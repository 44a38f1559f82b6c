"""The port's native host shim (``rag_foundation_tpu_torch/native``)
against the JAX package's and against the port's own Python and numpy
paths.

- The hasher: the port's native encode is bit-identical to the JAX
  package's native encode (the same source arithmetic, built with the
  same flags on the same machine), and within rtol 1e-6 of the Python
  path (the normalization's reciprocal differs in the last float32 ulp).
- The host re-rank (``HostArchive.rescore``): native against numpy
  within the float-order bound of an f32 dot of d terms,
  ``d * 2**-24 * sum|q_i r_i| * scale``; bit-identical to the JAX
  package's native re-rank.
- The loader: it builds into its build directory at first use, raises
  with the compiler's output on a source that does not compile, returns
  None without ``g++`` (the callers then take their Python and numpy
  paths), and two processes that build at once both load the library.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rag_foundation_tpu.engine.archive import HostArchive as JaxArchive
from rag_foundation_tpu.models.hash_encoder import \
    HashingEncoder as JaxHashingEncoder
from rag_foundation_tpu.native import load_hasher as jax_load_hasher
from rag_foundation_tpu_torch import native
from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder
from tests.test_native_hasher import TEXTS

ROOT = Path(__file__).resolve().parents[1]
QUERIES = TEXTS + [
    "Considering all of the projects described in the document, could "
    "you please tell me the codename for project Kalomi?"]


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Both packages' shims must build here (g++ is in this image): a
    skip would hide the native path the engines take by default."""
    assert native.load_hasher() is not None
    assert jax_load_hasher() is not None


@pytest.mark.parametrize("dim", [64, 768])
@pytest.mark.parametrize("ngram", [0, 3])
def test_native_encode_bit_identical_to_jax_native(dim, ngram):
    ours = HashingEncoder(dim=dim, ngram=ngram)
    ref = JaxHashingEncoder(dim=dim, ngram=ngram)
    assert ours._lib is not None and ref._lib is not None
    np.testing.assert_array_equal(ours.encode(TEXTS), ref.encode(TEXTS))
    np.testing.assert_array_equal(ours.encode_queries(QUERIES),
                                  ref.encode_queries(QUERIES))


@pytest.mark.parametrize("dim", [64, 768])
@pytest.mark.parametrize("ngram", [0, 3])
def test_native_encode_matches_python_path(dim, ngram):
    nat = HashingEncoder(dim=dim, ngram=ngram).encode(TEXTS)
    py = HashingEncoder(dim=dim, ngram=ngram, use_native=False).encode(TEXTS)
    np.testing.assert_allclose(nat, py, rtol=1e-6, atol=0)
    assert nat.dtype == np.float32 and nat.shape == (len(TEXTS), dim)
    assert not nat[2].any()                      # the empty text


def test_hybrid_hash_channel_is_native_by_default():
    from rag_foundation_tpu_torch.models.hybrid_encoder import HybridEncoder

    class Mini:                    # a stand-in semantic channel
        dim = 8

        def encode(self, texts):
            return np.ones((len(texts), 8), np.float32) / np.sqrt(8)

    hyb = HybridEncoder(96, Mini())
    assert hyb.hash_enc._lib is not None
    want = HashingEncoder(dim=96).encode_queries(QUERIES)
    got = hyb.encode_queries(QUERIES)[:, :96]
    norms = np.linalg.norm(got, axis=1, keepdims=True)
    np.testing.assert_allclose(got / np.maximum(norms, 1e-9),
                               want, rtol=1e-5, atol=1e-6)


# -- the host re-rank ----------------------------------------------------------

def _archives(n, d, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-127, 128, size=(n, d), dtype=np.int8)
    ours, ref = HostArchive(d), JaxArchive(d)
    ours.append(rows)
    ref.append(rows)
    return ours, ref, rng


def _numpy_rescore(arch, q, rows, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "load_hasher", lambda: None)
        return arch.rescore(q, rows)


def _order_bound(arch, q, rows):
    """Float-order bound of each f32 dot: d * 2**-24 * sum|q_i r_i|."""
    safe = np.clip(rows, 0, arch.n - 1)
    mag = np.abs(arch.chunk_i8(0, arch.n)[safe].astype(np.float64)) @ \
        np.abs(q.astype(np.float64))[:, :, None]
    return arch.dim * 2.0 ** -24 * mag[:, :, 0] * arch.scale


@pytest.mark.parametrize("n,d,q_n,c", [(4096, 256, 8, 33),
                                       (3000, 768, 5, 64),
                                       (50, 16, 3, 7)])
def test_rescore_native_against_numpy_and_jax(n, d, q_n, c, monkeypatch):
    ours, ref, rng = _archives(n, d, seed=n)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    rows = rng.integers(0, n, size=(q_n, c)).astype(np.int64)
    rows[0, 0] = -1               # pads: -inf
    rows[-1, -3:] = -1
    rows[1 % q_n, 2] = n + 7      # past the end: clipped to the last row
    got = ours.rescore(q, rows)
    want = _numpy_rescore(ours, q, rows, monkeypatch)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == rows.shape
    np.testing.assert_array_equal(np.isneginf(got), rows < 0)
    np.testing.assert_array_equal(np.isneginf(want), rows < 0)
    live = rows >= 0
    err = np.abs(got[live] - want[live])
    assert (err <= _order_bound(ours, q, rows)[live]).all(), err.max()
    last = ours.chunk_f32(n - 1, n)[0].astype(np.float64) @ q[1 % q_n]
    assert abs(got[1 % q_n, 2] - last) <= 1e-5 * max(1.0, abs(last))
    # the JAX package's native re-rank: the same bits
    np.testing.assert_array_equal(got, ref.rescore(q, rows))
    # shapes the C loop would read past are refused before the call
    with pytest.raises(ValueError, match="rescore"):
        ours.rescore(q[:, :-1], rows)
    with pytest.raises(ValueError, match="rescore"):
        ours.rescore(q[:-1], rows)


def test_rescore_empty_batches_and_archive(monkeypatch):
    ours, ref, rng = _archives(64, 32, seed=1)
    q0 = np.zeros((0, 32), np.float32)
    r0 = np.zeros((0, 5), np.int64)
    for out in (ours.rescore(q0, r0), _numpy_rescore(ours, q0, r0,
                                                     monkeypatch),
                ref.rescore(q0, r0)):
        assert out.shape == (0, 5) and out.dtype == np.float32
    # an empty archive has no row to score: every candidate is -inf on
    # both paths (the JAX package's numpy path raises here instead)
    empty = HostArchive(32)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    rows = np.array([[-1, 0, 3], [-1, -1, -1]], np.int64)
    for out in (empty.rescore(q, rows),
                _numpy_rescore(empty, q, rows, monkeypatch)):
        assert out.dtype == np.float32 and np.isneginf(out).all()
    with pytest.raises(TypeError):
        JaxArchive(32).rescore(q, rows)


# -- the loader ----------------------------------------------------------------

def test_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    gxx = shutil.which("g++")
    path = native.library_path(gxx)
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert native.load_hasher()._name == str(path)
    src = native.SRC
    edited = tmp_path / "hasher.cpp"
    edited.write_text(src.read_text() + "\n// an edit\n")
    monkeypatch.setattr(native, "SRC", edited)
    assert native.library_path(gxx) != path
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert native.library_path(gxx) != path


def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    broken = tmp_path / "hasher.cpp"
    broken.write_text(native.SRC.read_text().replace(
        "constexpr uint64_t FNV_PRIME", "constexpr uint64_t FNV_PRIME = ;"
        "\nconstexpr uint64_t BROKEN", 1))
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ exit [1-9][\s\S]*error"):
        native.load_hasher()
    assert not list((tmp_path / "build").iterdir())   # no library, no tmp
    with pytest.raises(RuntimeError):
        HashingEncoder(dim=64)


def test_without_gxx_the_python_paths_serve(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_MISSING", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with caplog.at_level("WARNING"):
        assert native.load_hasher() is None
        assert native.load_hasher() is None
    assert sum("no g++" in r.getMessage() for r in caplog.records) == 1
    enc = HashingEncoder(dim=64)
    assert enc._lib is None
    np.testing.assert_array_equal(
        enc.encode(TEXTS),
        JaxHashingEncoder(dim=64, use_native=False).encode(TEXTS))
    arch, _, rng = _archives(32, 16, seed=2)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    rows = np.array([[0, -1, 31], [5, 5, 40]], np.int64)
    np.testing.assert_array_equal(
        arch.rescore(q, rows), _numpy_rescore(arch, q, rows, monkeypatch))
    assert not (tmp_path / "build").exists()


def test_two_processes_building_at_once_both_load(tmp_path):
    build = tmp_path / "build"
    code = (
        "import sys, hashlib\n"
        "from pathlib import Path\n"
        "from rag_foundation_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(build)!r})\n"
        "from rag_foundation_tpu_torch.models.hash_encoder import "
        "HashingEncoder\n"
        "enc = HashingEncoder(dim=768)\n"
        "assert enc._lib is not None\n"
        "out = enc.encode(['two builds at once', 'x' * 5000])\n"
        "print(enc._lib._name, hashlib.sha256(out.tobytes()).hexdigest())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]            # one library, same vectors
    assert [p.name for p in build.iterdir()] == [
        Path(outs[0][0].split()[0]).name]      # no temporary file left
