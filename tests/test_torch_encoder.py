"""The port's MiniLM encoder against the JAX package's, on the CPU.

Both packages get the same parameters (a JAX init carried across with
``params_from_jax``) and the same token ids. Tolerances:

- float32: 1e-5 absolute on the unit-norm embeddings (f32 sums in another
  order; observed about 1e-7).
- bfloat16: max abs error 8e-3 and cosine >= 0.9995 a row. Both round to
  bf16 after every layer, but at other places: JAX adds a dense layer's
  bias to the f32 product before one rounding and rounds the attention
  weights to bf16 (einsum path), the port adds the bias in bf16 and keeps
  the weights in f32 (flash contract). Each differs by one bf16 rounding
  (2^-9 relative) a layer; observed about 2e-3 and 0.99998 at 2 layers.

The port's attention is the segment-masked plain version at every length;
JAX's is its einsum path (key mask) unless ``_use_flash`` is forced, which
the flash test does, running the library's Pallas kernel in TPU interpret
mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rag_foundation_tpu.models import encoder as jenc
from rag_foundation_tpu.models.hash_encoder import \
    HashingEncoder as JaxHashingEncoder
from rag_foundation_tpu.models.hybrid_encoder import \
    HybridEncoder as JaxHybrid
from rag_foundation_tpu.models.tokenizer import Tokenizer
from rag_foundation_tpu_torch.models import encoder as tenc
from rag_foundation_tpu_torch.models.hybrid_encoder import HybridEncoder
from rag_foundation_tpu_torch.ops import flash_attention as fa

SMALL = dict(vocab_size=512, hidden=64, layers=2, ffn=128)
F32_TOL = 1e-5
BF16_MAX_ERR, BF16_MIN_COS = 8e-3, 0.9995

TEXTS = ["revenue grew", "penguins live in antarctica", "x",
         "The codename for project Kalomi is ZEBRA42 and its budget is "
         "913 thousand credits in sector 4 of campus north.",
         "running jumped quickly teachers nationalisation",
         "日本語 only"]


def _cfgs(heads=4, max_len=32, dtype="float32"):
    kw = dict(SMALL, heads=heads, max_len=max_len, dtype=dtype)
    return jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)


def _params(jcfg, seed=0):
    p = jenc.init_params(jax.random.key(seed), jcfg)
    return p, tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                   device="cpu")


def _ids(cfg, texts=TEXTS):
    return Tokenizer(vocab_size=cfg.vocab_size).encode_batch(texts,
                                                             cfg.max_len)


def _assert_close(port, ref, dtype):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape and np.isfinite(port).all()
    if dtype == "float32":
        np.testing.assert_allclose(port, ref, rtol=0, atol=F32_TOL)
    else:
        assert np.abs(port - ref).max() <= BF16_MAX_ERR
        assert (port * ref).sum(axis=1).min() >= BF16_MIN_COS


def test_config_and_params_layout_match_jax():
    assert tenc.EncoderConfig()._asdict() == jenc.EncoderConfig()._asdict()
    for dtype, tdt in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
        jcfg, tcfg = _cfgs(dtype=dtype)
        assert tcfg.head_dim == jcfg.head_dim and tcfg.tdtype == tdt
        jp = jenc.init_params(jax.random.key(0), jcfg)
        tp = tenc.init_params(torch.Generator().manual_seed(0), tcfg)
        jleaves = {jax.tree_util.keystr(k): v for k, v in
                   jax.tree_util.tree_flatten_with_path(jp)[0]}
        tleaves = tenc._leaves(tp)
        assert sorted(jleaves) == sorted(tleaves)
        for key, v in jleaves.items():
            t = tleaves[key]
            assert tuple(t.shape) == v.shape, key
            assert str(t.dtype).split(".")[1] == str(v.dtype), key
        # truncated normal within +-2 sigma, sigma = fan_in ** -0.5
        w = tp["blocks"][0]["fc2"].float()
        bound = 2 * tcfg.ffn ** -0.5
        assert float(w.abs().max()) <= bound * (1 + 2 ** -8)
        assert abs(float(w.std()) * tcfg.ffn ** 0.5 - 0.88) < 0.02
        assert torch.equal(tp["ln_f"]["g"], torch.ones(64))
        again = tenc.init_params(torch.Generator().manual_seed(0), tcfg)
        assert torch.equal(again["tok_emb"], tp["tok_emb"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,max_len", [(4, 32), (2, 128)])
def test_encode_tokens_matches_jax(dtype, heads, max_len):
    jcfg, tcfg = _cfgs(heads, max_len, dtype)
    jp, tp = _params(jcfg)
    ids = _ids(jcfg)
    ref = jenc.encode_tokens_jit(jp, jnp.asarray(ids), jcfg)
    port = tenc.encode_tokens(tp, torch.from_numpy(ids), tcfg)
    assert port.dtype == torch.float32
    _assert_close(port, ref, dtype)
    np.testing.assert_allclose(np.linalg.norm(port.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_encode_tokens_matches_jax_flash_path(monkeypatch):
    """JAX with the Pallas flash kernel forced (TPU interpret mode, jit)
    against the port, f32, S=128, head dim 32."""
    jcfg, tcfg = _cfgs(heads=2, max_len=128)
    jp, tp = _params(jcfg, seed=1)
    ids = _ids(jcfg, TEXTS[:2])
    monkeypatch.setattr(jenc, "_use_flash", lambda cfg, s: True)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda p, i: jenc.encode_tokens(p, i, jcfg))(
            jp, jnp.asarray(ids))
        ref = np.asarray(ref)
    port = tenc.encode_tokens(tp, torch.from_numpy(ids), tcfg)
    _assert_close(port, ref, "float32")


def test_attention_argument_takes_any_implementation():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    ids = torch.from_numpy(_ids(jcfg))
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fa.flash_attention_reference(*args)

    a = tenc.encode_tokens(tp, ids, tcfg, attention=spy)
    assert calls == [(len(TEXTS), 4, 32, 16)] * tcfg.layers
    assert torch.equal(a, tenc.encode_tokens(tp, ids, tcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_both_ways(dtype, tmp_path):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg, seed=2)
    ids = _ids(jcfg)
    # JAX save -> port load: the same parameters, bit for bit
    jpath = str(tmp_path / "jax.npz")
    jenc.save_params(jp, jpath, jcfg)
    assert tenc.checkpoint_config(jpath) == jenc.checkpoint_config(jpath)
    loaded, want = tenc._leaves(tenc.load_params(jpath, tcfg,
                                                         device="cpu")), \
        tenc._leaves(tp)
    assert loaded.keys() == want.keys()
    for k, a in loaded.items():
        assert a.dtype == want[k].dtype and torch.equal(a, want[k]), k
    # port save (of its own init) -> JAX load: the same embeddings
    own = tenc.init_params(torch.Generator().manual_seed(3), tcfg)
    ppath = str(tmp_path / "port.npz")
    tenc.save_params(own, ppath, tcfg)
    back = jenc.load_params(ppath, jcfg)
    assert jenc.checkpoint_config(ppath) == jcfg._replace(dtype="bfloat16")
    own_leaves = tenc._leaves(own)
    for k, a in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(
            np.asarray(a, np.float32),
            own_leaves[jax.tree_util.keystr(k)].float().numpy())
    _assert_close(tenc.encode_tokens(own, torch.from_numpy(ids), tcfg),
                  jenc.encode_tokens_jit(back, jnp.asarray(ids), jcfg),
                  dtype)


def test_checkpoint_checks_raise_as_jax_does(tmp_path):
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg)
    path = str(tmp_path / "ok.npz")
    jenc.save_params(jp, path, jcfg)
    with np.load(path) as z:
        arrays = dict(z)
    cases = {}
    bad = dict(arrays, __tok_version=np.int64(1))
    cases["tokenizer"] = bad
    cases["missing"] = {k: v for k, v in arrays.items()
                        if k != "['blocks'][1]['fc2']"}
    old = {k: v for k, v in arrays.items() if k != "__tok_version"}
    cases["tokenizer v1"] = old           # pre-version checkpoint: v1
    port_load = functools.partial(tenc.load_params, device="cpu")
    for match, arrs in cases.items():
        p = str(tmp_path / f"{len(match)}.npz")
        np.savez(p, **arrs)
        for load, cfg in ((jenc.load_params, jcfg), (port_load, tcfg)):
            with pytest.raises(ValueError, match=match):
                load(p, cfg)
    for load, cfg in ((jenc.load_params, jcfg._replace(hidden=32)),
                      (port_load, tcfg._replace(hidden=32))):
        with pytest.raises(ValueError, match="shape"):
            load(path, cfg)
    np.savez(str(tmp_path / "nocfg.npz"),
             **{k: v for k, v in arrays.items() if not k.startswith("__cfg")})
    assert tenc.checkpoint_config(str(tmp_path / "nocfg.npz")) is None
    assert tenc.checkpoint_config(path, max_len=64).max_len == 64


def test_params_from_jax_dtype_and_device():
    jcfg, _ = _cfgs(dtype="bfloat16")
    jp = jenc.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = tenc.params_from_jax(tree, device="cpu")
    assert tp["tok_emb"].dtype == torch.bfloat16
    assert tp["ln_f"]["g"].dtype == torch.float32
    np.testing.assert_array_equal(tp["tok_emb"].float().numpy(),
                                  np.asarray(jp["tok_emb"], np.float32))
    t32 = tenc.params_from_jax(tree, device="cpu", dtype=torch.float32)
    assert t32["blocks"][0]["qkv"].dtype == torch.float32
    assert t32["blocks"][0]["ln1"]["b"].dtype == torch.float32


def test_minilm_encoder_matches_jax_and_buckets():
    jcfg, tcfg = _cfgs(max_len=64)
    jp, tp = _params(jcfg, seed=4)
    jax_e = jenc.MiniLMEncoder(dim=64, cfg=jcfg, params=jp)
    port = tenc.MiniLMEncoder(dim=64, cfg=tcfg, params=tp, device="cpu")
    assert port.name == jax_e.name == "minilm-jax"
    assert port.SEQ_BUCKET_FLOOR == jax_e.SEQ_BUCKET_FLOOR == 16
    e0 = port.encode([])
    assert e0.shape == (0, 64) and e0.dtype == np.float32
    out = port.encode(TEXTS)
    assert out.shape == (len(TEXTS), 64) and out.dtype == np.float32
    _assert_close(out, jax_e.encode(TEXTS), "float32")
    # batch-bucket independence: alone, or in a batch of another size
    # (another power-of-two batch and sequence bucket), the same vector
    for i in (0, 3, 5):
        np.testing.assert_allclose(port.encode([TEXTS[i]])[0], out[i],
                                   rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(port.encode(TEXTS[:3]), out[:3], rtol=0,
                               atol=F32_TOL)
    with pytest.raises(ValueError, match="dim"):
        tenc.MiniLMEncoder(dim=32, cfg=tcfg, device="cpu")
    seeded = tenc.MiniLMEncoder(dim=64, cfg=tcfg, seed=7, device="cpu")
    np.testing.assert_array_equal(
        seeded.encode(TEXTS[:2]),
        tenc.MiniLMEncoder(dim=64, cfg=tcfg, seed=7,
                           device="cpu").encode(TEXTS[:2]))


def test_padding_invariance():
    """The embedding does not depend on how many pad columns follow."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, seed=5)
    tok = Tokenizer(vocab_size=512)
    short = torch.from_numpy(tok.encode_batch(["hello world"], max_len=8))
    longp = torch.from_numpy(tok.encode_batch(["hello world"], max_len=32))
    a = tenc.encode_tokens(tp, short, tcfg._replace(max_len=8))
    b = tenc.encode_tokens(tp, longp, tcfg)
    torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_hybrid_encoder_matches_jax():
    jcfg, tcfg = _cfgs(max_len=64)
    jp, tp = _params(jcfg, seed=6)
    jax_h = JaxHybrid(96, jenc.MiniLMEncoder(dim=64, cfg=jcfg, params=jp),
                      w_mini=0.35)
    jax_h.hash_enc = JaxHashingEncoder(dim=96, use_native=False)
    port = HybridEncoder(96, tenc.MiniLMEncoder(dim=64, cfg=tcfg, params=tp,
                                                device="cpu"), w_mini=0.35)
    assert port.name == jax_h.name and port.dim == jax_h.dim == 160
    queries = TEXTS + ["Considering all of the projects described in the "
                       "document, could you please tell me the codename "
                       "for project Kalomi?"]
    for fn in ("encode", "encode_queries"):
        a, b = getattr(port, fn)(queries), getattr(jax_h, fn)(queries)
        _assert_close(a, b, "float32")
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="w_mini"):
        HybridEncoder(96, port.mini, w_mini=1.0)


def test_entry_points_default_to_the_card(tmp_path):
    """``VectorSegment``, ``VectorSegment.from_state``, ``load_params`` and
    ``params_from_jax`` ask for the card unless the caller says
    ``device="cpu"``: without one they raise ``resolve_device``'s error
    (no silent fallback to the CPU)."""
    from rag_foundation_tpu_torch.engine.segments import VectorSegment
    jcfg, tcfg = _cfgs()
    jp = jenc.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    path = str(tmp_path / "ckpt.npz")
    jenc.save_params(jp, path, jcfg)
    state = VectorSegment(8, device="cpu").state()
    calls = [lambda: VectorSegment(8).device,
             lambda: VectorSegment.from_state(state).device,
             lambda: tenc.load_params(path, tcfg)["tok_emb"].device,
             lambda: tenc.params_from_jax(tree)["tok_emb"].device]
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
