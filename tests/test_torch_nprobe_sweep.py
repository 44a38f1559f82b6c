"""BASELINE config 3's path through the port (a bf16 IVF-Flat body,
``ivf_search(p=3, approx_select=True)``, ``tools/nprobe_sweep.py``)
against the JAX package, at a small size (8,000 x 64, nlist 32).

A bf16 body built by JAX's ``build_ivf_flat`` is carried into the port by
``body_from_state``, so both sides scan identical lists: ids and dropped
probes are equal, values within 1e-5 relative (f32 sums of the same exact
bf16 products in another order). The two RNGs differ, so the port's own
build is held to JAX's by recall, and the sweep's corpus generator to
JAX's generator by statistics, not draws. ``chip_smoke.py`` phase 27's
recall gate is checked on recorded-shape sweeps.
"""

import importlib.util
import io
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine import ivf as jivf
from rag_foundation_tpu.ops.l2norm import l2_normalize as jax_l2
from rag_foundation_tpu_torch.engine import ivf as tivf
from rag_foundation_tpu_torch.engine.convert import (body_from_state,
                                                     body_to_state)
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.tools import nprobe_sweep

N, D, NLIST, Q, CENTERS = 8000, 64, 32, 64, 64


def _jax_corpus(n=N, d=D, q=Q, centers=CENTERS, noise=0.5, qnoise=0.2,
                seed=0):
    """``benchmarks/sweep_nprobe.py``'s generator at a small size."""
    kc, kv, kq, _ = jax.random.split(jax.random.key(seed), 4)
    cen = jax_l2(jax.random.normal(kc, (centers, d), jnp.float32))
    k1, k2 = jax.random.split(kv)
    cid = jax.random.randint(k1, (n,), 0, centers)
    corpus = jax_l2(cen[cid] + (noise / np.sqrt(d))
                    * jax.random.normal(k2, (n, d), jnp.float32))
    queries = jax_l2(corpus[:q] + (qnoise / np.sqrt(d))
                     * jax.random.normal(kq, (q, d), jnp.float32))
    return np.array(corpus), np.array(queries)


@pytest.fixture(scope="module")
def shared():
    """JAX's config-3 build of a bf16 corpus, its body carried across."""
    corpus, queries = _jax_corpus()
    jbody = jivf.build_ivf_flat(jnp.asarray(corpus).astype(jnp.bfloat16),
                                NLIST, key=jax.random.key(3), kmeans_iters=8,
                                sample=4096)
    state = {"f_" + k: (np.int64(v) if isinstance(v, int) else np.asarray(v))
             for k, v in jbody._asdict().items()}
    state["kind"] = "IVFFlatIndex"
    return corpus, queries, jbody, state


# (nprobe, p): config 3's p 3, and p 4, the p of the JAX package's
# recorded config 3 run, which chip_smoke.py's phase 27 holds to 0.95
CONFIG3_POINTS = ([(n, 3) for n in (2, 4, 8, 32)]
                  + [(n, 4) for n in (2, 4, 8, 16, 32)])


@pytest.mark.parametrize("nprobe,p", CONFIG3_POINTS, ids=[
    str(n) if p == 3 else f"p4-{n}" for n, p in CONFIG3_POINTS])
def test_config3_search_matches_jax_on_shared_bf16_body(shared, nprobe, p):
    corpus, queries, jbody, state = shared
    tbody = body_from_state(state, "cpu")
    assert tbody.lists.dtype == torch.bfloat16
    assert tbody.cap_len == jbody.cap_len and tbody.n == jbody.n
    jv, ji, jdrop = jivf.ivf_search(jbody, jnp.asarray(queries), 10,
                                    nprobe=nprobe, p=p, approx_select=True,
                                    interpret=True)
    tv, ti, tdrop = tivf.ivf_search(tbody, torch.as_tensor(queries), 10,
                                    nprobe=nprobe, p=p, approx_select=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tdrop) == int(jdrop)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def test_config3_dispatch_drops_probes_as_jax(shared):
    # qcap 8 at nprobe 16 of 32 lists: the default qcap drops probes on
    # both sides alike
    _, queries, jbody, state = shared
    tbody = body_from_state(state, "cpu")
    q = np.repeat(queries[:4], 16, axis=0)
    _, ji, jdrop = jivf.ivf_search(jbody, jnp.asarray(q), 10, nprobe=16,
                                   p=3, qcap=8, approx_select=True,
                                   interpret=True)
    _, ti, tdrop = tivf.ivf_search(tbody, torch.as_tensor(q), 10, nprobe=16,
                                   p=3, qcap=8, approx_select=True)
    assert int(jdrop) > 0
    assert int(tdrop) == int(jdrop)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_jax_bf16_body_carries_across_through_npz(shared):
    # np.savez writes JAX's ml_dtypes bf16 as a 2-byte void array: the
    # port reads the same bits back
    _, _, jbody, state = shared
    buf = io.BytesIO()
    np.savez(buf, **state)
    buf.seek(0)
    with np.load(buf) as z:
        loaded = {k: z[k] for k in z.files}
    assert loaded["f_lists"].dtype == np.dtype("V2")
    tbody = body_from_state(loaded, "cpu")
    want = np.asarray(jbody.lists).view(np.int16)
    np.testing.assert_array_equal(tbody.lists.view(torch.int16).numpy(),
                                  want)
    np.testing.assert_array_equal(tbody.row_ids.numpy(),
                                  np.asarray(jbody.row_ids))


def test_port_bf16_body_saves_and_reloads_verbatim(shared):
    corpus, queries, _, _ = shared
    gen = torch.Generator().manual_seed(0)
    body = tivf.build_ivf_flat(torch.as_tensor(corpus), NLIST, generator=gen,
                               kmeans_iters=8, sample=4096,
                               dtype=torch.bfloat16)
    idx = StoreIndex(D, mode="ivf_flat", nlist=NLIST, device="cpu")
    idx.restore_body({**body_to_state(body), "kind": "IVFFlatIndex",
                      "body_chunk_ids": np.arange(N, dtype=np.int64),
                      "dead": np.zeros(0, np.int64)})
    state = idx.body_state()
    assert state["f_lists"].dtype == np.dtype("V2")
    buf = io.BytesIO()
    np.savez(buf, **state)
    buf.seek(0)
    with np.load(buf) as z:
        back = StoreIndex(D, mode="ivf_flat", nlist=NLIST, device="cpu")
        back.restore_body({k: z[k] for k in z.files})
    assert back.body.lists.dtype == torch.bfloat16
    assert torch.equal(back.body.lists.view(torch.int16),
                       body.lists.view(torch.int16))
    assert torch.equal(back.body.row_ids, body.row_ids)
    assert torch.equal(back.body.centroids, body.centroids)
    a = tivf.ivf_search(idx.body, torch.as_tensor(queries), 10, nprobe=4,
                        p=3)
    b = tivf.ivf_search(back.body, torch.as_tensor(queries), 10, nprobe=4,
                        p=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_port_bf16_build_recall_within_jax(shared):
    corpus, queries, jbody, _ = shared
    _, exact = jax.lax.top_k(
        jnp.asarray(queries).astype(jnp.bfloat16).astype(jnp.float32)
        @ jnp.asarray(corpus).astype(jnp.bfloat16).astype(jnp.float32).T, 10)
    exact = np.asarray(exact)
    tbody, _ = nprobe_sweep.build(torch.as_tensor(corpus), NLIST, seed=3,
                                  sample=4096)
    assert tbody.lists.dtype == torch.bfloat16
    live = tbody.row_ids.numpy()
    assert sorted(live[live >= 0]) == list(range(N))
    for nprobe in (4, 8):
        _, ji, _ = jivf.ivf_search(jbody, jnp.asarray(queries), 10,
                                   nprobe=nprobe, p=3, approx_select=True,
                                   interpret=True)
        _, ti, _ = tivf.ivf_search(tbody, torch.as_tensor(queries), 10,
                                   nprobe=nprobe, p=3, approx_select=True)
        rj = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(np.asarray(ji), exact)])
        rt = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(ti.numpy(), exact)])
        assert rt >= rj - 0.03, (nprobe, rt, rj)


def _stats(corpus: np.ndarray, queries: np.ndarray) -> dict:
    """Row norms, each sampled row's nearest-neighbour cosine (its
    cluster's spread), the cosine of a row to the mean of its ten nearest
    rows (its centre's pull) and the query-to-source distance."""
    c = corpus.astype(np.float64)
    sample = c[:400]
    cos = sample @ c.T
    cos[np.arange(400), np.arange(400)] = -np.inf
    top = np.sort(cos, axis=1)[:, ::-1][:, :10]
    return {"norm": np.linalg.norm(c, axis=1).mean(),
            "nn_cos": top[:, 0].mean(),
            "tenth_cos": top[:, 9].mean(),
            "q_dist": np.linalg.norm(queries - corpus[:len(queries)],
                                     axis=1).mean()}


def test_sweep_corpus_matches_jax_generator_statistics():
    jc, jq = _jax_corpus(n=4000, q=256)
    tc, tq = nprobe_sweep.make_corpus(4000, D, 256, centers=CENTERS,
                                      seed=1, device="cpu")
    js, ts = _stats(jc, jq), _stats(tc.numpy(), tq.numpy())
    assert abs(ts["norm"] - 1.0) < 1e-6 and abs(js["norm"] - 1.0) < 1e-6
    for key in ("nn_cos", "tenth_cos"):
        assert abs(ts[key] - js[key]) < 0.02, (key, ts, js)
    # qnoise 0.2 / sqrt(d) a dimension: |q - row| about 0.2 (before the
    # renormalisation)
    assert abs(ts["q_dist"] - js["q_dist"]) < 0.01, (ts, js)
    assert abs(ts["q_dist"] - 0.2) < 0.02


def test_nprobe_sweep_runs_end_to_end_on_cpu():
    out = nprobe_sweep.run_sweep("cpu", n=N, d=D, nlist=NLIST, q_n=Q,
                                 centers=CENTERS, sample=4096, reps=1)
    json.dumps(out)
    assert out["device"] == "cpu" and out["card"] is None
    assert [r["nprobe"] for r in out["sweep"]] == list(nprobe_sweep.NPROBES)
    recalls = [r["recall_at_10"] for r in out["sweep"]]
    assert all(0.0 <= r <= 1.0 for r in recalls)
    assert recalls[-1] >= recalls[0] and recalls[-1] > 0.8
    for r in out["sweep"]:
        assert r["ms_per_batch"] > 0 and math.isfinite(r["qps"])
        assert isinstance(r["dropped_probes"], int)
    assert out["cap_len"] % 128 == 0 and out["build_s"] > 0
    assert out["smallest_nprobe_at_target"] == nprobe_sweep.smallest_nprobe(
        out["sweep"])


def test_nprobe_sweep_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        nprobe_sweep.run_sweep(n=1000, d=16, nlist=4, q_n=8)


def test_smallest_nprobe():
    rows = [{"nprobe": 4, "recall_at_10": 0.9},
            {"nprobe": 8, "recall_at_10": 0.96},
            {"nprobe": 16, "recall_at_10": 0.94}]
    assert nprobe_sweep.smallest_nprobe(rows) == 8
    assert nprobe_sweep.smallest_nprobe(rows[:1]) is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(recalls):
    return [{"nprobe": n, "recall_at_10": r}
            for n, r in zip(nprobe_sweep.NPROBES, recalls)]


# phase 27's gate: (p 3 recalls, p 4 recalls) over nprobe 4-128, and
# what must fail; the first pair is the H100 run's shape (p 3 under 0.95
# everywhere, p 4 above it)
@pytest.mark.parametrize("p3,p4,want", [
    ((0.9394, 0.945, 0.948, 0.9497, 0.9497, 0.9497),
     (0.9788, 0.985, 0.989, 0.9896, 0.9896, 0.9896), []),
    ((0.93,) * 6, (0.5, 0.6, 0.7, 0.8, 0.9, 0.95), []),
    ((0.94, 0.94, 0.5, 0.94, 0.94, 0.94), (0.99,) * 6, ["p 3"]),
    ((0.99,) * 6, (0.9499,) * 6, ["p 4"]),
    ((0.5,) * 6, (0.5,) * 6, ["p 4", "p 3"]),
])
def test_phase27_recall_gate(p3, p4, want):
    cs = _chip_smoke()
    faults = cs.sweep_faults({3: _rows(p3), 4: _rows(p4)},
                             nprobe_sweep.RECALL_TARGET)
    failed = [w for w in ("p 4", "p 3")
              if any(f"{w} sweep" in f for f in faults)]
    assert failed == want and len(faults) == len(want)
