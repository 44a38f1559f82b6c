"""Two processes joined into one mesh: the port's ``init_distributed`` and
its sharded searches across the process boundary, against the JAX
package's (the counterpart of ``tests/test_multihost.py``).

Two local CPU processes form the pod over gloo; each child imports only
the port (``rag_foundation_tpu_torch``), holds one shard of a 2-shard
mesh and returns its result in a file; this process computes the JAX
side and the port's single-process results on the same seeded inputs.

Tolerances: across processes the port's ``sharded_topk`` is bit-identical
to its single-process ``exact_topk`` of the whole corpus, and the two
ranks hold bit-identical results. The IVF-Flat (f32 lists) and IVF-PQ
(int8 LUT) searches of a body that JAX built, carried across with
``engine/convert.py``, give bit-identical ids and values to the port's
single-process two-shard search, and ids equal to JAX's single-process
two-shard search on the conftest's virtual devices (values within 1e-5:
the f32 products sum in another order). IVF-Flat recall@10 against
JAX's ``ivf_search`` at the same global nprobe is at least 0.95, as in
``tests/test_multihost.py``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine import ivf as jivf
from rag_foundation_tpu.engine import ivfpq as jpq
from rag_foundation_tpu.ops.topk import exact_topk as jax_exact_topk
from rag_foundation_tpu.parallel import mesh as jmesh_mod
from rag_foundation_tpu.parallel import sharded_ivf as jsivf
from rag_foundation_tpu_torch.engine.convert import body_from_state
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.parallel import mesh as tmesh_mod
from rag_foundation_tpu_torch.parallel import sharded_ivf as tsivf

ROOT = Path(__file__).resolve().parents[1]
N, D, Q, K = 4096, 64, 32, 10            # tests/test_multihost.py's sizes
NLIST, PQ_M = 32, 16
TOL = dict(rtol=1e-5, atol=1e-6)

_SUM_CHILD = r"""
import json, os, sys
import torch
import torch.distributed as dist
from rag_foundation_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh)
out_path = sys.argv[1]
# the coordinator, process count and id come from the environment; the
# backend is chosen from the hosts' cards (none here: gloo)
assert init_distributed()
assert dist.get_backend() == "gloo"
pid = dist.get_rank()
assert dist.get_world_size() == 2 and pid == int(os.environ[
    "RAGTPU_PROCESS_ID"])
mesh = make_mesh(2, devices=["cpu"])   # (data=1, shard=2) across processes
assert mesh.shape == {"data": 1, "shard": 2} and mesh.spans_processes
assert mesh.shard_offset == pid and len(mesh.devices) == 1
local = torch.tensor([float(pid + 1)])
dist.all_reduce(local)                 # the sum over both shards
json.dump({"pid": pid, "total": float(local[0])}, open(out_path, "w"))
"""

_SEARCH_CHILD = r"""
import sys
import numpy as np
import torch
import rag_foundation_tpu_torch.engine  # before the sharded modules
from rag_foundation_tpu_torch.engine.convert import body_from_state
from rag_foundation_tpu_torch.ops import ivf_scan, pq_scan
from rag_foundation_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh, shard_rows)
from rag_foundation_tpu_torch.parallel.sharded_ivf import (
    shard_ivf_index, shard_ivfpq_index, sharded_ivf_search,
    sharded_ivfpq_search)
from rag_foundation_tpu_torch.parallel.topk_merge import sharded_topk

coordinator, pid, in_path, out_path = sys.argv[1:5]
pid = int(pid)
assert init_distributed(coordinator=coordinator, num_processes=2,
                        process_id=pid, backend="gloo")
mesh = make_mesh(2, devices=["cpu"])
z = np.load(in_path)
state = lambda p: {k[len(p):]: z[k] for k in z.files if k.startswith(p)}
corpus = torch.as_tensor(z["corpus"])
queries = torch.as_tensor(z["queries"])
K = int(z["k"])

# this process holds only its half of the rows and of the lists
blocks = shard_rows(mesh, corpus)
assert len(blocks) == 1 and blocks[0].shape[0] == corpus.shape[0] // 2
fv, fi = sharded_topk(queries, blocks, K, mesh=mesh, block_size=1024)
# integer rows, duplicated across the halves: ties go to the lower
# global index only if the shards merge in global order
tv, ti = sharded_topk(torch.as_tensor(z["tie_queries"]),
                      shard_rows(mesh, torch.as_tensor(z["tie_corpus"])),
                      12, mesh=mesh, block_size=128)
ivf = shard_ivf_index(body_from_state(state("ivf_"), "cpu"), mesh)
assert len(ivf.shards) == 1
assert ivf.shards[0].nlist == int(z["ivf_f_centroids"].shape[0]) // 2
iv, ir = sharded_ivf_search(ivf, queries, K, mesh=mesh, nprobe_local=4,
                            p=K)
pq = shard_ivfpq_index(body_from_state(state("pq_"), "cpu"), mesh)
pv, pr = sharded_ivfpq_search(pq, queries, K, mesh=mesh, nprobe_local=4,
                              p=8, lut_dtype="int8")
np.savez(out_path, pid=pid, flat_vals=fv.numpy(), flat_rows=fi.numpy(),
         tie_vals=tv.numpy(), tie_rows=ti.numpy(),
         ivf_vals=iv.numpy(), ivf_rows=ir.numpy(), pq_vals=pv.numpy(),
         pq_rows=pr.numpy(),
         launches=[ivf_scan.LAUNCHES.count, pq_scan.LAUNCHES.count])
"""

_FAILING_CHILD = r"""
import sys
import torch
from rag_foundation_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh, shard_rows)
from rag_foundation_tpu_torch.parallel.topk_merge import sharded_topk

coordinator, pid = sys.argv[1], int(sys.argv[2])
init_distributed(coordinator=coordinator, num_processes=2, process_id=pid,
                 backend="gloo")
mesh = make_mesh(2, devices=["cpu"])
if pid == 1:
    raise RuntimeError("rank 1 fails before the gather")
# rank 0 waits in the all-gather for a peer that never comes
sharded_topk(torch.zeros((1, 4)), shard_rows(mesh, torch.zeros((8, 4))), 2,
             mesh=mesh)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pod(tmp_path, child_src, timeout, extra_args=(), env_vars=False):
    """Run ``child_src`` as ranks 0 and 1 (argv: coordinator, rank,
    *extra_args, out path; with ``env_vars``: the out path alone, the
    pod in ``RAGTPU_*``). A rank that exits non-zero, or a pod past
    ``timeout`` seconds, kills both and fails with their stderr.
    Returns the out paths."""
    coordinator = f"127.0.0.1:{_free_port()}"
    child = tmp_path / "child.py"
    child.write_text(child_src)
    outs = [tmp_path / f"out{i}" for i in range(2)]
    procs, errs = [], []
    for i in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        if env_vars:
            env.update(RAGTPU_COORDINATOR=coordinator,
                       RAGTPU_NUM_PROCESSES="2", RAGTPU_PROCESS_ID=str(i))
            argv = [str(outs[i])]
        else:
            argv = [coordinator, str(i), *map(str, extra_args),
                    str(outs[i])]
        err = open(tmp_path / f"err{i}.txt", "w+")
        errs.append(err)
        procs.append(subprocess.Popen([sys.executable, str(child), *argv],
                                      env=env, stdout=subprocess.DEVNULL,
                                      stderr=err))

    def stderr() -> str:
        text = []
        for i, err in enumerate(errs):
            err.seek(0)
            text.append(f"--- rank {i} ---\n{err.read()[-2000:]}")
        return "\n".join(text)

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                pytest.fail(f"a rank failed:\n{stderr()}")
            if time.monotonic() > deadline:
                pytest.fail(f"distributed pod timed out after {timeout} s:"
                            f"\n{stderr()}")
            time.sleep(0.05)
        if any(p.returncode for p in procs):
            pytest.fail(f"a rank failed:\n{stderr()}")
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for err in errs:
            err.close()
    return outs


def test_two_process_sum(tmp_path):
    import json
    for out in _run_pod(tmp_path, _SUM_CHILD, timeout=110, env_vars=True):
        # the sum over both processes' shards: 1.0 + 2.0
        assert json.loads(out.read_text())["total"] == 3.0


def test_init_distributed_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("RAGTPU_COORDINATOR", raising=False)
    assert jmesh_mod.init_distributed() is False
    assert tmesh_mod.init_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("missing", ["RAGTPU_NUM_PROCESSES",
                                     "RAGTPU_PROCESS_ID"])
def test_init_distributed_names_the_missing_variable_as_jax(monkeypatch,
                                                            missing):
    monkeypatch.setenv("RAGTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("RAGTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("RAGTPU_PROCESS_ID", "0")
    monkeypatch.delenv(missing)
    with pytest.raises(ValueError) as jax_err:
        jmesh_mod.init_distributed()
    with pytest.raises(ValueError) as port_err:
        tmesh_mod.init_distributed()
    assert str(port_err.value) == str(jax_err.value)
    assert missing in str(port_err.value)
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_fails_the_pod_without_a_hang(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="rank 1 fails before the gather"):
        _run_pod(tmp_path, _FAILING_CHILD, timeout=110)
    assert time.monotonic() - t0 < 100


def _state(prefix, jbody, kind) -> dict:
    out = {f"{prefix}kind": kind}
    for name, val in jbody._asdict().items():
        out[f"{prefix}f_{name}"] = np.int64(val) if isinstance(val, int) \
            else np.asarray(val)
    return out


def _corpus():
    # tests/test_multihost.py's corpus and queries
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((64, D)).astype(np.float32)
    corpus = (centers[rng.integers(0, 64, N)]
              + 0.1 * rng.standard_normal((N, D)).astype(np.float32))
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[:Q] + 0.02 * rng.standard_normal((Q, D)).astype(
        np.float32)
    return corpus, queries


def _tie_corpus():
    # small integers (every partial sum exact in f32); rows 10-69 repeat
    # in the second half as rows 700-759
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, (1024, 32)).astype(np.float32)
    x[700:760] = x[10:70]
    q = np.concatenate([x[10:14], rng.integers(-3, 4, (4, 32)).astype(
        np.float32)])
    return x, q


@pytest.fixture(scope="module")
def pod_results(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    tmp = tmp_path_factory.mktemp("pod")
    corpus, queries = _corpus()
    jflat = jivf.build_ivf_flat(jnp.asarray(corpus), nlist=NLIST,
                                key=jax.random.key(0))
    jpqb = jpq.build_ivf_pq(jnp.asarray(corpus), NLIST, PQ_M,
                            key=jax.random.key(0), refine=False)
    inputs = tmp / "inputs.npz"
    tie_corpus, tie_queries = _tie_corpus()
    np.savez(inputs, corpus=corpus, queries=queries, k=K,
             tie_corpus=tie_corpus, tie_queries=tie_queries,
             **_state("ivf_", jflat, "IVFFlatIndex"),
             **_state("pq_", jpqb, "IVFPQIndex"))
    outs = _run_pod(tmp, _SEARCH_CHILD, timeout=180, extra_args=(inputs,))
    got = [dict(np.load(f"{o}.npz")) for o in outs]
    return corpus, queries, jflat, jpqb, got


def _fields(got, name):
    return got[f"{name}_vals"], got[f"{name}_rows"]


def test_both_ranks_hold_the_same_result(pod_results):
    *_, got = pod_results
    assert [int(g["pid"]) for g in got] == [0, 1]
    for key in got[0]:
        if key != "pid":
            np.testing.assert_array_equal(got[0][key], got[1][key],
                                          err_msg=key)
    # the CPU path launches no kernel
    assert list(got[0]["launches"]) == [0, 0]


def test_sharded_topk_across_processes_bit_identical(pod_results):
    corpus, queries, *_, got = pod_results
    fv, fi = _fields(got[0], "flat")
    rv, ri = exact_topk(torch.as_tensor(queries), torch.as_tensor(corpus),
                        K, block_size=1024)
    np.testing.assert_array_equal(fi, ri.numpy())
    np.testing.assert_array_equal(fv, rv.numpy())
    _, ji = jax_exact_topk(jnp.asarray(queries), jnp.asarray(corpus), K,
                           block_size=1024)
    np.testing.assert_array_equal(fi, np.asarray(ji))


def test_ties_across_processes_take_the_lowest_global_index(pod_results):
    *_, got = pod_results
    tv, ti = _fields(got[0], "tie")
    x, q = _tie_corpus()
    rv, ri = exact_topk(torch.as_tensor(q), torch.as_tensor(x), 12,
                        block_size=128)
    np.testing.assert_array_equal(ti, ri.numpy())
    np.testing.assert_array_equal(tv, rv.numpy())
    _, ji = jax_exact_topk(jnp.asarray(q), jnp.asarray(x), 12,
                           block_size=128)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert list(ti[0, :2]) == [10, 700]


@pytest.fixture(scope="module")
def two_shards():
    jm = jmesh_mod.make_mesh(2)
    tm = tmesh_mod.make_mesh(2, devices=[torch.device("cpu")] * 2)
    return jm, tm


def test_sharded_ivf_across_processes_equals_one_process(pod_results,
                                                         two_shards):
    corpus, queries, jflat, _, got = pod_results
    jm, tm = two_shards
    iv, ir = _fields(got[0], "ivf")
    # the port in one process, two shards
    tbody = body_from_state(_state("", jflat, "IVFFlatIndex"), "cpu")
    sv, sr = tsivf.sharded_ivf_search(tsivf.shard_ivf_index(tbody, tm),
                                      torch.as_tensor(queries), K, mesh=tm,
                                      nprobe_local=4, p=K)
    np.testing.assert_array_equal(ir, sr.numpy())
    np.testing.assert_array_equal(iv, sv.numpy())
    # JAX in one process, two shards
    jv, jr = jsivf.sharded_ivf_search(
        jsivf.shard_ivf_index(jflat, jm), jnp.asarray(queries), K, mesh=jm,
        nprobe_local=4, p=K, interpret=True)
    np.testing.assert_array_equal(ir, np.asarray(jr))
    np.testing.assert_allclose(iv, np.asarray(jv), **TOL)
    # recall against JAX's single-device search at the same global nprobe
    _, ref, _ = jivf.ivf_search(jflat, jnp.asarray(queries), K, nprobe=8,
                                p=K, interpret=True)
    ref = np.asarray(ref)
    recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(ir, ref)])
    assert recall >= 0.95, recall
    np.testing.assert_array_equal(ir[:, 0], ref[:, 0])


def test_sharded_ivfpq_across_processes_equals_one_process(pod_results,
                                                           two_shards):
    _, queries, _, jpqb, got = pod_results
    jm, tm = two_shards
    pv, pr = _fields(got[0], "pq")
    tbody = body_from_state(_state("", jpqb, "IVFPQIndex"), "cpu")
    sv, sr = tsivf.sharded_ivfpq_search(
        tsivf.shard_ivfpq_index(tbody, tm), torch.as_tensor(queries), K,
        mesh=tm, nprobe_local=4, p=8, lut_dtype="int8")
    np.testing.assert_array_equal(pr, sr.numpy())
    np.testing.assert_array_equal(pv, sv.numpy())
    jv, jr = jsivf.sharded_ivfpq_search(
        jsivf.shard_ivfpq_index(jpqb, jm), jnp.asarray(queries), K, mesh=jm,
        nprobe_local=4, p=8, lut_dtype="int8", interpret=True)
    np.testing.assert_array_equal(pr, np.asarray(jr))
    np.testing.assert_allclose(pv, np.asarray(jv), **TOL)
