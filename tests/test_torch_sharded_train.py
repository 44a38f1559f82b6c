"""The port's sharded training step (``parallel/train_step.py``) against
JAX's ``full_step`` of ``__graft_entry__.dryrun_multichip``, on the CPU.

Both sides take the dryrun's tiny encoder config in f32 (vocab 512,
hidden 64, 2 layers, 4 heads, ffn 128, max_len 32), its seeded numpy
corpus, centroids and token ids (batch 8), the same parameters (a JAX
init carried across with ``params_from_jax``) and ``adam(1e-4)``. JAX
jits ``full_step`` on ``make_mesh(2, data=2)`` of the conftest's virtual
devices; the port runs on ``[cpu] * 4`` at data 2 x shard 2.

Tolerances (as ``tests/test_torch_train.py`` states them): the loss
within 1e-5 relative (f32 sums in another order, scaled by 1/0.05);
``sharded_topk``'s ids and ``assign_clusters``' assignment equal; the
updated parameters within 1e-5, a tenth of one Adam step of lr 1e-4,
leaving out the key third of ``qkv_b`` (its gradient is 0 in exact
arithmetic, rounding noise in f32, which Adam turns into steps of
+-lr). A ``data=2`` step of the port equals its ``data=1`` step on the
same global batch: the loss within 3e-6 and each gradient within 1e-5
of the leaf's largest.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rag_foundation_tpu.models import encoder as jenc
from rag_foundation_tpu.ops.kmeans import assign_clusters as jax_assign
from rag_foundation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rag_foundation_tpu.parallel.mesh import shard_rows as jax_shard_rows
from rag_foundation_tpu.parallel.topk_merge import \
    sharded_topk as jax_sharded_topk
from rag_foundation_tpu_torch.models import encoder as tenc
from rag_foundation_tpu_torch.models import optim
from rag_foundation_tpu_torch.parallel.mesh import make_mesh, shard_rows
from rag_foundation_tpu_torch.parallel.train_step import \
    make_sharded_train_step
from rag_foundation_tpu_torch.tools import dryrun_multichip as tool

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = dict(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128,
            max_len=32, dtype="float32")
K, LR = 4, 1e-4
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
DP_LOSS_TOL, DP_GRAD_TOL = 3e-6, 1e-5


def _inputs(data=2, shards=2, hidden=64):
    """The dryrun's draws, in its order."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((64 * shards, hidden)).astype(np.float32)
    centroids = rng.standard_normal((8, hidden)).astype(np.float32)
    batch = 4 * data
    q_ids = np.zeros((batch, TINY["max_len"]), np.int32)
    q_ids[:, 0] = 1
    q_ids[:, 1:8] = rng.integers(3, 500, (batch, 7))
    return corpus, centroids, q_ids, np.roll(q_ids, 1, axis=1)


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_full_step(jcfg, params, corpus, centroids, q_ids, d_ids):
    """``__graft_entry__.dryrun_multichip``'s ``full_step``, jitted on a
    (data 2, shard 2) mesh."""
    mesh = jax_make_mesh(2, data=2)
    optimizer = optax.adam(LR)
    base_step = jenc.make_train_step(jcfg, optimizer)

    def full_step(params, opt_state, q_ids, d_ids, corpus_sh, cents):
        params, opt_state, loss = base_step(params, opt_state, q_ids, d_ids)
        qvec = jenc.encode_tokens(params, q_ids, jcfg)
        vals, idxs = jax_sharded_topk(qvec, corpus_sh, K, mesh=mesh,
                                      block_size=32)
        assign, _ = jax_assign(qvec, cents, block_size=32)
        return params, opt_state, loss, vals, idxs, assign

    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P("data"))
    out = jax.jit(full_step)(
        jax.device_put(params, repl),
        jax.device_put(optimizer.init(params), repl),
        jax.device_put(jnp.asarray(q_ids), batch_sh),
        jax.device_put(jnp.asarray(d_ids), batch_sh),
        jax_shard_rows(mesh, jnp.asarray(corpus)),
        jax.device_put(jnp.asarray(centroids), repl))
    params, _, loss, vals, idxs, assign = out
    return (_jax_leaves(params), float(loss), np.asarray(vals),
            np.asarray(idxs), np.asarray(assign))


def _port_step(tp, data, corpus, centroids, q_ids, d_ids):
    mesh = make_mesh(2, data=data, devices=[CPU] * (2 * data))
    step = make_sharded_train_step(tenc.EncoderConfig(**TINY),
                                   optim.adam(LR), mesh, k=K, block_size=32)
    return step(tp, torch.as_tensor(q_ids), torch.as_tensor(d_ids),
                shard_rows(mesh, torch.as_tensor(corpus)),
                torch.as_tensor(centroids))


@pytest.fixture(scope="module")
def jax_params():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    return jenc.init_params(jax.random.key(0), jenc.EncoderConfig(**TINY))


def _port_params(jp):
    return tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")


def test_sharded_step_matches_jax_full_step(jax_params):
    corpus, centroids, q_ids, d_ids = _inputs()
    want, jloss, jvals, jidxs, jassign = _jax_full_step(
        jenc.EncoderConfig(**TINY), jax_params, corpus, centroids, q_ids,
        d_ids)
    tp = _port_params(jax_params)
    before = {k: t.clone() for k, t in tenc._leaves(tp).items()}
    out = _port_step(tp, 2, corpus, centroids, q_ids, d_ids)
    assert out.loss.shape == () and not out.loss.requires_grad
    assert abs(float(out.loss) - jloss) <= LOSS_RTOL * abs(jloss)
    np.testing.assert_array_equal(out.indices.numpy(), jidxs)
    np.testing.assert_array_equal(out.assign.numpy(), jassign)
    np.testing.assert_allclose(out.values.numpy(), jvals, rtol=1e-5,
                               atol=1e-5)
    assert out.indices.dtype == torch.int32 and out.assign.shape == (8,)
    h = TINY["hidden"]
    moved = 0
    for key, w in want.items():
        got = tenc._leaves(tp)[key].detach().numpy()
        moved += not np.array_equal(got, before[key].numpy())
        if key.endswith("['qkv_b']"):        # the key bias: see the top
            got, w = np.delete(got, np.s_[h:2 * h]), \
                np.delete(w, np.s_[h:2 * h])
        np.testing.assert_allclose(got, w, rtol=0, atol=PARAM_TOL,
                                   err_msg=key)
    assert moved == len(want)          # every leaf took its step


def test_data_rows_give_the_global_batch_step(jax_params):
    corpus, centroids, q_ids, d_ids = _inputs()
    grads = {}
    for data in (1, 2):
        tp = _port_params(jax_params)
        out = _port_step(tp, data, corpus, centroids, q_ids, d_ids)
        grads[data] = ({k: t.grad.numpy().copy()
                        for k, t in tenc._leaves(tp).items()},
                       float(out.loss), out)
    (g1, loss1, out1), (g2, loss2, out2) = grads[1], grads[2]
    assert abs(loss2 - loss1) <= DP_LOSS_TOL
    for key, want in g1.items():
        tol = DP_GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g2[key], want, rtol=0, atol=tol,
                                   err_msg=key)
    np.testing.assert_array_equal(out2.indices.numpy(), out1.indices.numpy())
    np.testing.assert_array_equal(out2.assign.numpy(), out1.assign.numpy())
    # a loss per data row (plain DDP: negatives from the row's own half)
    # is another loss, far outside the tolerance
    tp = _port_params(jax_params)
    cfg = tenc.EncoderConfig(**TINY)
    per_row = np.mean([float(tenc.contrastive_loss(
        tp, torch.as_tensor(q), torch.as_tensor(d), cfg))
        for q, d in zip(np.split(q_ids, 2), np.split(d_ids, 2))])
    assert abs(per_row - loss1) > 1000 * DP_LOSS_TOL, (per_row, loss1)


def test_a_batch_that_does_not_divide_over_the_rows_raises(jax_params):
    corpus, centroids, q_ids, d_ids = _inputs()
    with pytest.raises(ValueError, match="does not divide over 2"):
        _port_step(_port_params(jax_params), 2, corpus, centroids,
                   q_ids[:7], d_ids[:7])


def test_dryrun_tool_mesh_rule_as_jax():
    assert [tool.mesh_shape(n) for n in (1, 2, 3, 4, 6, 8)] == \
        [(1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (2, 4)]


def test_dryrun_tool_runs_to_its_ok_line():
    out = subprocess.run(
        [sys.executable, "-m", "rag_foundation_tpu_torch.tools."
         "dryrun_multichip", "--devices", "8", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip OK: mesh={'data': 2, 'shard': 4} loss=" \
        in out.stdout
