"""The docwalk corpus of ``perfbench/corpus.py`` on the CPU: a pure
function of (seed, row), and held to the statistics of
``benchmarks/corpus.py``'s generator (its structure, written out in
numpy with its constants, which this test reads from the source as
numbers without importing it)."""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.corpus import Docwalk, mix
from perfbench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[2]
D = 768


def jax_constants() -> dict:
    tree = ast.parse((ROOT / "benchmarks" / "corpus.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant):
            out[node.targets[0].id] = node.value.value
    return out


def numpy_docwalk(n_docs, d, topics, cpd, alpha, delta, seed):
    """``gen_docwalk_chunk``'s structure (benchmarks/corpus.py) in numpy:
    a doc centre near a random topic, a cumulative walk of steps,
    l2-normalised; draws of its own."""
    rng = np.random.default_rng(seed)
    top = rng.standard_normal((topics, d))
    top /= np.linalg.norm(top, axis=1, keepdims=True)
    t = rng.integers(0, topics, n_docs)
    dc = top[t] + alpha / np.sqrt(d) * rng.standard_normal((n_docs, d))
    steps = delta / np.sqrt(d) * rng.standard_normal((n_docs, cpd, d))
    x = dc[:, None, :] + np.cumsum(steps, axis=1)
    x /= np.linalg.norm(x, axis=2, keepdims=True)
    return x, top[t]


def stats(x: np.ndarray, topic_rows: np.ndarray) -> dict:
    """Step norms along a walk, a document's spread around its topic and
    around its own first chunk."""
    step = np.linalg.norm(x[:, 1:] - x[:, :-1], axis=2)
    return {"step": float(step.mean()),
            "topic_cos": float((x[:, 0] * topic_rows).sum(axis=1).mean()),
            "walk_cos": float((x[:, -1] * x[:, 0]).sum(axis=1).mean())}


@pytest.fixture(scope="module")
def constants():
    return jax_constants()


def test_configs_use_the_jax_constants(constants):
    for name in ("ivf_int8_10m", "ivf_pq_10m"):
        cfg = json.loads((ROOT / "perfbench" / "configs" /
                          f"{name}.json").read_text())
        c = cfg["corpus"]
        assert (c["cpd"], c["alpha"], c["delta"]) == (
            constants["CPD"], constants["ALPHA"], constants["DELTA"])
        assert cfg["dim"] == D and c["topics"] == cfg["nlist"] == 4096
    for name in ("q1024", "q64"):
        t = json.loads((ROOT / "perfbench" / "traffic" /
                        f"{name}.json").read_text())
        assert t["qnoise"] == constants["QNOISE"]


def test_statistics_match_the_jax_generator(constants):
    c = constants
    docs = 2048
    walk = Docwalk(11, docs * c["CPD"], D, topics=256, cpd=c["CPD"],
                   alpha=c["ALPHA"], delta=c["DELTA"], device="cpu",
                   block=c["CPD"] * 256)
    x = torch.cat([b for _, _, b in walk.blocks()]).numpy()
    x = x.reshape(docs, c["CPD"], D)
    # the topic of each document, found again from its first chunk
    topic_rows = walk.topics.numpy()[
        np.argmax(x[:, 0] @ walk.topics.numpy().T, axis=1)]
    mine = stats(x, topic_rows)
    ref_x, ref_t = numpy_docwalk(docs, D, 256, c["CPD"], c["ALPHA"],
                                 c["DELTA"], 5)
    theirs = stats(ref_x, ref_t)
    for key in mine:
        assert mine[key] == pytest.approx(theirs[key], rel=0.01), key
    # the walk step a chunk, about delta over the row's length
    assert mine["step"] == pytest.approx(
        c["DELTA"] / math.sqrt(1 + c["ALPHA"] ** 2 + 7.5 * c["DELTA"] ** 2),
        rel=0.05)


def test_query_to_source_similarity(constants):
    c = constants
    walk = Docwalk(3, 64 * c["CPD"], D, topics=64, cpd=c["CPD"],
                   alpha=c["ALPHA"], delta=c["DELTA"], device="cpu",
                   block=c["CPD"] * 16)
    t = Traffic({"batch": 64, "pool": 512, "qnoise": c["QNOISE"]}, walk, 3)
    src = walk.rows(torch.as_tensor(t.sources)).numpy()
    cos = (t.pool * src).sum(axis=1)
    assert cos.mean() == pytest.approx(1 / math.sqrt(1 + c["QNOISE"] ** 2),
                                       rel=0.005)
    assert np.allclose(np.linalg.norm(t.pool, axis=1), 1, atol=1e-5)


@pytest.mark.parametrize("lo,hi", [(0, 1), (5, 300), (250, 260),
                                   (1000, 1024)])
def test_any_rows_regenerate_bit_for_bit(lo, hi):
    kw = dict(topics=32, cpd=16, alpha=0.3, delta=0.16, device="cpu",
              block=256)
    a = Docwalk(2**31 + 11, 1024, 64, **kw)
    whole = torch.cat([b for _, _, b in a.blocks()])
    again = Docwalk(2**31 + 11, 1024, 64, **kw)
    assert torch.equal(again.rows(torch.arange(lo, hi)), whole[lo:hi])
    picks = torch.tensor([hi - 1, lo, hi - 1])
    assert torch.equal(again.rows(picks), whole[picks])


def test_seeds_give_other_rows_and_the_same_sizes():
    kw = dict(topics=32, cpd=16, alpha=0.3, delta=0.16, device="cpu",
              block=256)
    a = Docwalk(1, 512, 64, **kw).block(1)
    b = Docwalk(2, 512, 64, **kw).block(1)
    assert a.shape == b.shape and not torch.equal(a, b)
    assert mix(1, 1) != mix(2, 1) and mix(2**40, 3) < 2**63
