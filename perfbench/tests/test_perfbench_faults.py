"""The check that decides ``correct`` fails what it must, on the CPU at
a tiny size: the control (the exact scan at int4 put in the program's
place) and runs whose timed path is broken underneath, once for each
fault a cell can have: an answer altered where it is produced, and half
of a batch left out; and a codebook that was never fitted, which the
build checks cannot see and the recall against the exact answer does."""

import numpy as np
import pytest
import torch

from perfbench import compare, control, harness

CELLS = ["ivf_int8_10m.q1024", "ivf_pq_10m.q1024", "ivf_int8_10m.q64"]


def one_run(root, cell, seed=2147483659):
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", "1", "--device", "cpu"])
    return harness.run(args, root, 0.0)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass(tiny_root, cell):
    assert one_run(tiny_root, cell)["correct"] is True


@pytest.mark.parametrize("cell", ["ivf_int8_10m.q1024", "ivf_pq_10m.q1024"])
def test_the_control_fails(tiny_root, cell):
    args = harness.parse(["--workload", cell, "--seed", "1", "--seconds",
                          "1", "--device", "cpu"])
    numbers = control.control_numbers(args, tiny_root, 31)
    cfg = harness.load_cell(tiny_root, cell).cfg
    correct, checks = compare.judge(numbers, cfg["limits"])
    assert not correct
    assert checks["score_gap"]["value"] > 3 * checks["score_gap"]["limit"]
    assert checks["rank_miss"]["value"] > checks["rank_miss"]["limit"]


def alter_flat(monkeypatch):
    """The list scan returns each candidate's neighbouring slot."""
    from rag_foundation_tpu_torch.engine import ivf
    real = ivf.ivf_list_scan

    def altered(*a, **kw):
        vals, idx = real(*a, **kw)
        return vals, torch.where(idx >= 0, idx ^ 1, idx)
    monkeypatch.setattr(ivf, "ivf_list_scan", altered)


def alter_pq(monkeypatch):
    """The re-rank hands one query each row's neighbour in place of it."""
    from rag_foundation_tpu_torch.engine import ivfpq
    real = ivfpq._refine_rerank

    def altered(*a, **kw):
        vals, rows, k_eff = real(*a, **kw)
        rows = rows.clone()
        rows[3] = torch.where(rows[3] >= 0, rows[3] ^ 1, rows[3])
        return vals, rows, k_eff
    monkeypatch.setattr(ivfpq, "_refine_rerank", altered)


def half_left_out(monkeypatch, name):
    """The search answers the first half of each batch; the second half
    gets the first half's rows."""
    from rag_foundation_tpu_torch.engine import index
    real = getattr(index, name)

    def half(body, queries, *a, **kw):
        vals, rows, dropped = real(body, queries[: len(queries) // 2], *a,
                                   **kw)
        return (torch.cat([vals, vals]), torch.cat([rows, rows]), dropped)
    monkeypatch.setattr(index, name, half)


@pytest.mark.parametrize("cell,fault", [
    ("ivf_int8_10m.q1024", alter_flat),
    ("ivf_int8_10m.q64", alter_flat),
    ("ivf_pq_10m.q1024", alter_pq),
    ("ivf_int8_10m.q1024", lambda mp: half_left_out(mp, "ivf_search")),
    ("ivf_int8_10m.q64", lambda mp: half_left_out(mp, "ivf_search")),
    ("ivf_pq_10m.q1024", lambda mp: half_left_out(mp, "ivfpq_search")),
])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = one_run(tiny_root, cell)
    assert out["correct"] is False
    failed = [n for n, c in out["checks"].items()
              if c["value"] == "inf" or c["value"] > c["limit"]]
    assert "score_gap" in failed or "rank_miss" in failed


def unfitted_codebook(monkeypatch):
    """The product quantizer's codebook is seeded around one point and
    never iterates: each subspace's codewords lie near that point's
    slice. Every row still takes its nearest codeword."""
    from rag_foundation_tpu_torch.ops import pq

    def unfitted(x, k, *, generator, **kw):
        return x[:, :1].float() + 1e-3 * torch.randn(
            (x.shape[0], k, x.shape[2]), generator=generator,
            device=x.device)
    monkeypatch.setattr(pq, "kmeans_fit_batched", unfitted)


def test_an_unfitted_codebook_is_not_correct(tiny_root, monkeypatch):
    unfitted_codebook(monkeypatch)
    out = one_run(tiny_root, "ivf_pq_10m.q1024")
    assert out["correct"] is False
    failed = [n for n, c in out["checks"].items()
              if c["value"] == "inf" or c["value"] > c["limit"]]
    # the build checks follow the program's own codebook; the recall
    # against the exact top-10 sees it
    assert "recall_miss" in failed


def test_rank_miss_is_one_sided():
    ref = np.array([[0.9, 0.8, 0.7], [0.5, -np.inf, -np.inf]])
    # the reference's rows themselves, in another order: nothing missed
    assert compare.rank_miss(ref, np.array([[0.7, 0.9, 0.8],
                                            [0.5, 0.1, 0.0]])) == 0
    # better rows than the reference's (a probe it dropped): nothing
    assert compare.rank_miss(ref, np.array([[0.95, 0.9, 0.85],
                                            [0.6, 0.2, 0.1]])) == 0
    # the third rank short, an invalid slot: two of four counted ranks
    assert compare.rank_miss(ref, np.array([[0.9, 0.8, 0.69],
                                            [-np.inf, 0.4, 0.3]])) == 0.5


def test_recall_miss_counts_the_exact_rows_not_held():
    truth = np.array([[1, 2, 3], [4, 5, 6]])
    assert compare.recall_miss(truth, np.array([[3, 2, 1], [6, 9, 4]])) \
        == (1, 6)


def test_a_missing_limit_fails():
    assert compare.judge({"score_gap": 0.0}, {})[0] is False
    assert compare.judge({"score_gap": np.float64(0.0)},
                         {"score_gap": 0.0})[0] is True
