"""The comparison that decides ``correct``.

Numbers of a run, each held to the limit its configuration file gives
(``limits``; all are "at most"):

- ``score_gap``: the widest gap between a served score and the
  reference's score of the same (query, row) (``Reference.scores``). A
  served slot that holds no row, a row out of range, a row twice or a
  score that is not finite reads as an infinite gap.
- ``rank_miss``: the share of ranks of the reference's top-k over each
  query's kept probed lists (``Reference.probe_topk``) at which the
  served answer scores lower: one-sided, so an answer
  that beats the reference's dispatch policy misses nothing.
- ``recall_miss``: one less the mean recall@10 of the window's answered
  queries against the exact f32 top-10 (``Reference.scan``), which
  takes nothing of the program: the one number that sees the build's
  quality (k-means, codebook). Its limit is the configuration's stated
  floor, recall@10 at least 0.95.
- ``stored_mismatch``, ``coverage_errors``, ``misplaced_rows``: the
  built index the reference follows. Sampled rows as the program stores
  them against the reference's quantization; row ids that are not held
  exactly once by the lists and the exact tail together; sampled rows
  held by a list whose centroid is farther than the nearest (or, where
  the build spills full lists, the second nearest) by more than
  ``PLACE_TOL``. Exact comparisons: limit 0.
- ``misencoded_rows`` (product-quantized lists): sampled rows whose code
  in some subspace is not the codeword nearest to the row's residual
  from its list's centroid (``CODE_TOL``). Exact: limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

# f32 rounding of a 768-term centroid score is below 1e-6; a row's own
# list may be worse than its nearest by no more than this
PLACE_TOL = 1e-5
# the same for a codeword's squared distance to a 4-wide residual slice
CODE_TOL = 1e-6


def valid_slots(ids: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """``[S, k]`` bool: the slot holds a row in range, finite, and the
    row is not served twice to the same query."""
    ok = (ids >= 0) & (ids < n) & np.isfinite(vals)
    order = np.argsort(ids, axis=1, kind="stable")
    srt = np.take_along_axis(ids, order, axis=1)
    same = srt[:, 1:] == srt[:, :-1]
    twice_sorted = np.zeros(ids.shape, bool)
    twice_sorted[:, 1:] |= same
    twice_sorted[:, :-1] |= same
    twice = np.zeros(ids.shape, bool)
    np.put_along_axis(twice, order, twice_sorted, axis=1)
    return ok & ~twice


def served_checks(ref, ids: np.ndarray, vals: np.ndarray, q8: np.ndarray,
                  s_scale: np.ndarray, probes: torch.Tensor,
                  kept: torch.Tensor, state: dict,
                  q32: np.ndarray | None = None) -> dict[str, float]:
    """``score_gap`` and ``rank_miss`` of served ``(ids, vals) [S, k]``
    for queries ``q8 [S, d]`` (int8 as the configuration states) with
    score scales ``s_scale [S]``; ``q32`` (the queries the
    product-quantized stage scores) where the index holds codes."""
    dev = ref.corpus.device
    n = ref.corpus.n
    ok = valid_slots(ids, vals, n)
    q8_t = torch.as_tensor(q8, device=dev)
    sc_t = torch.as_tensor(np.asarray(s_scale, np.float32), device=dev)
    mine = ref.scores(q8_t, sc_t, torch.as_tensor(ids, device=dev)
                      ).cpu().numpy()
    gap = np.where(ok, np.abs(vals.astype(np.float64) - mine), np.inf)
    adc = None
    if "codes" in state:
        adc = {"codebook": state["codebook"], "codes": state["codes"],
               "centroids": state["centroids"],
               "candidates": ref.cfg["adc_candidates"],
               "q32": torch.as_tensor(q32, device=dev)}
    r_v, _ = ref.probe_topk(q8_t, sc_t, probes, kept, state["list_rows"],
                            state["tail_rows"], adc)
    r_v = r_v.cpu().numpy()
    return {"score_gap": float(gap.max()),
            "rank_miss": rank_miss(r_v, np.where(ok, mine, -np.inf))}


def recall_miss(truth: np.ndarray, ids: np.ndarray) -> tuple[int, int]:
    """``(misses, total)``: the rows of the exact top-k ``truth [S, k]``
    that the answers ``ids [S, k]`` do not hold."""
    hits = int((truth[:, :, None] == ids[:, None, :]).any(axis=2).sum())
    return truth.size - hits, truth.size


def rank_miss(ref_vals: np.ndarray, served_vals: np.ndarray) -> float:
    """Share of the reference's ranks that the served answer falls short
    of: rank ``i`` of a query is missed when the ``i``-th best score
    among its served rows (by the reference's score of each row; an
    invalid slot reads -inf) is below the reference's ``i``-th best.
    Rows that tie the reference's stand in for them, and an answer
    better than the reference's (rows from a probe the reference drops)
    misses nothing. ``ref_vals [S, k]`` descending, -inf where the
    reference has fewer than ``k`` rows (not counted)."""
    srt = -np.sort(-served_vals, axis=1)
    counted = np.isfinite(ref_vals)
    missed = counted & (srt < ref_vals)
    return float(missed.sum() / max(1, counted.sum()))


def build_checks(ref, state: dict, sample: torch.Tensor, spill: bool
                 ) -> dict[str, float]:
    """The three checks of the built index (see the module docstring).
    ``state``: the program's ``centroids [nlist, d]``, ``list_rows
    [nlist, cap]``, ``tail_rows [T]`` and ``stored [len(sample), d]``
    int8 (the sampled rows as the program holds them)."""
    n = ref.corpus.n
    list_rows = state["list_rows"]
    flat = list_rows.reshape(-1).long()
    live = flat >= 0
    held = torch.bincount(flat[live], minlength=n)[:n]
    tail = state["tail_rows"].long()
    if len(tail):
        held = held + torch.bincount(tail, minlength=n)[:n]
    coverage = int((held != 1).sum())

    mine = ref.rows8[sample]
    stored = int((state["stored"] != mine).any(dim=1).sum())

    cap = list_rows.shape[1]
    where = torch.full((n,), -1, dtype=torch.int64, device=flat.device)
    pos = torch.nonzero(live).squeeze(1)
    where[flat[pos]] = pos
    at = where[sample]
    has = at >= 0
    own = at[has] // cap
    c = state["centroids"].float()
    x = mine[has].float() * np.float32(ref.cfg["scale"])
    score = x @ c.T - 0.5 * (c * c).sum(dim=1)[None, :]
    top = torch.topk(score, 2, dim=1).values
    floor = top[:, 1] if spill else top[:, 0]
    own_score = torch.gather(score, 1, own[:, None]).squeeze(1)
    out = {"stored_mismatch": float(stored),
           "coverage_errors": float(coverage),
           "misplaced_rows": float(int((own_score < floor - PLACE_TOL
                                        ).sum()))}
    if "codes" in state:
        codes = state["codes"].reshape(-1, state["codes"].shape[-1])[at[has]]
        out["misencoded_rows"] = float(misencoded(
            x - c[own], codes, state["codebook"]))
    return out


def misencoded(residual: torch.Tensor, codes: torch.Tensor,
               codebook: torch.Tensor) -> int:
    """Rows whose code in some subspace names a codeword farther from the
    residual than the nearest by more than ``CODE_TOL``."""
    m, _, dsub = codebook.shape
    r = residual.reshape(len(residual), m, dsub).transpose(0, 1)
    dist = torch.cdist(r, codebook) ** 2                 # [m, S, K]
    chosen = torch.gather(dist, 2, codes.T.long()[:, :, None]).squeeze(2)
    return int((chosen > dist.min(dim=2).values + CODE_TOL).any(dim=0).sum())


def served_gaps(ref_logits: torch.Tensor, prompt_len: int, served,
                prefill: torch.Tensor, allowed: torch.Tensor
                ) -> tuple[float, float]:
    """``(logit_gap, token_deficit)`` of one request: ``ref_logits [s,
    vocab]`` the reference's over the prompt and every served token but
    the last, ``served [n]`` the answer's ids, ``prefill [vocab]`` the
    logits the program's prefill returned, ``allowed [vocab]`` the
    tokens the answer may use."""
    rows = ref_logits[prompt_len - 1:]
    std = rows.std(dim=1, unbiased=False)
    gap = float(((prefill.float() - rows[0]).abs().max() / std[0]).item())
    tok = torch.as_tensor(served, dtype=torch.int64, device=rows.device)
    best = rows.masked_fill(~allowed, float("-inf")).max(dim=1).values
    mine = rows.gather(1, tok[:, None]).squeeze(1)
    deficit = torch.where(allowed[tok], (best - mine) / std,
                          torch.full_like(best, float("inf")))
    return gap, float(deficit.max().item())


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at most
    its limit; a number without a limit fails."""
    out = {name: {"value": v, "limit": limits.get(name)}
           for name, v in numbers.items()}
    ok = all(e["limit"] is not None and e["value"] <= e["limit"]
             for e in out.values())
    return ok, out
