"""The exact flat scan at one million rows: the two-stage kernel timed,
its recall held against the two exact scans.

    python -m rag_foundation_tpu_torch.tools.exact_scan
    python -m rag_foundation_tpu_torch.tools.exact_scan --device cpu --rows 20000

Counterpart of ``bench.py::run_exact_1m``: a bf16 corpus of ``--rows`` x
768 made on the device in chunks from a seeded generator, queries = the
first ``--queries`` rows plus 0.1 x noise, top-10. ``block_topk(p=2,
block_n=1024)`` is timed (CUDA events on the card, the host clock on the
CPU); its recall@10 on 256 queries is taken against ``fused_topk`` and
against ``exact_topk``, which must give the same ids except between rows
whose scores differ by less than the summation-order error. Prints one
JSON line. On the card it needs ``nvcc`` (the kernels build at first use);
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from rag_foundation_tpu_torch.ops.block_topk import block_topk
from rag_foundation_tpu_torch.ops.fused_topk import fused_topk
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.utils.device import resolve_device

_CHUNK = 131_072
RECALL_QUERIES = 256


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_corpus(n: int, d: int, q_n: int, seed: int, dev: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus [n, d] bf16, queries [q_n, d] bf16) on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        corpus[lo:hi] = torch.randn((hi - lo, d), generator=g, device=dev)
    noise = torch.randn((q_n, d), generator=g, device=dev)
    queries = (corpus[:q_n].float() + 0.1 * noise).bfloat16()
    return corpus, queries


def score_tolerance(queries: torch.Tensor, corpus: torch.Tensor) -> float:
    """Bound on the difference of two f32 sums of the same ``d`` exact
    products taken in different orders: ``d * 2**-24 * sum|q_i c_i|``,
    with the sum bounded by the largest norms (Cauchy-Schwarz)."""
    d = corpus.shape[1]
    cmax = max(float(corpus[lo:lo + _CHUNK].float().norm(dim=1).max())
               for lo in range(0, corpus.shape[0], _CHUNK))
    return d * 2.0 ** -24 * float(queries.float().norm(dim=1).max()) * cmax


def id_mismatches(queries, corpus, ids_a, ids_b, tol: float) -> int:
    """Positions where two exact scans name different rows. Raises unless
    the two rows' scores (recomputed in f64) lie within ``tol``."""
    off = (ids_a != ids_b).nonzero()
    for qi, j in off.tolist():
        a, b = int(ids_a[qi, j]), int(ids_b[qi, j])
        if a < 0 or b < 0:
            raise RuntimeError(f"query {qi} rank {j}: ids {a} vs {b}")
        qv = queries[qi].double()
        sa, sb = float(qv @ corpus[a].double()), float(qv @ corpus[b].double())
        if abs(sa - sb) > tol:
            raise RuntimeError(
                f"query {qi} rank {j}: rows {a} ({sa}) and {b} ({sb}) differ "
                f"by more than the tolerance {tol}")
    return len(off)


def recall(served: torch.Tensor, truth: torch.Tensor, k: int) -> float:
    return sum(len(set(a) & set(b)) / k
               for a, b in zip(served.tolist(), truth.tolist())) / len(truth)


def run_exact_1m(device: str | torch.device = "cuda", n: int = 1_000_000,
                 d: int = 768, q_n: int = 1024, k: int = 10, seed: int = 0,
                 reps: int = 10) -> dict:
    dev = resolve_device(device)
    corpus, queries = make_corpus(n, d, q_n, seed, dev)
    kw = dict(p=2, block_n=1024)
    _, ids = block_topk(queries, corpus, k, **kw)          # warm / build
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            _, ids = block_topk(queries, corpus, k, **kw)
        stop.record()
        torch.cuda.synchronize(dev)
        per = start.elapsed_time(stop) / reps / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            _, ids = block_topk(queries, corpus, k, **kw)
        per = (time.perf_counter() - t0) / reps
    sub = min(RECALL_QUERIES, q_n)
    _, fused_ids = fused_topk(queries[:sub], corpus, k)
    _, exact_ids = exact_topk(queries[:sub], corpus, k)
    tol = score_tolerance(queries[:sub], corpus)
    near_ties = id_mismatches(queries, corpus, fused_ids, exact_ids, tol)
    return {
        "metric": f"{n}x{d} bf16 two-stage exact top-{k} QPS, 1 device",
        "rows": n, "d": d, "dtype": "bfloat16", "queries": q_n, "k": k,
        "qps": q_n / per, "ms_per_batch": per * 1e3,
        "recall_vs_fused": recall(ids[:sub], fused_ids, k),
        "recall_vs_exact": recall(ids[:sub], exact_ids, k),
        "recall_queries": sub,
        "fused_vs_exact_near_ties": near_ties, "score_tolerance": tol,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_line() if dev.type == "cuda" else None,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(run_exact_1m(args.device, n=args.rows, q_n=args.queries,
                                  seed=args.seed)))


if __name__ == "__main__":
    main()
