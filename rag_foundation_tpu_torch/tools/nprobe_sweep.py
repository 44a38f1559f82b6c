"""BASELINE config 3: a 1M x 768 bf16 IVF-Flat index (nlist 4096), nprobe
swept to recall@10 >= 0.95 against the exact scan.

    python -m rag_foundation_tpu_torch.tools.nprobe_sweep
    python -m rag_foundation_tpu_torch.tools.nprobe_sweep --device cpu \\
        --n 8000 --d 64 --nlist 32 --q 64 --centers 64 --sample 4096

Counterpart of ``benchmarks/sweep_nprobe.py`` with the same settings and
structure, the rows drawn from the same distribution (not the same draws:
a ``torch.Generator`` seeded with ``--seed`` replaces ``jax.random``): a
clustered corpus of ``--centers`` unit centres plus ``--noise``/sqrt(d)
normal noise, l2-normalised; queries are the first ``--q`` rows plus
``--qnoise``/sqrt(d) noise, l2-normalised. The index is
``build_ivf_flat(corpus_bf16, nlist, kmeans_iters=8, sample=262_144)``
(k-means training included in the build seconds), the ground truth
``exact_topk`` in bf16 (``block_size=65_536``), and each nprobe of the
sweep one ``ivf_search(k=10, p=3, approx_select=True)``: recall@10, ms a
batch (host clock, the device synchronised) and QPS, dropped probes.
Prints one JSON line with the card's name and power limit. It writes no
file. On the card the list-scan kernel builds at first use (``nvcc``);
``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from rag_foundation_tpu_torch.engine.ivf import build_ivf_flat, ivf_search
from rag_foundation_tpu_torch.ops.l2norm import l2_normalize
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.tools.exact_scan import card_line, recall
from rag_foundation_tpu_torch.utils.device import resolve_device

NPROBES = (4, 8, 16, 32, 64, 128)
RECALL_TARGET = 0.95      # config 3's own definition
_CHUNK = 131_072          # rows generated a step


def make_corpus(n: int, d: int, q_n: int, *, centers: int = 8192,
                noise: float = 0.5, qnoise: float = 0.2, seed: int = 0,
                device: str | torch.device = "cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus [n, d] f32, queries [q_n, d] f32), unit rows, on
    ``device``: config 3's clustered corpus, made in chunks."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    cen = l2_normalize(torch.randn((centers, d), generator=g, device=dev))
    corpus = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        cid = torch.randint(0, centers, (hi - lo,), generator=g, device=dev)
        corpus[lo:hi] = l2_normalize(
            cen[cid] + (noise / math.sqrt(d))
            * torch.randn((hi - lo, d), generator=g, device=dev))
    queries = l2_normalize(
        corpus[:q_n] + (qnoise / math.sqrt(d))
        * torch.randn((q_n, d), generator=g, device=dev))
    return corpus, queries


def build(corpus: torch.Tensor, nlist: int, *, seed: int = 0,
          sample: int = 262_144, dtype: torch.dtype = torch.bfloat16):
    """(index, seconds): config 3's build of ``corpus`` as lists of
    ``dtype`` (bf16, or f32 as the engine's ``ivf_flat`` mode stores),
    k-means on the first ``sample`` rows for 8 iterations, the device
    synchronised."""
    dev = corpus.device
    src = corpus.to(dtype)
    t0 = time.perf_counter()
    index = build_ivf_flat(src, nlist,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed), kmeans_iters=8,
                           sample=sample, dtype=dtype)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return index, time.perf_counter() - t0


def ground_truth(queries: torch.Tensor, corpus: torch.Tensor, k: int = 10
                 ) -> torch.Tensor:
    """Row ids [Q, k] of the exact scan in bf16, as config 3 takes them."""
    _, ids = exact_topk(queries.bfloat16(), corpus.bfloat16(), k,
                        block_size=65_536)
    return ids


def search_point(index, queries: torch.Tensor, truth: torch.Tensor,
                 nprobe: int, *, k: int = 10, p: int = 3, reps: int = 5
                 ) -> dict:
    """One point of the sweep: recall@k, ms a batch and QPS (``reps``
    searches after one that warms up and gives the recall), dropped
    probes."""
    dev = index.lists.device

    def search():
        return ivf_search(index, queries, k, nprobe=nprobe, p=p,
                          approx_select=True)

    _, ids, dropped = search()
    rec = recall(ids.cpu(), truth.cpu(), k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = search()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    per = (time.perf_counter() - t0) / reps
    del out
    return {"nprobe": nprobe, "recall_at_10": rec,
            "qps": queries.shape[0] / per, "ms_per_batch": per * 1e3,
            "dropped_probes": int(dropped)}


def sweep(index, queries, truth, *, nprobes=NPROBES, k: int = 10,
          p: int = 3, reps: int = 5) -> list[dict]:
    return [search_point(index, queries, truth, nprobe, k=k, p=p, reps=reps)
            for nprobe in nprobes]


def smallest_nprobe(rows: list[dict], target: float = RECALL_TARGET
                    ) -> int | None:
    """The smallest nprobe of the sweep reaching ``target`` recall@10."""
    hits = [r["nprobe"] for r in rows if r["recall_at_10"] >= target]
    return min(hits) if hits else None


def run_sweep(device: str | torch.device = "cuda", *, n: int = 1_000_000,
              d: int = 768, nlist: int = 4096, q_n: int = 1024, k: int = 10,
              p: int = 3, centers: int = 8192, noise: float = 0.5,
              qnoise: float = 0.2, sample: int = 262_144, seed: int = 0,
              nprobes=NPROBES, reps: int = 5) -> dict:
    dev = resolve_device(device)
    corpus, queries = make_corpus(n, d, q_n, centers=centers, noise=noise,
                                  qnoise=qnoise, seed=seed, device=dev)
    index, build_s = build(corpus, nlist, seed=seed, sample=sample)
    truth = ground_truth(queries, corpus, k)
    del corpus
    rows = sweep(index, queries, truth, nprobes=nprobes, k=k, p=p,
                 reps=reps)
    return {
        "metric": f"{n}x{d} bf16 IVF-Flat nlist {nlist}: recall@{k} and "
                  f"QPS by nprobe, 1 device",
        "config": {"n": n, "d": d, "nlist": nlist, "q": q_n, "k": k, "p": p,
                   "centers": centers, "noise": noise, "qnoise": qnoise,
                   "sample": sample, "kmeans_iters": 8, "seed": seed},
        "cap_len": index.cap_len, "build_s": build_s, "sweep": rows,
        "smallest_nprobe_at_target": smallest_nprobe(rows),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card_line() if dev.type == "cuda" else None,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--centers", type=int, default=8192)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--qnoise", type=float, default=0.2)
    ap.add_argument("--sample", type=int, default=262_144)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    print(json.dumps(run_sweep(
        args.device, n=args.n, d=args.d, nlist=args.nlist, q_n=args.q,
        k=args.k, p=args.p, centers=args.centers, noise=args.noise,
        qnoise=args.qnoise, sample=args.sample, seed=args.seed,
        reps=args.reps)))


if __name__ == "__main__":
    main()
