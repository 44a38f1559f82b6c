"""Time the exact scan of a host archive in several forms: the reference
behind ``Engine.recall_probe`` on an ``ivf_pq`` store with
``pq_refine="host"`` (``engine/index.py::archive_topk``).

    python -m rag_foundation_tpu_torch.tools.time_archive_scan \\
        --rows 100000000 --forms engine single one_pass blocked engine
    python -m rag_foundation_tpu_torch.tools.time_archive_scan \\
        --device cpu --rows 1200000

Fills a ``HostArchive`` of ``--rows`` x 768 int8 rows, uniform values made
on the device from ``--seed`` in chunks; every 1000th row is dead. The
queries are ``--queries`` stored rows widened to f32 plus N(0, 0.01^2)
noise, top ``--k``. Then runs the forms in the order given, once each,
and prints its seconds and whether its values and rows equal those of
the first form. The forms:

- ``engine``: ``archive_topk`` with a thread a core;
- ``single``: ``archive_topk`` with one thread (the reused buffer alone);
- ``one_pass``: each step widened into a fresh f32 array by one thread
  (``HostArchive.chunk_f32``), as the JAX package's ``StoreIndex`` does;
- ``blocked``: a thread a core, each widening 16,384 rows at a time into
  its own buffer and scoring them there (the f32 rows stay in the
  cache; its values may differ from the others' in the last bit).

It prints the card's name and power limit, the cores and the host's
memory, a line a form, and one JSON line. It needs ``--rows`` x 768
bytes of host memory and about 2 GB more.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.index import ARCHIVE_STEP, archive_topk
from rag_foundation_tpu_torch.tools.exact_scan import card_line
from rag_foundation_tpu_torch.utils.device import resolve_device

_CHUNK = 1 << 20
BLOCK = 16_384


def merge_step(best_v, best_r, s, lo, k):
    """Merge one step's scores ``s [Q, rows]`` into the running best."""
    kk = min(k, s.shape[1])
    part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
    allv = np.concatenate([best_v, np.take_along_axis(s, part, axis=1)],
                          axis=1)
    allr = np.concatenate([best_r, part + lo], axis=1)
    order = np.argsort(-allv, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(allv, order, axis=1),
            np.take_along_axis(allr, order, axis=1))


def one_pass(arch, live, q32, k):
    best_v = np.full((q32.shape[0], k), -np.inf, np.float32)
    best_r = np.full((q32.shape[0], k), -1, np.int64)
    for lo in range(0, len(live), ARCHIVE_STEP):
        hi = min(len(live), lo + ARCHIVE_STEP)
        s = q32 @ arch.chunk_f32(lo, hi).T
        s[:, ~live[lo:hi]] = -np.inf
        best_v, best_r = merge_step(best_v, best_r, s, lo, k)
    return best_v, best_r


def blocked(arch, live, q32, k):
    workers = os.cpu_count() or 1
    scale = np.float32(arch.scale)
    best_v = np.full((q32.shape[0], k), -np.inf, np.float32)
    best_r = np.full((q32.shape[0], k), -1, np.int64)
    s = np.empty((q32.shape[0], ARCHIVE_STEP), np.float32)
    local = threading.local()

    def score(a: int, b: int, lo: int) -> None:
        buf = getattr(local, "buf", None)
        if buf is None:
            buf = local.buf = np.empty((BLOCK, arch.dim), np.float32)
        np.multiply(arch.chunk_i8(a, b), scale, out=buf[:b - a],
                    dtype=np.float32)
        s[:, a - lo:b - lo] = q32 @ buf[:b - a].T

    with ThreadPoolExecutor(workers) as pool:
        for lo in range(0, len(live), ARCHIVE_STEP):
            hi = min(len(live), lo + ARCHIVE_STEP)
            list(pool.map(lambda a: score(a, min(hi, a + BLOCK), lo),
                          range(lo, hi, BLOCK)))
            step = s[:, :hi - lo]
            step[:, ~live[lo:hi]] = -np.inf
            best_v, best_r = merge_step(best_v, best_r, step, lo, k)
    return best_v, best_r


FORMS = {
    "engine": archive_topk,
    "single": lambda arch, live, q32, k: archive_topk(arch, live, q32, k,
                                                      workers=1),
    "one_pass": one_pass,
    "blocked": blocked,
}


def meminfo() -> dict:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, _, value = line.partition(":")
            if name in ("MemTotal", "MemAvailable"):
                out[name + "_GiB"] = int(value.split()[0]) / 2**20
    return out


def fill(rows: int, dim: int, seed: int, device: torch.device
         ) -> HostArchive:
    """An archive of ``rows`` uniform int8 rows made on ``device``."""
    arch = HostArchive(dim)
    arch.reserve(rows)
    gen = torch.Generator(device=device).manual_seed(seed)
    stage = torch.empty((_CHUNK, dim), dtype=torch.int8,
                        pin_memory=device.type == "cuda")
    for lo in range(0, rows, _CHUNK):
        take = min(_CHUNK, rows - lo)
        stage[:take].copy_(torch.randint(-127, 128, (take, dim),
                                         generator=gen, device=device,
                                         dtype=torch.int8))
        arch.append(stage[:take].numpy())
    return arch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the rows are made (default: the card)")
    ap.add_argument("--forms", nargs="+", choices=sorted(FORMS),
                    default=["engine", "single", "one_pass"])
    args = ap.parse_args()
    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"{card}; {os.cpu_count()} cores; host memory {meminfo()}",
          flush=True)

    t0 = time.perf_counter()
    arch = fill(args.rows, args.dim, args.seed, device)
    fill_s = time.perf_counter() - t0
    live = np.ones(args.rows, bool)
    live[::1000] = False
    rng = np.random.default_rng(args.seed)
    pick = rng.choice(args.rows, size=args.queries, replace=False)
    q32 = arch.rows_f32(pick) + rng.standard_normal(
        (args.queries, args.dim)).astype(np.float32) * np.float32(0.01)
    print(f"archive {args.rows} x {args.dim} int8 filled in {fill_s:.2f} s;"
          f" host memory {meminfo()}", flush=True)

    runs, first = [], None
    for name in args.forms:
        t0 = time.perf_counter()
        got = FORMS[name](arch, live, q32, args.k)
        sec = time.perf_counter() - t0
        if first is None:
            first = got
        same = (bool(np.array_equal(got[0], first[0])),
                bool(np.array_equal(got[1], first[1])))
        runs.append({"form": name, "s": sec, "values_equal": same[0],
                     "rows_equal": same[1]})
        print(f"{name}: {sec:.2f} s over {args.rows} rows, {args.queries} "
              f"queries, top {args.k}; values equal to {args.forms[0]}'s "
              f"{same[0]}, rows {same[1]} | {card}", flush=True)
    print(json.dumps({"rows": args.rows, "queries": args.queries,
                      "cores": os.cpu_count(), "card": card,
                      "fill_s": fill_s, "runs": runs}))


if __name__ == "__main__":
    main()
