#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rag_foundation_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py            # full size: 10M x 768 int8 IVF-Flat

Phases (each one fails the run: non-zero exit, no result line):

1. Card and build: the card's name and power limit, torch/CUDA versions,
   the kernel build from ``rag_foundation_tpu_torch/csrc`` (nvcc, sm_90a).
2. Each kernel against its plain PyTorch version on the card (int8 exact,
   f32/bf16 within a stated tolerance) at a small size.
3. The main path through the entry points a user calls: the port's
   ``Engine`` (ivf_flat_int8, d=768, nlist=4096, nprobe=32, p=3) behind
   ``EngineRpcServer``, driven only through ``RemoteEngine``: ingest real
   documents (enough to build an int8 body), pad the store to ``--rows``
   on the device, single and concurrent searches, a Q=1024 batch,
   citations, recall against the exact scan and the recall audit.
   Kernel launch counters are zeroed just before and read just after.
4. Restart: a fresh ``Engine`` on the same ``data_dir`` reloads the saved
   int8 body verbatim and gives the same hits.
5. The kernel against its plain version on the main path's Q=1024
   dispatch, with times: kernel, plain version, a library yardstick, and
   the bound.

The line before last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense
# operations/s per input type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1.979e15, "bf16": 0.989e15, "f32": 67e12}
# f32/bf16 scores of unit vectors: summation-order error is at most
# d * 2**-24 * sum|q_i r_i| <= 768 * 6e-8 = 4.6e-5 (bf16 products are exact
# in f32), so kernel and plain version agree within this
F32_TOL = 5e-5
RECALL_MIN = 0.95     # recall@10 of the served store vs the exact scan

_SYL = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "zu", "pe", "shi", "dra",
        "gon", "bel", "tor", "qua", "xen", "fli", "mur", "sol", "yat")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def project_name(i: int) -> str:
    c = (i * 7919 + 13) % 8000
    return "".join(_SYL[(c // 20 ** j) % 20] for j in range(3)).capitalize()


def fact_doc(i: int) -> str:
    return (f"Project {project_name(i)} report. The codename for project "
            f"{project_name(i)} is ZEBRA{i * 7}. Its budget is "
            f"{i * 13 % 997} thousand credits and its lead office is in "
            f"sector {i % 23} of campus {'north' if i % 2 else 'south'}.")


def fact_query(i: int) -> str:
    return f"What is the codename for project {project_name(i)}?"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def scan_bound(row_ids, live_n, qcap, p, esize, d, kind
               ) -> tuple[float, str, dict]:
    """(ms, "bytes" | "operations", counts): least time for one list scan
    with ``live_n[l]`` live query slots in list ``l``. The function needs
    the live query rows, the live rows of every list with a query (a dead
    row scores -inf from its id alone) and every id of those lists, read
    once, and writes every output (f32 value + int32 index) once; its
    operations are each live slot's dot with each live row of its list
    at the type's peak."""
    live_rows = (row_ids >= 0).sum(dim=1).double()
    read = live_n > 0
    nlist, cap_len = row_ids.shape
    c = {"lists_read": int(read.sum()), "live_slots": int(live_n.sum()),
         "rows_needed": int(live_rows[read].sum()),
         "rows_in_lists_read": int(read.sum()) * cap_len}
    out_elems = nlist * qcap * (cap_len // 128) * p
    nbytes = (c["live_slots"] + c["rows_needed"]) * d * esize \
        + c["rows_in_lists_read"] * 4 + nlist * 4 + out_elems * 8
    ops = 2.0 * d * float((live_n.double() * live_rows).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations", c


def check_scan(kv, ki, rv, ri, exact, q, lists, what):
    """Kernel (kv, ki) against plain version (rv, ri)."""
    import torch
    both = torch.isfinite(rv)
    if not torch.equal(torch.isfinite(kv), both):
        fail(f"{what}: -inf pattern differs")
    err = float((kv[both] - rv[both]).abs().max()) if both.any() else 0.0
    if exact:
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            bad = int((kv != rv).sum() + (ki != ri).sum())
            fail(f"{what}: kernel != plain version ({bad} elements)")
        return err
    if err > F32_TOL:
        fail(f"{what}: max |kernel - plain| {err} > {F32_TOL}")
    diff = (ki != ri).nonzero()
    if len(diff):
        # allowed only where both rows score within the tolerance
        cap_len = lists.shape[1]
        for l, s, j in diff.tolist():
            a, b = int(ki[l, s, j]), int(ri[l, s, j])
            qa = q[l, s].float()
            sa = float(qa @ lists[a // cap_len, a % cap_len].float())
            sb = float(qa @ lists[b // cap_len, b % cap_len].float())
            if abs(sa - sb) > F32_TOL:
                fail(f"{what}: idx differs beyond a near-tie at "
                     f"{(l, s, j)}: {a} ({sa}) vs {b} ({sb})")
    return err


def phase_small_kernels(ivf_scan, torch):
    """Kernel vs plain version on the card, all three types, small size."""
    g = torch.Generator(device="cuda").manual_seed(1)
    nlist, qcap, cap_len, d, p = 64, 16, 1024, 768, 3
    rows = torch.randn((nlist, cap_len, d), generator=g, device="cuda")
    rows /= rows.norm(dim=-1, keepdim=True)
    qs = torch.randn((nlist, qcap, d), generator=g, device="cuda")
    qs /= qs.norm(dim=-1, keepdim=True)
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    ids = torch.where(torch.rand(ids.shape, generator=g, device="cuda")
                      < 0.25, torch.full_like(ids, -1), ids)
    ids[3, 128:256] = -1      # a sub-block of dead rows
    s = 1.0 / 127.0
    cases = {
        "int8": (torch.clamp(torch.round(qs / s), -127, 127).to(torch.int8),
                 torch.clamp(torch.round(rows / s), -127, 127).to(
                     torch.int8), s * s),
        "f32": (qs.contiguous(), rows.contiguous(), 1.0),
        "bf16": (qs.bfloat16(), rows.bfloat16(), 1.0),
    }
    for kind, (q, lists, scale) in cases.items():
        kv, ki = ivf_scan.ivf_list_scan(q, lists, ids, p=p, scale=scale)
        torch.cuda.synchronize()
        rv, ri = ivf_scan.ivf_list_scan_reference(q, lists, ids, p=p,
                                                  scale=scale)
        err = check_scan(kv, ki, rv, ri, kind == "int8", q, lists,
                         f"ivf_list_scan {kind}")
        log(f"kernel check ivf_list_scan {kind} nlist={nlist} qcap={qcap} "
            f"cap_len={cap_len} d={d} p={p}: "
            + ("bit-identical" if kind == "int8" else
               f"max_abs_err={err:.3g} (tol {F32_TOL})"))


def library_ms_of(qdisp, lists, p):
    """Time of ``torch.bmm`` (f32) + ``torch.topk`` for the same scores
    and per-sub-block top-p, every slot computed. The f32 copy of the
    lists is made outside the timed region, in as few list chunks as the
    free memory holds (one when it all fits); chunk times add up.
    Returns (ms, chunks)."""
    import torch
    nlist, qcap, d = qdisp.shape
    cap_len = lists.shape[1]
    free, _ = torch.cuda.mem_get_info()
    per_list = (cap_len * d + qcap * d + 3 * qcap * cap_len) * 4
    step = max(1, min(nlist, int(free * 0.6) // per_list))
    total, chunks = 0.0, 0
    for lo in range(0, nlist, step):
        qf = qdisp[lo:lo + step].float()
        lf = lists[lo:lo + step].float()
        n = qf.shape[0]

        def library():
            sc = torch.bmm(qf, lf.transpose(1, 2))
            return torch.topk(sc.view(n, qcap, cap_len // 128, 128), p,
                              dim=-1)

        total += cuda_ms(library, reps=3, warmup=1)
        chunks += 1
        del qf, lf
    return total, chunks


def run_concurrent(remote, key, queries, threads):
    """Each thread sends its share of ``queries`` one at a time; returns
    (hits per query, wall seconds)."""
    out = [None] * len(queries)
    errors = []

    def worker(t):
        try:
            for i in range(t, len(queries), threads):
                out[i] = remote.search([key], queries[i], k=5)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in ts):
        fail(f"concurrent searches failed: {errors[:3]}")
    return out, wall


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="store size after padding (default 10M)")
    ap.add_argument("--docs", type=int, default=400,
                    help="real documents ingested before padding")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "rag_foundation_tpu_torch").is_dir():
        fail("rag_foundation_tpu_torch/ not found beside chip_smoke.py: run "
             "it from a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA card")
    sys.path.insert(0, str(ROOT))
    from rag_foundation_tpu_torch.engine.api import Engine, EngineConfig
    from rag_foundation_tpu_torch.engine.ivf import scan_inputs
    from rag_foundation_tpu_torch.engine.profile import search_profile
    from rag_foundation_tpu_torch.engine.rpc import (EngineRpcServer,
                                                     RemoteEngine)
    from rag_foundation_tpu_torch.ops import cuda_lib, ivf_scan

    # -- phase 1: card and build -------------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = cuda_lib.build(["ivf_list_scan"])
    for name, r in report.items():
        log(f"build {name}: {r['seconds']:.2f} s")
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    cuda_lib.load("ivf_list_scan")

    # -- phase 2: kernels vs plain versions, small size ---------------------
    phase_small_kernels(ivf_scan, torch)

    # -- phase 3: the main path through the RPC entry point -----------------
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-")
    sock = str(Path(data_dir) / "engine.sock")
    # a 20 ms admission window: 64 closed-loop clients then coalesce into
    # batches past the Q*nprobe*8 > nlist crossover (with 2 ms they
    # stagger into batches of one or two and never leave the small path).
    # build_threshold below --docs: the real documents build an int8
    # body, which the store saves and the restart reloads
    cfg = dict(dim=768, index_mode="ivf_flat_int8", nlist=4096, nprobe=32,
               ivf_p=3, batch_window_s=0.02, build_threshold=256,
               data_dir=data_dir, device="cuda")
    key = "stores/chip-smoke"
    rng = np.random.default_rng(args.seed)
    sampled = [int(i) for i in rng.choice(args.docs, size=64, replace=False)]
    ivf_scan.LAUNCHES.reset()                      # counts: main path only
    engine = Engine(EngineConfig(**cfg))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    try:
        remote.create_store(key)
        t0 = time.perf_counter()
        for i in range(args.docs):
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        seg = engine._store(key).segment
        saved = seg.body
        if saved is None or saved.lists.dtype != torch.int8:
            fail("the real documents built no int8 body")
        saved = (saved.lists.clone(), saved.row_ids.clone(), saved.scale)
        log(f"ingested {args.docs} documents in "
            f"{time.perf_counter() - t0:.2f} s "
            f"({remote.store_stats(key)['chunks']} chunks; int8 body of "
            f"{int((saved[1] >= 0).sum())} rows, nlist {saved[1].shape[0]},"
            f" tail {seg.tail.count})")
        before_pad = {i: remote.search([key], fact_query(i), k=5)
                      for i in sampled}
        for i, hits in before_pad.items():
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"before padding: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")

        n_pad = args.rows - args.docs
        t0 = time.perf_counter()
        remote.pad_store(key, n_pad, seed=args.seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        body = seg.body
        body_bytes = (body.lists.numel() * body.lists.element_size()
                      + body.row_ids.numel() * 4 + body.centroids.numel() * 4)
        mean_list = body.n / body.nlist
        log(f"store rows {args.rows} (pad {n_pad}) d=768: device build "
            f"{build_s:.2f} s = {args.rows / build_s:,.0f} vec/s; body "
            f"nlist={body.nlist} cap_len={body.cap_len} live={body.n} "
            f"(mean list {mean_list:.1f}, cap_len/mean "
            f"{body.cap_len / mean_list:.3f}) bytes={body_bytes} "
            f"({body_bytes / 2**30:.2f} GiB; live int8 rows "
            f"{body.n * 768 / 2**30:.2f} GiB) | {card}")

        # single searches (Q=1: the small-batch path at nlist=4096)
        lat = []
        for i in sampled * 3:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"padded store: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
        log(f"single search over RPC: p50 {p50:.3f} ms p99 {p99:.3f} ms "
            f"({len(lat)} searches; a lone request waits out the "
            f"{cfg['batch_window_s'] * 1e3:.0f} ms admission window) | {card}")
        qv1 = engine.encoder.encode([fact_query(i) for i in sampled])
        lat1, served = [], []
        for i in range(len(sampled)):
            t0 = time.perf_counter()
            served.append(seg.search(qv1[i:i + 1], 10)[1][0])
            lat1.append((time.perf_counter() - t0) * 1e3)
        log(f"StoreIndex.search Q=1 in process (no RPC, no window): p50 "
            f"{np.percentile(lat1, 50):.3f} ms p99 "
            f"{np.percentile(lat1, 99):.3f} ms | {card}")
        # recall@10 of the single-search path on the fact questions
        exact = seg.exact_reference_search(qv1, 10)
        fact_recall = float(np.mean([
            len(set(a[a >= 0]) & set(b[b >= 0])) / 10
            for a, b in zip(served, exact)]))
        log(f"recall@10 of fact questions (Q=1 path) vs "
            f"exact_reference_search: {fact_recall:.4f} "
            f"({len(sampled)} questions) | {card}")
        if fact_recall < RECALL_MIN:
            fail(f"fact-question recall@10 {fact_recall} < {RECALL_MIN}")

        # concurrent searches: the micro-batcher forms Q*nprobe*8 > nlist
        # batches, which take the list-scan kernel. Like the JAX engine,
        # a batch drops the probes past a list's default qcap, so similar
        # questions in one batch can lose their answer: counted, not
        # asserted
        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 24)]
        launches0 = ivf_scan.LAUNCHES.count
        search_profile.reset()
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        batches = search_profile.snapshot().get("body_dispatch",
                                                {"n": 0})["n"]
        right = sum(1 for i, h in zip(qids, hits)
                    if h and h[0].doc_id == f"doc-{i}")
        conc_launch = ivf_scan.LAUNCHES.count - launches0
        log(f"concurrent search over RPC: {threads} threads, {len(qids)} "
            f"queries in {wall:.3f} s = {len(qids) / wall:,.1f} QPS; "
            f"{batches} batches (mean {len(qids) / max(1, batches):.1f} "
            f"queries), kernel launches {conc_launch}; right top hit "
            f"{right}/{len(qids)} ({right / len(qids):.4f}) | {card}")
        if conc_launch == 0:
            fail("concurrent batches never reached the list-scan kernel")

        # one Q=1024 batch (int8 query transport, qcap from the batch)
        bq = [fact_query(int(i)) for i in rng.integers(0, args.docs, 1024)]
        remote.search_batch(key, bq[:64], k=10)          # warm shapes
        t0 = time.perf_counter()
        scores, ids = remote.search_batch(key, bq, k=10)
        bwall = time.perf_counter() - t0
        if scores.shape != (1024, 10):
            fail(f"search_batch returned {scores.shape}")
        log(f"search_batch Q=1024 over RPC (encode included): "
            f"{bwall * 1e3:.1f} ms = {1024 / bwall:,.0f} QPS; top score "
            f"finite for {int(np.isfinite(scores[:, 0]).sum())}/1024 | {card}")

        probe = remote.recall_probe(key, k=10, sample=64)
        if probe["recall"] is None:
            fail(f"recall_probe {probe}")
        main_launches = ivf_scan.LAUNCHES.count    # read just after
        log(f"recall_probe@10 (stored rows, nearly all pads) vs "
            f"exact_reference_search: {probe['recall']:.4f} "
            f"(sample {probe['sample']}) | {card}")
        log(f"main path kernel launches: ivf_list_scan {main_launches}; "
            f"device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            f" | {card}")
        if main_launches == 0:
            fail("the main path never launched ivf_list_scan")

        # the index alone on the same batch (no RPC, no encode)
        qv = engine.encoder.encode(bq)
        seg.search(qv, 10)
        t0 = time.perf_counter()
        for _ in range(5):
            seg.search(qv, 10)
        dwall = (time.perf_counter() - t0) / 5
        fact_drop = int(scan_inputs(body, torch.as_tensor(qv, device="cuda"),
                                    32)[3])
        log(f"StoreIndex.search Q=1024 in process: {dwall * 1e3:.2f} ms = "
            f"{1024 / dwall:,.0f} QPS; probes dropped by qcap "
            f"{fact_drop}/{1024 * 32} | {card}")

        # phase 5 input: a batch of 1024 stored rows (uniform traffic)
        probe_rows, _ = seg.sample_live_rows(1024, seed=args.seed + 1)
    finally:
        server.shutdown()

    # -- phase 4: restart on the same data_dir -------------------------------
    del engine, seg, remote       # body stays alive for phase 5
    gc.collect()
    engine2 = Engine(EngineConfig(**cfg))
    server2 = EngineRpcServer(engine2, sock, allow_pad=True).start()
    try:
        remote2 = RemoteEngine(sock)
        back = engine2._store(key).segment.body
        if back is None or not (torch.equal(back.lists, saved[0])
                                and torch.equal(back.row_ids, saved[1])
                                and back.scale == saved[2]):
            fail("restart: the reloaded int8 body differs from the saved one")
        for i in sampled:
            again = remote2.search([key], fact_query(i), k=5)
            if again != before_pad[i]:
                fail(f"restart: hits for project {i} differ")
        log(f"restart: body.npz reloaded verbatim on the card (lists, ids, "
            f"scale); {len(sampled)} queries give the same hits (the store "
            f"as saved; pads are not persisted)")
    finally:
        server2.shutdown()
    del engine2, remote2, back, saved
    gc.collect()

    # -- phase 5: kernel vs plain on the main path's dispatch, with times ---
    # a Q=1024 batch of stored rows, routed and inverted by the engine's
    # own code, dispatch included (empty slots are skipped)
    p = 3
    _, dispatch, _, dropped, qdisp, s = scan_inputs(
        body, torch.as_tensor(probe_rows, device="cuda"), 32)
    lists, row_ids = body.lists, body.row_ids
    nlist, qcap, d = qdisp.shape
    cap_len = lists.shape[1]
    live_n = ivf_scan.live_slots(dispatch)
    kv, ki = ivf_scan.ivf_list_scan(qdisp, lists, row_ids, dispatch, p=p,
                                    scale=s)
    torch.cuda.synchronize()
    rv, ri = ivf_scan.ivf_list_scan_reference(qdisp, lists, row_ids,
                                              dispatch, p=p, scale=s)
    max_err = check_scan(kv, ki, rv, ri, True, qdisp, lists,
                         "ivf_list_scan int8 main")
    del kv, ki, rv, ri
    ms = cuda_ms(lambda: ivf_scan.ivf_list_scan(
        qdisp, lists, row_ids, dispatch, p=p, scale=s), reps=10)
    plain_ms = cuda_ms(lambda: ivf_scan.ivf_list_scan_reference(
        qdisp, lists, row_ids, dispatch, p=p, scale=s), reps=2, warmup=1)
    library_ms, lib_chunks = library_ms_of(qdisp, lists, p)
    bound_ms, bound_by, c = scan_bound(row_ids, live_n, qcap, p, 1, d,
                                       "int8")
    log(f"ivf_list_scan int8 main path, Q=1024 stored rows: nlist={nlist} "
        f"qcap={qcap} (dropped {int(dropped)}) cap_len={cap_len} d={d} "
        f"p={p}, {c['lists_read']} lists with queries, {c['live_slots']} "
        f"live slots, {c['rows_needed']} live rows of "
        f"{c['rows_in_lists_read']}: bit-identical; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.bmm+topk (f32, every slot, "
        f"{lib_chunks} list chunks) {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}) | {card}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    shutil.rmtree(data_dir, ignore_errors=True)

    kernels = {"kernels": [{
        "name": "ivf_list_scan",
        "route": "cuda",
        "source": "rag_foundation_tpu_torch/csrc/ivf_list_scan.cu",
        "replaces": "rag_foundation_tpu/ops/pallas_ivf.py:101",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "dtype": "int8",
        "shape": {"nlist": nlist, "qcap": qcap, "cap_len": cap_len, "d": d,
                  "p": p, **c},
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
