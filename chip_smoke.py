#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rag_foundation_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py            # full size: two 10M x 768 stores,
                                     # then the exact scan of 1M x 768
    python3 chip_smoke.py --rows 200000 --pq-rows 200000 \
        --exact-rows 100000          # quick check

Phases (each one fails the run: non-zero exit, no result line):

1. Card and build: the card's name and power limit, torch/CUDA versions,
   the build of every kernel library from ``rag_foundation_tpu_torch/csrc``
   (nvcc, sm_90a, the compilers started together).
2. Each kernel against its plain PyTorch version on the card at a small
   size: the flat list scan (int8 exact, f32/bf16 within a stated
   tolerance), the ADC list scan (int8 LUT unpacked and packed exact,
   bf16 LUT within a stated tolerance, dead rows, a dead sub-block, a
   dispatch with empty tails) and the gather-and-rescore (exact, negative
   ids, a table whose row count is not a multiple of 8); then both list
   scans on edge cases: 0, 1, 8, 9, 16 and 17 live slots of qcap 32,
   sub-blocks of 0, 1 and 128 live rows, p from 1 to 8, packed codes and
   the bf16 LUT, f32 and bf16 flat lists; and the ADC scan on lists of 29
   sub-blocks at nlist 4, which it splits between blocks.
3. The main path through the entry points a user calls: the port's
   ``Engine`` (ivf_flat_int8, d=768, nlist=4096, nprobe=32, p=3) behind
   ``EngineRpcServer``, driven only through ``RemoteEngine``: ingest real
   documents (enough to build an int8 body), pad the store to ``--rows``
   on the device, single and concurrent searches, a Q=1024 batch,
   citations, recall against the exact scan and the recall audit, the
   engine's Prometheus text over RPC (``metrics_text``, parsed here: one
   batch-size observation a sequential search), and an in-process
   Q=1024 search of stored rows. Kernel launch counters are zeroed just
   before and read just after.
4. Restart: a fresh ``Engine`` on the same ``data_dir`` reloads the saved
   int8 body verbatim and gives the same hits.
5. The kernel against its plain version on the main path's Q=1024
   dispatch, with times: kernel, plain version, a library yardstick, and
   the bound; then that search split by stage on the card (coarse +
   dispatch, list scan, regather and top-k).
6. The ``ivf_pq`` main path, after the int8 store is released: a second
   ``Engine`` (ivf_pq, d=768, m=192 unpacked 4-bit codes, device refine,
   nlist=4096, nprobe=32) behind ``EngineRpcServer``: the same documents
   over RPC (enough to build a PQ body), then a bulk load
   (``StoreIndex.bulk_load_archive``) of those rows plus pads generated
   on the card up to ``--pq-rows``; single and concurrent searches, a
   Q=1024 batch, citations, recall against the exact scan, the recall
   audit, and a short run of the ``host`` and ``none`` refine tiers.
   The two kernels' launch counters are zeroed just before and read
   just after.
7. Restart of the ``ivf_pq`` store on its ``data_dir``: the saved body
   (codes, ids, codebooks, refine) and archive reload verbatim.
8. The two kernels against their plain versions on the PQ path's own
   Q=1024 dispatch, with times and bounds; then that search split by
   stage on the card (coarse + dispatch, LUT build and gather, list scan,
   regather and ADC top-C, re-rank).
9. After the PQ store is released: ``fused_topk`` and ``block_topk``
   against their plain versions at a small size (f32 and bf16, unaligned
   Q and N, a valid count below N as a device tensor, k above the live
   rows, integer-valued rows with duplicates bit-identical, two splits of
   the rows giving one output, ``block_topk(p=k)`` equal to
   ``fused_topk``).
10. The exact-scan path through ``tools.exact_scan.run_exact_1m`` at full
    width (``--exact-rows`` x 768 bf16, Q=1024, k=10): the two kernels'
    launch counters zeroed just before and read just after, recall@10 of
    ``block_topk(p=2)`` against ``fused_topk`` and ``exact_topk``, which
    must name the same rows; then each kernel against its plain version
    on those inputs with times (``block_topk``'s kernel and its stage 2
    also apart), a library yardstick and the bound.
11. ``exact_topk_hosted`` over a pinned host copy of ``--exact-rows`` x 768
    f32 rows against ``exact_topk`` on the device copy, with seconds and
    GB/s; then a 20,000-row ``build_ivf_flat_streaming`` body adopted by
    a ``StoreIndex`` with ``approx_routing=True`` and searched.
12. ``flash_attention`` against its plain version on the card, bf16 and
    f32, H=12, D=32, S in {16, 32, 100, 128, 512} (B*H = 288 at S=512),
    with pads, an all-pad row and a row of one token, within a stated
    tolerance.
13. The MiniLM encoder path at full width (hidden 384, 6 layers, 12
    heads): an ``EngineRpcServer`` with ``encoder="minilm"`` and the
    repository's trained ``checkpoints/minilm_ict.npz`` (max_len 128)
    ingests the fact documents and serves single and 64 concurrent
    searches over RPC (the kernel's launch counter must rise on ingest
    and on a single search; recall@10 >= 0.95 against the exact scan; the
    stored embeddings against the plain attention on the card, cosine
    >= 0.999); the same documents under ``encoder="hybrid"`` (768 = 384
    hash + 384 MiniLM, w=0.35); then a random MiniLM-L6 with
    ``max_len=512`` made by ``init_params`` from ``--seed``, saved with
    ``save_params`` and loaded by an ``Engine`` through
    ``encoder_ckpt``, which ingests long documents at the default 200
    words a chunk: batches of 256 chunks at S=512, the kernel's main
    shape, with chunks/s, and the kernel's time there beside its bound
    (bytes, tensor operations and one exponential a same-segment pair; the
    exponentials the kernel issues printed beside them), its plain version
    and ``scaled_dot_product_attention`` (timed only); the kernel's
    launches on these serve phases are printed by (B, S).

14. The attention backward kernels (``flash_attention_bwd_dkv``,
    ``flash_attention_bwd_dq``) against their plain versions on the card,
    bf16 and f32, H=12, S in {1, 8, 16, 32, 33, 64, 65, 100, 128, 256,
    512, 200}, D 16, 32 and 64, with pads, an all-pad row and a row of one
    token; the forward kernel's ``lse`` against a masked logsumexp;
    ``FlashAttention``'s gradients against autograd of the plain forward;
    then the backward kernels again on other segment layouts: three packed
    segments a row, ids 0-4 in no order, a row whose keys' ids differ from
    its queries', and a row whose queries see no key.
15. Encoder training at full width: a corpus from the recipe's own
    ``scripts/build_text_corpus.py`` (``--corpus-passages``), then the
    port's trainer (``tools.train_encoder.train_ict``, ICT mode: batch 256,
    q_len 32, d_len 128, symmetric InfoNCE at temperature 0.05, adamw lr
    3e-4 with warmup and cosine decay, clip 1.0) for ``--train-steps``
    steps, the three attention launch counters zeroed just before and read
    just after (the forward's also by (B, S)), a finite and falling loss, ms/step, pairs/s and held-out
    recall beside the hash encoder; the saved checkpoint served by an
    ``Engine`` through ``encoder_ckpt``; one step's gradients with the
    kernels against the plain attention (worst cosine a leaf); a few steps
    at d_len 512 with peak device memory; the two backward kernels timed on
    the steps' own layer-0 inputs (q side S=32, d side S=128, and S=512)
    beside their plain versions, ``scaled_dot_product_attention``'s
    backward, their bounds, the exponential floor and the share of 16x16
    blocks with no same-segment pair. ``--lengths-out`` writes those rows'
    lengths for ``time_kernels --lengths``.

``--long-docs`` sets the number of long documents of phase 13. The line
before last is the kernels' JSON (eight entries); the last line is
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

# f32/bf16 scores of unit vectors: summation-order error is at most
# d * 2**-24 * sum|q_i r_i| <= 768 * 6e-8 = 4.6e-5 (bf16 products are exact
# in f32), so kernel and plain version agree within this
F32_TOL = 5e-5
RECALL_MIN = 0.95     # recall@10 of the served store vs the exact scan
# ADC sums with a bf16 LUT: m = 192 entries of magnitude <= 1 summed in
# f32 in another order than the plain version: error <= m * 2**-24 * m
BF16_LUT_TOL = 3e-3
# flash attention: both outputs are convex combinations of v. The plain
# version computes in f32 and rounds its output to the input dtype once;
# the bf16 kernel also rounds each softmax weight to bf16 before P.V
# (2^-9 relative): at most three bf16 roundings of max|v| apart. f32: sums
# in another order, 1e-5 of max|v|
ATTN_TOL = {"bf16": 3 * 2 ** -9, "f32": 1e-5}
EMBED_COS_MIN = 0.999  # stored embeddings vs the plain attention path
LONG_BATCH = 256       # chunks an encode: the ingest pipeline's batch
# the attention backward kernels against their plain versions on the same
# lse and di: each output is a sum of products a.b (p.dO for dV, ds.q for
# dK, ds.k for dQ). The bf16 kernels round each p and ds to bf16 before
# the product and their output to bf16; the plain version rounds only its
# output. A rounding to bf16 (8 significant bits) is off by up to 2^-8 of
# its value. ds = p (dO.v - di) * scale cancels, so its error is relative
# to |a| = p (sum|dO||v| + |di|) * scale, not to |ds|: an element differs
# by at most 2^-8 * sum|a||b| plus the two outputs' roundings, 2^-8 *
# 2 |plain| (an ideal kernel with these roundings alone reaches past one:
# tests/test_torch_flash_attention_bwd.py). f32: exp2 against exp, sums in
# another order, 1e-5 of sum|a||b| + |plain|. (relative, |plain| count)
ATTN_BWD_TOL = {"bf16": (2 ** -8, 2), "f32": (1e-5, 1)}
# FlashAttention's gradients against autograd of the plain forward, which
# keeps o and the weights in f32: in bf16 three roundings of 2^-9 a term
# (P for P.V in the forward, which moves o and so di; P and dS in the
# backward); relative norm error of each gradient. f32: 1e-5
APPLY_TOL = {"bf16": 2 ** -6, "f32": 1e-5}
# the forward kernel's lse against a masked logsumexp: scores from the same
# exact bf16 products summed in another order, exp2/log2 in f32
LSE_TOL = 1e-4
TRAIN_BATCH = 256      # the production recipe's batch
# one training step's gradients, kernel path vs plain attention, each leaf:
# the two paths round bf16 activations at other places (the kernels round
# the attention weights, P and dS, to bf16; the plain path keeps them in
# f32), a relative 2^-9 a rounding through 6 layers and the loss's
# 1/temperature = 20; a kernel fault (a tile, a mask) turns whole gradients
GRAD_COS_MIN = 0.99

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
    # the calls queue behind a spin of the card (100 us a call), so that a
    # short kernel is timed on the card and not its host launch overhead
    torch.cuda._sleep(reps * 200_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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


def phase_small_pq_kernels(pq_scan, gather, torch):
    """ADC list scan and gather-and-rescore vs their plain versions on the
    card, small size."""
    g = torch.Generator(device="cuda").manual_seed(2)
    nlist, qcap, cap_len, m, p = 48, 16, 1024, 192, 4
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    ids = torch.where(torch.rand(ids.shape, generator=g, device="cuda")
                      < 0.25, torch.full_like(ids, -1), ids)
    ids[3, 128:256] = -1      # a sub-block of dead rows
    lut8 = torch.randint(-127, 128, (nlist, qcap, 16 * m), generator=g,
                         device="cuda", dtype=torch.int8)
    lutbf = (torch.randn((nlist, qcap, 16 * m), generator=g, device="cuda")
             .clamp(-1, 1).bfloat16())
    disp = torch.full((nlist, qcap), -1, dtype=torch.int32, device="cuda")
    disp[::3, :] = 0          # full lists
    disp[1::3, :5] = 1        # five live slots, then an empty tail
    disp[2, [0, 9]] = 2       # a hole: slots up to 9 are computed
    # the other lists of 2::3 have no query at all
    for lut_name, lut in (("int8", lut8), ("bf16", lutbf)):
        for packed in (False, True):
            c = pq_scan.pack_codes(codes).contiguous() if packed else codes
            err = 0.0
            for dispatch in (None, disp):
                kv, ki = pq_scan.pq_list_scan(lut, c, ids, dispatch, p=p)
                torch.cuda.synchronize()
                rv, ri = pq_scan.pq_list_scan_reference(lut, c, ids,
                                                        dispatch, p=p)
                what = (f"pq_list_scan {lut_name} LUT "
                        f"{'packed' if packed else 'unpacked'} "
                        f"{'with' if dispatch is not None else 'no'} "
                        f"dispatch")
                err = max(err, check_pq_scan(kv, ki, rv, ri,
                                             lut_name == "int8", what))
            log(f"kernel check pq_list_scan {lut_name} LUT "
                f"{'packed' if packed else 'unpacked'} nlist={nlist} "
                f"qcap={qcap} cap_len={cap_len} m={m} p={p}, dead rows, a "
                f"dead sub-block, with and without a dispatch: "
                + ("bit-identical" if lut_name == "int8" else
                   f"max_abs_err={err:.3g} (tol {BF16_LUT_TOL})"))
    for n, d, q_n, c in ((100_003, 768, 64, 64), (1001, 64, 7, 5)):
        table = torch.randint(-127, 128, (n, d), generator=g, device="cuda",
                              dtype=torch.int8)
        rows = torch.randint(0, n, (q_n, c), generator=g, device="cuda",
                             dtype=torch.int32)
        rows[0, :3] = torch.tensor([-1, -5, n - 1], dtype=torch.int32)
        qq = torch.randint(-127, 128, (q_n, d), generator=g, device="cuda",
                           dtype=torch.int8)
        out = gather.gather_rescore_int8(table, rows, qq)
        torch.cuda.synchronize()
        if not torch.equal(out, gather.gather_rescore_int8_reference(
                table, rows, qq)):
            fail(f"gather_rescore_int8 N={n} d={d}: kernel != plain version")
        log(f"kernel check gather_rescore_int8 N={n} (N % 8 = {n % 8}) "
            f"d={d} Q={q_n} C={c}, negative ids: bit-identical")


# live slots of the edge-case lists (qcap 32): none, one, a full n-tile of
# 8, one past it, a full pass of 16, one past it
EDGE_LIVE = (0, 1, 8, 9, 16, 17)
# lists of 29 sub-blocks at nlist 4: the ADC scan gives each list several
# blocks (the walk of a list split between blocks)
SPLIT_LIVE = (0, 8, 9, 17)


def edge_rows(torch, g, cap_len=512, live=EDGE_LIVE):
    """Row ids and a dispatch of one list per ``live`` entry: a sub-block
    of no live row, one of a single live row, one of 128 and the rest
    about 30% dead; list l has its first live[l] slots live."""
    nlist = len(live)
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    lone = torch.arange(nlist, device="cuda")
    one = ids[lone, 128 + 37 + lone].clone()
    ids[:, :256] = -1
    ids[lone, 128 + 37 + lone] = one
    tail = ids[:, 384:]
    tail[torch.rand(tail.shape, generator=g, device="cuda") < 0.3] = -1
    disp = torch.full((nlist, 32), -1, dtype=torch.int32, device="cuda")
    for l, n in enumerate(live):
        disp[l, :n] = l
    return ids, disp


def phase_edge_kernels(ivf_scan, pq_scan, torch):
    """Both list scans against their plain versions on the edge cases
    (``edge_rows``), p from 1 to 8, with and without the dispatch."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ids, disp = edge_rows(torch, g)
    nlist, cap_len = ids.shape
    for kind, d in (("int8", 768), ("int8", 48), ("f32", 768),
                    ("bf16", 768)):
        q = torch.randn((nlist, 32, d), generator=g, device="cuda")
        rows = torch.randn((nlist, cap_len, d), generator=g, device="cuda")
        q /= q.norm(dim=-1, keepdim=True)
        rows /= rows.norm(dim=-1, keepdim=True)
        s = 1.0 / 127.0
        if kind == "int8":
            q = torch.clamp(torch.round(q / s), -127, 127).to(torch.int8)
            rows = torch.clamp(torch.round(rows / s), -127, 127).to(
                torch.int8)
        elif kind == "bf16":
            q, rows = q.bfloat16(), rows.bfloat16()
        scale = s * s if kind == "int8" else 1.0
        err = 0.0
        for p in range(1, 9):
            for dispatch in (disp, None):
                kv, ki = ivf_scan.ivf_list_scan(q, rows, ids, dispatch, p=p,
                                                scale=scale)
                torch.cuda.synchronize()
                rv, ri = ivf_scan.ivf_list_scan_reference(
                    q, rows, ids, dispatch, p=p, scale=scale)
                err = max(err, check_scan(
                    kv, ki, rv, ri, kind == "int8", q, rows,
                    f"ivf_list_scan {kind} d={d} edge p={p}"))
        log(f"kernel check ivf_list_scan {kind} d={d} edge cases (live "
            f"slots {EDGE_LIVE} of qcap 32; sub-blocks of 0, 1, 128 live "
            f"rows; p 1-8): "
            + ("bit-identical" if kind == "int8" else
               f"max_abs_err={err:.3g} (tol {F32_TOL})"))
    m = 192
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    lut8 = torch.randint(-127, 128, (nlist, 32, 16 * m), generator=g,
                         device="cuda", dtype=torch.int8)
    lutbf = (torch.randn((nlist, 32, 16 * m), generator=g, device="cuda")
             .clamp(-1, 1).bfloat16())
    for name, lut, packed in (("int8", lut8, False), ("int8", lut8, True),
                              ("bf16", lutbf, False)):
        c = pq_scan.pack_codes(codes).contiguous() if packed else codes
        err = 0.0
        for p in range(1, 9):
            for dispatch in (disp, None):
                kv, ki = pq_scan.pq_list_scan(lut, c, ids, dispatch, p=p)
                torch.cuda.synchronize()
                rv, ri = pq_scan.pq_list_scan_reference(lut, c, ids,
                                                        dispatch, p=p)
                err = max(err, check_pq_scan(
                    kv, ki, rv, ri, name == "int8",
                    f"pq_list_scan {name} LUT "
                    f"{'packed' if packed else 'unpacked'} edge p={p}"))
        log(f"kernel check pq_list_scan {name} LUT "
            f"{'packed' if packed else 'unpacked'} m={m} edge cases (live "
            f"slots {EDGE_LIVE} of qcap 32; sub-blocks of 0, 1, 128 live "
            f"rows; p 1-8): "
            + ("bit-identical" if name == "int8" else
               f"max_abs_err={err:.3g} (tol {BF16_LUT_TOL})"))
    cap_len = 3712
    ids, disp = edge_rows(torch, g, cap_len, SPLIT_LIVE)
    codes = torch.randint(0, 16, (len(SPLIT_LIVE), cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    lut8 = torch.randint(-127, 128, (len(SPLIT_LIVE), 32, 16 * m),
                         generator=g, device="cuda", dtype=torch.int8)
    for packed in (False, True):
        c = pq_scan.pack_codes(codes).contiguous() if packed else codes
        for p in range(1, 9):
            for dispatch in (disp, None):
                kv, ki = pq_scan.pq_list_scan(lut8, c, ids, dispatch, p=p)
                torch.cuda.synchronize()
                rv, ri = pq_scan.pq_list_scan_reference(lut8, c, ids,
                                                        dispatch, p=p)
                check_pq_scan(kv, ki, rv, ri, True,
                              f"pq_list_scan int8 LUT split lists p={p}")
        log(f"kernel check pq_list_scan int8 LUT "
            f"{'packed' if packed else 'unpacked'} m={m}, lists split "
            f"between blocks (nlist {len(SPLIT_LIVE)}, cap_len {cap_len}, "
            f"live slots {SPLIT_LIVE} of qcap 32; p 1-8): bit-identical")


def prom_samples(text: str) -> dict:
    """``{"name{labels}": value}`` of Prometheus text, parsed by hand (the
    card machine has no prometheus_client)."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def stage_split(torch, fn, marks, names, card, what, reps=5) -> None:
    """One line of a search's device time by stage, from CUDA events
    recorded in one call of ``fn``: ``marks`` are (module, function name,
    "before" | "after") triples of the functions ``fn`` calls, in this
    order, each once; for the call each is wrapped to record an event as
    it is entered or as it returns. The stages are the spans between the
    call's start, the marks and its end (``names``, one more than the
    marks). Of ``reps`` calls after a warm one, the call of the median
    total is shown."""
    events = []

    def record():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    def wrap(f, when):
        def marked(*a, **kw):
            if when == "before":
                record()
            out = f(*a, **kw)
            if when == "after":
                record()
            return out
        return marked

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in marks]
    runs = []
    try:
        for mod, name, when in marks:
            setattr(mod, name, wrap(getattr(mod, name), when))
        for _ in range(reps + 1):
            events.clear()
            record()
            fn()
            record()
            torch.cuda.synchronize()
            if len(events) != len(marks) + 2:
                fail(f"{what}: {len(events) - 2} stage marks, expected "
                     f"{len(marks)}")
            runs.append([a.elapsed_time(b)
                         for a, b in zip(events, events[1:])])
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    parts = sorted(runs[1:], key=sum)[reps // 2]
    total = sum(parts)
    text = "; ".join(f"{name} {t:.3f} ms ({t / total:.1%})"
                     for name, t in zip(names, parts))
    log(f"{what}: {total:.3f} ms on the card = {text} | {card}")


def check_pq_scan(kv, ki, rv, ri, exact, what) -> float:
    """ADC kernel (kv, ki) against plain version (rv, ri)."""
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
    if err > BF16_LUT_TOL:
        fail(f"{what}: max |kernel - plain| {err} > {BF16_LUT_TOL}")
    off = ki != ri      # allowed only between rows scoring within the tol
    if off.any() and float((kv[off] - rv[off]).abs().max()) > BF16_LUT_TOL:
        fail(f"{what}: idx differs beyond a near-tie")
    return err


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


def recall_at(served, exact, k=10) -> float:
    import numpy as np
    return float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / k
                          for a, b in zip(served, exact)]))


def pq_recall_with_ties(seg, gather, qv, served, exact, k=10) -> float:
    """recall@k where a served chunk counts if it scores at least the
    k-th best exact score. The re-ranked scores are INTEGER int8 dots, so
    near-duplicate documents tie, and which of two tied chunks comes back
    is a matter of position, not of quality. Both id sets are scored here
    the way the refine stage scores them (the query quantized at its own
    absmax, exact int32 dots against the refine table's rows)."""
    import numpy as np
    import torch
    body, table = seg.body, seg.body_chunk_ids
    order = np.argsort(table, kind="stable")

    def rows_of(ids):
        pos = np.clip(np.searchsorted(table[order], ids), 0, len(table) - 1)
        rows = order[pos]
        return np.where((table[rows] == ids) & (ids >= 0), rows, -1)

    scale = np.abs(qv).max(axis=1, keepdims=True) / 127.0
    qq = torch.as_tensor(np.clip(np.round(qv / scale), -127, 127)
                         .astype(np.int8), device=body.refine.device)

    def scores(ids):
        rows = rows_of(ids)
        sc = gather.gather_rescore_int8_reference(
            body.refine, torch.as_tensor(rows.astype(np.int32),
                                         device=body.refine.device), qq)
        return np.where(rows >= 0, sc.cpu().numpy(), -np.inf)

    s_served, s_exact = scores(np.asarray(served)), scores(np.asarray(exact))
    if not np.isfinite(s_exact).all():
        # an exact neighbour outside the body (the tail): ids decide
        return recall_at(served, exact, k)
    return float(np.mean((s_served >= s_exact.min(axis=1, keepdims=True))
                         .sum(axis=1) / k))


def check_topk(kv, ki, rv, ri, q, c, tol, what) -> tuple[float, int]:
    """Kernel top-k (kv, ki) against the plain version's (rv, ri):
    (max |value difference|, ids that differ). ``tol == 0`` asks for
    bit-identical outputs; otherwise an id may differ only between two
    rows whose scores (recomputed in f64) lie within ``tol``."""
    import torch
    both = torch.isfinite(rv)
    if not torch.equal(torch.isfinite(kv), both) \
            or not torch.equal(ki < 0, ri < 0):
        fail(f"{what}: pad pattern differs")
    err = float((kv[both] - rv[both]).abs().max()) if both.any() else 0.0
    if tol == 0:
        if not (torch.equal(kv, rv) and torch.equal(ki, ri)):
            bad = int((kv != rv).sum() + (ki != ri).sum())
            fail(f"{what}: kernel != plain version ({bad} elements)")
        return err, 0
    if err > tol:
        fail(f"{what}: max |kernel - plain| {err} > {tol}")
    diff = (ki != ri).nonzero().tolist()
    for qi, j in diff:
        a, b = int(ki[qi, j]), int(ri[qi, j])
        qv = q[qi].double()
        sa, sb = float(qv @ c[a].double()), float(qv @ c[b].double())
        if abs(sa - sb) > tol:
            fail(f"{what}: idx differs beyond a near-tie at {(qi, j)}: "
                 f"{a} ({sa}) vs {b} ({sb})")
    return err, len(diff)


def phase_small_exact_kernels(bt, ft, torch):
    """Phase 9: fused_topk and block_topk vs their plain versions on the
    card, small size."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q_n, n, d, k = 77, 10_007, 768, 10        # neither a tile multiple
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        c = torch.randn((n, d), generator=g, device="cuda")
        c = (c / c.norm(dim=1, keepdim=True)).to(dtype)
        q = torch.randn((q_n, d), generator=g, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).to(dtype)
        worst, near = 0.0, 0
        for vc in (None, torch.tensor(n - 500, device="cuda"), 3):
            what = f"{name} valid_count={'N' if vc is None else int(vc)}"
            fv, fi = ft.fused_topk(q, c, k, valid_count=vc)
            torch.cuda.synchronize()
            err, nd = check_topk(fv, fi, *ft.fused_topk_reference(
                q, c, k, valid_count=vc), q, c, F32_TOL, f"fused_topk {what}")
            worst, near = max(worst, err), near + nd
            for splits in (1, 7):       # the split is no part of the result
                sv, si = ft.fused_topk(q, c, k, valid_count=vc,
                                       n_splits=splits)
                if not (torch.equal(sv, fv) and torch.equal(si, fi)):
                    fail(f"fused_topk {what}: n_splits={splits} changes the "
                         f"result")
            ev, ei = bt.block_topk(q, c, k, p=k, valid_count=vc, block_n=512)
            if not (torch.equal(ev, fv) and torch.equal(ei, fi)):
                fail(f"block_topk(p=k) {what} != fused_topk")
            kw = dict(p=2, valid_count=vc, block_n=256)
            bv, bi = bt.block_topk(q, c, k, **kw)
            torch.cuda.synchronize()
            err, nd = check_topk(bv, bi, *bt.block_topk_reference(
                q, c, k, **kw), q, c, F32_TOL, f"block_topk p=2 {what}")
            worst, near = max(worst, err), near + nd
            if vc is not None and int(vc) < k and not (
                    bool((fi[:, int(vc):] == -1).all())
                    and bool(torch.isneginf(fv[:, int(vc):]).all())):
                fail(f"fused_topk {what}: slots past the live rows are not "
                     f"(-inf, -1)")
        # the tie rule: small-integer rows (every partial sum exact in
        # f32), each row two or three times, across blocks and splits
        base = torch.randint(-3, 4, (1500, 64), generator=g,
                             device="cuda").to(dtype)
        ci = torch.cat([base, base, base[:700]])
        qi = base[:50] * 2
        rv, ri = ft.fused_topk_reference(qi, ci, 12)
        check_topk(*ft.fused_topk(qi, ci, 12, n_splits=5), rv, ri, qi, ci, 0,
                   f"fused_topk {name} integer rows")
        check_topk(*bt.block_topk(qi, ci, 12, p=12, block_n=128), rv, ri, qi,
                   ci, 0, f"block_topk(p=k) {name} integer rows")
        check_topk(*bt.block_topk(qi, ci, 12, p=3, block_n=128),
                   *bt.block_topk_reference(qi, ci, 12, p=3, block_n=128),
                   qi, ci, 0, f"block_topk(p=3) {name} integer rows")
        log(f"kernel check fused_topk + block_topk {name} Q={q_n} N={n} "
            f"d={d} k={k}, valid_count N / N-500 (device tensor) / 3, "
            f"n_splits 1 / 7 / default equal, block_topk(p=k) == fused_topk: "
            f"max_abs_err={worst:.3g} (tol {F32_TOL}), {near} ids differ "
            f"within it; integer rows with duplicates: bit-identical")


def library_topk(torch, q, c, k, block=65_536):
    """The yardstick the port never calls: ``torch.matmul`` in the corpus
    dtype over row blocks, ``torch.topk`` of each, ``torch.topk`` of the
    blocks' winners."""
    vals, idx = [], []
    for lo in range(0, c.shape[0], block):
        v, i = torch.topk(torch.matmul(q, c[lo:lo + block].T),
                          min(k, c.shape[0] - lo), dim=1)
        vals.append(v)
        idx.append(i + lo)
    v, pos = torch.topk(torch.cat(vals, dim=1), k, dim=1)
    return v, torch.gather(torch.cat(idx, dim=1), 1, pos)


def exact_phases(args, card) -> list[dict]:
    """Phases 9-11: the exact flat scan. Returns the two kernels' entries
    of the ``kernels`` line."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.utils import roofline
    from rag_foundation_tpu_torch.engine import ivf as tivf
    from rag_foundation_tpu_torch.engine.index import StoreIndex
    from rag_foundation_tpu_torch.ops import block_topk as bt
    from rag_foundation_tpu_torch.ops import fused_topk as ft
    from rag_foundation_tpu_torch.ops import ivf_scan
    from rag_foundation_tpu_torch.ops.hosted_topk import exact_topk_hosted
    from rag_foundation_tpu_torch.ops.topk import exact_topk
    from rag_foundation_tpu_torch.tools import exact_scan

    phase_small_exact_kernels(bt, ft, torch)

    # -- phase 10: the exact-scan path at full width -------------------------
    n, d, q_n, k = args.exact_rows, 768, 1024, 10
    bt.LAUNCHES.reset()                          # counts: this path only
    ft.LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    res = exact_scan.run_exact_1m("cuda", n=n, d=d, q_n=q_n, k=k,
                                  seed=args.seed)
    launches = (bt.LAUNCHES.count, ft.LAUNCHES.count)   # read just after
    log(f"exact scan {n}x{d} bf16 Q={q_n} k={k} block_topk(p=2, "
        f"block_n=1024): {res['ms_per_batch']:.3f} ms a batch = "
        f"{res['qps']:,.0f} QPS; recall@{k} of {res['recall_queries']} "
        f"queries {res['recall_vs_exact']:.4f} vs exact_topk, "
        f"{res['recall_vs_fused']:.4f} vs fused_topk; fused_topk vs "
        f"exact_topk: {res['fused_vs_exact_near_ties']} ids differ, all "
        f"between scores within {res['score_tolerance']:.3g}; launches "
        f"block_topk {launches[0]} fused_topk {launches[1]}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    if res["card"] != card:
        fail(f"run_exact_1m names the card {res['card']!r}, not {card!r}")
    if min(launches) == 0:
        fail(f"the exact-scan path launched {launches}")
    if min(res["recall_vs_exact"], res["recall_vs_fused"]) < RECALL_MIN:
        fail(f"block_topk(p=2) recall@{k} {res['recall_vs_exact']} < "
             f"{RECALL_MIN}")

    # each kernel against its plain version on the path's own inputs
    corpus, queries = exact_scan.make_corpus(n, d, q_n, args.seed,
                                             torch.device("cuda"))
    tol = exact_scan.score_tolerance(queries, corpus)
    bound_ms, bound_by = roofline.topk_bound(q_n, n, d, k, 2, "bf16")
    library_ms = cuda_ms(lambda: library_topk(torch, queries, corpus, k),
                         reps=5)
    entries = []
    for name, mod, fn, ref, line, count in (
            ("block_topk", bt, lambda: bt.block_topk(queries, corpus, k, p=2),
             lambda: bt.block_topk_reference(queries, corpus, k, p=2),
             "pallas_block_topk.py:68", launches[0]),
            ("fused_topk", ft, lambda: ft.fused_topk(queries, corpus, k),
             lambda: ft.fused_topk_reference(queries, corpus, k),
             "pallas_topk.py:91", launches[1])):
        kv, ki = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rv, ri = ref()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, near = check_topk(kv, ki, rv, ri, queries, corpus, tol,
                               f"{name} main")
        del kv, ki, rv, ri
        ms = cuda_ms(fn, reps=10)
        split = {}
        if mod is bt:       # the kernel (stage 1) and stage 2 apart
            split["kernel_ms"] = cuda_ms(lambda: bt.block_candidates(
                queries, corpus, 2, n, 1024), reps=10)
            cands = bt.block_candidates(queries, corpus, 2, n, 1024)
            split["stage2_ms"] = cuda_ms(lambda: bt._finish(*cands, k),
                                         reps=10)
            del cands
        log(f"{name} bf16 main path, Q={q_n} N={n} d={d} k={k}"
            f"{' p=2 block_n=1024 (stage-2 merge included)' if mod is bt else ''}"
            f": max_abs_err={err:.3g} (tol {tol:.3g}), {near} ids differ "
            f"within it; kernel {ms:.3f} ms"
            + (f" (stage 1 alone {split['kernel_ms']:.3f} ms, stage 2 alone "
               f"{split['stage2_ms']:.3f} ms)" if split else "")
            + f", plain {plain_ms:.3f} ms (one "
            f"run), torch.matmul+topk (bf16, 65,536-row blocks) "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) | "
            f"{card}")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"rag_foundation_tpu_torch/csrc/{name}.cu",
            "replaces": f"rag_foundation_tpu/ops/{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "dtype": "bf16", **split,
            "shape": {"Q": q_n, "N": n, "d": d, "k": k,
                      **({"p": 2, "block_n": 1024} if mod is bt else {})},
        })
    del corpus, queries
    torch.cuda.empty_cache()

    # -- phase 11: the host-streamed scan, then a streamed IVF body ---------
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    host = torch.empty((n, d), dtype=torch.float32, pin_memory=True)
    dev_rows = torch.empty((n, d), dtype=torch.float32, device="cuda")
    for lo in range(0, n, 131_072):
        hi = min(n, lo + 131_072)
        dev_rows[lo:hi] = torch.randn((hi - lo, d), generator=g,
                                      device="cuda")
        host[lo:hi].copy_(dev_rows[lo:hi])
    hq = dev_rows[:64] + 0.1 * torch.randn((64, d), generator=g,
                                           device="cuda")
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):      # the first run also allocates the pinned buffers
        t0 = time.perf_counter()
        hv, hi_ = exact_topk_hosted(hq, host.numpy(), k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dv, di = exact_topk(hq, dev_rows, k)
    if not torch.equal(hi_, di):
        fail(f"exact_topk_hosted: {int((hi_ != di).sum())} ids differ from "
             f"exact_topk on the device copy")
    gb = n * d * 4 / 1e9
    log(f"exact_topk_hosted {n}x{d} f32 ({gb:.2f} GB in host memory) Q=64 "
        f"k={k} block_rows=262144: ids bit-identical to exact_topk on the "
        f"device copy, max |value difference| "
        f"{float((hv - dv).abs().max()):.3g}; {walls[1]:.3f} s = "
        f"{gb / walls[1]:.2f} GB/s (first run {walls[0]:.3f} s) | {card}")
    del host, dev_rows, hq, hv, hi_, dv, di
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed + 3)
    sn, nlist = 20_000, 64
    centres = rng.standard_normal((256, d)).astype(np.float32)
    rows = centres[rng.integers(0, 256, sn)] \
        + 0.5 * rng.standard_normal((sn, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    t0 = time.perf_counter()
    body, overflow = tivf.build_ivf_flat_streaming(
        lambda lo, hi: rows[lo:hi], sn, d, nlist,
        generator=torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda", chunk=4096)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if overflow.any() or body.n != sn or body.lists.dtype != torch.int8:
        fail(f"build_ivf_flat_streaming: n={body.n} overflow="
             f"{int(overflow.sum())} dtype={body.lists.dtype}")
    seg = StoreIndex(d, mode="ivf_flat_int8", nlist=nlist, nprobe=8, ivf_p=3,
                     approx_routing=True, device="cuda")
    seg.adopt_body(body, np.arange(sn, dtype=np.int64) + 1000)
    picks = rng.choice(sn, 256, replace=False)
    qs = rows[picks] + 0.01 * rng.standard_normal((256, d)).astype(np.float32)
    scan0 = ivf_scan.LAUNCHES.count
    _, ids_batch = seg.search(qs, 5)             # Q*nprobe*8 > nlist
    batch_launches = ivf_scan.LAUNCHES.count - scan0
    ids_single = np.stack([seg.search(qs[i:i + 1], 5)[1][0]
                           for i in range(16)])   # the small-batch path
    if batch_launches == 0:
        fail("the batched search of the streamed body launched no list scan")
    # a batch drops the probes past a list's default qcap, as the JAX
    # engine does, so the batch is held to the recall floor and the single
    # searches (no qcap on the small-batch path) to every hit
    right = int((ids_batch[:, 0] == picks + 1000).sum())
    right1 = int((ids_single[:, 0] == picks[:16] + 1000).sum())
    if right < RECALL_MIN * 256 or right1 != 16:
        fail(f"streamed body: right top hit for {right}/256 batched and "
             f"{right1}/16 single searches")
    log(f"build_ivf_flat_streaming {sn}x{d} f32 source, nlist={nlist}, "
        f"chunk 4096: {build_s:.2f} s, cap_len={body.cap_len}, no overflow; "
        f"adopted with adopt_body, approx_routing=True: right top hit "
        f"{right}/256 in one batch ({batch_launches} list-scan launch) and "
        f"16/16 single searches | {card}")
    return entries


def pq_phases(args, card, rng, sampled, mods) -> list[dict]:
    """Phases 6-8: the ``ivf_pq`` store. Returns the two kernels' entries
    of the ``kernels`` line."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.utils import roofline
    (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
     HostArchive, tpq, pq_scan, gather, quantize) = mods
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-pq-")
    sock = str(Path(data_dir) / "engine.sock")
    # ivf_p=8: the 400 documents are near-duplicates of one template and
    # land in one posting list, a dozen to a sub-block; a capture of 4 rows
    # a sub-block (the JAX engine's fixed width) loses some of a
    # question's ten nearest there
    cfg = dict(dim=768, index_mode="ivf_pq", pq_m=192, pq_packed=False,
               pq_refine="device", nlist=4096, nprobe=32, ivf_p=8,
               batch_window_s=0.02, build_threshold=256, data_dir=data_dir,
               device="cuda")
    key = "stores/chip-smoke-pq"
    pq_scan.LAUNCHES.reset()                     # counts: this path only
    gather.LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
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
        if saved is None or type(saved).__name__ != "IVFPQIndex":
            fail("the real documents built no IVF-PQ body")
        saved = {"codes": saved.codes.clone(),
                 "row_ids": saved.row_ids.clone(),
                 "centroids": saved.centroids.clone(),
                 "codebook_centroids": saved.codebook_centroids.clone(),
                 "refine": saved.refine.clone(),
                 "archive": seg._pq_archive.chunk_i8(
                     0, seg._pq_archive.n).copy()}
        log(f"ivf_pq: ingested {args.docs} documents in "
            f"{time.perf_counter() - t0:.2f} s; PQ body of "
            f"{int((saved['row_ids'] >= 0).sum())} rows, nlist "
            f"{saved['row_ids'].shape[0]}, m {saved['codes'].shape[2]}, "
            f"refine {tuple(saved['refine'].shape)}, archive "
            f"{saved['archive'].shape[0]} rows, tail {seg.tail.count}")
        before_pad = {i: remote.search([key], fact_query(i), k=5)
                      for i in sampled}
        for i, hits in before_pad.items():
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"ivf_pq before padding: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")

        # mass import: the store's live rows, then pads generated on the
        # card with the pad_store distribution, into a host archive; the
        # body is built from it by the streaming build
        t0 = time.perf_counter()
        base_v, base_i = seg.live_rows()
        n_pad = max(0, args.pq_rows - len(base_i))
        total = len(base_i) + n_pad
        arch = HostArchive(768)
        arch.reserve(total)
        arch.append(base_v)
        chunk = 1 << 18
        gen = engine.pad_generator(engine.pad_centers(args.seed),
                                   Engine.PAD_NOISE, args.seed, chunk,
                                   seg.device)
        for ci in range(-(-n_pad // chunk)):
            take = min(chunk, n_pad - ci * chunk)
            arch.append(quantize.quantize_with_scale(
                gen(ci)[:take], arch.scale).cpu().numpy())
        fill_s = time.perf_counter() - t0
        pad_ids = np.arange(Engine.PAD_ID_BASE, Engine.PAD_ID_BASE + n_pad,
                            dtype=np.int64)
        t0 = time.perf_counter()
        seg.bulk_load_archive(arch, np.concatenate([base_i, pad_ids]))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        engine._pad_counts[key] = n_pad   # searches over-fetch past pads
        body = seg.body
        code_bytes = body.codes.numel() + body.row_ids.numel() * 4
        mean_list = body.n / body.nlist
        log(f"ivf_pq store rows {total} (pad {n_pad}) d=768: archive fill "
            f"(pads generated on the card, int8 to the host) {fill_s:.2f} "
            f"s; streaming build {build_s:.2f} s = {total / build_s:,.0f} "
            f"vec/s; body nlist={body.nlist} cap_len={body.cap_len} "
            f"m={body.m} live={body.n} (mean list {mean_list:.1f}, "
            f"cap_len/mean {body.cap_len / mean_list:.3f}), in tail "
            f"{seg.tail.count}; codes+ids {code_bytes / 2**30:.2f} GiB, "
            f"refine {body.refine.numel() / 2**30:.2f} GiB | {card}")

        lat = []
        for i in sampled:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"ivf_pq padded store: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        log(f"ivf_pq single search over RPC: p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms ({len(lat)} searches, right "
            f"top hit each; a lone request waits out the "
            f"{cfg['batch_window_s'] * 1e3:.0f} ms admission window) | "
            f"{card}")
        qv1 = engine.encoder.encode([fact_query(i) for i in sampled])
        lat1, served = [], []
        for i in range(len(sampled)):
            t0 = time.perf_counter()
            served.append(seg.search(qv1[i:i + 1], 10)[1][0])
            lat1.append((time.perf_counter() - t0) * 1e3)
        log(f"ivf_pq StoreIndex.search Q=1 in process (every batch size "
            f"goes through the list-scan kernel): p50 "
            f"{np.percentile(lat1, 50):.3f} ms p99 "
            f"{np.percentile(lat1, 99):.3f} ms | {card}")
        exact = seg.exact_reference_search(qv1, 10)
        # Engine.search asks a padded store's index for max(4k, 32) rows
        # (pads carry no metadata and are dropped from the hits), so for
        # k=10 the index re-ranks the ADC top 256: the served top 10 are
        # the first 10 of that. The bare index call with k=10 re-ranks 64
        served40 = np.stack([seg.search(qv1[i:i + 1], 40)[1][0, :10]
                             for i in range(len(sampled))])
        fact_recall = pq_recall_with_ties(seg, gather, qv1, served40, exact)
        log(f"ivf_pq recall@10 of fact questions (Q=1) vs "
            f"exact_reference_search: {fact_recall:.4f} counting a chunk "
            f"that ties the 10th exact score (integer int8 dots), "
            f"{recall_at(served40, exact):.4f} by ids alone, as "
            f"Engine.search asks the index (40 rows, ADC top 256 "
            f"re-ranked); StoreIndex.search(k=10) (ADC top 64 re-ranked) "
            f"{pq_recall_with_ties(seg, gather, qv1, served, exact):.4f} "
            f"and {recall_at(served, exact):.4f}; {len(sampled)} questions "
            f"| {card}")
        if fact_recall < RECALL_MIN:
            fail(f"ivf_pq fact-question recall@10 {fact_recall} < "
                 f"{RECALL_MIN}")

        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 24)]
        scan0, gather0 = pq_scan.LAUNCHES.count, gather.LAUNCHES.count
        search_profile.reset()
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        batches = search_profile.snapshot().get("body_dispatch",
                                                {"n": 0})["n"]
        right = sum(1 for i, h in zip(qids, hits)
                    if h and h[0].doc_id == f"doc-{i}")
        conc = (pq_scan.LAUNCHES.count - scan0,
                gather.LAUNCHES.count - gather0)
        log(f"ivf_pq concurrent search over RPC: {threads} threads, "
            f"{len(qids)} queries in {wall:.3f} s = "
            f"{len(qids) / wall:,.1f} QPS; {batches} batches (mean "
            f"{len(qids) / max(1, batches):.1f} queries), launches "
            f"pq_list_scan {conc[0]} gather_rescore_int8 {conc[1]}; right "
            f"top hit {right}/{len(qids)} ({right / len(qids):.4f}) | {card}")
        if min(conc) == 0:
            fail(f"ivf_pq concurrent batches launched {conc}")

        bq = [fact_query(int(i)) for i in rng.integers(0, args.docs, 1024)]
        remote.search_batch(key, bq[:64], k=10)
        t0 = time.perf_counter()
        scores, ids = remote.search_batch(key, bq, k=10)
        bwall = time.perf_counter() - t0
        if scores.shape != (1024, 10):
            fail(f"ivf_pq search_batch returned {scores.shape}")
        log(f"ivf_pq search_batch Q=1024 over RPC (encode included): "
            f"{bwall * 1e3:.1f} ms = {1024 / bwall:,.0f} QPS; top score "
            f"finite for {int(np.isfinite(scores[:, 0]).sum())}/1024 | "
            f"{card}")
        probe = remote.recall_probe(key, k=10, sample=64)
        if probe["recall"] is None:
            fail(f"ivf_pq recall_probe {probe}")
        log(f"ivf_pq recall_probe@10 (stored rows, nearly all pads) vs "
            f"exact_reference_search: {probe['recall']:.4f} (sample "
            f"{probe['sample']}) | {card}")

        # the other refine tiers on the same body, a short run each
        seg.pq_refine = "host"
        for i in sampled[:16]:
            hits = remote.search([key], fact_query(i), k=5)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"ivf_pq host refine: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        log(f"ivf_pq pq_refine=host (ADC on the card, rescore against the "
            f"host archive): right top hit 16/16 | {card}")
        with seg._body_lock:
            seg.pq_refine = "none"
            seg.body = body._replace(refine=body.refine[:0, :0])
        right = 0
        for i in sampled[:16]:
            hits = remote.search([key], fact_query(i), k=5)
            right += bool(hits and hits[0].doc_id == f"doc-{i}")
        log(f"ivf_pq pq_refine=none (raw ADC ranking): right top hit "
            f"{right}/16 | {card}")
        with seg._body_lock:
            seg.pq_refine = "device"
            seg.body = body
        launches = (pq_scan.LAUNCHES.count, gather.LAUNCHES.count)
        log(f"ivf_pq main path kernel launches: pq_list_scan {launches[0]}, "
            f"gather_rescore_int8 {launches[1]}; device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
        if min(launches) == 0:
            fail(f"the ivf_pq main path launched {launches}")

        qv = engine.encoder.encode(bq)
        seg.search(qv, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            seg.search(qv, 10)
        dwall = (time.perf_counter() - t0) / 3
        log(f"ivf_pq StoreIndex.search Q=1024 in process: "
            f"{dwall * 1e3:.2f} ms = {1024 / dwall:,.0f} QPS | {card}")
        probe_rows, _ = seg.sample_live_rows(1024, seed=args.seed + 1)
        seg.search(probe_rows, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            seg.search(probe_rows, 10)
        swall = (time.perf_counter() - t0) / 3
        log(f"ivf_pq StoreIndex.search Q=1024 stored rows in process (host "
            f"clock, int8 transport, device refine, tail merge): "
            f"{swall * 1e3:.2f} ms = {1024 / swall:,.0f} QPS | {card}")
    finally:
        remote.close()
        server.shutdown()

    # -- phase 7: restart on the same data_dir ------------------------------
    del engine, seg, remote, server, arch
    gc.collect()
    engine2 = Engine(EngineConfig(**cfg))
    server2 = EngineRpcServer(engine2, sock, allow_pad=True).start()
    remote2 = RemoteEngine(sock)
    try:
        seg2 = engine2._store(key).segment
        back = seg2.body
        if back is None or type(back).__name__ != "IVFPQIndex":
            fail("ivf_pq restart: no PQ body reloaded")
        for name in ("codes", "row_ids", "centroids", "codebook_centroids",
                     "refine"):
            if not torch.equal(getattr(back, name), saved[name]):
                fail(f"ivf_pq restart: reloaded {name} differs")
        if seg2._pq_archive is None or not np.array_equal(
                seg2._pq_archive.chunk_i8(0, seg2._pq_archive.n),
                saved["archive"]):
            fail("ivf_pq restart: reloaded archive differs")
        for i in sampled:
            again = remote2.search([key], fact_query(i), k=5)
            if again != before_pad[i]:
                fail(f"ivf_pq restart: hits for project {i} differ")
        log(f"ivf_pq restart: body.npz reloaded verbatim on the card "
            f"(codes, ids, codebooks, refine) with its archive; "
            f"{len(sampled)} queries give the same hits (the store as "
            f"saved; pads are not persisted)")
    finally:
        remote2.close()
        server2.shutdown()
    del engine2, remote2, server2, back, saved, seg2
    gc.collect()

    # -- phase 8: the two kernels on the PQ path's own dispatch -------------
    # a Q=1024 batch of stored rows through the engine's own transport
    # (int8, batch-absmax scale), routing and inversion
    fetch = 16                # what StoreIndex passes for k=10
    p = min(cfg["ivf_p"], fetch)
    q_scale = float(np.abs(probe_rows).max()) / 127.0
    q8 = torch.as_tensor(np.clip(np.round(probe_rows / q_scale), -127, 127)
                         .astype(np.int8), device="cuda")
    q32, _, _, dispatch, _, dropped = tpq.route(body, q8, 32,
                                                q_scale=q_scale)
    lut_disp, _ = tpq.scan_inputs(body, q32, dispatch, torch.int8)
    nlist, qcap, km = lut_disp.shape
    cap_len, m_bytes = body.codes.shape[1], body.codes.shape[2]
    live_n = pq_scan.live_slots(dispatch)
    kv, ki = pq_scan.pq_list_scan(lut_disp, body.codes, body.row_ids,
                                  dispatch, p=p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rv, ri = pq_scan.pq_list_scan_reference(lut_disp, body.codes,
                                            body.row_ids, dispatch, p=p)
    torch.cuda.synchronize()
    scan_plain_ms = (time.perf_counter() - t0) * 1e3
    scan_err = check_pq_scan(kv, ki, rv, ri, True, "pq_list_scan int8 main")
    del kv, ki, rv, ri
    scan_ms = cuda_ms(lambda: pq_scan.pq_list_scan(
        lut_disp, body.codes, body.row_ids, dispatch, p=p), reps=5,
        warmup=1)
    scan_bound_ms, scan_by, c = roofline.pq_scan_bound(body.row_ids, live_n, qcap, p,
                                              body.m, m_bytes, 1)
    log(f"pq_list_scan int8 LUT main path, Q=1024 stored rows: "
        f"nlist={nlist} qcap={qcap} (dropped {int(dropped)}) "
        f"cap_len={cap_len} m={body.m} p={p}, {c['lists_read']} lists with "
        f"queries, {c['live_slots']} live slots, {c['rows_needed']} live "
        f"rows of {c['rows_in_lists_read']}, {c['lookups']:.3e} lookups: "
        f"bit-identical; kernel {scan_ms:.3f} ms, plain "
        f"{scan_plain_ms:.3f} ms (one run), no single library call, bound "
        f"{scan_bound_ms:.3f} ms ({scan_by}) | {card}")
    del lut_disp
    # the same Q=1024 search split by stage, as StoreIndex runs it
    stage_split(
        torch, lambda: tpq.ivfpq_search(body, q8, fetch, nprobe=32, p=p,
                                        q_scale=q_scale),
        [(tpq, "route", "after"), (tpq, "scan_inputs", "after"),
         (tpq, "pq_list_scan", "after"), (tpq, "_refine_rerank", "before")],
        ["coarse + dispatch", "LUT build and gather", "list scan",
         "regather and ADC top-C", "re-rank"], card,
        "ivf_pq search of Q=1024 stored rows (ivfpq_search, split by CUDA "
        "events between its stages in one call)")

    q32, _, rows, _ = tpq.adc_top_rows(body, q8, fetch, nprobe=32, p=p,
                                       q_scale=q_scale)
    qq, _ = quantize.quantize_int8(q32)
    rows = rows.contiguous()
    q_n, cands = rows.shape
    out = gather.gather_rescore_int8(body.refine, rows, qq)
    torch.cuda.synchronize()
    ref = gather.gather_rescore_int8_reference(body.refine, rows, qq)
    if not torch.equal(out, ref):
        fail("gather_rescore_int8 main: kernel != plain version")
    del out, ref
    gather_ms = cuda_ms(lambda: gather.gather_rescore_int8(
        body.refine, rows, qq), reps=20)
    gather_plain_ms = cuda_ms(lambda: gather.gather_rescore_int8_reference(
        body.refine, rows, qq), reps=3, warmup=1)
    gather_bound_ms, gather_by = roofline.gather_bound(q_n, cands, 768)
    log(f"gather_rescore_int8 main path, Q={q_n} C={cands} d=768 over a "
        f"refine table of {body.refine.shape[0]} rows: bit-identical; "
        f"kernel {gather_ms:.4f} ms, plain {gather_plain_ms:.3f} ms, no "
        f"single library call, bound {gather_bound_ms:.4f} ms "
        f"({gather_by}) | {card}")
    shutil.rmtree(data_dir, ignore_errors=True)
    return [{
        "name": "pq_list_scan", "route": "cuda",
        "source": "rag_foundation_tpu_torch/csrc/pq_list_scan.cu",
        "replaces": "rag_foundation_tpu/ops/pallas_pq.py:135",
        "launches": launches[0], "max_abs_err": scan_err, "ms": scan_ms,
        "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
        "bound_by": scan_by, "library_ms": None, "dtype": "int8 LUT",
        "shape": {"nlist": nlist, "qcap": qcap, "cap_len": cap_len,
                  "m": body.m, "m_bytes": m_bytes, "p": p, **c},
    }, {
        "name": "gather_rescore_int8", "route": "cuda",
        "source": "rag_foundation_tpu_torch/csrc/gather_rescore_int8.cu",
        "replaces": "rag_foundation_tpu/ops/pallas_gather.py:66",
        "launches": launches[1], "max_abs_err": 0.0, "ms": gather_ms,
        "plain_ms": gather_plain_ms, "bound_ms": gather_bound_ms,
        "bound_by": gather_by, "library_ms": None, "dtype": "int8",
        "shape": {"N": int(body.refine.shape[0]), "Q": q_n, "C": cands,
                  "d": 768},
    }]


_NOUNS = ("report", "budget", "engineer", "station", "survey", "network",
          "harbor", "archive", "signal", "garden", "council", "reactor",
          "library", "market", "tunnel", "orchard")
_VERBS = ("measured", "reported", "tested", "moved", "checked", "updated",
          "ranked", "opened")


def long_doc(rng, words: int) -> str:
    """``words`` whitespace words of report prose from ``rng``: plurals,
    past tenses, adverbs and numbers with separators, which the tokenizer
    splits, so a 200-word chunk tokenizes past 256 ids."""
    out, n = [], 0
    while n < words:
        a, b = rng.integers(0, len(_NOUNS), 2)
        sent = (f"The {_NOUNS[a]}s of project "
                f"{project_name(int(rng.integers(8000)))} "
                f"{_VERBS[int(rng.integers(len(_VERBS)))]} "
                f"{int(rng.integers(1, 999))},{int(rng.integers(1000)):03d} "
                f"credits quickly, and the {_NOUNS[b]} teams were "
                f"{_VERBS[int(rng.integers(len(_VERBS)))]} steadily.")
        out.append(sent)
        n += len(sent.split())
    return " ".join(out)


def attention_inputs(torch, g, b, h, s, d, dtype):
    """q, k, v normal; segment 1 for a token, 0 for a pad; random lengths,
    row 1 all pads, row 2 one token."""
    q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lengths[1], lengths[2] = 0, 1
    seg = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])
    return q, k, v, seg.int().contiguous()


class ShapeTally:
    """The forward kernel's launches by shape while started: wraps
    ``flash_attention_forward``, which ``flash_attention`` and
    ``FlashAttention`` look up at call time, and counts its calls on card
    tensors by (B, S). Printed beside the wrapper's own counter, which
    stays the check."""

    def __init__(self, fa):
        self.fa, self.orig, self.counts = fa, fa.flash_attention_forward, {}

    def start(self) -> "ShapeTally":
        def counted(q, *a, **kw):
            if q.device.type == "cuda" and q.numel() > 0:
                key = (q.shape[0], q.shape[2])
                self.counts[key] = self.counts.get(key, 0) + 1
            return self.orig(q, *a, **kw)

        self.fa.flash_attention_forward = counted
        return self

    def stop(self) -> dict:
        self.fa.flash_attention_forward = self.orig
        return self.counts

    def text(self) -> str:
        """"S=... : n launches (B ...)" by S, the largest S first."""
        by_s = {}
        for (b, s), n in self.counts.items():
            by_s.setdefault(s, []).append((b, n))
        return "; ".join(
            f"S={s}: {sum(n for _, n in bs)} (" + ", ".join(
                f"B={b} x{n}" for b, n in sorted(bs, reverse=True)[:4])
            + (", ..." if len(bs) > 4 else "") + ")"
            for s, bs in sorted(by_s.items(), reverse=True))


def check_attention(torch, out, ref, v, kind, what) -> tuple[float, float]:
    """(max |kernel - plain|, tolerance); fails beyond the tolerance."""
    tol = ATTN_TOL[kind] * float(v.float().abs().max())
    if not bool(torch.isfinite(out).all()):
        fail(f"{what}: non-finite output")
    err = float((out.float() - ref.float()).abs().max())
    if err > tol:
        fail(f"{what}: max |kernel - plain| {err} > {tol}")
    return err, tol


def phase_small_attention(fa, torch):
    """Phase 12: flash_attention vs its plain version on the card."""
    g = torch.Generator(device="cuda").manual_seed(4)
    h, d = 12, 32
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        report = []
        for b, s in ((8, 16), (8, 32), (8, 100), (8, 128), (24, 512)):
            q, k, v, seg = attention_inputs(torch, g, b, h, s, d, dtype)
            out = fa.flash_attention(q, k, v, seg, seg, d ** -0.5)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v, seg, seg, d ** -0.5)
            err, tol = check_attention(torch, out, ref, v, kind,
                                       f"flash_attention {kind} S={s}")
            report.append(f"S={s} B={b} {err:.3g} (tol {tol:.3g})")
            del q, k, v, seg, out, ref
        log(f"kernel check flash_attention {kind} H={h} D={d}, random "
            f"lengths, an all-pad row, a one-token row: max_abs_err "
            + ", ".join(report))


def encoder_phases(args, card, rng, sampled, mods) -> dict:
    """Phase 13: the MiniLM encoder path. Returns the flash_attention
    entry of the ``kernels`` line."""
    import numpy as np
    import torch
    from rag_foundation_tpu_torch.utils import roofline
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    Engine, EngineConfig, EngineRpcServer, RemoteEngine = mods
    ckpt = ROOT / "checkpoints" / "minilm_ict.npz"
    if not ckpt.exists():
        fail(f"{ckpt} not found")
    data_dir = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-minilm-")
    sock = str(Path(data_dir) / "engine.sock")
    key = "stores/chip-smoke-minilm"
    # 76 words a chunk stays inside the checkpoint's 128-token window (no
    # warning). An IVF-Flat body of 16 lists, all probed, capturing 10
    # rows a sub-block: under MiniLM the near-duplicate fact documents
    # crowd a few lists, and 12 probes with the default capture of 4
    # served recall@10 0.9359 (a throwaway run on the H100)
    base = dict(chunk_tokens=76, chunk_overlap=16, index_mode="ivf_flat",
                nlist=16, nprobe=16, ivf_p=10, build_threshold=256,
                batch_window_s=0.02, device="cuda")
    fa.LAUNCHES.reset()                          # counts: this path only
    tally = ShapeTally(fa).start()
    engine = Engine(EngineConfig(dim=384, encoder="minilm",
                                 encoder_ckpt=str(ckpt), data_dir=data_dir,
                                 **base))
    server = EngineRpcServer(engine, sock, allow_pad=True).start()
    remote = RemoteEngine(sock, pool_size=80)
    queries = [fact_query(i) for i in sampled]
    try:
        remote.create_store(key)
        t0 = time.perf_counter()
        for i in range(args.docs):
            remote.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                                   fact_doc(i))
        ingest_s = time.perf_counter() - t0
        ingest_launches = fa.LAUNCHES.count
        n0 = fa.LAUNCHES.count
        remote.search([key], queries[0], k=10)
        single_launches = fa.LAUNCHES.count - n0
        seg = engine._store(key).segment
        log(f"minilm (minilm_ict.npz: hidden 384, 6 layers, 12 heads, "
            f"max_len 128): ingested {args.docs} documents over RPC in "
            f"{ingest_s:.2f} s ({remote.store_stats(key)['chunks']} chunks, "
            f"IVF-Flat body {'built' if seg.body is not None else 'NOT built'}"
            f"); flash_attention launches: ingest {ingest_launches}, one "
            f"single search {single_launches} | {card}")
        if ingest_launches == 0 or single_launches == 0:
            fail(f"the MiniLM path launched flash_attention {ingest_launches}"
                 f" times on ingest and {single_launches} on a search")
        lat, served, right = [], [], 0
        for i, q in zip(sampled, queries):
            t0 = time.perf_counter()
            hits = remote.search([key], q, k=10)
            lat.append((time.perf_counter() - t0) * 1e3)
            served.append([h.chunk_id for h in hits]
                          + [-1] * (10 - len(hits)))
            right += bool(hits and hits[0].doc_id == f"doc-{i}")
        # one question an encode, as served: another batch shape rounds
        # the bf16 forward differently, which can swap near-tied chunks
        qv = np.concatenate([engine.encoder.encode([q]) for q in queries])
        recall = recall_at(np.asarray(served), seg.exact_reference_search(
            qv, 10))
        log(f"minilm single search over RPC (encode on the card included): "
            f"p50 {np.percentile(lat, 50):.3f} ms p99 "
            f"{np.percentile(lat, 99):.3f} ms ({len(lat)} searches, a lone "
            f"request waits out the {base['batch_window_s'] * 1e3:.0f} ms "
            f"window); recall@10 vs exact_reference_search {recall:.4f}; "
            f"right top hit {right}/{len(sampled)} | {card}")
        if recall < RECALL_MIN:
            fail(f"minilm recall@10 {recall} < {RECALL_MIN}")
        threads = 64
        qids = [int(i) for i in rng.integers(0, args.docs, size=threads * 8)]
        hits, wall = run_concurrent(remote, key,
                                    [fact_query(i) for i in qids], threads)
        right_c = sum(1 for i, h in zip(qids, hits)
                      if h and h[0].doc_id == f"doc-{i}")
        log(f"minilm concurrent search over RPC: {threads} threads, "
            f"{len(qids)} queries in {wall:.3f} s = {len(qids) / wall:,.1f} "
            f"QPS; right top hit {right_c}/{len(qids)} | {card}")
        # the stored embeddings against the plain attention on the card
        vecs, cids = seg.live_rows()
        store = engine._store(key)
        enc = engine.encoder
        ids = enc.tokenizer.encode_batch(
            [store.chunks[int(c)].text for c in cids], enc.cfg.max_len)
        with torch.inference_mode():
            plain = tenc.encode_tokens(
                enc.params, torch.as_tensor(ids, device="cuda"), enc.cfg,
                attention=fa.flash_attention_reference).cpu().numpy()
        cos = float((vecs * plain).sum(axis=1).min())
        log(f"minilm stored embeddings ({len(cids)}, kernel path, batches "
            f"of one chunk) vs encode_tokens with flash_attention_reference "
            f"on the card (one batch at S={enc.cfg.max_len}): min cosine "
            f"{cos:.6f} (floor {EMBED_COS_MIN}) | {card}")
        if cos < EMBED_COS_MIN:
            fail(f"minilm embeddings: min cosine {cos} < {EMBED_COS_MIN}")
    finally:
        remote.close()
        server.shutdown()
    shutil.rmtree(data_dir, ignore_errors=True)
    del engine, server, remote, seg, store, enc

    # -- the same documents under the hybrid encoder -------------------------
    hyb = Engine(EngineConfig(dim=768, encoder="hybrid",
                              encoder_ckpt=str(ckpt), hybrid_w=0.35,
                              **base))
    hyb.create_store(key)
    n0 = fa.LAUNCHES.count
    t0 = time.perf_counter()
    for i in range(args.docs):
        hyb.ingest_document(key, f"doc-{i}", f"project-{i}.txt", fact_doc(i))
    hyb_s = time.perf_counter() - t0
    right_h = sum(1 for i, q in zip(sampled, queries)
                  if hyb.search([key], q, k=5)[0].doc_id == f"doc-{i}")
    log(f"hybrid (384 hash + 384 MiniLM, w=0.35, dim 768): ingested "
        f"{args.docs} documents in process in {hyb_s:.2f} s "
        f"({fa.LAUNCHES.count - n0} flash_attention launches); right top "
        f"hit {right_h}/{len(sampled)} (MiniLM alone {right}/"
        f"{len(sampled)}) | {card}")
    del hyb

    # -- the long-chunk configuration: MiniLM-L6 at max_len 512 --------------
    cfg512 = tenc.EncoderConfig(max_len=512)
    tmp = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-minilm512-")
    path = str(Path(tmp) / "minilm_l6_len512.npz")
    tenc.save_params(tenc.init_params(
        torch.Generator().manual_seed(args.seed), cfg512), path, cfg512)
    long_e = Engine(EngineConfig(dim=384, encoder="minilm",
                                 encoder_ckpt=path, device="cuda"))
    enc = long_e.encoder
    drng = np.random.default_rng(args.seed + 5)
    # LONG_BATCH + 1 chunks a document at 200 words a chunk, 40
    # overlapping: the ingest pipeline encodes a batch of LONG_BATCH, then 1
    docs = [long_doc(drng, 160 * LONG_BATCH + 200)
            for _ in range(args.long_docs)]
    long_e.create_store(key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j, text in enumerate(docs):
        long_e.ingest_document(key, f"long-{j}", f"long-{j}.txt", text)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    flash_launches = fa.LAUNCHES.count           # read just after the path
    by_shape = tally.stop()
    log(f"flash_attention launches on the serve phases by shape: "
        f"{tally.text()} | {card}")
    store = long_e._store(key)
    texts = [store.chunks[c].text for c in sorted(store.chunks)]
    lens = (enc.tokenizer.encode_batch(texts[:LONG_BATCH], 512) != 0).sum(
        axis=1)
    log(f"minilm max_len 512 (init_params seed {args.seed}, save_params -> "
        f"encoder_ckpt, chunk_tokens 200): ingested {len(docs)} documents "
        f"of {len(docs[0].split())} words = {len(texts)} chunks in "
        f"{long_s:.2f} s = {len(texts) / long_s:,.1f} chunks/s (chunking, "
        f"tokenizing, encoding, insert); a chunk tokenizes to "
        f"{int(lens.min())}-{int(lens.max())} ids, so every batch encodes "
        f"at S={512 if lens.max() > 256 else 256} | {card}")
    # the encoder alone: host tokenizer + device forward, then the forward
    n_enc = min(len(texts), 8 * LONG_BATCH) // LONG_BATCH * LONG_BATCH
    enc.encode(texts[:LONG_BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_enc, LONG_BATCH):
        enc.encode(texts[lo:lo + LONG_BATCH])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    ids = torch.as_tensor(enc.tokenizer.encode_batch(texts[:LONG_BATCH],
                                                     512), device="cuda")
    captured = []

    def capture(*a):
        captured.append([t.clone() if torch.is_tensor(t) else t for t in a])
        return fa.flash_attention_reference(*a)

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: tenc.encode_tokens(enc.params, ids, cfg512),
                         reps=5)
        tenc.encode_tokens(enc.params, ids, cfg512, attention=capture)
    log(f"minilm max_len 512 encode of {n_enc} chunks in batches of "
        f"{LONG_BATCH}: {enc_s:.2f} s = {n_enc / enc_s:,.1f} chunks/s with "
        f"the host tokenizer; the device forward alone (6 layers, "
        f"B={LONG_BATCH}, S=512) {fwd_ms:.2f} ms = "
        f"{LONG_BATCH / fwd_ms * 1e3:,.1f} chunks/s | {card}")

    # -- the kernel on the path's own layer-0 inputs, with times -------------
    q, k, v, sq, skv, scale = captured[0]
    del captured
    out = fa.flash_attention(q, k, v, sq, skv, scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, sq, skv, scale)
    err, tol = check_attention(torch, out, ref, v, "bf16",
                               "flash_attention main")
    del out, ref
    b, h, s, d = q.shape
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, sq, skv, scale),
                 reps=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(
        q, k, v, sq, skv, scale), reps=3, warmup=1)
    mask = (sq[:, :, None] == skv[:, None, :])[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), reps=20)
    bound_ms, bound_by, c = roofline.attention_bound(sq, skv, h, d, 2)
    log(f"flash_attention bf16 main path (layer 0 of a batch of long "
        f"chunks), B={b} H={h} S={s} D={d}, {c['pairs']} of "
        f"{c['dense_pairs']} (query, key) pairs share a segment: "
        f"max_abs_err={err:.3g} (tol {tol:.3g}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention (bool mask) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: bytes "
        f"{c['bytes'] / roofline.HBM_BYTES_S * 1e3:.4f} ms, tensor "
        f"operations {c['operations'] / roofline.PEAK_OPS_S['bf16'] * 1e3:.4f}"
        f" ms, exponential floor {c['exp_floor_ms']:.4f} ms for the "
        f"{c['exponentials']} same-segment pairs x heads; the kernel issues "
        f"{c['exponentials_issued']}, "
        f"{roofline.exp_floor_ms(c['exponentials_issued'], 1):.4f} ms; dense "
        f"S^2 operations {4.0 * b * h * s * s * d / roofline.PEAK_OPS_S['bf16'] * 1e3:.4f}"
        f" ms) | {card}")
    del long_e, enc, q, k, v, sq, skv, mask
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "rag_foundation_tpu_torch/csrc/flash_attention.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        ":758 (called at rag_foundation_tpu/models/"
                        "encoder.py:116)",
            "launches": flash_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "dtype": "bf16",
            "launches_by_b_s": {f"{bb},{ss}": n
                                for (bb, ss), n in by_shape.items()},
            "shape": {"B": b, "H": h, "S": s, "D": d, **c}}


def bwd_check(torch, got, want, bound, kind, what) -> float:
    """Max |kernel - plain| of a backward output; fails beyond
    ``rel * (bound + n * |plain|)`` in any element, (rel, n) =
    ``ATTN_BWD_TOL[kind]`` (``bound`` is sum |a||b| of the output's
    products)."""
    if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        fail(f"{what}: dtype {got.dtype} or non-finite output")
    rel, n = ATTN_BWD_TOL[kind]
    diff = (got.float() - want.float()).abs()
    excess = diff - rel * (bound + n * want.float().abs())
    if float(excess.max()) > 0.0:
        fail(f"{what}: |kernel - plain| beyond the tolerance by "
             f"{float(excess.max())}")
    return float(diff.max())


def check_bwd_kernels(torch, fa, q, k, v, sq, skv, lse, do, di, scale, kind,
                      what) -> tuple[float, float]:
    """Both backward kernels against their plain versions on the same
    inputs: (max_abs_err of dK/dV, of dQ)."""
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, sq, skv, lse, do, di, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, sq, skv, lse, do, di, scale)
    torch.cuda.synchronize()
    rk, rv = fa.flash_attention_bwd_dkv_reference(q, k, v, sq, skv, lse, do,
                                                  di, scale)
    rq = fa.flash_attention_bwd_dq_reference(q, k, v, sq, skv, lse, do, di,
                                             scale)
    bq, bk, bv = fa.backward_error_bounds(q, k, v, sq, skv, lse, do, di,
                                          scale)
    err_kv = max(bwd_check(torch, dk, rk, bk, kind, f"{what} dK"),
                 bwd_check(torch, dv, rv, bv, kind, f"{what} dV"))
    err_q = bwd_check(torch, dq, rq, bq, kind, f"{what} dQ")
    return err_kv, err_q


def phase_small_attention_bwd(fa, torch):
    """Phase 14: the backward kernels against their plain versions, the
    forward's lse against a masked logsumexp, and FlashAttention's
    gradients against autograd of the plain forward, on the card."""
    g = torch.Generator(device="cuda").manual_seed(14)
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        report = []
        for b, h, s, d in BWD_SHAPES:
            q, k, v, seg = attention_inputs(torch, g, b, h, s, d, dtype)
            do = torch.randn((b, h, s, d), generator=g,
                             device="cuda").to(dtype)
            scale = d ** -0.5
            out, lse = fa.flash_attention_forward(q, k, v, seg, seg, scale,
                                                  with_lse=True)
            torch.cuda.synchronize()
            logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                  k.float()) * scale
            same = (seg[:, :, None] == seg[:, None, :])[:, None]
            want = torch.logsumexp(logits.masked_fill(~same, -float("inf")),
                                   dim=-1)
            lse_err = float((lse - want).abs().max())
            if not bool(torch.isfinite(lse).all()) or lse_err > LSE_TOL:
                fail(f"flash_attention lse {kind} S={s}: max error "
                     f"{lse_err} > {LSE_TOL}")
            del logits, same, want
            # the backward kernels on the plain forward's lse and di
            ref_out, ref_lse = fa.flash_attention_reference(
                q, k, v, seg, seg, scale, with_lse=True)
            di = (ref_out.float() * do.float()).sum(dim=-1)
            err_kv, err_q = check_bwd_kernels(
                torch, fa, q, k, v, seg, seg, ref_lse, do, di, scale, kind,
                f"flash_attention_bwd {kind} S={s} D={d}")
            # FlashAttention (all three kernels) against autograd of the
            # plain forward
            grads = []
            for fn in (fa.flash_attention, fa.flash_attention_reference):
                t = [x.clone().requires_grad_(True) for x in (q, k, v)]
                fn(*t, seg, seg, scale).backward(do)
                grads.append([x.grad.float() for x in t])
            # a gradient that is exactly 0 (dQ and dK at S=1, where the one
            # weight is constant) is held to the largest one's norm
            norms = [float(r.norm()) for r in grads[1]]
            rel = max(float((a - r).norm()) / (n if n > 0 else max(norms))
                      for a, r, n in zip(*grads, norms))
            if rel > APPLY_TOL[kind]:
                fail(f"FlashAttention {kind} S={s}: gradient relative norm "
                     f"error {rel} > {APPLY_TOL[kind]}")
            report.append(f"S={s} B={b} H={h} D={d}: lse {lse_err:.3g}, "
                          f"dK/dV {err_kv:.3g}, dQ {err_q:.3g}, autograd "
                          f"rel {rel:.3g}")
            del q, k, v, seg, do, out, lse, ref_out, ref_lse, di, grads
        log(f"kernel check flash_attention_bwd_dkv/_dq {kind} (random "
            f"lengths, an all-pad row, a one-token row; max_abs_err, "
            f"within {ATTN_BWD_TOL[kind][0]:.3g} x (sum|a||b| + "
            f"{ATTN_BWD_TOL[kind][1]} |plain|)), "
            f"lse vs logsumexp (tol {LSE_TOL}), FlashAttention vs autograd "
            f"of the plain forward (tol {APPLY_TOL[kind]:.3g}): "
            + "; ".join(report))
        # other segment layouts: the kernels on the plain forward's lse
        report = []
        for pattern in SEG_PATTERNS:
            errs = [0.0, 0.0]
            for b, h, s, d in BWD_SHAPES:
                q, k, v, seg = attention_inputs(torch, g, b, h, s, d, dtype)
                sq, skv = segment_pattern(torch, g, seg, pattern)
                do = torch.randn((b, h, s, d), generator=g,
                                 device="cuda").to(dtype)
                ref_out, ref_lse = fa.flash_attention_reference(
                    q, k, v, sq, skv, d ** -0.5, with_lse=True)
                di = (ref_out.float() * do.float()).sum(dim=-1)
                errs = [max(a, e) for a, e in zip(errs, check_bwd_kernels(
                    torch, fa, q, k, v, sq, skv, ref_lse, do, di, d ** -0.5,
                    kind, f"flash_attention_bwd {kind} {pattern} S={s} "
                          f"D={d}"))]
                del q, k, v, seg, sq, skv, do, ref_out, ref_lse, di
            report.append(f"{pattern}: dK/dV {errs[0]:.3g}, dQ {errs[1]:.3g}")
        log(f"kernel check flash_attention_bwd_dkv/_dq {kind}, other segment "
            f"layouts (S {', '.join(str(x[2]) for x in BWD_SHAPES)}; "
            f"max_abs_err within the same tolerance): " + "; ".join(report))
    torch.cuda.empty_cache()


# phase 14's shapes (B, H, S, D): the trainer's buckets, the ragged edges
# of the kernels' 16-, 32- and 64-row tiles, and each head dim
BWD_SHAPES = ((8, 12, 1, 32), (8, 12, 8, 16), (8, 12, 16, 32),
              (8, 12, 32, 32), (8, 12, 33, 32), (8, 12, 64, 64),
              (8, 12, 65, 32), (8, 12, 100, 32), (8, 12, 128, 32),
              (8, 12, 256, 32), (24, 12, 512, 32), (4, 4, 200, 64))
SEG_PATTERNS = ("packed", "random", "kv_differs", "no_key")


def segment_pattern(torch, g, seg, pattern):
    """(seg_q, seg_kv) [B, S] int32 from the real-then-pad ``seg``:
    "packed" three segments a row end to end (ids 1, 2, 3) before the
    pads; "random" ids 0-4 a token in no order; "kv_differs" random ids,
    row 0's keys drawn apart from its queries; "no_key" random ids, row
    0's keys in a segment none of its queries has (lse -inf, every p 0)."""
    b, s = seg.shape
    if pattern == "packed":
        cuts = torch.randint(0, s + 1, (b, 2), generator=g,
                             device="cuda").sort(dim=1).values
        pos = torch.arange(s, device="cuda")[None, :]
        ids = (1 + (pos >= cuts[:, :1]).int() + (pos >= cuts[:, 1:]).int())
        out = (ids * seg).int().contiguous()
        return out, out
    sq = torch.randint(0, 5, (b, s), generator=g, device="cuda",
                       dtype=torch.int32)
    skv = sq.clone()
    if pattern == "kv_differs":
        skv[0] = torch.randint(0, 5, (s,), generator=g, device="cuda",
                               dtype=torch.int32)
    elif pattern == "no_key":
        skv[0] = 7
    return sq, skv


def time_attention_bwd(torch, F, fa, cap, card, what) -> dict:
    """Both backward kernels on captured layer-0 inputs ``cap`` = (q, k, v,
    seg_q, seg_kv, scale, dO): checked against their plain versions, timed
    beside them, beside scaled_dot_product_attention's backward with the
    boolean mask (timed only), their bounds and the exponential floor."""
    from rag_foundation_tpu_torch.utils import roofline
    q, k, v, sq, skv, scale, do = cap
    b, h, s, d = q.shape
    out, lse = fa.flash_attention_forward(q, k, v, sq, skv, scale,
                                          with_lse=True)
    di = (out.float() * do.float()).sum(dim=-1)
    err_kv, err_q = check_bwd_kernels(torch, fa, q, k, v, sq, skv, lse, do,
                                      di, scale, "bf16", what)
    args = (q, k, v, sq, skv, lse, do, di, scale)
    res = {}
    mask = (sq[:, :, None] == skv[:, None, :])[:, None]
    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                          scale=scale)
    empty = roofline.empty_block_share(sq, skv)
    for name, kern, plain, wrt, outputs, ops, err in (
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv,
             fa.flash_attention_bwd_dkv_reference, (kl, vl), 2, 8, err_kv),
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq,
             fa.flash_attention_bwd_dq_reference, (ql,), 1, 6, err_q)):
        ms = cuda_ms(lambda: kern(*args), reps=20)
        plain_ms = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            sdpa, wrt, do, retain_graph=True), reps=20)
        bound_ms, bound_by, c = roofline.attention_bwd_bound(
            sq, skv, h, d, 2, outputs, ops)
        exp_ms = roofline.exp_floor_ms(c["pairs"], h)
        log(f"{name} bf16 {what}, B={b} H={h} S={s} D={d}, {c['pairs']} of "
            f"{c['dense_pairs']} pairs share a segment, {empty:.1%} of the "
            f"16x16 blocks hold none: max_abs_err={err:.3g}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention backward (bool mask, grad of "
            f"{'k, v' if outputs == 2 else 'q'}) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; dense S^2 operations "
            f"{ops * b * h * s * s * d / roofline.PEAK_OPS_S['bf16'] * 1e3:.4f}"
            f" ms), exponential floor {exp_ms:.4f} ms | {card}")
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms, "exp_floor_ms": exp_ms,
                     "shape": {"B": b, "H": h, "S": s, "D": d, **c,
                               "empty_16x16_blocks": empty}}
    del out, lse, di, args, mask, ql, kl, vl, sdpa
    return res


def capture_calls(fa, torch, calls: tuple[int, ...]):
    """An attention function that runs flash_attention and keeps the
    inputs and the output's gradient of its listed calls (0-based):
    ``.captured[call]`` = (q, k, v, seg_q, seg_kv, scale, dO)."""
    seen = [0]

    def attention(q, k, v, sq, skv, scale):
        out = fa.flash_attention(q, k, v, sq, skv, scale)
        if seen[0] in calls:
            keep = [x.detach().clone() for x in (q, k, v, sq, skv)]
            call = seen[0]

            def grab(grad):
                attention.captured[call] = (*keep, scale,
                                            grad.contiguous().clone())

            out.register_hook(grab)
        seen[0] += 1
        return out

    attention.captured = {}
    return attention


# kernel-name fragments of the training step's device time, in the order
# they are matched (the rest is elementwise passes and reductions)
STEP_PARTS = (("attention kernels", ("flash_fwd", "flash_bwd")),
              ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass")),
              ("layernorm", ("layer_norm", "gammabeta")),
              ("embedding", ("embedding", "index")),
              ("optimizer (foreach AdamW)", ("multi_tensor", "adam")))


def profile_train_steps(torch, step, params, qb, db, steps, card) -> None:
    """Device time of ``steps`` training steps by kernel, from
    torch.profiler: the parts of STEP_PARTS, the top kernels and the
    device's busy share of the window (kernel time over wall time; the
    profiler's own cost is in the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    step(params, qb, db)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(params, qb, db)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation ("Optimizer.step#AdamW.step") also
    # has device time, that of the kernels under it
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total == 0:
        log(f"training step profile: the profiler saw no device time (not "
            f"measured) | {card}")
        return
    parts = {name: 0.0 for name, _ in STEP_PARTS}
    parts["other (elementwise, reductions)"] = 0.0
    for e in kernels:
        key = e.key.lower()
        name = next((n for n, frags in STEP_PARTS
                     if any(f in key for f in frags)),
                    "other (elementwise, reductions)")
        parts[name] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"training step profile ({steps} steps under torch.profiler, batch "
        f"{qb.shape[0]}, q_len {qb.shape[1]}, d_len {db.shape[1]}): device "
        f"time {total / steps:.2f} ms a step, wall {wall_ms / steps:.2f} ms "
        f"a step, device busy {total / wall_ms:.1%}; "
        + ", ".join(f"{n} {t / steps:.2f} ms ({t / total:.1%})"
                    for n, t in parts.items())
        + "; top kernels: "
        + "; ".join(f"{e.key[:60]} x{e.count // steps} "
                    f"{e.self_device_time_total / 1e3 / steps:.3f} ms"
                    for e in top) + f" | {card}")


def train_phases(args, card, rng, sampled, mods) -> list[dict]:
    """Phase 15: MiniLM-L6 training at full width through the port's
    trainer (ICT on a corpus built by the recipe's own tool), serving from
    the checkpoint it saved, a few steps at d_len 512, the kernel path's
    gradients against the plain attention's, and the two backward kernels
    timed on the step's own layer-0 inputs. Returns their two entries of
    the ``kernels`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.models import encoder as tenc
    from rag_foundation_tpu_torch.models import optim
    from rag_foundation_tpu_torch.models.tokenizer import Tokenizer
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    from rag_foundation_tpu_torch.tools import train_encoder
    Engine, EngineConfig = mods
    tmp = tempfile.mkdtemp(prefix="ragtpu-chip-smoke-train-")
    corpus = str(Path(tmp) / "corpus.jsonl")
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "build_text_corpus.py"),
         "--out", corpus, "--max-passages", str(args.corpus_passages)],
        capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        fail(f"build_text_corpus.py failed: {built.stderr[-2000:]}")
    corpus_s = time.perf_counter() - t0
    chunks = train_encoder.load_chunks(corpus)
    log(f"corpus: scripts/build_text_corpus.py --max-passages "
        f"{args.corpus_passages} in {corpus_s:.1f} s: "
        f"{built.stderr.strip().splitlines()[-1]}, {len(chunks)} chunks of "
        f"25-100 words")

    # -- the trainer, ICT mode, the recipe's shapes --------------------------
    ckpt = str(Path(tmp) / "minilm_ict_port.npz")
    targs = train_encoder.parse_args([
        "--corpus", corpus, "--steps", str(args.train_steps), "--batch",
        str(TRAIN_BATCH), "--q-len", "32", "--d-len", "128", "--lr", "3e-4",
        "--temperature", "0.05", "--seed", str(args.seed), "--out", ckpt,
        "--device", "cuda"])
    counters = (fa.LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES)
    for c in counters:
        c.reset()                                 # counts: this path only
    tally = ShapeTally(fa).start()
    torch.cuda.synchronize()
    run = train_encoder.train_ict(targs, log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    launches = [c.count for c in counters]        # read just after the path
    tally.stop()
    log(f"flash_attention launches on the training path by shape: "
        f"{tally.text()} | {card}")
    losses, summary = run["losses"], run["summary"]
    steps, secs = targs.steps, run["train_s"]
    tenth = max(1, steps // 10)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    log(f"train_encoder ICT (MiniLM-L6: hidden 384, 6 layers, 12 heads, "
        f"ffn 1536, bf16; batch {TRAIN_BATCH}, q_len 32, d_len 128, "
        f"symmetric InfoNCE t=0.05, adamw lr 3e-4 warmup-cosine, clip 1.0, "
        f"seed {args.seed}): {steps} steps in {secs:.2f} s = "
        f"{secs / steps * 1e3:.2f} ms/step = {steps * TRAIN_BATCH / secs:,.0f}"
        f" pairs/s (batch draws, host loop and logging included); loss "
        f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}, mean of the "
        f"first tenth {first:.4f}, of the last {last:.4f}; launches on the "
        f"training path: flash_attention {launches[0]}, "
        f"flash_attention_bwd_dkv {launches[1]}, flash_attention_bwd_dq "
        f"{launches[2]} | {card}")
    if not np.isfinite(losses).all():
        fail(f"non-finite loss at step {int(np.argmin(np.isfinite(losses)))}")
    if not last < first:
        fail(f"the loss did not fall: first tenth {first}, last {last}")
    if min(launches) == 0:
        fail(f"the training path launched an attention kernel no time: "
             f"{launches}")
    log(f"held-out recall (eval_n {summary['eval_n']} chunks, keyword "
        f"queries; printed, no floor): minilm(ICT) recall@1 "
        f"{summary['minilm']['recall@1']:.4f} recall@10 "
        f"{summary['minilm']['recall@10']:.4f}; hash-fnv-v2 recall@1 "
        f"{summary['hash']['recall@1']:.4f} recall@10 "
        f"{summary['hash']['recall@10']:.4f} | {card}")
    trained, cfg = run["encoder"].params, run["encoder"].cfg
    del run

    # -- train -> checkpoint -> serve ------------------------------------------
    engine = Engine(EngineConfig(dim=384, encoder="minilm",
                                 encoder_ckpt=ckpt, chunk_tokens=76,
                                 chunk_overlap=16, device="cuda"))
    loaded = tenc._leaves(engine.encoder.params)
    for key, t in tenc._leaves(trained).items():
        if not torch.equal(loaded[key], t.detach()):
            fail(f"the served encoder's {key} differs from the trained one")
    key = "stores/chip-smoke-trained"
    engine.create_store(key)
    n0 = fa.LAUNCHES.count
    t0 = time.perf_counter()
    for i in range(args.docs):
        engine.ingest_document(key, f"doc-{i}", f"project-{i}.txt",
                               fact_doc(i))
    ingest_s = time.perf_counter() - t0
    right = 0
    for i in sampled:
        hits = engine.search([key], fact_query(i), k=10)
        if len(hits) != 10 or not all(np.isfinite(h.score) for h in hits):
            fail(f"trained encoder: search for project {i} gave {hits}")
        right += hits[0].doc_id == f"doc-{i}"
    log(f"served from the trained checkpoint (Engine encoder_ckpt, every "
        f"parameter equal to the trained one): ingested {args.docs} fact "
        f"documents in {ingest_s:.2f} s, {len(sampled)} searches of 10 hits;"
        f" right top hit {right}/{len(sampled)} (printed: the corpus never "
        f"saw these names); flash_attention launches "
        f"{fa.LAUNCHES.count - n0} | {card}")
    del engine, loaded

    # -- one step's gradients: kernel path vs plain attention -----------------
    tok = Tokenizer(vocab_size=cfg.vocab_size)
    qrng = np.random.default_rng(args.seed + 3)
    batch = chunks[:TRAIN_BATCH]
    qb = torch.as_tensor(tok.encode_batch(
        [train_encoder.keyword_query(qrng, c) for c in batch], 32),
        device="cuda")
    db = torch.as_tensor(tok.encode_batch(batch, 128), device="cuda")
    leaves = list(tenc._leaves(trained).values())
    grads = {}
    # layer 0 of the q side (the first call) and of the d side
    cap = capture_calls(fa, torch, (0, cfg.layers))
    for name, attn in (("kernel", cap), ("plain",
                                          fa.flash_attention_reference)):
        loss = tenc.contrastive_loss(trained, qb, db, cfg, 0.05, True,
                                     attention=attn)
        grads[name] = torch.autograd.grad(loss, leaves)
    worst_cos, worst_rel = 1.0, 0.0
    for a, r in zip(grads["kernel"], grads["plain"]):
        a, r = a.double().ravel(), r.double().ravel()
        if not bool(torch.isfinite(a).all()):
            fail("kernel-path gradient not finite")
        if float(r.norm()) == 0.0:
            continue
        worst_cos = min(worst_cos, float(a @ r / (a.norm() * r.norm())))
        worst_rel = max(worst_rel, float((a - r).norm() / r.norm()))
    log(f"one step's gradients (batch {TRAIN_BATCH}, q_len 32, d_len 128), "
        f"attention=flash_attention vs flash_attention_reference, "
        f"{len(leaves)} leaves: worst cosine {worst_cos:.6f} (floor "
        f"{GRAD_COS_MIN}), worst relative norm error {worst_rel:.4g} | "
        f"{card}")
    if worst_cos < GRAD_COS_MIN:
        fail(f"gradient cosine {worst_cos} < {GRAD_COS_MIN}")
    del grads
    profile_train_steps(
        torch, tenc.make_train_step(cfg, optim.adamw(3e-4), max_grad_norm=1.0,
                                    temperature=0.05, symmetric=True),
        trained, qb, db, 3, card)

    # -- d_len 512: the shape at which JAX's TPU path takes the kernels -------
    cfg512 = tenc.EncoderConfig(max_len=512)
    params512 = tenc.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg512)
    drng = np.random.default_rng(args.seed + 15)
    docs = [long_doc(drng, 380) for _ in range(TRAIN_BATCH)]
    d512 = torch.as_tensor(tok.encode_batch(docs, 512), device="cuda")
    q512 = torch.as_tensor(tok.encode_batch(
        [train_encoder.keyword_query(drng, t) for t in docs], 32),
        device="cuda")
    lens = (d512 != 0).sum(dim=1)
    step = tenc.make_train_step(cfg512, optim.adamw(3e-4), max_grad_norm=1.0,
                                temperature=0.05, symmetric=True)
    step(params512, q512, d512)                  # warm-up: allocator, build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n512 = 4
    t0 = time.perf_counter()
    l512 = [step(params512, q512, d512) for _ in range(n512)]
    torch.cuda.synchronize()
    ms512 = (time.perf_counter() - t0) / n512 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(bool(torch.isfinite(x)) for x in l512):
        fail("non-finite loss at d_len 512")
    log(f"train step at d_len 512 (seeded MiniLM-L6 max_len 512, batch "
        f"{TRAIN_BATCH} long documents of {int(lens.min())}-"
        f"{int(lens.max())} ids, q_len 32): {ms512:.2f} ms/step = "
        f"{TRAIN_BATCH / ms512 * 1e3:,.0f} pairs/s; loss "
        f"{float(l512[0]):.4f} -> {float(l512[-1]):.4f}; peak device memory "
        f"{peak:.2f} GiB | {card}")

    # -- the backward kernels on the step's own layer-0 inputs ----------------
    cap512 = capture_calls(fa, torch, (cfg512.layers,))
    loss = tenc.contrastive_loss(params512, q512, d512, cfg512, 0.05, True,
                                 attention=cap512)
    torch.autograd.grad(loss, list(tenc._leaves(params512).values()))
    del loss, params512, step
    layer0 = {32: cap.captured[0], 128: cap.captured[cfg.layers],
              512: cap512.captured[cfg512.layers]}
    lengths = {s: [int(n) for n in (c[3] != 0).sum(dim=1).tolist()]
               for s, c in layer0.items()}
    for s, ns in lengths.items():
        log(f"layer-0 rows at S={s}: real tokens {min(ns)}-{max(ns)}, "
            f"median {sorted(ns)[len(ns) // 2]}, {ns.count(s)} of "
            f"{len(ns)} rows full")
    if args.lengths_out:
        Path(args.lengths_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.lengths_out).write_text(json.dumps(lengths))
    at = {s: time_attention_bwd(torch, F, fa, c, card, f"{step_name}, layer "
                                f"0 of the {'q' if s == 32 else 'd'} side")
          for (s, c), step_name in zip(layer0.items(), (
              "training step", "training step", "d_len 512 step"))}
    del cap, cap512, layer0
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    entries = []
    for name, line, launched in (
            ("flash_attention_bwd_dkv", 1121, launches[1]),
            ("flash_attention_bwd_dq", 1456, launches[2])):
        main = at[128][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "rag_foundation_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py"
                        f":{line} (reached from rag_foundation_tpu/models/"
                        f"encoder.py:187 make_train_step)",
            "launches": launched, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "exp_floor_ms": main["exp_floor_ms"], "dtype": "bf16",
            "shape": main["shape"],
            **{f"at_s{s}": at[s][name] for s in (32, 512)}})
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="int8 store size after padding (default 10M)")
    ap.add_argument("--pq-rows", type=int, default=10_000_000,
                    help="ivf_pq store size after padding (default 10M)")
    ap.add_argument("--exact-rows", type=int, default=1_000_000,
                    help="rows of the exact scan and of the host-streamed "
                         "scan (default 1M)")
    ap.add_argument("--docs", type=int, default=400,
                    help="real documents ingested before padding")
    ap.add_argument("--long-docs", type=int, default=8,
                    help="long documents (257 chunks each) of phase 13")
    ap.add_argument("--corpus-passages", type=int, default=6000,
                    help="passages of phase 15's ICT corpus")
    ap.add_argument("--train-steps", type=int, default=300,
                    help="steps of phase 15's training run")
    ap.add_argument("--lengths-out", default=None,
                    help="write phase 15's layer-0 row lengths (JSON by S) "
                         "here, for time_kernels --lengths")
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
    from rag_foundation_tpu_torch.engine import ivf as tivf
    from rag_foundation_tpu_torch.engine import ivfpq as tpq
    from rag_foundation_tpu_torch.engine.api import Engine, EngineConfig
    from rag_foundation_tpu_torch.engine.archive import HostArchive
    from rag_foundation_tpu_torch.engine.ivf import ivf_search, scan_inputs
    from rag_foundation_tpu_torch.engine.profile import search_profile
    from rag_foundation_tpu_torch.engine.rpc import (EngineRpcServer,
                                                     RemoteEngine)
    from rag_foundation_tpu_torch.ops import (cuda_lib, flash_attention,
                                              gather, ivf_scan, pq_scan,
                                              quantize)
    from rag_foundation_tpu_torch.utils import roofline

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
    kernel_names = ["ivf_list_scan", "pq_list_scan", "gather_rescore_int8",
                    "block_topk", "fused_topk", "flash_attention",
                    "flash_attention_bwd"]
    report = cuda_lib.build(kernel_names)
    for name, r in report.items():
        log(f"build {name}: {r['seconds']:.2f} s")
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    for name in kernel_names:
        cuda_lib.load(name)

    # -- phase 2: kernels vs plain versions, small size ---------------------
    phase_small_kernels(ivf_scan, torch)
    phase_small_pq_kernels(pq_scan, gather, torch)
    phase_edge_kernels(ivf_scan, pq_scan, torch)

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
        prom0 = prom_samples(remote.metrics_text())
        for i in sampled * 3:
            t0 = time.perf_counter()
            hits = remote.search([key], fact_query(i), k=5)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not hits or hits[0].doc_id != f"doc-{i}":
                fail(f"padded store: top hit for project {i} is "
                     f"{hits[0].doc_id if hits else None}")
        prom1 = prom_samples(remote.metrics_text())
        sent = {k: prom1.get(f"engine_search_batch_size_{k}", 0.0)
                - prom0.get(f"engine_search_batch_size_{k}", 0.0)
                for k in ("count", "sum")}
        stages = sorted(k for k in prom1 if k.startswith(
            "engine_query_stage_seconds_count"))
        log(f"metrics_text over RPC: engine_search_batch_size_count +"
            f"{sent['count']:.0f}, _sum +{sent['sum']:.0f} over "
            f"{len(lat)} sequential searches; stage series {stages}")
        if sent["count"] != len(lat) or sent["sum"] != len(lat):
            fail(f"metrics_text: batch-size histogram moved by {sent}, "
                 f"{len(lat)} searches sent")
        if len(stages) != 3:
            fail(f"metrics_text: stage series {stages}")
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
        seg.search(probe_rows, 10)
        t0 = time.perf_counter()
        for _ in range(5):
            seg.search(probe_rows, 10)
        swall = (time.perf_counter() - t0) / 5
        log(f"StoreIndex.search Q=1024 stored rows in process (host "
            f"clock, int8 transport, tail merge): {swall * 1e3:.2f} ms = "
            f"{1024 / swall:,.0f} QPS | {card}")
    finally:
        remote.close()
        server.shutdown()

    # -- phase 4: restart on the same data_dir -------------------------------
    del engine, seg, remote, server       # body stays alive for phase 5
    gc.collect()
    engine2 = Engine(EngineConfig(**cfg))
    server2 = EngineRpcServer(engine2, sock, allow_pad=True).start()
    remote2 = RemoteEngine(sock)
    try:
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
        remote2.close()
        server2.shutdown()
    del engine2, remote2, server2, back, saved
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
    bound_ms, bound_by, c = roofline.scan_bound(row_ids, live_n, qcap, p, 1, d,
                                       "int8")
    log(f"ivf_list_scan int8 main path, Q=1024 stored rows: nlist={nlist} "
        f"qcap={qcap} (dropped {int(dropped)}) cap_len={cap_len} d={d} "
        f"p={p}, {c['lists_read']} lists with queries, {c['live_slots']} "
        f"live slots, {c['rows_needed']} live rows of "
        f"{c['rows_in_lists_read']}: bit-identical; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.bmm+topk (f32, every slot, "
        f"{lib_chunks} list chunks) {library_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}) | {card}")
    # the same Q=1024 search split by stage, as StoreIndex runs it (int8
    # transport with the body's scale, k=10 -> fetch 16)
    qj = torch.as_tensor(np.clip(np.round(probe_rows / np.float32(
        body.scale)), -127, 127).astype(np.int8), device="cuda")
    stage_split(
        torch, lambda: ivf_search(body, qj, 16, nprobe=32, p=p),
        [(tivf, "scan_inputs", "after"), (tivf, "ivf_list_scan", "after")],
        ["coarse + dispatch", "list scan", "regather and top-k"], card,
        "ivf_flat_int8 search of Q=1024 stored rows (ivf_search, split by "
        "CUDA events between its stages in one call)")
    del qj
    shutil.rmtree(data_dir, ignore_errors=True)
    # release the int8 store before the ivf_pq phases (the servers'
    # handler threads, which hold their engine, end once their clients'
    # connections are closed)
    del body, lists, row_ids, qdisp, dispatch, live_n
    time.sleep(0.5)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"int8 store released: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # -- phases 6-8: the ivf_pq store -----------------------------------------
    pq_kernels = pq_phases(
        args, card, rng, sampled,
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine, search_profile,
         HostArchive, tpq, pq_scan, gather, quantize))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ivf_pq store released: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # -- phases 9-11: the exact flat scan --------------------------------------
    exact_kernels = exact_phases(args, card)

    # -- phases 12-13: the MiniLM encoder and its attention kernel ------------
    phase_small_attention(flash_attention, torch)
    attn_kernel = encoder_phases(
        args, card, rng, sampled,
        (Engine, EngineConfig, EngineRpcServer, RemoteEngine))

    # -- phases 14-15: encoder training and the attention backward kernels ---
    phase_small_attention_bwd(flash_attention, torch)
    bwd_kernels = train_phases(args, card, rng, sampled,
                               (Engine, EngineConfig))
    log(f"total {time.perf_counter() - t_start:.1f} s")

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
    }] + pq_kernels + exact_kernels + [attn_kernel] + bwd_kernels}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
