"""Time the kernels on synthetic data of the shapes their paths give them.

    python -m rag_foundation_tpu_torch.tools.time_kernels
    python -m rag_foundation_tpu_torch.tools.time_kernels --only pq flat \\
        --other-pq path/to/another/pq_list_scan.cu [more...] \\
        --other-flat path/to/another/ivf_list_scan.cu [more...]
    python -m rag_foundation_tpu_torch.tools.time_kernels --only pq_tier \\
        --other-pq path/to/another/pq_list_scan.cu [more...]
    python -m rag_foundation_tpu_torch.tools.time_kernels \\
        --only attention attention_bwd \\
        --other-attn path/to/another/flash_attention.cu [more...] \\
        --other-attn-bwd path/to/another/flash_attention_bwd.cu \\
        --lengths build/attention_lengths.json
    python -m rag_foundation_tpu_torch.tools.time_kernels --only exact \\
        --other-exact path/to/another/csrc [more directories...]

Needs a CUDA card and ``nvcc``. Inputs: 4096 lists whose 2,441 live rows
are interleaved over the sub-blocks as the index lays them out, a
dispatch whose live slots per list are Poisson(8) (a Q=1024, nprobe=32
batch of uniform traffic), int8 values from a seeded generator. It prints
the card's name and power limit, then one line a variant: the ADC scan
(``pq_list_scan``: qcap 16 and 8, with the dispatch and with every slot
live, p 8 and 1, bf16 LUT, packed codes) and the flat scan
(``ivf_list_scan``, p 3), each time beside its bound (``utils.roofline``'s
``pq_scan_bound`` and ``scan_bound``). The flat section then times
BASELINE config 3's shape class (``CONFIG3``: 4,096 lists of 768 slots,
244 live rows a list interleaved as the index lays them out, d 768, p 3):
bf16 and f32 lists at a Poisson(8) dispatch (qcap 16, nprobe 32) and a
Poisson(32) one (qcap 64, nprobe 128), beside ``scan_bound`` for their
type. ``pq_tier`` times the ADC scan
at the 100M capacity tier's shape class (``TIER``: 24,415 lists of 4,480
slots, packed m=256 codes, about 14 GB of them, qcap 8, p 4, about 1.8
live slots a list read), on random codes and on one repeated byte. With
``--other-pq`` (at m=192 in ``pq``, at the tier's shape in ``pq_tier``)
or ``--other-flat`` (one or more sources each, each in turn) it also
builds that source (another
version of the kernel with the same C entry point; headers are taken
from its own directory), checks that the two give bit-identical outputs
on the main path's shape (int8, qcap 16, a Poisson(8) dispatch; p 8 for
the ADC scan, 3 for the flat one) and times them in turns (other, this,
this, other; five rounds of two pairs each, and the number of pairs
this version won), so that two versions are compared within one run on
one card; ``--other-flat`` also at config 3's two dispatches in bf16 and
in f32, the outputs there held within ``ivf_scan.F32_TOL`` of each other
(f32 sums in another order) rather than bit for bit. Both versions run
through their C entry on the same ``live_n`` and preallocated outputs.
Last come the exact-scan kernels on ``--exact-rows`` x 768 normal rows and
1024 queries: ``block_topk`` (p 2 and 10, its kernel alone, stage 2 alone
and the two together), ``fused_topk`` (the default split of the rows
and a few others, k 10 and 64), in bf16, and both in f32 on an eighth of
the rows; with ``--other-exact`` first the ``block_topk.cu`` and
``fused_topk.cu`` of each directory listed in turns against this version's
(``block_candidates`` p 2 and ``fused_topk`` k 10 in bf16, outputs
compared with ``torch.equal``). Then the encoder's attention
(``flash_attention``, H=12, D=32, bf16) at the batch and sequence buckets
MiniLM encodes at (B 1, 64, 256; S 16, 128, 512), every token real and
with chunks of half the bucket
(pads past them), beside ``scaled_dot_product_attention`` with the same
boolean mask; with ``--other-attn`` first each listed source in turns at
B=256 and S 32, 128, 512, two length patterns each as below (each
version's out and lse held to the plain version within ``chip_smoke.py``'s
tolerance). Then the attention
backward (``attention_bwd``: ``flash_attention_bwd_dkv`` and
``flash_attention_bwd_dq``, bf16, H=12, D=32) at the trainer's batch and
buckets (B 256; S 32, 128, 512), each with two length patterns (real
tokens then pads, the lengths drawn from ``--lengths``, the JSON that
``chip_smoke.py --lengths-out`` writes of phase 15's layer-0 rows, or
uniform in [1, S] without it; and every token real), beside their bounds,
the exponential floor and the backward of
``scaled_dot_product_attention`` with the same boolean mask (the gradient
of k and v, or of q); with ``--other-attn-bwd`` each listed source in
turns instead, both versions first held to the plain versions within
``chip_smoke.py``'s tolerance. Every time is the card's: the calls queue
behind a spin of the card, so a short kernel is not timed by its host
launch. ``--only`` picks sections.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import tempfile
from pathlib import Path

from rag_foundation_tpu_torch.utils import roofline


FAILED: list[str] = []   # checks that failed; main() exits non-zero


def _ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls back to back,
    queued behind a 100 us a call spin of the card, so that the host's
    launch overhead (tens of us a wrapper call) never starves the card
    and a short kernel is timed, not its launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 200_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _lists(torch, g, nlist: int, cap_len: int, live_rows: int):
    """Row ids of lists filled with ``live_rows`` rows in interleaved
    slots (``engine/ivf.py``'s layout), the rest dead."""
    nsub = cap_len // 128
    slot = torch.arange(cap_len, device="cuda")
    rank = (slot % 128) * nsub + slot // 128
    ids = torch.arange(nlist * cap_len, dtype=torch.int32,
                       device="cuda").view(nlist, cap_len)
    return torch.where(rank[None, :] < live_rows, ids,
                       torch.full_like(ids, -1)).contiguous()


def _dispatch(torch, g, nlist: int, qcap: int):
    n_live = torch.poisson(torch.full((nlist,), 8.0, device="cuda"),
                           generator=g).clamp(0, qcap).int()
    disp = torch.where(torch.arange(qcap, device="cuda")[None, :]
                       < n_live[:, None], 0, -1).int()
    return disp, int(n_live.sum())


def _bound(t) -> str:
    """``(ms, bound_by, ...)`` of ``utils.roofline`` as text."""
    return f"{t[0]:.4f} ms ({t[1]})"


def pq_bound(ids, live_n, qcap, p, m, lut_esize, m_bytes=None) -> str:
    return _bound(roofline.pq_scan_bound(ids, live_n, qcap, p, m,
                                         m if m_bytes is None else m_bytes,
                                         lut_esize))


def flat_bound(ids, live_n, qcap, p, d) -> str:
    return _bound(roofline.scan_bound(ids, live_n, qcap, p, 1, d, "int8"))


def _other_fn(src: str, entry: str, argtypes, tmp: str):
    """The C entry point of another version of a kernel source, built once
    a source into ``tmp``."""
    from rag_foundation_tpu_torch.ops import cuda_lib
    tag = hashlib.sha256(str(Path(src).resolve()).encode()).hexdigest()[:12]
    lib_path = Path(tmp) / f"lib{Path(src).stem}-{tag}.so"
    if not lib_path.exists():
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS[:-2],
                        "-o", str(lib_path), src], check=True)
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _turns(torch, name, other, this, bound, check=None) -> int:
    """The outputs compared (bit-identity, or ``check(other_outputs,
    this_outputs)``, which returns its verdict), then other/this/this/other
    five times: ten pairs, (other, this) and (this, other) in each round.
    Returns the pairs this version won."""
    ov, tv = other(), this()
    torch.cuda.synchronize()
    if check is None:
        same = all(torch.equal(a, b) for a, b in zip(ov, tv))
        verdict = "bit-identical" if same else "DIFFER"
    else:
        verdict = check(ov, tv)
    print(f"{name}: outputs {verdict}; bound {bound}", flush=True)
    won = 0
    for _ in range(5):
        t = [_ms(other), _ms(this), _ms(this), _ms(other)]
        won += (t[1] < t[0]) + (t[2] < t[3])
        print(f"  other {t[0]:.4f} this {t[1]:.4f} this {t[2]:.4f} other "
              f"{t[3]:.4f} ms", flush=True)
    print(f"  this faster in {won} of 10 pairs", flush=True)
    return won


def time_pq(torch, g, nlist: int, live_rows: int,
            other_srcs: list[str]) -> None:
    from rag_foundation_tpu_torch.ops import pq_scan
    cap_len, m = 3712, 192
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    ids = _lists(torch, g, nlist, cap_len, live_rows)
    for qcap in (16, 8):
        lut = torch.randint(-127, 128, (nlist, qcap, 16 * m), generator=g,
                            device="cuda", dtype=torch.int8)
        disp, live = _dispatch(torch, g, nlist, qcap)
        if qcap == 16:
            for src in other_srcs:
                _pq_turns(torch, src, lut, codes, ids, disp, live, m, 8,
                          False, f"m={m}")
        every = torch.full((nlist,), qcap, dtype=torch.int32, device="cuda")
        for name, d, slots in (("Poisson(8) dispatch", disp, live),
                               ("every slot live", None, nlist * qcap)):
            live_n = every if d is None else pq_scan.live_slots(d)
            for p in (8, 1):
                t = _ms(lambda: pq_scan.pq_list_scan(lut, codes, ids, d,
                                                     p=p))
                print(f"pq_list_scan int8 LUT qcap={qcap} {name} "
                      f"({slots} live slots) p={p}: {t:.3f} ms, bound "
                      f"{pq_bound(ids, live_n, qcap, p, m, 1)}",
                      flush=True)
        lutb = torch.randn((nlist, qcap, 16 * m), generator=g,
                           device="cuda").bfloat16()
        t = _ms(lambda: pq_scan.pq_list_scan(lutb, codes, ids, None, p=8))
        print(f"pq_list_scan bf16 LUT qcap={qcap} every slot live p=8: "
              f"{t:.3f} ms, bound "
              f"{pq_bound(ids, every, qcap, 8, m, 2)}", flush=True)
    packed = pq_scan.pack_codes(codes).contiguous()
    t = _ms(lambda: pq_scan.pq_list_scan(lut, packed, ids, None, p=8))
    print(f"pq_list_scan int8 LUT qcap=8 packed codes every slot live p=8: "
          f"{t:.3f} ms", flush=True)


# The 100M capacity tier's dispatch (chip_smoke.py phase 26): 24,415 lists
# of 4,480 slots, packed m = 256 codes, qcap 8, p = 4, about 4,100 live
# rows a list (74.2M over the 18,113 lists read) and 32,768 probes spread
# over the lists (Poisson(32768 / 24415) live slots a list: about 1.8 a
# list read).
TIER = {"nlist": 24_415, "cap_len": 4480, "m": 256, "qcap": 8, "p": 4,
        "live_rows": 4097, "probes": 32_768}


def time_pq_tier(torch, g, other_srcs: list[str]) -> None:
    """The ADC scan at the 100M tier's shape class on synthetic codes
    (about 14 GB on the card): the live-slot histogram and the lists by
    route, each ``other_srcs`` in turns against this version, then this
    version on random codes and on codes of one repeated byte (equal times:
    no bank conflict that depends on the codes)."""
    from rag_foundation_tpu_torch.ops import pq_scan
    nlist, cap_len, m = TIER["nlist"], TIER["cap_len"], TIER["m"]
    qcap, p = TIER["qcap"], TIER["p"]
    codes = torch.randint(0, 256, (nlist, cap_len, m // 2), generator=g,
                          device="cuda", dtype=torch.uint8)
    ids = _lists(torch, g, nlist, cap_len, TIER["live_rows"])
    lut = torch.randint(-127, 128, (nlist, qcap, 16 * m), generator=g,
                        device="cuda", dtype=torch.int8)
    n_live = torch.poisson(torch.full((nlist,), TIER["probes"] / nlist,
                                      device="cuda"),
                           generator=g).clamp(0, qcap).int()
    disp = torch.where(torch.arange(qcap, device="cuda")[None, :]
                       < n_live[:, None], 0, -1).int()
    live_n = pq_scan.live_slots(disp)
    hist = torch.bincount(live_n.long(), minlength=qcap + 1).tolist()
    routes = pq_scan.scan_routes(torch.int8, True, m, p, live_n)
    bound = pq_bound(ids, live_n, qcap, p, m, 1, m // 2)
    what = (f"nlist={nlist} cap_len={cap_len} m={m} packed qcap={qcap} "
            f"p={p}, {int(live_n.sum())} live slots")
    print(f"pq_list_scan tier {what}: lists by live slots {hist}, by route "
          f"{routes}; bound {bound}", flush=True)
    for src in other_srcs:
        _pq_turns(torch, src, lut, codes, ids, disp, int(live_n.sum()), m, p,
                  True, "the 100M tier's shape")
    t = _ms(lambda: pq_scan.pq_list_scan(lut, codes, ids, disp, p=p), reps=5)
    codes.fill_(0x5A)
    t_same = _ms(lambda: pq_scan.pq_list_scan(lut, codes, ids, disp, p=p),
                 reps=5)
    print(f"pq_list_scan tier {what}: {t:.3f} ms on random codes, "
          f"{t_same:.3f} ms on one repeated byte; bound {bound}", flush=True)


def _pq_turns(torch, other_src, lut, codes, ids, disp, live, m, p, packed,
              shape) -> None:
    from rag_foundation_tpu_torch.ops import pq_scan
    nlist, qcap, _ = lut.shape
    cap_len, m_bytes = ids.shape[1], codes.shape[2]
    live_n = pq_scan.live_slots(disp)
    w = (cap_len // 128) * p
    ov = torch.empty((nlist, qcap, w), dtype=torch.float32, device="cuda")
    oi = torch.empty((nlist, qcap, w), dtype=torch.int32, device="cuda")
    tv = torch.empty_like(ov)
    ti = torch.empty_like(oi)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        fn = _other_fn(other_src, "pq_list_scan_launch",
                       [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                        ci, vp], tmp)

        # both versions through their C entry on the same live_n and
        # preallocated outputs: the wrapper's own small kernels (live_slots,
        # the allocations) fall on neither side
        def launch(f, v, i):
            rc = f(0, int(packed), lut.data_ptr(), codes.data_ptr(),
                   ids.data_ptr(), live_n.data_ptr(), v.data_ptr(),
                   i.data_ptr(), nlist, qcap, cap_len, m, m_bytes, p,
                   torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"pq_list_scan_launch: CUDA error {rc}")
            return v, i

        this_fn = pq_scan._kernel()
        _turns(torch, f"pq_list_scan int8 LUT {shape} "
               f"({'packed' if packed else 'unpacked'}) qcap={qcap} "
               f"({live} live slots) p={p}, other = {other_src}",
               lambda: launch(fn, ov, oi), lambda: launch(this_fn, tv, ti),
               pq_bound(ids, live_n, qcap, p, m, 1, m_bytes))


def _flat_other(torch, other_src: str, tmp: str, code: int, q, lists, ids,
                live_n, p: int, scale: float):
    """Another ``ivf_list_scan.cu`` through its C entry on preallocated
    outputs (and this version's the same way): the wrapper's small kernels
    (``live_slots``, the allocations) fall on neither side."""
    nlist, qcap, d = q.shape
    cap_len = lists.shape[1]
    w = (cap_len // 128) * p
    vp, ci = ctypes.c_void_p, ctypes.c_int
    argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                ctypes.c_float, vp]
    from rag_foundation_tpu_torch.ops import ivf_scan

    def runner(fn):
        v = torch.empty((nlist, qcap, w), dtype=torch.float32, device="cuda")
        i = torch.empty((nlist, qcap, w), dtype=torch.int32, device="cuda")

        def launch():
            rc = fn(code, q.data_ptr(), lists.data_ptr(), ids.data_ptr(),
                    live_n.data_ptr(), v.data_ptr(), i.data_ptr(), nlist,
                    qcap, cap_len, d, p, scale,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"ivf_list_scan_launch: CUDA error {rc}")
            return v, i
        return launch

    return (runner(_other_fn(other_src, "ivf_list_scan_launch", argtypes,
                             tmp)), runner(ivf_scan._kernel()))


def time_flat(torch, g, nlist: int, live_rows: int,
              other_srcs: list[str]) -> None:
    from rag_foundation_tpu_torch.ops import ivf_scan
    qcap, cap_len, d, p = 16, 2816, 768, 3
    lists = torch.randint(-127, 128, (nlist, cap_len, d), generator=g,
                          device="cuda", dtype=torch.int8)
    q = torch.randint(-127, 128, (nlist, qcap, d), generator=g,
                      device="cuda", dtype=torch.int8)
    ids = _lists(torch, g, nlist, cap_len, live_rows)
    disp, live = _dispatch(torch, g, nlist, qcap)
    live_n = ivf_scan.live_slots(disp)
    bound = flat_bound(ids, live_n, qcap, p, d)
    name = (f"ivf_list_scan int8 qcap={qcap} Poisson(8) dispatch ({live} "
            f"live slots) p={p}")

    def this():
        return ivf_scan.ivf_list_scan(q, lists, ids, disp, p=p, scale=1e-4)

    if not other_srcs:
        print(f"{name}: {_ms(this):.3f} ms, bound {bound}", flush=True)
    for src in other_srcs:
        with tempfile.TemporaryDirectory() as tmp:
            other, mine = _flat_other(torch, src, tmp, 0, q, lists, ids,
                                      live_n, p, 1e-4)
            _turns(torch, f"{name}, other = {src}", other, mine, bound)
    del lists, q, ids
    time_flat_config3(torch, g, other_srcs)


# BASELINE config 3's dispatches (chip_smoke.py phase 27): 1M rows over
# 4,096 lists (about 244 live rows a list, interleaved over the sub-blocks
# as the index lays them out), d 768, p 3; a Q=1024 batch at nprobe 32
# gives Poisson(8) live slots a list (qcap 16), at nprobe 128 Poisson(32)
# (qcap 64). cap_len is the largest list rounded up to 128: config 3's
# build of 1M rows gave 768 (chip_smoke.py phase 27)
CONFIG3 = {"nlist": 4096, "cap_len": 768, "d": 768, "live_rows": 244,
           "p": 3, "dispatches": ((16, 8.0), (64, 32.0))}


def _close(ov, tv) -> str:
    """Two versions' outputs within ``ivf_scan.F32_TOL``, the -inf pattern
    equal; indices may differ between rows scoring within it (counted)."""
    import torch
    from rag_foundation_tpu_torch.ops.ivf_scan import F32_TOL
    fin = torch.isfinite(ov[0])
    if not torch.equal(fin, torch.isfinite(tv[0])):
        FAILED.append("flat config 3: -inf patterns differ")
        return "DIFFER (-inf pattern)"
    err = float((ov[0][fin] - tv[0][fin]).abs().max()) if fin.any() else 0.0
    ids = int((ov[1] != tv[1]).sum())
    if err > F32_TOL:
        FAILED.append(f"flat config 3: max |other - this| {err}")
    return (f"max |other - this| {err:.3g} (tol {F32_TOL}), {ids} indices "
            f"differ" + ("" if err <= F32_TOL else " DIFFER"))


def time_flat_config3(torch, g, other_srcs: list[str]) -> None:
    """bf16 and f32 lists (the engine's ``ivf_flat`` type) of config 3's
    shape class (``CONFIG3``) at each of its dispatches, beside
    ``scan_bound`` (2 or 4 bytes an element, the type's peak); with
    ``other_srcs`` each source in turns at each, outputs compared within
    ``ivf_scan.F32_TOL``."""
    from rag_foundation_tpu_torch.ops import ivf_scan
    nlist, cap_len, d, p = (CONFIG3[k] for k in ("nlist", "cap_len", "d",
                                                  "p"))
    ids = _lists(torch, g, nlist, cap_len, CONFIG3["live_rows"])
    lists = torch.randn((nlist, cap_len, d), generator=g, device="cuda")
    lists /= lists.norm(dim=-1, keepdim=True)
    for dt in (torch.bfloat16, torch.float32):
        rows = lists.to(dt)
        for qcap, lam in CONFIG3["dispatches"]:
            q = torch.randn((nlist, qcap, d), generator=g, device="cuda")
            q = (q / q.norm(dim=-1, keepdim=True)).to(dt)
            n_live = torch.poisson(torch.full((nlist,), lam, device="cuda"),
                                   generator=g).clamp(0, qcap).int()
            disp = torch.where(torch.arange(qcap, device="cuda")[None, :]
                               < n_live[:, None], 0, -1).int()
            live_n = ivf_scan.live_slots(disp)
            kind = "bf16" if dt == torch.bfloat16 else "f32"
            bound = _bound(roofline.scan_bound(ids, live_n, qcap, p,
                                               rows.element_size(), d, kind))
            name = (f"ivf_list_scan {kind} config 3 shape (nlist {nlist}, "
                    f"cap_len {cap_len}, {CONFIG3['live_rows']} live rows a "
                    f"list) qcap={qcap} Poisson({lam:g}) dispatch "
                    f"({int(live_n.sum())} live slots) p={p}, route "
                    f"{ivf_scan.scan_route(dt, qcap, d, p)}")

            def this():
                return ivf_scan.ivf_list_scan(q, rows, ids, disp, p=p)

            if not other_srcs:
                print(f"{name}: {_ms(this, reps=5):.4f} ms, bound {bound}",
                      flush=True)
            for src in other_srcs:
                with tempfile.TemporaryDirectory() as tmp:
                    other, mine = _flat_other(torch, src, tmp,
                                              ivf_scan._DTYPE_CODE[dt], q,
                                              rows, ids, live_n, p, 1.0)
                    _turns(torch, f"{name}, other = {src}", other, mine,
                           bound, check=_close)
        del rows


def _exact_inputs(torch, g, n: int, d: int, q_n: int, dtype):
    c = torch.empty((n, d), dtype=dtype, device="cuda")
    for lo in range(0, n, 131_072):
        c[lo:lo + 131_072] = torch.randn((min(131_072, n - lo), d),
                                         generator=g, device="cuda")
    return torch.randn((q_n, d), generator=g, device="cuda").to(dtype), c


def time_exact(torch, g, rows: int, other_dirs: list[str]) -> None:
    """The exact-scan kernels; with ``other_dirs`` (directories, each
    holding another ``block_topk.cu``, ``fused_topk.cu`` and the headers
    they include), first each version in turns against this one at
    ``rows`` x 768 bf16, Q=1024: ``block_candidates`` (p=2, block_n=1024)
    and ``fused_topk`` (k=10, the default split), outputs compared with
    ``torch.equal``."""
    from rag_foundation_tpu_torch.ops import block_topk as bt
    from rag_foundation_tpu_torch.ops import fused_topk as ft
    d, q_n = 768, 1024
    if other_dirs:
        q, c = _exact_inputs(torch, g, rows, d, q_n, torch.bfloat16)
        for other_dir in other_dirs:
            _exact_turns(torch, bt, ft, q, c, other_dir)
        del q, c
    for dtype, n in ((torch.bfloat16, rows), (torch.float32, rows // 8)):
        q, c = _exact_inputs(torch, g, n, d, q_n, dtype)
        name = f"{str(dtype).split('.')[1]} N={n} d={d} Q={q_n}"
        for p in (2, 10):
            t1 = _ms(lambda: bt.block_candidates(q, c, p, n, 1024), reps=5)
            t2 = _ms(lambda: bt.block_topk(q, c, 10, p=p), reps=5)
            cands = bt.block_candidates(q, c, p, n, 1024)
            t3 = _ms(lambda: bt._finish(*cands, 10), reps=5)
            print(f"block_topk {name} k=10 p={p} block_n=1024: kernel "
                  f"{t1:.3f} ms, stage 2 alone {t3:.3f} ms, with the stage-2 "
                  f"merge {t2:.3f} ms", flush=True)
            del cands
        auto = ft.default_splits(q_n, n, c.device)
        for k, splits in ((10, None), (10, 16), (10, 64), (10, 512),
                          (64, None)):
            t = _ms(lambda: ft.fused_topk(q, c, k, n_splits=splits), reps=5)
            print(f"fused_topk {name} k={k} n_splits="
                  f"{auto if splits is None else splits}"
                  f"{' (default)' if splits is None else ''}: {t:.3f} ms",
                  flush=True)
        del c, q


def _exact_turns(torch, bt, ft, q, c, other_dir: str) -> None:
    n, d = c.shape
    q_n, p, k, block_n = q.shape[0], 2, 10, 1024
    nseg = -(-n // block_n)
    splits = ft.default_splits(q_n, n, c.device)
    seg_len = -(-(-(-n // splits)) // 128) * 128
    n_splits = -(-n // seg_len)
    bound = _bound(roofline.topk_bound(q_n, n, d, k, 2, "bf16"))
    dev = c.device
    cv = torch.empty((q_n, nseg, p), dtype=torch.float32, device=dev)
    ci = torch.empty((q_n, nseg, p), dtype=torch.int32, device=dev)
    pv = torch.empty((q_n, n_splits, k), dtype=torch.float32, device=dev)
    pi = torch.empty((q_n, n_splits, k), dtype=torch.int32, device=dev)
    fv = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    fi = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    vp, ci_t = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fb = _other_fn(str(Path(other_dir) / "block_topk.cu"),
                       "block_topk_launch",
                       [ci_t, vp, vp, vp, ci_t, vp, vp, ci_t, ci_t, ci_t,
                        ci_t, ci_t, vp], tmp)
        ff = _other_fn(str(Path(other_dir) / "fused_topk.cu"),
                       "fused_topk_launch",
                       [ci_t, vp, vp, vp, ci_t, vp, vp, vp, vp, ci_t, ci_t,
                        ci_t, ci_t, ci_t, vp], tmp)

        def other_block():
            rc = fb(2, q.data_ptr(), c.data_ptr(), None, n, cv.data_ptr(),
                    ci.data_ptr(), q_n, n, d, block_n, p, stream)
            if rc != 0:
                raise RuntimeError(f"other kernel: CUDA error {rc}")
            return cv, ci

        def other_fused():
            rc = ff(2, q.data_ptr(), c.data_ptr(), None, n, pv.data_ptr(),
                    pi.data_ptr(), fv.data_ptr(), fi.data_ptr(), q_n, n, d,
                    seg_len, k, stream)
            if rc != 0:
                raise RuntimeError(f"other kernel: CUDA error {rc}")
            return fv, fi

        _turns(torch, f"block_candidates bf16 N={n} d={d} Q={q_n} p={p} "
               f"block_n={block_n} (kernel alone), other = {other_dir}",
               other_block, lambda: bt.block_candidates(q, c, p, n, block_n),
               bound)
        _turns(torch, f"fused_topk bf16 N={n} d={d} Q={q_n} k={k} "
               f"n_splits={n_splits}, other = {other_dir}", other_fused,
               lambda: ft.fused_topk(q, c, k), bound)


ATTN_H, ATTN_D = 12, 32     # MiniLM-L6's heads and head dim
# chip_smoke.py's ATTN_BWD_TOL for bf16: p and ds rounded to bf16 before a
# product (2^-8 of sum|a||b|), the kernel's and the plain version's output
# rounded to bf16 (2^-8 of |plain| each)
BWD_TOL = 2 ** -8


def _attn_ctypes(n_ptrs: int):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return [ci] + [vp] * n_ptrs + [ci, ci, ci, ci, ctypes.c_float, vp]


def time_attention(torch, g, others: list[str],
                   lengths: dict | None) -> None:
    """The forward at the encoder's buckets beside SDPA; with ``others``,
    first an A/B against each of those flash_attention.cu sources at B=256
    and S 32, 128, 512 (two length patterns each, as the backward's; both
    versions' outputs held to the plain version within ``ATTN_TOL`` of
    max|v|, their lse within ``LSE_TOL``)."""
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    h, d = ATTN_H, ATTN_D
    if others:
        b = 256
        with tempfile.TemporaryDirectory() as tmp:
            fns = [(src, _other_fn(src, "flash_attention_launch",
                                   _attn_ctypes(7), tmp)) for src in others]
            for s in (32, 128, 512):
                q, k, v = (torch.randn((b, h, s, d), generator=g,
                                       device="cuda").bfloat16()
                           for _ in range(3))
                for name, seg in _length_patterns(torch, g, b, s, lengths):
                    for src, fn in fns:
                        _fwd_turns(torch, fa, fn, q, k, v, seg, src, name)
    for b in (1, 64, 256):
        for s in (16, 128, 512):
            q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda")
                       .bfloat16() for _ in range(3))
            for name, real in (("all real", s), ("half real", s // 2)):
                seg = (torch.arange(s, device="cuda") < real).int() \
                    .expand(b, s).contiguous()
                mask = (seg[:, :, None] == seg[:, None, :])[:, None]
                t = _ms(lambda: fa.flash_attention(q, k, v, seg, seg,
                                                   d ** -0.5), reps=20)
                lib = _ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=d ** -0.5), reps=20)
                print(f"flash_attention bf16 B={b} H={h} S={s} D={d} "
                      f"{name}: {t:.4f} ms (scaled_dot_product_attention "
                      f"{lib:.4f} ms)", flush=True)


# chip_smoke.py's ATTN_TOL (bf16, times max|v|) and LSE_TOL
ATTN_TOL, LSE_TOL = 3 * 2 ** -9, 1e-4


def _fwd_turns(torch, fa, fn, q, k, v, seg, other_src, name) -> None:
    b, h, s, d = q.shape
    scale = d ** -0.5
    out, lse = torch.empty_like(q), torch.empty((b, h, s), device="cuda")
    ref, ref_lse = fa.flash_attention_reference(q, k, v, seg, seg, scale,
                                                with_lse=True)
    tol = ATTN_TOL * float(v.float().abs().max())

    def other():
        rc = fn(2, q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                seg.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, s, d,
                scale, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"other kernel: CUDA error {rc}")
        return out, lse

    def check(ov, tv) -> str:
        errs = []
        for who, (o, l) in (("other", ov), ("this", tv)):
            err = float((o.float() - ref.float()).abs().max())
            fin = torch.isfinite(ref_lse)
            lerr = float((l[fin] - ref_lse[fin]).abs().max())
            if err > tol or lerr > LSE_TOL or not torch.equal(
                    torch.isfinite(l), fin):
                FAILED.append(f"flash_attention {who} S={s} {name}: out "
                              f"{err} (tol {tol}), lse {lerr}")
                return f"OUTSIDE the tolerance ({who})"
            errs.append(f"{who} max_abs_err {err:.3g}, lse {lerr:.3g}")
        return "within the tolerance of the plain version (" \
            + ", ".join(errs) + f"; tol {tol:.3g}, lse {LSE_TOL})"

    ms, by, c = roofline.attention_bound(seg, seg, h, d, 2)
    _turns(torch, f"flash_attention bf16 B={b} H={h} S={s} D={d} {name} "
           f"({c['pairs']} of {c['dense_pairs']} pairs share a segment; "
           f"{c['exponentials_issued']} exponentials issued, "
           f"{c['exponentials']} needed), with lse, other = {other_src}",
           other, lambda: fa.flash_attention_forward(
               q, k, v, seg, seg, scale, with_lse=True),
           f"{ms:.4f} ms ({by}; exponential floor {c['exp_floor_ms']:.4f} "
           f"ms)", check)
    del ref, ref_lse


def _length_patterns(torch, g, b: int, s: int, lengths: dict | None):
    """(name, seg [b, s] int32): real tokens (1) then pads (0), with the
    lengths of ``lengths[str(s)]`` (phase 15's captured layer-0 rows, drawn
    with replacement) or, without them, uniform in [1, s]; then all real."""
    if lengths is not None and str(s) in lengths:
        pool = torch.tensor(lengths[str(s)], device="cuda")
        n = pool[torch.randint(0, len(pool), (b,), generator=g,
                               device="cuda")]
        name = "phase-15 lengths"
    else:
        n = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
        name = "lengths uniform in [1, S]"
    seg = (torch.arange(s, device="cuda")[None, :] < n[:, None]).int()
    return ((name, seg.contiguous()),
            ("all real", torch.ones((b, s), dtype=torch.int32,
                                    device="cuda")))




def _bwd_check(torch, fa, args, plain):
    """check() of _turns for the backward kernels: each version's outputs
    against the plain version's within BWD_TOL x (sum|a||b| + 2 |plain|)."""
    bounds = plain["bounds"]

    def check(ov, tv) -> str:
        errs = []
        for who, outs in (("other", ov), ("this", tv)):
            worst, err = float("-inf"), 0.0
            for got, want, bound in zip(outs, plain["outs"], bounds):
                diff = (got.float() - want.float()).abs()
                worst = max(worst, float((diff - BWD_TOL * (
                    bound + 2 * want.float().abs())).max()))
                err = max(err, float(diff.max()))
            if worst > 0.0:
                FAILED.append(f"{who}: outside the tolerance by {worst}")
                return f"OUTSIDE the tolerance ({who}, by {worst:.3g})"
            errs.append(f"{who} max_abs_err {err:.3g}")
        return "within the tolerance of the plain version (" \
            + ", ".join(errs) + ")"

    return check


def time_attention_bwd(torch, g, others: list[str], lengths: dict | None
                       ) -> None:
    """The two backward kernels at the trainer's batch (B=256, H=12, D=32)
    and buckets (S 32, 128, 512), each with two length patterns: beside
    their bounds, exponential floor and SDPA's backward, or, with
    ``others``, in turns against each other flash_attention_bwd.cu."""
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    b, h, d = 256, ATTN_H, ATTN_D
    scale = d ** -0.5
    for s in (32, 128, 512):
        q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        for name, seg in _length_patterns(torch, g, b, s, lengths):
            out, lse = fa.flash_attention_forward(q, k, v, seg, seg, scale,
                                                  with_lse=True)
            di = (out.float() * do.float()).sum(dim=-1)
            args = (q, k, v, seg, seg, lse, do, di, scale)
            pairs = roofline.same_segment_pairs(seg, seg)
            what = (f"B={b} H={h} S={s} D={d} {name} ({pairs} of {b * s * s}"
                    f" pairs share a segment, "
                    f"{roofline.empty_block_share(seg, seg):.1%} of 16x16 "
                    f"blocks hold none; exponential floor "
                    f"{roofline.exp_floor_ms(pairs, h):.4f} ms)")
            bound_kv = _bound(roofline.attention_bwd_bound(seg, seg, h, d, 2,
                                                           2, 8))
            bound_q = _bound(roofline.attention_bwd_bound(seg, seg, h, d, 2,
                                                          1, 6))
            if others:
                dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(*args)
                dq_r = fa.flash_attention_bwd_dq_reference(*args)
                bq, bk, bv = fa.backward_error_bounds(*args)
                _bwd_turns(torch, fa, others, args, what, bound_kv, bound_q,
                           {"outs": (dk_r, dv_r), "bounds": (bk, bv)},
                           {"outs": (dq_r,), "bounds": (bq,)})
                del dk_r, dv_r, dq_r, bq, bk, bv
                continue
            t_kv = _ms(lambda: fa.flash_attention_bwd_dkv(*args), reps=20)
            t_q = _ms(lambda: fa.flash_attention_bwd_dq(*args), reps=20)
            mask = (seg[:, :, None] == seg[:, None, :])[:, None]
            ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
            ref = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                 scale=scale)
            lib_kv = _ms(lambda: torch.autograd.grad(
                ref, (kl, vl), do, retain_graph=True), reps=20)
            lib_q = _ms(lambda: torch.autograd.grad(
                ref, (ql,), do, retain_graph=True), reps=20)
            print(f"flash_attention_bwd bf16 {what}: dkv {t_kv:.4f} ms "
                  f"(bound {bound_kv}), dq {t_q:.4f} ms (bound {bound_q}); "
                  f"scaled_dot_product_attention backward: k, v "
                  f"{lib_kv:.4f} ms, q {lib_q:.4f} ms", flush=True)
            del ql, kl, vl, ref, mask


def _bwd_turns(torch, fa, others, args, what, bound_kv, bound_q, plain_kv,
               plain_q) -> None:
    q, k, v, sq, skv, lse, do, di, scale = args
    b, h, s, d = q.shape
    dk, dv, dq = (torch.empty_like(x) for x in (k, v, q))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, sq, skv, lse, do, di)]
    with tempfile.TemporaryDirectory() as tmp:
        for src in others:
            fkv = _other_fn(src, "flash_attention_bwd_dkv_launch",
                            _attn_ctypes(10), tmp)
            fq = _other_fn(src, "flash_attention_bwd_dq_launch",
                           _attn_ctypes(9), tmp)

            def other_kv():
                rc = fkv(2, *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, s, d,
                         scale, stream)
                if rc != 0:
                    raise RuntimeError(f"other kernel: CUDA error {rc}")
                return dk, dv

            def other_q():
                rc = fq(2, *ptrs, dq.data_ptr(), b, h, s, d, scale, stream)
                if rc != 0:
                    raise RuntimeError(f"other kernel: CUDA error {rc}")
                return (dq,)

            _turns(torch, f"flash_attention_bwd_dkv bf16 {what}, other = "
                   f"{src}", other_kv,
                   lambda: fa.flash_attention_bwd_dkv(*args), bound_kv,
                   _bwd_check(torch, fa, args, plain_kv))
            _turns(torch, f"flash_attention_bwd_dq bf16 {what}, other = "
                   f"{src}", other_q,
                   lambda: (fa.flash_attention_bwd_dq(*args),), bound_q,
                   _bwd_check(torch, fa, args, plain_q))


def sass_loops(name: str, only: str = "") -> None:
    """The inner loops of ``csrc/<name>.cu``'s kernels as compiled (those
    whose name holds ``only``): for each kernel, each loop (a backward
    branch) that holds a tensor-core product or a shared-memory load, its
    instruction count and the counts of its most frequent opcodes
    (``cuobjdump -sass`` of the built library)."""
    import re
    from collections import Counter
    from rag_foundation_tpu_torch.ops import cuda_lib
    cuda_lib.load(name)
    tool = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass",
                          str(cuda_lib.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    for body in out.split("Function : ")[1:]:
        head = body.split("\n", 1)[0]
        named = re.search(r"((?:pq|ivf)_scan_\w+?|flash_(?:bwd|fwd)_\w+?|"
                          r"segment_topk_\w+?)(I\w*?E)?EvP", head)
        fn = "".join(named.groups("")) if named else head.strip()
        seen = set()
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        for i, (a, text) in enumerate(ins):
            br = re.search(r"BRA[^0-9]*0x([0-9a-f]+)", text)
            if not br or int(br.group(1), 16) not in at \
                    or int(br.group(1), 16) >= a:
                continue
            loop = [t for _, t in ins[at[int(br.group(1), 16)]:i + 1]]
            ops = Counter((t.split()[1] if t.startswith("@") else
                           t.split()[0]).split(".")[0] for t in loop)
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(7))
            if (ops["IMMA"] or ops["HMMA"] or ops["LDS"] or ops["LDSM"]) \
                    and len(loop) < 4000 and only in fn \
                    and top not in seen:
                seen.add(top)
                print(f"{name} {fn}: loop of {len(loop)} instructions: "
                      f"{top}", flush=True)


SECTIONS = ("pq", "pq_tier", "flat", "exact", "attention", "attention_bwd")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--live-rows", type=int, default=2441,
                    help="live rows a list (10M rows over 4096 lists)")
    ap.add_argument("--other-flat", nargs="+", default=[],
                    help="other ivf_list_scan.cu sources to time in turns")
    ap.add_argument("--other-pq", nargs="+", default=[],
                    help="other pq_list_scan.cu sources to time in turns")
    ap.add_argument("--other-exact", nargs="+", default=[],
                    help="directories, each with another block_topk.cu, "
                         "fused_topk.cu and their headers, to time in turns")
    ap.add_argument("--other-attn", nargs="+", default=[],
                    help="other flash_attention.cu sources to time in turns")
    ap.add_argument("--other-attn-bwd", nargs="+", default=[],
                    help="other flash_attention_bwd.cu sources to time in "
                         "turns")
    ap.add_argument("--lengths", default=None,
                    help="JSON of phase 15's layer-0 lengths by S "
                         "(chip_smoke.py --lengths-out)")
    ap.add_argument("--sass", action="store_true",
                    help="print the list scans', the attention kernels' "
                         "(bf16, D=32) and the exact scan's (bf16) inner "
                         "loops as compiled")
    ap.add_argument("--exact-rows", type=int, default=1_000_000,
                    help="corpus rows of the exact-scan kernels (bf16)")
    ap.add_argument("--only", nargs="+", choices=SECTIONS, default=SECTIONS,
                    help="sections to time (default all)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA card")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(out.stdout.strip().splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.sass:
        sass_loops("pq_list_scan")
        sass_loops("ivf_list_scan")
        sass_loops("flash_attention_bwd", only="bf16ILi32")
        sass_loops("flash_attention", only="bf16ILi32")
        sass_loops("block_topk", only="bf16")
    if "pq" in args.only:
        time_pq(torch, g, args.nlist, args.live_rows, args.other_pq)
    if "pq_tier" in args.only:
        time_pq_tier(torch, g, args.other_pq)
    if "flat" in args.only:
        time_flat(torch, g, args.nlist, args.live_rows, args.other_flat)
    if "exact" in args.only:
        time_exact(torch, g, args.exact_rows, args.other_exact)
    lengths = None
    if args.lengths is not None:
        lengths = json.loads(Path(args.lengths).read_text())
    if "attention" in args.only:
        time_attention(torch, g, args.other_attn, lengths)
    if "attention_bwd" in args.only:
        time_attention_bwd(torch, g, args.other_attn_bwd, lengths)
    if FAILED:
        raise SystemExit("outputs outside the tolerance: " + "; ".join(FAILED))


if __name__ == "__main__":
    main()
