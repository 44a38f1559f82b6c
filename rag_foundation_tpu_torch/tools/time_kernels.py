"""Time the kernels on synthetic data of the shapes their paths give them.

    python -m rag_foundation_tpu_torch.tools.time_kernels
    python -m rag_foundation_tpu_torch.tools.time_kernels --only pq flat \\
        --other-pq path/to/another/pq_list_scan.cu \\
        --other-flat path/to/another/ivf_list_scan.cu

Needs a CUDA card and ``nvcc``. Inputs: 4096 lists whose 2,441 live rows
are interleaved over the sub-blocks as the index lays them out, a
dispatch whose live slots per list are Poisson(8) (a Q=1024, nprobe=32
batch of uniform traffic), int8 values from a seeded generator. It prints
the card's name and power limit, then one line a variant: the ADC scan
(``pq_list_scan``: qcap 16 and 8, with the dispatch and with every slot
live, p 8 and 1, bf16 LUT, packed codes) and the flat scan
(``ivf_list_scan``, p 3), each time beside its bound (the formulas of
``chip_smoke.py``'s ``pq_scan_bound`` and ``scan_bound``). With
``--other-pq`` or ``--other-flat`` it also builds that source (another
version of the kernel with the same C entry point; headers are taken
from its own directory), checks that the two give bit-identical outputs
on the main path's shape (int8, qcap 16, a Poisson(8) dispatch; p 8 for
the ADC scan, 3 for the flat one) and times them in turns (other, this,
this, other; five rounds of two pairs each, and the number of pairs
this version won), so that two versions are compared within one run on
one card.
Last come the exact-scan kernels on ``--exact-rows`` x 768 normal rows and
1024 queries: ``block_topk`` (p 2 and 10, its kernel alone
and with the stage-2 merge), ``fused_topk`` (the default split of the rows
and a few others, k 10 and 64), in bf16, and both in f32 on an eighth of
the rows. Then the encoder's attention (``flash_attention``, H=12, D=32,
bf16) at the batch and sequence buckets MiniLM encodes at (B 1, 64, 256;
S 16, 128, 512), every token real and with chunks of half the bucket
(pads past them), beside ``scaled_dot_product_attention`` with the same
boolean mask. Then the attention backward (``attention_bwd``:
``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``, bf16, H=12,
D=32) at the trainer's batch and buckets (B 256 and 1; S 32, 128, 512),
all real and half real, each beside the backward of
``scaled_dot_product_attention`` with the same boolean mask (the gradient
of k and v, or of q). ``--only`` picks sections.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path


def _ms(fn, reps: int = 10) -> float:
    import torch
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


# the published H100 SXM peaks of chip_smoke.py
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
SMEM_BYTES_S = 132 * 128 * 1.98e9


def _live_counts(ids, live_n):
    live_rows = (ids >= 0).sum(dim=1).double()
    read = live_n > 0
    return live_rows, read, int(read.sum()) * ids.shape[1]


def pq_bound_ms(ids, live_n, qcap, p, m, m_bytes, lut_esize) -> str:
    """``chip_smoke.pq_scan_bound``: the live rows' codes, the ids of the
    lists read, the live slots' LUTs and the outputs over the HBM rate, or
    one shared-memory read a lookup, whichever is longer."""
    live_rows, read, ids_read = _live_counts(ids, live_n)
    out_elems = ids.shape[0] * qcap * (ids.shape[1] // 128) * p
    nbytes = float(live_rows[read].sum()) * m_bytes + ids_read * 4 \
        + int(live_n.sum()) * 16 * m * lut_esize + ids.shape[0] * 4 \
        + out_elems * 8
    lookups = m * float((live_n.double() * live_rows).sum())
    t_b, t_o = nbytes / HBM_BYTES_S, lookups * lut_esize / SMEM_BYTES_S
    by = "bytes" if t_b >= t_o else "lookups"
    return f"{max(t_b, t_o) * 1e3:.3f} ms ({by})"


def flat_bound_ms(ids, live_n, qcap, p, d) -> str:
    """``chip_smoke.scan_bound`` for int8: the live query rows, the live
    rows of the lists read, their ids and the outputs over the HBM rate,
    or the int8 products at the peak rate, whichever is longer."""
    live_rows, read, ids_read = _live_counts(ids, live_n)
    out_elems = ids.shape[0] * qcap * (ids.shape[1] // 128) * p
    nbytes = (int(live_n.sum()) + float(live_rows[read].sum())) * d \
        + ids_read * 4 + ids.shape[0] * 4 + out_elems * 8
    ops = 2.0 * d * float((live_n.double() * live_rows).sum())
    t_b, t_o = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    by = "bytes" if t_b >= t_o else "operations"
    return f"{max(t_b, t_o) * 1e3:.3f} ms ({by})"


def _other_fn(src: str, entry: str, argtypes, tmp: str):
    """The C entry point of another version of a kernel source."""
    from rag_foundation_tpu_torch.ops import cuda_lib
    lib_path = str(Path(tmp) / f"lib{entry}.so")
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS[:-2],
                    "-o", lib_path, src], check=True)
    fn = getattr(ctypes.CDLL(lib_path), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _turns(torch, name, other, this, bound) -> None:
    """Bit-identity, then other/this/this/other five times: ten pairs,
    (other, this) and (this, other) in each round."""
    ov, oi = other()
    tv, ti = this()
    torch.cuda.synchronize()
    same = torch.equal(ov, tv) and torch.equal(oi, ti)
    print(f"{name}: outputs {'bit-identical' if same else 'DIFFER'}; bound "
          f"{bound}", flush=True)
    won = 0
    for _ in range(5):
        t = [_ms(other), _ms(this), _ms(this), _ms(other)]
        won += (t[1] < t[0]) + (t[2] < t[3])
        print(f"  other {t[0]:.3f} this {t[1]:.3f} this {t[2]:.3f} other "
              f"{t[3]:.3f} ms", flush=True)
    print(f"  this faster in {won} of 10 pairs", flush=True)


def time_pq(torch, g, nlist: int, live_rows: int,
            other_src: str | None) -> None:
    from rag_foundation_tpu_torch.ops import pq_scan
    cap_len, m = 3712, 192
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    ids = _lists(torch, g, nlist, cap_len, live_rows)
    for qcap in (16, 8):
        lut = torch.randint(-127, 128, (nlist, qcap, 16 * m), generator=g,
                            device="cuda", dtype=torch.int8)
        disp, live = _dispatch(torch, g, nlist, qcap)
        if other_src is not None and qcap == 16:
            _pq_turns(torch, other_src, lut, codes, ids, disp, live, m)
        every = torch.full((nlist,), qcap, dtype=torch.int32, device="cuda")
        for name, d, slots in (("Poisson(8) dispatch", disp, live),
                               ("every slot live", None, nlist * qcap)):
            live_n = every if d is None else pq_scan.live_slots(d)
            for p in (8, 1):
                t = _ms(lambda: pq_scan.pq_list_scan(lut, codes, ids, d,
                                                     p=p))
                print(f"pq_list_scan int8 LUT qcap={qcap} {name} "
                      f"({slots} live slots) p={p}: {t:.3f} ms, bound "
                      f"{pq_bound_ms(ids, live_n, qcap, p, m, m, 1)}",
                      flush=True)
        lutb = torch.randn((nlist, qcap, 16 * m), generator=g,
                           device="cuda").bfloat16()
        t = _ms(lambda: pq_scan.pq_list_scan(lutb, codes, ids, None, p=8))
        print(f"pq_list_scan bf16 LUT qcap={qcap} every slot live p=8: "
              f"{t:.3f} ms, bound "
              f"{pq_bound_ms(ids, every, qcap, 8, m, m, 2)}", flush=True)
    packed = pq_scan.pack_codes(codes).contiguous()
    t = _ms(lambda: pq_scan.pq_list_scan(lut, packed, ids, None, p=8))
    print(f"pq_list_scan int8 LUT qcap=8 packed codes every slot live p=8: "
          f"{t:.3f} ms", flush=True)


def _pq_turns(torch, other_src, lut, codes, ids, disp, live, m) -> None:
    from rag_foundation_tpu_torch.ops import pq_scan
    nlist, qcap, _ = lut.shape
    cap_len, p = ids.shape[1], 8
    live_n = pq_scan.live_slots(disp)
    w = (cap_len // 128) * p
    ov = torch.empty((nlist, qcap, w), dtype=torch.float32, device="cuda")
    oi = torch.empty((nlist, qcap, w), dtype=torch.int32, device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        fn = _other_fn(other_src, "pq_list_scan_launch",
                       [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                        ci, vp], tmp)

        def other():
            rc = fn(0, 0, lut.data_ptr(), codes.data_ptr(), ids.data_ptr(),
                    live_n.data_ptr(), ov.data_ptr(), oi.data_ptr(), nlist,
                    qcap, cap_len, m, m, p,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"other kernel: CUDA error {rc}")
            return ov, oi

        _turns(torch, f"pq_list_scan int8 LUT qcap={qcap} Poisson(8) "
               f"dispatch ({live} live slots) p={p}, other = {other_src}",
               other, lambda: pq_scan.pq_list_scan(lut, codes, ids, disp,
                                                   p=p),
               pq_bound_ms(ids, live_n, qcap, p, m, m, 1))


def time_flat(torch, g, nlist: int, live_rows: int,
              other_src: str | None) -> None:
    from rag_foundation_tpu_torch.ops import ivf_scan
    qcap, cap_len, d, p = 16, 2816, 768, 3
    lists = torch.randint(-127, 128, (nlist, cap_len, d), generator=g,
                          device="cuda", dtype=torch.int8)
    q = torch.randint(-127, 128, (nlist, qcap, d), generator=g,
                      device="cuda", dtype=torch.int8)
    ids = _lists(torch, g, nlist, cap_len, live_rows)
    disp, live = _dispatch(torch, g, nlist, qcap)
    live_n = ivf_scan.live_slots(disp)
    bound = flat_bound_ms(ids, live_n, qcap, p, d)
    name = (f"ivf_list_scan int8 qcap={qcap} Poisson(8) dispatch ({live} "
            f"live slots) p={p}")

    def this():
        return ivf_scan.ivf_list_scan(q, lists, ids, disp, p=p, scale=1e-4)

    if other_src is None:
        print(f"{name}: {_ms(this):.3f} ms, bound {bound}", flush=True)
        return
    w = (cap_len // 128) * p
    ov = torch.empty((nlist, qcap, w), dtype=torch.float32, device="cuda")
    oi = torch.empty((nlist, qcap, w), dtype=torch.int32, device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        fn = _other_fn(other_src, "ivf_list_scan_launch",
                       [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                        ctypes.c_float, vp], tmp)

        def other():
            rc = fn(0, q.data_ptr(), lists.data_ptr(), ids.data_ptr(),
                    live_n.data_ptr(), ov.data_ptr(), oi.data_ptr(), nlist,
                    qcap, cap_len, d, p, 1e-4,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"other kernel: CUDA error {rc}")
            return ov, oi

        _turns(torch, f"{name}, other = {other_src}", other, this, bound)


def time_exact(torch, g, rows: int) -> None:
    from rag_foundation_tpu_torch.ops import block_topk as bt
    from rag_foundation_tpu_torch.ops import fused_topk as ft
    d, q_n = 768, 1024
    for dtype, n in ((torch.bfloat16, rows), (torch.float32, rows // 8)):
        c = torch.empty((n, d), dtype=dtype, device="cuda")
        for lo in range(0, n, 131_072):
            c[lo:lo + 131_072] = torch.randn((min(131_072, n - lo), d),
                                             generator=g, device="cuda")
        q = torch.randn((q_n, d), generator=g, device="cuda").to(dtype)
        name = f"{str(dtype).split('.')[1]} N={n} d={d} Q={q_n}"
        for p in (2, 10):
            t1 = _ms(lambda: bt.block_candidates(q, c, p, n, 1024), reps=5)
            t2 = _ms(lambda: bt.block_topk(q, c, 10, p=p), reps=5)
            print(f"block_topk {name} k=10 p={p} block_n=1024: kernel "
                  f"{t1:.3f} ms, with the stage-2 merge {t2:.3f} ms",
                  flush=True)
        auto = ft.default_splits(q_n, n, c.device)
        for k, splits in ((10, None), (10, 16), (10, 64), (10, 512),
                          (64, None)):
            t = _ms(lambda: ft.fused_topk(q, c, k, n_splits=splits), reps=5)
            print(f"fused_topk {name} k={k} n_splits="
                  f"{auto if splits is None else splits}"
                  f"{' (default)' if splits is None else ''}: {t:.3f} ms",
                  flush=True)
        del c, q


def time_attention(torch, g) -> None:
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    h, d = 12, 32
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


def time_attention_bwd(torch, g) -> None:
    import torch.nn.functional as F
    from rag_foundation_tpu_torch.ops import flash_attention as fa
    h, d = 12, 32
    for b in (256, 1):
        for s in (32, 128, 512):
            q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                       device="cuda").bfloat16()
                           for _ in range(4))
            for name, real in (("all real", s), ("half real", s // 2)):
                seg = (torch.arange(s, device="cuda") < real).int() \
                    .expand(b, s).contiguous()
                mask = (seg[:, :, None] == seg[:, None, :])[:, None]
                out, lse = fa.flash_attention_forward(
                    q, k, v, seg, seg, d ** -0.5, with_lse=True)
                di = (out.float() * do.float()).sum(dim=-1)
                args = (q, k, v, seg, seg, lse, do, di, d ** -0.5)
                t_kv = _ms(lambda: fa.flash_attention_bwd_dkv(*args), reps=20)
                t_q = _ms(lambda: fa.flash_attention_bwd_dq(*args), reps=20)
                ql, kl, vl = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                ref = F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask, scale=d ** -0.5)
                lib_kv = _ms(lambda: torch.autograd.grad(
                    ref, (kl, vl), do, retain_graph=True), reps=20)
                lib_q = _ms(lambda: torch.autograd.grad(
                    ref, (ql,), do, retain_graph=True), reps=20)
                print(f"flash_attention_bwd bf16 B={b} H={h} S={s} D={d} "
                      f"{name}: dkv {t_kv:.4f} ms, dq {t_q:.4f} ms "
                      f"(scaled_dot_product_attention backward: k, v "
                      f"{lib_kv:.4f} ms, q {lib_q:.4f} ms)", flush=True)


def sass_loops(name: str) -> None:
    """The inner loops of ``csrc/<name>.cu``'s kernels as compiled: for
    each kernel, each loop (a backward branch) that holds a tensor-core
    product or a shared-memory load, its instruction count and the counts
    of its most frequent opcodes (``cuobjdump -sass`` of the built
    library)."""
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
        named = re.search(r"((?:pq|ivf)_scan_\w+?)(I\w*?E)?EvP", head)
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
            if (ops["IMMA"] or ops["LDS"]) and len(loop) < 1000 \
                    and top not in seen:
                seen.add(top)
                print(f"{name} {fn}: loop of {len(loop)} instructions: "
                      f"{top}", flush=True)


SECTIONS = ("pq", "flat", "exact", "attention", "attention_bwd")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--live-rows", type=int, default=2441,
                    help="live rows a list (10M rows over 4096 lists)")
    ap.add_argument("--other-flat", default=None,
                    help="another ivf_list_scan.cu to time in turns")
    ap.add_argument("--other-pq", default=None,
                    help="another pq_list_scan.cu to time in turns")
    ap.add_argument("--sass", action="store_true",
                    help="print the list scans' inner loops as compiled")
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
    if "pq" in args.only:
        time_pq(torch, g, args.nlist, args.live_rows, args.other_pq)
    if "flat" in args.only:
        time_flat(torch, g, args.nlist, args.live_rows, args.other_flat)
    if "exact" in args.only:
        time_exact(torch, g, args.exact_rows)
    if "attention" in args.only:
        time_attention(torch, g)
    if "attention_bwd" in args.only:
        time_attention_bwd(torch, g)


if __name__ == "__main__":
    main()
