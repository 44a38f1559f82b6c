"""Time the kernels on synthetic data of the shapes their paths give them.

    python -m rag_foundation_tpu_torch.tools.time_kernels
    python -m rag_foundation_tpu_torch.tools.time_kernels \\
        --other-flat path/to/another/ivf_list_scan.cu

Needs a CUDA card and ``nvcc``. Inputs: 4096 lists whose 2,441 live rows
are interleaved over the sub-blocks as the index lays them out, a
dispatch whose live slots per list are Poisson(8) (a Q=1024, nprobe=32
batch of uniform traffic), int8 values from a seeded generator. It prints
the card's name and power limit, then one line a variant: the ADC scan
(``pq_list_scan``: qcap 16 and 8, with the dispatch and with every slot
live, p 8 and 1, bf16 LUT, packed codes) and the flat scan
(``ivf_list_scan``, p 3). With ``--other-flat`` it also builds that
source (another version of the flat kernel with the same C entry point;
headers are taken from its own directory) and times the two in turns
(other, this, this, other), so that two versions are compared within one
run on one card. Last come the exact-scan kernels on ``--exact-rows`` x 768
normal rows and 1024 queries: ``block_topk`` (p 2 and 10, its kernel alone
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


def time_pq(torch, g, nlist: int, live_rows: int) -> None:
    from rag_foundation_tpu_torch.ops import pq_scan
    cap_len, m = 3712, 192
    codes = torch.randint(0, 16, (nlist, cap_len, m), generator=g,
                          device="cuda", dtype=torch.uint8)
    ids = _lists(torch, g, nlist, cap_len, live_rows)
    for qcap in (16, 8):
        lut = torch.randint(-127, 128, (nlist, qcap, 16 * m), generator=g,
                            device="cuda", dtype=torch.int8)
        disp, live = _dispatch(torch, g, nlist, qcap)
        for name, d, slots in ((f"Poisson(8) dispatch", disp, live),
                               ("every slot live", None, nlist * qcap)):
            for p in (8, 1):
                t = _ms(lambda: pq_scan.pq_list_scan(lut, codes, ids, d,
                                                     p=p))
                print(f"pq_list_scan int8 LUT qcap={qcap} {name} "
                      f"({slots} live slots) p={p}: {t:.3f} ms", flush=True)
        lutb = torch.randn((nlist, qcap, 16 * m), generator=g,
                           device="cuda").bfloat16()
        t = _ms(lambda: pq_scan.pq_list_scan(lutb, codes, ids, None, p=8))
        print(f"pq_list_scan bf16 LUT qcap={qcap} every slot live p=8: "
              f"{t:.3f} ms", flush=True)
    packed = pq_scan.pack_codes(codes).contiguous()
    t = _ms(lambda: pq_scan.pq_list_scan(lut, packed, ids, None, p=8))
    print(f"pq_list_scan int8 LUT qcap=8 packed codes every slot live p=8: "
          f"{t:.3f} ms", flush=True)


def time_flat(torch, g, nlist: int, live_rows: int,
              other_src: str | None) -> None:
    from rag_foundation_tpu_torch.ops import cuda_lib, ivf_scan
    qcap, cap_len, d, p = 16, 2816, 768, 3
    lists = torch.randint(-127, 128, (nlist, cap_len, d), generator=g,
                          device="cuda", dtype=torch.int8)
    q = torch.randint(-127, 128, (nlist, qcap, d), generator=g,
                      device="cuda", dtype=torch.int8)
    ids = _lists(torch, g, nlist, cap_len, live_rows)
    disp, live = _dispatch(torch, g, nlist, qcap)

    def this():
        return ivf_scan.ivf_list_scan(q, lists, ids, disp, p=p, scale=1e-4)

    if other_src is None:
        print(f"ivf_list_scan int8 qcap={qcap} Poisson(8) dispatch ({live} "
              f"live slots) p={p}: {_ms(this):.3f} ms", flush=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = str(Path(tmp) / "libother.so")
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS[:-2], "-o",
                        lib_path, other_src], check=True)
        fn = ctypes.CDLL(lib_path).ivf_list_scan_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.c_float, vp]
        fn.restype = ci
        live_n = ivf_scan.live_slots(disp)
        w = (cap_len // 128) * p
        ov = torch.empty((nlist, qcap, w), dtype=torch.float32,
                         device="cuda")
        oi = torch.empty((nlist, qcap, w), dtype=torch.int32, device="cuda")

        def other():
            rc = fn(0, q.data_ptr(), lists.data_ptr(), ids.data_ptr(),
                    live_n.data_ptr(), ov.data_ptr(), oi.data_ptr(), nlist,
                    qcap, cap_len, d, p, 1e-4,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"other kernel: CUDA error {rc}")

        other()
        tv, ti = this()
        torch.cuda.synchronize()
        same = torch.equal(ov, tv) and torch.equal(oi, ti)
        print(f"ivf_list_scan int8 qcap={qcap} Poisson(8) dispatch ({live} "
              f"live slots) p={p}: outputs "
              f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        for _ in range(3):
            print(f"  other {_ms(other):.3f} this {_ms(this):.3f} this "
                  f"{_ms(this):.3f} other {_ms(other):.3f} ms", flush=True)


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


SECTIONS = ("pq", "flat", "exact", "attention", "attention_bwd")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nlist", type=int, default=4096)
    ap.add_argument("--live-rows", type=int, default=2441,
                    help="live rows a list (10M rows over 4096 lists)")
    ap.add_argument("--other-flat", default=None,
                    help="another ivf_list_scan.cu to time in turns")
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
    if "pq" in args.only:
        time_pq(torch, g, args.nlist, args.live_rows)
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
