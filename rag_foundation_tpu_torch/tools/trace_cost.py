"""Host cost of ``engine/profile.py``'s tracing a search batch, in isolation.

    python -m rag_foundation_tpu_torch.tools.trace_cost [--reps 20000]
    python -m rag_foundation_tpu_torch.tools.trace_cost --device cpu

Replays, with no search work inside, the tracing that one batch of
``StoreIndex``'s batched path goes through: its six old host stages
(``q_upload``, ``body_dispatch``, ``tail_dispatch``, ``tail_fetch``,
``rows_fetch``, ``idmap_merge``), and what this tracing adds to them:
the batch (numbered, entered at dispatch and at finalize), the new
stages (``q_quantize``, ``q_copy``, ``route``, ``scan``, ``regather``,
``own_wait``), five CUDA events and their resolution (``close_batch``),
the probe count with its device-side add, and the int8 scan's row count
(its index's rows a list looked up, its live slots held and summed on
the device, as ``ivf_search`` counts a 4,096-list body). It times ``--reps``
batches, each dispatched before the previous one's finalize (as
``search_many`` runs them), three ways, and prints one JSON line of
microseconds a batch:

- ``old_us``: the old stages alone, outside any batch;
- ``always_on_us``: the whole replay less ``old_us``, with no profiler:
  what every batch pays;
- ``profiled_us``: the whole replay under a recording ``torch.profiler``
  (``--reps`` / 10 batches), less ``old_us``: the ranges' cost too.

On a CUDA device the events are real and the stream is empty, so a wait
costs its call alone. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from rag_foundation_tpu_torch.engine.ivf import cached_scan_rows
from rag_foundation_tpu_torch.engine.profile import StageProfile
from rag_foundation_tpu_torch.ops.ivf_scan import S8_SLOTS

OLD = ("q_upload", "body_dispatch", "tail_dispatch", "tail_fetch",
       "rows_fetch", "idmap_merge")


def old_dispatch(p: StageProfile, dev, counted) -> None:
    for name in OLD[:3]:
        with p.stage(name):
            pass


def old_finalize(p: StageProfile, batch) -> None:
    for name in OLD[3:]:
        with p.stage(name):
            pass


def traced_dispatch(p: StageProfile, dev, counted):
    """A batch's dispatch, traced as ``StoreIndex`` nests it."""
    dropped, live_n, row_ids = counted
    stage = p.stage
    with p.open_batch(dev) as batch:
        with stage("q_upload"):
            with stage("q_quantize"):
                pass
            with stage("q_copy"):
                pass
        with stage("body_dispatch"):
            with stage("route"):
                p.count_probes(1024 * 32, dropped)
            with stage("scan"):
                p.count_scan_rows(live_n, cached_scan_rows(row_ids),
                                  S8_SLOTS)
            with stage("regather"):
                pass
        with stage("tail_dispatch"):
            pass
    return batch


def traced_finalize(p: StageProfile, batch) -> None:
    stage = p.stage
    with batch:
        with stage("tail_fetch"):
            pass
        with stage("rows_fetch"):
            if batch.marks:
                with stage("own_wait"):
                    batch.marks[-1][1].synchronize()
        p.close_batch(batch)
        with stage("idmap_merge"):
            pass


def per_batch_us(dispatch, finalize, dev, reps: int) -> float:
    """Microseconds a batch over ``reps`` batches, each dispatched before
    the previous one's finalize, as ``StoreIndex.search_many`` runs them."""
    p = StageProfile()
    counted = (torch.zeros((), dtype=torch.int32, device=dev),
               torch.ones(4096, dtype=torch.int32, device=dev),
               torch.zeros((4096, 128), dtype=torch.int32, device=dev))
    prev = dispatch(p, dev, counted)

    def one() -> None:
        nonlocal prev
        batch = dispatch(p, dev, counted)
        finalize(p, prev)
        prev = batch

    for _ in range(min(reps, 100)):
        one()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    dt = time.perf_counter() - t0
    finalize(p, prev)
    p.counts()
    return dt / reps * 1e6


def card_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"], capture_output=True, text=True)
    return f"{torch.cuda.get_device_name(dev)}, {limit.stdout.strip()}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(card_name(dev))
    old = per_batch_us(old_dispatch, old_finalize, dev, args.reps)
    traced = per_batch_us(traced_dispatch, traced_finalize, dev, args.reps)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts):
        profiled = per_batch_us(traced_dispatch, traced_finalize, dev,
                                max(1, args.reps // 10))
    out = {"device": card_name(dev), "reps": args.reps,
           "old_us": old, "always_on_us": traced - old,
           "profiled_us": profiled - old}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
