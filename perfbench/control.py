"""Readings that the limits of ``compare.py`` are set from.

    python3 -m perfbench.control --workload <cell> --program-seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 2

For each program seed: one run of the cell as the benchmark makes it
(``--seconds`` long), its numbers. For each control seed: the cell's
index built as a run builds it, then the control put in the program's
place: ``reference.int4_topk``, the exact scan at int4, answers the
batches a run would check, and the same comparison reads it. In a
generation cell the control seed's run serves its window as a run does,
and the comparison reads the control's outputs in the program's place:
the reference with its weights rounded to fp8 e4m3
(``reference_decoder.round_fp8``), its logits at the prompt's last
position and, at each position of the same prompts and served tokens,
the token it puts first. One JSON line a seed on standard output. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import compare, harness, reference
from perfbench.corpus import Docwalk, mix
from perfbench.traffic import Traffic


def control_numbers(args, root: Path, seed: int) -> dict:
    cell = harness.load_cell(root, args.workload)
    cfg = cell.cfg
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    reference.no_tf32()
    corpus = Docwalk.from_config(cfg, dev)
    system = harness.load_module(cell.data / "systems" / f"{cfg['mode']}.py")
    built = system.build(cfg, corpus, dev)
    traffic = Traffic(cell.traffic, corpus, seed)
    sample = torch.as_tensor(
        np.random.default_rng(mix(seed, 6)).choice(
            cfg["rows"], size=min(cfg["rows"], cfg["check_rows"]),
            replace=False), device=dev)
    state = built.state(sample)
    spill = built.spill
    del built, system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.Reference(cfg, corpus)
    ref.scan(traffic.pool)
    checked = list(range(-(-cfg["check_queries"] // traffic.batch)))
    vals, ids = reference.int4_topk(
        corpus, np.concatenate([traffic.queries(j) for j in checked]),
        cfg["k"])
    q_n = traffic.batch
    results = {j: (vals[i * q_n:(i + 1) * q_n].astype(np.float32),
                   ids[i * q_n:(i + 1) * q_n])
               for i, j in enumerate(checked)}
    numbers = harness.judge_served(ref, cfg, traffic, results, checked,
                                   state)
    misses, total = compare.recall_miss(
        ref.truth[np.concatenate([traffic.batch_ids(j) for j in checked])],
        ids)
    numbers["recall_miss"] = misses / total
    numbers.update(compare.build_checks(ref, state, sample, spill))
    return numbers


def generation_control(args, root: Path, seed: int) -> dict:
    from perfbench import generate
    run_args = harness.parse(
        ["--workload", args.workload, "--seed", str(seed), "--seconds",
         str(args.seconds), "--device", args.device])
    out = generate.run(run_args, harness.load_cell(root, args.workload),
                       time.perf_counter(), control=True)
    return {name: float(c["value"]) for name, c in out["checks"].items()}


def main(argv=None, root: Path | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = harness.PKG.parent if root is None else root
    for seed in [int(s) for s in args.program_seeds.split(",") if s]:
        t0 = time.perf_counter()
        run_args = harness.parse(
            ["--workload", args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--device", args.device])
        out = harness.run(run_args, root, t0)
        print(json.dumps({"seed": seed, "side": "program",
                          "correct": out["correct"],
                          "numbers": out["checks"]}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    generate = harness.load_cell(root, args.workload).cfg.get(
        "kind") == "generate"
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        if generate:
            numbers = generation_control(args, root, seed)
        else:
            numbers = control_numbers(args, root, seed)
        print(json.dumps({"seed": seed, "side": "control",
                          "numbers": {n: harness._finite(v)
                                      for n, v in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
