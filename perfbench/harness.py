"""One run of one cell, driven by the data in ``BENCHMARK.json``.

A configuration whose ``kind`` is ``"generate"`` is run by
``generate.run``; one without ``kind`` is a search cell, run here.

Set-up makes the corpus on the card (from the configuration's corpus
seed: every run builds the same index) and the query pool (from the
run's seed), builds the index through ``systems/<mode>.py`` and warms
the cell's batch shape on the program's own entry. The window then drives
``StoreIndex.search_many`` with one closed-loop stream of the traffic's
batches, each dispatched one batch ahead of the previous batch's
finalize (the entry's own pipelining), until ``--seconds`` have passed;
the window closes when the entry has finalized every batch it took, and
``qps`` counts all of them over all of that time. A batch's latency runs
from the moment the entry takes it from the stream (its dispatch) to
its finalize, which ends right before the entry takes the batch two
later. After the window the program's state
is copied where the reference follows it and freed, and the reference
judges what the window served (``compare.py``).

``--trace 1`` traces the last ``TRACE_S`` seconds of the window with
``torch.profiler`` (where the profiler recorded no device operation,
``TRACE_S`` seconds more of the same traffic after the window) and
reports the per-layer metrics, read by ``metrics/<name>.py``; the host
stages' times and the served rates (``ctx.window``) come from the
untraced part before. The result line is printed only if no module of JAX or
the JAX package is loaded by then.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import compare, reference
from perfbench.corpus import Docwalk, mix
from perfbench.traffic import Traffic

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_foundation_tpu")
WARM_BATCHES = 4
TRACE_S = 2.0
# traced parts a run may take: the profiler now and then records the
# host's ranges and no device operation (seen on an H100), and then the
# same traffic is traced again after the window
TRACE_TRIES = 3
# stream length bound: no batch rate of this program comes near it
MAX_BATCHES_S = 20_000


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the CPU rehearsal tests only: run on the CPU with the kernels'
    # plain versions instead of refusing to run without a card
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> SimpleNamespace:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    per_layer = [m["name"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in e2e]
    return SimpleNamespace(
        name=name, chips=cell["chips"], data=root / PKG.name,
        cfg=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (root / PKG.name / "traffic" / f"{cell['traffic']}.json"
             ).read_text()),
        end_to_end=[m for m in bench["end_to_end"] if m["name"] in e2e],
        per_layer=per_layer)


class Stream:
    """The window's batches for ``search_many``, handed over as the entry
    asks, until the deadline. ``asks[i]``: when the entry asked for batch
    ``i``, having finished the finalize of batch ``i - 2``; ``handed[i]``:
    when it got it."""

    def __init__(self, traffic: Traffic, deadline: float, cap: int,
                 on_ask=None, first: int = 0):
        self.traffic, self.deadline, self.cap = traffic, deadline, cap
        self.on_ask = on_ask
        self.first = first
        self.asks: list[float] = []
        self.handed: list[float] = []

    def __len__(self) -> int:
        return self.cap

    def __iter__(self):
        for i in range(self.cap):
            now = time.perf_counter()
            self.asks.append(now)
            if now >= self.deadline:
                return
            if self.on_ask is not None:
                self.on_ask(now, i)
            self.handed.append(time.perf_counter())
            yield self.traffic.queries(self.first + i)


def synchronize(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(args, root: Path, t_start: float) -> dict:
    """One run; returns the result line's object, ``checks`` last."""
    cell = load_cell(root, args.workload)
    if cell.cfg.get("kind", "search") == "generate":
        from perfbench import generate
        return generate.run(args, cell, t_start)
    cfg, k = cell.cfg, cell.cfg["k"]
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    reference.no_tf32()
    marks = [("imports", time.perf_counter())]
    corpus = Docwalk.from_config(cfg, dev)
    system = load_module(cell.data / "systems" / f"{cfg['mode']}.py")
    built = system.build(cfg, corpus, dev)
    marks.append(("corpus and build", time.perf_counter()))
    traffic = Traffic(cell.traffic, corpus, args.seed)
    marks.append(("query pool", time.perf_counter()))
    store = built.store
    store.search_many([traffic.queries(i) for i in range(WARM_BATCHES)], k)
    synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    print(f"{cell.name} seed {args.seed}: {built.describe()}; set-up "
          + ", ".join(f"{name} {t - t_prev:.3f} s" for (name, t), (_, t_prev)
                      in zip(marks, [("", t_start)] + marks)),
          file=sys.stderr)
    from rag_foundation_tpu_torch.engine.profile import search_profile
    setup_s = time.perf_counter() - t_start

    # -- the window --------------------------------------------------------
    tracer = None
    traced = {"from": None, "profile": {}, "batches": []}
    q_n = traffic.batch
    if args.trace:
        from perfbench.trace import Tracer, spans_on
        tracer = Tracer(dev.type == "cuda")
    cap = int(args.seconds * MAX_BATCHES_S) + 16

    def on_ask(now, i):
        """A traced run traces the window's last ``TRACE_S`` seconds; the
        host stages are read from the part before."""
        if tracer is not None and traced["from"] is None \
                and now >= deadline - min(TRACE_S, args.seconds / 2):
            traced["from"] = i
            traced["profile"] = {
                name: (search_profile.seconds[name],
                       search_profile.calls[name])
                for name in search_profile.seconds}
            traced["spans"] = spans_on(search_profile)
            traced["spans"].__enter__()
            tracer.start()

    search_profile.reset()
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    stream = Stream(traffic, deadline, cap, on_ask)
    results = store.search_many(stream, k)
    t_end = time.perf_counter()
    synchronize(dev)
    n_sent = len(stream.handed)
    if n_sent == 0:
        raise SystemExit("the window dispatched no batch")
    if traced["from"] is not None:
        tracer.stop()
        traced["spans"].__exit__(None, None, None)
        traced["batches"] = list(range(traced["from"], n_sent))
    after = n_sent
    for _ in range(TRACE_TRIES - 1):
        if tracer is None or tracer.busy_s > 0 or dev.type != "cuda":
            break
        print("traced: the profiler recorded no device operation; "
              "tracing the same traffic again", file=sys.stderr)
        more = Stream(traffic, time.perf_counter() + TRACE_S, cap,
                      first=after)
        with spans_on(search_profile):
            tracer.start()
            store.search_many(more, k)
            synchronize(dev)
            tracer.stop()
        traced["batches"] = list(range(after, after + len(more.handed)))
        after += len(more.handed)
    # batch j's finalize ends before the entry asks for batch j + 2 (the
    # stream's next call); the last batch's ends when search_many returns
    done = [stream.asks[j + 2] if j + 2 < len(stream.asks) else t_end
            for j in range(n_sent)]
    # the window closes when search_many returns: nothing was handed over
    # past the deadline and every batch handed over was finalized, so all
    # of them count, over all of that time. A traced run reads the same
    # quantities over the part before the profiler started.
    close = t_end if traced["from"] is None else stream.asks[traced["from"]]
    window = served_rates(stream.handed, done, t0, close, q_n)
    window["build_vec_s"] = cfg["rows"] / built.build_s
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    # -- what the reference follows, then the program freed ---------------
    rng = np.random.default_rng(mix(args.seed, 5))
    n_check = min(n_sent, max(1, -(-cfg["check_queries"] // q_n)))
    checked = sorted(rng.choice(n_sent, size=n_check, replace=False))
    sample = torch.as_tensor(
        np.random.default_rng(mix(args.seed, 6)).choice(
            cfg["rows"], size=min(cfg["rows"], cfg["check_rows"]),
            replace=False), device=dev)
    state = built.state(sample)
    ctx = None
    if tracer is not None:
        ctx = SimpleNamespace(
            cfg=cfg, batch=q_n, profile=traced["profile"], tracer=tracer,
            batches=[traffic.batch_ids(i) for i in traced["batches"]],
            window=window, pool=traffic.pool, centroids=state["centroids"],
            live=(state["list_rows"] >= 0).sum(dim=1), device=dev)
    spill = built.spill
    del built, store, system
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference.Reference(cfg, corpus)
    ref.scan(traffic.pool)
    misses = total = failed = 0
    for j in range(n_sent):
        vals, ids = results[j]
        failed += int((~compare.valid_slots(ids, vals, cfg["rows"])
                       ).any(axis=1).sum())
    for j in range(n_sent):
        m, t = compare.recall_miss(ref.truth[traffic.batch_ids(j)],
                                   results[j][1])
        misses, total = misses + m, total + t
    numbers = judge_served(ref, cfg, traffic, results, checked, state)
    numbers["recall_miss"] = misses / max(1, total)
    numbers.update(compare.build_checks(ref, state, sample, spill))
    correct, checks = compare.judge(numbers, cfg["limits"])
    print(f"reference and comparison {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)

    out = {"correct": correct,
           "attempted": n_sent * q_n,
           "failed": failed,
           "metrics": {},
           "device": device_info(dev, memory_peak)}
    if tracer is None:
        values = dict(window, recall_at_10=1.0 - numbers["recall_miss"],
                      setup_s=setup_s)
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        out["device"]["busy_s"] = tracer.busy_s
        out["device"]["window_s"] = tracer.window_s
        for name in cell.per_layer:
            reader = load_module(cell.data / "metrics" / f"{name}.py")
            v = reader.read(ctx)
            if v is not None:
                out["metrics"][name] = {"value": v, "unit": reader.UNIT}
        out["breakdown"] = tracer.breakdown
        for name, (sec, count) in sorted(tracer.kernels.items(),
                                         key=lambda kv: -kv[1][0])[:6]:
            print(f"traced: {count} x {sec / count * 1e3:.4f} ms "
                  f"{name[:100]}", file=sys.stderr)
        print(f"traced: {len(traced['batches'])} batches in "
              f"{tracer.window_s:.3f} s, busy {tracer.busy_s:.3f} s; the "
              f"profiler started in {tracer.start_s:.3f} s",
              file=sys.stderr)
    out["checks"] = {name: {key: _finite(v) for key, v in c.items()}
                     for name, c in checks.items()}
    return out


def served_rates(handed: list[float], done: list[float], t0: float,
                 close: float, q_n: int) -> dict[str, float]:
    """``qps``: the queries of the batches finalized by ``close``, over
    ``close - t0``; ``batch_p95_ms``: the 95th percentile of those
    batches' latencies, each from its hand-over to its finalize."""
    js = [j for j in range(len(done)) if done[j] <= close]
    if not js:
        raise SystemExit("no batch came back inside the window")
    return {"qps": len(js) * q_n / (close - t0),
            "batch_p95_ms": float(np.percentile(
                [(done[j] - handed[j]) * 1e3 for j in js], 95))}


def _finite(v):
    """A number for the JSON line: a gap that is not finite reads as the
    string "inf" (JSON has no infinity)."""
    return v if v is None or math.isfinite(v) else "inf"


def judge_served(ref, cfg: dict, traffic: Traffic, results, checked,
                 state: dict) -> dict[str, float]:
    """``compare.served_checks`` over the batches ``checked``: their
    served rows, their queries quantized as the configuration states,
    and each batch routed and dispatched by the reference."""
    dev = ref.corpus.device
    nlist = state["centroids"].shape[0]
    qcap = reference.default_qcap(traffic.batch, cfg["nprobe"], nlist)
    parts = {"ids": [], "vals": [], "q8": [], "q32": [], "scale": [],
             "probes": [], "kept": []}
    for j in checked:
        vals, ids = results[j]
        q = traffic.queries(j)
        q8, s_q = reference.quantize_queries(q, cfg)
        probes = reference.route(torch.as_tensor(q, device=dev),
                                 state["centroids"], cfg["nprobe"])
        parts["ids"].append(ids)
        parts["vals"].append(vals)
        parts["q8"].append(q8)
        parts["q32"].append(q8.astype(np.float32) * np.float32(s_q))
        parts["scale"].append(np.full(
            len(q), reference.score_scale(s_q, cfg["scale"]), np.float32))
        parts["probes"].append(probes)
        parts["kept"].append(reference.kept_probes(probes, qcap))
    cat = {name: np.concatenate(v) for name, v in parts.items()
           if name not in ("probes", "kept")}
    return compare.served_checks(
        ref, cat["ids"], cat["vals"], cat["q8"], cat["scale"],
        torch.cat(parts["probes"]), torch.cat(parts["kept"]), state,
        cat["q32"])


def device_info(dev, memory_peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(memory_peak)}
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        info["power_limit"] = got.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def main(argv=None, t_start: float | None = None,
         root: Path | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = PKG.parent if root is None else root
    if args.device == "cuda":
        chips = load_cell(root, args.workload).chips
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"the cell needs {chips} CUDA card(s); this machine has "
                  f"{have}", file=sys.stderr)
            return 2
    out = run(args, root, t_start)
    found = forbidden_modules()
    if found:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
