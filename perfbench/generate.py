"""One run of a generation cell: a configuration whose ``kind`` is
``"generate"`` (a configuration without ``kind`` is a search cell, run by
``harness.run``).

Set-up loads the model through ``systems/<mode>.py`` (``load(cfg, root,
device)``: an object with ``widths``, ``serve(feed)`` and ``free()``),
checks that the widths it loaded are the configuration's, makes the
prompt pool from the run's seed (``prompts.py``) and serves
``WARM_REQUESTS`` requests through the same entry. The window hands the
adapter requests as it asks for them (``Feed.take``), never more than the
traffic's ``concurrency`` in flight, until ``--seconds`` have passed; it
closes when the adapter has finished every request it took. The adapter
marks each request's tokens as their ids reach the host
(``Request.emit``) and hands back the answer's ids and the logits its
prefill returned (``Feed.finish``).

- ``gen_tok_s``: the answer tokens of every request finished by the
  close, over the time from the window's start to the close;
- ``ttft_p95_ms``: the 95th percentile over those requests of the time
  from the hand-over to the first token's id on the host;
- ``tpot_p95_ms``: the 95th percentile over those requests of (last
  token's time - first token's time) / (tokens - 1).

``correct`` (``compare.served_gaps``): after the window, once the memory
peak is read and the program is freed, the plain float32 reference
(``reference_decoder.py``) runs once over the prompt and the served
tokens of a sample of the finished requests drawn from the seed, with
the one of the most tokens (then the longest prompt) in it: ``logit_gap`` and ``token_deficit``
over that sample, and ``malformed_requests``, the requests handed over
that came back with another number of tokens than their budget, an id
outside the vocabulary, or not at all (these count in ``failed``).

``--trace 1`` traces the window's last ``TRACE_S`` seconds as
``harness.run`` does; the adapter's ``feed.span`` ranges name the idle
gaps, and the served rates (``ctx.window``) come from the untraced part
before.
"""

from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import compare, harness, reference, roofline
from perfbench.corpus import mix
from perfbench.prompts import Prompts, answer_tokens
from perfbench.reference_decoder import WIDTHS, ReferenceDecoder
from perfbench.trace import LABEL

WARM_REQUESTS = 2


class Request:
    """One request: the prompt ``ids``, the ``max_tokens`` it asks for
    and the ``budget`` of tokens its answer gets. ``marks``: (host time,
    tokens on the host by then), one a ``emit``."""

    def __init__(self, ids: np.ndarray, max_tokens: int, budget: int):
        self.ids = ids
        self.max_tokens, self.budget = max_tokens, budget
        self.handed = self.done = None
        self.marks: list[tuple[float, int]] = []
        self.out = self.logits = None

    def emit(self, n: int) -> None:
        """The first ``n`` tokens of the answer are on the host now."""
        self.marks.append((time.perf_counter(), n))


class Feed:
    """The requests of a window, handed over as the adapter asks until the
    deadline (or ``cap`` requests). ``handed``: the requests in the order
    they were handed over."""

    def __init__(self, prompts: Prompts, cfg: dict, deadline: float,
                 cap: float = float("inf"), on_ask=None, first: int = 0):
        self.prompts, self.cfg = prompts, cfg
        self.concurrency = prompts.concurrency
        self.deadline, self.cap = deadline, cap
        self.on_ask, self.first = on_ask, first
        self.handed: list[Request] = []
        self.finished = 0
        self.tracing = False

    def take(self) -> Request | None:
        """The next request, or None once the deadline has passed."""
        if len(self.handed) - self.finished >= self.concurrency:
            raise RuntimeError("the adapter asked for more requests than "
                               "the traffic's concurrency")
        now = time.perf_counter()
        if now >= self.deadline or len(self.handed) >= self.cap:
            return None
        if self.on_ask is not None:
            self.on_ask(now, len(self.handed))
        ids = self.prompts.prompt(self.first + len(self.handed))
        cfg = self.cfg
        req = Request(ids, self.prompts.max_tokens,
                      answer_tokens(len(ids), self.prompts.max_tokens,
                                    cfg["ans_len"], cfg["max_len"],
                                    cfg["gen_block"]))
        req.handed = time.perf_counter()
        self.handed.append(req)
        return req

    def finish(self, req: Request, ids, logits: torch.Tensor) -> None:
        """``req`` is answered: its ids, and the f32 logits ``[vocab]``
        its prefill returned."""
        req.done = time.perf_counter()
        req.out = np.asarray(ids, dtype=np.int64).reshape(-1)
        req.logits = logits
        self.finished += 1

    def span(self, name: str):
        """A ``bench.<name>`` profiler range while the window is traced."""
        if self.tracing:
            return torch.profiler.record_function(LABEL + name)
        return contextlib.nullcontext()


def model_flops(cell):
    """``(prompt_len, new_tokens) -> operations`` of the configuration's
    model: ``roofline.<flops>_flops``, or the ``flops`` function of
    ``flops/<flops>.py`` for a model the yardstick has none for."""
    name = cell.cfg["flops"]
    fn = getattr(roofline, f"{name}_flops", None)
    if fn is None:
        fn = harness.load_module(cell.data / "flops" / f"{name}.py").flops
    return lambda prompt_len, new: fn(cell.cfg, prompt_len, new)


def well_formed(req: Request, vocab: int) -> bool:
    return req.out is not None and len(req.out) == req.budget \
        and bool(((req.out >= 0) & (req.out < vocab)).all())


def served_rates(reqs: list[Request], t0: float, close: float, flops
                 ) -> dict[str, float]:
    """The window's rates over the requests finished by ``close`` (see
    the module docstring), and ``model_flops`` of their prompts and
    answers over ``window_s``."""
    done = [r for r in reqs if r.done is not None and r.done <= close
            and r.marks]
    tpot = [(r.marks[-1][0] - r.marks[0][0]) / (len(r.out) - 1) * 1e3
            for r in done if len(r.out) > 1]
    if not tpot:
        raise SystemExit("no request of two tokens or more finished inside "
                         "the window")
    return {"gen_tok_s": sum(len(r.out) for r in done) / (close - t0),
            "ttft_p95_ms": float(np.percentile(
                [(r.marks[0][0] - r.handed) * 1e3 for r in done], 95)),
            "tpot_p95_ms": float(np.percentile(tpot, 95)),
            "model_flops": float(sum(flops(len(r.ids), len(r.out))
                                     for r in done)),
            "window_s": close - t0}


def run(args, cell, t_start: float, control: bool = False) -> dict:
    """One run of the generation cell ``cell`` (``harness.load_cell``);
    returns the result line's object, ``checks`` last. ``control``: the
    fp8 reference's outputs are judged in the program's place
    (``control.py``)."""
    cfg = cell.cfg
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    reference.no_tf32()
    marks = [("imports", time.perf_counter())]
    system = harness.load_module(cell.data / "systems" / f"{cfg['mode']}.py")
    model = system.load(cfg, cell.data.parent, dev)
    loaded = {w: model.widths[w] for w in WIDTHS}
    if loaded != {w: cfg[w] for w in WIDTHS}:
        raise SystemExit(f"the model loaded {loaded}, not the "
                         f"configuration's widths")
    marks.append(("model", time.perf_counter()))
    prompts = Prompts(cell.traffic, cfg["vocab_size"], args.seed)
    if prompts.longest > cfg["max_len"] - cfg["ans_len"]:
        raise SystemExit("the traffic's prompts pass the model's prefix")
    marks.append(("prompts", time.perf_counter()))
    model.serve(Feed(prompts, cfg, float("inf"), WARM_REQUESTS))
    harness.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    print(f"{cell.name} seed {args.seed}: {cfg['mode']} {loaded}; set-up "
          + ", ".join(f"{name} {t - t_prev:.3f} s" for (name, t), (_, t_prev)
                      in zip(marks, [("", t_start)] + marks)),
          file=sys.stderr)
    setup_s = time.perf_counter() - t_start

    # -- the window --------------------------------------------------------
    tracer = None
    traced = {"at": None}
    if args.trace:
        from perfbench.trace import Tracer
        tracer = Tracer(dev.type == "cuda")

    def on_ask(now, i):
        if tracer is not None and traced["at"] is None \
                and now >= deadline - min(harness.TRACE_S, args.seconds / 2):
            traced["at"] = now
            feed.tracing = True
            tracer.start()

    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    feed = Feed(prompts, cfg, deadline, on_ask=on_ask)
    model.serve(feed)
    t_end = time.perf_counter()
    harness.synchronize(dev)
    if not feed.handed:
        raise SystemExit("the window handed over no request")
    if traced["at"] is not None:
        tracer.stop()
    after = len(feed.handed)
    n_traced = sum(traced["at"] is not None and r.handed >= traced["at"]
                   for r in feed.handed)
    for _ in range(harness.TRACE_TRIES - 1):
        if tracer is None or traced["at"] is not None and (
                tracer.busy_s > 0 or dev.type != "cuda"):
            break
        print("traced: no traced part, or the profiler recorded no device "
              "operation; tracing the same traffic again", file=sys.stderr)
        more = Feed(prompts, cfg, time.perf_counter() + harness.TRACE_S,
                    first=after)
        more.tracing = True
        tracer.start()
        model.serve(more)
        harness.synchronize(dev)
        tracer.stop()
        after += len(more.handed)
        n_traced = len(more.handed)
        traced["at"] = traced["at"] or t_end
    close = t_end if traced["at"] is None else traced["at"]
    window = served_rates(feed.handed, t0, close, model_flops(cell))
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0

    # -- the sample the reference follows, then the program freed ----------
    vocab = cfg["vocab_size"]
    n_handed = len(feed.handed)
    sound = [r for r in feed.handed if well_formed(r, vocab)]
    failed = len(feed.handed) - len(sound)
    rng = np.random.default_rng(mix(args.seed, 9))
    picked = []
    if sound:
        longest = max(range(len(sound)), key=lambda j: (
            len(sound[j].out), len(sound[j].ids)))
        rest = [j for j in range(len(sound)) if j != longest]
        picked = [longest] + sorted(rng.choice(
            rest, size=min(len(rest), cfg["check_requests"] - 1),
            replace=False).tolist())
    sample = [(sound[j].ids, sound[j].out, sound[j].logits.float().cpu())
              for j in picked]
    ctx = SimpleNamespace(cfg=cfg, tracer=tracer, window=window, device=dev)
    model.free()
    del model, feed, sound
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    path = str(cell.data.parent / cfg["checkpoint"])
    ref = ReferenceDecoder(path, dev)
    lower = ReferenceDecoder(path, dev, fp8=True) if control else None
    numbers = {"logit_gap": 0.0, "token_deficit": 0.0,
               "malformed_requests": float(failed)}
    for prompt, out, prefill in sample:
        allowed = ref.allowed(prompt, cfg["constrained"])
        seq = np.concatenate([prompt, out[:-1]])
        r = ref.logits(seq)
        if lower is not None:
            c = lower.logits(seq)[len(prompt) - 1:]
            prefill = c[0]
            out = c.masked_fill(~allowed, float("-inf")).argmax(dim=1)
        gap, deficit = compare.served_gaps(r, len(prompt), out,
                                           prefill.to(dev), allowed)
        numbers["logit_gap"] = max(numbers["logit_gap"], gap)
        numbers["token_deficit"] = max(numbers["token_deficit"], deficit)
    correct, checks = compare.judge(numbers, cfg["limits"])
    print(f"reference over {len(sample)} requests "
          f"({sum(len(s[1]) for s in sample)} served tokens) and comparison "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    out = {"correct": correct,
           "attempted": n_handed,
           "failed": failed,
           "metrics": {},
           "device": harness.device_info(dev, memory_peak)}
    if tracer is None:
        values = dict(window, setup_s=setup_s)
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        out["device"]["busy_s"] = tracer.busy_s
        out["device"]["window_s"] = tracer.window_s
        for name in cell.per_layer:
            reader = harness.load_module(cell.data / "metrics" / f"{name}.py")
            v = reader.read(ctx)
            if v is not None:
                out["metrics"][name] = {"value": v, "unit": reader.UNIT}
        out["breakdown"] = tracer.breakdown
        for name, (sec, count) in sorted(tracer.kernels.items(),
                                         key=lambda kv: -kv[1][0])[:6]:
            print(f"traced: {count} x {sec / count * 1e3:.4f} ms "
                  f"{name[:100]}", file=sys.stderr)
        print(f"traced: {n_traced} requests in "
              f"{tracer.window_s:.3f} s, busy {tracer.busy_s:.3f} s; the "
              f"profiler started in {tracer.start_s:.3f} s",
              file=sys.stderr)
    out["checks"] = {name: {key: harness._finite(v) for key, v in c.items()}
                     for name, c in checks.items()}
    return out
