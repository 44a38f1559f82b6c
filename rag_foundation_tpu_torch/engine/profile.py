"""The search path's tracing: host stages, device stages, probe counters.

``search_profile`` is the port's one in-program tracing system for
``StoreIndex``'s search. It is always on, about 20 us a batch on an H100
host (``tools/trace_cost.py``):

- Host stages. ``stage(name)`` adds the block's wall seconds and one
  call under ``name``. Dispatch stages time the enqueue; a fetch stage
  (``rows_fetch``, ``tail_fetch``) times the wait for the card and the
  copy. While a ``torch.profiler`` is recording, a stage also opens the
  range ``index.<name>``, which carries the batch's number as ``batch``
  (recorded where the capture has ``record_shapes``): a capture places
  every host stage against the device's operations, and ties a batch's
  dispatch to its finalize.
- Device stages, timed on one batch in ``TIMED_EVERY`` (``open_batch``
  numbers the batches; the timed ones are those on a CUDA device whose
  number it divides). In a timed batch the stages of ``DEVICE_STAGES``
  record a CUDA event on the batch's stream at their end (the first one
  at its start too), and the finalize waits for the last one first
  (``own_wait``). ``close_batch``, called once the batch's fetch has
  returned, turns each interval between consecutive events into seconds
  under ``device.<stage>``, one call a timed batch, so reading them
  never waits. An interval runs from the event before it: where the card
  waited for the host's launches inside a stage, that idle time counts
  too, and so does the work of concurrent searches on the same stream.
  Events and their reads cost about 60 us a batch on an H100 host, hence
  the sampling.
- Counters. ``count_probes`` adds a routed batch's probes (a host count)
  and the probes its dispatch dropped past ``qcap``: a device scalar,
  kept until ``FOLD`` of them are summed into a device-side accumulator
  at once (no host read in the batch, three launches in ``FOLD``
  batches). ``counts()`` reads them, with a synchronise.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict

import torch

# host stage -> the device stage its events time
DEVICE_STAGES = {"q_copy": "device.upload", "route": "device.route",
                 "scan": "device.scan", "regather": "device.regather"}
# one batch in this many has its device stages timed
TIMED_EVERY = 16
# dropped-probe scalars held before they are summed on the device
FOLD = 64

# is a profiler recording? (a C-level flag, about 0.2 us; opening a range
# with no profiler costs about 15 us)
_recording = torch._C._autograd._profiler_enabled
# a profiler range whose keyword inputs the capture records
_RANGE = torch._C._profiler._RecordFunctionFast


class _Local(threading.local):
    batch = None          # the thread's current batch


class Batch:
    """One search batch: its number and, where it is timed, the events its
    device stages recorded on its stream. ``with batch:`` makes it the
    calling thread's current batch, the one its stages belong to."""

    __slots__ = ("seq", "stream", "marks", "_profile", "_prev")

    def __init__(self, profile: "StageProfile", seq: int, stream):
        self.seq = seq
        self.stream = stream
        # [(stage, event)], the first ("start", event); None untimed
        self.marks = None if stream is None else []
        self._profile = profile
        self._prev = None

    def __enter__(self) -> "Batch":
        local = self._profile._local
        self._prev = local.batch
        local.batch = self
        return self

    def __exit__(self, *exc) -> None:
        self._profile._local.batch = self._prev

    def mark(self, name: str) -> None:
        ev = self._profile._event()
        ev.record(self.stream)
        self.marks.append((name, ev))


class _Stage:
    __slots__ = ("profile", "name", "batch", "range", "t0")

    def __init__(self, profile: "StageProfile", name: str):
        self.profile = profile
        self.name = name

    def __enter__(self) -> None:
        batch = self.batch = self.profile._local.batch
        if batch is not None and batch.marks == [] \
                and self.name in DEVICE_STAGES:
            batch.mark("start")
        self.range = None
        if _recording():
            self.range = _RANGE("index." + self.name) if batch is None \
                else _RANGE("index." + self.name, [], {"batch": batch.seq})
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        batch = self.batch
        if batch is not None and batch.marks is not None \
                and self.name in DEVICE_STAGES:
            batch.mark(self.name)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        profile = self.profile
        with profile._lock:
            profile.seconds[self.name] += dt
            profile.calls[self.name] += 1


class StageProfile:
    def __init__(self) -> None:
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.probes = 0
        # device -> int64 scalar: probes dropped past qcap, and the
        # batches' scalars not summed into it yet
        self._dropped: dict[torch.device, torch.Tensor] = {}
        self._pending: list[torch.Tensor] = []
        self._events: list = []            # reusable timing events
        self._seq = itertools.count()
        self._local = _Local()
        # concurrent app searches accumulate into the same singleton;
        # '+=' on a dict value is a read-modify-write that loses
        # updates without this. Stage *interleaving* across threads
        # still mixes wall-clock: per-stage shares are only meaningful
        # under single-threaded bench scripts; the totals stay exact
        self._lock = threading.Lock()

    def stage(self, name: str) -> _Stage:
        return _Stage(self, name)

    def open_batch(self, device: torch.device | None) -> Batch:
        """The next batch; if timed (on a CUDA ``device``, one in
        ``TIMED_EVERY``), its device stages record events on that device's
        current stream (``None``: never, as for a mesh whose shards may
        sit on several devices)."""
        seq = next(self._seq)
        timed = device is not None and device.type == "cuda" \
            and seq % TIMED_EVERY == 0
        return Batch(self, seq,
                     torch.cuda.current_stream(device) if timed else None)

    def _event(self) -> torch.cuda.Event:
        try:
            return self._events.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def close_batch(self, batch: Batch) -> None:
        """Add ``batch``'s device stages and give its events back. Call it
        once the batch's work is done: ``elapsed_time`` then never waits."""
        marks = batch.marks
        if not marks:
            return
        batch.marks = None
        spent: dict[str, float] = {}
        prev = marks[0][1]
        for name, ev in marks[1:]:
            key = DEVICE_STAGES[name]
            spent[key] = spent.get(key, 0.0) + prev.elapsed_time(ev) / 1e3
            prev = ev
        with self._lock:
            for key, s in spent.items():
                self.seconds[key] += s
                self.calls[key] += 1
        self._events.extend(ev for _, ev in marks)

    def count_probes(self, probes: int,
                     dropped: torch.Tensor | None = None) -> None:
        """Add a routed batch's ``probes`` and its device count of probes
        dropped past ``qcap`` (``None``: a path without a ``qcap``)."""
        with self._lock:
            self.probes += probes
            if dropped is None:
                return
            self._pending.append(dropped)
            if len(self._pending) < FOLD:
                return
            pending, self._pending = self._pending, []
        self._fold(pending)

    def _fold(self, pending: list[torch.Tensor]) -> None:
        """Sum dropped-probe scalars into their devices' accumulators."""
        by_device: dict[torch.device, list] = {}
        for t in pending:
            by_device.setdefault(t.device, []).append(t)
        for device, group in by_device.items():
            with self._lock:
                acc = self._dropped.get(device)
                if acc is None:
                    acc = self._dropped[device] = torch.zeros(
                        (), dtype=torch.int64, device=device)
            acc.add_(torch.stack(group).sum())

    def counts(self) -> dict[str, int]:
        """``probes`` and ``probes_dropped`` since the last reset; reading
        the device accumulators waits for the work queued before."""
        with self._lock:
            pending, self._pending = self._pending, []
        self._fold(pending)
        with self._lock:
            probes = self.probes
            accs = list(self._dropped.values())
        return {"probes": probes,
                "probes_dropped": sum(int(a.item()) for a in accs)}

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()
            self.probes = 0
            self._pending = []
            for acc in self._dropped.values():
                acc.zero_()

    def snapshot(self) -> dict[str, dict]:
        return {k: {"s": round(self.seconds[k], 4), "n": self.calls[k]}
                for k in self.seconds}


# the serving path's singleton (StoreIndex dispatch/finalize stages)
search_profile = StageProfile()
