"""The traced part of a ``--trace 1`` run, read from ``torch.profiler``.

The device's busy time is the union of its operations' intervals
(kernels, copies, sets) inside the traced window; an idle gap is named
by the benchmark's span (``bench.*``, a ``record_function`` range) that
overlaps it most on the host, or ``host.other``.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

LABEL = "bench."
TOP = 10


class Tracer:
    """``torch.profiler`` over one part of a window, a fresh profile each
    start. The profiler's first start in a process loads and sets up its
    tracing library, which takes seconds: ``__init__`` does that once with
    a throwaway profile, so the start inside the window is quick."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
        self._new = lambda: profile(activities=acts)
        self._prof = None
        self.t0 = self.t1 = 0.0
        self.start_s = 0.0
        self.kernels: dict[str, list] = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.breakdown: dict = {}

    def start(self) -> None:
        asked = time.perf_counter()
        self._prof = self._new()
        self._prof.start()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - asked

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self._prof.stop()
        self._read()

    def _read(self) -> None:
        span_us = (self.t1 - self.t0) * 1e6
        dev, spans = [], []
        for e in self._prof.events():
            a = max(0.0, e.time_range.start)
            b = min(span_us, e.time_range.end)
            if e.name.startswith(LABEL):
                if e.device_type == torch.autograd.DeviceType.CPU:
                    spans.append((a, b, e.name))
                continue
            if e.device_type != torch.autograd.DeviceType.CPU \
                    and not getattr(e, "is_user_annotation", False) \
                    and b > a:
                dev.append((a, b, e.name))
        dev.sort()
        by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
        merged: list[list[float]] = []
        for a, b, name in dev:
            by_name[name][0] += (b - a) / 1e6
            by_name[name][1] += 1
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.kernels = dict(by_name)
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.window_s = span_us / 1e6
        edges = [0.0] + [x for ab in merged for x in ab] + [span_us]
        spans.sort()
        starts = [s[0] for s in spans]
        longest = max((b - a for a, b, _ in spans), default=0.0)
        gaps = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                near = spans[bisect.bisect_left(starts, a - longest):
                             bisect.bisect_left(starts, b)]
                gaps[_name_gap(a, b, near)] += (b - a) / 1e6
        top_ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        self.breakdown = {
            "device_ops": [[n, v[0]] for n, v in top_ops[:TOP]],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda x: -x[1])[:TOP]}

    def kernel_time(self, fragment: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``fragment``."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if fragment in name:
                s += sec
                n += count
        return s, n


def _name_gap(a: float, b: float, spans) -> str:
    """The span that overlaps ``[a, b]`` most; the innermost (shortest)
    of those that overlap it alike."""
    best, key = "host.other", (0.0, 0.0)
    for sa, sb, name in spans:
        k = (min(b, sb) - max(a, sa), sa - sb)
        if k[0] > 0 and k > key:
            best, key = name, k
    return best


def spans_on(profile) -> contextlib.AbstractContextManager:
    """Within the block, each stage of the program's ``StageProfile``
    also opens a ``record_function`` range named ``bench.<stage>``."""
    original = profile.stage

    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(LABEL + name), original(name):
            yield

    @contextlib.contextmanager
    def block():
        profile.stage = stage
        try:
            yield
        finally:
            del profile.stage

    return block()
