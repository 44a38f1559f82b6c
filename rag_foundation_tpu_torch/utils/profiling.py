"""Per-stage timing + optional ``torch.profiler`` tracing.

The engine times the stages of each search (embed / scan / merge) with
``StageTimer``; set ``RAGTPU_TRACE_DIR`` to also capture a
``torch.profiler`` timeline (CPU + CUDA activity, Chrome trace format)
around a block.
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    """Collects named stage durations; optionally mirrors to a
    prometheus histogram with a ``stage`` label."""

    def __init__(self, histogram=None):
        self.stages: dict[str, float] = {}
        self._histogram = histogram

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if self._histogram is not None:
                self._histogram.labels(name).observe(dt)


@contextlib.contextmanager
def maybe_trace(name: str = "ragtpu"):
    """Wrap a block in ``torch.profiler.profile`` when RAGTPU_TRACE_DIR
    is set and write ``<dir>/<name>.<pid>.<ns>.json``; no-op otherwise."""
    trace_dir = os.environ.get("RAGTPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{name}.{os.getpid()}.{time.time_ns()}.json"))
