"""The engine process's metrics, rendered as Prometheus text.

Counterpart of the engine series of ``rag_foundation_tpu/app/metrics.py``
(the ones the JAX engine feeds from ``api.py``), without
``prometheus_client``: a histogram with fixed buckets and a gauge, both
with labels, and ``render`` in the text exposition format 0.0.4
(``# HELP``/``# TYPE``, cumulative ``_bucket{le=...}`` ending in
``+Inf``, ``_sum`` and ``_count``). ``EngineRpcServer``'s
``metrics_text`` op returns ``Engine.metrics.render()``.
"""

from __future__ import annotations

import bisect
import math
import threading

# prometheus_client's default latency buckets (Histogram.DEFAULT_BUCKETS)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0)


def _num(v: float) -> str:
    """A sample value or bound as prometheus_client writes it."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, doc: str, labelnames=()):
        self.name, self.doc = name, doc
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, *values, **kw):
        if kw:
            values = tuple(kw[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._child()
        return child

    def _child(self):
        raise NotImplementedError

    def _samples(self):
        """(suffix, label pairs, value) of every child."""
        raise NotImplementedError

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.doc}",
                 f"# TYPE {self.name} {self.kind}"]
        for suffix, pairs, value in self._samples():
            lines.append(f"{self.name}{suffix}{_labels(pairs)} {_num(value)}")
        return "\n".join(lines) + "\n"


class _HistogramChild:
    def __init__(self, bounds: tuple[float, ...]):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)    # the last is +Inf
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self._bounds, v)   # le: v <= bound
        with self._lock:
            self._counts[i] += 1
            self._sum += v


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, doc, labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, doc, labelnames)
        self.buckets = tuple(float(b) for b in buckets)
        if not self.labelnames:
            self._children[()] = self._child()

    def _child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def _samples(self):
        for values, child in sorted(self._children.items()):
            pairs = list(zip(self.labelnames, values))
            with child._lock:
                counts, total = list(child._counts), child._sum
            acc = 0
            for bound, n in zip(self.buckets + (math.inf,), counts):
                acc += n
                yield "_bucket", pairs + [("le", _num(bound))], acc
            yield "_count", pairs, acc
            yield "_sum", pairs, total


class _GaugeChild:
    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, doc, labelnames=()):
        super().__init__(name, doc, labelnames)
        if not self.labelnames:
            self._children[()] = self._child()

    def _child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)

    def _samples(self):
        for values, child in sorted(self._children.items()):
            yield "", list(zip(self.labelnames, values)), child.value


class EngineMetrics:
    """The series the JAX engine process feeds (``app/metrics.py``), with
    the same names, help texts, labels and buckets."""

    def __init__(self):
        self.query_stage_seconds = Histogram(
            "engine_query_stage_seconds", "Per-stage query latency",
            ["stage"])     # embed | scan | merge
        self.search_batch_size = Histogram(
            "engine_search_batch_size",
            "Queries per coalesced device search",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self.recall_at_k = Gauge(
            "engine_recall_at_k",
            "Sampled recall vs exact scan (recall audit)", ["store", "k"])
        self.device_bytes_in_use = Gauge(
            "engine_device_bytes_in_use", "Accelerator HBM bytes in use")

    def update_device_memory(self, device) -> int | None:
        """Set the device-memory gauge from the card's allocator; on the
        CPU it is left unset, as the JAX engine leaves it. Returns the
        bytes or None."""
        if getattr(device, "type", str(device)) != "cuda":
            return None
        import torch
        used = int(torch.cuda.memory_allocated(device))
        self.device_bytes_in_use.set(used)
        return used

    def render(self) -> str:
        return "".join(m.render() for m in (
            self.query_stage_seconds, self.search_batch_size,
            self.recall_at_k, self.device_bytes_in_use))
