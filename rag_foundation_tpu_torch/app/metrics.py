"""Prometheus metrics — the app's series, without ``prometheus_client``.

Counterpart of ``rag_foundation_tpu/app/metrics.py`` (reference parity:
backend/app/metrics.py:4-12: HTTP request counter/histogram, provider
call counter/latency, token counter, plus the per-stage chat latency and
index gauges). The card machine has no ``prometheus_client``, so the
series are built on the port's text registry (``engine/metrics.py``),
with the same names, help texts, labels and buckets.

The JAX app keeps one global registry that the in-process JAX engine also
feeds. Here the engine owns its series (``Engine.metrics``): ``render``
writes the app's series and then the engine's, which come from the
in-process engine when there is one and are empty otherwise, as the JAX
app's are in a process that serves a remote engine.
"""

from __future__ import annotations

from rag_foundation_tpu_torch.engine.metrics import (Counter, EngineMetrics,
                                                     Gauge, Histogram)

http_requests_total = Counter(
    "http_requests_total", "HTTP requests", ["method", "path", "status"])
http_request_duration_seconds = Histogram(
    "http_request_duration_seconds", "HTTP request latency",
    ["method", "path"])
engine_calls_total = Counter(
    "engine_calls_total", "Engine calls", ["op", "outcome"])
engine_latency_seconds = Histogram(
    "engine_latency_seconds", "Engine op latency", ["op"])
llm_tokens_total = Counter(
    "llm_tokens_total", "Token usage", ["kind", "model"])
# host-plane request anatomy: preamble = auth+validate+tenant+limits+
# budget, session = session upsert + user-message persist, engine = the
# ask_stream call (encode+search+compose), stream = SSE delta pump,
# finalize = cost ledger + assistant persist
chat_stage_seconds = Histogram(
    "chat_stage_seconds", "Per-stage chat request latency", ["stage"])
index_vectors = Gauge(
    "engine_index_vectors", "Vectors resident per store", ["store"])
ingest_vectors_total = Counter(
    "engine_ingest_vectors_total", "Vectors ingested")

APP_SERIES = (http_requests_total, http_request_duration_seconds,
              engine_calls_total, engine_latency_seconds, llm_tokens_total,
              chat_stage_seconds, index_vectors, ingest_vectors_total)


def render(engine=None) -> bytes:
    """The app's series, then the engine's: ``engine.metrics`` of an
    in-process ``Engine``, else the engine series with nothing observed
    (a ``RemoteEngine`` or the mock)."""
    own = getattr(engine, "metrics", None)
    if not isinstance(own, EngineMetrics):
        own = EngineMetrics()
    text = "".join(m.render() for m in APP_SERIES) + own.render()
    return text.encode()
