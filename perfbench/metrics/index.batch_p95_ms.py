"""The 95th percentile of a batch's latency in ``StoreIndex.search_many``,
from the entry taking the batch to its finalize: the end-to-end
``batch_p95_ms``, read over the untraced part of a traced run's window.
Per layer in the cells whose host-paced runs spread too widely for a
bound on ``batch_p95_ms`` end to end."""

UNIT = "ms"


def read(ctx):
    return ctx.window["batch_p95_ms"]
