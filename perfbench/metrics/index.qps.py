"""Queries a second served by ``StoreIndex.search_many``: the end-to-end
``qps`` (the queries of every batch finalized, over the time from the
window's start), read over the untraced part of a traced run's window.
Per layer in the cells whose host-paced runs spread too widely for a
bound on ``qps`` end to end."""

UNIT = "queries/s"


def read(ctx):
    return ctx.window["qps"]
