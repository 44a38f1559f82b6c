"""Milliseconds a batch that the result fetch spent after its own batch's
work was done: the program's host stage ``rows_fetch`` less its inner
stage ``own_wait`` (the wait for the event after the batch's last body
launch), each over its own calls, over the untraced part of a traced
run's window. It holds the copy, and any work queued on the card after
the batch (the next batch, dispatched ahead)."""

UNIT = "ms"
OUTER, INNER = "rows_fetch", "own_wait"


def read(ctx):
    out_s, out_n = ctx.profile.get(OUTER, (0.0, 0))
    in_s, in_n = ctx.profile.get(INNER, (0.0, 0))
    if not out_n or not in_n:
        return None
    return (out_s / out_n - in_s / in_n) * 1e3
