"""Milliseconds a batch that the query upload waited for the card: the
program's host stage ``q_copy`` (the copy to the card, which waits for
the work queued before it) less its device stage ``device.upload`` (the
copy on the card), each over its own calls, over the untraced part of a
traced run's window."""

UNIT = "ms"
HOST, DEVICE = "q_copy", "device.upload"


def read(ctx):
    host_s, host_n = ctx.profile.get(HOST, (0.0, 0))
    dev_s, dev_n = ctx.profile.get(DEVICE, (0.0, 0))
    if not host_n or not dev_n:
        return None
    return (host_s / host_n - dev_s / dev_n) * 1e3
