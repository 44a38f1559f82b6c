"""Share of the traced window in which no operation runs on the card
while it serves answers (``torch.profiler``: the union of the device's
kernels, copies and sets against the traced window's length on the host
clock)."""

UNIT = "%"


def read(ctx):
    t = ctx.tracer
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
