"""``device.idle_pct`` (the share of the traced window in which no
operation runs on the card) in the cells that report no ``qps`` end to
end."""

UNIT = "%"


def read(ctx):
    t = ctx.tracer
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
