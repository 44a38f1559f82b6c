"""Device milliseconds a batch in the regather: the program's
``search_profile`` device stage ``device.regather`` (CUDA events around
the per-query gather of the list scan's candidates and the top-k; for PQ
the selection and the int8 re-rank), over the untraced part of a traced
run's window."""

UNIT = "ms"
STAGE = "device.regather"


def read(ctx):
    seconds, calls = ctx.profile.get(STAGE, (0.0, 0))
    return seconds / calls * 1e3 if calls else None
