"""Device milliseconds a batch in routing: the program's
``search_profile`` device stage ``device.route`` (CUDA events around the
coarse product, the top-``nprobe``, the dispatch inversion and the
query gather; for PQ the LUTs too), over the untraced part of a traced
run's window."""

UNIT = "ms"
STAGE = "device.route"


def read(ctx):
    seconds, calls = ctx.profile.get(STAGE, (0.0, 0))
    return seconds / calls * 1e3 if calls else None
