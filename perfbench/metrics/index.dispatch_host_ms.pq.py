"""``index.dispatch_host_ms`` (host milliseconds a batch in
``search_profile``'s ``body_dispatch`` stage, over the untraced part of
a traced run's window) in the cells that report no ``qps`` end to end."""

UNIT = "ms"
STAGE = "body_dispatch"


def read(ctx):
    seconds, calls = ctx.profile.get(STAGE, (0.0, 0))
    return seconds / calls * 1e3 if calls else None
