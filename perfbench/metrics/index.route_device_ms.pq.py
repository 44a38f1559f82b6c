"""``index.route_device_ms`` (device milliseconds a batch in
``search_profile``'s ``device.route`` stage, over the untraced part of a
traced run's window) in the cells that report no ``qps`` end to end."""

UNIT = "ms"
STAGE = "device.route"


def read(ctx):
    seconds, calls = ctx.profile.get(STAGE, (0.0, 0))
    return seconds / calls * 1e3 if calls else None
