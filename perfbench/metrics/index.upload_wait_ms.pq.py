"""``index.upload_wait_ms`` (``q_copy``'s host milliseconds a batch less
``device.upload``'s, over the untraced part of a traced run's window) in
the cells that report no ``qps`` end to end."""

UNIT = "ms"
HOST, DEVICE = "q_copy", "device.upload"


def read(ctx):
    host_s, host_n = ctx.profile.get(HOST, (0.0, 0))
    dev_s, dev_n = ctx.profile.get(DEVICE, (0.0, 0))
    if not host_n or not dev_n:
        return None
    return (host_s / host_n - dev_s / dev_n) * 1e3
