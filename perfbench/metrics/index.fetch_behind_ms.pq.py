"""``index.fetch_behind_ms`` (``rows_fetch``'s host milliseconds a batch
less ``own_wait``'s, over the untraced part of a traced run's window) in
the cells that report no ``qps`` end to end."""

UNIT = "ms"
OUTER, INNER = "rows_fetch", "own_wait"


def read(ctx):
    out_s, out_n = ctx.profile.get(OUTER, (0.0, 0))
    in_s, in_n = ctx.profile.get(INNER, (0.0, 0))
    if not out_n or not in_n:
        return None
    return (out_s / out_n - in_s / in_n) * 1e3
