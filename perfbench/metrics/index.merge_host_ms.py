"""Host milliseconds a batch in the index's row-to-id merge: the
program's ``search_profile`` stage ``idmap_merge`` of
``engine/index.py`` (row ids to chunk ids, tombstones, the final top-k
on the host), over the untraced part of a traced run's window."""

UNIT = "ms"
STAGE = "idmap_merge"


def read(ctx):
    seconds, calls = ctx.profile.get(STAGE, (0.0, 0))
    return seconds / calls * 1e3 if calls else None
