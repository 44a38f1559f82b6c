"""Host milliseconds a batch in the index's body dispatch: the
program's ``search_profile`` stage ``body_dispatch`` of
``engine/index.py`` (queries to the card, coarse routing, the dispatch
inversion, the list scan and the regather enqueued), over the untraced
part of a traced run's window."""

UNIT = "ms"
STAGE = "body_dispatch"


def read(ctx):
    seconds, calls = ctx.profile.get(STAGE, (0.0, 0))
    return seconds / calls * 1e3 if calls else None
