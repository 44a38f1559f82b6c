"""Rows a second of the index build (``systems/<mode>.py``'s timed
build, the card synchronised on both sides): the end-to-end
``build_vec_s``, per layer in the cells whose runs spread too widely
for a bound on it end to end. The build is part of ``setup_s``."""

UNIT = "vectors/s"


def read(ctx):
    return ctx.window["build_vec_s"]
