"""The whole answer's share of the card's bf16 peak: the model operations
of every request finished in the window (``roofline.<flops>_flops``:
prompt and answer through the model once, attention over the real
context, the output head a token) over the window's seconds times
``roofline.PEAK_OPS_S["bf16"]``; read over the untraced part of a traced
run's window."""

from perfbench import roofline

UNIT = "%"


def read(ctx):
    w = ctx.window
    return 100.0 * w["model_flops"] / (w["window_s"]
                                       * roofline.PEAK_OPS_S["bf16"])
