"""step_mfu: the whole call's share of the card's float32 peak: the FLOPs
the window's calls must do (benchlib.work: the fold's recurrences and, in a
centroid cell, the centroid fills, counted by the algorithm) over the
traced window's time, against the published 67 TFLOP/s, in percent.  It
bounds every kernel's roofline share of the same calls."""

from benchlib import work


def read(ctx):
    if ctx.trace is None or ctx.step_flops is None:
        return None
    if ctx.trace.window_s() <= 0:
        return None
    return 100.0 * ctx.step_flops / ctx.trace.window_s() / work.PEAK_FP32_PER_S
