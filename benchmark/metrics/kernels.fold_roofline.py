"""kernels.fold_roofline: the least time the window's folds could take on
the card (benchlib.work: the larger of their bytes over the published HBM
rate and their recurrence FLOPs over the published float32 rate, counted
by the algorithm), over the device kernel time inside the traced
fold_batch spans (copies and fills excluded), in percent."""

from benchlib import work
from benchlib.trace import is_copy


def read(ctx):
    if ctx.trace is None or ctx.work is None:
        return None
    kernel_us = sum(e - s for name, s, e in ctx.trace.in_spans("fold_batch")
                    if not is_copy(name))
    if kernel_us <= 0:
        return None
    return 100.0 * work.least_seconds(*ctx.work) / (kernel_us / 1e6)
