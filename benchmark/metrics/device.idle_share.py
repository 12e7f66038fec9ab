"""device.idle_share: 1 - (union of the device's operations) / (traced
window), over the window's calls, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s() <= 0:
        return None
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())
