"""runner.d2h_ms: the device-to-host copies' device time inside the
traced fold_batch spans, per call (batch engine, parallel/runner.py)."""

from benchlib.trace import is_d2h


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    ev = [e for e in ctx.trace.in_spans("fold_batch") if is_d2h(e[0])]
    if not ev:
        return None
    return sum(e - s for _, s, e in ev) / 1e3 / ctx.calls
