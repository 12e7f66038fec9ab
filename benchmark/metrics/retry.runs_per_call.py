"""retry.runs_per_call: inside-pass launches per call, from the kernel
wrappers' launch counters: the prefix seed's run, the first run and each
re-run of the retry loop (exact)."""


def read(ctx):
    if not ctx.calls or not ctx.runs:
        return None
    return ctx.runs / ctx.calls
