"""centroid.traceback_ms: the PhaseTimer phase traceback of
centroid_structures (the host traceback and the dot-brackets), per
call."""


def read(ctx):
    phase = (ctx.phases or {}).get("traceback")
    if phase is None or not ctx.calls:
        return None
    return 1e3 * phase["seconds"] / ctx.calls
