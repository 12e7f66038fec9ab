"""centroid.fill_copy_ms: the PhaseTimer phase fill_copy of
centroid_structures (the (R, G, N, N) fills' copy to the host), per
call."""


def read(ctx):
    phase = (ctx.phases or {}).get("fill_copy")
    if phase is None or not ctx.calls:
        return None
    return 1e3 * phase["seconds"] / ctx.calls
