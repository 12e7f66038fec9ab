"""call_p95_ms: the 95th percentile of the window's calls, each from its
start to its outputs on the host (host clock)."""

import statistics


def read(ctx):
    if len(ctx.latencies_s) < 2:
        return None
    ms = [1e3 * x for x in ctx.latencies_s]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
