"""call_p95_ms: the 95th percentile (nearest rank) of the same call times
as ``call_p50_ms``; the run prints the count of calls beside it."""

import math


def read(ctx):
    if not ctx.latencies_s:
        return None
    lat = sorted(ctx.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
