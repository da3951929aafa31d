"""call_p50_ms: the median host-clock time of every call in the window,
from the call to its result in numpy or its states synchronised."""

import statistics


def read(ctx):
    if not ctx.latencies_s:
        return None
    return statistics.median(ctx.latencies_s) * 1e3
