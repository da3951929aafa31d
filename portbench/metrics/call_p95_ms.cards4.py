"""call_p95_ms.cards4: the 95th percentile (nearest rank) of the call times
in a traced run's window, as ``call_p95_ms`` reads them, for a cell whose
tail spreads too widely from process to process to bound end to end (the
every-card cell). Moves ``call_p50_ms``."""

import math


def read(ctx):
    lat = sorted(ctx.window.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
