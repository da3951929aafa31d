"""kernel.off_state_pct: the share of weighted FIXED launches in which the
MH kernel keeps its off-limits slab state in shared memory, in %: the
``mh.off_state`` ranges over the ``mh.off_state`` and ``mh.off_rows``
ranges opened in the traced calls, x 100 (host events read by name; the
program opens one of the two in each launch with the off-limits term in
the loop, ``mh.off_rows`` where the slab rows are summed from scratch).
None where neither was opened. Moves ``proposals_per_s``: the state
recomputes only the cells a step's moves change."""


def read(ctx):
    calls = ctx.trace.calls
    opened = [n for n, s, _ in ctx.trace.host if n in ("mh.off_state", "mh.off_rows")
              and any(lo <= s <= hi for lo, hi in calls)]
    if not opened:
        return None
    return 100.0 * opened.count("mh.off_state") / len(opened)
