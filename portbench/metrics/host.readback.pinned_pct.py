"""host.readback.pinned_pct: the share of readbacks that copied the fused
result into page-locked host memory with one wait, in %: the
``mh.readback_pinned`` ranges over the ``mh.readback`` ranges opened in the
traced calls, x 100 (host events read by name, as ``portbench/spans.py``
reads them). None where no traced call opened ``mh.readback``, or where the
program opens no ``mh.readback_pinned`` at all. Moves ``proposals_per_s``:
the pinned copy waits once, with no page faults, where a pageable copy
waits on each field."""


def read(ctx):
    calls = ctx.trace.calls
    opened = [n for n, s, _ in ctx.trace.host if n in ("mh.readback", "mh.readback_pinned")
              and any(lo <= s <= hi for lo, hi in calls)]
    reads = opened.count("mh.readback")
    pinned = opened.count("mh.readback_pinned")
    if not reads or not pinned:
        return None
    return 100.0 * pinned / reads
