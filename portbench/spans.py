"""The host path's time split by the program's own spans.

The program opens named ranges on its call path (``mh.suggest_layouts``,
``mh.pack_scene``, ...), which a ``--trace 1`` run records among the host
ops, on the clock of the cards' kernels and copies. Within each traced
call, every instant at which no card runs a kernel or a copy (the instants
``host.ms_per_call`` counts) goes to the innermost ``mh.*`` span covering
it: of those, the one that started last. Spans are read by name only; a
program that opens none leaves every reader here with nothing to read.
"""

from __future__ import annotations

from collections import defaultdict

from portbench.trace import clip

PREFIX = "mh."


def innermost(spans, lo: float, hi: float):
    """The name of the span that started last among ``spans`` (``(start,
    end, name)``) covering all of ``[lo, hi]``, the shorter on a tie; None
    where none covers it."""
    best = None
    for s, e, n in spans:
        if s <= lo and e >= hi and (best is None or (s, -e) > (best[0], -best[1])):
            best = (s, e, n)
    return None if best is None else best[2]


def idle_ms_per_call(trace) -> dict:
    """``{span name: ms}``: the time each ``mh.*`` span holds, as the
    innermost, of the traced calls' time with no card busy, averaged over
    the traced calls. Every span name a traced call opened is a key; the
    key None holds that time where no ``mh.*`` span is open."""
    if not trace.calls:
        return {}
    busy = trace.busy()
    mine = [(s, e, n) for n, s, e in trace.host if n.startswith(PREFIX)]
    total = defaultdict(float)
    for lo, hi in trace.calls:
        spans = [(max(s, lo), min(e, hi), n) for s, e, n in mine if e > lo and s < hi]
        for _, _, n in spans:
            total[n] += 0.0
        edge, idle = lo, []
        for s, e in clip(busy, lo, hi) + [(hi, hi)]:
            if s > edge:
                idle.append((edge, s))
            edge = max(edge, e)
        for a, b in idle:
            cuts = sorted({a, b} | {t for s, e, _ in spans for t in (s, e) if a < t < b})
            for p, q in zip(cuts, cuts[1:]):
                total[innermost(spans, p, q)] += q - p
    return {n: t * 1e-3 / len(trace.calls) for n, t in total.items()}


def read_span(ctx, name: str):
    """The idle ms per call that span ``name`` holds, None where no traced
    call opened it."""
    return idle_ms_per_call(ctx.trace).get(name)
