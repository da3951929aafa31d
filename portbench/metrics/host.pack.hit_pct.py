"""host.pack.hit_pct: the share of ``pack_scene`` calls that found the
scene's packing in its memo, in %: the ``mh.pack_hit`` ranges over the
``mh.pack_scene`` ranges opened in the traced calls, x 100 (host events
read by name, as ``portbench/spans.py`` reads them). None where no traced
call opened ``mh.pack_scene``. Moves ``proposals_per_s``: a hit skips the
scene's host reads, packing and uploads."""


def read(ctx):
    calls = ctx.trace.calls
    opened = [n for n, s, _ in ctx.trace.host if n in ("mh.pack_scene", "mh.pack_hit")
              and any(lo <= s <= hi for lo, hi in calls)]
    packs = opened.count("mh.pack_scene")
    if not packs:
        return None
    return 100.0 * opened.count("mh.pack_hit") / packs
