"""host.ms_per_call: the host path's share of a call (``api.py``
``suggest_layouts``, ``kernels/fused_mh.py`` ``pack_scene`` and the launch
wrapper, the every-card split), in ms: each traced call's wall time less
the time in which any card runs a kernel or a copy, averaged over the
traced calls. Moves ``proposals_per_s``: one caller waits on each call."""

from portbench.trace import covered


def read(ctx):
    calls = ctx.trace.calls
    if not calls:
        return None
    busy = ctx.trace.busy()
    host_us = [(e - s) - covered(busy, s, e) for s, e in calls]
    return sum(host_us) / len(host_us) * 1e-3
