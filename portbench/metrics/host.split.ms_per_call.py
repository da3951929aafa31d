"""host.split.ms_per_call: the host path's time in the every-card split (span
``mh.split``): the shared start expanded and each shard's slice moved to its
card, in ms: the time of each traced call in which no card runs a kernel or
a copy and this span is the innermost one open, averaged over the traced
calls (``portbench/spans.py``). Moves ``proposals_per_s``: one caller waits
on each call."""

from portbench.spans import read_span


def read(ctx):
    return read_span(ctx, "mh.split")
