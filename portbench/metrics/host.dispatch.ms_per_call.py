"""host.dispatch.ms_per_call: the host path's time in the dispatch of
``api.py`` ``suggest_layouts``: the self time of its ``mh.suggest_layouts``
span (argument checks, ``Scene.to``, the mask counts read back, the engine
choice, ``chain_mesh()``, logging), in ms: the time of each traced call in
which no card runs a kernel or a copy and this span is the innermost one
open, averaged over the traced calls (``portbench/spans.py``). Moves
``proposals_per_s``: one caller waits on each call."""

from portbench.spans import read_span


def read(ctx):
    return read_span(ctx, "mh.suggest_layouts")
