"""host.scene_build.ms_per_call: the host path's time in ``SceneSpec.build``
and ``initial_pose`` on the card (span ``mh.scene_build``), where a call
passes the ``SceneSpec``, in ms: the time of each traced call in which no
card runs a kernel or a copy and this span is the innermost one open,
averaged over the traced calls (``portbench/spans.py``). Moves
``proposals_per_s``: one caller waits on each call."""

from portbench.spans import read_span


def read(ctx):
    return read_span(ctx, "mh.scene_build")
