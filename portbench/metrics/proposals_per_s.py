"""proposals_per_s: the MH proposals of every call completed in the window
(chains x steps x moves a step; replicas x steps for tempering) over the
time from the window's start to the last completion."""


def read(ctx):
    if not ctx.latencies_s or ctx.span_s <= 0:
        return None
    return ctx.proposals / ctx.span_s
