"""torch_engine.kernels_per_step: device kernels in the traced window over
the MH steps the traced calls take (the torch chain engine,
``sampler/mh.py``, ``proposal.py``, ``prng.py``, ``tempering.py``).
Moves ``proposals_per_s``."""


def read(ctx):
    steps = len(ctx.trace.calls) * ctx.steps_per_call
    kernels = ctx.trace.kernels()
    if not steps or not kernels:
        return None
    return len(kernels) / steps
