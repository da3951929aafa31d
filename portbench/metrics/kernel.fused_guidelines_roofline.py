"""kernel.fused_guidelines_roofline: the MH kernel's least time over its
measured time, in %, on scenes with many design guidelines. The least time
of a launch is the larger of its operations over the float32 peak and its
bytes over the memory bandwidth, as ``counts/fused_guidelines.py`` counts
them from the launch's own draws: the single-move count plus the clearance
pairs, outside-surface terms, distance and angle rows the moves change.
Reads traces with one single-move, one-draw launch per call; None where
any launch has no count (compound steps, weighted FIXED). Moves
``proposals_per_s``."""

KERNEL = "fused_mh_kernel("


def read(ctx):
    times = ctx.trace.kernels(KERNEL)
    if not times or len(times) != len(ctx.keys):
        return None
    count = ctx.count("fused_guidelines")
    bounds = [count.launch(ctx.config, ctx.traffic, key) for key in ctx.keys]
    if any(b is None for b in bounds):
        return None
    return 100.0 * sum(b["bound_s"] for b in bounds) / (sum(times) * 1e-6)
