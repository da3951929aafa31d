"""kernel.fused_ms_per_launch: the mean device time of one launch of the
MH kernel (``kernels/csrc/fused_mh.cu``, ``fused_mh_kernel``), in ms.
Moves ``proposals_per_s``."""

KERNEL = "fused_mh_kernel("


def read(ctx):
    times = ctx.trace.kernels(KERNEL)
    if not times:
        return None
    return sum(times) / len(times) * 1e-3
