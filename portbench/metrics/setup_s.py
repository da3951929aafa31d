"""setup_s: process start to the first timed call: imports, building or
loading the CUDA library, the scene, and the warm-up calls of the cell's
own shapes."""


def read(ctx):
    return ctx.setup_s
