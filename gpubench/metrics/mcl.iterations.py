"""mcl.iterations: the iterations mcl_local returned, a clustering."""

from gpubench.core.readers import op_mean


def read(ctx):
    return op_mean(ctx, "iterations")
