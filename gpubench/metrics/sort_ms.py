"""<cell>.sort_ms: device milliseconds an operation of the window (a call,
a clustering) spends in library sort kernels."""

from gpubench.core.readers import stage_ms_per_op


def read(ctx):
    return stage_ms_per_op(ctx, "sort")
