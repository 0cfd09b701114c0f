"""spmm.unpermute_ms: device milliseconds a call spends in the program's
``spmm.unpermute`` span (Y's rows gathered back to the original order)."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "spmm.unpermute")
