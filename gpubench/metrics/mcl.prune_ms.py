"""mcl.prune_ms: device milliseconds a clustering spends in the
program's ``mcl.prune`` spans (each iteration's ``_mcl_prune``)."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "mcl.prune")
