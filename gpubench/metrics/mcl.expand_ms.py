"""mcl.expand_ms: device milliseconds a clustering spends in the
program's ``mcl.expand`` spans (each iteration's ``spgemm_auto``)."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "mcl.expand")
