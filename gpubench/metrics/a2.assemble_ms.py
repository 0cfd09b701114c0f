"""a2.assemble_ms: device milliseconds a call spends in the program's
``spgemm.assemble`` spans: each slab's C written into the output
buffers, after the read of the running total."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "spgemm.assemble")
