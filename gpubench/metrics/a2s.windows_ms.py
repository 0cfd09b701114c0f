"""a2s.windows_ms: device milliseconds a streamed A² spends in the
program's ``seg.windows`` spans: every slab's exact row counts and its
per-row window gather from the expanded stream."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "seg.windows")
