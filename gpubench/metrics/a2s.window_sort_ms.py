"""a2s.window_sort_ms: device milliseconds a streamed A² spends in the
program's ``seg.sort`` spans: every slab's per-class window sorts and
value gathers, whatever sort kernels the library picks for them."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "seg.sort")
