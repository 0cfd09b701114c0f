"""spmm_ms: the window's milliseconds over its calls."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.ops) if ctx.ops else None
