"""mcl_s: the window's seconds over the whole clusterings it completed."""


def read(ctx):
    return ctx.window_s / len(ctx.ops) if ctx.ops else None
