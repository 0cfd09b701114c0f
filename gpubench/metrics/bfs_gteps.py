"""bfs_gteps: Graph500 edges of every search of the window (each root's
component's edges) over the window's seconds, in 1e9 a second."""


def read(ctx):
    if not ctx.ops:
        return None
    return sum(r["edges"] for r in ctx.ops) / ctx.window_s / 1e9
