"""products_per_s: the products of every A² of the window (counted once
from the graph) over the window's seconds."""


def read(ctx):
    if not ctx.ops:
        return None
    return sum(r["products"] for r in ctx.ops) / ctx.window_s
