"""<cell>.idle_pct: 100 x (1 - the union of device intervals / the traced
window)."""


def read(ctx):
    return ctx.trace.idle_pct() if ctx.trace is not None else None
