"""a2.attempts: the program's ``spgemm.attempt`` spans over its
``spgemm.call`` spans in the window: multiplies a call makes, 1 when the
first output buffer held C."""

from gpubench.core.spans import count


def read(ctx):
    calls = count(ctx, "spgemm.call")
    return count(ctx, "spgemm.attempt") / calls if calls else None
