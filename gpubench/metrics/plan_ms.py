"""<cell>.plan_ms: host milliseconds an operation of the window (a call,
a clustering) spends in the program's ``spgemm.plan`` spans: the
dispatcher's product count and plan, and each slab plan."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "spgemm.plan", "host_ns")
