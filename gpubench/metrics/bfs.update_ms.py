"""bfs.update_ms: device milliseconds a batch spends in the program's
``bfs.level`` spans outside their ``bfs.fold`` (the self time): the
level updates on the (n_pad, 128) carriers."""

from gpubench.core.spans import ms_per_op


def read(ctx):
    return ms_per_op(ctx, "bfs.level", "self_ns")
