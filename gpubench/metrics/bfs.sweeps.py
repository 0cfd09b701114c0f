"""bfs.sweeps: the deepest level + 1 of a batch (its ELL max sweeps), read
from the output."""

from gpubench.core.readers import op_mean


def read(ctx):
    return op_mean(ctx, "sweeps")
