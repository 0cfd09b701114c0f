"""bfs.ell_roofline: the bound of every batch's max folds (the graph
and the roots' frontier and output, once a sweep) over the device time of
csrc/ell.cu's kernels."""

from gpubench.core.readers import ELL_KERNELS, roofline_pct
from gpubench.count.work import ell_max_work


def read(ctx):
    c = ctx.counts
    if not ctx.ops or "sweeps" not in ctx.ops[0]:
        return None
    work = [ell_max_work(c["nnz"], c["n"], c["roots"], r["sweeps"])
            for r in ctx.ops]
    return roofline_pct(ctx, ELL_KERNELS, work)
