"""spmm.ell_roofline: the bound of every call's Y = A X (A's entries,
X and Y once) over the device time of csrc/ell.cu's kernels."""

from gpubench.core.readers import ELL_KERNELS, roofline_pct
from gpubench.count.work import ell_sum_work


def read(ctx):
    c = ctx.counts
    work = ell_sum_work(c["nnz"], c["n"], c["n"], c["d"])
    return roofline_pct(ctx, ELL_KERNELS, [work] * len(ctx.ops))
