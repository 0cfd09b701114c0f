"""a2.kernels_roofline: the bound of every call's expansion and
compression (A's entries twice, the products, C) over the device time of
K1-K4's kernels."""

from gpubench.core.readers import A2_KERNELS, roofline_pct
from gpubench.count.work import compress_work, expand_work


def read(ctx):
    c = ctx.counts
    if "nnz_c" not in c:
        return None
    per_call = [expand_work(c["nnz_a"], c["nnz_a"], c["products"]),
                compress_work(c["products"], c["nnz_c"])]
    return roofline_pct(ctx, A2_KERNELS, per_call * len(ctx.ops))
