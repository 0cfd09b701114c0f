"""a2s.kernels_roofline: K1 and K2's share of their roofline in the
streamed A²: the bound of each call's expansion and compression over the
device time of the expansion and compression kernels.  The work is
counted from A's entries, the products and C (never from the padded
windows), at this route's sizes: A and B (= A) read as stored, each
product and each entry of C an int32 column key and a float32 value."""

from gpubench.core.readers import A2_KERNELS, roofline_pct
from gpubench.count.work import COO_BYTES

#: Bytes of one product or entry of C on the streamed route: int32
#: column key, float32 value (the row is the window's, not stored).
PACKED_BYTES = 8


def read(ctx):
    c = ctx.counts
    if "nnz_c" not in c:
        return None
    a, p = c["nnz_a"], c["products"]
    per_call = [(COO_BYTES * 2 * a + PACKED_BYTES * p, p),   # K1
                (PACKED_BYTES * (p + c["nnz_c"]), p)]         # K2
    return roofline_pct(ctx, A2_KERNELS, per_call * len(ctx.ops))
