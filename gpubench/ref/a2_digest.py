"""Plain digest of C = A² for a C that no card holds: the entries of C
counted, its values summed, summed with the sign of their column's parity
(odd columns negated) and squared and summed, row block by row block, each
block formed by :func:`gpubench.ref.spgemm.a2_block` (expand, sort, fold)
and dropped.

Plain PyTorch only: nothing of the program is imported or used.  No matrix
multiplication runs, so TF32 never applies; it is turned off all the same.
"""

from __future__ import annotations

import torch

from gpubench.ref.spgemm import a2_block, row_blocks

__all__ = ["a2_digest", "compare_digest"]

#: Products a block expands at once: at float64, 20-25 GiB of temporaries,
#: so a scale-22 digest takes ~200 blocks.
MAX_PRODUCTS = 1 << 28


def a2_digest(g, dtype=torch.float64,
              max_products: int = MAX_PRODUCTS) -> tuple:
    """(entries of C, sum of C's values, their sum with odd columns
    negated, sum of their squares) of A² of a benchmark graph ``g``.
    Values, products and each entry's fold are in ``dtype``, each block's
    sums too; the blocks' sums add up in float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nnz, total, signed, sumsq = 0, 0.0, 0.0, 0.0
    for r0, r1 in row_blocks(g.row_ptr, g.col, g.row_ptr, max_products):
        key, val = a2_block(g, r0, r1, dtype)
        nnz += key.shape[0]
        total += float(val.sum())
        signed += float(torch.where(key % g.n % 2 == 1, -val, val).sum())
        sumsq += float((val * val).sum())
        del key, val
    return nnz, total, signed, sumsq


def _rel(x: float, ref: float, scale: float) -> float:
    if scale:
        return abs(x - ref) / scale
    return 0.0 if x == ref else float("inf")


def compare_digest(g, nnz: int, checksum: float, truncated: bool,
                   signed: float) -> dict:
    """Hold a digest ``(nnz, checksum, truncated, signed)`` of A² against
    the plain one in float64.  Returns ``nnz_gap`` (|nnz - the
    reference's|), ``truncated`` (0 or 1), ``checksum_rel`` (|checksum -
    the reference's| / the reference's), ``signed_rel`` (|signed - the
    reference's| / C's Frobenius norm) and ``nnz_c``, the reference's
    entry count."""
    ref_nnz, ref_sum, ref_signed, ref_sumsq = a2_digest(g)
    return {"nnz_gap": abs(int(nnz) - ref_nnz), "truncated": int(truncated),
            "checksum_rel": _rel(checksum, ref_sum, abs(ref_sum)),
            "signed_rel": _rel(signed, ref_signed, ref_sumsq ** 0.5),
            "nnz_c": ref_nnz}
