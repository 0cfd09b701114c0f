"""Plain digest of C = A² for the tests: the entries of C counted, its
values summed, summed with the sign of their column's parity (odd columns
negated) and squared and summed, in float64, row block by row block
(expand, sort, fold).

Plain PyTorch only: nothing of ``combblas_tpu`` or ``combblas_tpu_torch``
is imported.  No matrix multiplication runs, so TF32 never applies.  The
benchmark keeps its own copy (``gpubench/ref/a2_digest.py``).
"""

from __future__ import annotations

import torch

__all__ = ["a2_digest"]


def a2_digest(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
              n: int, max_products: int = 1 << 22) -> tuple:
    """(entries of C, sum of C's values, their sum with odd columns
    negated, sum of their squares) of C = A² for the n x n matrix A with
    live entries (row, col, val) in row-major order, no duplicates.
    Products and each entry's fold are float64; rows are taken in blocks
    of at most ``max_products`` products (a single row may exceed it)."""
    row, col = row.long(), col.long()
    rp = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    rp[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    deg = rp[1:] - rp[:-1]
    ent_cum = torch.zeros(row.shape[0] + 1, dtype=torch.int64,
                          device=row.device)
    ent_cum[1:] = torch.cumsum(deg[col], 0)
    row_cum = ent_cum[rp].cpu()              # products before each row
    nnz, total, signed, sumsq, r0 = 0, 0.0, 0.0, 0.0, 0
    while r0 < n:
        r1 = int(torch.searchsorted(row_cum, int(row_cum[r0]) + max_products,
                                    right=True)) - 1
        r1 = min(max(r1, r0 + 1), n)
        e0, e1 = int(rp[r0]), int(rp[r1])
        k = col[e0:e1]
        cnt = deg[k]
        m = int(cnt.sum())
        if m:
            src = torch.repeat_interleave(torch.arange(e1 - e0), cnt,
                                          output_size=m)
            start = torch.cumsum(cnt, 0) - cnt
            pos = rp[k][src] + torch.arange(m) - start[src]
            key = row[e0:e1][src] * n + col[pos]
            prod = val[e0:e1].double()[src] * val[pos].double()
            key, order = torch.sort(key)
            ukey, inv = torch.unique_consecutive(key, return_inverse=True)
            c = torch.zeros(ukey.shape[0], dtype=torch.float64)
            c.index_add_(0, inv, prod[order])
            nnz += ukey.shape[0]
            total += float(c.sum())
            signed += float(torch.where(ukey % n % 2 == 1, -c, c).sum())
            sumsq += float((c * c).sum())
        r0 = r1
    return nnz, total, signed, sumsq
