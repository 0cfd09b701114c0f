"""Plain SpGEMM A·B (expand, sort, fold) in row blocks, and the check of a
kept C against it.

Plain PyTorch only: nothing of the program is imported or used.  The rows
of A are cut into blocks of at most ``max_products`` products; each block
expands its products, sorts their (row, column) keys and sums equal keys.
"""

from __future__ import annotations

import torch

__all__ = ["row_blocks", "product_block", "a2_block", "compare_blocks",
           "compare_a2"]

#: Products a block expands at once (a few GiB of temporaries).
MAX_PRODUCTS = 1 << 26


def row_blocks(a_rp: torch.Tensor, a_col: torch.Tensor, b_rp: torch.Tensor,
               max_products: int = MAX_PRODUCTS) -> list:
    """[(r0, r1)] row ranges of A, each with at most ``max_products``
    products (a single row may exceed it alone)."""
    b_len = b_rp[1:] - b_rp[:-1]
    per_entry = b_len[a_col.long()]
    cum = torch.zeros(per_entry.shape[0] + 1, dtype=torch.int64,
                      device=a_col.device)
    cum[1:] = torch.cumsum(per_entry, 0)
    row_cum = cum[a_rp].cpu()          # products before each row
    out, r0, m = [], 0, a_rp.shape[0] - 1
    while r0 < m:
        target = int(row_cum[r0]) + max_products
        r1 = int(torch.searchsorted(row_cum, target, right=True)) - 1
        r1 = min(max(r1, r0 + 1), m)
        out.append((r0, r1))
        r0 = r1
    return out


def product_block(a_rp, a_col, a_val, b_rp, b_col, b_val, r0: int, r1: int,
                  n_cols: int, dtype=torch.float64):
    """C[r0:r1] = A[r0:r1] · B as (keys, values): keys row * n_cols + col
    ascending and unique, values in ``dtype`` (products and sums)."""
    dev = a_col.device
    e0, e1 = int(a_rp[r0]), int(a_rp[r1])
    rows = torch.repeat_interleave(
        torch.arange(r0, r1, device=dev), a_rp[r0 + 1:r1 + 1] - a_rp[r0:r1])
    k = a_col[e0:e1].long()
    cnt = b_rp[k + 1] - b_rp[k]
    total = int(cnt.sum())
    if total == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=dtype, device=dev))
    src = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), cnt,
                                  output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    pos = b_rp[k][src] + torch.arange(total, device=dev) - start[src]
    key = rows[src] * n_cols + b_col[pos].long()
    val = a_val[e0:e1].to(dtype)[src] * b_val[pos].to(dtype)
    key, order = torch.sort(key)
    ukey, inv = torch.unique_consecutive(key, return_inverse=True)
    out = torch.zeros(ukey.shape[0], dtype=dtype, device=dev)
    out.index_add_(0, inv, val[order])
    return ukey, out


def a2_block(g, r0: int, r1: int, dtype=torch.float64):
    """Rows [r0, r1) of A² of a benchmark graph ``g``."""
    return product_block(g.row_ptr, g.col, g.val, g.row_ptr, g.col, g.val,
                         r0, r1, g.n, dtype)


def compare_blocks(g, candidate) -> tuple:
    """Hold a C under test against the plain A² in float64, row block by
    row block; ``candidate(r0, r1)`` gives the (keys, values) of its rows
    [r0, r1), keys ``row * n + col`` in row-major order.

    Returns (``key_mismatch``: entries whose (row, column) differs from
    the reference's, plus the differences in length; ``val_max_rel``: the
    largest |c - ref| / |ref| over the entries of blocks whose keys match;
    the reference's entry count)."""
    mismatch, worst, nnz_ref = 0, 0.0, 0
    for r0, r1 in row_blocks(g.row_ptr, g.col, g.row_ptr):
        key, ref = a2_block(g, r0, r1)
        nnz_ref += key.shape[0]
        ck, cv = candidate(r0, r1)
        if ck.shape[0] != key.shape[0]:
            mismatch += abs(ck.shape[0] - key.shape[0])
            m = min(ck.shape[0], key.shape[0])
            mismatch += int((ck[:m] != key[:m]).sum())
            continue
        mismatch += int((ck != key).sum())
        if key.shape[0]:
            rel = torch.nan_to_num((cv.double() - ref).abs()
                                   / ref.abs().clamp(min=1e-300),
                                   nan=float("inf"))
            worst = max(worst, float(rel.max()))
    return mismatch, worst, nnz_ref


def compare_a2(g, c_row: torch.Tensor, c_col: torch.Tensor,
               c_val: torch.Tensor, c_nnz: int) -> dict:
    """Hold a kept C = A² (the program's arrays, row-major, ``c_nnz`` live
    entries) against the plain product (:func:`compare_blocks`).

    Returns ``key_mismatch`` (entries past the last row counted too),
    ``val_max_rel`` and ``nnz_c``, the reference's entry count."""
    bounds = torch.searchsorted(
        c_row[:c_nnz],
        torch.arange(g.n + 1, dtype=c_row.dtype, device=c_row.device))

    def block(r0, r1):
        lo, hi = int(bounds[r0]), int(bounds[r1])
        return c_row[lo:hi].long() * g.n + c_col[lo:hi].long(), c_val[lo:hi]

    mismatch, worst, nnz_ref = compare_blocks(g, block)
    mismatch += c_nnz - int(bounds[g.n])   # entries past the last row
    return {"key_mismatch": mismatch, "val_max_rel": worst, "nnz_c": nnz_ref}
