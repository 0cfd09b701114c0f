"""Plain Y = A X, and the check of a program's Y against it.

Plain PyTorch only: X's rows are gathered at each block of A's entries,
scaled and added into Y at the entries' rows.
"""

from __future__ import annotations

import torch

__all__ = ["spmm", "compare_spmm"]

#: Entries gathered at once (at d = 128 in float64, 4 GiB).
CHUNK = 1 << 22


def spmm(g, x: torch.Tensor, dtype=torch.float64, acc=None) -> torch.Tensor:
    """A X with A's values and X in ``dtype``, summed in ``acc`` (default
    ``dtype``); Y is (n, d) in ``acc``."""
    acc = acc or dtype
    y = torch.zeros((g.n, x.shape[1]), dtype=acc, device=x.device)
    xd = x.to(dtype)
    for lo in range(0, g.nnz, CHUNK):
        hi = min(lo + CHUNK, g.nnz)
        prod = g.val[lo:hi].to(dtype)[:, None] * xd[g.col[lo:hi].long()]
        y.index_add_(0, g.row[lo:hi].long(), prod.to(acc))
    return y


def compare_spmm(g, x: torch.Tensor, y: torch.Tensor) -> dict:
    """``y_max_rel``: the largest |y - ref| / ref over Y's elements, the
    reference in float64 (A and X are non-negative, so ref = |A| |X| and
    an element whose reference is 0 has to be 0)."""
    ref = spmm(g, x)
    worst = 0.0
    for lo in range(0, g.n, CHUNK // 8):
        r = ref[lo:lo + CHUNK // 8]
        d = (y[lo:lo + CHUNK // 8].double() - r).abs()
        rel = torch.nan_to_num(d / r.clamp(min=1e-300), nan=float("inf"))
        worst = max(worst, float(rel.max()))
    return {"y_max_rel": worst}
