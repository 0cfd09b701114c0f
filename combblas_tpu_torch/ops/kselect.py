"""Per-column k-select (port of ``combblas_tpu/ops/kselect.py``).

One sort by (column ascending, value descending) ranks every entry within
its column; the k-th largest per column is a gather at rank k - 1.

Ties: JAX's ``lax.sort(num_keys=2)`` on the CPU leaves equal (column,
value) pairs in input order, so the port breaks ties by entry id.  For
float32 values one stable ``torch.sort`` of an int64 key does it: the
column in the high 32 bits, the order-reversed float32 bits of the value in
the low 32 (negative values included; -0.0 counts as 0.0, as JAX's sort
canonicalises it).  Other value types take two stable sorts.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.ewise import _compact

__all__ = ["kselect_col", "col_rank", "select_top_k_per_col"]

_U32 = (1 << 32) - 1


def _desc_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) whose ascending order is float32 ``v``'s
    descending order."""
    b = (v + 0.0).view(torch.int32).long() & _U32   # -0.0 + 0.0 is +0.0
    asc = torch.where(b >= (1 << 31), _U32 - b, b + (1 << 31))
    return _U32 - asc


def col_desc_order(col: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts entries by (col ascending, v descending),
    equal pairs in entry order."""
    if v.dtype == torch.float32:
        key = (col.long() << 32) | _desc_bits(v)
        return torch.sort(key, stable=True)[1]
    order = torch.sort(v, descending=True, stable=True)[1]
    return order[torch.sort(col[order], stable=True)[1]]


def _col_sorted_desc(a: SpCOO):
    """Entry order by (col asc, val desc); pads (col n) last."""
    n = a.shape[1]
    col = torch.where(a.mask(), a.col, n)
    order = col_desc_order(col, a.val)
    return col[order], order


def _col_starts(col_s: torch.Tensor, n: int) -> torch.Tensor:
    """Start of each column 0..n in the sorted column ids."""
    bounds = torch.arange(n + 1, dtype=col_s.dtype, device=col_s.device)
    return torch.searchsorted(col_s, bounds)


def col_rank(a: SpCOO) -> torch.Tensor:
    """Rank (0-based, by descending value) of each stored entry within its
    column, aligned with a's entry order (int32)."""
    n = a.shape[1]
    col_s, eid_s = _col_sorted_desc(a)
    col_start = _col_starts(col_s, n)
    pos = torch.arange(a.capacity, device=a.device) - col_start[col_s.long()]
    rank = torch.empty(a.capacity, dtype=torch.int32, device=a.device)
    rank[eid_s] = pos.to(torch.int32)
    return rank


def _per_col(k, n: int, device) -> torch.Tensor:
    return torch.as_tensor(k, dtype=torch.int64, device=device).expand(n)


def kselect_col(a: SpCOO, k) -> torch.Tensor:
    """Per-column k-th largest stored value (1-indexed k), -inf where the
    column has fewer than k entries.  k may be scalar or a length-n
    vector."""
    n = a.shape[1]
    col_s, eid_s = _col_sorted_desc(a)
    col_start = _col_starts(col_s, n)
    count = col_start[1:] - col_start[:-1]
    k = _per_col(k, n, a.device)
    idx = (col_start[:-1] + k - 1).clamp(0, a.capacity - 1)
    kth = a.val[eid_s[idx]]
    return torch.where((count >= k) & (k >= 1), kth,
                       torch.tensor(float("-inf"), dtype=kth.dtype,
                                    device=a.device))


def select_top_k_per_col(a: SpCOO, k, out_capacity: int | None = None
                         ) -> SpCOO:
    """Keep only the k largest entries of each column (ties by entry
    order) — the 'select' step of MCL pruning."""
    n = a.shape[1]
    k = _per_col(k, n, a.device)
    keep = col_rank(a) < k[a.col.clamp(max=n - 1).long()]
    return _compact(a, keep, out_capacity)
