"""Plain Markov clustering (HipMCL's rules), and the check of a program's
clustering against it.

Plain PyTorch only.  The iterate is a column-stochastic matrix held as
row-major (row, col, val) arrays.  Each iteration: expansion (the square,
:mod:`gpubench.ref.spgemm`'s blocked product), the prune of
``MCLPruneRecoverySelect`` (entries below ``cutoff`` drop; a column keeps
at most its ``select`` largest; a column left with fewer than
``recover_pct * min(recover_num, select)`` keeps its ``recover_num``
largest of the unpruned column instead; equal values rank by row),
inflation, column normalisation and the chaos (the largest column max
less column sum of squares); it stops once the chaos is below ``eps``.
Clusters are the connected components of the last iterate's pattern.
"""

from __future__ import annotations

import torch

from gpubench.count.work import components
from gpubench.ref.spgemm import product_block, row_blocks

__all__ = ["mcl", "partition_distance", "compare_mcl"]


def _row_ptr(row: torch.Tensor, n: int) -> torch.Tensor:
    return torch.searchsorted(
        row, torch.arange(n + 1, dtype=row.dtype, device=row.device))


def _col_stochastic(col, val, n):
    s = torch.zeros(n, dtype=val.dtype, device=val.device)
    s.index_add_(0, col.long(), val)
    return val / s[col.long()]


def _square(row, col, val, n, dtype):
    rp = _row_ptr(row, n)
    keys, vals = [], []
    for r0, r1 in row_blocks(rp, col, rp):
        k, v = product_block(rp, col, val, rp, col, val, r0, r1, n, dtype)
        keys.append(k)
        vals.append(v)
    key = torch.cat(keys)
    return (key // n).to(torch.int32), (key % n).to(torch.int32), \
        torch.cat(vals)


def _prune(row, col, val, n, p: dict):
    """Keep mask of the prune rule over row-major entries."""
    dev = val.device
    av = val.abs()
    # rank in column by |v| descending, equal values by row ascending
    # (entries are row-major, so stable sorts keep row order)
    order = torch.sort(av, descending=True, stable=True)[1]
    order = order[torch.sort(col[order], stable=True)[1]]
    col_s = col[order].long()
    start = torch.searchsorted(col_s, torch.arange(n + 1, device=dev))
    pos = torch.arange(col_s.shape[0], device=dev) - start[col_s]
    cut_s = av[order] >= p["cutoff"]
    c0 = torch.zeros(col_s.shape[0] + 1, dtype=torch.int64, device=dev)
    c0[1:] = torch.cumsum(cut_s, 0)
    kept = torch.clamp(c0[start[1:]] - c0[start[:-1]], max=p["select"])
    need = kept < int(p["recover_pct"] * min(p["recover_num"], p["select"]))
    keep_s = torch.where(need[col_s], pos < p["recover_num"],
                         cut_s & (pos < p["select"]))
    keep = torch.empty_like(keep_s)
    keep[order] = keep_s
    return keep


def _chaos(col, val, n) -> float:
    dev = val.device
    cmax = torch.zeros(n, dtype=val.dtype, device=dev)
    cmax.scatter_reduce_(0, col.long(), val, "amax", include_self=False)
    css = torch.zeros(n, dtype=val.dtype, device=dev)
    css.index_add_(0, col.long(), val * val)
    return float((cmax - css).max())


def mcl(g, p: dict, dtype=torch.float64, max_iters: int | None = None):
    """Cluster the benchmark graph ``g`` with the parameters ``p``
    (``inflation``, ``cutoff``, ``select``, ``recover_num``,
    ``recover_pct``, ``eps``, ``max_iters``; self loops added).  Values
    and sums are in ``dtype``.  Returns (labels int64[n], iterations)."""
    n = g.n
    dev = g.row.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    key = torch.cat([g.row.long() * n + g.col.long(), ids * n + ids])
    val = torch.cat([g.val.to(dtype), torch.ones(n, dtype=dtype,
                                                 device=dev)])
    key, order = torch.sort(key)
    key, inv = torch.unique_consecutive(key, return_inverse=True)
    v = torch.zeros(key.shape[0], dtype=dtype, device=dev)
    v.index_add_(0, inv, val[order])
    row, col = (key // n).to(torch.int32), (key % n).to(torch.int32)
    val = _col_stochastic(col, v, n)
    it = 0
    for it in range(1, (max_iters or p["max_iters"]) + 1):
        row, col, val = _square(row, col, val, n, dtype)
        keep = _prune(row, col, val, n, p)
        row, col, val = row[keep], col[keep], val[keep]
        val = _col_stochastic(col, val.abs() ** p["inflation"], n)
        if _chaos(col, val, n) < p["eps"]:
            break
    sym_r = torch.cat([row, col])
    sym_c = torch.cat([col, row])
    return components(sym_r, sym_c, n), it


def partition_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Vertices outside their best-matching cluster, the larger over the
    two directions: 0 exactly when the labellings give one partition."""
    n = a.shape[0]

    def one_way(x, y):
        _, xi = torch.unique(x, return_inverse=True)
        _, yi = torch.unique(y, return_inverse=True)
        pair, cnt = torch.unique(xi * n + yi, return_counts=True)
        best = torch.zeros(n, dtype=torch.int64, device=x.device)
        best.scatter_reduce_(0, pair // n, cnt, "amax")
        return n - int(best.sum())

    a, b = a.long(), b.long()
    return max(one_way(a, b), one_way(b, a))


def compare_mcl(g, p: dict, labels: torch.Tensor, iterations: int) -> dict:
    """``labels_moved``: :func:`partition_distance` between the program's
    clusters and the reference's; ``iter_gap``: |iterations - the
    reference's|."""
    ref, ref_it = mcl(g, p)
    return {"labels_moved": partition_distance(labels.to(ref.device), ref),
            "iter_gap": abs(int(iterations) - ref_it)}
