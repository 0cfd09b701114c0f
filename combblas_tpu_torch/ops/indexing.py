"""SpRef / SpAsgn — matlab-style submatrix extraction and assignment (port
of ``combblas_tpu/ops/indexing.py``).

:func:`spref` is the reference's algorithm, P·A·Q with selector matrices
through ``spgemm_auto`` (so on the card it runs the expansion and compress
kernels); :func:`spref_gather` and :func:`spasgn` translate indices
directly (membership masks and gathers, no products).  Every matrix built
here lies on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import (
    SpCOO,
    _np_dtype,
    _sort_pairs,
    compress_sorted,
    merge,
    sort_coo,
)
from combblas_tpu_torch.ops.ewise import _compact, ewise_apply
from combblas_tpu_torch.ops.reduce import nnz_per
from combblas_tpu_torch.ops.spgemm import spgemm_auto
from combblas_tpu_torch.semiring import PLUS_TIMES

__all__ = [
    "make_selector",
    "spref",
    "spref_gather",
    "spasgn",
    "prune_block",
    "induced_subgraph",
    "remove_loops",
    "add_loops",
    "prune_ktips",
]


def make_selector(indices, n: int, transpose: bool = False,
                  device=None) -> SpCOO:
    """Boolean extraction matrix: (k, n) with S[i, indices[i]] = 1, or its
    (n, k) transpose, on ``device`` (the card when it is None)."""
    indices = np.asarray(indices, np.int64)
    k = indices.shape[0]
    rows = np.arange(k, dtype=np.int64)
    ones = np.ones(k, np.float32)
    if transpose:
        return SpCOO.from_arrays(indices, rows, ones, (n, k), device=device)
    return SpCOO.from_arrays(rows, indices, ones, (k, n), device=device)


def spref(a: SpCOO, ri, ci) -> SpCOO:
    """A(ri, ci) via P·A·Q, the reference's algorithm.  Index vectors may
    repeat (rows/cols are then replicated), as in matlab."""
    m, n = a.shape
    p = make_selector(ri, m, device=a.device)
    q = make_selector(ci, n, transpose=True, device=a.device)
    return spgemm_auto(spgemm_auto(p, a), q)


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _inverse(ix: torch.Tensor, size: int, k: int) -> torch.Tensor:
    """Old index -> new position, -1 where absent."""
    inv = torch.full((size,), -1, dtype=torch.int64, device=ix.device)
    inv[ix] = torch.arange(k, device=ix.device)
    return inv


def spref_gather(a: SpCOO, ri, ci, *, out_rows: int, out_cols: int,
                 out_capacity: int | None = None) -> SpCOO:
    """A(ri, ci) by direct index translation (ri/ci must be
    duplicate-free: the permutation / subselection case)."""
    m, n = a.shape
    nr = _inverse(_index(ri, a.device), m, out_rows)[
        a.row.clamp(max=m - 1).long()]
    nc = _inverse(_index(ci, a.device), n, out_cols)[
        a.col.clamp(max=n - 1).long()]
    keep = a.mask() & (nr >= 0) & (nc >= 0)
    cap = a.capacity if out_capacity is None else out_capacity
    r = torch.where(keep, nr, out_rows).to(torch.int32)
    c = torch.where(keep, nc, out_cols).to(torch.int32)
    v = torch.where(keep, a.val, 0)
    r, c, v = _sort_pairs(r, c, v)
    return compress_sorted(r, c, v, keep.sum(), (out_rows, out_cols),
                           out_capacity=cap)


def _hits(a: SpCOO, ri, ci) -> torch.Tensor:
    """Entries whose row is in ri and whose column is in ci."""
    m, n = a.shape
    in_r = torch.zeros(m, dtype=torch.bool, device=a.device)
    in_r[_index(ri, a.device)] = True
    in_c = torch.zeros(n, dtype=torch.bool, device=a.device)
    in_c[_index(ci, a.device)] = True
    return (in_r[a.row.clamp(max=m - 1).long()]
            & in_c[a.col.clamp(max=n - 1).long()])


def prune_block(a: SpCOO, ri, ci, out_capacity: int | None = None) -> SpCOO:
    """Remove all entries in rows ri × cols ci
    (``SpParMat::Prune(ri, ci)``)."""
    return _compact(a, ~_hits(a, ri, ci), out_capacity)


def induced_subgraph(a: SpCOO, vertices) -> SpCOO:
    """Subgraph induced by a vertex set (``InducedSubgraphs2Procs``):
    A(v, v) by index translation."""
    k = len(vertices)
    return spref_gather(a, vertices, vertices, out_rows=k, out_cols=k)


def remove_loops(a: SpCOO) -> SpCOO:
    """Drop diagonal entries (``SpParMat::RemoveLoops``)."""
    return _compact(a, a.row != a.col)


def _keep_a_else_b(x, y):
    return torch.where(x != 0, x, y)


def add_loops(a: SpCOO, value=1.0, out_capacity: int | None = None) -> SpCOO:
    """Set diagonal entries to ``value`` where absent
    (``SpParMat::AddLoops``)."""
    n = min(a.shape)
    eye = SpCOO.from_arrays(np.arange(n), np.arange(n),
                            np.full(n, value, _np_dtype(a.val.dtype)),
                            a.shape, device=a.device)
    # union, keeping A's value where the diagonal already exists
    return ewise_apply(a, eye, _keep_a_else_b, mode="union",
                       out_capacity=out_capacity
                       or (a.capacity + eye.capacity))


def prune_ktips(a: SpCOO, k: int = 1, rounds: int | None = None) -> SpCOO:
    """Iteratively remove "tip" vertices of degree <= k (genome-assembly
    k-tips pruning): drop every edge incident to a low-degree vertex until
    a fixpoint (or ``rounds`` iterations)."""
    rounds = rounds if rounds is not None else a.shape[0]
    cur = a
    for _ in range(rounds):
        m, n = cur.shape
        tip = nnz_per(cur, "row") + nnz_per(cur, "col") <= k
        hit = (tip[cur.row.clamp(max=m - 1).long()]
               | tip[cur.col.clamp(max=n - 1).long()]) & cur.mask()
        if not bool(hit.any()):
            break
        cur = _compact(cur, ~hit)
    return cur


def spasgn(a: SpCOO, ri, ci, b: SpCOO,
           out_capacity: int | None = None) -> SpCOO:
    """A(ri, ci) = B (``SpParMat::SpAsgn``): clear the ri×ci block of A,
    then merge in B's entries translated through ri/ci."""
    m, n = a.shape
    ri = _index(ri, a.device)
    ci = _index(ci, a.device)
    cleared = prune_block(a, ri, ci, out_capacity=a.capacity)
    kb_r, kb_c = b.shape
    valid = b.mask()
    emb = SpCOO(
        row=torch.where(valid, ri[b.row.clamp(max=kb_r - 1).long()],
                        m).to(torch.int32),
        col=torch.where(valid, ci[b.col.clamp(max=kb_c - 1).long()],
                        n).to(torch.int32),
        val=torch.where(valid, b.val, 0),
        nnz=b.nnz, shape=(m, n))
    cap = out_capacity if out_capacity is not None else a.capacity + b.capacity
    return merge(cleared, sort_coo(emb), PLUS_TIMES, out_capacity=cap)
