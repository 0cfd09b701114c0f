"""Distributed elementwise ops, reductions, transpose and k-select (port of
``combblas_tpu/parallel/elementwise.py``).

Block-local ops (apply, prune, the binary ops between aligned matrices)
need no communication; dimension ops (DimApply, Reduce, PruneColumn,
Kselect) read the vector slice of their block row or column and fold
partial results over the other mesh axis, as the SpMV does
(:mod:`combblas_tpu_torch.parallel.spmv`).

Each op reads only the live prefix of every block (``min(nnz,
capacity)`` slots, one host read of the nnz): the values-only ops write
new values into the live prefix of a zeroed stack, the pruning ops compact
each block's kept entries to its front (pads ``(mb, nb, 0)`` behind them,
the input's capacity kept, as JAX's ``_compact`` does), and the binary ops
and the transpose run the ported local op on every block cut to its live
entries.  Every stack, pad and nnz equals JAX's; the reductions fold over
the same segments in another order.

On a grid spread over several processes (a pod) every process works on
its own blocks, indexed from its first block, and its slices of the
FullyDist vectors.  What crosses processes goes through
:mod:`parallel.exchange`: a dimension op gathers the span of a vector that
its blocks read (as ``dist_spmv`` does); a reduction folds its blocks into
one partial vector per block of the other axis and fans them in onto the
slices' owners in the one-process order (block rows, or block columns,
ascending), so a pod's float sums are one process's bit for bit;
Kselect1 sends each block's candidates to the owner of their column's
slice; the transpose fetches block (j, i) from its owner; nnz is the whole
table in every process, and every decision that ends a loop or picks a
branch reads a value reduced over the processes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from combblas_tpu_torch.ops import ewise as lew
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.kselect import _desc_bits
from combblas_tpu_torch.ops.spgemm import round_capacity_frac
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
    live_counts,
    local_block,
)
from combblas_tpu_torch.parallel.spmv import (
    _col_space,
    _fold,
    _padded,
    _pod_input,
    _pod_plan,
    _row_space,
    _segments,
)
from combblas_tpu_torch.parallel.summa import _run_blocks
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = [
    "dist_apply",
    "dist_prune",
    "dist_ewise_mult",
    "dist_add",
    "dist_dim_apply",
    "dist_prune_column",
    "dist_reduce",
    "dist_kselect_col",
    "dist_kselect2_col",
    "dist_kselect_col_checked",
    "dist_transpose",
    "dist_nnz_per_col",
]

_U32 = (1 << 32) - 1


def _blocks(a: DistSpMat):
    """(i, j, live count) of every block of this process, in (i, j) order,
    (i, j) counted from its first block (in one process the grid's)."""
    lc = a.grid.local_shape()[1]
    return [(b // lc, b % lc, k) for b, k in enumerate(live_counts(a))]


def _live_block(a: DistSpMat, i: int, j: int, k: int) -> SpCOO:
    """Block (i, j) (counted from this process's first) cut to its ``k``
    live slots (at least one): the local ops find the same live entries in
    it as in the whole block, whose other slots are pads."""
    r0, c0 = a.grid.origin()
    blk = local_block(a, r0 + i, c0 + j)
    cap = max(k, 1)
    return blk.with_capacity(cap) if cap < a.capacity else blk


def _new_values(a: DistSpMat, piece: Callable) -> DistSpMat:
    """The stack with new values: ``piece(i, j, k)`` gives block (i, j)'s
    first ``k`` values; every other slot holds 0 (JAX: ``where(valid,
    ..., 0)``).  Coordinates and nnz are shared with ``a``."""
    val = None
    for i, j, k in _blocks(a):
        v = piece(i, j, k)
        if val is None:
            val = torch.zeros(a.val.shape, dtype=v.dtype, device=v.device)
        val[i, j, :k] = v
    return dataclasses.replace(a, val=val)


def _compact_blocks(a: DistSpMat, keep: Callable,
                    out_capacity: int | None = None) -> DistSpMat:
    """Every block's live entries where ``keep(i, j, k)`` holds (a bool
    over its first ``k`` slots), moved to the front in order, ``(mb, nb,
    0)`` pads behind them (JAX ``_compact`` on every block).  The blocks
    keep the input's capacity, or take ``out_capacity``, nnz saturating
    there."""
    mb, nb = block_dims(a.gshape, a.grid)
    cap = a.capacity if out_capacity is None else out_capacity
    dims = a.grid.local_shape() + (cap,)
    dev = a.row.device
    row = torch.full(dims, mb, dtype=torch.int32, device=dev)
    col = torch.full(dims, nb, dtype=torch.int32, device=dev)
    val = torch.zeros(dims, dtype=a.val.dtype, device=dev)
    nnz = torch.zeros(dims[:2], dtype=torch.int64, device=dev)
    for i, j, k in _blocks(a):
        idx = torch.nonzero(keep(i, j, k)).squeeze(1)[:cap]
        t = idx.shape[0]
        row[i, j, :t] = a.row[i, j, idx]
        col[i, j, :t] = a.col[i, j, idx]
        val[i, j, :t] = a.val[i, j, idx]
        nnz[i, j] = t
    return DistSpMat(row=row, col=col, val=val,
                     nnz=exchange.gather_table(nnz, a.grid), gshape=a.gshape,
                     grid=a.grid)


def _per_block(a: DistSpMat, body: Callable, gshape=None) -> DistSpMat:
    """``body(i, j, block)`` -> SpCOO on every block (cut to its live
    entries), the results stacked; they must share one capacity."""
    blocks = {(i, j): k for i, j, k in _blocks(a)}
    row, col, val, nnz = _run_blocks(
        a.grid.local_shape(),
        lambda i, j: body(i, j, _live_block(a, i, j, blocks[i, j])))
    return DistSpMat(row=row, col=col, val=val,
                     nnz=exchange.gather_table(nnz, a.grid),
                     gshape=gshape or a.gshape, grid=a.grid)


def _check_aligned(a: DistSpMat, b: DistSpMat) -> None:
    if a.grid != b.grid or a.gshape != b.gshape:
        raise ValueError(f"operands differ: {a.gshape} on {a.grid} vs "
                         f"{b.gshape} on {b.grid}")


def dist_apply(a: DistSpMat, fn: Callable) -> DistSpMat:
    """fn on every stored value (``SpParMat::Apply``)."""
    return _new_values(a, lambda i, j, k: fn(a.val[i, j, :k]))


def dist_prune(a: DistSpMat, pred: Callable) -> DistSpMat:
    """Drop the entries where pred(value) holds (``SpParMat::Prune``)."""
    return _compact_blocks(a, lambda i, j, k: ~pred(a.val[i, j, :k]))


def _binary(a: DistSpMat, b: DistSpMat, op: Callable) -> DistSpMat:
    """``op(block of a, block of b)`` on every block pair."""
    _check_aligned(a, b)
    bk = {(i, j): k for i, j, k in _blocks(b)}
    return _per_block(a, lambda i, j, blk: op(
        blk, _live_block(b, i, j, bk[i, j])))


def dist_ewise_mult(a: DistSpMat, b: DistSpMat, exclude: bool = False,
                    out_capacity: int | None = None) -> DistSpMat:
    """``EWiseMult`` on every block pair: the Hadamard product, or with
    ``exclude`` A where B has no entry.  Blocks of ``out_capacity`` slots
    (default: the larger input capacity)."""
    cap = out_capacity or max(a.capacity, b.capacity)
    return _binary(a, b, lambda x, y: lew.ewise_mult(
        x, y, exclude=exclude, out_capacity=cap))


def dist_add(a: DistSpMat, b: DistSpMat,
             out_capacity: int | None = None) -> DistSpMat:
    """A + B over the structural union, block by block; blocks of
    ``out_capacity`` slots (default: the two capacities together)."""
    cap = out_capacity or (a.capacity + b.capacity)
    return _binary(a, b, lambda x, y: lew.add(x, y, out_capacity=cap))


def _vec_len(a: DistSpMat, dim: str) -> int:
    mb, nb = block_dims(a.gshape, a.grid)
    if dim == "row":
        return a.grid.pr * mb
    if dim == "col":
        return a.grid.pc * nb
    raise ValueError(dim)


def _span(a: DistSpMat, x: torch.Tensor, dim: str) -> torch.Tensor:
    """The part of FullyDist ``x`` (row space for ``dim='row'``, column
    space for ``'col'``) that this process's blocks read, indexed from its
    first block row or column: in one process the whole vector, cut or
    padded to its padded length (JAX's all_gather of the block row's or
    column's slice); on a pod gathered from the slices' owners."""
    n = _vec_len(a, dim)
    if not a.grid.is_pod:
        return _padded(x, n)
    return _pod_input(a, [x], n, dim == "row", [x.dtype])[0]


def _slice_at(a: DistSpMat, x: torch.Tensor, dim: str, i: int, j: int,
              k: int) -> torch.Tensor:
    """The elements of ``x``, a :func:`_span`, at block (i, j)'s first
    ``k`` entries' rows (row space) or columns (column space), (i, j)
    counted from this process's first block."""
    mb, nb = block_dims(a.gshape, a.grid)
    if dim == "row":
        return x[i * mb + a.row[i, j, :k].clamp(max=mb - 1).long()]
    return x[j * nb + a.col[i, j, :k].clamp(max=nb - 1).long()]


def dist_dim_apply(a: DistSpMat, x: torch.Tensor, dim: str,
                   fn: Callable = torch.mul) -> DistSpMat:
    """A_ij = fn(A_ij, x_i or x_j); x in the matching FullyDist layout (row
    space for ``dim='row'``, column space for ``'col'``), cut or padded to
    its padded length."""
    xp = _span(a, x, dim)
    return _new_values(a, lambda i, j, k: fn(
        a.val[i, j, :k], _slice_at(a, xp, dim, i, j, k)))


def dist_prune_column(a: DistSpMat, x: torch.Tensor,
                      pred: Callable) -> DistSpMat:
    """Drop entry (i, j) when pred(A_ij, x_j); x in the column-space
    layout (``PruneColumn``)."""
    xp = _span(a, x, "col")
    return _compact_blocks(a, lambda i, j, k: ~pred(
        a.val[i, j, :k], _slice_at(a, xp, "col", i, j, k)))


def _dim_fold(a: DistSpMat, vals: torch.Tensor, dim: str, sr: Semiring,
              live) -> torch.Tensor:
    """Every block's row or column fold of ``vals`` (one per live entry),
    reduce-scattered over the other mesh axis: the FullyDist vector of
    ``dim`` (row space or column space); empty slots the add's
    identity."""
    if a.grid.is_pod:
        return _pod_dim_fold(a, vals, dim, sr, live)
    pr, pc = a.grid.pr, a.grid.pc
    mb, nb = block_dims(a.gshape, a.grid)
    bid, r, c, _v = live
    if dim == "row":
        return _row_space(_fold(vals, bid * mb + r, (pr, pc), mb, "c", sr))
    return _col_space(_fold(vals, bid * nb + c, (pr, pc), nb, "r", sr))


def _pod_dim_fold(a: DistSpMat, vals: torch.Tensor, dim: str, sr: Semiring,
                  live) -> torch.Tensor:
    """:func:`_dim_fold` on a pod: this process's blocks fold ``vals`` into
    one partial vector per block column (``dim='row'``: over the span of
    its block rows) or per block row (``'col'``: over its block columns),
    each block's segments as in one process; the partials then meet on the
    slices' owners in one reduction over the blocks of the other axis,
    ascending, as one process's reduce-scatter adds them.  This process's
    slice of the FullyDist vector."""
    g = a.grid
    mb, nb = block_dims(a.gshape, g)
    lr, lc = g.local_shape()
    bid, r, c, _v = live
    li, lj = bid // lc, bid % lc
    _in, length, spans = _pod_plan(a, dim == "col")
    if dim == "row":
        rows, width = lc, lr * mb
        seg = lj * width + li * mb + r
    else:
        rows, width = lr, lc * nb
        seg = li * width + lj * nb + c
    part = _segments(vals, seg, rows * width, sr, False)
    y, = exchange.reduce_to_owners([part.reshape(rows, width)], spans,
                                   length, g, [sr.add_kind])
    return y


def dist_reduce(a: DistSpMat, dim: str, sr: Semiring = PLUS_TIMES,
                premap: Callable | None = None) -> torch.Tensor:
    """Row ('row') or column ('col') reduction with the semiring add, after
    ``premap`` on each value: a row-space or column-space FullyDist vector;
    empty rows or columns hold the add's identity."""
    _vec_len(a, dim)
    live = _live_entries(a)
    vals = premap(live[3]) if premap is not None else live[3]
    return _dim_fold(a, vals, dim, sr, live)


def dist_nnz_per_col(a: DistSpMat) -> torch.Tensor:
    """Stored entries per column, column-space layout (int32)."""
    live = _live_entries(a)
    ones = torch.ones(live[0].shape, dtype=torch.int32, device=a.row.device)
    return _dim_fold(a, ones, "col", PLUS_TIMES, live)


def dist_kselect_col(a: DistSpMat, k, k_cap: int | None = None,
                     full_gather: bool = False) -> torch.Tensor:
    """Per-column k-th largest value (1-indexed), -inf where a column has
    fewer than k entries (``Kselect1``).  A Python int ``k`` with no
    ``k_cap`` is its own candidate cap; a per-column ``k`` (a tensor) needs
    a ``k_cap`` or an explicit ``full_gather=True``, as in JAX."""
    if k_cap is None and not full_gather:
        if isinstance(k, (int, np.integer)):
            k_cap = int(k)
        else:
            raise ValueError(
                "dist_kselect_col: traced k needs a static k_cap (candidate "
                "bound) or an explicit full_gather=True opt-in — the "
                "unbounded path gathers full block capacity along 'r' "
                "(round-1 memory hazard)")
    return _dist_kselect_col(a, k, k_cap)


def _col_len(a: DistSpMat) -> int:
    """The length of this process's column-space vectors: ``pc*nb``, a
    share of it on a pod."""
    n = _vec_len(a, "col")
    return n // a.grid.nproc


def _col_k(a: DistSpMat, k) -> torch.Tensor:
    """k broadcast over this process's column space (int64)."""
    return torch.as_tensor(k, device=a.row.device).to(torch.int64).expand(
        _col_len(a))


def _desc_order(seg: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The stable order by (segment ascending, float32 v descending); the
    segment ids must be below 2^31."""
    key = (seg.long() << 32) | _desc_bits(v)
    return torch.sort(key, stable=True)[1]


def _dist_kselect_col(a: DistSpMat, k, k_cap: int | None) -> torch.Tensor:
    """Kselect1.  With ``k_cap``, every block first keeps each column's
    ``k_cap`` largest entries (sorted by column, then value descending) and
    only its first ``cand_cap`` candidates, ``min(capacity,
    round_capacity_frac(max(nb*k_cap, 128)))``, are shipped along 'r';
    ``k`` is clipped to ``k_cap``.  Without it every live entry is a
    candidate.  The k-th largest of each column is then taken over the
    block column's candidates (on a pod, the process that holds the
    column's slice takes each candidate, in rank order).  Column-space
    output (``pc*nb``)."""
    pc = a.grid.pc
    nb = block_dims(a.gshape, a.grid)[1]
    kk = _col_k(a, k)
    bid, _r, c, v = _live_entries(a)
    v = v.to(torch.float32)
    if k_cap is not None:
        kk = torch.clamp(kk, max=k_cap)
        cand_cap = min(a.capacity, round_capacity_frac(max(nb * int(k_cap),
                                                           128)))
        # per block: rank within the column, keep rank < k_cap, then the
        # first cand_cap kept in (col, value desc) order
        seg = bid * (nb + 1) + c
        order = _desc_order(seg, v)
        seg = seg[order]
        pos = torch.arange(seg.shape[0], device=seg.device)
        keep = pos - torch.searchsorted(seg, seg) < k_cap
        # a kept entry's place among its block's kept ones
        blk = seg // (nb + 1)
        kept = torch.cumsum(keep, 0)
        first = torch.searchsorted(blk, blk)
        before = torch.where(first > 0, kept[(first - 1).clamp(min=0)], 0)
        keep &= kept - before - 1 < cand_cap
        sel = order[keep]
        bid, c, v = bid[sel], c[sel], v[sel]
    # candidates of block column j, over every block row i
    lc, c0 = a.grid.local_shape()[1], a.grid.origin()[1]
    gcol, v = exchange.route_to_owners(
        (c0 + bid % lc) * nb + c.long(), [v], a.grid, pc * nb)
    vs = v[_desc_order(gcol, v)]
    ncol = _col_len(a)
    count = torch.bincount(gcol.long(), minlength=ncol)
    start = torch.cumsum(count, 0) - count
    idx = (start + kk - 1).clamp(0, max(vs.shape[0] - 1, 0))
    kth = vs[idx] if vs.shape[0] else torch.zeros(ncol, device=v.device)
    return torch.where((count >= kk) & (kk >= 1), kth,
                       torch.tensor(float("-inf"), device=v.device))


def _ordered_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 image in [0, 2^32) of float32 bits whose order is the floats'
    (negatives complemented, positives with the sign bit set)."""
    b = v.to(torch.float32).view(torch.int32).long() & _U32
    return torch.where(b >= (1 << 31), _U32 - b, b | (1 << 31))


def dist_kselect2_col(a: DistSpMat, k) -> torch.Tensor:
    """Per-column k-th largest by 32 rounds of bisection on the
    order-preserving 32-bit image of the values (``Kselect2``): each round
    counts, per column, the entries at or above the midpoint (a segment sum
    per block, then a sum over 'r').  Never gathers the entries.  -inf
    where a column has fewer than k entries or k <= 0; column-space
    output."""
    lc = a.grid.local_shape()[1]
    nb = block_dims(a.gshape, a.grid)[1]
    kk = _col_k(a, k)
    live = _live_entries(a)
    bid, _r, c, v = live
    u = _ordered_u32(v)
    scol = (bid % lc) * nb + c.long()      # the column within the span

    def count_ge(thresh):
        ge = (u >= _span(a, thresh, "col")[scol]).to(torch.int32)
        return _dim_fold(a, ge, "col", PLUS_TIMES, live)

    ncol = _col_len(a)
    total = count_ge(torch.zeros(ncol, dtype=torch.int64, device=v.device))
    found = (total >= kk) & (kk > 0)
    lo = torch.zeros(ncol, dtype=torch.int64, device=v.device)
    hi = torch.full((ncol,), _U32, dtype=torch.int64, device=v.device)
    for _ in range(32):    # invariant: feasible(lo), not feasible(hi + 1)
        mid = lo + (hi - lo) // 2 + (hi - lo) % 2
        feas = count_ge(mid) >= kk
        lo = torch.where(feas, mid, lo)
        hi = torch.where(feas, hi, mid - 1)
    top = lo >= (1 << 31)
    bits = torch.where(top, lo & 0x7FFFFFFF, _U32 - lo)
    vals = torch.where(bits >= (1 << 31), bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)
    return torch.where(found, vals,
                       torch.tensor(float("-inf"), device=v.device))


def dist_kselect_col_checked(a: DistSpMat, k,
                             k_cap: int | None = None) -> torch.Tensor:
    """Kselect1 (candidate gather) and Kselect2 (bisection), held equal
    (the reference's cross-validation); raises AssertionError where they
    disagree."""
    if k_cap is None and not isinstance(k, (int, np.integer)):
        k_cap = int(exchange.max_proc(torch.as_tensor(k).max().cpu(),
                                      a.grid))
    v1 = dist_kselect_col(a, k, k_cap=k_cap)
    v2 = dist_kselect2_col(a, k)
    ok = (v1 == v2) | (torch.isneginf(v1) & torch.isneginf(v2))
    if exchange.any_proc(~ok.all(), a.grid):
        raise AssertionError("Kselect1/Kselect2 disagree (KSELECTLIMITERROR)")
    return v1


def dist_transpose(a: DistSpMat) -> DistSpMat:
    """A^T on a square grid: every block transposed (local coordinates
    swapped, re-sorted), then block (i, j) moved to (j, i) (on a pod,
    fetched from the process that holds it)."""
    grid = a.grid
    if grid.pr != grid.pc:
        raise ValueError("transpose needs a square grid (as the reference)")
    t = _per_block(a, lambda i, j, blk: blk.transpose().with_capacity(
        a.capacity), gshape=(a.gshape[1], a.gshape[0]))
    if grid.is_pod:
        lr, lc = grid.local_shape()
        mb, nb = t.block_shape()
        got = exchange.gather_live(
            [t.row, t.col, t.val], grid,
            [(j, i) for i, j in grid.local_blocks()],
            torch.clamp(t.nnz, max=t.capacity).cpu().numpy(), (mb, nb, 0),
            t.capacity)
        row, col, val = (x.reshape(lr, lc, -1) for x in got)
        return dataclasses.replace(t, row=row, col=col, val=val,
                                   nnz=t.nnz.transpose(0, 1).contiguous())
    return dataclasses.replace(
        t, row=t.row.transpose(0, 1).contiguous(),
        col=t.col.transpose(0, 1).contiguous(),
        val=t.val.transpose(0, 1).contiguous(),
        nnz=t.nnz.transpose(0, 1).contiguous())
