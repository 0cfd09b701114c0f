"""Distributed dense matrices and sparse × dense products on the block grid
(port of ``combblas_tpu/parallel/dense.py``).

A distributed dense matrix (``DenseParMat``) is a plain tensor of the
padded shape (pr·mb, pc·nb) on the grid's device: block (i, j) is what
device (i, j) held under the JAX package's ``P('r', 'c')``.  A dense
operand of :func:`dist_spmm` is a column-space FullyDist block of rows
(n_padded, d), and its result a row-space one (m_padded, d); read in the
JAX package's ``P(('c','r'))`` / ``P(('r','c'))`` order both are the rows
in natural order (see :mod:`parallel.spmv`).

On a grid spread over several processes (a pod) a dense matrix is this
process's rectangle of blocks, (lr·mb, lc·nb), the blocks its
``DistSpMat`` share holds; a dense operand or result of
:func:`dist_spmm` is this process's slice of the rows
(:meth:`ProcGrid.vec_range`), as a ``dist_spmv`` vector with a trailing
d.  :func:`dense_to_host` and :func:`dense_reduce` take the grid as a
keyword: a tensor alone does not say whether it is the whole matrix or a
share, so without it they refuse to run inside a group of several
processes.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
)
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.parallel.spmv import (
    _fold,
    _pod_input,
    _pod_plan,
    _segments,
    _sum_ascends,
)
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["dense_put", "dense_to_host", "dist_spmm", "dense_add_sparse",
           "dense_reduce"]


def _share_shape(x: torch.Tensor, grid: ProcGrid):
    """(lr, lc, mb, nb) of a pod share ``x`` of a dense matrix."""
    lr, lc = grid.local_shape()
    return lr, lc, x.shape[0] // lr, x.shape[1] // lc


def _pod_grid(grid: ProcGrid | None, what: str) -> bool:
    """Whether ``grid`` spans several processes; without a grid, refuse in
    a group of several processes (the tensor may be a share)."""
    if grid is None:
        if exchange.size() > 1:
            raise ValueError(f"{what} in a group of {exchange.size()} "
                             "processes needs the matrix's grid: a dense "
                             "matrix on a pod is this process's share")
        return False
    return grid.is_pod


def dense_put(x: np.ndarray, grid: ProcGrid, gshape=None) -> torch.Tensor:
    """A host (m, n, ...) dense matrix on the grid's device, zero-padded to
    block multiples (``DenseParMat``'s constructor); ``gshape`` (default
    ``x``'s) sets the blocks.  On a pod, this process's rectangle of
    blocks."""
    x = np.asarray(x)
    m, n = x.shape[:2]
    mb, nb = block_dims((m, n) if gshape is None else gshape, grid)
    pad = np.zeros((grid.pr * mb, grid.pc * nb) + x.shape[2:], x.dtype)
    pad[:m, :n] = x
    if grid.is_pod:
        (r0, c0), (lr, lc) = grid.origin(), grid.local_shape()
        pad = np.ascontiguousarray(
            pad[r0 * mb:(r0 + lr) * mb, c0 * nb:(c0 + lc) * nb])
    return torch.from_numpy(pad).to(grid.device)


def dense_to_host(x: torch.Tensor, shape, *,
                  grid: ProcGrid | None = None) -> np.ndarray:
    """The (shape[0], shape[1]) corner of a padded dense matrix, on the
    host.  On a pod (``grid``) ``x`` is this process's rectangle: the
    blocks are gathered, and every process gets the whole corner."""
    if _pod_grid(grid, "dense_to_host"):
        lr, lc, mb, nb = _share_shape(x, grid)
        parts = exchange.allgather_var([x.reshape(-1)])[0].reshape(
            (grid.nproc,) + tuple(x.shape))
        whole = x.new_empty((grid.pr * mb, grid.pc * nb) + x.shape[2:])
        for q in range(grid.nproc):
            r0, c0 = grid.origin(q)
            whole[r0 * mb:(r0 + lr) * mb, c0 * nb:(c0 + lc) * nb] = parts[q]
        x = whole
    return x[: shape[0], : shape[1]].cpu().numpy()


def _pod_spmm(a: DistSpMat, x: torch.Tensor, sr: Semiring, live):
    """:func:`dist_spmm` on a pod: this process's blocks read the rows of
    X under their block columns (gathered from the slices' owners where
    they are not its own), fold their products block by block as one
    process does, and the partials of each block row meet on the owners
    of its rows, over the block columns in ascending order (one reduction
    of a stack of one partial a block, as one process's reduce-scatter
    adds them)."""
    g = a.grid
    mb, nb = block_dims(a.gshape, g)
    lr, lc = g.local_shape()
    d = x.shape[1]
    in_len, out_len, spans = _pod_plan(a, False)
    xs, = _pod_input(a, [x.reshape(-1)], in_len, False, [x.dtype], d)
    xs = xs.reshape(-1, d)
    bid, r, c, v = _live_entries(a) if live is None else live
    prod = sr.mul(v[:, None], xs[(bid % lc) * nb + c.clamp(max=nb - 1)])
    seg = bid * mb + r
    part = _segments(prod, seg, lr * lc * mb, sr, _sum_ascends(sr, seg))
    part = part.reshape(lr, lc, mb * d).transpose(0, 1).reshape(
        lc, lr * mb * d)
    y, = exchange.reduce_to_owners(
        [part], [(s * d, e * d) for s, e in spans], out_len * d, g,
        [sr.add_kind])
    return y.reshape(-1, d)


def dist_spmm(a: DistSpMat, x: torch.Tensor, sr: Semiring = PLUS_TIMES, *,
              live=None) -> torch.Tensor:
    """Y = A ·_sr X, X dense (n_padded, d) in the column-space layout (cut
    or zero-padded to ``pc*nb`` rows).  Every block gathers its block
    column's rows of X at its entries' columns and folds the products per
    row (float sums in a fixed order, as :func:`parallel.spmv._fold`
    does); the partials meet in a reduce-scatter over the grid's columns.
    Returns Y (m_padded, d) in the row-space layout; rows without a
    product hold the add's identity.  ``live``: ``a``'s
    ``_live_entries``, for a loop that multiplies one matrix many times.
    On a pod X and Y are this process's slices of rows, and Y equals one
    process's bit for bit."""
    if a.grid.is_pod:
        return _pod_spmm(a, x, sr, live)
    pr, pc = a.grid.pr, a.grid.pc
    mb, nb = block_dims(a.gshape, a.grid)
    d = x.shape[1]
    xp = torch.zeros((pc * nb, d), dtype=x.dtype, device=x.device)
    k = min(x.shape[0], pc * nb)
    xp[:k] = x[:k]
    bid, r, c, v = _live_entries(a) if live is None else live
    prod = sr.mul(v[:, None], xp[(bid % pc) * nb + c.clamp(max=nb - 1)])
    seg = bid * mb + r
    y = _fold(prod, seg, (pr, pc), mb, "c", sr, _sum_ascends(sr, seg))
    return y.reshape(pr * mb, d)


def dense_add_sparse(x: torch.Tensor, a: DistSpMat) -> torch.Tensor:
    """Dense += sparse (``DenseParMat::operator+=(SpParMat)``): every
    block's entries added at their places in the padded dense matrix (on
    a pod, in this process's rectangle: no exchange)."""
    lc = a.grid.local_shape()[1]
    mb, nb = block_dims(a.gshape, a.grid)
    bid, r, c, v = _live_entries(a)
    add = torch.zeros_like(x)
    add.index_put_(((bid // lc) * mb + r.long(), (bid % lc) * nb + c.long()),
                   v.to(x.dtype), accumulate=True)
    return x + add


def dense_reduce(x: torch.Tensor, dim: str, *,
                 grid: ProcGrid | None = None) -> torch.Tensor:
    """Row (``dim='row'``) or column sums of a padded dense matrix
    (``DenseParMat::Reduce``).  On a pod (``grid``) ``x`` is this
    process's rectangle: every block sums its part of each row (column),
    and the partials meet on the owners of the rows (columns), over the
    blocks in ascending order; this process's slice of the sums."""
    if dim not in ("row", "col"):
        raise ValueError(dim)
    if not _pod_grid(grid, "dense_reduce"):
        return torch.sum(x, dim=1 if dim == "row" else 0)
    lr, lc, mb, nb = _share_shape(x, grid)
    rest = tuple(x.shape[2:])
    k = int(np.prod(rest, dtype=np.int64))
    if dim == "row":
        part = x.reshape(lr * mb, lc, nb, k).sum(2).transpose(0, 1)
        spans = [(grid.origin(q)[0] * mb * k, (grid.origin(q)[0] + lr) * mb
                  * k) for q in range(grid.nproc)]
        length = grid.pr * mb * k
    else:
        part = x.reshape(lr, mb, lc * nb, k).sum(1)
        spans = [(grid.origin(q)[1] * nb * k, (grid.origin(q)[1] + lc) * nb
                  * k) for q in range(grid.nproc)]
        length = grid.pc * nb * k
    y, = exchange.reduce_to_owners([part.reshape(part.shape[0], -1)],
                                   spans, length, grid, ["sum"])
    return y.reshape((-1,) + rest)
