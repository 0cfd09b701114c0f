"""Distributed dense matrices and sparse × dense products on the block grid
(port of ``combblas_tpu/parallel/dense.py``).

A distributed dense matrix (``DenseParMat``) is a plain tensor of the
padded shape (pr·mb, pc·nb) on the grid's device: block (i, j) is what
device (i, j) held under the JAX package's ``P('r', 'c')``.  A dense
operand of :func:`dist_spmm` is a column-space FullyDist block of rows
(n_padded, d), and its result a row-space one (m_padded, d); read in the
JAX package's ``P(('c','r'))`` / ``P(('r','c'))`` order both are the rows
in natural order (see :mod:`parallel.spmv`).
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
)
from combblas_tpu_torch.parallel.grid import ProcGrid, single_process
from combblas_tpu_torch.parallel.spmv import _fold, _sum_ascends
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["dense_put", "dense_to_host", "dist_spmm", "dense_add_sparse",
           "dense_reduce"]


@single_process
def dense_put(x: np.ndarray, grid: ProcGrid, gshape=None) -> torch.Tensor:
    """A host (m, n, ...) dense matrix on the grid's device, zero-padded to
    block multiples (``DenseParMat``'s constructor); ``gshape`` (default
    ``x``'s) sets the blocks."""
    x = np.asarray(x)
    m, n = x.shape[:2]
    mb, nb = block_dims((m, n) if gshape is None else gshape, grid)
    pad = np.zeros((grid.pr * mb, grid.pc * nb) + x.shape[2:], x.dtype)
    pad[:m, :n] = x
    return torch.from_numpy(pad).to(grid.device)


def dense_to_host(x: torch.Tensor, shape) -> np.ndarray:
    """The (shape[0], shape[1]) corner of a padded dense matrix, on the
    host."""
    return x[: shape[0], : shape[1]].cpu().numpy()


@single_process
def dist_spmm(a: DistSpMat, x: torch.Tensor, sr: Semiring = PLUS_TIMES, *,
              live=None) -> torch.Tensor:
    """Y = A ·_sr X, X dense (n_padded, d) in the column-space layout (cut
    or zero-padded to ``pc*nb`` rows).  Every block gathers its block
    column's rows of X at its entries' columns and folds the products per
    row (float sums in a fixed order, as :func:`parallel.spmv._fold`
    does); the partials meet in a reduce-scatter over the grid's columns.
    Returns Y (m_padded, d) in the row-space layout; rows without a
    product hold the add's identity.  ``live``: ``a``'s
    ``_live_entries``, for a loop that multiplies one matrix many times."""
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


@single_process
def dense_add_sparse(x: torch.Tensor, a: DistSpMat) -> torch.Tensor:
    """Dense += sparse (``DenseParMat::operator+=(SpParMat)``): every
    block's entries added at their places in the padded dense matrix."""
    pc = a.grid.pc
    mb, nb = block_dims(a.gshape, a.grid)
    bid, r, c, v = _live_entries(a)
    add = torch.zeros_like(x)
    add.index_put_(((bid // pc) * mb + r.long(), (bid % pc) * nb + c.long()),
                   v.to(x.dtype), accumulate=True)
    return x + add


def dense_reduce(x: torch.Tensor, dim: str) -> torch.Tensor:
    """Row (``dim='row'``) or column sums of a padded dense matrix
    (``DenseParMat::Reduce``)."""
    if dim not in ("row", "col"):
        raise ValueError(dim)
    return torch.sum(x, dim=1 if dim == "row" else 0)
