"""Row/column reductions (port of ``combblas_tpu/ops/reduce.py``).

One segment reduction over the COO stream, as ``SpParMat::Reduce``: the
live entries fold into a length ``m + 1`` (or ``n + 1``) buffer filled with
the semiring add's identity, pads go to the last slot, which is cut off.
Empty rows or columns therefore hold the identity (``-inf`` for a max over
floats, as JAX's ``segment_max`` gives).
"""

from __future__ import annotations

from typing import Callable

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import _segment_reduce
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["reduce_dim", "nnz_per"]


def _segments(a: SpCOO, dim: str):
    """Each entry's segment (pads on the spare slot) and the length."""
    m, n = a.shape
    valid = a.mask()
    if dim == "row":
        return torch.where(valid, a.row, m), m
    if dim == "col":
        return torch.where(valid, a.col, n), n
    raise ValueError(dim)


def reduce_dim(a: SpCOO, dim: str, sr: Semiring = PLUS_TIMES,
               premap: Callable | None = None) -> torch.Tensor:
    """Reduce along one dimension: ``dim='row'`` gives the length-m vector
    of row reductions, ``'col'`` the length-n vector of column reductions.
    ``premap`` transforms each stored value before the fold (the unary op
    of the reference's Reduce).  Empty rows/cols get ``sr.zero``."""
    seg, length = _segments(a, dim)
    vals = premap(a.val) if premap is not None else a.val
    vals = torch.where(a.mask(), vals, sr.zero(vals.dtype).to(vals.device))
    return _segment_reduce(vals, seg, length, sr)


def nnz_per(a: SpCOO, dim: str) -> torch.Tensor:
    """Number of stored entries per row or column (int32 vector)."""
    seg, length = _segments(a, "row" if dim == "row" else "col")
    return _segment_reduce(a.mask().to(torch.int32), seg, length, PLUS_TIMES)
