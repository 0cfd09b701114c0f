"""Local SpMV / SpMSpV / SpMM over semirings (port of
``combblas_tpu/ops/spmv.py``).

Every product of the COO stream is formed in one gather and folded per
output row with the semiring add (``index_add_`` for sum,
``scatter_reduce_`` with ``amin`` / ``amax`` for min / max).  Rows with no
product hold the add's identity, as JAX's segment reductions give.  Sparse
vectors are dense values plus a bool mask.  :func:`spmm` with
``use_kernel=True`` (JAX: ``use_pallas``) routes plus-times float SpMM
through the ELL-8 kernel (``ops/spmm_ell.py``).
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmm_ell import spmm_ell
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring
from combblas_tpu_torch.utils.timers import span

__all__ = ["spmv", "spmv_transpose", "spmsv_masked", "spmm"]


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, num: int,
                    sr: Semiring) -> torch.Tensor:
    """Fold ``vals`` (first dim = entries) into ``num`` segments by ``seg``;
    ``seg == num`` drops an entry.  Empty segments hold the add's
    identity."""
    shape = (num + 1,) + tuple(vals.shape[1:])
    seg = seg.long()
    if sr.add_kind == "sum":
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        out.index_add_(0, seg, vals)
    else:
        out = sr.zero(vals.dtype).to(vals.device).expand(shape).clone()
        idx = seg.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
        out.scatter_reduce_(0, idx, vals,
                            reduce="amin" if sr.add_kind == "min" else "amax")
    return out[:num]


def spmv(a: SpCOO, x: torch.Tensor, sr: Semiring = PLUS_TIMES
         ) -> torch.Tensor:
    """y = A ._sr x with dense x (len n) -> dense y (len m)."""
    m, n = a.shape
    valid = a.mask()
    prod = sr.mul(a.val, x[a.col.clamp(max=n - 1).long()])
    prod = torch.where(valid, prod, sr.zero(prod.dtype).to(prod.device))
    return _segment_reduce(prod, torch.where(valid, a.row, m), m, sr)


def spmv_transpose(a: SpCOO, x: torch.Tensor, sr: Semiring = PLUS_TIMES
                   ) -> torch.Tensor:
    """y = A^T ._sr x: y_j = add_i mul(A_ij, x_i); x len m -> y len n."""
    m, n = a.shape
    valid = a.mask()
    prod = sr.mul(a.val, x[a.row.clamp(max=m - 1).long()])
    prod = torch.where(valid, prod, sr.zero(prod.dtype).to(prod.device))
    return _segment_reduce(prod, torch.where(valid, a.col, n), n, sr)


def spmsv_masked(a: SpCOO, x_val: torch.Tensor, x_mask: torch.Tensor,
                 sr: Semiring = PLUS_TIMES, transpose: bool = False):
    """Masked-dense SpMSpV: the sparse vector is (values, bool mask).
    Returns (y_val, y_mask): y has an entry where at least one product
    with an active x entry landed; other outputs hold the add's identity."""
    m, n = a.shape
    valid = a.mask()
    if transpose:
        src, dst, out_len, src_len = a.row, a.col, n, m
    else:
        src, dst, out_len, src_len = a.col, a.row, m, n
    src_c = src.clamp(max=src_len - 1).long()
    # only the active entries fold (one host read): every inactive entry
    # sent to one spare slot would serialise the card's atomics there
    idx = torch.nonzero(valid & x_mask[src_c]).squeeze(1)
    src_c = src_c[idx]
    prod = sr.mul(a.val[idx], x_val[src_c])
    zero = sr.zero(prod.dtype).to(prod.device)
    seg = dst[idx].long()
    y = _segment_reduce(prod, seg, out_len, sr)
    y_mask = torch.zeros(out_len, dtype=torch.bool, device=a.device)
    y_mask[seg] = True
    return torch.where(y_mask, y, zero), y_mask


def spmm(a: SpCOO, x: torch.Tensor, sr: Semiring = PLUS_TIMES,
         use_kernel: bool = False, prep: dict | None = None) -> torch.Tensor:
    """Sparse (m, n) x dense (n, d) -> dense (m, d).

    Default: gather X's rows at the entries' columns, multiply, fold per
    row.  ``use_kernel=True`` (JAX: ``use_pallas``) takes the ELL-8 kernel
    (:func:`combblas_tpu_torch.ops.spmm_ell.spmm_ell`) for plus-times with
    a 2-D float X that is not float64, outside ``torch.compile`` tracing
    (the plan reads ``nnz`` and ``t_seg`` as Python ints, and the kernel
    is a ctypes call that tracing cannot follow).  Pass ``prep`` from
    ``spmm_ell_prepare`` to amortize planning.  Any (m, n, d): the TPU's
    VMEM-size gate does not carry over."""
    if (use_kernel and sr == PLUS_TIMES and x.dim() == 2
            and x.dtype.is_floating_point and x.dtype != torch.float64
            and not torch.compiler.is_compiling()):
        with span("spmm.call", x):
            return spmm_ell(a, x, prep=prep)
    return _spmm_gather(a, x, sr)


def _spmm_gather(a: SpCOO, x: torch.Tensor, sr: Semiring = PLUS_TIMES
                 ) -> torch.Tensor:
    """The gather + fold route of :func:`spmm` (JAX: ``_spmm_xla``)."""
    m, n = a.shape
    valid = a.mask()
    prod = sr.mul(a.val[:, None], x[a.col.clamp(max=n - 1).long()])
    prod = torch.where(valid[:, None], prod,
                       sr.zero(prod.dtype).to(prod.device))
    return _segment_reduce(prod, torch.where(valid, a.row, m), m, sr)
