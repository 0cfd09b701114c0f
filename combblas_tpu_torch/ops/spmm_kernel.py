"""SpMM over the row-sorted COO stream: the CUDA kernel ``csrc/spmm_coo.cu``
and its plain version (port of ``combblas_tpu/ops/pallas/spmm_kernel.py``).

:func:`spmm_pallas` replaces the TPU kernel of the same name (K8): y = A @ X
(plus-times, float32) for a row-sorted SpCOO, any width d.  The TPU kernel
folded row runs inside 8-entry groups and carried the open run across
tiles; here the sorted stream's row pointer gives every row its entries, so
the kernel sums each row in registers and writes it once, and cuts a row of
more than ``piece_len`` entries at the bounds of fixed ranges of the stream,
summing the pieces in a second pass (``csrc/spmm_coo.cu``).
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["PIECE_LEN", "spmm_pallas", "spmm_coo_plain"]

#: Entries per chunk of the plain version: bounds its (chunk, d) products
#: (1.5 GB in float32 and float64 at d = 128).
_PLAIN_CHUNK = 1 << 20
#: Default entries per range of the kernel: rows longer than this are split.
PIECE_LEN = 256


def spmm_coo_plain(row_ptr, col, val, x) -> torch.Tensor:
    """Plain PyTorch version: gather X's rows at the entries' columns,
    scale, and ``index_add_`` into the entries' rows (from ``row_ptr``),
    adding the float32 products in float64 as the kernel does."""
    m = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(m, device=x.device), row_ptr[1:] - row_ptr[:-1],
        output_size=nnz)
    y = torch.zeros((m, x.shape[1]), dtype=torch.float64, device=x.device)
    for lo in range(0, nnz, _PLAIN_CHUNK):
        hi = min(lo + _PLAIN_CHUNK, nnz)
        prod = val[lo:hi, None] * x[col[lo:hi].long()]
        y.index_add_(0, rows[lo:hi], prod.double())
    return y.float()


def _spmm_coo(row_ptr, col, val, x, *, plain: bool,
              piece_len: int = PIECE_LEN) -> torch.Tensor:
    dev = x.device
    for name, t, dt, dim in (("row_ptr", row_ptr, torch.int64, 1),
                             ("col", col, torch.int32, 1),
                             ("val", val, torch.float32, 1),
                             ("x", x, torch.float32, 2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    if col.shape != val.shape:
        raise ValueError("col and val differ in length")
    if piece_len < 1:
        raise ValueError(f"piece_len must be >= 1, got {piece_len}")
    if dev.type == "cpu" or plain:
        return spmm_coo_plain(row_ptr, col, val, x)
    if dev.type != "cuda":
        raise ValueError(f"no SpMM kernel for device {dev}")
    m = row_ptr.shape[0] - 1
    d = x.shape[1]
    # the stream's capacity bounds nnz: ranges and scratch need no sync
    ranges = -(-col.shape[0] // piece_len)
    y = torch.empty((m, d), dtype=torch.float32, device=dev)
    part = torch.empty((2 * ranges, d), dtype=torch.float64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_spmm_coo(row_ptr.data_ptr(), col.data_ptr(),
                               val.data_ptr(), m, ranges, piece_len,
                               x.data_ptr(), d, part.data_ptr(),
                               y.data_ptr(), stream)
    _build.check(lib, err, "spmm_coo")
    LAUNCHES["spmm_coo"] += 1
    return y


def spmm_pallas(a: SpCOO, x: torch.Tensor, plain: bool = False
                ) -> torch.Tensor:
    """y = A @ X (plus-times) for a row-sorted SpCOO (its invariant); the
    result has X's dtype, computed in float32.  CPU tensors, or
    ``plain=True``, take :func:`spmm_coo_plain`; CUDA tensors launch
    ``csrc/spmm_coo.cu``, which splits rows of more than ``PIECE_LEN``
    entries."""
    y = _spmm_coo(a.row_ptr(), a.col, a.val.float().contiguous(),
                  x.float().contiguous(), plain=plain)
    return y.to(x.dtype)
