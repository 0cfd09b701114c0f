"""Degree-sorted ELL-8 fold: the CUDA kernel ``csrc/ell.cu`` and its plain
version.

One kernel for two TPU kernels: :func:`ell_fold` with ``op="sum"`` replaces
``combblas_tpu/ops/pallas/spmm_ell.py:_spmm_ell_call`` (K6; the ELL-8 plan
is the blocked plan with one block) and, with ``op="sum"`` or ``"max"``,
``combblas_tpu/ops/pallas/spmm_ell_blocked.py:_ell_blocked_call`` (K7).

The plan holds, per position p, 8 entries ``(cols[p, i], vals[p, i])``, one
per row ``g*8 + i`` of the group that owns p, and per group g and column
block cb one run of positions ``run_start[g, cb] .. + run_len[g, cb]``.
Row ``g*8 + i`` of the output folds ``vals[p, i] * X[cb*bs_c + cols[p, i]]``
over the positions of all of g's runs, starting from 0: a sum, or a max
from 0 (the TPU kernel zeroes its output and accumulator).  ELL padding
slots (col 0, val 0) take part, as on the TPU.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["ell_fold", "ell_fold_plain"]

_OPS = {"sum": 0, "max": 1}
#: Positions per chunk of the plain version: bounds its (chunk, 8, d)
#: product tensor (256 MB at d = 128).
_PLAIN_CHUNK = 1 << 16


def ell_fold_plain(cols, vals, run_start, run_len, x, *, bs_c: int,
                   op: str) -> torch.Tensor:
    """Plain PyTorch fold: every run's positions are listed with
    ``repeat_interleave``, their rows of X gathered and scaled, and folded
    into Y with ``index_add_`` (sum, of the float32 products in float64,
    as the kernel adds) or ``scatter_reduce_`` (``amax`` with the
    zero-filled Y included)."""
    groups, nb = run_start.shape
    d = x.shape[1]
    dev = x.device
    y = torch.zeros((groups * 8, d), device=dev,
                    dtype=torch.float64 if op == "sum" else torch.float32)
    lens = run_len.reshape(-1).long()
    total = int(lens.sum())
    run = torch.repeat_interleave(torch.arange(groups * nb, device=dev), lens,
                                  output_size=total)
    pos = (torch.arange(total, device=dev) - (torch.cumsum(lens, 0)
                                              - lens)[run]
           + run_start.reshape(-1).long()[run])
    eight = torch.arange(8, device=dev)
    for lo in range(0, total, _PLAIN_CHUNK):
        hi = min(lo + _PLAIN_CHUNK, total)
        p, r = pos[lo:hi], run[lo:hi]
        src = cols[p].long() + (r % nb * bs_c)[:, None]         # (k, 8)
        prod = (vals[p][..., None] * x[src]).reshape(-1, d)      # (k*8, d)
        dst = ((r // nb)[:, None] * 8 + eight).reshape(-1)
        if op == "sum":
            y.index_add_(0, dst, prod.double())
        else:
            y.scatter_reduce_(0, dst[:, None].expand(-1, d), prod,
                              reduce="amax", include_self=True)
    return y.float()


def ell_fold(cols, vals, run_start, run_len, x, *, bs_c: int,
             op: str = "sum", plain: bool = False) -> torch.Tensor:
    """Y (G*8, d) float32 from the ELL-8 plan and X (rows, d) float32.

    ``cols`` int32 and ``vals`` float32 are (P, 8), ``run_start`` and
    ``run_len`` int32 (G, nb), all contiguous on X's device.  CPU tensors,
    or ``plain=True``, take :func:`ell_fold_plain`; CUDA tensors launch
    ``csrc/ell.cu``.  The caller keeps every column ``cb*bs_c + col`` of a
    run inside X."""
    if op not in _OPS:
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    dev = x.device
    for name, t, dt, dim in (("cols", cols, torch.int32, 2),
                             ("vals", vals, torch.float32, 2),
                             ("run_start", run_start, torch.int32, 2),
                             ("run_len", run_len, torch.int32, 2),
                             ("x", x, torch.float32, 2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    if cols.shape != vals.shape or cols.shape[1] != 8:
        raise ValueError(f"cols/vals must be (P, 8), got {tuple(cols.shape)} "
                         f"and {tuple(vals.shape)}")
    if run_start.shape != run_len.shape:
        raise ValueError("run_start and run_len differ in shape")
    if dev.type == "cpu" or plain:
        return ell_fold_plain(cols, vals, run_start, run_len, x, bs_c=bs_c,
                              op=op)
    if dev.type != "cuda":
        raise ValueError(f"no ELL kernel for device {dev}")
    groups, nb = run_start.shape
    d = x.shape[1]
    y = torch.empty((groups * 8, d), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_ell_fold(cols.data_ptr(), vals.data_ptr(),
                               run_start.data_ptr(), run_len.data_ptr(),
                               groups, nb, bs_c, x.data_ptr(), d,
                               _OPS[op], y.data_ptr(), stream)
    _build.check(lib, err, f"ell_{op}")
    LAUNCHES[f"ell_{op}"] += 1
    return y
