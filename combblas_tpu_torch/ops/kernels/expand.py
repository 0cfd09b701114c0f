"""ESC expansion: the CUDA kernel ``csrc/expand.cu`` and its plain version.

Counterpart of ``combblas_tpu/ops/pallas/expand_kernel.py``:
:func:`expand_chunks_compact` (int32 keys) replaces ``expand_chunks_compact``
(K1) and :func:`expand_chunks_compact_wide` (int64 keys) replaces
``expand_chunks_compact_wide`` (K3).  For every live A entry (i, k, a_ik), in
A-entry order, one product per entry (k, j, b_kj) of B's row k:
``key = i*stride + j`` and ``val = mul(a_ik, b_kj)`` in f32, compacted with
no gaps.  Slots past the total hold the key sentinel (INT32_MAX / INT64_MAX)
and 0.  Write offsets come from an exclusive scan of the per-entry counts
``b_rp[k+1] - b_rp[k]``, which replaces the TPU kernel's chunk table
(``build_chunk_meta``) and B's 128-lane tables.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build
from combblas_tpu_torch.semiring import Semiring

__all__ = ["expand_chunks_compact", "expand_chunks_compact_wide",
           "expand_plain", "KEY_SENTINEL"]

KEY_SENTINEL = {torch.int32: torch.iinfo(torch.int32).max,
                torch.int64: torch.iinfo(torch.int64).max}


def _entry_offsets(a_col, a_valid, b_rp):
    """Exclusive scan of per-A-entry product counts: int64[n_a + 1]."""
    kk = b_rp.shape[0] - 1
    acol = torch.clamp(a_col.long(), max=kk - 1)
    cnt = torch.where(a_valid, b_rp[acol + 1] - b_rp[acol], 0)
    offs = torch.zeros(cnt.shape[0] + 1, dtype=torch.int64,
                       device=cnt.device)
    torch.cumsum(cnt, 0, out=offs[1:])
    return offs


def expand_plain(a_row, a_col, a_val, offs, b_rp, b_col, b_val,
                 sr: Semiring, stride: int, out_key, out_val) -> None:
    """Plain PyTorch expansion (``repeat_interleave`` and a gather) into the
    pre-filled ``out_key`` / ``out_val``; products past their capacity are
    dropped."""
    n_a = a_row.shape[0]
    cnt = offs[1:] - offs[:-1]
    total = int(offs[-1])
    e = torch.repeat_interleave(torch.arange(n_a, device=a_row.device), cnt,
                                output_size=total)
    pos = torch.arange(total, device=a_row.device) - offs[:-1][e]
    bidx = b_rp[a_col[e].long()] + pos
    kd = out_key.dtype
    key = a_row[e].to(kd) * stride + b_col[bidx].to(kd)
    val = sr.mul(a_val[e], b_val[bidx])
    t = min(total, out_key.shape[0])
    out_key[:t] = key[:t]
    out_val[:t] = val[:t]


def _expand(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val, sr: Semiring,
            *, stride: int, stream_cap: int, key_dtype: torch.dtype,
            plain: bool):
    dev = a_row.device
    for name, t, dt in (("a_row", a_row, torch.int32),
                        ("a_col", a_col, torch.int32),
                        ("a_val", a_val, torch.float32),
                        ("a_valid", a_valid, torch.bool),
                        ("b_rp", b_rp, torch.int64),
                        ("b_col", b_col, torch.int32),
                        ("b_val", b_val, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a_row on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D")
    if stream_cap < 1:
        raise ValueError(f"stream_cap must be positive, got {stream_cap}")
    if not (a_row.shape == a_col.shape == a_val.shape == a_valid.shape):
        raise ValueError("A's row/col/val/valid differ in length")
    out_key = torch.full((stream_cap,), KEY_SENTINEL[key_dtype],
                         dtype=key_dtype, device=dev)
    out_val = torch.zeros(stream_cap, dtype=torch.float32, device=dev)
    offs = _entry_offsets(a_col, a_valid, b_rp)
    total = offs[-1]
    if dev.type == "cpu" or plain:
        expand_plain(a_row, a_col, a_val, offs, b_rp, b_col, b_val, sr,
                     stride, out_key, out_val)
        return out_key, out_val, total
    if dev.type != "cuda":
        raise ValueError(f"no expansion kernel for device {dev}")
    lib = _build.library()
    tag = "i32" if key_dtype == torch.int32 else "i64"
    fn = getattr(lib, f"cbt_expand_{tag}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_row.data_ptr(), a_col.data_ptr(), a_val.data_ptr(),
                 offs.data_ptr(), a_row.shape[0], b_rp.data_ptr(),
                 b_col.data_ptr(), b_val.data_ptr(), stride, sr.mul_code,
                 out_key.data_ptr(), out_val.data_ptr(), stream_cap, stream)
    _build.check(lib, err, f"expand_{tag}")
    LAUNCHES[f"expand_{tag}"] += 1
    return out_key, out_val, total


def expand_chunks_compact(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val,
                          sr: Semiring, *, stride: int, stream_cap: int,
                          plain: bool = False):
    """Compacted expansion with int32 keys ``a_row*stride + b_col`` (K1;
    seg2's windowed slabs call it with ``stride=0``).  The caller keeps
    ``(rows+1)*stride`` below 2^31.

    A is given as its entries (``a_valid`` masks the live ones), B as its
    row pointer ``b_rp`` (int64) and entry arrays.  Returns (key
    int32[stream_cap], val f32[stream_cap], total) with ``total`` a 0-d
    int64 tensor, the unclamped product count.  CPU tensors, or
    ``plain=True`` (the reference run), take :func:`expand_plain`; CUDA
    tensors launch ``csrc/expand.cu``."""
    return _expand(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val, sr,
                   stride=stride, stream_cap=stream_cap,
                   key_dtype=torch.int32, plain=plain)


def expand_chunks_compact_wide(a_row, a_col, a_val, a_valid, b_rp, b_col,
                               b_val, sr: Semiring, *, stride: int,
                               stream_cap: int, plain: bool = False):
    """Compacted expansion with int64 keys ``a_row*stride + b_col`` (K3).
    With ``stride = n+1`` the key orders exactly as the pair (row, col) of
    the JAX kernel's two int32 streams.  Same contract as
    :func:`expand_chunks_compact`."""
    return _expand(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val, sr,
                   stride=stride, stream_cap=stream_cap,
                   key_dtype=torch.int64, plain=plain)
