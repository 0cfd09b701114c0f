"""Compress of a key-sorted stream: the CUDA kernels ``csrc/compress.cu``
and their plain version.

Counterpart of ``combblas_tpu/ops/pallas/compress_kernel.py``:
:func:`compress_sorted_packed` (int32 keys) replaces
``compress_sorted_packed_pallas`` (K2) and :func:`compress_sorted_wide`
(int64 keys ``row*stride + col``, split back into (row, col)) replaces
``compress_sorted_wide_pallas`` (K4); :func:`compress_sorted_wide_keys` is
K4 without the split.  One logical pass: each run of equal keys folds with
the semiring add in f32, sentinel keys are dropped wherever they stand, and
the survivors are compacted.  ``nnz`` saturates at ``out_capacity`` and
survivors past it are dropped (the retry / truncation signal); entries past
``nnz`` are sentinel / 0.  On the card one pass over tiles of
``COMPRESS_TILE`` elements writes the survivors at offsets from a
decoupled look-back and a second launch writes the pads from the ``nnz`` it
reads on the device, so the outputs are allocated with ``torch.empty`` and
nothing waits on the host.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build
from combblas_tpu_torch.ops.kernels.expand import KEY_SENTINEL
from combblas_tpu_torch.semiring import Semiring

__all__ = ["compress_sorted_packed", "compress_sorted_wide_keys",
           "compress_sorted_wide", "compress_plain", "COMPRESS_TILE"]

#: Elements per tile of the compress kernel, as ``csrc/compress.cu`` kTile.
COMPRESS_TILE = 1024


def compress_plain(key, val, sr: Semiring, out_key, out_val) -> torch.Tensor:
    """Plain PyTorch compress (run-head mask, ``cumsum``,
    ``scatter_reduce``) into the pre-filled ``out_key`` / ``out_val``.
    Returns the saturated survivor count as a 0-d int64 tensor."""
    n = key.shape[0]
    cap = out_key.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    run = torch.cumsum(head, 0) - 1
    if sr.add_kind == "sum":
        red = torch.zeros(n, dtype=torch.float32, device=key.device)
        red.scatter_reduce_(0, run, val, reduce="sum")
    else:
        red = sr.zero(torch.float32).to(key.device).repeat(n)
        red.scatter_reduce_(0, run, val,
                            reduce="amin" if sr.add_kind == "min" else "amax")
    run_key = key[head]
    keep = run_key != KEY_SENTINEL[key.dtype]
    k_out = run_key[keep]
    v_out = red[:run_key.shape[0]][keep]
    t = min(k_out.shape[0], cap)
    out_key[:t] = k_out[:t]
    out_val[:t] = v_out[:t]
    return torch.tensor(t, dtype=torch.int64, device=key.device)


def _compress(key, val, sr: Semiring, *, out_capacity: int, plain: bool):
    dev = key.device
    if key.dtype not in KEY_SENTINEL:
        raise TypeError(f"keys must be int32 or int64, got {key.dtype}")
    if val.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {val.dtype}")
    if val.device != dev:
        raise ValueError(f"val is on {val.device}, key on {dev}")
    if key.dim() != 1 or key.shape != val.shape:
        raise ValueError("key and val must be 1-D of one length")
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError("key and val must be contiguous")
    if key.shape[0] < 1:
        raise ValueError("empty stream")
    if out_capacity < 1:
        raise ValueError(f"out_capacity must be positive, got {out_capacity}")
    if dev.type == "cpu" or plain:
        out_key = torch.full((out_capacity,), KEY_SENTINEL[key.dtype],
                             dtype=key.dtype, device=dev)
        out_val = torch.zeros(out_capacity, dtype=torch.float32, device=dev)
        nnz = compress_plain(key, val, sr, out_key, out_val)
        return out_key, out_val, nnz
    if dev.type != "cuda":
        raise ValueError(f"no compress kernel for device {dev}")
    lib = _build.library()
    tag = "i32" if key.dtype == torch.int32 else "i64"
    n = key.shape[0]
    # the kernels write every slot: survivors, then pads from nnz on
    out_key = torch.empty(out_capacity, dtype=key.dtype, device=dev)
    out_val = torch.empty(out_capacity, dtype=torch.float32, device=dev)
    # tile counter, nnz, one look-back status word per tile
    state = torch.zeros(2 + -(-n // COMPRESS_TILE), dtype=torch.int64,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"cbt_compress_{tag}")(
            key.data_ptr(), val.data_ptr(), n, sr.add_code,
            out_key.data_ptr(), out_val.data_ptr(), out_capacity,
            state.data_ptr(), stream)
    _build.check(lib, err, f"compress_{tag}")
    LAUNCHES[f"compress_{tag}"] += 1
    return out_key, out_val, state[1]


def compress_sorted_packed(key, val, sr: Semiring, *, out_capacity: int,
                           plain: bool = False):
    """Compress a sorted int32-key stream (pads INT32_MAX) into (out_key
    int32[out_capacity], out_val f32[out_capacity], nnz) (K2).  CPU
    tensors, or ``plain=True`` (the reference run), take
    :func:`compress_plain`; CUDA tensors launch ``csrc/compress.cu``."""
    if key.dtype != torch.int32:
        raise TypeError(f"packed keys must be int32, got {key.dtype}")
    return _compress(key, val, sr, out_capacity=out_capacity, plain=plain)


def compress_sorted_wide_keys(key, val, sr: Semiring, *, out_capacity: int,
                              plain: bool = False):
    """Compress a sorted int64-key stream (pads INT64_MAX) into (out_key
    int64[out_capacity], out_val f32[out_capacity], nnz): the K4 kernel
    alone, keys left packed.  The digest, which reads only values and nnz,
    calls this."""
    if key.dtype != torch.int64:
        raise TypeError(f"wide keys must be int64, got {key.dtype}")
    return _compress(key, val, sr, out_capacity=out_capacity, plain=plain)


def compress_sorted_wide(key, val, sr: Semiring, *, out_capacity: int,
                         stride: int, plain: bool = False):
    """Compress a sorted int64-key stream ``key = row*stride + col`` (pads
    INT64_MAX) and split the survivors back into (row, col) (K4).  Returns
    (row int32, col int32, val f32, nnz); entries past nnz are INT32_MAX /
    INT32_MAX / 0, as the JAX kernel leaves them."""
    okey, oval, nnz = compress_sorted_wide_keys(
        key, val, sr, out_capacity=out_capacity, plain=plain)
    # survivors are never the sentinel, and every slot past nnz is
    live = okey != KEY_SENTINEL[torch.int64]
    sent = torch.iinfo(torch.int32).max
    row = torch.where(live, okey // stride, sent).to(torch.int32)
    col = torch.where(live, okey % stride, sent).to(torch.int32)
    return row, col, oval, nnz
