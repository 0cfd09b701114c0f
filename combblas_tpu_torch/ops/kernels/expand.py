"""ESC expansion: the CUDA kernels ``csrc/expand.cu`` and their plain
versions.

Counterpart of ``combblas_tpu/ops/pallas/expand_kernel.py``:
:func:`expand_chunks_compact` (int32 keys) replaces ``expand_chunks_compact``
(K1), :func:`expand_chunks_compact_wide` (int64 keys) replaces
``expand_chunks_compact_wide`` (K3) and :func:`expand_chunks` (int32 keys,
chunk-padded) replaces ``expand_chunks`` (K5).  For every live A entry
(i, k, a_ik), in A-entry order, one product per entry (k, j, b_kj) of B's
row k: ``key = i*stride + j`` and ``val = mul(a_ik, b_kj)`` in f32.  The
compacted kernels write the products with no gaps; K5 gives each A entry
``ceil(cnt/128)`` whole 128-slot chunks.  Every slot no product reaches holds
the key sentinel (INT32_MAX / INT64_MAX) and 0.  Write offsets come from an
exclusive scan of the per-entry counts (or chunk counts, for K5), which
replaces the TPU kernels' chunk table (``build_chunk_meta``) and B's
128-lane tables.  The kernels write every slot of the stream, pads
included, so their outputs are allocated with ``torch.empty``: K1 and K3
from a merge-path split of the entries against the slots (``EXPAND_TILE``
merge items a tile), K5 from one of the entries against the chunks
(``EXPAND_CHUNKS_TILE`` merge items a tile, one warp a chunk).
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build
from combblas_tpu_torch.semiring import Semiring

__all__ = ["expand_chunks_compact", "expand_chunks_compact_wide",
           "expand_chunks", "expand_plain", "expand_chunks_plain",
           "KEY_SENTINEL", "CH", "EXPAND_TILE", "EXPAND_CHUNKS_TILE"]

KEY_SENTINEL = {torch.int32: torch.iinfo(torch.int32).max,
                torch.int64: torch.iinfo(torch.int64).max}
#: Slots per chunk of the chunk-padded stream (the TPU's lane width).
CH = 128
#: Merge items (A entries and stream slots) per tile of K1/K3, as
#: ``csrc/expand.cu`` kTile; a tile holds at most this many of each.
EXPAND_TILE = 1024
#: Merge items (A entries and 128-slot chunks) per tile of K5, as
#: ``csrc/expand.cu`` kChunkTile.
EXPAND_CHUNKS_TILE = 128


def _entry_counts(a_col, a_valid, b_rp):
    """Products of each A entry: int64[n_a], 0 for dead entries."""
    kk = b_rp.shape[0] - 1
    acol = torch.clamp(a_col.long(), max=kk - 1)
    return torch.where(a_valid, b_rp[acol + 1] - b_rp[acol], 0)


def _plain_products(a_row, a_col, a_val, cnt, b_rp, b_col, b_val,
                    sr: Semiring, stride: int, key_dtype):
    """Every product in A-entry order (``repeat_interleave`` and a gather):
    (key, val, its A entry, its position in that entry's B row)."""
    dev = a_row.device
    total = int(cnt.sum())
    e = torch.repeat_interleave(torch.arange(a_row.shape[0], device=dev),
                                cnt, output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(total, device=dev) - start[e]
    bidx = b_rp[a_col[e].long()] + pos
    key = a_row[e].to(key_dtype) * stride + b_col[bidx].to(key_dtype)
    return key, sr.mul(a_val[e], b_val[bidx]), e, pos


def expand_plain(a_row, a_col, a_val, cnt, b_rp, b_col, b_val,
                 sr: Semiring, stride: int, out_key, out_val) -> None:
    """Plain PyTorch compacted expansion into the pre-filled ``out_key`` /
    ``out_val``; products past their capacity are dropped."""
    key, val, _e, _pos = _plain_products(a_row, a_col, a_val, cnt, b_rp,
                                         b_col, b_val, sr, stride,
                                         out_key.dtype)
    t = min(key.shape[0], out_key.shape[0])
    out_key[:t] = key[:t]
    out_val[:t] = val[:t]


def expand_chunks_plain(a_row, a_col, a_val, cnt, b_rp, b_col, b_val,
                        sr: Semiring, stride: int, out_key, out_val) -> None:
    """Plain PyTorch chunk-padded expansion (K5) into the pre-filled
    ``out_key`` / ``out_val``: A entry e's product l lands in slot
    ``128 * ch_start[e] + l``; slots past the capacity are dropped."""
    key, val, e, pos = _plain_products(a_row, a_col, a_val, cnt, b_rp,
                                       b_col, b_val, sr, stride,
                                       out_key.dtype)
    nch = -(-cnt // CH)
    slot = CH * (torch.cumsum(nch, 0) - nch)[e] + pos
    keep = slot < out_key.shape[0]
    out_key[slot[keep]] = key[keep]
    out_val[slot[keep]] = val[keep]


def _check_inputs(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val):
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
    if not (a_row.shape == a_col.shape == a_val.shape == a_valid.shape):
        raise ValueError("A's row/col/val/valid differ in length")


def _expand(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val, sr: Semiring,
            *, stride: int, stream_cap: int, key_dtype: torch.dtype,
            plain: bool):
    _check_inputs(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val)
    if stream_cap < 1:
        raise ValueError(f"stream_cap must be positive, got {stream_cap}")
    dev = a_row.device
    if dev.type == "cpu" or plain:
        cnt = _entry_counts(a_col, a_valid, b_rp)
        total = cnt.sum()
        out_key = torch.full((stream_cap,), KEY_SENTINEL[key_dtype],
                             dtype=key_dtype, device=dev)
        out_val = torch.zeros(stream_cap, dtype=torch.float32, device=dev)
        expand_plain(a_row, a_col, a_val, cnt, b_rp, b_col, b_val, sr,
                     stride, out_key, out_val)
        return out_key, out_val, total
    if dev.type != "cuda":
        raise ValueError(f"no expansion kernel for device {dev}")
    lib = _build.library()
    n_a = a_row.shape[0]
    tag = "i32" if key_dtype == torch.int32 else "i64"
    # the kernel writes every slot, pads included; the outputs come first,
    # so that they take the blocks a caller freed just before for them
    out_key = torch.empty(stream_cap, dtype=key_dtype, device=dev)
    out_val = torch.empty(stream_cap, dtype=torch.float32, device=dev)
    # write offsets (each entry's product count from a kernel, then a scan)
    # and each entry's B row start
    offs = torch.empty(n_a + 1, dtype=torch.int64, device=dev)
    bstart = torch.empty(n_a, dtype=torch.int64, device=dev)
    splits = torch.empty(-(-(n_a + stream_cap) // EXPAND_TILE) + 1,
                         dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_expand_counts(a_col.data_ptr(), a_valid.data_ptr(),
                                    n_a, b_rp.data_ptr(), offs.data_ptr(),
                                    bstart.data_ptr(), stream)
        _build.check(lib, err, f"expand_{tag} counts")
        offs[1:].cumsum_(0)
        err = getattr(lib, f"cbt_expand_{tag}")(
            a_row.data_ptr(), a_val.data_ptr(), offs.data_ptr(), n_a,
            bstart.data_ptr(), b_col.data_ptr(), b_val.data_ptr(), stride,
            sr.mul_code, splits.data_ptr(), out_key.data_ptr(),
            out_val.data_ptr(), stream_cap, stream)
    _build.check(lib, err, f"expand_{tag}")
    LAUNCHES[f"expand_{tag}"] += 1
    return out_key, out_val, offs[-1]


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


def expand_chunks(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val,
                  sr: Semiring, *, stride: int, chunk_cap: int,
                  plain: bool = False):
    """Chunk-padded expansion with int32 keys ``a_row*stride + b_col`` (K5).

    A entry e's products fill ``ceil(cnt_e/128)`` consecutive 128-slot
    chunks from chunk ``ch_start[e]`` (the exclusive scan of the chunk
    counts in A-entry order); slots past a chunk's products and the dummy
    chunks up to ``chunk_cap`` hold INT32_MAX / 0, and chunks past
    ``chunk_cap`` are dropped.  The caller keeps ``(rows+1)*stride`` below
    2^31.  Returns (key int32[chunk_cap*128], val f32[chunk_cap*128]),
    equal to the JAX ``expand_chunks`` stream slot for slot.  CPU tensors,
    or ``plain=True`` (the reference run), take :func:`expand_chunks_plain`;
    CUDA tensors launch ``csrc/expand.cu``."""
    _check_inputs(a_row, a_col, a_val, a_valid, b_rp, b_col, b_val)
    if chunk_cap < 1:
        raise ValueError(f"chunk_cap must be positive, got {chunk_cap}")
    dev = a_row.device
    slots = chunk_cap * CH
    if dev.type == "cpu" or plain:
        out_key = torch.full((slots,), KEY_SENTINEL[torch.int32],
                             dtype=torch.int32, device=dev)
        out_val = torch.zeros(slots, dtype=torch.float32, device=dev)
        expand_chunks_plain(a_row, a_col, a_val,
                            _entry_counts(a_col, a_valid, b_rp), b_rp, b_col,
                            b_val, sr, stride, out_key, out_val)
        return out_key, out_val
    if dev.type != "cuda":
        raise ValueError(f"no expansion kernel for device {dev}")
    lib = _build.library()
    n_a = a_row.shape[0]
    # the kernel writes every slot, pads and dummy chunks included; the
    # outputs come first, so that they take the blocks a caller freed just
    # before for them
    out_key = torch.empty(slots, dtype=torch.int32, device=dev)
    out_val = torch.empty(slots, dtype=torch.float32, device=dev)
    # chunk offsets (each entry's chunk count from a kernel, then a scan),
    # each entry's B row start and product count
    ch_offs = torch.empty(n_a + 1, dtype=torch.int64, device=dev)
    bstart = torch.empty(n_a, dtype=torch.int64, device=dev)
    blen = torch.empty(n_a, dtype=torch.int64, device=dev)
    splits = torch.empty(-(-(n_a + chunk_cap) // EXPAND_CHUNKS_TILE) + 1,
                         dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_expand_chunk_counts(
            a_col.data_ptr(), a_valid.data_ptr(), n_a, b_rp.data_ptr(),
            ch_offs.data_ptr(), bstart.data_ptr(), blen.data_ptr(), stream)
        _build.check(lib, err, "expand_chunks_i32 counts")
        ch_offs[1:].cumsum_(0)
        err = lib.cbt_expand_chunks_i32(
            a_row.data_ptr(), a_val.data_ptr(), ch_offs.data_ptr(), n_a,
            bstart.data_ptr(), blen.data_ptr(), b_col.data_ptr(),
            b_val.data_ptr(), stride, sr.mul_code, splits.data_ptr(),
            out_key.data_ptr(), out_val.data_ptr(), chunk_cap, stream)
    _build.check(lib, err, "expand_chunks_i32")
    LAUNCHES["expand_chunks_i32"] += 1
    return out_key, out_val
