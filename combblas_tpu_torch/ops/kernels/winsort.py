"""Stable window sort of the row-classed digest (K10): the CUDA kernels
``csrc/winsort.cu`` and their plain version.

The classed digest (``ops/spgemm_seg.py``) lays each slab's rows out as
windows, class after class, and sorts each window by column key before K2
folds the buffer.  :func:`window_sort` forms that buffer straight from K1's
stream: window ``w`` of the table ``(start, lens, dest, width)`` takes the
stream's ``lens[w]`` products from ``start[w]``, stably sorted by key (equal
keys keep their stream order), at ``dest[w]`` of the buffer, followed by
the key sentinel and 0 up to ``width[w]``.  The table lists the windows in
class order (ascending width), so one class is one contiguous range of it.
No TPU kernel does this: the JAX package leaves it to XLA's sort, as the
plain version leaves it to ``torch.sort(dim=1, stable=True)`` and a value
gather.

On the card, windows up to :data:`NARROW_MAX` wide are sorted whole in
shared memory, one block a window (one launch per width range of
:data:`NARROW_CAPS`); the wider ones by a tiled LSD radix sort whose every
pass spreads :data:`WINSORT_TILE`-product tiles of all of them over the
card.  Only the key's low ``key_bits`` bits are sorted, in passes of at most
8 bits, the 4-byte values moving with their keys.

:func:`row_window_sort` is the same sort keyed by row, for the compacted
expansion streams of K1 (packed int32 keys) and K3 (int64 keys) that the
kernel routes of ``ops/spgemm.py`` sort: each row's products lie together
in the stream, rows ascending (A's entries in row order, as ``SpCOO``
keeps them), so a stable sort of each row's window by ``key - row *
stride`` (its column) is the stable sort of the whole stream.  The windows
come from the stream itself (:func:`row_bounds`), stay in place, one a row,
and the stream is sorted in place: rows of one product and the sentinel
tail past the products are not touched.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build
from combblas_tpu_torch.ops.kernels.expand import KEY_SENTINEL

__all__ = ["window_sort", "window_sort_plain", "key_bits", "regimes",
           "row_window_sort", "row_bounds", "row_sort_shapes",
           "NARROW_MAX", "NARROW_CAPS", "WINSORT_TILE", "TAIL_CHUNK",
           "SCAN_TILE"]

#: Widest window the narrow kernels sort in shared memory, as
#: ``csrc/winsort.cu`` kNarrowMax.
NARROW_MAX = 16384
#: Width limits of the narrow kernels' instances, one launch each.
NARROW_CAPS = (512, 4096, NARROW_MAX)
#: Products per tile of the wide passes, as ``csrc/winsort.cu`` kTile.
WINSORT_TILE = 16384
#: Sentinel slots per chunk of the wide windows' tails (kTailChunk).
TAIL_CHUNK = 16384
#: Entries per block of the wide passes' offset scan (kScanTile).
SCAN_TILE = 4096
_MAX_BINS = 256


def key_bits(n_cols: int) -> int:
    """Key bits a sort of column ids below ``n_cols`` needs (at least 1)."""
    return max((n_cols - 1).bit_length(), 1)


def regimes(classes: tuple, s_caps: tuple) -> list:
    """The launches of a plan's classes: (cap, first window, end window)
    for each run of classes that one narrow instance takes (``cap`` in
    :data:`NARROW_CAPS`), then (None, first, end) for the wide classes."""
    out = []
    w = 0
    for L, S in zip(classes, s_caps):
        cap = next((c for c in NARROW_CAPS if L <= c), None)
        if out and out[-1][0] == cap:
            out[-1][2] += S
        else:
            out.append([cap, w, w + S])
        w += S
    return [tuple(g) for g in out]


def window_sort_plain(colstream, valstream, table, *, classes: tuple,
                      s_caps: tuple):
    """Plain PyTorch window sort: each class's windows gathered from the
    stream by the table and sorted by ``torch.sort(dim=1, stable=True)``
    straight into the class's slice of the buffer, the values gathered by
    its permutation.  The table's windows lie end to end in its order (as
    the classed digest's window table lays them), so a class's slice is one
    (windows, width) view and ``dest`` is not read."""
    start, lens, _dest, _width = table
    dev = colstream.device
    padded = sum(S * L for S, L in zip(s_caps, classes))
    cat_k = torch.empty(padded, dtype=torch.int32, device=dev)
    cat_v = torch.empty(padded, dtype=valstream.dtype, device=dev)
    w0 = off = 0
    for S, L in zip(s_caps, classes):
        # each class's windows and permutation go before the next class's
        n = S * L
        j = torch.arange(L, device=dev)
        keep = j < lens[w0:w0 + S, None]
        idx = torch.where(keep, start[w0:w0 + S, None] + j, 0)
        col2d = torch.where(keep, colstream[idx], KEY_SENTINEL[torch.int32])
        val2d = torch.where(keep, valstream[idx], 0.0)
        del idx, keep
        perm = torch.empty((S, L), dtype=torch.int64, device=dev)
        torch.sort(col2d, dim=1, stable=True,
                   out=(cat_k[off:off + n].view(S, L), perm))
        del col2d
        torch.gather(val2d, 1, perm, out=cat_v[off:off + n].view(S, L))
        del val2d, perm
        w0 += S
        off += n
    return cat_k, cat_v


def _check(colstream, valstream, table, classes, s_caps):
    dev = colstream.device
    if colstream.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {colstream.dtype}")
    if colstream.dim() != 1 or valstream.shape != colstream.shape:
        raise ValueError("colstream and valstream must be 1-D of one length")
    if not (colstream.is_contiguous() and valstream.is_contiguous()):
        raise ValueError("colstream and valstream must be contiguous")
    if len(classes) != len(s_caps) or list(classes) != sorted(classes):
        raise ValueError("classes must ascend, one s_cap each")
    n_win = sum(s_caps)
    for name, t in zip(("start", "lens", "dest", "width"), table):
        if t.device != dev or valstream.device != dev:
            raise ValueError(f"{name} is on {t.device}, the stream on {dev}")
        if t.dtype != torch.int64 or t.shape != (n_win,):
            raise ValueError(f"{name} must be int64[{n_win}], got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def window_sort(colstream, valstream, table, *, classes: tuple,
                s_caps: tuple, key_bits: int, plain: bool = False):
    """The class buffer (cat_k int32[padded], cat_v[padded]) of a slab from
    its stream and window table (K10).

    ``table`` is (start, lens, dest, width), int64 per window in class
    order, ``classes`` / ``s_caps`` the plan's widths and window counts
    (``padded`` = sum of their products).  Keys must lie below
    ``2**key_bits``.  CPU tensors, or ``plain=True`` (the reference run),
    take :func:`window_sort_plain`; CUDA tensors launch
    ``csrc/winsort.cu``, which takes 4-byte values only and
    overwrites the wide windows' lanes of the stream when ``key_bits`` >
    16 (a ping-pong buffer of the sort's passes): the stream is the
    caller's to drop."""
    _check(colstream, valstream, table, classes, s_caps)
    dev = colstream.device
    if plain or dev.type == "cpu":
        return window_sort_plain(colstream, valstream, table,
                                 classes=classes, s_caps=s_caps)
    if dev.type != "cuda":
        raise ValueError(f"no window sort kernel for device {dev}")
    if valstream.element_size() != 4:
        raise TypeError(f"values must be 4 bytes, got {valstream.dtype}")
    if not 1 <= key_bits <= 31:
        raise ValueError(f"key_bits must be in [1, 31], got {key_bits}")
    if colstream.shape[0] >= 2**31:
        raise ValueError("the stream must hold fewer than 2^31 slots")
    lib = _build.library()
    start, lens, dest, width = table
    padded = sum(S * L for S, L in zip(s_caps, classes))
    # every slot is written once: live lanes sorted, tails, dead windows
    cat_k = torch.empty(padded, dtype=torch.int32, device=dev)
    cat_v = torch.empty(padded, dtype=valstream.dtype, device=dev)
    groups = regimes(classes, s_caps)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the narrow windows first: the wide passes may overwrite the stream
        for cap, w0, w1 in groups:
            if cap is None or w1 == w0:
                continue
            err = lib.cbt_winsort_narrow(
                colstream.data_ptr(), valstream.data_ptr(),
                start[w0:].data_ptr(), lens[w0:].data_ptr(),
                dest[w0:].data_ptr(), width[w0:].data_ptr(), w1 - w0, cap,
                key_bits, cat_k.data_ptr(), cat_v.data_ptr(), stream)
            _build.check(lib, err, "winsort_narrow")
            LAUNCHES["winsort_narrow"] += 1
        cap, w0, w1 = groups[-1] if groups else (0, 0, 0)
        if cap is None and w1 > w0:
            wide = [(L, S) for L, S in zip(classes, s_caps) if L > NARROW_MAX]
            max_tiles = sum(S * -(-L // WINSORT_TILE) for L, S in wide)
            max_chunks = sum(S * -(-L // TAIL_CHUNK) for L, S in wide)
            max_scan_tiles = -(-max_tiles * _MAX_BINS // SCAN_TILE)
            passes = -(-key_bits // 8)
            scratch_k = scratch_v = None
            if passes > 1:
                scratch_k = torch.empty_like(colstream)
                scratch_v = torch.empty_like(valstream)
            cums = torch.empty(2, w1 - w0 + 1, dtype=torch.int64, device=dev)
            wins = torch.empty(max_tiles + max_chunks, dtype=torch.int32,
                               device=dev)
            hist = torch.empty(max_tiles * _MAX_BINS, dtype=torch.int32,
                               device=dev)
            state = torch.zeros(passes * (1 + max_scan_tiles),
                                dtype=torch.int64, device=dev)
            err = lib.cbt_winsort_wide(
                colstream.data_ptr(), valstream.data_ptr(),
                start[w0:].data_ptr(), lens[w0:].data_ptr(),
                dest[w0:].data_ptr(), width[w0:].data_ptr(), w1 - w0,
                key_bits,
                None if scratch_k is None else scratch_k.data_ptr(),
                None if scratch_v is None else scratch_v.data_ptr(),
                cums[0].data_ptr(), cums[1].data_ptr(), wins.data_ptr(),
                wins[max_tiles:].data_ptr(), max_tiles, max_chunks,
                hist.data_ptr(), state.data_ptr(), max_scan_tiles,
                cat_k.data_ptr(), cat_v.data_ptr(), stream)
            _build.check(lib, err, "winsort_wide")
            LAUNCHES["winsort_wide"] += 1
    return cat_k, cat_v


# -- keyed by row ---------------------------------------------------------

def row_sort_shapes(n_rows: int, stream_len: int) -> dict:
    """The launch shapes of :func:`row_window_sort` for a stream of
    ``stream_len`` slots over ``n_rows`` rows, from the host's sizes alone
    (no sync): ``narrow``, bounds on the rows of 2 to 512, 513 to 4096 and
    4097 to :data:`NARROW_MAX` live products (a row of more than ``lo``
    takes ``lo + 1`` slots); ``wide``, on the wider rows; ``tiles``, on
    their :data:`WINSORT_TILE` tiles (a row's last tile may be partial)."""
    narrow = tuple(min(n_rows, stream_len // (lo + 1))
                   for lo in (1,) + NARROW_CAPS[:-1])
    wide = min(n_rows, stream_len // (NARROW_MAX + 1))
    return dict(narrow=narrow, wide=wide,
                tiles=stream_len // WINSORT_TILE + wide if wide else 0)


def row_bounds(key, rows: int, stride: int):
    """Each row's window of the stream: int64[rows + 1], row r's products
    at [bounds[r], bounds[r + 1]).  bounds[r] is the first slot whose key
    reaches ``r * stride``, by binary search: the stream need not be
    sorted, only hold every key below ``r * stride`` (the rows before r)
    ahead of the others, which rows in ascending order do."""
    q = torch.arange(rows + 1, dtype=key.dtype, device=key.device) * stride
    return torch.searchsorted(key, q)


def row_window_sort(key, val, *, rows: int, stride: int, key_bits: int):
    """Sort a compacted expansion stream in place, each row's window by
    column (K10 keyed by row), and return it.

    ``key``: int32 or int64 ``row * stride + column`` for rows below
    ``rows`` and columns below ``2**key_bits``, each row's products
    together, rows ascending, the slots past them at the key sentinel;
    ``val`` moves with it.  The windows are :func:`row_bounds`'.  The
    result equals ``torch.sort(key, stable=True)`` and ``val`` gathered by
    its order, slot for slot, which is the plain route: ``ops/spgemm.py``
    takes that library sort for CPU tensors and ``plain=True``.  CUDA
    tensors only; it launches ``csrc/winsort.cu`` (4-byte values only): one
    partition of the rows by width, the three narrow instances and, for
    rows past :data:`NARROW_MAX`, the wide passes (at least two, through
    stream-sized scratch), with the launch shapes of
    :func:`row_sort_shapes`.  Nothing syncs with the host."""
    dev = key.device
    if key.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"keys must be int32 or int64, got {key.dtype}")
    if key.dim() != 1 or val.shape != key.shape:
        raise ValueError("key and val must be 1-D of one length")
    if not (key.is_contiguous() and val.is_contiguous()):
        raise ValueError("key and val must be contiguous")
    if val.device != dev:
        raise ValueError(f"val is on {val.device}, key on {dev}")
    if not 1 <= key_bits <= 31:
        raise ValueError(f"key_bits must be in [1, 31], got {key_bits}")
    if rows * stride > torch.iinfo(key.dtype).max:
        raise ValueError(f"{rows} rows of stride {stride} overflow "
                         f"{key.dtype} keys")
    if dev.type != "cuda":
        raise ValueError(f"no window sort kernel for device {dev}")
    if val.element_size() != 4:
        raise TypeError(f"values must be 4 bytes, got {val.dtype}")
    n = key.shape[0]
    if n >= 2**31 or rows >= 2**31:
        raise ValueError("the stream and the rows must be fewer than 2^31")
    bounds = row_bounds(key, rows, stride)
    shapes = row_sort_shapes(rows, n)
    wide, tiles = shapes["wide"], shapes["tiles"]
    passes = max(-(-key_bits // 8), 2)
    scan_tiles = -(-tiles * _MAX_BINS // SCAN_TILE)
    lib = _build.library()
    zeroed = torch.zeros(4 + 3 * wide + passes * (1 + scan_tiles),
                         dtype=torch.int64, device=dev)
    lists = torch.empty(3 * rows, dtype=torch.int32, device=dev)
    tile_win = torch.empty(tiles, dtype=torch.int32, device=dev)
    hist = torch.empty(tiles * _MAX_BINS, dtype=torch.int32, device=dev)
    cums = torch.empty(2 * (wide + 1), dtype=torch.int64, device=dev)
    # scratch a, then b from the third pass on
    lanes = (2 if passes > 2 else 1) * n if wide else 0
    scratch_k = torch.empty(lanes, dtype=torch.int32, device=dev)
    scratch_v = torch.empty(lanes, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_winsort_rows(
            key.data_ptr(), int(key.dtype == torch.int64), val.data_ptr(),
            bounds.data_ptr(), rows, n, stride, key_bits,
            *shapes["narrow"], wide, tiles, scan_tiles, zeroed.data_ptr(),
            lists.data_ptr(), tile_win.data_ptr(), hist.data_ptr(),
            cums.data_ptr(), scratch_k.data_ptr(), scratch_v.data_ptr(),
            stream)
    _build.check(lib, err, "winsort_rows")
    LAUNCHES["winsort_rows"] += 1
    return key, val
