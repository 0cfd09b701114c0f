"""Local semiring SpGEMM, C = A ·_sr B (port of
``combblas_tpu/ops/spgemm.py``).

The ESC scheme (expand -> sort -> compress) throughout; the sort is
``torch.sort(stable=True)`` where JAX used ``lax.sort``, except on the card,
where a compacted stream (K1 or K3) is sorted one row's window at a time by
the window sort's keyed-by-row form (K10,
:func:`.kernels.winsort.row_window_sort`), to the same stream.  Routes, by
the JAX names:

- ``spgemm`` / ``spgemm_rowchunked``: plain PyTorch ESC for any value type
  (the JAX package's non-Pallas path); ``spgemm_dense``: densify, multiply,
  re-sparsify.
- ``spgemm_pallas``: packed int32 keys ``row*(n+1)+col`` through the
  expansion kernel (K1 ``expand_chunks_compact`` with ``stream_cap``, K5
  ``expand_chunks`` without), the sort and the compress kernel K2.
  ``spgemm_wide`` (JAX ``spgemm_pallas_wide``): int64 keys, K3 and K4.
- ``spgemm_pallas_rowchunked`` / ``spgemm_pallas_streamed``: equal-flops row
  slabs of A through the narrow or wide route, assembled or digested.
- ``spgemm_auto``: the host-driven dispatcher with a caller-held plan.

The kernel routes launch the hand-written CUDA kernels of :mod:`.kernels`
for CUDA tensors and run their plain versions for CPU tensors (or with
``plain=True``).  Counts and keys that JAX split across int32 limbs or
streams are plain int64 here.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO, sort_compress
from combblas_tpu_torch.ops.kernels.compress import (
    compress_sorted_packed,
    compress_sorted_wide,
    compress_sorted_wide_keys,
)
from combblas_tpu_torch.ops.kernels.expand import (
    CH,
    expand_chunks,
    expand_chunks_compact,
    expand_chunks_compact_wide,
)
from combblas_tpu_torch.ops.kernels.expand import (
    _entry_counts as _products_per_entry,
)
from combblas_tpu_torch.ops.kernels.winsort import key_bits, row_window_sort
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring
from combblas_tpu_torch.utils.timers import span

__all__ = ["spgemm", "spgemm_flops", "spgemm_bounds", "spgemm_rowchunked",
           "spgemm_dense", "spgemm_pallas", "spgemm_pallas_bounds",
           "spgemm_pallas_rowchunked", "spgemm_wide", "spgemm_pallas_streamed",
           "spgemm_auto", "expand_products", "round_capacity_frac",
           "stream_capacity", "SORT_ELEM_LIMIT", "SpGEMMSortLimitError",
           "check_sort_limit"]

#: Largest sort stream a plan may ask for.  Same value as the JAX package's
#: XLA stable-sort bound so that plans match; ``torch.sort`` itself is not
#: the limit.
SORT_ELEM_LIMIT = 1 << 30


class SpGEMMSortLimitError(ValueError):
    """A single sort stage would exceed :data:`SORT_ELEM_LIMIT`."""


def check_sort_limit(n_elems: int, what: str = "sort stream",
                     limit: int = SORT_ELEM_LIMIT) -> None:
    if n_elems > limit:
        raise SpGEMMSortLimitError(
            f"{what} of {n_elems} elements exceeds the sort limit ({limit}); "
            "use spgemm_auto / seg2 slabbing or lower flops_cap")


def spgemm_flops(a: SpCOO, b: SpCOO) -> int:
    """Exact number of semiring multiplications for A·B, as one int64 sum
    (port of ``spgemm_flops``; no 16-bit limbs)."""
    return int(_entry_counts(a, b.row_ptr()).sum())


def round_capacity_frac(n: int, frac: int = 8) -> int:
    """Round up to the next 1/frac-of-a-power-of-two step."""
    n = max(n, 8)
    step = max((1 << int(np.floor(np.log2(n)))) // frac, 8)
    return -(-n // step) * step


def stream_capacity(flops: int, tile: int = 32768) -> int:
    """Expansion stream capacity for ``flops`` products: the JAX package's
    staging slack and ``tile`` rounding (kept so that plans match)."""
    need = flops + 17 * 128
    return max(-(-need // tile) * tile, tile)


def _slab_extract(a: SpCOO, k: int, bounds: torch.Tensor, s: int, *,
                  span_cap: int, slab_nnz_cap: int):
    """A's entries of rows [bounds[s], bounds[s+1]), rows rebased slab-local.
    Returns (sub SpCOO of shape (span_cap, k), row_lo); pads are
    (span_cap, k, 0).  Two device binary searches, no host sync."""
    row_lo = bounds[s]
    row_hi = bounds[s + 1]
    lohi = torch.searchsorted(a.row, torch.stack([row_lo, row_hi]).to(
        a.row.dtype))
    lohi = torch.minimum(lohi, a.nnz)
    lo, hi = lohi[0], lohi[1]
    t = torch.arange(slab_nnz_cap, device=a.device)
    src = torch.clamp(lo + t, max=a.capacity - 1)
    sel = t < (hi - lo)
    sub = SpCOO(
        row=torch.where(sel, torch.clamp(a.row[src] - row_lo, max=span_cap),
                        span_cap).to(torch.int32),
        col=torch.where(sel, a.col[src], k).to(torch.int32),
        val=torch.where(sel, a.val[src], torch.zeros((), dtype=a.val.dtype,
                                                     device=a.device)),
        nnz=(hi - lo).to(torch.int64),
        shape=(span_cap, k),
    )
    return sub, row_lo


def _entry_counts(a: SpCOO, b_rp: torch.Tensor) -> torch.Tensor:
    """Products of each of A's entries (int64, 0 past nnz)."""
    return _products_per_entry(a.col, a.mask(), b_rp)


def _out_cap(out_capacity: int) -> int:
    """The compress kernels' output length for ``out_capacity``."""
    return max(-(-out_capacity // 128) * 128, 2048)


# -- the ESC route for any value type -----------------------------------

def expand_products(a_row, a_col, a_val, a_valid, b_col, b_val, rp_lo,
                    rp_hi, sr: Semiring, flops_cap: int,
                    out_sentinels):
    """Every product (i, j, v) of A's live entries with B's rows, in
    A-entry order: the first ``flops_cap`` of them, the rest of the
    ``flops_cap`` slots ``(m_sent, n_sent, 0)``.  ``rp_lo/rp_hi`` give B row
    k's entry range.  Returns (i int32, j int32, v, total) with ``total`` the
    unclamped product count (0-d int64).  Written as ``repeat_interleave``
    and a gather; A's values keep their type (the JAX forward fill carries
    them through float32 / int32)."""
    m_sent, n_sent = out_sentinels
    dev = a_row.device
    acol = torch.clamp(a_col.long(), max=rp_lo.shape[0] - 1)
    lo = rp_lo[acol]
    cnt = torch.where(a_valid, rp_hi[acol] - lo, 0)
    offs = torch.cumsum(cnt, 0)
    start = offs - cnt
    total = offs[-1]
    # each entry's run cut at the cap, so only kept products are formed
    kept = torch.clamp(torch.clamp(offs, max=flops_cap) - start, min=0)
    n_kept = min(int(total), flops_cap)
    e = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), kept,
                                output_size=n_kept)
    bidx = lo[e] + torch.arange(n_kept, device=dev) - start[e]
    v = sr.mul(a_val[e], b_val[bidx])
    i = torch.full((flops_cap,), m_sent, dtype=torch.int32, device=dev)
    j = torch.full((flops_cap,), n_sent, dtype=torch.int32, device=dev)
    vout = torch.zeros(flops_cap, dtype=v.dtype, device=dev)
    i[:n_kept] = a_row[e]
    j[:n_kept] = b_col[bidx]
    vout[:n_kept] = v
    return i, j, vout, total


def _expand(a: SpCOO, b: SpCOO, b_rp, sr: Semiring, flops_cap: int):
    """:func:`expand_products` for whole operands."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {a.shape} x {b.shape}")
    return expand_products(a.row, a.col, a.val, a.mask(), b.col, b.val,
                           b_rp[:-1], b_rp[1:], sr, flops_cap, (m, n))


def spgemm(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
           flops_cap: int, out_capacity: int) -> SpCOO:
    """Single-pass ESC SpGEMM for any value type.  ``flops_cap`` must bound
    the product count (:func:`spgemm_bounds`); products past it are
    dropped."""
    check_sort_limit(flops_cap, "ESC expansion sort")
    i, j, v, total = _expand(a, b, b.row_ptr(), sr, flops_cap)
    return sort_compress(i, j, v, total, (a.shape[0], b.shape[1]), sr=sr,
                         out_capacity=out_capacity)


def spgemm_bounds(a: SpCOO, b: SpCOO):
    """(flops_cap, out_capacity) for :func:`spgemm`: the exact product
    count rounded to a 1/8-power-of-two step, twice."""
    cap = round_capacity_frac(spgemm_flops(a, b))
    return cap, cap


def _slab_bounds_host(a: SpCOO, b: SpCOO, num_slabs: int):
    """(flops_cap, slab_rows) for :func:`spgemm_rowchunked`: uniform row
    slabs and the next power of two of the heaviest slab's products."""
    m = a.shape[0]
    slab_rows = -(-m // num_slabs)
    a_rp = a.row_ptr().cpu().numpy()
    coffs = np.concatenate(
        [[0], np.cumsum(_entry_counts(a, b.row_ptr()).cpu().numpy())])
    worst = 0
    for s in range(num_slabs):
        lo = a_rp[min(s * slab_rows, m)]
        hi = a_rp[min((s + 1) * slab_rows, m)]
        worst = max(worst, int(coffs[hi] - coffs[lo]))
    cap = max(8, 1 << int(np.ceil(np.log2(max(worst, 1)))))
    return cap, slab_rows


def spgemm_rowchunked(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                      num_slabs: int, slab_rows: int, flops_cap: int,
                      out_capacity: int) -> SpCOO:
    """Memory-bounded ESC SpGEMM over uniform row slabs of A, one after the
    other (``lax.map`` in JAX), each with a ``flops_cap``-slot expansion.
    Slabs own disjoint output rows in increasing order, so each slab's
    compressed entries are scattered straight to their final positions; the
    scatter drops entries past ``out_capacity`` and ``nnz`` saturates
    there."""
    m, _k = a.shape
    n = b.shape[1]
    dev = a.device
    b_rp, a_rp = b.row_ptr(), a.row_ptr()
    slab_out_cap = flops_cap  # a slab's nnz <= its products <= flops_cap
    t = torch.arange(a.capacity, device=dev)
    pos = torch.arange(slab_out_cap, device=dev)
    vdt = sr.mul(a.val[:0], b.val[:0]).dtype
    out_row = torch.full((out_capacity + 1,), m, dtype=torch.int32,
                         device=dev)
    out_col = torch.full((out_capacity + 1,), n, dtype=torch.int32,
                         device=dev)
    out_val = torch.zeros(out_capacity + 1, dtype=vdt, device=dev)
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(num_slabs):
        lo = a_rp[min(s * slab_rows, m)]
        hi = a_rp[min((s + 1) * slab_rows, m)]
        # A's entry range [lo, hi) at the front of a capacity-sized window
        src = torch.clamp(lo + t, max=a.capacity - 1)
        sub = SpCOO(row=a.row[src], col=a.col[src], val=a.val[src],
                    nnz=hi - lo, shape=a.shape)
        i, j, v, total = _expand(sub, b, b_rp, sr, flops_cap)
        c = sort_compress(i, j, v, total, (m, n), sr=sr,
                          out_capacity=slab_out_cap)
        dest = prefix + pos
        dest = torch.where((pos < c.nnz) & (dest < out_capacity), dest,
                           out_capacity)
        out_row.scatter_(0, dest, c.row)
        out_col.scatter_(0, dest, c.col)
        out_val.scatter_(0, dest, c.val)
        prefix = prefix + c.nnz
    return SpCOO(row=out_row[:out_capacity], col=out_col[:out_capacity],
                 val=out_val[:out_capacity],
                 nnz=torch.clamp(prefix, max=out_capacity), shape=(m, n))


def spgemm_dense(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                 out_capacity: int) -> SpCOO:
    """Dense-fallback SpGEMM: densify, multiply, re-sparsify.  PLUS_TIMES
    is a float32 ``torch.matmul`` and OR_AND a matmul of the nonzero
    patterns; other semirings reduce over k in blocks of 512 (the last block
    starts at k - 512, as ``dynamic_slice`` clamps it).  Products that fold
    to exactly 0 are dropped.  ``nnz`` counts every nonzero cell, even past
    ``out_capacity``, as in the JAX package."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {a.shape} x {b.shape}")
    dev = a.device
    ad, bd = a.to_dense(), b.to_dense()
    if sr.name == "plus_times":
        cd = torch.matmul(ad.float(), bd.float())
    elif sr.name == "or_and":
        cd = (torch.matmul((ad != 0).float(), (bd != 0).float())
              > 0).to(a.val.dtype)
    else:
        zero = sr.zero(torch.result_type(ad, bd)).to(dev)
        am, bm = ad != 0, bd != 0
        chunk = max(1, min(k, 512))
        cd = zero.repeat(m, n)
        for c in range(-(-k // chunk)):
            lo = min(c * chunk, k - chunk)
            sl = slice(lo, lo + chunk)
            prod = torch.where(am[:, sl, None] & bm[None, sl, :],
                               sr.mul(ad[:, sl, None], bd[None, sl, :]),
                               zero)
            if sr.add_kind == "sum":
                cd = cd + prod.sum(1)
            elif sr.add_kind == "min":
                cd = torch.minimum(cd, prod.amin(1))
            else:
                cd = torch.maximum(cd, prod.amax(1))
        cd = torch.where(cd == zero, torch.zeros_like(cd), cd)
    flat = cd.reshape(-1)
    nz = flat != 0
    dest = torch.cumsum(nz, 0) - 1
    nnz = torch.clamp(dest[-1] + 1, min=0)
    dest = torch.where(nz & (dest < out_capacity), dest, out_capacity)
    lin = torch.arange(m * n, device=dev)
    out_row = torch.full((out_capacity + 1,), m, dtype=torch.int32,
                         device=dev)
    out_row.scatter_(0, dest, (lin // n).to(torch.int32))
    out_col = torch.full((out_capacity + 1,), n, dtype=torch.int32,
                         device=dev)
    out_col.scatter_(0, dest, (lin % n).to(torch.int32))
    out_val = torch.zeros(out_capacity + 1, dtype=cd.dtype, device=dev)
    out_val.scatter_(0, dest, flat)
    return SpCOO(row=out_row[:out_capacity], col=out_col[:out_capacity],
                 val=out_val[:out_capacity], nnz=nnz.to(torch.int64),
                 shape=(m, n))


# -- the kernel routes (JAX "pallas") -----------------------------------

def _chunk_count(a: SpCOO, b: SpCOO) -> int:
    """Number of 128-slot chunks in K5's stream for A·B."""
    return int((-(-_entry_counts(a, b.row_ptr()) // CH)).sum())


def spgemm_pallas_bounds(a: SpCOO, b: SpCOO):
    """(chunk_cap, out_capacity) for :func:`spgemm_pallas`: chunk_cap is a
    multiple of 256, as in the JAX package, so stream lengths match."""
    nch = _chunk_count(a, b)
    chunk_cap = max(-(-round_capacity_frac(max(nch, 256)) // 256) * 256, 256)
    return chunk_cap, round_capacity_frac(spgemm_flops(a, b))


def _expand_sort(a: SpCOO, b: SpCOO, sr: Semiring, *,
                 stream_cap: int | None, chunk_cap: int | None = None,
                 wide: bool = False, b_rp: torch.Tensor | None = None,
                 plain: bool = False):
    """Expand A·B with keys ``row*(n+1)+col`` and sort the stream by key.
    ``wide``: int64 keys, compacted (K3).  Otherwise int32 keys, so
    ``(m+1)*(n+1) < 2^31``: compacted (K1) with ``stream_cap``, chunk-padded
    (K5) over ``chunk_cap`` chunks without it.  A compacted stream on the
    card is sorted by rows' windows (:func:`row_window_sort`, which needs
    A's live entries in row order, as ``SpCOO`` keeps them); K5's stream,
    whose pads lie inside rows, CPU tensors and ``plain=True`` take
    ``torch.sort``.  Returns (key, val, stride)."""
    check_sort_limit(stream_cap if stream_cap is not None
                     else chunk_cap * CH, "expansion stream sort")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {a.shape} x {b.shape}")
    stride = n + 1
    if not wide and (m + 1) * stride >= 1 << 31:
        raise ValueError(f"packed keys of a {m} x {n} product overflow int32;"
                         " use spgemm_wide")
    if b_rp is None:
        b_rp = b.row_ptr()
    args = (a.row, a.col, a.val, a.mask(), b_rp, b.col, b.val, sr)
    with span("spgemm.expand", a.row):
        if wide:
            key, val, _total = expand_chunks_compact_wide(
                *args, stride=stride, stream_cap=stream_cap, plain=plain)
        elif stream_cap is not None:
            key, val, _total = expand_chunks_compact(
                *args, stride=stride, stream_cap=stream_cap, plain=plain)
        else:
            key, val = expand_chunks(*args, stride=stride,
                                     chunk_cap=chunk_cap, plain=plain)
    with span("spgemm.sort", key):
        if stream_cap is not None and key.is_cuda and not plain:
            key, val = row_window_sort(key, val, rows=m, stride=stride,
                                       key_bits=key_bits(n))
        else:
            key, order = torch.sort(key, stable=True)
            val = val[order]
    return key, val, stride


def spgemm_pallas(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                  chunk_cap: int, out_capacity: int,
                  stream_cap: int | None = None,
                  b_rp: torch.Tensor | None = None,
                  plain: bool = False) -> SpCOO:
    """Narrow ESC SpGEMM on the kernels: packed int32 keys, so
    ``(m+1)*(n+1) < 2^31``, and float32 values.  With ``stream_cap`` (from
    :func:`stream_capacity` of the product count) the compacted expansion
    K1 runs and the sort sees exactly the products plus a sentinel tail;
    without it the chunk-padded expansion K5 runs over ``chunk_cap`` chunks.
    Then ``torch.sort`` and the compress kernel K2 into
    ``max(ceil128(out_capacity), 2048)`` slots; past ``nnz`` the rows are m,
    the columns n and the values 0.  ``plain=True`` runs the kernels' plain
    versions (the reference run)."""
    m, n = a.shape[0], b.shape[1]
    key, val, stride = _expand_sort(a, b, sr, stream_cap=stream_cap,
                                    chunk_cap=chunk_cap, b_rp=b_rp,
                                    plain=plain)
    with span("spgemm.compress", key):
        okey, oval, nnz = compress_sorted_packed(
            key, val, sr, out_capacity=_out_cap(out_capacity), plain=plain)
    live = torch.arange(okey.shape[0], device=okey.device) < nnz
    return SpCOO(
        row=torch.clamp(okey // stride, max=m).to(torch.int32),
        col=torch.where(live, torch.clamp(okey % stride, max=n),
                        n).to(torch.int32),
        val=oval.to(a.val.dtype),
        nnz=nnz,
        shape=(m, n),
    )


def spgemm_wide(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                out_capacity: int, stream_cap: int,
                b_rp: torch.Tensor | None = None,
                plain: bool = False) -> SpCOO:
    """Wide-key ESC SpGEMM (port of ``spgemm_pallas_wide``): int64 keys
    ``row*(n+1)+col`` through the expansion kernel, one ``torch.sort``, and
    the compress kernel.  ``stream_cap`` must cover A·B's products.
    ``plain=True`` runs the kernels' plain versions (the reference run)."""
    m, n = a.shape[0], b.shape[1]
    key, val, stride = _expand_sort(a, b, sr, stream_cap=stream_cap,
                                    wide=True, b_rp=b_rp, plain=plain)
    with span("spgemm.compress", key):
        orow, ocol, oval, nnz = compress_sorted_wide(
            key, val, sr, out_capacity=_out_cap(out_capacity),
            stride=stride, plain=plain)
    # slots past nnz hold INT32_MAX, which the clamps turn into the (m, n)
    # pads; live columns are < n already
    return SpCOO(
        row=torch.clamp(orow, max=m),
        col=torch.clamp(ocol, max=n),
        val=oval.to(a.val.dtype),
        nnz=nnz,
        shape=(m, n),
    )


def _row_flops_cum_f32(a: SpCOO, b: SpCOO) -> torch.Tensor:
    """(m,) float32 inclusive cumsum of per-row product counts: the JAX
    balance curve for equal-flops slab boundaries (exact below 2^24; the
    per-row counts are summed exactly before the cast)."""
    m = a.shape[0]
    rows = torch.where(a.mask(), a.row.long(), m)
    rowfl = torch.zeros(m + 1, dtype=torch.int64, device=a.device)
    rowfl.index_add_(0, rows, _entry_counts(a, b.row_ptr()))
    return torch.cumsum(rowfl[:m].to(torch.float32), 0)


def _equal_flops_bounds(a: SpCOO, b: SpCOO, num_slabs: int) -> torch.Tensor:
    """Equal-flops row boundaries (num_slabs+1,) int64 from the float32
    balance curve and float32 targets, as the JAX package computes them."""
    m = a.shape[0]
    cum = _row_flops_cum_f32(a, b)
    tgt = (torch.arange(1, num_slabs, dtype=torch.float32, device=a.device)
           * cum[-1]) / num_slabs
    mid = torch.searchsorted(cum, tgt) + 1
    edge = torch.tensor([0, m], dtype=torch.int64, device=a.device)
    return torch.cat([edge[:1], torch.clamp(mid, max=m), edge[1:]])


def _slab_stats(a: SpCOO, b: SpCOO, bounds: torch.Tensor, num_slabs: int):
    """Exact int64 per-slab (nnz, chunks, flops) for row boundaries
    ``bounds`` (int64, on A's device)."""
    m = a.shape[0]
    valid = a.mask()
    cnt = _entry_counts(a, b.row_ptr())
    sid = torch.searchsorted(bounds, torch.clamp(a.row.long(), max=m),
                             right=True) - 1
    sid = torch.where(valid, torch.clamp(sid, 0, num_slabs), num_slabs)

    def per_slab(x):
        out = torch.zeros(num_slabs + 1, dtype=torch.int64, device=a.device)
        return out.index_add_(0, sid, x)[:num_slabs].cpu().numpy()

    return per_slab(valid.long()), per_slab(-(-cnt // CH)), per_slab(cnt)


def _pallas_slab_plan(a: SpCOO, b: SpCOO, num_slabs: int,
                      wide: bool = False):
    """Host slab plan, the JAX package's: equal-flops boundaries, split
    further so no slab spans more rows than packed keys allow (unless
    ``wide``) and replanned while a slab has 2^30 or more products; uniform
    capacities.  Returns (bounds np.int32 (S+1,), span_cap, slab_nnz_cap,
    chunk_cap, worst_fl)."""
    with span("spgemm.plan", a.row):
        m = a.shape[0]
        n = b.shape[1]
        span_max = m if wide else max((1 << 31) // (n + 1) - 2, 1)
        num_slabs = max(1, min(num_slabs, m))
        for _ in range(8):
            cut = _equal_flops_bounds(a, b, num_slabs).cpu().numpy()
            out = [0]
            for s in range(len(cut) - 1):
                hi = int(cut[s + 1])
                while hi - out[-1] > span_max:
                    out.append(out[-1] + span_max)
                if hi > out[-1]:
                    out.append(hi)
            bounds = np.asarray(out, np.int32)
            nnz_s, ch_s, fl_s = _slab_stats(
                a, b, torch.as_tensor(bounds.astype(np.int64),
                                      device=a.device), len(bounds) - 1)
            if int(fl_s.max(initial=0)) < 1 << 30:
                break
            num_slabs = max(num_slabs * 2, len(bounds))
        worst_nnz = int(nnz_s.max(initial=1))
        worst_ch = int(ch_s.max(initial=1))
        worst_fl = int(fl_s.max(initial=1))
        widest = int((bounds[1:] - bounds[:-1]).max(initial=1))
        span_cap = min(round_capacity_frac(max(widest, 8)), m, span_max)
        span_cap = max(span_cap, widest)  # never below the actual max span
        slab_nnz_cap = round_capacity_frac(max(worst_nnz, 8))
        chunk_cap = max(
            -(-round_capacity_frac(max(worst_ch, 256)) // 256) * 256, 256)
        return bounds, span_cap, slab_nnz_cap, chunk_cap, max(worst_fl, 1)


def _pallas_slab_step(a: SpCOO, b: SpCOO, b_rp, bounds, s: int, state,
                      sr: Semiring, *, span_cap: int, slab_nnz_cap: int,
                      chunk_cap: int, slab_out_cap: int, stream_cap: int,
                      out_capacity: int, wide: bool = False,
                      plain: bool = False):
    """One slab of :func:`spgemm_pallas_rowchunked`: A's rows [bounds[s],
    bounds[s+1]) rebased slab-local, multiplied through the narrow or wide
    route, and the slab's whole ``slab_out_cap`` buffer (live entries, then
    (m, n, 0) pads) written at ``start = min(total, out_capacity)`` of the
    output buffers, in place (JAX's ``dynamic_update_slice``; reading
    ``total`` is the one host sync of a slab).  The next slab overwrites the
    pad suffix.  ``state = (row, col, val, total, truncated)``."""
    m, k = a.shape
    n = b.shape[1]
    dst_row, dst_col, dst_val, total, truncated = state
    with span("spgemm.slab", a.row):
        with span("spgemm.extract"):
            sub, row_lo = _slab_extract(a, k, bounds, s, span_cap=span_cap,
                                        slab_nnz_cap=slab_nnz_cap)
        if wide:
            c = spgemm_wide(sub, b, sr, out_capacity=slab_out_cap,
                            stream_cap=stream_cap, b_rp=b_rp, plain=plain)
        else:
            c = spgemm_pallas(sub, b, sr, chunk_cap=chunk_cap,
                              out_capacity=slab_out_cap,
                              stream_cap=stream_cap, b_rp=b_rp, plain=plain)
        with span("spgemm.assemble"):
            live = torch.arange(c.capacity, device=a.device) < c.nnz
            out = slice(min(int(total), out_capacity),
                        min(int(total), out_capacity) + c.capacity)
            dst_row[out] = torch.where(live, c.row + row_lo.to(torch.int32),
                                       m)
            dst_col[out] = torch.where(live, c.col, n)
            dst_val[out] = torch.where(live, c.val, torch.zeros_like(c.val))
    return (dst_row, dst_col, dst_val, total + c.nnz,
            truncated | (c.nnz >= slab_out_cap))


def spgemm_pallas_rowchunked(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES,
                             *, num_slabs: int, out_capacity: int,
                             wide: bool = False,
                             plain: bool = False) -> SpCOO:
    """Memory-bounded kernel SpGEMM over equal-flops row slabs of A
    (:func:`_pallas_slab_plan`), each through :func:`spgemm_pallas` with a
    compacted stream (or :func:`spgemm_wide` when ``wide``), appended in
    row order.  The result has ``out_capacity + slab_out_cap`` slots (the
    last slab's pad suffix lands past ``out_capacity``); ``nnz`` is
    ``out_capacity`` when any slab or the total overflowed."""
    m, _k = a.shape
    n = b.shape[1]
    dev = a.device
    bounds, span_cap, slab_nnz_cap, chunk_cap, worst_fl = \
        _pallas_slab_plan(a, b, num_slabs, wide=wide)
    num_slabs = len(bounds) - 1
    if not wide and (span_cap + 1) * (n + 1) >= 1 << 31:
        raise ValueError(f"slab span {span_cap} x {n} overflows packed keys")
    slab_out_cap = _out_cap(max(round_capacity_frac(
        min(worst_fl, max(2 * out_capacity // num_slabs, 2048))), 2048))
    slab_stream_cap = stream_capacity(worst_fl)
    cap_slack = out_capacity + slab_out_cap
    state = (torch.full((cap_slack,), m, dtype=torch.int32, device=dev),
             torch.full((cap_slack,), n, dtype=torch.int32, device=dev),
             torch.zeros(cap_slack, dtype=a.val.dtype, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    bounds_dev = torch.as_tensor(bounds.astype(np.int64), device=dev)
    b_rp = b.row_ptr()
    for s in range(num_slabs):
        state = _pallas_slab_step(
            a, b, b_rp, bounds_dev, s, state, sr, span_cap=span_cap,
            slab_nnz_cap=slab_nnz_cap, chunk_cap=chunk_cap,
            slab_out_cap=slab_out_cap, stream_cap=slab_stream_cap,
            out_capacity=out_capacity, wide=wide, plain=plain)
    row, col, val, total, truncated = state
    total = torch.clamp(torch.where(truncated, out_capacity, total),
                        max=out_capacity)
    return SpCOO(row=row, col=col, val=val, nnz=total, shape=(m, n))


def _slab_digest_step(a: SpCOO, b: SpCOO, b_rp, bounds, s: int, state,
                      sr: Semiring, *, span_cap: int, slab_nnz_cap: int,
                      slab_out_cap: int, stream_cap: int, wide: bool = False,
                      plain: bool = False):
    """One slab of the streamed digest (port of
    ``_pallas_slab_digest_step``): form the slab's C block as
    :func:`spgemm_pallas` (compacted stream, packed int32 keys) or, with
    ``wide``, :func:`spgemm_wide` does, fold it into ``state = (nnz int64,
    checksum f32, truncated bool)`` and drop it.  The fold reads only
    values and nnz, so the keys are never split into (row, col).  All on
    the device."""
    k = a.shape[1]
    compress = compress_sorted_wide_keys if wide else compress_sorted_packed
    with span("spgemm.slab", a.row):
        with span("spgemm.extract"):
            sub, _row_lo = _slab_extract(a, k, bounds, s, span_cap=span_cap,
                                         slab_nnz_cap=slab_nnz_cap)
        key, val, _stride = _expand_sort(sub, b, sr, stream_cap=stream_cap,
                                         wide=wide, b_rp=b_rp, plain=plain)
        with span("spgemm.compress"):
            _okey, oval, nnz = compress(key, val, sr,
                                        out_capacity=_out_cap(slab_out_cap),
                                        plain=plain)
        # entries past nnz hold 0, so the plain sum is the live sum
        cs = oval.sum()
    nnz_total, checksum, truncated = state
    return (nnz_total + nnz, checksum + cs,
            truncated | (nnz >= slab_out_cap))


def spgemm_pallas_streamed(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                           num_slabs: int, wide: bool = False,
                           slab_out_cap: int | None = None,
                           plain: bool = False):
    """Slab-streamed SpGEMM for products whose assembled C need not be
    resident: each equal-flops slab's C block is formed, folded into the
    digest and released.  Returns (nnz int, checksum float, truncated
    bool)."""
    bounds, span_cap, slab_nnz_cap, _chunk_cap, worst_fl = \
        _pallas_slab_plan(a, b, num_slabs, wide=wide)
    if slab_out_cap is None:
        slab_out_cap = round_capacity_frac(max(worst_fl, 2048))
    slab_out_cap = _out_cap(slab_out_cap)
    slab_stream_cap = stream_capacity(worst_fl)
    dev = a.device
    state = (torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros((), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    bounds_dev = torch.as_tensor(bounds.astype(np.int64), device=dev)
    b_rp = b.row_ptr()
    for s in range(len(bounds) - 1):
        state = _slab_digest_step(
            a, b, b_rp, bounds_dev, s, state, sr, span_cap=span_cap,
            slab_nnz_cap=slab_nnz_cap, slab_out_cap=slab_out_cap,
            stream_cap=slab_stream_cap, wide=wide, plain=plain)
    nnz, checksum, truncated = state
    return int(nnz), float(checksum), bool(truncated)


# -- the dispatcher ------------------------------------------------------

def _kernel_ok(a: SpCOO, b: SpCOO) -> bool:
    """Whether the kernel routes apply (JAX ``_pallas_backend_ok``): float32
    values on both sides.  The device is not asked: the routes run the
    kernels on CUDA tensors and their plain versions on CPU tensors."""
    return a.val.dtype == torch.float32 and b.val.dtype == torch.float32


def spgemm_auto(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                max_flops_cap: int = 1 << 24, out_capacity: int | None = None,
                nnz_estimate: int | None = None,
                plan: dict | None = None, plain: bool = False) -> SpCOO:
    """Host-driven dispatcher: single pass when the expansion fits, row
    slabs otherwise, with estimate-and-retry output sizing.

    The output is sized from ``nnz_estimate`` (default: half the products,
    at most the dense cell count) and the multiply is retried with a doubled
    buffer while compression reports it full (nnz == capacity).  Routes, as
    on a TPU: ``pallas`` (one :func:`spgemm_pallas` call, compacted stream)
    and ``pallas_slabs`` (:func:`spgemm_pallas_rowchunked`, narrow or wide)
    for float32 values; ``sort`` (:func:`spgemm`) and ``rowchunked``
    (:func:`spgemm_rowchunked`) otherwise.

    ``plan``: a caller-held dict that freezes the route and capacities.
    While the operands' capacities and shapes match and the product count
    stays within ``[flops_ok/64, flops_ok]``, later calls reuse it; a fresh
    plan freezes 1.5x the current products (and chunk headroom) when a dict
    is given.  ``plain=True`` runs the kernel routes' plain versions (the
    reference run)."""
    max_flops_cap = min(max_flops_cap, SORT_ELEM_LIMIT)
    dense_cells = a.shape[0] * b.shape[1]
    with span("spgemm.call", a.row):
        with span("spgemm.plan"):
            key = (int(a.capacity), int(b.capacity), a.shape, b.shape,
                   out_capacity, id(sr))
            flops_exact = spgemm_flops(a, b)
            if not (plan is not None and plan.get("key") == key
                    and flops_exact <= plan["flops_ok"]
                    and flops_exact * 64 >= plan["flops_ok"]):
                plan = _fresh_plan(a, b, plan, key, flops_exact,
                                   max_flops_cap, out_capacity, nnz_estimate)
        out_cap = plan["out_cap"]
        while True:
            with span("spgemm.attempt"):
                if plan["kind"] == "pallas":
                    c = spgemm_pallas(
                        a, b, sr, chunk_cap=plan["chunk_cap"],
                        out_capacity=out_cap, stream_cap=plan["scap"],
                        plain=plain)
                elif plan["kind"] == "pallas_slabs":
                    c = spgemm_pallas_rowchunked(
                        a, b, sr, num_slabs=plan["num_slabs"],
                        out_capacity=out_cap, wide=plan["wide"], plain=plain)
                elif plan["kind"] == "sort":
                    check_sort_limit(plan["flops_cap"], "ESC expansion")
                    c = spgemm(a, b, sr, flops_cap=plan["flops_cap"],
                               out_capacity=out_cap)
                else:
                    slab_cap, slab_rows = _slab_bounds_host(
                        a, b, plan["num_slabs"])
                    c = spgemm_rowchunked(
                        a, b, sr, num_slabs=plan["num_slabs"],
                        slab_rows=slab_rows, flops_cap=slab_cap,
                        out_capacity=out_cap)
                full = int(c.nnz) >= out_cap
            if not full or out_cap >= min(plan["oc"], max(dense_cells, 8)):
                return c
            out_cap = round_capacity_frac(out_cap * 2)
            plan["out_cap"] = out_cap


def _fresh_plan(a: SpCOO, b: SpCOO, plan: dict | None, key, flops_exact: int,
                max_flops_cap: int, out_capacity: int | None,
                nnz_estimate: int | None) -> dict:
    """:func:`spgemm_auto`'s plan for these operands, written into ``plan``
    when the caller holds one."""
    m, n = a.shape[0], b.shape[1]
    held = plan is not None
    # a held plan is reused at every later call: 1.5x headroom on products
    froz_fl = round_capacity_frac(
        max(flops_exact, 8) * 3 // 2 if held else max(flops_exact, 8))
    flops_cap = round_capacity_frac(max(flops_exact, 8))
    if out_capacity is not None:
        out_cap = out_capacity
    else:
        est = nnz_estimate if nnz_estimate is not None else max(
            flops_cap // 2, 8)
        out_cap = round_capacity_frac(
            int(min(est, flops_cap, max(m * n, 8))))
    fresh = dict(key=key, flops_ok=froz_fl, out_cap=out_cap, oc=flops_cap,
                 kind="sort", flops_cap=round_capacity_frac(froz_fl))
    if _kernel_ok(a, b):
        chunk_cap, _ = spgemm_pallas_bounds(a, b)
        chunk_cap = max(-(-round_capacity_frac(
            chunk_cap * (3 if held else 2) // 2) // 256) * 256, 256)
        scap = stream_capacity(froz_fl)
        single_ok = ((m + 1) * (n + 1) < (1 << 31)
                     and scap <= SORT_ELEM_LIMIT)
        if single_ok and scap <= max(max_flops_cap, flops_cap * 2):
            fresh.update(kind="pallas", chunk_cap=chunk_cap, scap=scap)
        else:
            # memory-driven slab count; the wide route has no per-slab
            # packed-key row-span limit, so key range never multiplies it
            mem_slabs = -(-flops_exact // max_flops_cap)
            key_slabs = -(-(m + 1) // max((1 << 31) // (n + 1) - 1, 1))
            wide = key_slabs > mem_slabs
            nslabs = (max(mem_slabs, 2) if wide
                      else max(key_slabs, mem_slabs, 2))
            if nslabs <= max(m, 1):
                fresh.update(kind="pallas_slabs", num_slabs=nslabs,
                             wide=wide)
    if fresh["kind"] == "sort" and flops_cap > max_flops_cap:
        fresh.update(kind="rowchunked",
                     num_slabs=-(-flops_cap // max_flops_cap) * 2)
    if not held:
        return fresh
    plan.clear()
    plan.update(fresh)
    return plan
