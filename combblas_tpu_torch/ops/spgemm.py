"""Local semiring SpGEMM, the subset of ``combblas_tpu/ops/spgemm.py`` that
the seg2 digest pipeline calls: the planning helpers, the slab extraction,
and the flat-slab multiply with its digest step.

The ESC scheme (expand -> sort -> compress) is kept; the expansion and the
compress are the hand-written CUDA kernels of :mod:`.kernels`, the sort is
``torch.sort`` where JAX used ``lax.sort``.  Counts and keys that JAX had to
split across int32 limbs or streams are plain int64 here.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.kernels.compress import (
    compress_sorted_wide,
    compress_sorted_wide_keys,
)
from combblas_tpu_torch.ops.kernels.expand import expand_chunks_compact_wide
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["spgemm_flops", "round_capacity_frac", "stream_capacity",
           "SORT_ELEM_LIMIT", "SpGEMMSortLimitError", "check_sort_limit",
           "spgemm_wide"]

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
            "use seg2 slabbing or lower flops_cap")


def spgemm_flops(a: SpCOO, b: SpCOO) -> int:
    """Exact number of semiring multiplications for A·B, as one int64 sum
    (port of ``spgemm_flops``; no 16-bit limbs)."""
    k = a.shape[1]
    b_rp = b.row_ptr()
    acol = torch.clamp(a.col.long(), max=k - 1)
    cnt = torch.where(a.mask(), b_rp[acol + 1] - b_rp[acol], 0)
    return int(cnt.sum())


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


def _wide_expand_sort(a: SpCOO, b: SpCOO, sr: Semiring, *, stream_cap: int,
                      b_rp: torch.Tensor | None, plain: bool):
    """Expand A·B with int64 keys ``row*(n+1)+col`` and sort the stream by
    key.  Returns (key, val, stride)."""
    k, n = b.shape
    if a.shape[1] != k:
        raise ValueError(f"inner dimensions differ: {a.shape} x {b.shape}")
    if b_rp is None:
        b_rp = b.row_ptr()
    stride = n + 1
    key, val, _total = expand_chunks_compact_wide(
        a.row, a.col, a.val, a.mask(), b_rp, b.col, b.val, sr,
        stride=stride, stream_cap=stream_cap, plain=plain)
    key, order = torch.sort(key, stable=True)
    return key, val[order], stride


def _wide_out_cap(out_capacity: int) -> int:
    return max(-(-out_capacity // 128) * 128, 2048)


def spgemm_wide(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                out_capacity: int, stream_cap: int,
                b_rp: torch.Tensor | None = None,
                plain: bool = False) -> SpCOO:
    """Wide-key ESC SpGEMM (port of ``spgemm_pallas_wide``): int64 keys
    ``row*(n+1)+col`` through the expansion kernel, one ``torch.sort``, and
    the compress kernel.  ``stream_cap`` must cover A·B's products.
    ``plain=True`` runs the kernels' plain versions (the reference run)."""
    m, n = a.shape[0], b.shape[1]
    key, val, stride = _wide_expand_sort(a, b, sr, stream_cap=stream_cap,
                                         b_rp=b_rp, plain=plain)
    orow, ocol, oval, nnz = compress_sorted_wide(
        key, val, sr, out_capacity=_wide_out_cap(out_capacity),
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


def _slab_digest_step(a: SpCOO, b: SpCOO, b_rp, bounds, s: int, state,
                      sr: Semiring, *, span_cap: int, slab_nnz_cap: int,
                      slab_out_cap: int, stream_cap: int,
                      plain: bool = False):
    """One slab of the streamed digest (port of ``_pallas_slab_digest_step``
    with ``wide=True``): form the slab's C block as :func:`spgemm_wide`
    does, fold it into ``state = (nnz int64, checksum f32, truncated
    bool)`` and drop it.  The fold reads only values and nnz, so the packed
    keys are never split into (row, col).  All on the device."""
    k = a.shape[1]
    sub, _row_lo = _slab_extract(a, k, bounds, s, span_cap=span_cap,
                                 slab_nnz_cap=slab_nnz_cap)
    key, val, _stride = _wide_expand_sort(sub, b, sr, stream_cap=stream_cap,
                                          b_rp=b_rp, plain=plain)
    _okey, oval, nnz = compress_sorted_wide_keys(
        key, val, sr, out_capacity=_wide_out_cap(slab_out_cap), plain=plain)
    # entries past nnz hold 0, so the plain sum is the live sum
    cs = oval.sum()
    nnz_total, checksum, truncated = state
    return (nnz_total + nnz, checksum + cs,
            truncated | (nnz >= slab_out_cap))
