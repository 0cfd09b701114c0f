"""Distributed 2D SpGEMM on the block grid — Sparse SUMMA (port of
``combblas_tpu/parallel/summa.py``).

Block (i, j) of C gathers A's row panel (blocks A(i, s) for every s, the
JAX ``all_gather`` along 'c') and B's column panel (blocks B(s, j), the
``all_gather`` along 'r') and runs one local ESC multiply over the whole
panel.  The JAX body of one device is :func:`_summa_block`; the public
functions call it for every block, and every block lives on the grid's
device.

Local routes, by the JAX names: ``"xla"`` is the plain ESC (expansion,
sort, fold) for any value type; ``"pallas"`` (packed int32 keys, so
(mb+1)*(nb+1) < 2^31) and ``"wide"`` (int64 keys) run the hand-written
expansion and compress kernels (K1+K2, K3+K4) through
:func:`combblas_tpu_torch.ops.spgemm.spgemm_pallas` / ``spgemm_wide``: the
kernels on CUDA tensors, their plain versions on CPU tensors.
"""

from __future__ import annotations

import itertools
from typing import Callable, Tuple

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO, sort_compress
from combblas_tpu_torch.ops.spgemm import (
    _entry_counts,
    _expand,
    round_capacity_frac,
    spgemm_pallas,
    spgemm_wide,
    stream_capacity,
)
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _gather_blocks,
    _put_blocks,
    block_dims,
)
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["summa_spgemm", "summa_flops", "summa_bounds",
           "summa_spgemm_auto", "summa_impl_auto", "summa_chunk_bound"]

IMPLS = ("xla", "pallas", "wide")


def _panel_a(ar, ac, av, an, kb: int, mb: int) -> SpCOO:
    """A's row panel from the (g, cap) stacks of blocks A(i, s): one SpCOO
    of shape (mb, g*kb), block s's columns shifted by s*kb (the
    panel-global column), its live entries in row order and, inside a row,
    block 0's, then block 1's, ...: the order a stable sort by row of the
    blocks laid end to end gives (the JAX kernels read them end to end).
    So the expansion stream holds each row's products together, as the
    card's row-window sort needs, and the sorted stream is the same.  The
    ``"xla"`` route reads the panel in this order too: a ``flops_cap``
    below the panel's products keeps other products than the JAX package
    keeps.  Each block's rows are sorted, its pads (row mb) last.  No host
    sync."""
    g, cap = ar.shape
    dev = ar.device
    rows = torch.arange(mb + 1, dtype=ar.dtype, device=dev)
    rp = torch.searchsorted(ar.contiguous(),
                            rows.expand(g, mb + 1).contiguous())
    rp = torch.minimum(rp, an[:, None])          # each block's row pointer
    cnt = rp[:, 1:] - rp[:, :-1]
    per_row = cnt.sum(0)
    # the panel slot of a block's first entry in row r, less its own slot
    first = ((torch.cumsum(per_row, 0) - per_row)[None, :]
             + torch.cumsum(cnt, 0) - cnt - rp[:, :-1])
    t = torch.arange(cap, device=dev)
    dest = torch.gather(first, 1, torch.clamp(ar.long(), max=mb - 1))
    dest += t[None, :]
    dest.masked_fill_(t[None, :] >= an[:, None], g * cap)
    off = torch.arange(g, device=dev) * kb
    return _put_blocks(ar, ac, av, an, dest, None, off, (mb, g * kb))


def _panel_b(br, bc, bv, bn, kb: int, nb: int) -> SpCOO:
    """B's column panel from the (g, cap) stacks of blocks B(s, j), as one
    row-sorted SpCOO of shape (g*kb, nb), block s's rows shifted by s*kb.

    The JAX package reads the gathered panel in place through per-row
    ``rp_lo``/``rp_hi`` (``_panel_b_rp``): block s's entries sit at
    [s*cap, s*cap + nnz_s), with a gap of pads behind each block.  The
    port's expansion kernels read B through one row pointer, so the panel
    is compacted: the blocks' live entries back to back, whose row pointer
    (``row_ptr``) is each block's own, offset by the nnz of the blocks
    before it."""
    g = br.shape[0]
    off = torch.arange(g, device=br.device) * kb
    return _gather_blocks(br, bc, bv, bn, off, None, (g * kb, nb))


def _panel_multiply_pallas(pa: SpCOO, pb: SpCOO, sr: Semiring, *,
                           flops_cap: int, out_capacity: int, chunk_cap: int,
                           wide: bool) -> SpCOO:
    """Panel x panel through the expansion and compress kernels: a
    compacted stream of ``stream_capacity(flops_cap)`` slots, packed int32
    keys (K1, K2) or, ``wide``, int64 keys (K3, K4).  C has
    ``max(ceil128(out_capacity), 2048)`` slots, pads (mb, nb, 0)."""
    scap = stream_capacity(flops_cap)
    if wide:
        return spgemm_wide(pa, pb, sr, out_capacity=out_capacity,
                           stream_cap=scap)
    return spgemm_pallas(pa, pb, sr, chunk_cap=chunk_cap,
                         out_capacity=out_capacity, stream_cap=scap)


def _local_multiply(pa: SpCOO, pb: SpCOO, sr: Semiring, *, impl: str,
                    flops_cap: int, out_capacity: int,
                    chunk_cap: int = 0) -> SpCOO:
    """One local product on route ``impl``.  ``"xla"``: the first
    ``flops_cap`` products in A-entry order, sorted and folded into
    ``out_capacity`` slots; the kernel routes as
    :func:`_panel_multiply_pallas`."""
    if impl == "xla":
        i, j, v, total = _expand(pa, pb, pb.row_ptr(), sr, flops_cap)
        return sort_compress(i, j, v, total, (pa.shape[0], pb.shape[1]),
                             sr=sr, out_capacity=out_capacity)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return _panel_multiply_pallas(pa, pb, sr, flops_cap=flops_cap,
                                  out_capacity=out_capacity,
                                  chunk_cap=chunk_cap, wide=impl == "wide")


def _run_blocks(dims: Tuple[int, ...], body: Callable[..., SpCOO]):
    """``body(*index)`` for every block index of ``dims``, each result
    written into (*dims, cap) stacks allocated at the first block (every
    block of one call has one capacity); returns (row, col, val, nnz)."""
    out = None
    for idx in itertools.product(*(range(d) for d in dims)):
        c = body(*idx)
        if out is None:
            out = tuple(torch.empty(dims + x.shape, dtype=x.dtype,
                                    device=x.device)
                        for x in (c.row, c.col, c.val))
            out += (torch.empty(dims, dtype=torch.int64,
                                device=c.row.device),)
        for dst, x in zip(out, (c.row, c.col, c.val, c.nnz)):
            dst[idx] = x
    return out


def _check_operands(a: DistSpMat, b: DistSpMat) -> None:
    if a.grid != b.grid:
        raise ValueError("operands on different grids (GRIDMISMATCH)")
    if a.gshape[1] != b.gshape[0]:
        raise ValueError(f"inner dimensions differ: {a.gshape} x {b.gshape} "
                         "(DIMMISMATCH)")
    if a.grid.pr != a.grid.pc:
        raise ValueError("SpGEMM needs a square grid (reference: √p×√p)")


def _remote_panel(m, positions, shape):
    """The blocks of ``m`` at ``positions`` from their owners, only their
    live entries moved, as stacks of ``shape`` (blocks) and the capacity
    the most entries of one of them need (the matrix's when a block's nnz
    passes it): a panel reads each block's live prefix only, so the
    panel's pads are what shrinks.  ``m`` is a DistSpMat, or a layered
    ``Dist3DSpMat`` whose positions are those of ``m.grid.flat()`` (block
    row i of layer t is row t·pr + i)."""
    g = m.grid.flat()
    nnz = m.nnz.reshape(g.pr, g.pc).cpu().numpy()
    need = max(int(nnz[i, j]) for i, j in positions)
    cap = min(m.capacity, max(need, 1))
    mb, nb = m.block_shape()
    stacks = [x.reshape(-1, x.shape[-2], m.capacity)
              for x in (m.row, m.col, m.val)]
    got = exchange.gather_live(stacks, g, positions,
                               np.minimum(nnz, m.capacity), (mb, nb, 0), cap)
    return [x.reshape(*shape, cap) for x in got]


def _panel_stacks(a, b):
    """The block stacks this process's panels read, by layer: A's (row,
    col, val, nnz) of its layers and block rows, every column (ll, lr, pc,
    ...), and B's of its layers and block columns, every row (ll, pr, lc,
    ...), indexed from its first block.  ``a`` and ``b`` are DistSpMats (one
    layer: the caller takes :func:`_layer` 0) or layered ``Dist3DSpMat``s.
    In one process the operands' own stacks; on a pod the blocks come from
    their owners, each block's live entries only (``_remote_panel`` on the
    grid's ``flat()`` view; the stacks then hold as many slots as the
    fullest of them needs), unless this process holds them all (A's whole
    block rows, B's whole block columns): those are its own stacks."""
    g = a.grid
    (t0, r0, c0), (ll, lr, lc) = g.origin3(), g.local_shape3()
    layers = range(t0, t0 + ll)
    ast, bst = ([x.reshape(ll, lr, lc, -1) for x in (m.row, m.col, m.val)]
                for m in (a, b))
    if lc != g.pc:
        ast = _remote_panel(a, [(t * g.pr + i, s) for t in layers
                                for i in range(r0, r0 + lr)
                                for s in range(g.pc)], (ll, lr, g.pc))
    if lr != g.pr:
        bst = _remote_panel(b, [(t * g.pr + s, j) for t in layers
                                for s in range(g.pr)
                                for j in range(c0, c0 + lc)], (ll, g.pr, lc))
    an, bn = (m.nnz.reshape(g.layers, g.pr, g.pc)[t0:t0 + ll]
              for m in (a, b))
    return ((*ast, an[:, r0:r0 + lr]), (*bst, bn[:, :, c0:c0 + lc]))


def _layer(stacks, t: int):
    """Layer t (counted from this process's first) of a
    :func:`_panel_stacks`: the stacks :func:`_panels` reads."""
    return [[x[t] for x in st] for st in stacks]


def _panels(a: DistSpMat, b: DistSpMat, i: int, j: int, stacks):
    """The A row panel and B column panel of this process's block (i, j),
    (i, j) counted from its first block; ``stacks``: the
    :func:`_layer` of the call's :func:`_panel_stacks`."""
    mb, kb_a = a.block_shape()
    kb_b, nb = b.block_shape()
    (ar, ac, av, an), (br, bc, bv, bn) = stacks
    pa = _panel_a(ar[i], ac[i], av[i], an[i], kb_a, mb)
    pb = _panel_b(br[:, j], bc[:, j], bv[:, j], bn[:, j], kb_b, nb)
    return pa, pb


def _summa_block(a: DistSpMat, b: DistSpMat, i: int, j: int, *,
                 sr: Semiring, flops_cap: int, out_capacity: int, impl: str,
                 chunk_cap: int, stacks) -> SpCOO:
    """Block (i, j) of C: gather the panels, one local multiply (the JAX
    ``_summa_local`` of device (i, j))."""
    pa, pb = _panels(a, b, i, j, stacks)
    return _local_multiply(pa, pb, sr, impl=impl, flops_cap=flops_cap,
                           out_capacity=out_capacity, chunk_cap=chunk_cap)


def summa_spgemm(a: DistSpMat, b: DistSpMat, sr: Semiring = PLUS_TIMES, *,
                 flops_cap: int, out_capacity: int, impl: str = "xla",
                 chunk_cap: int = 0) -> DistSpMat:
    """C = A ·_sr B on the 2D grid.  ``flops_cap`` must bound every
    block's panel product count (:func:`summa_bounds`); ``impl`` selects
    the local route (:func:`summa_impl_auto`).  C's blocks have
    ``out_capacity`` slots on the ``"xla"`` route and
    ``max(ceil128(out_capacity), 2048)`` on the kernel routes; a block's
    nnz saturates at ``out_capacity``."""
    _check_operands(a, b)
    stacks = _layer(_panel_stacks(a, b), 0)
    row, col, val, nnz = _run_blocks(
        a.grid.local_shape(),
        lambda i, j: _summa_block(a, b, i, j, sr=sr, flops_cap=flops_cap,
                                  out_capacity=out_capacity, impl=impl,
                                  chunk_cap=chunk_cap, stacks=stacks))
    return DistSpMat(row=row, col=col, val=val,
                     nnz=exchange.gather_table(nnz, a.grid),
                     gshape=(a.gshape[0], b.gshape[1]), grid=a.grid)


def summa_impl_auto(a: DistSpMat, b: DistSpMat) -> str:
    """The local route: the kernel routes whenever both value types are
    float32 (packed keys when the block dims allow, wide otherwise), on any
    device (CPU tensors run the kernels' plain versions); ``"xla"`` for
    other value types."""
    if a.val.dtype != torch.float32 or b.val.dtype != torch.float32:
        return "xla"
    mb, _ = block_dims(a.gshape, a.grid)
    _, nb = block_dims(b.gshape, b.grid)
    return "pallas" if (mb + 1) * (nb + 1) < (1 << 31) else "wide"


def summa_chunk_bound(a: DistSpMat, b: DistSpMat, flops_cap: int) -> int:
    """The JAX package's per-block chunk-count bound for the kernel
    routes: sum(ceil(cnt/128)) <= (A-panel nnz) + flops/128.  The port's
    compacted expansion needs no chunk table; the bound rides along as
    ``spgemm_pallas``'s ``chunk_cap``."""
    panel_nnz = int(a.nnz.sum(-1).max())
    nch = panel_nnz + flops_cap // 128 + 256
    return max(-(-round_capacity_frac(nch) // 256) * 256, 256)


def summa_flops(a: DistSpMat, b: DistSpMat) -> torch.Tensor:
    """(pr, pc) int64 per-block panel product counts — the distributed
    symbolic pass (reference ``EstimateFLOP``); every process gets the
    whole table."""
    _check_operands(a, b)
    lr, lc = a.grid.local_shape()
    out = torch.empty((lr, lc), dtype=torch.int64, device=a.row.device)
    stacks = _layer(_panel_stacks(a, b), 0)
    for i, j in itertools.product(range(lr), range(lc)):
        pa, pb = _panels(a, b, i, j, stacks)
        out[i, j] = _entry_counts(pa, pb.row_ptr()).sum()
    return exchange.gather_table(out, a.grid)


def summa_bounds(a: DistSpMat, b: DistSpMat) -> Tuple[int, int]:
    """(flops_cap, out_capacity) for :func:`summa_spgemm`: the largest
    block's panel product count, rounded to a 1/8-power-of-two step."""
    cap = round_capacity_frac(int(summa_flops(a, b).max()))
    return cap, cap


def summa_spgemm_auto(a: DistSpMat, b: DistSpMat, sr: Semiring = PLUS_TIMES,
                      *, nnz_estimate: int | None = None) -> DistSpMat:
    """SUMMA with estimate-and-retry output sizing: the block output
    buffer starts from ``nnz_estimate`` (default: half the panel product
    bound) and the multiply is retried with a doubled buffer while any
    block saturates (block nnz == capacity)."""
    flops_cap, oc = summa_bounds(a, b)
    impl = summa_impl_auto(a, b)
    chunk_cap = summa_chunk_bound(a, b, flops_cap) if impl != "xla" else 0
    if nnz_estimate is not None:
        out_cap = round_capacity_frac(max(int(nnz_estimate), 8))
    else:
        out_cap = round_capacity_frac(max(flops_cap // 2, 8))
    out_cap = min(out_cap, oc)
    while True:
        c = summa_spgemm(a, b, sr, flops_cap=flops_cap, out_capacity=out_cap,
                         impl=impl, chunk_cap=chunk_cap)
        full = int(c.nnz.max()) >= min(out_cap, c.capacity)
        if not full or out_cap >= oc:
            return c
        del c  # the next attempt's blocks take its place on the card
        out_cap = min(round_capacity_frac(out_cap * 2), oc)
