"""3D (split-layer, communication-avoiding) SpGEMM on the block grid (port
of ``combblas_tpu/parallel/summa3d.py``).

Grid (l, pr, pc).  Layer t owns the t-th range of the inner dimension: A's
columns ('col' split) and B's rows ('row' split).  Each layer runs the
all-gather SUMMA on its own blocks; then the l partial C blocks of one fiber
(i, j) are reduced along 'l': each layer sorts its partial block by
destination layer (layer t owns the columns [t*nb/l, (t+1)*nb/l) of every
block) and sends each destination a ``fiber_cap`` chunk.  The JAX
``all_to_all`` of those (l, l, fiber_cap) send stacks is a transpose here;
each layer then folds what it received.  An overfull chunk saturates the
fiber's output nnz at ``out_capacity``: the caller's retry signal.  The port
walks the fibers one at a time, so only one fiber's send stacks are on the
device at once.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import (
    SpCOO,
    _pair_key,
    _round_capacity,
    _sort_pairs,
    compress_sorted,
    sort_compress,
)
from combblas_tpu_torch.ops.spgemm import spgemm_flops
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _bucket_blocks,
    _gather_blocks,
    block_dims,
)
from combblas_tpu_torch.parallel.grid import ProcGrid, single_process
from combblas_tpu_torch.parallel.summa import (
    _local_multiply,
    _panel_a,
    _panel_b,
)
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["Dist3DSpMat", "summa3d_spgemm", "summa3d_bounds",
           "mem_efficient_spgemm3d"]


@dataclasses.dataclass(frozen=True)
class Dist3DSpMat:
    """Layer-split distributed sparse matrix: (l, pr, pc, cap) block stacks
    and (l, pr, pc) int64 nnz on the grid's device.

    ``split``: 'col' (A operands: layer t holds the t-th column range), 'row'
    (B operands) or 'blockcol' (products: layer t holds the t-th column slice
    of every 2D block).  Coordinates are local to the per-layer block."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    nnz: torch.Tensor
    gshape: Tuple[int, int]
    grid: ProcGrid
    split: str

    @property
    def layers(self) -> int:
        return self.grid.layers

    def layer_shape(self) -> Tuple[int, int]:
        """Per-layer global (sub)matrix shape before 2D blocking."""
        m, n = self.gshape
        if self.split == "col":
            return m, -(-n // self.layers)
        if self.split == "row":
            return -(-m // self.layers), n
        g2 = self.grid.grid2d()
        mb, nb = block_dims(self.gshape, g2)
        return g2.pr * mb, nb // self.layers * g2.pc

    def block_shape(self) -> Tuple[int, int]:
        g2 = self.grid.grid2d()
        if self.split == "blockcol":
            mb, nb = block_dims(self.gshape, g2)
            return mb, nb // self.layers
        return block_dims(self.layer_shape(), g2)

    @staticmethod
    def from_dist2d(a: "DistSpMat | SpCOO", grid: ProcGrid, split: str,
                    capacity: int | None = None) -> "Dist3DSpMat":
        """2D -> 3D redistribution: slice the split dimension into l
        ranges, 2D-distribute each slice on the layer's grid (as
        ``DistSpMat.from_coo_arrays``), pad the layers to one capacity and
        stack them, on the grid's device."""
        if not grid.is3d:
            raise ValueError("from_dist2d needs a grid with layers")
        if split not in ("col", "row"):
            raise ValueError(f"split must be 'col' or 'row', got {split!r}")
        if isinstance(a, DistSpMat):
            a = a.to_local()
        k = int(a.nnz)
        row = a.row[:k].to(grid.device).long()
        col = a.col[:k].to(grid.device).long()
        val = a.val[:k].to(grid.device)
        m, n = a.shape
        l = grid.layers
        g2 = grid.grid2d()
        if split == "col":
            sb = -(-n // l)
            which = col // sb
            lr_, lc_ = row, col - which * sb
            lshape = (m, sb)
        else:
            sb = -(-m // l)
            which = row // sb
            lr_, lc_ = row - which * sb, col
            lshape = (sb, n)
        mb, nb = block_dims(lshape, g2)
        layers = [_bucket_blocks(lr_[which == t], lc_[which == t],
                                 val[which == t], lshape, g2, None)
                  for t in range(l)]
        cap = capacity or max(stk[0].shape[-1] for stk in layers)

        def stack(i, fill):
            out = torch.full((l, g2.pr, g2.pc, cap), fill,
                             dtype=layers[0][i].dtype, device=grid.device)
            for t, stk in enumerate(layers):
                out[t, :, :, :stk[i].shape[-1]] = stk[i]
            return out

        return Dist3DSpMat(
            row=stack(0, mb), col=stack(1, nb), val=stack(2, 0),
            nnz=torch.stack([stk[3] for stk in layers]),
            gshape=(int(m), int(n)), grid=grid, split=split)

    def to_local(self) -> SpCOO:
        """All layers' blocks as one SpCOO on the grid's device: global
        coordinates, (row, col) sorted, duplicates summed, capacity the
        power of two (at least 8) at or above nnz (the JAX ``to_local``)."""
        l = self.layers
        g2 = self.grid.grid2d()
        mb, nb = self.block_shape()
        ls0, ls1 = self.layer_shape()
        nb_full = block_dims(self.gshape, g2)[1]
        dev = self.row.device
        t, i, j = (x.reshape(-1) for x in torch.meshgrid(
            torch.arange(l, device=dev), torch.arange(g2.pr, device=dev),
            torch.arange(g2.pc, device=dev), indexing="ij"))
        roff = i * mb + (t * ls0 if self.split == "row" else 0)
        if self.split == "blockcol":
            coff = j * nb_full + t * nb
        elif self.split == "col":
            coff = j * nb + t * ls1
        else:
            coff = j * nb
        g = l * g2.pr * g2.pc
        flat = _gather_blocks(self.row.reshape(g, -1),
                              self.col.reshape(g, -1),
                              self.val.reshape(g, -1), self.nnz.reshape(-1),
                              roff, coff, self.gshape)
        total = int(flat.nnz)
        row, col, val = _sort_pairs(flat.row[:total], flat.col[:total],
                                    flat.val[:total])
        del flat
        c = compress_sorted(row, col, val, total, self.gshape, sr=PLUS_TIMES,
                            out_capacity=max(total, 1))
        return c.with_capacity(_round_capacity(int(c.nnz)))

    def to_dist2d(self, grid2: ProcGrid) -> DistSpMat:
        """3D -> 2D redistribution (``Convert2D``): gather the layers and
        re-bucket onto ``grid2``'s blocks on the host."""
        return DistSpMat.from_local(self.to_local(), grid2)


def _fiber_send(part: SpCOO, nlayers: int, fiber_cap: int):
    """One layer's partial C block grouped by destination layer: (l,
    fiber_cap) row / col / val chunks, the chunk lengths (each at most
    ``fiber_cap``) and whether any destination overflowed."""
    mb, nb = part.shape
    cap = part.capacity
    nb_split = nb // nlayers
    dev = part.row.device
    live = part.mask()
    dest = torch.where(live, torch.clamp(part.col.long() // nb_split,
                                         max=nlayers - 1), nlayers)
    d_s, order = torch.sort(dest, stable=True)
    ids = torch.arange(nlayers, device=dev)
    starts = torch.searchsorted(d_s, ids)
    lens = torch.searchsorted(d_s, ids, right=True) - starts
    tt = torch.arange(fiber_cap, device=dev)
    pos = order[torch.clamp(starts[:, None] + tt[None, :], max=cap - 1)]
    ok = tt[None, :] < lens[:, None]
    chunks = (torch.where(ok, part.row[pos], mb),
              torch.where(ok, part.col[pos], nb),
              torch.where(ok, part.val[pos], torch.zeros_like(part.val[pos])))
    return chunks, torch.clamp(lens, max=fiber_cap), (lens > fiber_cap).any()


def _fiber_reduce(recv, rlen, t: int, over, sr: Semiring, *, out_capacity,
                  mb: int, nb_split: int) -> SpCOO:
    """Layer t folds the chunks it received from every layer into its
    column slice of the fiber's C block; nnz saturates at ``out_capacity``
    when any chunk of the fiber overflowed."""
    rr, rc, rv = recv
    fiber_cap = rr.shape[-1]
    tt = torch.arange(fiber_cap, device=rr.device)
    rok = tt[None, :] < rlen[:, None]
    lo = t * nb_split
    c = sort_compress(torch.where(rok, rr, mb).reshape(-1),
                      torch.where(rok, rc - lo, nb_split).reshape(-1),
                      torch.where(rok, rv, torch.zeros_like(rv)).reshape(-1),
                      rlen.sum(), (mb, nb_split), sr=sr,
                      out_capacity=out_capacity)
    return dataclasses.replace(
        c, nnz=torch.where(over, out_capacity, c.nnz).to(torch.int64))


@single_process
def summa3d_spgemm(a: Dist3DSpMat, b: Dist3DSpMat, sr: Semiring = PLUS_TIMES,
                   *, flops_cap: int, out_capacity: int) -> Dist3DSpMat:
    """C = A ·_sr B with A col-split and B row-split across layers; C is
    'blockcol' split (layer t owns the columns [t*nb/l, (t+1)*nb/l) of every
    block).  ``flops_cap`` bounds a layer's panel products and
    ``out_capacity`` a block's partial and reduced outputs."""
    if a.grid != b.grid or not a.grid.is3d:
        raise ValueError("operands must share one grid with layers")
    if a.split != "col" or b.split != "row":
        raise ValueError("A must be 'col' split and B 'row' split")
    grid = a.grid
    g2 = grid.grid2d()
    if g2.pr != g2.pc:
        raise ValueError("3D SpGEMM needs square layers")
    mb, kb_a = a.block_shape()
    kb_b, nb = b.block_shape()
    l = grid.layers
    if nb % l:
        raise ValueError("the column block must split evenly across layers")
    nb_split = nb // l
    # per-destination exchange capacity: the balanced share, 2x slack
    fiber_cap = min(out_capacity, max(-(-out_capacity // l) * 2, 2048))
    dev = a.row.device
    dims = (l, g2.pr, g2.pc)
    out = None
    for i, j in itertools.product(range(g2.pr), range(g2.pc)):
        sends, lens, over = [], [], []
        for t in range(l):
            pa = _panel_a(a.row[t, i], a.col[t, i], a.val[t, i],
                          a.nnz[t, i], kb_a, mb)
            pb = _panel_b(b.row[t, :, j], b.col[t, :, j], b.val[t, :, j],
                          b.nnz[t, :, j], kb_b, nb)
            part = _local_multiply(pa, pb, sr, impl="xla",
                                   flops_cap=flops_cap,
                                   out_capacity=out_capacity)
            chunks, n_t, over_t = _fiber_send(part, l, fiber_cap)
            sends.append(chunks)
            lens.append(n_t)
            over.append(over_t)
            del pa, pb, part
        # the all_to_all: layer t receives chunk t of every layer
        recv = [torch.stack([s[k] for s in sends], 1) for k in range(3)]
        rlen = torch.stack(lens, 1)
        any_over = torch.stack(over).any()
        del sends
        for t in range(l):
            c = _fiber_reduce([x[t] for x in recv], rlen[t], t, any_over, sr,
                              out_capacity=out_capacity, mb=mb,
                              nb_split=nb_split)
            if out is None:
                out = [torch.empty(dims + (out_capacity,), dtype=x.dtype,
                                   device=dev) for x in (c.row, c.col, c.val)]
                out.append(torch.empty(dims, dtype=torch.int64, device=dev))
            for dst, x in zip(out, (c.row, c.col, c.val, c.nnz)):
                dst[t, i, j] = x
    return Dist3DSpMat(row=out[0], col=out[1], val=out[2], nnz=out[3],
                       gshape=(a.gshape[0], b.gshape[1]), grid=grid,
                       split="blockcol")


def _sort_blocks(row, col, val):
    """Sort every block of (..., cap) stacks by (row, col), stably."""
    order = torch.sort(_pair_key(row, col), dim=-1, stable=True)[1]
    return tuple(torch.take_along_dim(x, order, dim=-1)
                 for x in (row, col, val))


def _col_slab3d(b: Dist3DSpMat, lo: int, hi: int) -> Dist3DSpMat:
    """B's block-local columns [lo, hi): the rest become per-block pads and
    every block is re-sorted (ColSplit for the phased 3D path)."""
    mb, nb = b.block_shape()
    idx = torch.arange(b.row.shape[-1], device=b.row.device)
    valid = (idx < b.nnz[..., None]) & (b.col >= lo) & (b.col < hi)
    row, col, val = _sort_blocks(
        torch.where(valid, b.row, mb), torch.where(valid, b.col, nb),
        torch.where(valid, b.val, torch.zeros_like(b.val)))
    return dataclasses.replace(b, row=row, col=col, val=val,
                               nnz=valid.sum(-1))


def _concat3d(a: Dist3DSpMat, b: Dist3DSpMat) -> Dist3DSpMat:
    """Entrywise concat of two same-layout 3D matrices with disjoint
    columns (phase outputs), blocks re-sorted."""
    row, col, val = _sort_blocks(torch.cat([a.row, b.row], -1),
                                 torch.cat([a.col, b.col], -1),
                                 torch.cat([a.val, b.val], -1))
    return dataclasses.replace(a, row=row, col=col, val=val,
                               nnz=a.nnz + b.nnz)


@single_process
def mem_efficient_spgemm3d(a: Dist3DSpMat, b: Dist3DSpMat,
                           sr: Semiring = PLUS_TIMES, phases: int = 1,
                           flops_cap: int | None = None,
                           out_capacity: int | None = None,
                           phase_hook=None) -> Dist3DSpMat:
    """Phased 3D SpGEMM (``MemEfficientSpGEMM3D``): B in column slabs, each
    through :func:`summa3d_spgemm`, the phase outputs concatenated (their
    columns are disjoint).  ``phase_hook`` runs on each phase's product."""
    if flops_cap is None or out_capacity is None:
        fc, oc = summa3d_bounds(a, b)
        flops_cap = flops_cap or max(fc // max(phases, 1), 1024)
        out_capacity = out_capacity or max(oc // max(phases, 1), 1024)
    _, nb = b.block_shape()
    slab = -(-nb // phases)
    acc = None
    for p in range(phases):
        lo, hi = p * slab, min((p + 1) * slab, nb)
        if lo >= hi:
            break
        bp = _col_slab3d(b, lo, hi) if phases > 1 else b
        cp = summa3d_spgemm(a, bp, sr, flops_cap=flops_cap,
                            out_capacity=out_capacity)
        if phase_hook is not None:
            cp = phase_hook(cp)
        acc = cp if acc is None else _concat3d(acc, cp)
    return acc


@single_process
def summa3d_bounds(a: Dist3DSpMat, b: Dist3DSpMat) -> Tuple[int, int]:
    """(flops_cap, out_capacity): the whole product's count rounded up to a
    power of two (at least 64), a safe bound for any block's layer panel."""
    total = spgemm_flops(a.to_local(), b.to_local())
    cap = max(64, 1 << int(np.ceil(np.log2(max(total, 1)))))
    return cap, cap
