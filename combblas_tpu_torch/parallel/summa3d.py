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
fiber's output nnz at ``out_capacity``: the caller's retry signal.

The port walks the fibers one at a time, so only one fiber's send stacks
are on the device at once.  On a grid over several processes (a pod) each
process holds its box of (ll, lr, lc) blocks (:meth:`ProcGrid.
local_shape3`) and walks its (lr, lc) fibers in rounds, every process its
own fiber of the round: the processes that share a fiber hold it at the
same place of their boxes.  A round forms the partial products of this
process's ll layers of its fiber, from panels of live prefixes fetched
from their owners before the first round, then sends each destination
layer's chunk, live prefix only, to that layer's owner (``exchange.pull``)
and folds what it received in ascending source layer, which is the
one-process stack.  The overflow flag is the fiber's, an OR over its l
layers' host counts.  A layer's partial product and a fiber's reduction
fold on the card through the compress kernel (K2 on packed keys, K4 on
wide ones, :func:`_sort_fold`), whose sums follow the sorted stream alone:
a pod's stream is one process's, so its blocks are one process's bit for
bit, and two runs give the same bits.
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
from combblas_tpu_torch.ops.kernels.compress import (
    compress_sorted_packed,
    compress_sorted_wide_keys,
)
from combblas_tpu_torch.ops.kernels.expand import KEY_SENTINEL
from combblas_tpu_torch.ops.spgemm import (
    _entry_counts,
    _expand,
    round_capacity_frac,
    spgemm_flops,
)
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _block_capacity,
    _box_entries,
    _fill_box,
    _gather_blocks,
    block_dims,
)
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.parallel.summa import _layer, _panel_stacks, _panels
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["Dist3DSpMat", "summa3d_spgemm", "summa3d_bounds",
           "summa3d_layer_bounds", "mem_efficient_spgemm3d"]


def _nnz_table(local: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """The (l, pr, pc) table of a per-block count from every process's
    (ll, lr, lc) part; in one process ``local`` itself."""
    if not grid.is_pod:
        return local
    ll, lr, lc = grid.local_shape3()
    return exchange.gather_table(local.reshape(ll * lr, lc),
                                 grid.flat()).reshape(
        grid.layers, grid.pr, grid.pc)


@dataclasses.dataclass(frozen=True)
class Dist3DSpMat:
    """Layer-split distributed sparse matrix: (l, pr, pc, cap) block stacks
    and (l, pr, pc) int64 nnz on the grid's device.  On a pod the stacks
    hold this process's (ll, lr, lc) box of blocks and ``nnz`` stays the
    whole table in every process, as a ``DistSpMat``'s does.

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

    @property
    def capacity(self) -> int:
        return self.row.shape[-1]

    @property
    def local_nnz(self) -> torch.Tensor:
        """The nnz of this process's blocks, (ll, lr, lc): ``nnz`` itself
        in one process."""
        if not self.grid.is_pod:
            return self.nnz
        (t0, r0, c0) = self.grid.origin3()
        ll, lr, lc = self.grid.local_shape3()
        return self.nnz[t0:t0 + ll, r0:r0 + lr, c0:c0 + lc]

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
        stack them, on the grid's device.  On a pod the operand is gathered
        whole (an SpCOO: every process passes the same) and each process
        buckets its own blocks of its layers; the capacity comes from the
        whole count table."""
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
        (t0, r0, c0), (ll, lr, lc) = grid.origin3(), grid.local_shape3()
        box = ((r0, c0), (lr, lc))
        ents = [_box_entries(lr_[which == t], lc_[which == t],
                             val[which == t], mb, nb, box, own=grid.is_pod)
                for t in range(t0, t0 + ll)]
        nnz = _nnz_table(torch.stack([e[-1].reshape(lr, lc) for e in ents]),
                         grid)
        most = int(nnz.max())
        cap = capacity or _block_capacity(most, None)
        if most > cap:
            raise ValueError(f"a block holds {most} entries, past the "
                             f"capacity {cap}")
        stacks = [_fill_box(e, (lr, lc), cap, mb, nb) for e in ents]
        row, col, val = (torch.stack([st[f] for st in stacks])
                         for f in range(3))
        return Dist3DSpMat(row=row, col=col, val=val, nnz=nnz,
                           gshape=(int(m), int(n)), grid=grid, split=split)

    def to_local(self) -> SpCOO:
        """All layers' blocks as one SpCOO on the grid's device: global
        coordinates, (row, col) sorted, duplicates summed, capacity the
        power of two (at least 8) at or above nnz (the JAX ``to_local``).
        On a pod every process gets the whole matrix: its live entries,
        all-gathered in rank order (the raster order of the blocks)."""
        grid = self.grid
        g2 = grid.grid2d()
        mb, nb = self.block_shape()
        ls0, ls1 = self.layer_shape()
        nb_full = block_dims(self.gshape, g2)[1]
        dev = self.row.device
        (t0, r0, c0), (ll, lr, lc) = grid.origin3(), grid.local_shape3()
        t, i, j = (x.reshape(-1) for x in torch.meshgrid(
            torch.arange(t0, t0 + ll, device=dev),
            torch.arange(r0, r0 + lr, device=dev),
            torch.arange(c0, c0 + lc, device=dev), indexing="ij"))
        roff = i * mb + (t * ls0 if self.split == "row" else 0)
        if self.split == "blockcol":
            coff = j * nb_full + t * nb
        elif self.split == "col":
            coff = j * nb + t * ls1
        else:
            coff = j * nb
        g = ll * lr * lc
        flat = _gather_blocks(self.row.reshape(g, -1),
                              self.col.reshape(g, -1),
                              self.val.reshape(g, -1),
                              self.local_nnz.reshape(-1), roff, coff,
                              self.gshape)
        total = int(flat.nnz)
        row, col, val = flat.row[:total], flat.col[:total], flat.val[:total]
        del flat
        if grid.is_pod:
            row, col, val = exchange.allgather_var([row, col, val])
            total = int(row.shape[0])
        row, col, val = _sort_pairs(row, col, val)
        c = compress_sorted(row, col, val, total, self.gshape, sr=PLUS_TIMES,
                            out_capacity=max(total, 1))
        return c.with_capacity(_round_capacity(int(c.nnz)))

    def to_dist2d(self, grid2: ProcGrid) -> DistSpMat:
        """3D -> 2D redistribution (``Convert2D``): gather the layers and
        re-bucket onto ``grid2``'s blocks (on a pod, a 2D grid over the
        same processes: each process buckets its own)."""
        return DistSpMat.from_local(self.to_local(), grid2)


def _sort_fold(i, j, v, nvalid, shape, sr: Semiring,
               out_capacity: int) -> SpCOO:
    """:func:`ops.coo.sort_compress` of a stream whose pads are (m, n), for
    ``shape`` (m, n).  Float32 values take the compress kernel's route (on
    CPU tensors its plain version): the keys ``i*(n+1) + j`` (int32 where
    they fit, else int64; pads the key sentinel) sorted stably and folded
    by K2 / K4, whose sums follow the sorted stream alone (ROADMAP §3,
    trait 10), so a stream gives the same bits in every run and every
    process.  Other value types take ``sort_compress``."""
    if v.dtype != torch.float32:
        return sort_compress(i, j, v, nvalid, shape, sr=sr,
                             out_capacity=out_capacity)
    m, n = shape
    stride = n + 1
    kd = torch.int32 if (m + 1) * stride < (1 << 31) else torch.int64
    key = torch.where(i < m, i.to(kd) * stride + j.to(kd), KEY_SENTINEL[kd])
    key, order = torch.sort(key, stable=True)
    fold = compress_sorted_packed if kd == torch.int32 else \
        compress_sorted_wide_keys
    okey, oval, nnz = fold(key, v[order], sr, out_capacity=out_capacity)
    live = torch.arange(out_capacity, device=key.device) < nnz
    return SpCOO(row=torch.where(live, okey // stride, m).to(torch.int32),
                 col=torch.where(live, okey % stride, n).to(torch.int32),
                 val=oval, nnz=nnz, shape=(m, n))


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


def _fiber_exchange(sends, lens, over, grid: ProcGrid, i: int, j: int):
    """The ``all_to_all`` of fiber (i, j): this process's layers' send
    chunks, lengths and overflow flags (one of each a layer it holds) ->
    the (ll, l, fiber_cap) row / col / val stacks its layers received, in
    ascending source layer, the (ll, l) received lengths and the fiber's
    overflow flag (0-d bool).  In one process the transpose of the send
    stacks; on a pod each chunk's live prefix comes from the owner of its
    source layer's block, and the lengths and flags of the fiber's l
    layers are read from one host all-gather."""
    if not grid.is_pod:
        recv = [torch.stack([s[k] for s in sends], 1) for k in range(3)]
        return recv, torch.stack(lens, 1), torch.stack(over).any()
    l = grid.layers
    t0 = grid.origin3()[0]
    ll, fiber_cap = len(sends), sends[0][0].shape[-1]
    dev = sends[0][0].device
    mine = torch.cat([torch.stack(lens), torch.stack(over)[:, None].long()],
                     1).cpu().numpy()
    table = exchange.allgather_host(mine)          # (P, ll, l + 1)
    src = [grid.owner3(t, i, j) for t in range(l)]
    first = [grid.origin3(q)[0] for q in src]
    got_lens = np.stack([table[q, t - f, :l]
                         for t, (q, f) in enumerate(zip(src, first))])
    fiber_over = bool(any(table[q, t - f, l]
                          for t, (q, f) in enumerate(zip(src, first))))
    pub = [torch.cat([sends[a][k][d, :int(mine[a, d])] for a in range(ll)
                      for d in range(l)]) for k in range(3)]
    wants = []
    for d in range(t0, t0 + ll):
        for t in range(l):
            q, at = src[t], t - first[t]
            offs = table[q, :, :l].reshape(-1)
            off = int(offs[:at * l + d].sum())
            wants += [(q, k, off, off + int(offs[at * l + d]))
                      for k in range(3)]
    got = exchange.pull(pub, wants)
    recv = [torch.zeros((ll, l, fiber_cap), dtype=x.dtype, device=dev)
            for x in sends[0]]
    for n, piece in enumerate(got):
        (a, t), k = divmod(n // 3, l), n % 3
        recv[k][a, t, :piece.shape[0]] = piece
    rlen = torch.from_numpy(np.ascontiguousarray(
        got_lens[:, t0:t0 + ll].T)).to(dev)
    return recv, rlen, torch.tensor(fiber_over, device=dev)


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
    c = _sort_fold(torch.where(rok, rr, mb).reshape(-1),
                   torch.where(rok, rc - lo, nb_split).reshape(-1),
                   torch.where(rok, rv, torch.zeros_like(rv)).reshape(-1),
                   rlen.sum(), (mb, nb_split), sr, out_capacity)
    return dataclasses.replace(
        c, nnz=torch.where(over, out_capacity, c.nnz).to(torch.int64))


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
    mb, _ = a.block_shape()
    _, nb = b.block_shape()
    l = grid.layers
    if nb % l:
        raise ValueError("the column block must split evenly across layers")
    nb_split = nb // l
    # per-destination exchange capacity: the balanced share, 2x slack
    fiber_cap = min(out_capacity, max(-(-out_capacity // l) * 2, 2048))
    dev = a.row.device
    (t0, r0, c0), dims = grid.origin3(), grid.local_shape3()
    stacks = _panel_stacks(a, b)
    out = None
    for i, j in itertools.product(range(dims[1]), range(dims[2])):
        sends, lens, over = [], [], []
        for t in range(dims[0]):
            pa, pb = _panels(a, b, i, j, _layer(stacks, t))
            i_, j_, v_, total = _expand(pa, pb, pb.row_ptr(), sr, flops_cap)
            part = _sort_fold(i_, j_, v_, total, (mb, nb), sr, out_capacity)
            chunks, n_t, over_t = _fiber_send(part, l, fiber_cap)
            sends.append(chunks)
            lens.append(n_t)
            over.append(over_t)
            del pa, pb, i_, j_, v_, part
        # the all_to_all: layer t receives chunk t of every layer
        recv, rlen, any_over = _fiber_exchange(sends, lens, over, grid,
                                               r0 + i, c0 + j)
        del sends
        for t in range(dims[0]):
            c = _fiber_reduce([x[t] for x in recv], rlen[t], t0 + t,
                              any_over, sr, out_capacity=out_capacity,
                              mb=mb, nb_split=nb_split)
            if out is None:
                out = [torch.empty(dims + (out_capacity,), dtype=x.dtype,
                                   device=dev) for x in (c.row, c.col, c.val)]
                out.append(torch.empty(dims, dtype=torch.int64, device=dev))
            for dst, x in zip(out, (c.row, c.col, c.val, c.nnz)):
                dst[t, i, j] = x
    return Dist3DSpMat(row=out[0], col=out[1], val=out[2],
                       nnz=_nnz_table(out[3], grid),
                       gshape=(a.gshape[0], b.gshape[1]), grid=grid,
                       split="blockcol")


def _sort_blocks(row, col, val):
    """Sort every block of (..., cap) stacks by (row, col), stably."""
    order = torch.sort(_pair_key(row, col), dim=-1, stable=True)[1]
    return tuple(torch.take_along_dim(x, order, dim=-1)
                 for x in (row, col, val))


def _col_slab3d(b: Dist3DSpMat, lo: int, hi: int) -> Dist3DSpMat:
    """B's block-local columns [lo, hi): the rest become per-block pads and
    every block is re-sorted (ColSplit for the phased 3D path).  Each
    process masks its own blocks; on a pod the new count table is
    all-gathered."""
    mb, nb = b.block_shape()
    idx = torch.arange(b.row.shape[-1], device=b.row.device)
    valid = ((idx < b.local_nnz[..., None]) & (b.col >= lo)
             & (b.col < hi))
    row, col, val = _sort_blocks(
        torch.where(valid, b.row, mb), torch.where(valid, b.col, nb),
        torch.where(valid, b.val, torch.zeros_like(b.val)))
    return dataclasses.replace(b, row=row, col=col, val=val,
                               nnz=_nnz_table(valid.sum(-1), b.grid))


def _concat3d(a: Dist3DSpMat, b: Dist3DSpMat) -> Dist3DSpMat:
    """Entrywise concat of two same-layout 3D matrices with disjoint
    columns (phase outputs), blocks re-sorted."""
    row, col, val = _sort_blocks(torch.cat([a.row, b.row], -1),
                                 torch.cat([a.col, b.col], -1),
                                 torch.cat([a.val, b.val], -1))
    return dataclasses.replace(a, row=row, col=col, val=val,
                               nnz=a.nnz + b.nnz)


def mem_efficient_spgemm3d(a: Dist3DSpMat, b: Dist3DSpMat,
                           sr: Semiring = PLUS_TIMES, phases: int = 1,
                           flops_cap: int | None = None,
                           out_capacity: int | None = None,
                           phase_hook=None) -> Dist3DSpMat:
    """Phased 3D SpGEMM (``MemEfficientSpGEMM3D``): B in column slabs, each
    through :func:`summa3d_spgemm`, the phase outputs concatenated (their
    columns are disjoint).  ``phase_hook`` runs on each phase's product.
    The caps and the phase loop read only values every process of a pod
    holds alike."""
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


def summa3d_bounds(a: Dist3DSpMat, b: Dist3DSpMat) -> Tuple[int, int]:
    """(flops_cap, out_capacity): the whole product's count rounded up to a
    power of two (at least 64), a safe bound for any block's layer panel;
    on a pod from the whole operands (``to_local``), the same in every
    process."""
    total = spgemm_flops(a.to_local(), b.to_local())
    cap = max(64, 1 << int(np.ceil(np.log2(max(total, 1)))))
    return cap, cap


def summa3d_layer_bounds(a: Dist3DSpMat,
                         b: Dist3DSpMat) -> Tuple[int, int]:
    """(flops_cap, out_capacity) of :func:`summa3d_spgemm` from each
    block's exact layer-panel count, rounded as ``summa_bounds`` rounds;
    :func:`summa3d_bounds` takes the whole product's count, which at scale
    17 would not fit the card.  On a pod each process counts its own
    blocks' panels and the largest count is taken over the processes, so
    that every process gets the same caps."""
    stacks = _panel_stacks(a, b)
    worst = 0
    for t, i, j in itertools.product(*map(range, a.grid.local_shape3())):
        pa, pb = _panels(a, b, i, j, _layer(stacks, t))
        worst = max(worst, int(_entry_counts(pa, pb.row_ptr()).sum()))
    worst = int(exchange.max_proc(torch.tensor(worst), a.grid))
    cap = round_capacity_frac(worst)
    return cap, cap
