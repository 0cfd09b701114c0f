"""DistSpMat / DistVec — the 2D-block-distributed sparse matrix and dense
vector (port of ``combblas_tpu/parallel/dist.py``).

A DistSpMat holds block-stacked padded-COO tensors of shape (pr, pc, cap)
with block-local coordinates and ``nnz`` of shape (pr, pc), as the JAX
package does; block (i, j) is what JAX's ``shard_map`` handed device (i, j).
Every block shares one capacity, a power of two (at least 8), and block
(i, j) pads past its nnz with (mb, nb, 0).  All blocks lie on the grid's
device.  ``nnz`` is int64, as the port's SpCOO keeps it.

On a grid spread over several processes (a pod) the stacks hold only this
process's blocks: (lr, lc, cap), the blocks [r0, r0+lr) x [c0, c0+lc) of
:meth:`ProcGrid.local_shape` / :meth:`ProcGrid.origin` (in one process
(pr, pc, cap), as before).  ``nnz`` stays the whole (pr, pc) table in every
process, as JAX's replicated ``nnz`` is read on every host: each
constructor and each product refreshes it with one host all-gather, so
capacities, retries and loop stops read the same numbers everywhere.
Every process has the same capacity.  A FullyDist vector is this
process's slice of the padded vector (:meth:`ProcGrid.vec_range`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import (
    SpCOO,
    _round_capacity,
    _sort_pairs,
)
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.parallel.multihost import global_put

__all__ = ["DistSpMat", "DistVec", "block_dims", "row_vec_len",
           "col_vec_len", "local_block", "dist_vec", "live_counts"]


def block_dims(gshape: Tuple[int, int], grid: ProcGrid) -> Tuple[int, int]:
    """Per-block (mb, nb): the global dims over the grid, rounded up, with
    mb also rounded up to a multiple of pc and nb to a multiple of pr (so
    that the FullyDist vector layout tiles each block exactly)."""
    m, n = gshape
    mb = -(-m // grid.pr)
    nb = -(-n // grid.pc)
    mb = -(-mb // grid.pc) * grid.pc
    nb = -(-nb // grid.pr) * grid.pr
    return mb, nb


def row_vec_len(gshape: Tuple[int, int], grid: ProcGrid) -> int:
    """Padded global length of a row-space (length-m) FullyDist vector."""
    return grid.pr * block_dims(gshape, grid)[0]


def col_vec_len(gshape: Tuple[int, int], grid: ProcGrid) -> int:
    """Padded global length of a column-space (length-n) FullyDist vector."""
    return grid.pc * block_dims(gshape, grid)[1]


def _fold_runs(val: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Sums of the runs of ``val`` that start where ``first`` holds, each
    folded in a fixed order (``segment_reduce`` over the runs' lengths: on
    the CPU in entry order, as the JAX package's host bucketing sums;
    integers with ``index_add_``, exact in any order), so that two calls
    sum alike on the card too."""
    seg = torch.cumsum(first, 0) - 1
    k = int(seg[-1]) + 1
    if val.is_floating_point():
        return torch.segment_reduce(val, "sum", lengths=torch.bincount(
            seg, minlength=k), unsafe=True)
    return torch.zeros(k, dtype=val.dtype, device=val.device).index_add_(
        0, seg, val)


def _bucket_blocks(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   gshape, grid: ProcGrid, capacity):
    """Block stacks (R, C, V of shape (pr, pc, cap), counts (pr, pc) int64)
    of global COO triples, on the triples' device, as the JAX
    ``from_coo_arrays`` lays them out: sorted by (block, local row, local
    col), duplicates summed in that order, capacity rounded up to a power
    of two (at least 8), pads (mb, nb, 0).  A block past ``capacity``
    raises ``ValueError``.  On a pod only this process's blocks are built
    (the counts are the whole table, all-gathered)."""
    mb, nb = block_dims(gshape, grid)
    box = ((grid.origin(), grid.local_shape()) if grid.is_pod
           else ((0, 0), (grid.pr, grid.pc)))
    ents = _box_entries(row, col, val, mb, nb, box, own=grid.is_pod)
    table = exchange.gather_table(ents[-1].reshape(box[1]), grid)
    cap = _block_capacity(int(table.max()), capacity)
    return (*_fill_box(ents, box[1], cap, mb, nb), table)


def _box_entries(row, col, val, mb: int, nb: int, box, own: bool):
    """The triples of the box ``((r0, c0), (lr, lc))`` of (mb, nb) blocks
    (``own``: drop the others; else every triple lies in it) sorted by
    (block, local row, local col), duplicates summed in that order: (block
    index within the box, local row, local col, value, count a block)."""
    dev = row.device
    row, col = row.long(), col.long()
    (r0, c0), (pr, pc) = box
    bi, bj = row // mb, col // nb
    if own:     # keep the box's triples; block ids within the box
        keep = torch.nonzero((bi >= r0) & (bi < r0 + pr) & (bj >= c0)
                             & (bj < c0 + pc)).squeeze(1)
        row, col, val = row[keep], col[keep], val[keep]
        bi, bj = bi[keep] - r0, bj[keep] - c0
        row, col = row - r0 * mb, col - c0 * nb
    lr, lc = row - bi * mb, col - bj * nb
    blk = bi * pc + bj
    key, order = torch.sort((blk * mb + lr) * nb + lc, stable=True)
    blk, lr, lc, val = blk[order], lr[order], lc[order], val[order]
    if key.numel():     # fold duplicates
        new = torch.ones(key.shape[0], dtype=torch.bool, device=dev)
        new[1:] = key[1:] != key[:-1]
        if not bool(new.all()):
            val = _fold_runs(val, new)
            blk, lr, lc = blk[new], lr[new], lc[new]
    return blk, lr, lc, val, torch.bincount(blk, minlength=pr * pc)


def _block_capacity(most: int, capacity) -> int:
    """The stacks' capacity: ``capacity`` (default ``most``, the fullest
    block's count) rounded up to a power of two, at least 8; ``ValueError``
    when ``most`` passes it."""
    cap = most if capacity is None else capacity
    cap = max(8, 1 << int(np.ceil(np.log2(max(cap, 1)))))
    if most > cap:
        raise ValueError(f"a block holds {most} entries, past the capacity "
                         f"{cap}")
    return cap


def _fill_box(ents, shape, cap: int, mb: int, nb: int):
    """(R, C, V) stacks of ``shape`` + (cap,) of :func:`_box_entries`'
    result, each block's entries first, then pads (mb, nb, 0)."""
    blk, lr, lc, val, counts = ents
    dev = blk.device
    g = shape[0] * shape[1]
    pos = torch.arange(blk.shape[0], device=dev) - (
        torch.cumsum(counts, 0) - counts)[blk]
    R = torch.full((g, cap), mb, dtype=torch.int32, device=dev)
    C = torch.full((g, cap), nb, dtype=torch.int32, device=dev)
    V = torch.zeros((g, cap), dtype=val.dtype, device=dev)
    R[blk, pos] = lr.to(torch.int32)
    C[blk, pos] = lc.to(torch.int32)
    V[blk, pos] = val
    return (R.reshape(*shape, cap), C.reshape(*shape, cap),
            V.reshape(*shape, cap))


def _gather_blocks(row, col, val, nnz, row_off, col_off,
                   shape: Tuple[int, int]) -> SpCOO:
    """The live entries of a (g, cap) stack of blocks, block after block,
    as one SpCOO of capacity g*cap: block s's first ``nnz[s]`` entries
    shifted by (``row_off[s]``, ``col_off[s]``; None: no shift), then
    (m, n, 0) pads.  Rows are sorted only within each block.  No host
    sync."""
    g, cap = row.shape
    t = torch.arange(cap, device=row.device)
    live = t[None, :] < nnz[:, None]
    start = torch.cumsum(nnz, 0) - nnz
    dest = torch.where(live, start[:, None] + t[None, :], g * cap)
    return _put_blocks(row, col, val, nnz, dest, row_off, col_off, shape)


def _put_blocks(row, col, val, nnz, dest, row_off, col_off,
                shape: Tuple[int, int]) -> SpCOO:
    """The live entries of a (g, cap) stack of blocks scattered to ``dest``
    ((g, cap) int64: each entry's slot in the result, ``g * cap`` for a
    pad), shifted as :func:`_gather_blocks` shifts them, the other slots
    (m, n, 0) pads."""
    g, cap = row.shape
    m, n = shape
    dest = dest.reshape(-1)

    def put(x, fill, off=None):
        out = torch.full((g * cap + 1,), fill, dtype=x.dtype,
                         device=x.device)
        if off is not None:
            x = x + off[:, None].to(x.dtype)
        out.scatter_(0, dest, x.reshape(-1))
        return out[:-1]

    return SpCOO(row=put(row, m, row_off), col=put(col, n, col_off),
                 val=put(val, 0), nnz=nnz.sum(), shape=(int(m), int(n)))


@dataclasses.dataclass(frozen=True)
class DistSpMat:
    """2D block-distributed sparse matrix.

    row/col/val: (pr, pc, cap) with block-local coordinates, padded per
    block with (mb, nb, 0) past its nnz ((lr, lc, cap), this process's
    blocks, on a pod); nnz: (pr, pc) int64, every block's; gshape is the
    true (unpadded) global shape."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    nnz: torch.Tensor
    gshape: Tuple[int, int]
    grid: ProcGrid

    @property
    def capacity(self) -> int:
        return self.row.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    def block_shape(self) -> Tuple[int, int]:
        return block_dims(self.gshape, self.grid)

    @property
    def local_nnz(self) -> torch.Tensor:
        """The nnz of this process's blocks, (lr, lc): ``nnz`` itself in
        one process."""
        if not self.grid.is_pod:
            return self.nnz
        (r0, c0), (lr, lc) = self.grid.origin(), self.grid.local_shape()
        return self.nnz[r0:r0 + lr, c0:c0 + lc]

    def total_nnz(self) -> torch.Tensor:
        return self.nnz.sum()

    def load_imbalance(self) -> torch.Tensor:
        """max block nnz / mean block nnz (1.0 is balanced), float32."""
        mean = torch.clamp(self.nnz.to(torch.float32).mean(), min=1e-9)
        return self.nnz.max().to(torch.float32) / mean

    # -- host constructors ------------------------------------------------
    @staticmethod
    def from_coo_arrays(row, col, val, gshape: Tuple[int, int],
                        grid: ProcGrid, capacity: int | None = None,
                        dtype=np.float32) -> "DistSpMat":
        """Bucket global COO triples (host arrays) to their blocks on the
        grid's device (duplicates summed): the JAX package's stacks, slot
        for slot."""
        dev = grid.device
        R, C, V, counts = _bucket_blocks(
            torch.from_numpy(np.array(row, np.int64)).to(dev),
            torch.from_numpy(np.array(col, np.int64)).to(dev),
            torch.from_numpy(np.array(val, dtype)).to(dev), gshape, grid,
            capacity)
        return DistSpMat(row=R, col=C, val=V, nnz=counts,
                         gshape=(int(gshape[0]), int(gshape[1])), grid=grid)

    @staticmethod
    def from_numpy_blocks(row, col, val, nnz, gshape: Tuple[int, int],
                          grid: ProcGrid) -> "DistSpMat":
        """Block stacks as numpy (``np.asarray`` of a JAX DistSpMat's
        fields) to a port DistSpMat on the grid's device, bit for bit (on
        a pod, this process's blocks of them)."""
        row, col = np.asarray(row, np.int32), np.asarray(col, np.int32)
        if row.shape[:2] != (grid.pr, grid.pc) or row.shape != col.shape \
                or row.shape != np.shape(val):
            raise ValueError(f"block stacks of shapes {row.shape}, "
                             f"{col.shape}, {np.shape(val)} on a "
                             f"{grid.pr}x{grid.pc} grid")
        return DistSpMat(row=global_put(row, grid, "blocks"),
                         col=global_put(col, grid, "blocks"),
                         val=global_put(val, grid, "blocks"),
                         nnz=global_put(np.asarray(nnz, np.int64), grid),
                         gshape=(int(gshape[0]), int(gshape[1])), grid=grid)

    @staticmethod
    def from_local(a: SpCOO, grid: ProcGrid,
                   capacity: int | None = None) -> "DistSpMat":
        """Distribute a single-device SpCOO onto the grid: its live triples
        bucketed on the grid's device, as :meth:`from_coo_arrays` does."""
        nnz = int(a.nnz)
        dev = grid.device
        R, C, V, counts = _bucket_blocks(
            a.row[:nnz].to(dev), a.col[:nnz].to(dev), a.val[:nnz].to(dev),
            a.shape, grid, capacity)
        return DistSpMat(row=R, col=C, val=V, nnz=counts,
                         gshape=(int(a.shape[0]), int(a.shape[1])),
                         grid=grid)

    # -- conversions ------------------------------------------------------
    def to_local(self) -> SpCOO:
        """All blocks as one SpCOO on the grid's device: the live entries
        in global coordinates, (row, col) sorted, capacity the power of two
        (at least 8) at or above nnz, as the JAX ``to_local`` builds it.
        On a pod every process gets the whole matrix (an all-gather of the
        blocks' live entries), which JAX cannot do across controllers."""
        pr, pc = self.grid.local_shape()
        (r0, c0) = self.grid.origin()
        mb, nb = self.block_shape()
        dev = self.row.device
        ii = torch.arange(pr, device=dev).repeat_interleave(pc) + r0
        jj = torch.arange(pc, device=dev).repeat(pr) + c0
        flat = _gather_blocks(
            self.row.reshape(pr * pc, -1), self.col.reshape(pr * pc, -1),
            self.val.reshape(pr * pc, -1), self.local_nnz.reshape(-1),
            ii * mb, jj * nb, self.gshape)
        total = int(flat.nnz)
        row, col, val = flat.row[:total], flat.col[:total], flat.val[:total]
        if self.grid.is_pod:
            row, col, val = exchange.allgather_var([row, col, val])
            total = int(row.shape[0])
        row, col, val = _sort_pairs(row, col, val)
        del flat
        out = SpCOO(row=row, col=col, val=val, nnz=torch.tensor(
            total, dtype=torch.int64, device=dev), shape=self.gshape)
        return out.with_capacity(_round_capacity(total))

    def to_dense(self) -> np.ndarray:
        return self.to_local().to_dense().cpu().numpy()


def local_block(mat: DistSpMat, i: int, j: int) -> SpCOO:
    """Block (i, j) as an SpCOO of the block shape (what device (i, j) saw
    under the JAX package's ``shard_map``); views, no copy.  On a pod the
    block must be this process's."""
    r0, c0 = mat.grid.origin()
    return SpCOO(row=mat.row[i - r0, j - c0], col=mat.col[i - r0, j - c0],
                 val=mat.val[i - r0, j - c0], nnz=mat.nnz[i, j],
                 shape=mat.block_shape())


def live_counts(mat: DistSpMat) -> list:
    """Each of this process's blocks' live entries, ``min(nnz,
    capacity)``, block after block in (i, j) order, read on the host once.
    A block's live entries are the first slots of its stack."""
    return torch.clamp(mat.local_nnz, max=mat.capacity).reshape(-1).tolist()


def _live_entries(mat: DistSpMat, counts: list | None = None):
    """Every block's live entries back to back in (i, j) block order: the
    block index ``i*pc + j`` (int64), the local rows and columns (int32)
    and the values.  The batched pass over the stack that replaces a loop
    of per-block bodies reads these, with block offsets added to its
    segment ids; the pads past each block's nnz are never touched.  On a
    pod, this process's blocks, indexed ``i*lc + j`` within its share."""
    pc = mat.grid.local_shape()[1]
    k = live_counts(mat) if counts is None else counts
    dev = mat.row.device
    blocks = [(b, kb) for b, kb in enumerate(k) if kb]
    if not blocks:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                mat.row.new_empty((0,)), mat.col.new_empty((0,)),
                mat.val.new_empty((0,)))
    bid = torch.cat([torch.full((kb,), b, dtype=torch.int64, device=dev)
                     for b, kb in blocks])

    def cat(x):
        return torch.cat([x[b // pc, b % pc, :kb] for b, kb in blocks])

    return bid, cat(mat.row), cat(mat.col), cat(mat.val)


@dataclasses.dataclass(frozen=True)
class DistVec:
    """The FullyDist dense-vector layout: a flat tensor of the padded
    global length (a multiple of pr*pc) on the grid's device; on a pod,
    this process's slice of it."""

    grid: ProcGrid
    length: int

    @property
    def padded(self) -> int:
        p = self.grid.pr * self.grid.pc
        return -(-self.length // p) * p

    def put(self, x) -> torch.Tensor:
        x = np.asarray(x)
        xp = np.zeros(self.padded, x.dtype)
        xp[: self.length] = x
        return global_put(xp, self.grid, "vector")


def dist_vec(x, grid: ProcGrid) -> torch.Tensor:
    """A host vector in the FullyDist layout (zero-padded)."""
    x = np.asarray(x)
    return DistVec(grid, x.shape[0]).put(x)
