"""DistSpMat / DistVec — the 2D-block-distributed sparse matrix and dense
vector (port of ``combblas_tpu/parallel/dist.py``).

A DistSpMat holds block-stacked padded-COO tensors of shape (pr, pc, cap)
with block-local coordinates and ``nnz`` of shape (pr, pc), as the JAX
package does; block (i, j) is what JAX's ``shard_map`` handed device (i, j).
Every block shares one capacity, a power of two (at least 8), and block
(i, j) pads past its nnz with (mb, nb, 0).  All blocks lie on the grid's
device.  ``nnz`` is int64, as the port's SpCOO keeps it.
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
    find,
)
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.parallel.multihost import global_put

__all__ = ["DistSpMat", "DistVec", "block_dims", "row_vec_len",
           "col_vec_len", "local_block", "dist_vec"]


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


def _bucket_blocks(row, col, val, gshape, grid: ProcGrid, capacity, dtype):
    """Host numpy block stacks (R, C, V, counts) of global COO triples, as
    the JAX ``from_coo_arrays`` lays them out: sorted by (block, local row,
    local col), duplicates summed in that order, capacity rounded up to a
    power of two (at least 8), pads (mb, nb, 0)."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, dtype)
    pr, pc = grid.pr, grid.pc
    mb, nb = block_dims(gshape, grid)
    bi, bj = row // mb, col // nb
    lr = (row - bi * mb).astype(np.int32)
    lc = (col - bj * nb).astype(np.int32)
    order = np.lexsort((lc, lr, bj, bi))
    bi, bj, lr, lc = bi[order], bj[order], lr[order], lc[order]
    val = val[order]
    if row.size:
        new = np.empty(row.size, bool)
        new[0] = True
        new[1:] = ((bi[1:] != bi[:-1]) | (bj[1:] != bj[:-1])
                   | (lr[1:] != lr[:-1]) | (lc[1:] != lc[:-1]))
        seg = np.cumsum(new) - 1
        sval = np.zeros(int(seg[-1]) + 1, val.dtype)
        np.add.at(sval, seg, val)
        bi, bj, lr, lc, val = bi[new], bj[new], lr[new], lc[new], sval
    counts = np.zeros((pr, pc), np.int64)
    np.add.at(counts, (bi, bj), 1)
    cap = int(counts.max()) if capacity is None else capacity
    cap = max(8, 1 << int(np.ceil(np.log2(max(cap, 1)))))
    R = np.full((pr, pc, cap), mb, np.int32)
    C = np.full((pr, pc, cap), nb, np.int32)
    V = np.zeros((pr, pc, cap), dtype)
    flat_block = bi * pc + bj
    starts = np.searchsorted(flat_block, np.arange(pr * pc))
    pos = np.arange(bi.size) - starts[flat_block]
    R[bi, bj, pos] = lr
    C[bi, bj, pos] = lc
    V[bi, bj, pos] = val
    return R, C, V, counts


def _gather_blocks(row, col, val, nnz, row_off, col_off,
                   shape: Tuple[int, int]) -> SpCOO:
    """The live entries of a (g, cap) stack of blocks, block after block,
    as one SpCOO of capacity g*cap: block s's first ``nnz[s]`` entries
    shifted by (``row_off[s]``, ``col_off[s]``; None: no shift), then
    (m, n, 0) pads.  Rows are sorted only within each block.  No host
    sync."""
    g, cap = row.shape
    m, n = shape
    dev = row.device
    t = torch.arange(cap, device=dev)
    live = t[None, :] < nnz[:, None]
    start = torch.cumsum(nnz, 0) - nnz
    dest = torch.where(live, start[:, None] + t[None, :], g * cap).reshape(-1)

    def put(x, fill, off=None):
        out = torch.full((g * cap + 1,), fill, dtype=x.dtype, device=dev)
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
    block with (mb, nb, 0) past its nnz; nnz: (pr, pc) int64; gshape is the
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
        """Bucket global COO triples to their blocks on the host (duplicates
        summed), then put the stacks on the grid's device: the JAX
        package's stacks, slot for slot."""
        R, C, V, counts = _bucket_blocks(row, col, val, gshape, grid,
                                         capacity, dtype)
        return DistSpMat.from_numpy_blocks(R, C, V, counts, gshape, grid)

    @staticmethod
    def from_numpy_blocks(row, col, val, nnz, gshape: Tuple[int, int],
                          grid: ProcGrid) -> "DistSpMat":
        """Block stacks as numpy (``np.asarray`` of a JAX DistSpMat's
        fields) to a port DistSpMat on the grid's device, bit for bit."""
        row, col = np.asarray(row, np.int32), np.asarray(col, np.int32)
        if row.shape[:2] != (grid.pr, grid.pc) or row.shape != col.shape \
                or row.shape != np.shape(val):
            raise ValueError(f"block stacks of shapes {row.shape}, "
                             f"{col.shape}, {np.shape(val)} on a "
                             f"{grid.pr}x{grid.pc} grid")
        return DistSpMat(row=global_put(row, grid), col=global_put(col, grid),
                         val=global_put(val, grid),
                         nnz=global_put(np.asarray(nnz, np.int64), grid),
                         gshape=(int(gshape[0]), int(gshape[1])), grid=grid)

    @staticmethod
    def from_local(a: SpCOO, grid: ProcGrid,
                   capacity: int | None = None) -> "DistSpMat":
        """Distribute a single-device SpCOO onto the grid."""
        row, col, val = find(a)
        return DistSpMat.from_coo_arrays(row, col, val, a.shape, grid,
                                         capacity=capacity, dtype=val.dtype)

    # -- conversions ------------------------------------------------------
    def to_local(self) -> SpCOO:
        """All blocks as one SpCOO on the grid's device: the live entries
        in global coordinates, (row, col) sorted, capacity the power of two
        (at least 8) at or above nnz, as the JAX ``to_local`` builds it."""
        pr, pc = self.grid.pr, self.grid.pc
        mb, nb = self.block_shape()
        dev = self.row.device
        ii = torch.arange(pr, device=dev).repeat_interleave(pc)
        jj = torch.arange(pc, device=dev).repeat(pr)
        flat = _gather_blocks(
            self.row.reshape(pr * pc, -1), self.col.reshape(pr * pc, -1),
            self.val.reshape(pr * pc, -1), self.nnz.reshape(-1), ii * mb,
            jj * nb, self.gshape)
        total = int(flat.nnz)
        row, col, val = _sort_pairs(flat.row[:total], flat.col[:total],
                                    flat.val[:total])
        del flat
        out = SpCOO(row=row, col=col, val=val, nnz=torch.tensor(
            total, dtype=torch.int64, device=dev), shape=self.gshape)
        return out.with_capacity(_round_capacity(total))

    def to_dense(self) -> np.ndarray:
        return self.to_local().to_dense().cpu().numpy()


def local_block(mat: DistSpMat, i: int, j: int) -> SpCOO:
    """Block (i, j) as an SpCOO of the block shape (what device (i, j) saw
    under the JAX package's ``shard_map``); views, no copy."""
    return SpCOO(row=mat.row[i, j], col=mat.col[i, j], val=mat.val[i, j],
                 nnz=mat.nnz[i, j], shape=mat.block_shape())


@dataclasses.dataclass(frozen=True)
class DistVec:
    """The FullyDist dense-vector layout: a flat tensor of the padded
    global length (a multiple of pr*pc) on the grid's device."""

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
        return global_put(xp, self.grid)


def dist_vec(x, grid: ProcGrid) -> torch.Tensor:
    """A host vector in the FullyDist layout (zero-padded)."""
    x = np.asarray(x)
    return DistVec(grid, x.shape[0]).put(x)
