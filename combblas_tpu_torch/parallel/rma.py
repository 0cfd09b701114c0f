"""The one-sided ring SUMMA on the block grid (port of
``combblas_tpu/parallel/rma.py``).

Cannon's schedule: after an initial skew (block (i, j) holds A(i, (i+j) mod
p) and B((i+j) mod p, j)), every stage multiplies each block's resident pair
into its accumulator, then A moves one hop along 'c' and B one hop along
'r' (block (i, j) receives from (i, j-1) and (i-1, j)).  Each block moves
exactly one hop a stage and no collective runs in the steady state.

The hop is K9, the hand-written ring push of ``csrc/ring.cu``
(:func:`combblas_tpu_torch.ops.kernels.ring.ring_hop`): one launch moves
both operands' whole stacks, row ids, column ids, values and nnz, so a call
on a p x p grid launches it p - 1 times (the JAX package: three pushes per
operand per stage).  CPU tensors take its plain version.

On a grid spread over several processes each process runs the stages of
its own blocks.  The skew is a one-time exchange
(:func:`parallel.exchange.gather_blocks`); every stage's hop is K9, which
crosses processes where the ring does (B's hops along 'r' when each process
holds whole block rows) and stays inside one where it does not.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO, merge
from combblas_tpu_torch.ops.kernels.ring import ring_hop
from combblas_tpu_torch.ops.spgemm import _expand
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import DistSpMat
from combblas_tpu_torch.parallel.summa import _check_operands
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["summa_spgemm_rma"]


def _shift_block(pa, pb, grid):
    """One hop for both resident operands: A's (row, col, val, nnz) stacks
    along 'c', B's along 'r', in one ring-shift launch.  Each stage reads
    its pair before the next hop, so a pod's hop may hand out views of its
    ring slot (:func:`ring_hop`)."""
    out = ring_hop([*pa, *pb], ["c"] * 4 + ["r"] * 4, grid)
    return tuple(out[:4]), tuple(out[4:])


def _rma_stage(acc: SpCOO, pa: SpCOO, pb: SpCOO, sr: Semiring, *,
               stage_flops_cap: int, out_capacity: int) -> SpCOO:
    """One stage of one block (the body of the JAX ``_rma_local`` loop):
    the resident pair's first ``stage_flops_cap`` products, merged into the
    accumulator by a (row, col) sort and fold."""
    i, j, v, total = _expand(pa, pb, pb.row_ptr(), sr, stage_flops_cap)
    prods = SpCOO(row=i, col=j, val=v, nnz=total, shape=acc.shape)
    return merge(acc, prods, sr, out_capacity=out_capacity)


def _skew(m: DistSpMat, axis_of_shift: str):
    """The initial Cannon skew: this process's blocks' (row, col, val, nnz)
    stacks after it, along 'c' block (i, j) taking (i, (i+j) mod p), along
    'r' ((i+j) mod p, j).  The blocks come from their owners (in one
    process, one gather of the stacks) and nnz from the table."""
    g = m.grid
    p = g.pr
    lr, lc = g.local_shape()
    pos = [(i, (i + j) % p) if axis_of_shift == "c" else ((i + j) % p, j)
           for i, j in g.local_blocks()]
    stacks = exchange.gather_blocks([m.row, m.col, m.val], g, pos)
    ii, jj = (torch.as_tensor(v, device=m.nnz.device) for v in zip(*pos))
    return tuple(x.reshape(lr, lc, *x.shape[1:])
                 for x in (*stacks, m.nnz[ii, jj]))


def summa_spgemm_rma(a: DistSpMat, b: DistSpMat, sr: Semiring = PLUS_TIMES,
                     *, stage_flops_cap: int,
                     out_capacity: int) -> DistSpMat:
    """Cannon-schedule one-sided SUMMA (``ParFriendsExt.h:58,291`` parity):
    per stage a local ESC product per block and a one-hop ring push of
    both operands.  ``stage_flops_cap`` bounds one stage's products of a
    block; C's blocks have ``out_capacity`` slots."""
    _check_operands(a, b)
    g = a.grid
    p = g.pr
    lr, lc = g.local_shape()
    mb, kb_a = a.block_shape()
    kb_b, nb = b.block_shape()
    pa, pb = _skew(a, "c"), _skew(b, "r")
    dev = a.row.device
    # the accumulators, updated block by block in place
    row = torch.full((lr, lc, out_capacity), mb, dtype=torch.int32,
                     device=dev)
    col = torch.full((lr, lc, out_capacity), nb, dtype=torch.int32,
                     device=dev)
    val = torch.zeros((lr, lc, out_capacity), dtype=a.val.dtype, device=dev)
    nnz = torch.zeros((lr, lc), dtype=torch.int64, device=dev)
    for s in range(p):
        for i in range(lr):
            for j in range(lc):
                c = _rma_stage(
                    SpCOO(row[i, j], col[i, j], val[i, j], nnz[i, j],
                          (mb, nb)),
                    SpCOO(*(x[i, j] for x in pa), shape=(mb, kb_a)),
                    SpCOO(*(x[i, j] for x in pb), shape=(kb_b, nb)), sr,
                    stage_flops_cap=stage_flops_cap,
                    out_capacity=out_capacity)
                row[i, j], col[i, j], val[i, j], nnz[i, j] = (
                    c.row, c.col, c.val, c.nnz)
        if s + 1 < p:
            pa, pb = _shift_block(pa, pb, g)
    return DistSpMat(row=row, col=col, val=val,
                     nnz=exchange.gather_table(nnz, g),
                     gshape=(a.gshape[0], b.gshape[1]), grid=g)
