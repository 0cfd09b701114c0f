"""Bipartite matchings on the block grid (port of
``combblas_tpu/parallel/matching.py``).

- :func:`dist_bp_maximal`: greedy maximal matching
  (``BPMaximalMatching.h:24``): propose/accept rounds, each a blockwise
  segment-min, a min over the grid's columns and two owner routings
  (:func:`dist_route`, the alltoallv "Set" of the mate vectors).
- :func:`dist_bp_maximum`: maximum-cardinality matching
  (``BPMaximumMatching.cpp:207``): alternating-BFS levels as distributed
  frontier steps, one host read a level; the augmentation walk runs on
  host copies, the local function's walk.
- :func:`dist_awpm`: locally dominant rounds
  (``ApproxWeightPerfectMatching.h:792``) with the handshake routed
  through the vertex owners.

Vertex vectors keep JAX's FullyDist layouts: mate_row row space (length
``pr*mb``), mate_col column space (``pc*nb``).  Each body JAX ran under
``shard_map`` is one batched pass over every block's live entries, block
(i, j)'s segments offset by its index; the ``pmin`` / ``pmax`` over mesh
axis 'r' or 'c' and the slice each device keeps are
``parallel/spmv.py``'s reductions over the block stack's rows or columns.
"""

from __future__ import annotations

from typing import Tuple

import torch

from combblas_tpu_torch.models.matching import augment_phases
from combblas_tpu_torch.ops.spmv import _segment_reduce
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
)
from combblas_tpu_torch.parallel.grid import single_process
from combblas_tpu_torch.parallel.spmv import (
    _active,
    _axis_reduce,
    _col_space,
    _fold,
    _padded,
    _row_space,
)
from combblas_tpu_torch.parallel.vector import dist_route
from combblas_tpu_torch.semiring import MAX_SECOND, MIN_SECOND

__all__ = ["dist_bp_maximal", "dist_bp_maximum", "dist_awpm"]


class _Blocks:
    """Every block's live entries with their block coordinates and the
    global row / column each local one stands for."""

    def __init__(self, a: DistSpMat):
        self.pr, self.pc = a.grid.pr, a.grid.pc
        self.mb, self.nb = block_dims(a.gshape, a.grid)
        self.m_pad, self.n_pad = self.pr * self.mb, self.pc * self.nb
        bid, r, c, v = _live_entries(a)
        self.bid = bid
        self.rr = r.clamp(max=self.mb - 1).long()
        self.cc = c.clamp(max=self.nb - 1).long()
        self.bi, self.bj = bid // self.pc, bid % self.pc
        self.grow = self.bi * self.mb + self.rr
        self.gcol = self.bj * self.nb + self.cc
        self.val = v
        self.dims = (self.pr, self.pc)


def _pad_mates(b: _Blocks, mate_row, mate_col):
    """The mate vectors at their padded lengths, padded with 0 ("matched"),
    as JAX's ``_pad_to``."""
    return (_padded(mate_row, b.m_pad, torch.int32),
            _padded(mate_col, b.n_pad, torch.int32))


def _dist_propose(b: _Blocks, mate_row, mate_col) -> torch.Tensor:
    """Rows propose their least open neighbour column: a blockwise
    segment-min, reduce-scattered (min) over 'c'.  Returns the proposals
    in row space, ``n_pad`` or more for none."""
    mr, mc = _pad_mates(b, mate_row, mate_col)
    open_e = (mr[b.grow] < 0) & (mc[b.gcol] < 0)
    prop = torch.where(open_e, b.gcol, b.n_pad).to(torch.int32)
    return _row_space(_fold(prop, b.bid * b.mb + b.rr, b.dims, b.mb, "c",
                            MIN_SECOND))


def _propose_accept_round(b: _Blocks, grid, mate_row, mate_col):
    """One distributed propose/accept round (the local
    ``_propose_accept``)."""
    prop = _dist_propose(b, mate_row, mate_col)
    has = prop < b.n_pad
    dev = prop.device
    rows = torch.arange(b.m_pad, dtype=torch.int32, device=dev)
    # columns accept the least proposing row (owner routing, min)
    acc0 = torch.full((b.n_pad,), b.m_pad, dtype=torch.int32, device=dev)
    acc, hit = dist_route(prop, rows, has, acc0, grid, combine="min")
    cols = torch.arange(b.n_pad, dtype=torch.int32, device=dev)
    won_c = hit & (acc < b.m_pad)
    new_mate_col = torch.where(won_c, acc, mate_col)
    notice0 = torch.full((b.m_pad,), -1, dtype=torch.int32, device=dev)
    notice, _ = dist_route(torch.where(won_c, acc, b.m_pad), cols, won_c,
                           notice0, grid, combine="max")
    new_mate_row = torch.where(notice >= 0, notice, mate_row)
    return new_mate_row, new_mate_col, bool(won_c.any())


@single_process
def dist_bp_maximal(a: DistSpMat) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy maximal matching on the grid (``BPMaximalMatching.h:24``).
    Returns (mate_row [row space], mate_col [column space]), -1 =
    unmatched; padding slots stay -1 (no edges)."""
    b = _Blocks(a)
    dev = a.row.device
    mate_row = torch.full((b.m_pad,), -1, dtype=torch.int32, device=dev)
    mate_col = torch.full((b.n_pad,), -1, dtype=torch.int32, device=dev)
    progressed = True
    while progressed:
        mate_row, mate_col, progressed = _propose_accept_round(
            b, a.grid, mate_row, mate_col)
    return mate_row, mate_col


def _dist_alt_level(b: _Blocks, frontier, visited_col) -> torch.Tensor:
    """One alternating-BFS level: frontier rows discover unvisited columns
    (a blockwise segment-max over the active entries, reduce-scattered
    (max) over 'r').  Returns the discovering rows in column space, below
    0 where none."""
    fm = _padded(frontier, b.m_pad, torch.bool)
    vc = _padded(visited_col, b.n_pad, torch.bool)
    active = fm[b.grow] & ~vc[b.gcol]
    grow, seg = _active(active, b.grow, b.bid * b.nb + b.cc)
    return _col_space(_fold(grow.to(torch.int32), seg, b.dims, b.nb, "r",
                            MAX_SECOND))


def _dist_alt_bfs(b: _Blocks, grid, m_true: int, mate_row, mate_col):
    """Alternating-path BFS from every unmatched true row (one phase,
    distributed): (parent_col, free columns) in column space."""
    dev = mate_row.device
    # padded rows have no edges, but their mate_row is -1 ("free"): seed
    # only the true rows
    rows = torch.arange(b.m_pad, device=dev)
    frontier = (mate_row < 0) & (rows < m_true)
    parent_col = torch.full((b.n_pad,), -1, dtype=torch.int32, device=dev)
    visited = torch.zeros(b.n_pad, dtype=torch.bool, device=dev)
    while True:
        disc = _dist_alt_level(b, frontier, visited)
        newly = disc >= 0
        if not bool(newly.any()):
            break
        parent_col = torch.where(newly & (parent_col < 0), disc, parent_col)
        visited = visited | newly
        # the mates of the newly found matched columns (owner routing,
        # column space to row space)
        nxt = torch.where(newly, mate_col, -1)
        f1, _ = dist_route(torch.where(nxt >= 0, nxt, b.m_pad),
                           torch.ones(b.n_pad, dtype=torch.int32, device=dev),
                           nxt >= 0,
                           torch.zeros(b.m_pad, dtype=torch.int32,
                                       device=dev), grid, combine="max")
        frontier = f1 > 0
    return parent_col, visited & (mate_col < 0)


@single_process
def dist_bp_maximum(a: DistSpMat, init=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum-cardinality matching on the grid
    (``BPMaximumMatching.cpp:207``): the distributed greedy init (or the
    caller's ``init``, e.g. AWPM's weighted matching), then phases of a
    distributed alternating BFS and host augmentation of vertex-disjoint
    paths."""
    mate_row, mate_col = dist_bp_maximal(a) if init is None else init
    b = _Blocks(a)
    return augment_phases(
        lambda mr, mc: _dist_alt_bfs(b, a.grid, a.gshape[0], mr, mc),
        mate_row, mate_col, b.m_pad, b.n_pad, a.row.device)


def _dist_dominant(b: _Blocks, mate_row, mate_col):
    """A locally dominant weighted round, distributed: every entry checked
    against its row's and column's maxima (blockwise segment-max, then the
    max over 'c' / 'r' that every block of the axis gets), then each row's
    least best column and each column's least best row (segment-min,
    reduce-scattered).  Returns (chosen_c row space, chosen_r column
    space)."""
    mr, mc = _pad_mates(b, mate_row, mate_col)
    open_e = (mr[b.grow] < 0) & (mc[b.gcol] < 0)
    w = torch.where(open_e, b.val.to(torch.float32), float("-inf"))
    nblk = b.pr * b.pc
    rseg, cseg = b.bid * b.mb + b.rr, b.bid * b.nb + b.cc
    rmax = _axis_reduce(_segment_reduce(w, rseg, nblk * b.mb, MAX_SECOND)
                        .reshape(b.pr, b.pc, b.mb), "c", MAX_SECOND)
    cmax = _axis_reduce(_segment_reduce(w, cseg, nblk * b.nb, MAX_SECOND)
                        .reshape(b.pr, b.pc, b.nb), "r", MAX_SECOND)
    is_best = open_e & (w == rmax.reshape(-1)[rseg]) & (
        w == cmax.reshape(-1)[cseg])
    ch_c = _fold(torch.where(is_best, b.gcol, b.n_pad).to(torch.int32), rseg,
                 b.dims, b.mb, "c", MIN_SECOND)
    ch_r = _fold(torch.where(is_best, b.grow, b.m_pad).to(torch.int32), cseg,
                 b.dims, b.nb, "r", MIN_SECOND)
    return _row_space(ch_c), _col_space(ch_r)


@single_process
def dist_awpm(a: DistSpMat, complete: bool = True):
    """Approximate-weight (perfect) matching on the grid
    (``ApproxWeightPerfectMatching.h:792,1144``): locally dominant rounds
    (a 1/2-approximation of the maximum weight), then with ``complete`` the
    cardinality completion by :func:`dist_bp_maximum` on the whole
    graph."""
    b = _Blocks(a)
    grid = a.grid
    dev = a.row.device
    mate_row = torch.full((b.m_pad,), -1, dtype=torch.int32, device=dev)
    mate_col = torch.full((b.n_pad,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(b.m_pad, dtype=torch.int32, device=dev)
    cols = torch.arange(b.n_pad, dtype=torch.int32, device=dev)
    while True:
        ch_c, ch_r = _dist_dominant(b, mate_row, mate_col)
        # handshake: row r and column c agree iff ch_c[r] == c and
        # ch_r[c] == r; the column side's picks are routed to the rows
        has_r = ch_r < b.m_pad
        pc2, _ = dist_route(
            torch.where(has_r, ch_r, b.m_pad), cols, has_r,
            torch.full((b.m_pad,), b.n_pad, dtype=torch.int32, device=dev),
            grid, combine="min")
        agree = (ch_c < b.n_pad) & (pc2 == ch_c)
        if not bool(agree.any()):
            break
        mate_row = torch.where(agree, ch_c, mate_row)
        mc_upd, _ = dist_route(
            torch.where(agree, ch_c, b.n_pad), rows, agree,
            torch.full((b.n_pad,), -1, dtype=torch.int32, device=dev), grid,
            combine="max")
        mate_col = torch.where(mc_upd >= 0, mc_upd, mate_col)
    if complete:
        return dist_bp_maximum(a, init=(mate_row, mate_col))
    return mate_row, mate_col
