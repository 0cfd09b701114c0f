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
``shard_map`` is one batched pass over every block's live entries, folded
by the global row or column each stands for: JAX's ``pmin`` / ``pmax``
over mesh axis 'c' or 'r' and the slice each device keeps, as min and max
are exact in any order.

On a grid over several processes the mate vectors are this process's
slices: a round reads the mates of its blocks' rows and columns from their
owners (``exchange.gather_range``), its blocks' folds meet on the owners
(``exchange.reduce_to_owners``; min and max are exact in any order), and
every round's and level's stop is read over all the processes.  The
augmentation walk takes whole host copies of the mates, as JAX's does, and
hands every process its slices back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from combblas_tpu_torch.models.matching import augment_phases
from combblas_tpu_torch.ops.spmv import _segment_reduce
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
)
from combblas_tpu_torch.parallel.spmv import _active, _pod_input, _pod_plan
from combblas_tpu_torch.parallel.vector import dist_route
from combblas_tpu_torch.semiring import MAX_SECOND, MIN_SECOND

__all__ = ["dist_bp_maximal", "dist_bp_maximum", "dist_awpm"]


class _Blocks:
    """Every block's live entries (on a pod, this process's blocks') with
    their block coordinates, the global row / column each local one stands
    for, and the row / column it has within the span of rows / columns
    this process's blocks cover."""

    def __init__(self, a: DistSpMat):
        g = self.grid = a.grid
        self.a = a
        mb, nb = block_dims(a.gshape, g)
        self.m_pad, self.n_pad = g.pr * mb, g.pc * nb
        self.rows = g.vec_range(self.m_pad)
        self.cols = g.vec_range(self.n_pad)
        lc = g.local_shape()[1]
        r0, c0 = g.origin()
        bid, r, c, v = _live_entries(a)
        self.bid = bid
        li, lj = bid // lc, bid % lc
        self.srow = li * mb + r.clamp(max=mb - 1).long()
        self.scol = lj * nb + c.clamp(max=nb - 1).long()
        self.grow = r0 * mb + self.srow
        self.gcol = c0 * nb + self.scol
        self.val = v

    def ids(self, space: str) -> torch.Tensor:
        """The global ids (int32) of this process's slice of the row-space
        (``'row'``) or column-space (``'col'``) vector."""
        lo, hi = self.rows if space == "row" else self.cols
        return torch.arange(lo, hi, dtype=torch.int32,
                            device=self.val.device)

    def full(self, space: str, fill: int) -> torch.Tensor:
        """This process's slice of an int32 vector of ``fill``."""
        lo, hi = self.rows if space == "row" else self.cols
        return torch.full((hi - lo,), fill, dtype=torch.int32,
                          device=self.val.device)

    def span(self, x: torch.Tensor, space: str, dtype) -> torch.Tensor:
        """The part of a row- or column-space vector (this process's slice)
        that its blocks read, indexed by ``srow`` / ``scol``: in one
        process the whole vector, cut or padded (JAX's ``_pad_to``)."""
        length = self.m_pad if space == "row" else self.n_pad
        return _pod_input(self.a, [x], length, space == "row", [dtype])[0]

    def fold(self, vals: torch.Tensor, space: str, sr, idx=None):
        """Every block's fold of ``vals`` (one per live entry, or per entry
        of ``idx``) by its rows (``space='row'``) or columns, reduced over
        the blocks of the other axis (a min or a max: exact in any order):
        this process's slice of the row-space or column-space vector;
        empty slots the add's identity."""
        seg = self.srow if space == "row" else self.scol
        seg = seg if idx is None else seg[idx]
        _in, length, spans = _pod_plan(self.a, space == "col")
        lo, hi = spans[self.grid.rank]
        part = _segment_reduce(vals, seg, hi - lo, sr)
        if not self.grid.is_pod:
            return part
        y, = exchange.reduce_to_owners([part], spans, length, self.grid,
                                       [sr.add_kind])
        return y

    def extreme_at(self, w: torch.Tensor, space: str, sr) -> torch.Tensor:
        """The reduction of ``w`` over each entry's whole row (``'row'``)
        or column, at every live entry (JAX's ``pmax`` that every block of
        the axis gets)."""
        whole = self.span(self.fold(w, space, sr), space, w.dtype)
        return whole[self.srow if space == "row" else self.scol]


def _any(flag, b: _Blocks) -> bool:
    return exchange.any_proc(flag, b.grid)


def _dist_propose(b: _Blocks, mate_row, mate_col) -> torch.Tensor:
    """Rows propose their least open neighbour column: a blockwise
    segment-min, reduce-scattered (min) over 'c'.  Returns the proposals
    in row space, ``n_pad`` or more for none."""
    mr = b.span(mate_row, "row", torch.int32)
    mc = b.span(mate_col, "col", torch.int32)
    open_e = (mr[b.srow] < 0) & (mc[b.scol] < 0)
    prop = torch.where(open_e, b.gcol, b.n_pad).to(torch.int32)
    return b.fold(prop, "row", MIN_SECOND)


def _propose_accept_round(b: _Blocks, grid, mate_row, mate_col):
    """One distributed propose/accept round (the local
    ``_propose_accept``)."""
    prop = _dist_propose(b, mate_row, mate_col)
    has = prop < b.n_pad
    # columns accept the least proposing row (owner routing, min)
    acc, hit = dist_route(prop, b.ids("row"), has, b.full("col", b.m_pad),
                          grid, combine="min")
    won_c = hit & (acc < b.m_pad)
    new_mate_col = torch.where(won_c, acc, mate_col)
    notice, _ = dist_route(torch.where(won_c, acc, b.m_pad), b.ids("col"),
                           won_c, b.full("row", -1), grid, combine="max")
    new_mate_row = torch.where(notice >= 0, notice, mate_row)
    return new_mate_row, new_mate_col, _any(won_c.any(), b)


def dist_bp_maximal(a: DistSpMat) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy maximal matching on the grid (``BPMaximalMatching.h:24``).
    Returns (mate_row [row space], mate_col [column space]), -1 =
    unmatched; padding slots stay -1 (no edges).  On a pod, this process's
    slices."""
    b = _Blocks(a)
    mate_row, mate_col = b.full("row", -1), b.full("col", -1)
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
    fm = b.span(frontier, "row", torch.bool)
    vc = b.span(visited_col, "col", torch.bool)
    idx, = _active(fm[b.srow] & ~vc[b.scol], torch.arange(
        b.bid.shape[0], device=b.bid.device))
    return b.fold(b.grow[idx].to(torch.int32), "col", MAX_SECOND, idx)


def _dist_alt_bfs(b: _Blocks, grid, m_true: int, mate_row, mate_col):
    """Alternating-path BFS from every unmatched true row (one phase,
    distributed): (parent_col, free columns) in column space."""
    # padded rows have no edges, but their mate_row is -1 ("free"): seed
    # only the true rows
    frontier = (mate_row < 0) & (b.ids("row") < m_true)
    parent_col = b.full("col", -1)
    visited = parent_col >= 0
    while True:
        disc = _dist_alt_level(b, frontier, visited)
        newly = disc >= 0
        if not _any(newly.any(), b):
            break
        parent_col = torch.where(newly & (parent_col < 0), disc, parent_col)
        visited = visited | newly
        # the mates of the newly found matched columns (owner routing,
        # column space to row space)
        nxt = torch.where(newly, mate_col, -1)
        f1, _ = dist_route(torch.where(nxt >= 0, nxt, b.m_pad),
                           b.full("col", 1), nxt >= 0, b.full("row", 0),
                           grid, combine="max")
        frontier = f1 > 0
    return parent_col, visited & (mate_col < 0)


def dist_bp_maximum(a: DistSpMat, init=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum-cardinality matching on the grid
    (``BPMaximumMatching.cpp:207``): the distributed greedy init (or the
    caller's ``init``, e.g. AWPM's weighted matching), then phases of a
    distributed alternating BFS and host augmentation of vertex-disjoint
    paths.  On a pod the mates (``init`` too) are this process's slices;
    the augmentation walks whole host copies in every process alike."""
    mate_row, mate_col = dist_bp_maximal(a) if init is None else init
    b = _Blocks(a)
    (rlo, rhi), (clo, chi) = b.rows, b.cols

    def whole(x):
        return exchange.gather_whole(x, a.grid)

    def bfs(mr, mc):
        pcol, free = _dist_alt_bfs(b, a.grid, a.gshape[0], mr[rlo:rhi],
                                   mc[clo:chi])
        return whole(pcol), whole(free)

    mr, mc = augment_phases(bfs, whole(mate_row), whole(mate_col), b.m_pad,
                            b.n_pad, a.row.device)
    return mr[rlo:rhi], mc[clo:chi]


def _dist_dominant(b: _Blocks, mate_row, mate_col):
    """A locally dominant weighted round, distributed: every entry checked
    against its row's and column's maxima (blockwise segment-max, then the
    max over 'c' / 'r' that every block of the axis gets), then each row's
    least best column and each column's least best row (segment-min,
    reduce-scattered).  Returns (chosen_c row space, chosen_r column
    space)."""
    mr = b.span(mate_row, "row", torch.int32)
    mc = b.span(mate_col, "col", torch.int32)
    open_e = (mr[b.srow] < 0) & (mc[b.scol] < 0)
    w = torch.where(open_e, b.val.to(torch.float32), float("-inf"))
    is_best = open_e & (w == b.extreme_at(w, "row", MAX_SECOND)) & (
        w == b.extreme_at(w, "col", MAX_SECOND))
    ch_c = b.fold(torch.where(is_best, b.gcol, b.n_pad).to(torch.int32),
                  "row", MIN_SECOND)
    ch_r = b.fold(torch.where(is_best, b.grow, b.m_pad).to(torch.int32),
                  "col", MIN_SECOND)
    return ch_c, ch_r


def dist_awpm(a: DistSpMat, complete: bool = True):
    """Approximate-weight (perfect) matching on the grid
    (``ApproxWeightPerfectMatching.h:792,1144``): locally dominant rounds
    (a 1/2-approximation of the maximum weight), then with ``complete`` the
    cardinality completion by :func:`dist_bp_maximum` on the whole
    graph.  On a pod, this process's slices of the mates."""
    b = _Blocks(a)
    grid = a.grid
    mate_row, mate_col = b.full("row", -1), b.full("col", -1)
    rows, cols = b.ids("row"), b.ids("col")
    while True:
        ch_c, ch_r = _dist_dominant(b, mate_row, mate_col)
        # handshake: row r and column c agree iff ch_c[r] == c and
        # ch_r[c] == r; the column side's picks are routed to the rows
        has_r = ch_r < b.m_pad
        pc2, _ = dist_route(torch.where(has_r, ch_r, b.m_pad), cols, has_r,
                            b.full("row", b.n_pad), grid, combine="min")
        agree = (ch_c < b.n_pad) & (pc2 == ch_c)
        if not _any(agree.any(), b):
            break
        mate_row = torch.where(agree, ch_c, mate_row)
        mc_upd, _ = dist_route(torch.where(agree, ch_c, b.n_pad), rows,
                               agree, b.full("col", -1), grid,
                               combine="max")
        mate_col = torch.where(mc_upd >= 0, mc_upd, mate_col)
    if complete:
        return dist_bp_maximum(a, init=(mate_row, mate_col))
    return mate_row, mate_col
