"""Bipartite matchings: greedy maximal, augmenting-path maximum and
approximate-weight (port of ``combblas_tpu/models/matching.py``).

Rows and columns of the (m, n) sparse matrix are the two vertex classes;
mate vectors are int32 with -1 for unmatched, on the matrix's device.

- :func:`bp_maximal_matching`: propose/accept rounds.  Every unmatched row
  proposes its least open neighbour column and every column accepts its
  least proposing row: two segment-min folds a round over the live entries
  (``scatter_reduce`` from the type's extreme, as JAX's ``segment_min``
  leaves an empty segment), one host read a round.
- :func:`bp_maximum_matching`: phases of an alternating BFS from the free
  rows, a host loop with one read a level (JAX's ``lax.while_loop``), then
  the augmentation walk over the free columns in ascending order on host
  copies, taking every vertex-disjoint path as JAX does.
- :func:`awpm`: locally dominant rounds (an edge heaviest for both its
  ends is matched), then the maximum-cardinality completion.

A write that JAX drops (``.at[].set(mode="drop")``) lands on a spare slot
of its own past the vector, so that no one slot gathers them all.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import _segment_reduce
from combblas_tpu_torch.semiring import MAX_SECOND, MIN_SECOND

__all__ = [
    "bp_maximal_matching",
    "bp_maximum_matching",
    "awpm",
    "matching_weight",
    "is_valid_matching",
]


def _live(a: SpCOO):
    """The live (row, col, val) of ``a`` (one host read of nnz), rows and
    columns int64."""
    k = min(int(a.nnz), a.capacity)
    return a.row[:k].long(), a.col[:k].long(), a.val[:k]


def _spare(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """``idx`` where ``ok`` holds, else a slot of its own past ``size``."""
    return torch.where(ok, idx, size + torch.arange(
        idx.shape[0], device=idx.device))


def _put(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
         val: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(val)`` where ``ok`` holds (JAX ``mode="drop"``)."""
    n = x.shape[0]
    buf = torch.cat([x, x.new_empty(idx.shape[0])])
    buf[_spare(idx, ok, n)] = val.to(x.dtype)
    return buf[:n]


def _handshake(a_shape, choice: torch.Tensor, accept: torch.Tensor,
               mate_row: torch.Tensor, mate_col: torch.Tensor):
    """Match row r with column ``choice[r]`` where that column's
    ``accept`` is r; returns (mate_row, mate_col, progressed)."""
    m, n = a_shape
    rows = torch.arange(m, dtype=torch.int32, device=choice.device)
    won = (choice < n) & (accept[choice.clamp(max=n - 1).long()] == rows)
    new_mate_row = torch.where(won, choice.to(torch.int32), mate_row)
    new_mate_col = _put(mate_col, choice.long(), won, rows)
    return new_mate_row, new_mate_col, bool(won.any())


def _propose_accept(a: SpCOO, live, mate_row, mate_col):
    """One round: each unmatched row proposes its least unmatched
    neighbour column; each column accepts its least proposing row.
    Returns (mate_row, mate_col, progressed)."""
    m, n = a.shape
    r, c, _ = live
    open_edge = (mate_row[r] < 0) & (mate_col[c] < 0)
    prop = _segment_reduce(torch.where(open_edge, c, n).to(torch.int32), r,
                           m, MIN_SECOND)
    has_prop = prop < n
    rows = torch.arange(m, dtype=torch.int32, device=prop.device)
    acc = _segment_reduce(rows, _spare(prop.long(), has_prop, n), n + m,
                          MIN_SECOND)[:n]
    return _handshake(a.shape, prop, acc, mate_row, mate_col)


def bp_maximal_matching(a: SpCOO) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy maximal matching: (mate_row[m], mate_col[n]), -1 = unmatched
    (the reference's ``MaximalMatching`` greedy init,
    ``BPMaximalMatching.h:24``)."""
    m, n = a.shape
    mate_row = torch.full((m,), -1, dtype=torch.int32, device=a.device)
    mate_col = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    live = _live(a)
    progressed = True
    while progressed:
        mate_row, mate_col, progressed = _propose_accept(a, live, mate_row,
                                                         mate_col)
    return mate_row, mate_col


def _alt_level(live, n: int, frontier, visited) -> torch.Tensor:
    """One alternating-BFS level: each unvisited column reached from the
    frontier rows records its largest discovering row (a segment-max over
    the active entries only); below 0 where none."""
    r, c, _ = live
    idx = torch.nonzero(frontier[r] & ~visited[c]).squeeze(1)
    return _segment_reduce(r[idx].to(torch.int32), c[idx], n, MAX_SECOND)


def _alt_bfs(a: SpCOO, live, mate_row, mate_col):
    """Alternating-path BFS from every unmatched row (one phase): returns
    (parent_col[n], the discovering row or -1; the reached free columns).
    Row layers advance through matched columns only, one host read a
    level."""
    m, n = a.shape
    frontier = mate_row < 0
    parent_col = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    visited = torch.zeros(n, dtype=torch.bool, device=a.device)
    while True:
        disc = _alt_level(live, n, frontier, visited)
        newly = disc >= 0
        if not bool(newly.any()):
            break
        parent_col = torch.where(newly & (parent_col < 0), disc, parent_col)
        visited = visited | newly
        nxt = torch.where(newly, mate_col, -1).long()
        frontier = _put(torch.zeros(m, dtype=torch.bool, device=a.device),
                        nxt, nxt >= 0, torch.ones_like(nxt, dtype=torch.bool))
    return parent_col, visited & (mate_col < 0)


def _host_vec(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _augment(parent_col: list, free: list, mr: np.ndarray, mc: np.ndarray,
             m: int, n: int) -> int:
    """Augment, in place on the host mate vectors, every path found by
    walking back from the free columns in ascending order that shares no
    vertex with a path taken before it (JAX's walk, step for step).  A
    path reads ``mr`` only at rows no earlier path took, so the phase's
    snapshot serves.  Returns the number of paths."""
    mr_snap = mr.tolist()
    used_row = bytearray(m)
    used_col = bytearray(n)
    augmented = 0
    for c0 in free:
        path = []
        c = c0
        ok = True
        while True:
            r = parent_col[c]
            if r < 0 or used_row[r] or used_col[c]:
                ok = False
                break
            path.append((r, c))
            prev_c = mr_snap[r]
            if prev_c < 0:
                break
            c = prev_c
        if not ok or not path:
            continue
        for r, c in path:
            used_row[r] = 1
            used_col[c] = 1
            mr[r] = c
            mc[c] = r
        augmented += 1
    return augmented


def augment_phases(bfs, mate_row, mate_col, m: int, n: int, device):
    """The phase loop of the maximum matchings: ``bfs(mate_row, mate_col)``
    gives (parent_col, free columns) on the device; the paths augment on
    host copies, uploaded once a phase.  Returns the mate tensors."""
    mr = _host_vec(mate_row).astype(np.int32).copy()
    mc = _host_vec(mate_col).astype(np.int32).copy()
    while True:
        parent_col, free_cols = bfs(torch.from_numpy(mr).to(device),
                                    torch.from_numpy(mc).to(device))
        free = torch.nonzero(free_cols).squeeze(1).tolist()
        if not free:
            break
        if _augment(parent_col.tolist(), free, mr, mc, m, n) == 0:
            break
    return torch.from_numpy(mr).to(device), torch.from_numpy(mc).to(device)


def bp_maximum_matching(a: SpCOO, init=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum-cardinality matching (``BPMaximumMatching.cpp:207``): the
    greedy init (or the caller's ``init=(mate_row, mate_col)``), then
    phases of an alternating BFS and augmentation of vertex-disjoint
    paths."""
    mate_row, mate_col = bp_maximal_matching(a) if init is None else init
    m, n = a.shape
    live = _live(a)
    return augment_phases(lambda mr, mc: _alt_bfs(a, live, mr, mc),
                          mate_row, mate_col, m, n, a.device)


def _dominant_round(a: SpCOO, live, mate_row, mate_col):
    """One locally dominant round: match the edges heaviest for both ends
    (Preis / Manne-Bisseling, the engine of
    ``ApproxWeightPerfectMatching.h:792``); ties go to the least column,
    then the least row."""
    m, n = a.shape
    r, c, v = live
    open_e = (mate_row[r] < 0) & (mate_col[c] < 0)
    w = torch.where(open_e, v.to(torch.float32), float("-inf"))
    rmax = _segment_reduce(w, r, m, MAX_SECOND)
    cmax = _segment_reduce(w, c, n, MAX_SECOND)
    is_best = open_e & (w == rmax[r]) & (w == cmax[c])
    chosen_c = _segment_reduce(torch.where(is_best, c, n).to(torch.int32), r,
                               m, MIN_SECOND)
    chosen_r = _segment_reduce(torch.where(is_best, r, m).to(torch.int32), c,
                               n, MIN_SECOND)
    return _handshake(a.shape, chosen_c, chosen_r, mate_row, mate_col)


def awpm(a: SpCOO, complete: bool = True):
    """Approximate-weight (perfect) matching
    (``ApproxWeightPerfectMatching.h:792,1144``): locally dominant rounds
    (a 1/2-approximation of the maximum weight), then with ``complete``
    the augmenting phases on the whole graph from that matching, which
    keep every matched vertex matched."""
    m, n = a.shape
    mate_row = torch.full((m,), -1, dtype=torch.int32, device=a.device)
    mate_col = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    live = _live(a)
    progressed = True
    while progressed:
        mate_row, mate_col, progressed = _dominant_round(a, live, mate_row,
                                                         mate_col)
    if complete:
        mate_row, mate_col = bp_maximum_matching(a, init=(mate_row,
                                                          mate_col))
    return mate_row, mate_col


def matching_weight(a_dense, mate_row) -> float:
    """Host: the summed weight of the matched edges."""
    a_dense = _host_vec(a_dense)
    mr = _host_vec(mate_row)
    return float(sum(a_dense[r, c] for r, c in enumerate(mr) if c >= 0))


def is_valid_matching(a_dense, mate_row, mate_col) -> bool:
    """Host check: mates are consistent and every matched pair is an
    edge."""
    a_dense = _host_vec(a_dense)
    mate_row = _host_vec(mate_row)
    mate_col = _host_vec(mate_col)
    for r, c in enumerate(mate_row):
        if c >= 0 and (a_dense[r, c] == 0 or mate_col[c] != r):
            return False
    for c, r in enumerate(mate_col):
        if r >= 0 and mate_row[r] != c:
            return False
    return True
