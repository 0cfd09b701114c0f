"""Breadth-first search: top-down, direction-optimizing, push and batched
pull (port of ``combblas_tpu/models/bfs.py``).

The frontier is a masked dense vector (values = vertex id + 1).  JAX's
``lax.while_loop`` level loops become Python loops with one host read per
level (the frontier size, or whether any vertex was reached); each level's
work stays on the graph's device.

- :func:`bfs_local`, :func:`bfs_dir_opt_local`: a masked SpMSpV (or a pull
  segment-max) per level over every edge.
- :func:`bfs_dist`, :func:`bfs_dir_opt_dist`: the same levels on a block
  grid, vectors in the FullyDist layout padded to ``row_vec_len``, through
  ``dist_spmsv_masked`` and ``dist_bfs_pull_masked``.
- :func:`bfs_push_local`: per level, the frontier's adjacency lists are
  expanded by the ESC expansion kernel (K1, ``ops/kernels/expand.py``) into
  a (neighbour, parent id + 1) stream and folded with one scatter-max, so
  each edge is touched once over the traversal.
- :func:`bfs_batch_pull`: up to R roots at once, pull steps over the CSR
  edge stream with a wrapping int32 cumsum per row, parents in one scan
  after the level loop.
- :func:`bfs_batch_pull_big`: up to 128 roots ride the 128 float32 columns
  of one ELL-8 max sweep per level (``ops/kernels/ell.py``, K7): every
  vertex's max (original id + 1) over frontier neighbours, which is hit
  detection and parent choice at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.kernels.ell import ell_fold
from combblas_tpu_torch.ops.kernels.expand import expand_chunks_compact
from combblas_tpu_torch.ops.spmm_ell_blocked import ell_blocked_prepare
from combblas_tpu_torch.ops.spmv import spmsv_masked
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    row_vec_len,
)
from combblas_tpu_torch.parallel.spmv import (
    dist_bfs_pull_masked,
    dist_spmsv_masked,
)
from combblas_tpu_torch.semiring import MAX_SECOND, PLUS_TIMES
from combblas_tpu_torch.utils.timers import span

__all__ = ["bfs_local", "bfs_dist", "bfs_dir_opt_local", "bfs_dir_opt_dist",
           "bfs_push_local",
           "bfs_push_prepare", "bfs_batch_pull", "bfs_batch_prepare",
           "bfs_batch_pull_big", "validate_bfs"]

#: Direction-optimizing BFS pulls once the frontier holds more than
#: n / BETA vertices.
BETA = 8
#: Parent ids ride float32 (id + 1) in the push stream and the pull sweep:
#: exact only below 2^24.
_F32_EXACT = 1 << 24


class _BfsState(NamedTuple):
    parents: torch.Tensor     # int32[n], -1 = unvisited
    levels: torch.Tensor      # int32[n], -1 = unvisited
    front_val: torch.Tensor   # int32[n]: vertex id + 1 where frontier
    front_mask: torch.Tensor  # bool[n]
    depth: int
    nfront: int


def _init_state(n: int, root: int, device, lo: int | None = None
                ) -> _BfsState:
    """The state of the n vertices at level 0 of a BFS from ``root``; with
    ``lo``, of vertices [lo, lo + n), a pod process's slice of them."""
    parents = torch.full((n,), -1, dtype=torch.int32, device=device)
    levels = torch.full((n,), -1, dtype=torch.int32, device=device)
    fv = torch.zeros(n, dtype=torch.int32, device=device)
    fm = torch.zeros(n, dtype=torch.bool, device=device)
    if lo is None or lo <= root < lo + n:
        at = root if lo is None else root - lo
        parents[at] = root
        levels[at] = 0
        fv[at] = root + 1
        fm[at] = True
    return _BfsState(parents, levels, fv, fm, 0, 1)


def _advance(state: _BfsState, y: torch.Tensor, ym: torch.Tensor,
             lo: int = 0, pod: bool = False) -> _BfsState:
    """Fold one level's candidate parents into the BFS state of vertices
    [lo, ...) (one host read: the next frontier's size, summed over the
    processes on a pod, so that every process stops at the same level)."""
    new = ym & (state.parents < 0)
    parents = torch.where(new, y.to(torch.int32) - 1, state.parents)
    levels = torch.where(new, state.depth + 1, state.levels)
    ids = torch.arange(new.shape[0], dtype=torch.int32, device=new.device)
    fv = torch.where(new, ids + (lo + 1), 0)
    nfront = int(new.sum())
    if pod:
        nfront = int(exchange.allgather_host(
            np.asarray([nfront], np.int64)).sum())
    return _BfsState(parents, levels, fv, new, state.depth + 1, nfront)


def bfs_local(a: SpCOO, root: int):
    """Single-device BFS.  Edge (u, v) = stored entry (row u, col v); the
    traversal follows out-edges.  Returns (parents, levels) int32[n]."""
    s = _init_state(a.shape[0], int(root), a.device)
    while s.nfront > 0:
        y, ym = spmsv_masked(a, s.front_val, s.front_mask, MAX_SECOND,
                             transpose=True)
        s = _advance(s, y, ym)
    return s.parents, s.levels


def _dist_levels(a: DistSpMat, root: int, pull: bool):
    """The level loop of :func:`bfs_dist` (``pull=False``) and
    :func:`bfs_dir_opt_dist` (``pull=True``: a level with more than
    ``n_pad / BETA`` frontier vertices pulls)."""
    if a.gshape[0] != a.gshape[1]:
        raise ValueError(f"BFS needs a square adjacency matrix, got "
                         f"{a.gshape}")
    n_pad = row_vec_len(a.gshape, a.grid)
    lo, hi = a.grid.vec_range(n_pad)
    s = _init_state(hi - lo, int(root), a.row.device,
                    lo if a.grid.is_pod else None)
    live = _live_entries(a)
    while s.nfront > 0:
        if pull and s.nfront * BETA > n_pad:
            y, ym = dist_bfs_pull_masked(a, s.front_mask, s.parents < 0,
                                         live=live)
            y = y.to(s.front_val.dtype)
        else:
            y, ym = dist_spmsv_masked(a, s.front_val, s.front_mask,
                                      MAX_SECOND, transpose=True, live=live)
        s = _advance(s, y, ym, lo, a.grid.is_pod)
    return s.parents, s.levels


def bfs_dist(a: DistSpMat, root: int):
    """Distributed BFS over the block grid: each level one masked SpMSpV
    fan-out / fan-in (``dist_spmsv_masked``, transposed).  Returns
    (parents, levels), int32 FullyDist vectors of the padded length
    ``row_vec_len`` (padding vertices have no edges and stay -1); on a
    pod, this process's slices of them, every level's stop read from the
    frontier summed over the processes."""
    return _dist_levels(a, root, pull=False)


def bfs_dir_opt_dist(a: DistSpMat, root: int):
    """Distributed direction-optimizing BFS: top-down levels as
    :func:`bfs_dist`; once the frontier holds more than ``n_pad / BETA``
    vertices, a level runs the pull step (``dist_bfs_pull_masked``, which
    moves only the frontier and unvisited bitmaps).  Both share the state
    fold, so parents and levels equal :func:`bfs_dist`'s."""
    return _dist_levels(a, root, pull=True)


def bfs_dir_opt_local(a: SpCOO, root: int):
    """Direction-optimizing BFS (Beamer): a level pushes over the
    frontier's out-edges, or, once the frontier holds more than n / 8
    vertices, every vertex pulls the max frontier in-neighbour (+1) with
    one segment max.  Both share the state fold, so levels equal
    :func:`bfs_local`'s."""
    n = a.shape[0]
    valid = a.mask()
    src = a.row.clamp(max=n - 1)
    dst = a.col.clamp(max=n - 1).long()
    s = _init_state(n, int(root), a.device)
    while s.nfront > 0:
        if s.nfront * BETA > n:
            active = valid & s.front_mask[src.long()]
            cand = torch.where(active, src + 1, 0)
            y = torch.full((n + 1,), torch.iinfo(torch.int32).min,
                           dtype=torch.int32, device=a.device)
            y.scatter_reduce_(0, torch.where(active, dst, n), cand,
                              reduce="amax")
            y = y[:n]
            ym = y > 0
        else:
            y, ym = spmsv_masked(a, s.front_val, s.front_mask, MAX_SECOND,
                                 transpose=True)
        s = _advance(s, y, ym)
    return s.parents, s.levels


# -- push BFS on the expansion kernel (K1) ----------------------------------

def bfs_push_prepare(a: SpCOO):
    """State for :func:`bfs_push_local`: the row pointer, the column
    stream and, per entry, its source row + 1 as float32 (0 on padding):
    the expansion's B operand, whose products carry parent ids."""
    n = a.shape[1]
    if n >= _F32_EXACT:
        raise ValueError(f"parent ids ride float32 exactly only below 2^24,"
                         f" got n = {n}")
    pv = (a.row + 1).to(torch.float32) * a.mask().to(torch.float32)
    return a.row_ptr(), a.col, pv


def _bfs_push_level(rp, col, pv, fr, parents, levels, depth: int, *,
                    n: int, stream_cap: int):
    """One push level: expand the frontier's adjacency lists (frontier slot
    i = A row, frontier vertex = A column, the adjacency = B, stride 0)
    into a (neighbour, parent + 1) stream, fold with one scatter-max, and
    list the next frontier in ascending order.  Returns (parents, levels,
    next frontier int32, its edge count as a 0-d tensor)."""
    k = fr.shape[0]
    dev = fr.device
    nbr, par, total = expand_chunks_compact(
        torch.arange(k, dtype=torch.int32, device=dev), fr,
        torch.ones(k, dtype=torch.float32, device=dev),
        torch.ones(k, dtype=torch.bool, device=dev), rp, col, pv,
        PLUS_TIMES, stride=0, stream_cap=stream_cap)
    live = torch.arange(stream_cap, device=dev) < total
    tgt = torch.where(live, nbr.clamp(max=n), n).long()
    cand = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    cand.scatter_reduce_(0, tgt, torch.where(live, par, 0.0), reduce="amax")
    cand = cand[:n]
    new = (cand > 0) & (parents < 0)
    parents = torch.where(new, cand.to(torch.int32) - 1, parents)
    levels = torch.where(new, depth + 1, levels)
    ids = torch.nonzero(new).reshape(-1)
    nedges = (rp[ids + 1] - rp[ids]).sum()
    return parents, levels, ids.to(torch.int32), nedges


def bfs_push_local(a: SpCOO, root: int, prep=None):
    """Host-driven push BFS over the frontier's edges only.  Each level's
    stream capacity is its exact edge count.  Returns (parents, levels)
    int32[n] on the graph's device."""
    n = a.shape[0]
    root = int(root)
    rp, col, pv = bfs_push_prepare(a) if prep is None else prep
    parents = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    levels = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    parents[root] = root
    levels[root] = 0
    fr = torch.tensor([root], dtype=torch.int32, device=a.device)
    edges = int(rp[root + 1] - rp[root])
    depth = 0
    while fr.shape[0] > 0:
        parents, levels, fr, nedges = _bfs_push_level(
            rp, col, pv, fr, parents, levels, depth, n=n,
            stream_cap=max(edges, 1))
        edges = int(nedges)
        depth += 1
    return parents, levels


# -- batched pull BFS --------------------------------------------------------

def bfs_batch_prepare(a: SpCOO):
    """State for :func:`bfs_batch_pull`: CSR row pointer, the edge-target
    stream, per-entry source rows, and the live-entry mask."""
    n = a.shape[0]
    rp = a.row_ptr()
    live = a.mask()
    col = torch.where(live, a.col.clamp(max=n - 1), 0).long()
    row = torch.where(live, a.row.clamp(max=n - 1), 0).long()
    return rp, col, row, live


def _bfs_batch_pull(rp, col, row, live, roots):
    r = roots.shape[0]
    n = rp.shape[0] - 1
    dev = col.device
    ar = torch.arange(r, device=dev)
    levels = torch.full((r, n), -1, dtype=torch.int32, device=dev)
    levels[ar, roots] = 0
    z1 = torch.zeros((r, 1), dtype=torch.int32, device=dev)
    lo, hi = rp[:-1], rp[1:]

    def seg_rowsum(stream):
        """Per-row sums of an (R, E) int32 edge stream: an int32 cumsum,
        which may wrap, and two boundary gathers; the difference is exact
        mod 2^32, so exact for true row sums below 2^31."""
        c0 = torch.cat([z1, torch.cumsum(stream, 1, dtype=torch.int32)], 1)
        return c0[:, hi] - c0[:, lo], c0

    depth = 0
    while True:
        hit = ((levels[:, col] == depth) & live).to(torch.int32)
        rowhit, _ = seg_rowsum(hit)
        new = (rowhit > 0) & (levels < 0)
        levels = torch.where(new, depth + 1, levels)
        depth += 1
        if not bool(new.any()):
            break

    # parents in one scan: each row's first edge whose target is one level
    # up (its running count is one above the count at the row's start)
    pl = levels[:, col]
    rl = levels[:, row]
    ind = (pl == rl - 1) & (rl > 0) & live
    _, c0 = seg_rowsum(ind.to(torch.int32))
    first = ind & (c0[:, 1:] == c0[:, lo[row]] + 1)
    pv = torch.where(first, col + 1, 0).to(torch.int32)
    psum, _ = seg_rowsum(pv)   # at most one nonzero per row: exact
    parents = torch.where(levels > 0, psum - 1, -1)
    parents[ar, roots] = roots.to(torch.int32)
    return parents, levels


def bfs_batch_pull(a: SpCOO, roots, prep=None):
    """Multi-root BFS, pull formulation over every edge per level.  ``a``
    must be symmetric.  Returns (parents, levels) as (R, n) int32."""
    rp, col, row, live = bfs_batch_prepare(a) if prep is None else prep
    roots = torch.as_tensor(np.asarray(roots), dtype=torch.int64,
                            device=a.device)
    return _bfs_batch_pull(rp, col, row, live, roots)


def _bfs_pull_big(prep: dict, roots_s: torch.Tensor, roots: torch.Tensor):
    """The level sweep in the relabeled space.  Every carrier is (n_pad,
    128) float32; lanes >= R carry no root and stay unvisited.  Frontier
    values are ORIGINAL ids + 1, so parents need no translation."""
    dp = 128
    n_pad = prep["n_pad"]
    dev = roots.device
    r = roots.shape[0]
    ids = (prep["order"].to(torch.float32) + 1.0)[:, None]  # 0 on pad rows
    ar = torch.arange(r, device=dev)
    levels = torch.full((n_pad, dp), -1.0, device=dev)
    parents = torch.full((n_pad, dp), -1.0, device=dev)
    levels[roots_s, ar] = 0.0
    parents[roots_s, ar] = roots.to(torch.float32)
    cols, vals = prep["cols"].t(), prep["vals"].t()
    depth = 0.0
    while True:
        with span("bfs.level"):
            f = torch.where(levels == depth, ids, 0.0)
            with span("bfs.fold"):
                y = ell_fold(cols, vals, prep["run_start"], prep["run_len"],
                             f, bs_c=prep["bs_c"], op="max",
                             pieces=prep["pieces"])[:n_pad]
            new = (y > 0) & (levels < 0)
            parents = torch.where(new, y - 1.0, parents)
            levels = torch.where(new, depth + 1.0, levels)
            depth += 1.0
            if not bool(new.any()):
                break
    return (parents[:, :r].to(torch.int32), levels[:, :r].to(torch.int32))


def bfs_batch_pull_big(a: SpCOO, roots, prep=None, nb: int = 6):
    """Multi-root BFS through the blocked ELL-8 max fold, one sweep per
    level (the graph relabeled by degree once, in the plan).  ``a`` must be
    symmetric; at most 128 roots.  Returns (parents, levels) as (R, n)
    int32 in ORIGINAL vertex ids."""
    n = a.shape[0]
    if n >= _F32_EXACT:
        raise ValueError(f"vertex ids ride float32 exactly only below 2^24,"
                         f" got n = {n}")
    with span("bfs.batch", a.row):
        if prep is None:
            prep = ell_blocked_prepare(a, nb, relabel_cols=True, binary=True)
        roots = torch.as_tensor(np.asarray(roots), dtype=torch.int64,
                                device=a.device)
        if roots.shape[0] > 128:
            raise ValueError("one sweep carries at most 128 root columns")
        inv = prep["inv"].long()
        parents_s, levels_s = _bfs_pull_big(prep, inv[roots], roots)
        with span("bfs.unpermute"):
            rank = inv[:n]
            return (parents_s[rank].t().contiguous(),
                    levels_s[rank].t().contiguous())


def validate_bfs(a: SpCOO, root: int, parents, levels) -> bool:
    """Graph500-style check: the root is its own parent at level 0, and
    every other visited vertex v has an edge (parent, v) in ``a`` and sits
    one level below its parent.  JAX's version reads a dense matrix; this
    one searches ``a``'s sorted edge list on its device, so it scales."""
    n = a.shape[1]
    dev = a.device
    parents = torch.as_tensor(parents, device=dev).long()
    levels = torch.as_tensor(levels, device=dev).long()
    if int(parents[root]) != root or int(levels[root]) != 0:
        return False
    vis = torch.nonzero(parents >= 0).reshape(-1)
    vis = vis[vis != root]
    if vis.numel() == 0:
        return True
    nnz = int(a.nnz)
    if nnz == 0:
        return False
    keys = a.row[:nnz].long() * n + a.col[:nnz].long()   # row-major sorted
    p = parents[vis]
    pe = p * n + vis
    found = torch.searchsorted(keys, pe).clamp(max=nnz - 1)
    return bool((keys[found] == pe).all()
                & (levels[vis] == levels[p] + 1).all())
