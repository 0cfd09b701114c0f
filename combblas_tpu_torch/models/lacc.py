"""LACC: linear-algebraic connected components (Awerbuch-Shiloach) (port of
``combblas_tpu/models/lacc.py``).

The parent vector is a dense int32 tensor.  One round: the star check
(two gathers and two scatters of False), conditional hooking of star roots
onto a strictly smaller neighbouring parent, unconditional hooking of the
remaining stars, shortcutting; until the parents stop changing (one host
read a round).  Every hook is a scatter-min (``scatter_reduce`` with
``"amin"``), the neighbour minima a (min, select2nd) SpMV: ``spmv`` on one
matrix, ``dist_spmv`` on a block grid.  On a grid over several processes
the parent vector is this process's slice: the reads ``f[f]`` and
``star[f]`` ask the owners (``exchange.gather_at``), the scatters of the
star check and the hooks go to them (``exchange.route_to_owners``), and
the loop stops on a flag reduced over the processes; the labels are
integers, so the slices are one process's exactly.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import spmv
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    col_vec_len,
)
from combblas_tpu_torch.parallel.grid import ProcGrid, default_grid
from combblas_tpu_torch.parallel.spmv import dist_spmv
from combblas_tpu_torch.semiring import MIN_SECOND

__all__ = ["lacc_local", "lacc_dist"]

_I32_MAX = torch.iinfo(torch.int32).max


def _star_check(f: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """star[v]: v belongs to a star (its tree has depth <= 1), for the
    vertices of this process's slice ``f`` of the parent vector.  Where
    f[f[v]] != f[v], neither f[v] nor f[f[v]] heads a star: those writes
    of False go to the owners of the vertices they touch, and the reads
    f[f] and star[f] come from them (in one process plain indexing)."""
    whole = f.shape[0] * grid.nproc
    fl = f.long()
    gf = exchange.gather_at(f, fl, grid)
    bad = gf != f
    star = ~bad
    tgt, = exchange.route_to_owners(torch.cat([fl[bad], gf[bad].long()]),
                                    [], grid, whole)
    star[tgt] = False
    return exchange.gather_at(star, fl, grid)


def _hook(f: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
          grid: ProcGrid):
    """f.at[idx].min(v): a scatter-min, each (idx, v) pair at the process
    that holds its target."""
    tgt, val = exchange.route_to_owners(idx.long(), [v], grid,
                                        f.shape[0] * grid.nproc)
    return f.scatter_reduce(0, tgt, val, "amin")


def _lacc_round(f: torch.Tensor, y: torch.Tensor,
                grid: ProcGrid) -> torch.Tensor:
    """One round given the neighbour-parent minima y (empty rows hold the
    int32 maximum, neutral under min)."""
    star = _star_check(f, grid)
    y = torch.minimum(y, f)
    # conditional hooking: star vertices hook their root onto a strictly
    # smaller neighbouring parent
    f1 = _hook(f, f, torch.where(star & (y < f), y, _I32_MAX), grid)
    # unconditional hooking: the remaining stars hook onto any neighbouring
    # parent (ties by min), which guarantees progress
    star2 = _star_check(f1, grid)
    f2 = _hook(f1, f1, torch.where(star2 & (y != f1), y, _I32_MAX), grid)
    return torch.minimum(exchange.gather_at(f2, f2.long(), grid), f2)


def _lacc(f: torch.Tensor, neighbour_min, grid: ProcGrid) -> torch.Tensor:
    """Rounds from the parents ``f`` (this process's slice) until no
    process's parents change."""
    while True:
        fn = _lacc_round(f, neighbour_min(f), grid)
        changed = exchange.any_proc((fn != f).any(), grid)
        f = fn
        if not changed:
            return f


def lacc_local(a: SpCOO) -> torch.Tensor:
    """Component labels (min vertex id per component) of a symmetric
    graph, on the graph's device."""
    f = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return _lacc(f, lambda f: spmv(a, f, MIN_SECOND),
                 default_grid(device=a.device))


def lacc_dist(a: DistSpMat) -> torch.Tensor:
    """Distributed LACC: the neighbour-parent minima through
    ``dist_spmv``, hooks on the FullyDist parent vector of the padded
    length ``col_vec_len``; on a pod this process's slice of it, whose
    reads and hooks go to the processes that hold the parents they touch,
    the loop stopping when no process changed."""
    g = a.grid
    lo, hi = g.vec_range(col_vec_len(a.gshape, g))
    live = _live_entries(a)

    def neighbour_min(f):
        y = dist_spmv(a, f, MIN_SECOND, live=live)
        if y.shape[0] != f.shape[0]:     # row space longer than columns
            y, = exchange.gather_range([y], g, lo, hi)
        return y

    f = torch.arange(lo, hi, dtype=torch.int32, device=a.row.device)
    return _lacc(f, neighbour_min, g)
