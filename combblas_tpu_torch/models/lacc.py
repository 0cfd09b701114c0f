"""LACC: linear-algebraic connected components (Awerbuch-Shiloach) (port of
``combblas_tpu/models/lacc.py``).

The parent vector is a dense int32 tensor.  One round: the star check
(two gathers and two scatters of False), conditional hooking of star roots
onto a strictly smaller neighbouring parent, unconditional hooking of the
remaining stars, shortcutting; until the parents stop changing (one host
read a round).  Every hook is a scatter-min (``scatter_reduce`` with
``"amin"``), the neighbour minima a (min, select2nd) SpMV: ``spmv`` on one
matrix, ``dist_spmv`` on a block grid.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import spmv
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    col_vec_len,
)
from combblas_tpu_torch.parallel.grid import single_process
from combblas_tpu_torch.parallel.spmv import dist_spmv
from combblas_tpu_torch.semiring import MIN_SECOND

__all__ = ["lacc_local", "lacc_dist"]

_I32_MAX = torch.iinfo(torch.int32).max


def _star_check(f: torch.Tensor) -> torch.Tensor:
    """star[v]: v belongs to a star (its tree has depth <= 1).  Where
    f[f[v]] != f[v], neither f[v] nor f[f[v]] heads a star; the index n
    (JAX ``mode="drop"``) lands on a spare slot that is cut off."""
    n = f.shape[0]
    fl = f.long()
    gf = f[fl]
    bad = gf != f
    star = torch.ones(n + 1, dtype=torch.bool, device=f.device)
    star[:n] = ~bad
    star[torch.where(bad, fl, n)] = False
    star[torch.where(bad, gf.long(), n)] = False
    return star[:n][fl]


def _hook(f: torch.Tensor, idx: torch.Tensor, v: torch.Tensor):
    """f.at[idx].min(v): a scatter-min."""
    return f.scatter_reduce(0, idx.long(), v, "amin")


def _lacc_round(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One round given the neighbour-parent minima y (empty rows hold the
    int32 maximum, neutral under min)."""
    star = _star_check(f)
    y = torch.minimum(y, f)
    # conditional hooking: star vertices hook their root onto a strictly
    # smaller neighbouring parent
    f1 = _hook(f, f, torch.where(star & (y < f), y, _I32_MAX))
    # unconditional hooking: the remaining stars hook onto any neighbouring
    # parent (ties by min), which guarantees progress
    star2 = _star_check(f1)
    f2 = _hook(f1, f1, torch.where(star2 & (y != f1), y, _I32_MAX))
    return torch.minimum(f2[f2.long()], f2)        # shortcut


def _lacc(n: int, device, neighbour_min) -> torch.Tensor:
    f = torch.arange(n, dtype=torch.int32, device=device)
    while True:
        fn = _lacc_round(f, neighbour_min(f))
        changed = bool((fn != f).any())
        f = fn
        if not changed:
            return f


def lacc_local(a: SpCOO) -> torch.Tensor:
    """Component labels (min vertex id per component) of a symmetric
    graph, on the graph's device."""
    return _lacc(a.shape[0], a.device, lambda f: spmv(a, f, MIN_SECOND))


@single_process
def lacc_dist(a: DistSpMat) -> torch.Tensor:
    """Distributed LACC: the neighbour-parent minima through
    ``dist_spmv``, hooks on the FullyDist parent vector of the padded
    length ``col_vec_len``."""
    n_pad = col_vec_len(a.gshape, a.grid)
    live = _live_entries(a)
    return _lacc(n_pad, a.row.device,
                 lambda f: dist_spmv(a, f, MIN_SECOND, live=live)[:n_pad])
