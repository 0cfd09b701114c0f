"""Connected components by FastSV (port of ``combblas_tpu/models/cc.py``).

The parent vector is a dense int32 tensor; one iteration is:

    gf   = f[f]                                   (grandparent gather)
    y[u] = min over neighbors v of gf[v]          (SpMV over (min, select2nd))
    f[f[u]] <- min(f[f[u]], y[u])                 (stochastic hooking)
    f[u]    <- min(f[u],    y[u])                 (aggressive hooking)
    f       <- f[f]                               (shortcutting)

until f stops changing: a Python loop with one host read a round.
:func:`fastsv_dist` runs the neighbour-min SpMV over the block grid
(``dist_spmv``) on the FullyDist parent vector.  On a grid over several
processes each holds its slice of f: the grandparent reads ``f[f]`` and the
hook's writes ``f[f[u]] <- min(...)`` go to the processes that hold the
labels they touch (:func:`parallel.exchange.gather_at` /
``route_to_owners``), and the loop stops when no process changed.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import spmv
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    col_vec_len,
)
from combblas_tpu_torch.parallel.spmv import dist_spmv
from combblas_tpu_torch.semiring import MIN_SECOND

__all__ = ["fastsv_local", "fastsv_dist", "count_components"]


def _fastsv_body(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Hook and shortcut given the neighbor-grandparent minima y."""
    fl = f.long()
    y = torch.minimum(y, f[fl])  # never regress; empty rows hold +inf
    f = f.scatter_reduce(0, fl, y, "amin")  # stochastic hooking
    f = torch.minimum(f, y)  # aggressive hooking onto self
    return f[f.long()]  # shortcutting


def fastsv_local(a: SpCOO) -> torch.Tensor:
    """Component labels (min vertex id per component) of a symmetric graph,
    on the graph's device."""
    n = a.shape[0]
    f = torch.arange(n, dtype=torch.int32, device=a.device)
    while True:
        y = spmv(a, f[f.long()], MIN_SECOND)  # min over neighbors' gf
        fn = _fastsv_body(f, y)
        changed = bool((fn != f).any())
        f = fn
        if not changed:
            return f


def _fastsv_dist_body(f: torch.Tensor, y: torch.Tensor, gf: torch.Tensor,
                      grid) -> torch.Tensor:
    """:func:`_fastsv_body` on this process's slice ``f`` of the parent
    vector, given ``gf`` = f[f] and the neighbour minima ``y`` of its
    vertices: the hooks' (target, value) pairs go to the targets' owners,
    and the shortcut reads the hooked f from the owners (in one process,
    where both exchanges are plain indexing, :func:`_fastsv_body`)."""
    y = torch.minimum(y, gf)
    tgt, val = exchange.route_to_owners(f.long(), [y], grid,
                                        f.shape[0] * grid.nproc)
    f = f.scatter_reduce(0, tgt, val, "amin")     # stochastic hooking
    f = torch.minimum(f, y)                       # aggressive hooking
    return exchange.gather_at(f, f.long(), grid)  # shortcutting


def fastsv_dist(a: DistSpMat) -> torch.Tensor:
    """Distributed FastSV: the neighbour-min SpMV runs over the block grid;
    the parent vector is a FullyDist int32 vector of the padded length
    ``col_vec_len`` (padding vertices are their own components); on a pod
    this process's slice of it."""
    if a.gshape[0] != a.gshape[1]:
        raise ValueError(f"FastSV needs a square matrix, got {a.gshape}")
    g = a.grid
    lo, hi = g.vec_range(col_vec_len(a.gshape, g))
    f = torch.arange(lo, hi, dtype=torch.int32, device=a.row.device)
    live = _live_entries(a)
    while True:
        gf = exchange.gather_at(f, f.long(), g)
        y = dist_spmv(a, gf, MIN_SECOND, live=live)
        if y.shape[0] != f.shape[0]:     # row space longer than columns
            y, = exchange.gather_range([y], g, lo, hi)
        fn = _fastsv_dist_body(f, y, gf, g)
        changed = exchange.any_proc((fn != f).any(), g)
        f = fn
        if not changed:
            return f


def count_components(labels, n: int | None = None) -> int:
    """Host helper: number of distinct component labels among the first n
    vertices."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    if n is not None:
        labels = labels[:n]
    return int(np.unique(labels).size)
