"""Connected components by FastSV (port of ``combblas_tpu/models/cc.py``).

The parent vector is a dense int32 tensor; one iteration is:

    gf   = f[f]                                   (grandparent gather)
    y[u] = min over neighbors v of gf[v]          (SpMV over (min, select2nd))
    f[f[u]] <- min(f[f[u]], y[u])                 (stochastic hooking)
    f[u]    <- min(f[u],    y[u])                 (aggressive hooking)
    f       <- f[f]                               (shortcutting)

until f stops changing: a Python loop with one host read a round.
:func:`fastsv_dist` runs the neighbour-min SpMV over the block grid
(``dist_spmv``) on the FullyDist parent vector.
"""

from __future__ import annotations

import numpy as np
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


@single_process
def fastsv_dist(a: DistSpMat) -> torch.Tensor:
    """Distributed FastSV: the neighbour-min SpMV runs over the block grid;
    the parent vector is a FullyDist int32 vector of the padded length
    ``col_vec_len`` (padding vertices are their own components)."""
    if a.gshape[0] != a.gshape[1]:
        raise ValueError(f"FastSV needs a square matrix, got {a.gshape}")
    n_pad = col_vec_len(a.gshape, a.grid)
    f = torch.arange(n_pad, dtype=torch.int32, device=a.row.device)
    live = _live_entries(a)
    while True:
        y = dist_spmv(a, f[f.long()], MIN_SECOND, live=live)
        fn = _fastsv_body(f, y[:n_pad])
        changed = bool((fn != f).any())
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
