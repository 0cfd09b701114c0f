"""Filtered (semantic-graph) traversals (port of
``combblas_tpu/models/filtered.py``).

The counterparts of ``Applications/FilteredBFS.cpp:129`` /
``FilteredMIS.cpp:147``: the edge attribute lives in the value array and
an edge predicate masks the traversal's gather pass ("late filtering"), so
no subgraph is built; :func:`materialize_filtered` builds it for repeated
queries with one predicate.  A predicate maps a value tensor to a bool
tensor.  The distributed forms run on a grid over several processes too:
the prune needs no exchange, the BFS's vectors are this process's slices
(its stop read over all the processes, as ``bfs_dist``'s), and the MIS is
``luby_mis_dist``'s.
"""

from __future__ import annotations

from typing import Callable

import torch

from combblas_tpu_torch.models.bfs import _advance, _init_state
from combblas_tpu_torch.models.mis import luby_mis, luby_mis_dist
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.ewise import _compact
from combblas_tpu_torch.ops.spmv import _segment_reduce
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    row_vec_len,
)
from combblas_tpu_torch.parallel.elementwise import dist_prune
from combblas_tpu_torch.parallel.spmv import dist_spmsv_masked
from combblas_tpu_torch.semiring import MAX_SECOND

__all__ = [
    "bfs_filtered",
    "bfs_filtered_dist",
    "materialize_filtered",
    "materialize_filtered_dist",
    "mis_filtered",
    "mis_filtered_dist",
]


def materialize_filtered(a: SpCOO, pred: Callable) -> SpCOO:
    """The subgraph of the edges whose value passes ``pred``."""
    return _compact(a, pred(a.val))


def bfs_filtered(a: SpCOO, root: int, pred: Callable):
    """BFS over the edges passing ``pred(value)`` (``FilteredBFS.cpp``
    semantics): every level folds, over the passing edges out of the
    frontier, the largest source + 1 into each target (a segment-max of
    the active edges only), one host read a level.  Returns (parents,
    levels) int32[n]."""
    n = a.shape[0]
    k = min(int(a.nnz), a.capacity)
    ok = pred(a.val[:k])
    src = a.row[:k].long().clamp(max=n - 1)
    dst = a.col[:k].long().clamp(max=n - 1)
    s = _init_state(n, int(root), a.device)
    while s.nfront > 0:
        idx = torch.nonzero(ok & s.front_mask[src]).squeeze(1)
        y = _segment_reduce((src[idx] + 1).to(torch.int32), dst[idx], n,
                            MAX_SECOND)
        s = _advance(s, y, y > 0)
    return s.parents, s.levels


def mis_filtered(a: SpCOO, generator: torch.Generator, pred: Callable):
    """Luby MIS of the filtered subgraph (``FilteredMIS.cpp``)."""
    return luby_mis(materialize_filtered(a, pred), generator)


def materialize_filtered_dist(a: DistSpMat, pred: Callable) -> DistSpMat:
    """The semantic subgraph on the grid: a blockwise prune, no exchange
    (``SemanticGraph.h``'s repeated-query path)."""
    return dist_prune(a, lambda v: ~pred(v))


def bfs_filtered_dist(a: DistSpMat, root: int, pred: Callable):
    """Distributed filtered BFS (``FilteredBFS.cpp:129``): the predicate
    masks the entries of every level's ``dist_spmsv_masked``, as
    ``bfs_dist`` steps otherwise.  ``a``: a DistSpMat whose values are
    attribute codes.  Returns (parents, levels) of length
    ``row_vec_len`` (on a pod, this process's slices)."""
    g = a.grid
    lo, hi = g.vec_range(row_vec_len(a.gshape, g))
    s = _init_state(hi - lo, int(root), a.row.device,
                    lo if g.is_pod else None)
    live = _live_entries(a)
    while s.nfront > 0:
        y, ym = dist_spmsv_masked(a, s.front_val, s.front_mask, MAX_SECOND,
                                  transpose=True, edge_pred=pred, live=live)
        s = _advance(s, y, ym, lo, g.is_pod)
    return s.parents, s.levels


def mis_filtered_dist(a: DistSpMat, generator: torch.Generator,
                      pred: Callable):
    """Distributed FilteredMIS (``FilteredMIS.cpp:147``): Luby rounds with
    the predicate in every SpMV."""
    return luby_mis_dist(a, generator, edge_pred=pred)
