"""Betweenness centrality: batched Brandes (port of
``combblas_tpu/models/bc.py``).

``Applications/BetwCent.cpp:61-237`` processes batches of sources: a
forward BFS wave per level (path counts pushed one step, a sparse ×
dense product of the (n, batch) fringe), then the dependency
back-propagation, deepest level first.  :func:`betweenness_centrality`
runs each level as one ``ops/spmv.spmm`` on its gather route (JAX's
default, ``use_pallas=False``); :func:`betweenness_centrality_dist` as one
``dist_spmm`` on the block grid.  The level loop is host-paced: one read a
level (whether the wave reached a new vertex).  On a grid over several
processes the fringes, path counts and dependencies are this process's
slices of rows, the level loop stops when no process's wave reached a new
vertex, and each batch's scores are put together from the slices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import spmm
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dense import dist_spmm
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    col_vec_len,
)
from combblas_tpu_torch.parallel.elementwise import dist_transpose

__all__ = ["betweenness_centrality", "betweenness_centrality_dist"]


def _forward_step(at: SpCOO, fringe: torch.Tensor, nsp: torch.Tensor):
    """One BFS wave: the paths that reach undiscovered vertices from the
    current fringe; returns (new fringe, path counts so far)."""
    new = spmm(at, fringe)
    new = torch.where(nsp > 0, 0.0, new)
    return new, nsp + new


def _backward_step(a: SpCOO, fringe_prev: torch.Tensor,
                   fringe_d: torch.Tensor, nsp: torch.Tensor,
                   delta: torch.Tensor) -> torch.Tensor:
    """Brandes' dependency accumulation for one level: for every BFS-DAG
    edge (v, w), v at level d-1 and w at level d, delta[v] += nsp[v] /
    nsp[w] * (1 + delta[w]); the level masks keep exactly those edges.
    delta is kept itself, not as 1 + delta (JAX's ``bcu``): every term is
    non-negative, so a float32 delta far below 1 keeps its own precision
    instead of the ulp of 1."""
    w_term = torch.where(fringe_d > 0,
                         (1.0 + delta) / torch.clamp(nsp, min=1e-30), 0.0)
    pulled = spmm(a, w_term)
    return delta + torch.where(fringe_prev > 0, pulled * nsp, 0.0)


def _in_rows(batch: np.ndarray, lo: int, rows: int):
    """The sources of ``batch`` among the rows [lo, lo + rows): their rows
    there and their columns in the batch, as index tensors."""
    k = np.nonzero((batch >= lo) & (batch < lo + rows))[0]
    return torch.from_numpy(batch[k] - lo), torch.from_numpy(k)


def _first_fringe(batch: np.ndarray, rows: int, dev,
                  lo: int = 0) -> torch.Tensor:
    """The (rows, batch) fringe of the sources, of the rows [lo, lo +
    rows)."""
    fr = torch.zeros((rows, len(batch)), dtype=torch.float32, device=dev)
    src, k = _in_rows(batch, lo, rows)
    fr[src.to(dev), k.to(dev)] = 1.0
    return fr


def _contribution(delta: torch.Tensor, nsp: torch.Tensor, batch: np.ndarray,
                  n: int, lo: int = 0) -> torch.Tensor:
    """One batch's dependencies summed over its sources (float64), less
    each source's own column at its own row: of the rows [lo, n) that
    ``delta`` holds from ``lo`` on."""
    dd = (delta * (nsp > 0))[:max(n - lo, 0)].to(torch.float64)
    contrib = dd.sum(dim=1)
    src, k = _in_rows(batch, lo, dd.shape[0])
    src, k = src.to(dd.device), k.to(dd.device)
    contrib[src] -= dd[src, k]
    return contrib


def betweenness_centrality(a: SpCOO, batch_size: int = 32,
                           sources: Optional[np.ndarray] = None,
                           normalize: bool = False) -> np.ndarray:
    """Exact (``sources=None``: every vertex) or sampled BC scores of the
    graph ``a`` (float64, host), ``batch_size`` sources at a time."""
    n = a.shape[0]
    at = a.transpose()
    sources = np.arange(n) if sources is None else np.asarray(sources)
    bc = np.zeros(n, np.float64)
    for lo in range(0, len(sources), batch_size):
        batch = sources[lo: lo + batch_size]
        fringe = _first_fringe(batch, n, a.device)
        nsp = fringe
        fringes = [fringe]
        while True:    # forward, until no new vertex is reached
            fringe, nsp = _forward_step(at, fringe, nsp)
            if float(fringe.sum()) == 0.0:
                break
            fringes.append(fringe)
        delta = torch.zeros_like(nsp)
        for depth in range(len(fringes) - 1, 0, -1):
            delta = _backward_step(a, fringes[depth - 1], fringes[depth],
                                   nsp, delta)
        bc += _contribution(delta, nsp, batch, n).cpu().numpy()
    if normalize and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc


def betweenness_centrality_dist(a: DistSpMat, batch_size: int = 32,
                                sources: Optional[np.ndarray] = None
                                ) -> np.ndarray:
    """Distributed batched Brandes: the wavefronts are (n_padded, batch)
    dense matrices in the grid's vector layout, every level one
    ``dist_spmm`` (``BetwCent.cpp:179``'s PSpGEMM fringe), the
    back-propagation a second.  ``a``: symmetric, on a square grid.  On a
    pod every process gets the whole host scores."""
    n = a.gshape[0]
    g = a.grid
    at = dist_transpose(a)
    live_a, live_at = _live_entries(a), _live_entries(at)
    lo, hi = g.vec_range(col_vec_len(a.gshape, g))
    dev = a.row.device
    sources = np.arange(n) if sources is None else np.asarray(sources)
    bc = np.zeros(n, np.float64)
    for first in range(0, len(sources), batch_size):
        batch = sources[first: first + batch_size]
        fringe = _first_fringe(batch, hi - lo, dev, lo)
        nsp = fringe
        fringes = [fringe]
        while True:
            new = dist_spmm(at, fringe, live=live_at)[:hi - lo]
            new = torch.where(nsp > 0, 0.0, new)
            if not exchange.any_proc((new != 0).any(), g):
                break
            nsp = nsp + new
            fringe = new
            fringes.append(fringe)
        delta = torch.zeros_like(nsp)
        for d in range(len(fringes) - 1, 0, -1):
            w_term = torch.where(fringes[d] > 0,
                                 (1.0 + delta) / torch.clamp(nsp, min=1e-30),
                                 0.0)
            pulled = dist_spmm(a, w_term, live=live_a)[:hi - lo]
            delta = delta + torch.where(fringes[d - 1] > 0, pulled * nsp,
                                        0.0)
        bc += exchange.gather_whole(_contribution(delta, nsp, batch, n, lo),
                                    g).cpu().numpy()
    return bc
