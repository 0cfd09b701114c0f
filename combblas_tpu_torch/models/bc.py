"""Betweenness centrality: batched Brandes (port of
``combblas_tpu/models/bc.py``).

``Applications/BetwCent.cpp:61-237`` processes batches of sources: a
forward BFS wave per level (path counts pushed one step, a sparse ×
dense product of the (n, batch) fringe), then the dependency
back-propagation, deepest level first.  :func:`betweenness_centrality`
runs each level as one ``ops/spmv.spmm`` on its gather route (JAX's
default, ``use_pallas=False``); :func:`betweenness_centrality_dist` as one
``dist_spmm`` on the block grid.  The level loop is host-paced: one read a
level (whether the wave reached a new vertex).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmv import spmm
from combblas_tpu_torch.parallel.dense import dist_spmm
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    col_vec_len,
)
from combblas_tpu_torch.parallel.elementwise import dist_transpose
from combblas_tpu_torch.parallel.grid import single_process

__all__ = ["betweenness_centrality", "betweenness_centrality_dist"]


def _forward_step(at: SpCOO, fringe: torch.Tensor, nsp: torch.Tensor):
    """One BFS wave: the paths that reach undiscovered vertices from the
    current fringe; returns (new fringe, path counts so far)."""
    new = spmm(at, fringe)
    new = torch.where(nsp > 0, 0.0, new)
    return new, nsp + new


def _backward_step(a: SpCOO, fringe_prev: torch.Tensor,
                   fringe_d: torch.Tensor, nsp: torch.Tensor,
                   bcu: torch.Tensor) -> torch.Tensor:
    """Brandes' dependency accumulation for one level (``bcu`` is 1 +
    delta): for every BFS-DAG edge (v, w), v at level d-1 and w at level
    d, delta[v] += nsp[v] / nsp[w] * bcu[w]; the level masks keep exactly
    those edges."""
    w_term = torch.where(fringe_d > 0, bcu / torch.clamp(nsp, min=1e-30),
                         0.0)
    pulled = spmm(a, w_term)
    return bcu + torch.where(fringe_prev > 0, pulled * nsp, 0.0)


def _first_fringe(batch: np.ndarray, rows: int, dev) -> torch.Tensor:
    fr = torch.zeros((rows, len(batch)), dtype=torch.float32, device=dev)
    fr[torch.from_numpy(batch).to(dev), torch.arange(len(batch),
                                                      device=dev)] = 1.0
    return fr


def _contribution(bcu: torch.Tensor, nsp: torch.Tensor, batch: np.ndarray,
                  n: int) -> np.ndarray:
    """One batch's dependencies summed over its sources (float64), less
    each source's own column at its own row."""
    dd = ((bcu - 1.0) * (nsp > 0))[:n].to(torch.float64)
    contrib = dd.sum(dim=1)
    src = torch.from_numpy(batch).to(dd.device)
    contrib[src] -= dd[src, torch.arange(len(batch), device=dd.device)]
    return contrib.cpu().numpy()


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
        bcu = torch.ones_like(nsp)
        for depth in range(len(fringes) - 1, 0, -1):
            bcu = _backward_step(a, fringes[depth - 1], fringes[depth], nsp,
                                 bcu)
        bc += _contribution(bcu, nsp, batch, n)
    if normalize and n > 2:
        bc /= (n - 1) * (n - 2)
    return bc


@single_process
def betweenness_centrality_dist(a: DistSpMat, batch_size: int = 32,
                                sources: Optional[np.ndarray] = None
                                ) -> np.ndarray:
    """Distributed batched Brandes: the wavefronts are (n_padded, batch)
    dense matrices in the grid's vector layout, every level one
    ``dist_spmm`` (``BetwCent.cpp:179``'s PSpGEMM fringe), the
    back-propagation a second.  ``a``: symmetric, on a square grid."""
    n = a.gshape[0]
    at = dist_transpose(a)
    live_a, live_at = _live_entries(a), _live_entries(at)
    n_pad = col_vec_len(a.gshape, a.grid)
    dev = a.row.device
    sources = np.arange(n) if sources is None else np.asarray(sources)
    bc = np.zeros(n, np.float64)
    for lo in range(0, len(sources), batch_size):
        batch = sources[lo: lo + batch_size]
        fringe = _first_fringe(batch, n_pad, dev)
        nsp = fringe
        fringes = [fringe]
        while True:
            new = dist_spmm(at, fringe, live=live_at)[:n_pad]
            new = torch.where(nsp > 0, 0.0, new)
            if float(new.sum()) == 0.0:
                break
            nsp = nsp + new
            fringe = new
            fringes.append(fringe)
        bcu = torch.ones_like(nsp)
        for d in range(len(fringes) - 1, 0, -1):
            w_term = torch.where(fringes[d] > 0,
                                 bcu / torch.clamp(nsp, min=1e-30), 0.0)
            pulled = dist_spmm(a, w_term, live=live_a)[:n_pad]
            bcu = bcu + torch.where(fringes[d - 1] > 0, pulled * nsp, 0.0)
        bc += _contribution(bcu, nsp, batch, n)
    return bc
