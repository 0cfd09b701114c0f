"""The Graph500-style data of the SpMM, BFS and materialized A² runs on the
card.

``chip_smoke.py`` (phases 6-11), ``profile_spmm_bfs`` and
``profile_spgemm`` build their graphs, dense operands, BFS-like frontier and
BFS roots here, so the scripts measure the same data for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.gen.rmat import rmat_matrix
from combblas_tpu_torch.ops.coo import SpCOO

__all__ = ["GRAPH_SCALE", "EDGEFACTOR", "NARROW_SCALE", "AUTO_SCALE",
           "AUTO_FLOPS_CAP", "spmm_bfs_graphs", "a2_matrix", "bfs_frontier",
           "bfs_roots"]

#: R-MAT scale of the SpMM and BFS runs: the size of kron_g500-logn21.
GRAPH_SCALE = 21
#: Graph500 edges per vertex.
EDGEFACTOR = 16
#: R-MAT scale of the narrow ``spgemm_pallas`` A²: the largest square A²
#: whose packed keys (m+1)*(n+1) stay below 2^31.
NARROW_SCALE = 15
#: R-MAT scale of the slabbed ``spgemm_auto`` A², and its per-slab product
#: cap (``bench.py``'s setting for the materialized lines).
AUTO_SCALE = 17
AUTO_FLOPS_CAP = 1 << 27
#: Seed of the frontier's own generator, apart from the graphs' seed.
_FRONTIER_SEED = 7


def spmm_bfs_graphs(seed: int, dev, scale: int = GRAPH_SCALE) -> dict:
    """From one generator seeded ``seed`` on ``dev``: ``a``, a G500 R-MAT
    with unit values; ``s``, the next draw symmetrized with its self loops
    removed (the BFS graph); ``x`` (n, 128) and ``x8`` (n, 8), uniform in
    [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, EDGEFACTOR)
    s = rmat_matrix(gen, scale, EDGEFACTOR, symmetrize=True,
                    remove_self_loops=True)
    n = a.shape[1]
    return dict(a=a, s=s,
                x=torch.rand((n, 128), generator=gen, device=dev),
                x8=torch.rand((n, 8), generator=gen, device=dev))


def a2_matrix(seed: int, dev, scale: int):
    """The G500 ef-16 R-MAT of the materialized A² runs, from a generator
    seeded ``seed`` on ``dev``; values are the summed duplicate-edge counts,
    so every product and sum of A² is an integer."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return rmat_matrix(gen, scale, EDGEFACTOR)


def bfs_frontier(n_pad: int, n: int, dev, d: int = 128) -> torch.Tensor:
    """A (n_pad, d) float32 pull frontier like a BFS level's: a tenth of
    its entries hold a vertex id + 1 in [1, n], the rest 0."""
    gen = torch.Generator(device=dev).manual_seed(_FRONTIER_SEED)
    hit = torch.rand((n_pad, d), generator=gen, device=dev) < 0.1
    ids = torch.randint(1, n + 1, (n_pad, d), generator=gen, device=dev)
    return torch.where(hit, ids.float(), 0.0)


def bfs_roots(s: SpCOO, seed: int, k: int = 64) -> np.ndarray:
    """``k`` distinct roots of degree >= 1 (all of them if fewer), drawn
    from a numpy generator seeded ``seed``, as Graph500 samples its
    search keys."""
    rp = s.row_ptr()
    cand = torch.nonzero(rp[1:] > rp[:-1]).reshape(-1).cpu().numpy()
    return np.random.default_rng(seed).choice(cand, size=min(k, len(cand)),
                                              replace=False)
