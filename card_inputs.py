"""The inputs of the card runs: the Graph500-style data of the SpMM, BFS
and materialized A² phases of ``chip_smoke.py`` and of the card tests, and
the grid products of A² that ``chip_smoke.py`` phases 13-14 time.

The scripts build their graphs, dense operands, BFS-like frontier and BFS
roots here, so they measure the same data for the same seed.  No module of
``combblas_tpu_torch`` imports this one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from combblas_tpu_torch.gen.rmat import rmat_matrix
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.parallel.dist import DistSpMat
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.parallel.memefficient import summa_spgemm_staged
from combblas_tpu_torch.parallel.rma import summa_spgemm_rma
from combblas_tpu_torch.parallel.summa import (
    summa_bounds,
    summa_chunk_bound,
    summa_flops,
    summa_impl_auto,
    summa_spgemm_auto,
)
from combblas_tpu_torch.parallel.summa3d import (
    Dist3DSpMat,
    summa3d_layer_bounds,
    summa3d_spgemm,
)

__all__ = ["GRAPH_SCALE", "EDGEFACTOR", "NARROW_SCALE", "AUTO_SCALE",
           "AUTO_FLOPS_CAP", "GRID_SIDES", "GRID3D", "spmm_bfs_graphs",
           "a2_matrix", "bfs_frontier", "bfs_roots", "grid_cells"]

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
#: Sides of the square grids, and the (layers, pr, pc) of the 3D grid.
GRID_SIDES = (2, 4)
GRID3D = (2, 2, 2)


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


def grid_cells(a, dev) -> list:
    """The grid products of A² on ``dev``: ``summa_spgemm_auto`` on the
    2x2 and 4x4 grids, ``summa_spgemm_staged`` and ``summa_spgemm_rma`` on
    the 4x4 grid, and ``summa3d_spgemm`` on the (2, 2, 2) grid, as (label,
    call, info) in phase order, ``info`` holding the layout: grid, route,
    caps, the largest block's panel products and set-up seconds."""
    cells = []
    grids = {}
    for side in GRID_SIDES:
        t = time.perf_counter()
        da = DistSpMat.from_local(a, ProcGrid.make(side, side, device=dev))
        per_block = summa_flops(da, da)
        grids[side] = da
        cells.append((f"summa_spgemm_auto {side}x{side}",
                      lambda da=da: summa_spgemm_auto(da, da),
                      dict(grid=(side, side), impl=summa_impl_auto(da, da),
                           a_capacity=da.capacity,
                           a_imbalance=float(da.load_imbalance()),
                           block_flops_max=int(per_block.max()),
                           setup_secs=time.perf_counter() - t)))
    d4 = grids[4]
    fc, oc = summa_bounds(d4, d4)
    impl = summa_impl_auto(d4, d4)
    chunk_cap = summa_chunk_bound(d4, d4, fc)
    caps = dict(grid=(4, 4), stage_flops_cap=fc, out_capacity=oc)
    cells.append(("summa_spgemm_staged 4x4",
                  lambda: summa_spgemm_staged(d4, d4, stage_flops_cap=fc,
                                              out_capacity=oc, impl=impl,
                                              chunk_cap=chunk_cap),
                  dict(caps, impl=impl)))
    cells.append(("summa_spgemm_rma 4x4",
                  lambda: summa_spgemm_rma(d4, d4, stage_flops_cap=fc,
                                           out_capacity=oc),
                  dict(caps, impl="xla")))
    t = time.perf_counter()
    g3 = ProcGrid.make(GRID3D[1], GRID3D[2], layers=GRID3D[0], device=dev)
    a3 = Dist3DSpMat.from_dist2d(a, g3, "col")
    b3 = Dist3DSpMat.from_dist2d(a, g3, "row")
    fc3, oc3 = summa3d_layer_bounds(a3, b3)
    cells.append(("summa3d_spgemm 2x2x2",
                  lambda: summa3d_spgemm(a3, b3, flops_cap=fc3,
                                         out_capacity=oc3),
                  dict(grid=GRID3D, impl="xla", flops_cap=fc3,
                       out_capacity=oc3,
                       setup_secs=time.perf_counter() - t)))
    return cells
