"""Algebraic-multigrid restriction: MIS-2 coarsening and Galerkin products
(port of ``combblas_tpu/models/multigrid.py``).

MIS-2 is Luby over the distance-2 neighbourhood (``RestrictionOp.h:118``):
a vertex wins when its random priority beats every vertex within two hops,
two chained (max, select2nd) SpMVs a round.  The restriction matrix R maps
every vertex to a coarse vertex near it; the coarse operator R·A·Rᵀ
(``RestrictionOp.h:197``) is two SpGEMMs, ``spgemm_auto`` locally (the
expansion and compress kernels K1/K2, or K3/K4 where the plan goes wide)
and ``summa_spgemm_auto`` on the grid.

Priorities come from a ``torch.Generator`` (JAX draws from a key): the
draw is :func:`_priorities`, which the tests replace with JAX's draws to
compare sets exactly.

On a grid over several processes the live set, the priorities and the set
are this process's slices: every process draws the whole vector's
priorities from its generator (seeded alike) and keeps its slice, as
``luby_mis_dist`` does, and every round's stop is read over all the
processes.  The host maps the JAX functions return or walk (MIS-2's set,
the attachments behind R's triples) are put together from the slices.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.models.mis import _priorities
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spgemm import spgemm_auto
from combblas_tpu_torch.ops.spmv import spmv
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import DistSpMat, row_vec_len
from combblas_tpu_torch.parallel.elementwise import dist_transpose
from combblas_tpu_torch.parallel.spmv import _padded, dist_spmv
from combblas_tpu_torch.parallel.summa import summa_spgemm_auto
from combblas_tpu_torch.semiring import MAX_SECOND, MIN_SECOND, PLUS_TIMES

__all__ = [
    "mis2", "restriction_op", "galerkin",
    "mis2_dist", "mis2_verify_dist", "restriction_op_dist", "galerkin_dist",
]


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _two_hop_max(spmv_max, x: torch.Tensor) -> torch.Tensor:
    """The max of ``x`` over each vertex's distance-<=2 neighbourhood,
    itself included, through ``spmv_max`` (a (max, select2nd) SpMV)."""
    h1 = _finite_or_zero(spmv_max(x))
    h1 = torch.maximum(h1, _padded(x, h1.shape[0]))
    return torch.maximum(_finite_or_zero(spmv_max(h1)), h1)


def _mis2_rounds(spmv_max, live: torch.Tensor, generator: torch.Generator,
                 grid=None, lo: int = 0) -> torch.Tensor:
    """Luby rounds at distance 2 over the vertices where ``live`` holds,
    one host read a round: winners remove their distance-2
    neighbourhood.  On a pod (``grid``) ``live`` is this process's slice,
    from ``lo`` on, of the padded vector."""
    pod = grid is not None and grid.is_pod
    n = live.shape[0] * (grid.nproc if pod else 1)
    in_set = torch.zeros(live.shape[0], dtype=torch.bool, device=live.device)
    while exchange.any_proc(live.any(), grid) if pod else bool(live.any()):
        pri = _priorities(n, live, generator, lo)
        winners = live & (pri >= _two_hop_max(spmv_max, pri)) & (pri > 0)
        hit = _two_hop_max(spmv_max, winners.to(torch.float32)) > 0
        in_set, live = in_set | winners, live & ~hit
    return in_set


def mis2(a: SpCOO, generator: torch.Generator) -> torch.Tensor:
    """Maximal independent set of the distance-2 graph
    (``RestrictionOp.h:118``): bool[n] on the matrix's device."""
    live = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    return _mis2_rounds(lambda x: spmv(a, x, MAX_SECOND), live, generator)


def _assemble_r(in_set: np.ndarray, attach: np.ndarray):
    """R's triples: coarse ids are the MIS-2 vertices in order, then the
    leftovers (``attach`` < 0), each its own coarse vertex; fine vertex v
    goes to the coarse id of ``attach[v]``.  Returns (rows, ncoarse)."""
    n = in_set.shape[0]
    coarse = np.nonzero(in_set)[0]
    cid = np.full(n, -1, np.int64)
    cid[coarse] = np.arange(coarse.size)
    left = np.nonzero(attach < 0)[0]
    cid[left] = coarse.size + np.arange(left.size)
    attach = attach.copy()
    attach[left] = left
    return cid[attach], coarse.size + left.size


def restriction_op(a: SpCOO, generator: torch.Generator) -> SpCOO:
    """The (ncoarse, n) restriction matrix (``RestrictionOp.h:197``):
    coarse vertices are the MIS-2 set; every fine vertex attaches to a
    coarse neighbour, else through an attached neighbour, else becomes
    coarse itself.  The attachment walks the stored edges in order on the
    host, as JAX does: the first coarse neighbour in edge order, then two
    sweeps in which an attachment found earlier in a sweep already
    propagates (so a sweep can carry one further than two hops)."""
    n = a.shape[0]
    in_set = mis2(a, generator).cpu().numpy()
    k = min(int(a.nnz), a.capacity)
    edges = list(zip(a.row[:k].tolist(), a.col[:k].tolist()))
    coarse = in_set.tolist()
    attach = [v if coarse[v] else -1 for v in range(n)]
    for u, v in edges:
        if attach[u] < 0 and coarse[v]:
            attach[u] = v
        if attach[v] < 0 and coarse[u]:
            attach[v] = u
    for _ in range(2):
        for u, v in edges:
            if attach[u] < 0 and attach[v] >= 0:
                attach[u] = attach[v]
            if attach[v] < 0 and attach[u] >= 0:
                attach[v] = attach[u]
    rows, ncoarse = _assemble_r(in_set, np.asarray(attach, np.int64))
    return SpCOO.from_arrays(rows, np.arange(n), np.ones(n, np.float32),
                             (ncoarse, n), device=a.device)


def galerkin(r: SpCOO, a: SpCOO) -> SpCOO:
    """The coarse operator R·A·Rᵀ (``RestrictionOp.h:197``,
    ``ReleaseTests/GalerkinNew.cpp:105-112``): two ``spgemm_auto``."""
    return spgemm_auto(spgemm_auto(r, a), r.transpose())


# -- on the block grid ------------------------------------------------------

def _slice_of(a: DistSpMat, x: np.ndarray) -> torch.Tensor:
    """This process's slice of the row-space vector whose first elements
    are the host array ``x`` (zero-padded), on the grid's device."""
    n_pad = row_vec_len(a.gshape, a.grid)
    lo, hi = a.grid.vec_range(n_pad)
    pad = np.zeros(n_pad, x.dtype)
    pad[:x.shape[0]] = x
    return torch.from_numpy(pad[lo:hi]).to(a.row.device)


def _ids(a: DistSpMat, dtype) -> torch.Tensor:
    """The global ids of this process's slice of a row-space vector."""
    lo, hi = a.grid.vec_range(row_vec_len(a.gshape, a.grid))
    return torch.arange(lo, hi, dtype=dtype, device=a.row.device)


def mis2_dist(a: DistSpMat, generator: torch.Generator) -> np.ndarray:
    """Distributed MIS-2 (``RestrictionOp.h:118``): Luby rounds over the
    distance-2 neighbourhood, two chained (max, select2nd) ``dist_spmv``
    a hop, one host read a round (the reference's ``while (cntUnfinished
    > 0)``).  ``a``: symmetric.  Returns a host bool array of length
    ``a.gshape[0]`` (on a pod, the whole array in every process)."""
    n = a.gshape[0]
    lo = a.grid.vec_range(row_vec_len(a.gshape, a.grid))[0]
    in_set = _mis2_rounds(lambda x: dist_spmv(a, x, MAX_SECOND),
                          _ids(a, torch.int64) < n, generator, a.grid, lo)
    return exchange.gather_whole(in_set, a.grid).cpu().numpy()[:n]


def mis2_verify_dist(a: DistSpMat, in_set) -> bool:
    """MIS-2 check (the reference's ``SpMV<MIS2verifySR>``) of a 0/1
    adjacency without self loops: no set vertex has a set neighbour, no
    vertex has two, and every vertex lies within distance 2 of the set.
    ``in_set``: a host array of the n vertices (on a pod, whole in every
    process)."""
    n = a.gshape[0]
    sp = _slice_of(a, np.asarray(in_set)[:n].astype(bool))
    s = sp.to(torch.float32)
    m1 = _finite_or_zero(dist_spmv(a, s, PLUS_TIMES))
    cover = _two_hop_max(lambda x: dist_spmv(a, x, MAX_SECOND), s)
    bad = (sp & (m1 > 0)).any() | (m1 >= 2).any() | (
        (_ids(a, torch.int64) < n) & ~((cover > 0) | sp)).any()
    return not exchange.any_proc(bad, a.grid)


def restriction_op_dist(a: DistSpMat, generator: torch.Generator
                        ) -> DistSpMat:
    """Distributed restriction matrix (``RestrictionOp.h:197``): coarse
    vertices are the distributed MIS-2; every fine vertex attaches to its
    least coarse neighbour, else to the least attachment among its
    neighbours (two (min, select2nd) ``dist_spmv``), else becomes coarse
    itself; R is bucketed onto ``a``'s grid (on a pod, from the whole host
    triples, each process its blocks)."""
    n = a.gshape[0]
    in_set = mis2_dist(a, generator)
    coarse = _slice_of(a, in_set)
    ids = _ids(a, torch.float32)
    inf = float("inf")
    att1 = dist_spmv(a, torch.where(coarse, ids, inf), MIN_SECOND)
    att1 = torch.where(coarse, ids, att1)
    att2 = dist_spmv(a, torch.where(torch.isfinite(att1), att1, inf),
                     MIN_SECOND)
    att = torch.where(torch.isfinite(att1), att1, att2)
    attach = torch.where(torch.isfinite(att), att, -1.0).to(torch.int64)
    attach = exchange.gather_whole(attach, a.grid)[:n].cpu().numpy()
    rows, ncoarse = _assemble_r(in_set, attach)
    return DistSpMat.from_coo_arrays(rows, np.arange(n),
                                     np.ones(n, np.float32),
                                     (int(ncoarse), n), a.grid)


def galerkin_dist(r: DistSpMat, a: DistSpMat) -> DistSpMat:
    """Distributed R·A·Rᵀ: two ``summa_spgemm_auto`` and one
    ``dist_transpose`` (``RestrictionOp.h:197``,
    ``ReleaseTests/GalerkinNew.cpp:105-112``)."""
    return summa_spgemm_auto(summa_spgemm_auto(r, a), dist_transpose(r))
