"""MCL (HipMCL): Markov clustering by expand, prune, inflate (port of
``combblas_tpu/models/mcl.py``).

The loops run on the host (capacities change between iterations).

- :func:`mcl_local`: the expansion is ``spgemm_auto`` with a caller-held
  plan, whose row slabs run on the card's expansion and compress kernels:
  the packed pair (K1, K2) when a slab's keys fit int32 and the span plan
  needs no more slabs than the memory plan, else the wide pair (K3, K4).
  At scale 17 (``bench_mcl``'s graph) the plan takes two wide slabs, K3
  and K4; smaller plans (scale 12) run K1 and K2.  The prune is one
  sorted pass of the rule (``MCLPruneRecoverySelect``) over the
  expansion's live prefix: entries below ``cutoff`` drop, a column keeps
  at most its ``select`` largest, and a column left with too few takes
  its ``recover_num`` largest of the unpruned column instead.
- :func:`mcl_dist` (HipMCL proper): on a block grid, the expansion is
  ``mem_efficient_spgemm`` (phased SUMMA) with :func:`dist_mcl_prune`, the
  threshold form of the rule, run inside every phase.  Its blocks take the
  packed route (K1, K2) when ``(mb+1)*(nb+1) < 2^31``, as on a 4x4 grid at
  scale 17, and the wide route (K3, K4) otherwise.  With ``layers > 1`` the
  expansion is the 3D SUMMA.  Clusters are ``fastsv_dist`` of ``A +
  A^T``.  ``preprocess=True`` first runs HipMCL's ``RemoveIsolated`` and
  ``RandPermute`` (:func:`dist_remove_isolated`, :func:`dist_rand_permute`:
  ``dist_permute`` owner exchanges) and translates the labels back.
  On a grid over several processes (a pod) ``mcl_dist`` runs with or
  without the layers and the preprocessing: every stage is the pod form
  of its distributed op (the 3D expansion on a layered grid over the same
  processes), every branch and the loop's stop read
  values reduced over the processes, and the labels are this process's
  slice.  The preprocessing's host maps (length n) are built whole in
  every process, from one all-gather of their slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from combblas_tpu_torch.models.cc import fastsv_dist, fastsv_local
from combblas_tpu_torch.ops.coo import SpCOO, merge
from combblas_tpu_torch.ops.ewise import _compact, dim_apply
from combblas_tpu_torch.ops.kselect import col_desc_order
from combblas_tpu_torch.ops.reduce import reduce_dim
from combblas_tpu_torch.ops.spgemm import spgemm_auto
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import DistSpMat
from combblas_tpu_torch.parallel.elementwise import (
    dist_add,
    dist_apply,
    dist_dim_apply,
    dist_kselect2_col,
    dist_kselect_col,
    dist_nnz_per_col,
    dist_prune,
    dist_prune_column,
    dist_reduce,
    dist_transpose,
)
from combblas_tpu_torch.parallel.indexing import dist_permute
from combblas_tpu_torch.parallel.memefficient import mem_efficient_spgemm
from combblas_tpu_torch.parallel.vector import dist_rand_perm
from combblas_tpu_torch.semiring import MAX_FIRST, PLUS_TIMES
from combblas_tpu_torch.utils.timers import span

__all__ = ["MCLParams", "mcl_local", "mcl_dist", "dist_mcl_prune",
           "dist_remove_isolated", "dist_rand_permute",
           "make_col_stochastic", "chaos"]

#: The seed of ``mcl_dist``'s permutation when no generator is given (the
#: JAX package defaults to ``PRNGKey(17)``).
PREPROCESS_SEED = 17

#: ``spgemm_auto``'s slab budget in MCL: the default 2^24 would cut the
#: expansion into many more row slabs at bench scales.
EXPANSION_FLOPS_CAP = 1 << 28


@dataclasses.dataclass
class MCLParams:
    """HipMCL's runtime parameters (``MCL.cpp`` ProcessParam)."""

    inflation: float = 2.0
    cutoff: float = 1.0e-4  # prunelimit base
    select: int = 1100  # -select
    recover_num: int = 1400  # -recover_num
    recover_pct: float = 0.9  # -recover_pct
    eps: float = 1.0e-3  # chaos convergence EPS
    max_iters: int = 100
    add_self_loops: bool = True


def make_col_stochastic(a: SpCOO) -> SpCOO:
    """Normalize columns to sum 1 (``MakeColStochastic``: Reduce(Column,
    +), safe inverse, DimApply)."""
    colsum = reduce_dim(a, "col")
    inv = torch.where(colsum > 0, 1.0 / colsum, 0.0)
    return dim_apply(a, inv, "col")


def _square(v):
    return v * v


def chaos(a: SpCOO) -> torch.Tensor:
    """Convergence metric (``Chaos``): max over columns of (column max -
    column sum of squares); an empty column counts 0 for its max."""
    colmax = reduce_dim(a, "col", MAX_FIRST)
    colmax = torch.where(torch.isfinite(colmax), colmax, 0.0)
    colss = reduce_dim(a, "col", premap=_square)
    return torch.max(colmax - colss)


def _inflate(a: SpCOO, power: float) -> SpCOO:
    val = torch.where(a.mask(), torch.pow(a.val.abs(), power), 0.0)
    return dataclasses.replace(a, val=val)


def _mcl_prune(a: SpCOO, p: MCLParams, out_capacity: int) -> SpCOO:
    """Threshold, select and recovery (``MCLPruneRecoverySelect``) in one
    sorted pass: one stable sort by (col, |v| descending) ranks every
    entry in its column; the three rules are then rank masks, scattered
    back to entry order, and the survivors compact once.

    Every pass runs on the live prefix, the first ``nnz`` slots: by
    ``SpCOO``'s contract the rest are pads, which would sort after every
    live entry and never be kept, so the output equals the JAX package's,
    which sorts the whole capacity."""
    n = a.shape[1]
    live = min(int(a.nnz), a.capacity)
    a = dataclasses.replace(a, row=a.row[:live], col=a.col[:live],
                            val=a.val[:live])
    av = a.val.abs()
    eid_s = col_desc_order(a.col, av)
    col_s = a.col[eid_s]
    col_start = torch.searchsorted(
        col_s, torch.arange(n + 1, dtype=col_s.dtype, device=a.device))
    pos = torch.arange(live, device=a.device) - col_start[col_s.long()]
    # entries >= cutoff form a per-column prefix of this order, so the
    # kept count per column is a difference of a cumulative sum
    cut_s = av[eid_s] >= p.cutoff
    c0 = torch.zeros(live + 1, dtype=torch.int64, device=a.device)
    c0[1:] = torch.cumsum(cut_s, 0)
    kept = torch.clamp(c0[col_start[1:]] - c0[col_start[:-1]],
                       max=p.select)
    # recovery: columns whose post-select count fell below the floor take
    # their top recover_num of the unpruned column
    need_rec = kept < int(p.recover_pct * min(p.recover_num, p.select))
    rec_s = need_rec[col_s.long()]
    final_s = torch.where(rec_s, pos < p.recover_num,
                          cut_s & (pos < p.select))
    keep = torch.empty(live, dtype=torch.bool, device=a.device)
    keep[eid_s] = final_s
    return _compact(a, keep, out_capacity)


def _mask_cols(a: SpCOO, colmask: torch.Tensor) -> SpCOO:
    """Keep only the entries of the columns where ``colmask`` holds."""
    n = a.shape[1]
    return _compact(a, colmask[a.col.clamp(max=n - 1).long()])


def _mcl_iteration(a: SpCOO, p: MCLParams, cap: int, plan: dict):
    """One iteration of :func:`mcl_local`: expansion (``spgemm_auto`` with
    the caller-held ``plan``), prune into ``min(cap, capacity)``, inflation
    and normalisation; the new iterate and its chaos."""
    with span("mcl.iteration", a.row):
        with span("mcl.expand"):
            a2 = spgemm_auto(a, a, out_capacity=None, plan=plan,
                             max_flops_cap=EXPANSION_FLOPS_CAP)
        with span("mcl.prune"):
            a2 = _mcl_prune(a2, p, min(cap, a2.capacity))
        with span("mcl.inflate"):
            a2 = make_col_stochastic(_inflate(a2, p.inflation))
        with span("mcl.chaos"):
            ch = float(chaos(a2))
    return a2, ch


def iterate_capacity(a: SpCOO, p: MCLParams) -> int:
    """The pruned iterate's capacity bound for a start matrix ``a`` (self
    loops added, normalised): ``select`` entries a column, as the JAX
    package sizes it.  Recovery may keep up to ``recover_num`` > ``select``
    in a column; entries past the bound are dropped by ``_compact``, whose
    ``nnz`` still counts them."""
    n = a.shape[1]
    return max(a.capacity, 1 << int(np.ceil(np.log2(
        max(min(p.select * n, n * n), 8)))))


def mcl_local(a: SpCOO, params: Optional[MCLParams] = None,
              verbose: bool = False,
              on_iter: Optional[Callable[[int, float, float], None]] = None,
              deadline: Optional[float] = None):
    """Run MCL on a local matrix; returns (cluster_labels, n_iterations).

    Clusters are the connected components of the last iterate's structure
    (``Interpret``).  ``on_iter(it, chaos, secs)`` is called after every
    iteration; ``deadline`` is an absolute ``time.perf_counter()`` cutoff
    after which the loop stops (from iteration 3 on), labels still taken
    from the current matrix."""
    p = params or MCLParams()
    with span("mcl.clustering", a.row):
        n = a.shape[1]
        if p.add_self_loops:
            eye = SpCOO.eye(n, dtype=a.val.dtype, device=a.device)
            a = merge(a, eye, PLUS_TIMES)
        a = make_col_stochastic(a)
        cap = iterate_capacity(a, p)
        it = 0
        # the plan dict freezes the expansion's route and capacities after the
        # first call with each operand capacity (iteration 1 sees the input's,
        # iteration 2 on the pruned one's)
        exp_plan: dict = {}
        for it in range(1, p.max_iters + 1):
            t0 = time.perf_counter()
            a, ch = _mcl_iteration(a, p, cap, exp_plan)
            if verbose:
                print(f"mcl iter {it}: chaos={ch:.5f} nnz={int(a.nnz)}")
            if on_iter is not None:
                on_iter(it, ch, time.perf_counter() - t0)
            if ch < p.eps:
                break
            if deadline is not None and it >= 3 \
                    and time.perf_counter() > deadline:
                break
        with span("mcl.labels"):
            sym = merge(a, a.transpose(), PLUS_TIMES)
            labels = fastsv_local(sym)
    return labels, it


# -- distributed HipMCL ------------------------------------------------------

def _below_or_equal_cutoff(cutoff: float):
    # the reference's hard-threshold prune is less_equal
    def f(v):
        return v <= cutoff

    return f


def _below_thresh(v, t):
    return v < t


def _pow_closure(power: float):
    def f(v):
        return torch.pow(v.abs(), power)

    return f


def dist_mcl_prune(c: DistSpMat, p: MCLParams,
                   use_kselect2: bool = False) -> DistSpMat:
    """Distributed ``MCLPruneRecoverySelect``: one threshold a column.

    1. statistics of the hard-threshold-pruned matrix (entries <= cutoff
       drop);
    2. recovery columns (pruned nnz < recover_num, pruning removed
       something, pruned column sum < recover_pct) take the threshold
       Kselect(A, recover_num);
    3. other columns with pruned nnz > select take Kselect(A, select);
    4. selected columns left with nnz < recover_num and sum < recover_pct
       fall back to Kselect(A, recover_num);
    5. one PruneColumn(v < threshold) of the unpruned matrix, whose
       capacity the result keeps.

    Kselect is ``dist_kselect_col`` with ``k_cap = max(select,
    recover_num)``, or the bisection ``dist_kselect2_col`` with
    ``use_kselect2``.  Entries equal to a column's threshold all stay,
    unlike ``mcl_local``'s top-k.  On a pod each branch is taken when a
    column of any process asks for it, so every process runs the same
    k-selects."""
    if use_kselect2:
        ksel = dist_kselect2_col
    else:
        kmax = max(int(p.recover_num), int(p.select), 1)

        def ksel(c_, k_):
            return dist_kselect_col(c_, k_, k_cap=kmax)
    c1 = dist_prune(c, _below_or_equal_cutoff(p.cutoff))
    nnz_unpruned = dist_nnz_per_col(c)
    nnz_p = dist_nnz_per_col(c1)
    sums = dist_reduce(c1, "col")
    del c1
    thresh = torch.full_like(sums, p.cutoff)
    recover = ((nnz_p < p.recover_num) & (nnz_unpruned > nnz_p)
               & (sums < p.recover_pct))
    grid = c.grid
    if p.recover_num > 0 and exchange.any_proc(recover.any(), grid):
        thresh = torch.where(recover, ksel(c, p.recover_num), thresh)
    if p.select > 0:
        sel = ~recover & (nnz_p > p.select)
        if exchange.any_proc(sel.any(), grid):
            thresh = torch.where(sel, ksel(c, p.select), thresh)
            if p.recover_num > 0:
                c_sel = dist_prune_column(c, thresh, _below_thresh)
                nnz1 = dist_nnz_per_col(c_sel)
                sums1 = dist_reduce(c_sel, "col")
                del c_sel
                resel = sel & (nnz1 < p.recover_num) & (sums1 < p.recover_pct)
                if exchange.any_proc(resel.any(), grid):
                    thresh = torch.where(resel, ksel(c, p.recover_num),
                                         thresh)
    return dist_prune_column(c, thresh, _below_thresh)


def _dist_col_stochastic(m: DistSpMat) -> DistSpMat:
    """Columns scaled to sum 1 (empty columns stay empty)."""
    colsum = dist_reduce(m, "col")
    inv = torch.where(colsum > 0, 1.0 / colsum, 0.0)
    return dist_dim_apply(m, inv, "col")


def _dist_chaos(m: DistSpMat) -> torch.Tensor:
    """:func:`chaos` over the block grid: max over columns of (column max
    - column sum of squares), over every process of a pod."""
    cmax = dist_reduce(m, "col", MAX_FIRST)
    cmax = torch.where(torch.isfinite(cmax), cmax, 0.0)
    css = dist_reduce(m, "col", premap=_square)
    return exchange.max_proc(torch.max(cmax - css), m.grid)


def _expand_2d(m: DistSpMat, hook: Callable, phases: int) -> DistSpMat:
    """The 2D expansion: phased SUMMA with the prune inside every phase."""
    return mem_efficient_spgemm(m, m, phases=phases, phase_hook=hook)


def _expand_3d(m: DistSpMat, hook: Callable, phases: int,
               grid3) -> DistSpMat:
    """The 3D expansion (``MemEfficientSpGEMM3D``): A redistributed to the
    layered grid, every column slab through ``summa3d_spgemm``, back to the
    2D grid (``Convert2D``), pruned, and summed in."""
    from combblas_tpu_torch.parallel.summa3d import (
        Dist3DSpMat,
        _col_slab3d,
        summa3d_bounds,
        summa3d_spgemm,
    )

    a3 = Dist3DSpMat.from_dist2d(m, grid3, "col")
    b3 = Dist3DSpMat.from_dist2d(m, grid3, "row")
    fc, oc = summa3d_bounds(a3, b3)
    fc = max(fc // max(phases, 1), 1024)
    oc = max(oc // max(phases, 1), 1024)
    _, nb3 = b3.block_shape()
    slab = -(-nb3 // phases)
    acc = None
    for ph in range(phases):
        lo, hi = ph * slab, min((ph + 1) * slab, nb3)
        if lo >= hi:
            break
        bp = _col_slab3d(b3, lo, hi) if phases > 1 else b3
        cp3 = summa3d_spgemm(a3, bp, flops_cap=fc, out_capacity=oc)
        cp = hook(cp3.to_dist2d(m.grid))
        del cp3
        acc = cp if acc is None else dist_add(
            acc, cp, out_capacity=acc.capacity + cp.capacity)
    return acc


def _mcl_dist_iteration(a: DistSpMat, p: MCLParams, expand: Callable):
    """One iteration of :func:`mcl_dist`: expansion (pruned per phase),
    inflation, normalisation; the new iterate and its chaos."""
    a2 = expand(a)
    a2 = dist_apply(a2, _pow_closure(p.inflation))
    a2 = _dist_col_stochastic(a2)
    return a2, float(_dist_chaos(a2))


def dist_remove_isolated(a: DistSpMat):
    """``RemoveIsolated`` (``MCL.cpp:477``): the vertices with an empty
    column dropped by compacting the kept ones to the front of the index
    space (``gshape`` stays), one ``dist_permute``.  Returns (compacted
    matrix, host int32 map with -1 for a dropped vertex, kept count); on
    a pod every process holds the whole map."""
    n = a.gshape[1]
    counts = exchange.gather_whole(dist_nnz_per_col(a), a.grid)
    keep = counts[:n].cpu().numpy() > 0
    n_keep = int(keep.sum())
    vmap = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
    return dist_permute(a, vmap, vmap), vmap, n_keep


def dist_rand_permute(a: DistSpMat, generator: torch.Generator):
    """``RandPermute`` (``MCL.cpp:497``): the symmetric random relabelling
    A(p, p), a ``dist_rand_perm`` drawn from ``generator`` and one
    ``dist_permute``.  Returns (matrix, host permutation of length n); on
    a pod every process holds the whole permutation."""
    n = a.gshape[1]
    perm = exchange.gather_whole(dist_rand_perm(generator, n, a.grid),
                                 a.grid)[:n].cpu().numpy()
    return dist_permute(a, perm), perm


def _preprocess(a: DistSpMat, generator):
    """``RemoveIsolated`` then ``RandPermute``: the matrix and the map of
    every original vertex to its permuted compacted index (-1: dropped)."""
    if generator is None:
        generator = torch.Generator(device=a.grid.device).manual_seed(
            PREPROCESS_SEED)
    a, vmap, _ = dist_remove_isolated(a)
    a, perm = dist_rand_permute(a, generator)
    return a, np.where(vmap >= 0, perm[np.maximum(vmap, 0)], -1)


def _labels_back(labels: torch.Tensor, vmap: np.ndarray, n_cols: int,
                 grid) -> torch.Tensor:
    """The labels of the original vertices: a kept vertex takes its
    permuted index's label, an isolated vertex ``n_cols + its index`` (a
    singleton, apart from every kept label).  On a pod, this process's
    slice of the n labels padded to a multiple of the processes (a pad
    slot labelled as an isolated vertex), each kept label read from the
    process that holds it."""
    n = vmap.shape[0]
    lo, hi = grid.vec_range(-(-n // grid.nproc) * grid.nproc)
    part = np.full(hi - lo, -1, np.int32)
    part[:max(min(hi, n) - lo, 0)] = vmap[lo:hi]
    dev = labels.device
    kept = torch.from_numpy(part >= 0).to(dev)
    idx = torch.from_numpy(np.maximum(part, 0).astype(np.int64)).to(dev)
    own = n_cols + torch.arange(lo, hi, device=dev)
    return torch.where(kept, exchange.gather_at(labels, idx, grid),
                       own.to(labels.dtype))


def mcl_dist(a: DistSpMat, params: Optional[MCLParams] = None,
             phases: int = 1, verbose: bool = False,
             preprocess: bool = False,
             generator: Optional[torch.Generator] = None,
             use_kselect2: bool = False, layers: int = 1, grid3=None):
    """Distributed HipMCL on a square block grid: the expansion is
    ``mem_efficient_spgemm`` in ``phases`` column slabs with
    :func:`dist_mcl_prune` applied inside every phase, then inflation and
    normalisation as distributed column ops, until the chaos falls below
    ``eps``; the clusters are ``fastsv_dist`` of ``A + A^T``.  No self
    loops are added (``params.add_self_loops`` is not read).

    ``layers > 1`` runs the expansion on the 3D grid ``grid3`` (its
    ``layers`` layers over ``a``'s 2D grid).  ``preprocess=True`` runs
    ``RemoveIsolated`` and ``RandPermute`` first (the permutation drawn
    from ``generator``, on any device; default: one on the grid's device
    seeded ``PREPROCESS_SEED``; JAX takes ``rng_key``) and translates the
    labels back.  Returns (labels, iterations): the labels are the
    column-space FullyDist vector of length ``col_vec_len``, or with
    ``preprocess`` one label per original vertex (length n), an isolated
    vertex labelled ``n + its index``.  On a grid over several processes
    the labels are this process's slice: of the column-space vector, or
    with ``preprocess`` its ``vec_range`` slice of the n labels padded to
    a multiple of the processes (a pad slot i labelled ``n + i``), so that
    the slices put together and cut to n are one process's labels.  There
    ``grid3`` must span the same processes as ``a``'s grid."""
    p = params or MCLParams()
    vmap = None
    if preprocess:
        a, vmap = _preprocess(a, generator)

    def hook(c: DistSpMat) -> DistSpMat:
        return dist_mcl_prune(c, p, use_kselect2=use_kselect2)

    if layers > 1:
        if grid3 is None or not grid3.is3d or grid3.layers != layers:
            raise ValueError("mcl_dist(layers > 1) needs a 3D ProcGrid "
                             "(grid3=) with that many layers")
        if (grid3.nproc, grid3.rank) != (a.grid.nproc, a.grid.rank):
            raise ValueError(f"grid3 spans {grid3.nproc} processes (rank "
                             f"{grid3.rank}), the matrix's grid "
                             f"{a.grid.nproc} (rank {a.grid.rank})")

        def expand(m):
            return _expand_3d(m, hook, phases, grid3)
    else:
        def expand(m):
            return _expand_2d(m, hook, phases)

    a = _dist_col_stochastic(a)
    it = 0
    for it in range(1, p.max_iters + 1):
        a, ch = _mcl_dist_iteration(a, p, expand)
        if verbose:
            print(f"mcl_dist iter {it}: chaos={ch:.5f} "
                  f"nnz={int(a.total_nnz())}")
        if ch < p.eps:
            break
    sym = dist_add(a, dist_transpose(a))
    labels = fastsv_dist(sym)
    if vmap is not None:
        return _labels_back(labels, vmap, a.gshape[1], a.grid), it
    return labels, it
