"""MCL (HipMCL), the local half: Markov clustering by expand, prune,
inflate (port of ``combblas_tpu/models/mcl.py``).

The loop runs on the host (capacities change between iterations).  The
expansion is ``spgemm_auto`` with a caller-held plan, so on the card it
runs the hand-written expansion (K1) and compress (K2) kernels in row slabs.
Pruning keeps the reference's semantics (``MCLPruneRecoverySelect``):
entries below ``cutoff`` drop, a column keeps at most its ``select``
largest, and a column left with too few takes its ``recover_num`` largest
of the unpruned column instead.  The distributed half (``mcl_dist`` and its
prune, isolated-vertex removal and permutation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from combblas_tpu_torch.models.cc import fastsv_local
from combblas_tpu_torch.ops.coo import SpCOO, merge
from combblas_tpu_torch.ops.ewise import _compact, dim_apply
from combblas_tpu_torch.ops.kselect import col_desc_order
from combblas_tpu_torch.ops.reduce import reduce_dim
from combblas_tpu_torch.ops.spgemm import spgemm_auto
from combblas_tpu_torch.semiring import MAX_FIRST, PLUS_TIMES

__all__ = ["MCLParams", "mcl_local", "make_col_stochastic", "chaos"]

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
    back to entry order, and the survivors compact once."""
    n = a.shape[1]
    cap = a.capacity
    live = a.mask()
    av = torch.where(live, a.val.abs(), -1.0)
    col = torch.where(live, a.col, n)
    eid_s = col_desc_order(col, av)
    col_s = col[eid_s]
    col_start = torch.searchsorted(
        col_s, torch.arange(n + 1, dtype=col_s.dtype, device=a.device))
    pos = torch.arange(cap, device=a.device) - col_start[col_s.long()]
    # entries >= cutoff form a per-column prefix of this order, so the
    # kept count per column is a difference of a cumulative sum
    cut_s = av[eid_s] >= p.cutoff
    c0 = torch.zeros(cap + 1, dtype=torch.int64, device=a.device)
    c0[1:] = torch.cumsum(cut_s, 0)
    kept = torch.clamp(c0[col_start[1:]] - c0[col_start[:-1]],
                       max=p.select)
    # recovery: columns whose post-select count fell below the floor take
    # their top recover_num of the unpruned column
    need_rec = kept < int(p.recover_pct * min(p.recover_num, p.select))
    rec_s = need_rec[col_s.clamp(max=n - 1).long()]
    final_s = torch.where(rec_s, pos < p.recover_num,
                          cut_s & (pos < p.select)) & (col_s < n)
    keep = torch.empty(cap, dtype=torch.bool, device=a.device)
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
    a2 = spgemm_auto(a, a, out_capacity=None, plan=plan,
                     max_flops_cap=EXPANSION_FLOPS_CAP)
    a2 = _mcl_prune(a2, p, min(cap, a2.capacity))
    a2 = make_col_stochastic(_inflate(a2, p.inflation))
    return a2, float(chaos(a2))


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
    sym = merge(a, a.transpose(), PLUS_TIMES)
    return fastsv_local(sym), it
