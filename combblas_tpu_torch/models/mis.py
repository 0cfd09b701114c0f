"""Maximal independent set by Luby's algorithm (port of
``combblas_tpu/models/mis.py``).

Each round draws random priorities for the live vertices; a vertex joins
the set when its priority beats every live neighbour's (a (max,
select2nd) SpMV), then the winners and their neighbours leave the live
set.  Priorities come from a ``torch.Generator`` (JAX draws from a key):
the two packages draw different numbers, so they are compared on the
set's invariants, not its members.  On a grid over several processes each
draws the whole vector's priorities from its copy of the generator and
keeps its slice, so the set is one process's.
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
    row_vec_len,
)
from combblas_tpu_torch.parallel.spmv import dist_spmsv_masked
from combblas_tpu_torch.semiring import MAX_SECOND

__all__ = ["luby_mis", "luby_mis_dist"]


def _priorities(n: int, live: torch.Tensor, generator: torch.Generator,
                lo: int = 0):
    """uniform[1, 2) priorities on the live vertices, 0 on the dead, drawn
    on the generator's device (so one CPU generator gives the card and the
    CPU the same draws): all ``n`` drawn, ``live`` covering [lo, lo +
    len(live)) of them."""
    pri = torch.rand(n, generator=generator, device=generator.device) + 1.0
    pri = pri[lo:lo + live.shape[0]]
    return torch.where(live, pri.to(live.device), 0.0)


def luby_mis(a: SpCOO, generator: torch.Generator) -> torch.Tensor:
    """Boolean MIS membership of a symmetric graph with an empty diagonal
    (a self loop would keep its vertex live for ever)."""
    n = a.shape[0]
    in_set = torch.zeros(n, dtype=torch.bool, device=a.device)
    live = torch.ones(n, dtype=torch.bool, device=a.device)
    while bool(live.any()):
        pri = _priorities(n, live, generator)
        nbr_best = spmv(a, pri, MAX_SECOND)      # best neighbour priority
        nbr_best = torch.where(torch.isfinite(nbr_best), nbr_best, 0.0)
        winners = live & (pri > nbr_best)
        hit = spmv(a, winners.to(torch.float32), MAX_SECOND)
        hit = torch.where(torch.isfinite(hit), hit, 0.0) > 0
        live = live & ~winners & ~hit
        in_set = in_set | winners
    return in_set


def luby_mis_dist(a: DistSpMat, generator: torch.Generator,
                  edge_pred=None) -> torch.Tensor:
    """Distributed Luby MIS on the block grid: two masked SpMV fan-out /
    fan-ins a round.  ``edge_pred`` keeps only the edges whose value passes
    it (late filtering).  At most ``4 * int(ceil(log2 n) + 4)`` rounds, as
    JAX bounds them.  Returns the boolean membership vector in the
    row-space layout (length ``row_vec_len``; on a pod this process's
    slice); padding vertices never join."""
    n = a.gshape[0]
    g = a.grid
    n_pad = row_vec_len(a.gshape, g)
    lo, hi = g.vec_range(n_pad)
    dev = a.row.device
    live = torch.arange(lo, hi, device=dev) < n
    in_set = torch.zeros(hi - lo, dtype=torch.bool, device=dev)
    max_rounds = 4 * int(np.ceil(np.log2(max(n, 2))) + 4)
    rounds = 0
    entries = _live_entries(a)
    while exchange.any_proc(live.any(), g) and rounds < max_rounds:
        rounds += 1
        pri = _priorities(n_pad, live, generator, lo)
        nbr_best, hit0 = dist_spmsv_masked(a, pri, live, MAX_SECOND,
                                           transpose=False,
                                           edge_pred=edge_pred, live=entries)
        nbr_best = torch.where(hit0, nbr_best, 0.0)
        winners = live & (pri > nbr_best)
        blocked, hitw = dist_spmsv_masked(
            a, winners.to(torch.float32), winners, MAX_SECOND,
            transpose=False, edge_pred=edge_pred, live=entries)
        dead = hitw & (blocked > 0)
        in_set = in_set | winners
        live = live & ~winners & ~dead
    return in_set
