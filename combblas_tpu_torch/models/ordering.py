"""Matrix orderings: reverse Cuthill-McKee and minimum degree (port of
``combblas_tpu/models/ordering.py``).

- :func:`rcm_order` (``Applications/Ordering/RCM.cpp:610``): a
  pseudo-peripheral vertex by repeated BFS (``:332``), BFS levels, and
  within each level the order (position of the BFS parent, degree, vertex
  id); components after the first each from their own start; reversed.
- :func:`rcm_order_dist`: the reference's distributed formulation on the
  block grid: BFS by ``bfs_dist``, and per level a vertex's "parent order"
  is the smallest label among its previous-level neighbours, one
  ``dist_spmsv_masked`` with MIN_SECOND (``SpMV<SelectMinSR>``, ``:361``),
  then two stable mesh-wide sorts (by (degree, id), then by parent order)
  and routes.  The two rules differ (the BFS parent is the largest-id
  frontier neighbour, not the earliest-labelled one), so the two orders
  differ in general, in the JAX package as here; each has the same
  levels and bandwidth profile.
- :func:`md_order` / :func:`md_order_dist` (``Applications/Ordering/MD.cpp``):
  greedy minimum degree with exact fill on the host, and the reference's
  distributed loop (reach sets by BFS through eliminated vertices, the
  reach vertices' degrees from one multi-source BFS on a dense n x k
  frontier through ``dist_spmm``); ties by vertex id, so the two are equal.

Every loop is host-paced, as in the JAX package: ``rcm_order_dist`` reads
the host a few times a level, the minimum-degree loops take n steps.  On a
grid over several processes the device vectors are this process's slices;
the host maps the JAX functions read whole (the degrees, each component's
BFS levels, the labels, MD's frontier sets) are put together from the
slices, so every process takes the same branches and returns the whole
order.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.models.bfs import bfs_dist, bfs_local
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.reduce import nnz_per
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dense import dist_spmm
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
    row_vec_len,
)
from combblas_tpu_torch.parallel.elementwise import _dim_fold, dist_reduce
from combblas_tpu_torch.parallel.spmv import dist_spmsv_masked, dist_spmv
from combblas_tpu_torch.parallel.vector import (
    dist_apply_perm,
    dist_route,
    dist_sort_auto,
)
from combblas_tpu_torch.semiring import MIN_SECOND, PLUS_TIMES

__all__ = ["pseudo_peripheral_vertex", "rcm_order", "rcm_order_dist",
           "md_order", "md_order_dist"]

#: The repeated-BFS rounds of the pseudo-peripheral vertex search.
_PPV_ROUNDS = 8


def pseudo_peripheral_vertex(a: SpCOO, start: int = 0,
                             max_rounds: int = _PPV_ROUNDS):
    """Repeated-BFS pseudo-peripheral vertex search (``RCM.cpp:332``): BFS,
    jump to a minimum-degree vertex of the last level, repeat until the
    eccentricity stops growing.  Returns (vertex, eccentricity)."""
    deg = nnz_per(a, "row").cpu().numpy()
    v = start
    last_ecc = -1
    for _ in range(max_rounds):
        _, levels = bfs_local(a, v)
        lv = levels.cpu().numpy()
        ecc = int(lv.max())
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        far = np.nonzero(lv == ecc)[0]
        v = int(far[np.argmin(deg[far])])
    return v, last_ecc


def _cm_order_component(a: SpCOO, parents, levels, degn) -> np.ndarray:
    """Cuthill-McKee order of one BFS component: level by level, sorted by
    (position of the BFS parent in the order so far, degree, id)."""
    lv = levels.cpu().numpy()
    par = parents.cpu().numpy()
    n = lv.shape[0]
    maxlev = int(lv.max())
    pos = np.full(n, -1, np.int64)
    out = []
    counter = 0
    for lev in range(maxlev + 1):
        members = np.nonzero(lv == lev)[0]
        if lev == 0:
            order = members
        else:
            parent_pos = pos[par[members]]
            order = members[np.lexsort((members, degn[members],
                                        parent_pos))]
        pos[order] = counter + np.arange(order.size)
        counter += order.size
        out.append(order)
    return np.concatenate(out)


def rcm_order(a: SpCOO, start: int | None = None) -> torch.Tensor:
    """The RCM permutation: order[i] is the i-th vertex of the reverse
    Cuthill-McKee ordering (int64, on ``a``'s device).  Components after
    the first (``start``'s, or a pseudo-peripheral vertex's) follow, each
    from a pseudo-peripheral vertex of its own."""
    n = a.shape[0]
    degn = nnz_per(a, "row").cpu().numpy()
    visited = np.zeros(n, bool)
    pieces = []
    while not visited.all():
        if start is None or pieces:
            cand = np.nonzero(~visited)[0]
            s = int(cand[np.argmin(degn[cand])])
            s, _ = pseudo_peripheral_vertex(a, s)
        else:
            s = start
        parents, levels = bfs_local(a, s)
        pieces.append(_cm_order_component(a, parents, levels, degn))
        visited |= levels.cpu().numpy() >= 0
        start = None
    order = np.concatenate(pieces)[::-1].copy()
    return torch.from_numpy(order).to(a.device)


def _whole_host(x: torch.Tensor, a: DistSpMat, n: int) -> np.ndarray:
    """The first ``n`` elements of the FullyDist vector of which ``x`` is
    this process's slice, on the host of every process."""
    return exchange.gather_whole(x, a.grid)[:n].cpu().numpy()


def _dist_ppv(a: DistSpMat, s: int, degh: np.ndarray, n: int):
    """The pseudo-peripheral search of :func:`pseudo_peripheral_vertex` by
    ``bfs_dist``; returns the vertex."""
    last_ecc = -1
    for _ in range(_PPV_ROUNDS):
        _, levels = bfs_dist(a, s)
        lv = _whole_host(levels, a, n)
        ecc = int(lv.max())
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        far = np.nonzero(lv == ecc)[0]
        s = int(far[np.argmin(degh[far])])
    return s


def rcm_order_dist(a: DistSpMat, start: int | None = None) -> np.ndarray:
    """Distributed RCM on the block grid (``RCM.cpp:332,361``): per
    component a pseudo-peripheral vertex by repeated ``bfs_dist``, then
    level by level the labels: parent order = the smallest previous-level
    label among a vertex's neighbours (``dist_spmsv_masked``, MIN_SECOND),
    rank by (degree, id) in one stable sort, then by parent order in a
    second, labels routed to their vertices.  One host read a level, the
    masked SpMSpV's active count (the level's size, JAX's read, comes
    from the component's host levels).
    ``a``: square, symmetric structure.  Returns the RCM order as a host
    int64 array (order[i] = the i-th vertex); on a pod, in every
    process."""
    n = a.gshape[0]
    n_pad = row_vec_len(a.gshape, a.grid)
    grid = a.grid
    lo, hi = grid.vec_range(n_pad)
    dev = a.row.device
    live = _live_entries(a)
    deg = dist_reduce(a, "row", PLUS_TIMES, premap=lambda v: 1.0 + 0.0 * v)
    degh = _whole_host(deg, a, n).astype(np.int64)
    visited = np.zeros(n, bool)
    label = np.full(n_pad, -1, np.int64)
    counter = 0
    ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    while not visited.all():
        if start is None:
            cand = np.nonzero(~visited)[0]
            s = int(cand[np.argmin(degh[cand])])
        else:
            s, start = start, None
        s = _dist_ppv(a, s, degh, n)
        _, levels = bfs_dist(a, s)
        lvh = _whole_host(levels, a, n)
        comp = lvh >= 0
        label[s] = counter
        counter += 1
        lab_dev = torch.from_numpy(np.concatenate(
            [label[:n], np.full(n_pad - n, -1)])[lo:hi].astype(
                np.int32)).to(dev)
        for lev in range(1, int(lvh.max()) + 1):
            prev_mask = (levels == lev - 1) & (lab_dev >= 0)
            pord, _ = dist_spmsv_masked(
                a, lab_dev.to(torch.float32) + 1.0, prev_mask, MIN_SECOND,
                transpose=True, live=live)
            members = levels == lev
            nmem = int((lvh == lev).sum())
            # rank 1: stable by (degree, id)
            degkey = torch.where(members, deg.to(torch.float32), inf)
            _, vid1 = dist_sort_auto(degkey, grid, ids)
            rank1, _ = dist_route(vid1, ids, vid1 < n_pad,
                                  torch.zeros_like(ids), grid, combine="set")
            # parent orders at their rank-1 positions, then stable by them
            pkey = torch.where(members, pord, inf)
            pkey_arranged = dist_apply_perm(
                torch.where(torch.isfinite(pkey), pkey, inf), rank1, grid)
            vid_arranged = dist_apply_perm(
                torch.where(members, ids, n_pad), rank1, grid)
            pkey_arranged = torch.where(vid_arranged < n_pad, pkey_arranged,
                                        inf)
            _, vid2 = dist_sort_auto(pkey_arranged, grid, vid_arranged)
            newlab, hit = dist_route(
                vid2, ids + counter, (vid2 < n_pad) & (ids < nmem),
                torch.zeros_like(ids), grid, combine="set")
            lab_dev = torch.where(hit, newlab, lab_dev)
            counter += nmem
        lab_h = _whole_host(lab_dev, a, n)
        label[:n] = np.where(comp, lab_h, label[:n])
        visited |= comp
    order = np.argsort(label[:n])
    return order[::-1].copy()


def md_order(a: SpCOO) -> torch.Tensor:
    """Minimum-degree ordering (``Applications/Ordering/MD.cpp``): greedy
    elimination with exact fill-in on host adjacency sets, ties by vertex
    id.  Returns the order (int32, on ``a``'s device)."""
    n = a.shape[0]
    row, col, _val, nnz, _shape = a.to_numpy()
    adj = [set() for _ in range(n)]
    for u, v in zip(row[:nnz], col[:nnz]):
        if u != v:
            adj[u].add(int(v))
            adj[v].add(int(u))
    eliminated = np.zeros(n, bool)
    order = []
    for _ in range(n):
        best, best_deg = -1, None
        for v in range(n):
            if not eliminated[v]:
                d = len(adj[v])
                if best_deg is None or d < best_deg:
                    best, best_deg = v, d
        order.append(best)
        eliminated[best] = True
        nbrs = [u for u in adj[best] if not eliminated[u]]
        for u in nbrs:  # clique fill-in among the remaining neighbours
            adj[u].discard(best)
            for w in nbrs:
                if w != u:
                    adj[u].add(w)
    return torch.tensor(order, dtype=torch.int32, device=a.device)


def md_order_dist(a: DistSpMat) -> torch.Tensor:
    """Distributed minimum degree (``MD.cpp:290-346``): per step the
    smallest-degree live vertex is eliminated, its reach set found by a
    distributed BFS through eliminated vertices only (``getReach``, one
    pattern ``dist_spmv`` a hop), and the reach vertices' quotient-graph
    degrees recomputed by one multi-source BFS whose frontier is a dense n
    x k 0/1 matrix pushed through ``dist_spmm`` (``getReachesSPMM``).  A
    host-paced n-step loop.  ``a``: symmetric.  Ties by vertex id: equal
    to :func:`md_order`.  Returns the order (int32, on the grid's device;
    on a pod, the whole order in every process)."""
    n = a.gshape[0]
    g = a.grid
    dev = a.row.device
    live = _live_entries(a)
    n_pad = row_vec_len(a.gshape, g)
    lo, hi = g.vec_range(n_pad)

    def mine(x: np.ndarray) -> np.ndarray:
        """This process's rows of a host array of the n vertices."""
        pad = np.zeros((n_pad,) + x.shape[1:], x.dtype)
        pad[:n] = x
        return pad[lo:hi]

    def neighbor_mask(mask: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(mine(mask)).to(dev, torch.float32)
        y = dist_spmv(a, x, PLUS_TIMES, live=live)
        return _whole_host(y > 0, a, n)

    def spmm_step(x: torch.Tensor) -> torch.Tensor:
        return (dist_spmm(a, x, PLUS_TIMES, live=live) > 0).to(torch.float32)

    # external degree: the rows' stored non-zeros, less their self loops
    # (the diagonal entries each block holds, folded over the blocks)
    mb, nb = block_dims(a.gshape, g)
    lc = g.local_shape()[1]
    r0, c0 = g.origin()
    bid, r, c, _v = live
    loop = ((bid // lc + r0) * mb + r) == ((bid % lc + c0) * nb + c)
    ones = dist_reduce(a, "row", premap=lambda v: (v != 0).to(v.dtype))
    loops = _dim_fold(a, loop.to(torch.float32), "row", PLUS_TIMES, live)
    deg = (_whole_host(ones, a, n).astype(np.int64)
           - _whole_host(loops, a, n).astype(np.int64))

    enodes = np.zeros(n, bool)
    order = []
    for _ in range(n):
        s = int(np.argmin(np.where(enodes, n + 1, deg)))
        order.append(s)
        enodes[s] = True
        # getReach(s): BFS from s through eliminated vertices only
        en_d = torch.from_numpy(mine(enodes)).to(dev)
        f = np.zeros(n, bool)
        f[s] = True
        visited = f.copy()
        reach = np.zeros(n, bool)
        while f.any():
            nb_ = neighbor_mask(f) & ~visited
            if not nb_.any():
                break
            visited |= nb_
            reach |= nb_ & ~enodes
            f = nb_ & enodes
        srcs = np.nonzero(reach)[0]
        if srcs.size == 0:
            continue
        # getReachesSPMM: a k-source BFS on a dense frontier
        k = int(srcs.size)
        k_pad = max(8, 1 << int(np.ceil(np.log2(k))))
        x = np.zeros((n, k_pad), np.float32)
        x[srcs, np.arange(k)] = 1.0
        xd = torch.from_numpy(mine(x)).to(dev)
        vis = xd
        while True:
            y = spmm_step(xd)[:hi - lo]
            y = torch.where(vis > 0, 0.0, y)
            if not exchange.any_proc((y > 0).any(), g):
                break
            vis = torch.maximum(vis, y)
            xd = y * en_d[:, None]
            if not exchange.any_proc((xd > 0).any(), g):
                break
        nen = torch.from_numpy(mine(~enodes)).to(dev, torch.float32)
        cnt = (vis * nen[:, None]).sum(0).cpu().numpy()
        if g.is_pod:     # whole counts: the processes' in rank order
            cnt = exchange.allgather_host(cnt).sum(0, dtype=cnt.dtype)
        deg[srcs] = cnt[:k].astype(np.int64) - 1
    return torch.tensor(order, dtype=torch.int32, device=dev)
