"""The distributed vector layer: sort, RandPerm, routing, gather, Invert and
Uniq (port of ``combblas_tpu/parallel/vector.py``).

Vectors keep the FullyDist layout of :mod:`parallel.dist`: one flat tensor
whose padded length is a multiple of ``grid.nprocs`` (which counts the
layers of a 3D grid), chunk ``c`` being device ``c``'s shard under the JAX
package.  Sparse vectors are (values, bool mask) pairs in that layout.

Every function's result is fully defined by its inputs, whatever the
number of devices, and the port computes it for the whole padded vector at
once on the grid's device:

- the JAX sample sort (local sorts, splitters, a bucket exchange, a
  rebalance) leaves the vector sorted by (key, global index), payloads
  carried: here one stable sort of the whole vector on that key;
- the owner shuffle of :func:`dist_route` delivers the pairs in (source
  device, slot) order, which is the flat order of the input: ``set``
  keeps the last pair a slot receives, ``sum`` folds them in that order
  on the CPU (``index_add_``) and in a fixed order on the card
  (``index_put_(accumulate=True)``, sorted by slot first), ``min`` and
  ``max`` do not depend on the order.

Keys are :func:`_sortable_u32` values carried in int64: floats order as
JAX orders them, -0.0 before +0.0 and NaNs by their bits, which a float
sort would tie or move.  Nothing here reads a value back to the host.

On a grid spread over several processes a vector is this process's slice
(:meth:`ProcGrid.vec_range`) of the padded vector, whose whole length is
the slice's times the processes, and every function gives each process
its slice of the one-process result, element for element:

- the sorts (:func:`dist_sort`, :func:`perm_from_keys`, :func:`dist_uniq`)
  run the sample sort's exchange across the processes: a local sort on
  (key, global index), splitter samples all-gathered, one all-to-all of
  the buckets, a local sort of what arrived, and the rebalance to even
  slices;
- a route sends its pairs to the owners of their indices
  (``exchange.route_to_owners``), which deliver them in (source process,
  source order): the slices are contiguous, so that is the flat order,
  and ``set`` and ``sum`` see the pairs of each slot in one process's
  order; a dropped pair is not sent;
- a gather asks the owners (``exchange.gather_at``);
- :func:`dist_rand_perm` draws the whole vector's keys in every process
  and keeps its slice, so the permutation is one process's.

The exchanges read their counts on the host; in one process nothing here
reads a value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.grid import ProcGrid

__all__ = [
    "dist_sort",
    "dist_sort_auto",
    "dist_rand_perm",
    "perm_from_keys",
    "dist_route",
    "dist_gather",
    "dist_apply_perm",
    "dist_invert",
    "dist_uniq",
]

#: The pad key: past every value's key (ties broken by the global index).
_PAD_KEY = 0xFFFFFFFF
_SIGN = 0x80000000
_COMBINES = ("set", "sum", "min", "max")


def _sortable_u32(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving uint32 key of ``x``, as int64 in [0, 2^32):
    floats (as float32) by their bits, negatives complemented and positives
    with the sign bit set, so -0.0 < +0.0 and a NaN sorts by its bits (a
    positive NaN after +inf, a negative one before -inf); ints as int32
    offset by 2^31; uint32 as they are."""
    if x.is_floating_point():
        b = x.to(torch.float32).view(torch.int32).to(torch.int64) & _PAD_KEY
        return torch.where(b >= _SIGN, _PAD_KEY - b, b | _SIGN)
    if x.dtype == getattr(torch, "uint32", None):
        return x.to(torch.int64)
    return x.to(torch.int32).to(torch.int64) + _SIGN


def _whole(x: torch.Tensor, grid: ProcGrid) -> int:
    """The padded length of the FullyDist vector of which ``x`` is this
    process's slice (in one process ``x``'s own length), checked to be a
    multiple of the grid's devices."""
    n_pad = x.shape[0] * grid.nproc
    if n_pad % grid.nprocs:
        raise ValueError(f"padded length {n_pad} is not a multiple of the "
                         f"grid's {grid.nprocs} devices")
    return n_pad


def _sort_on(key: torch.Tensor, n: int, *tensors: torch.Tensor):
    """``tensors`` in the order of (``key``, global index): ``key`` holds
    uint32 values in int64, the pad key from index ``n`` on (so padding
    sorts to the tail), and ties keep the index order (a stable sort)."""
    if n < key.shape[0]:
        key = key.clone()
        key[n:] = _PAD_KEY
    _, order = torch.sort(key, stable=True)
    return tuple(t[order] for t in tensors)


#: Splitter samples each process contributes to the pod's sample sort.
_POD_SAMPLES = 32


def _pod_sort(key: torch.Tensor, grid: ProcGrid, tensors, n: int):
    """The sample sort across the processes of a pod (``par::sampleSort``):
    ``key`` (uint32 values in int64, the pad key from global index ``n``
    on) and ``tensors`` are this process's slices.  Elements order by
    (key, global index), packed into one int64 (the key's 32 bits over the
    index's 31), so every comparison of the exchange is one of unique
    integers."""
    P, chunk = grid.nproc, key.shape[0]
    lo = grid.vec_range(chunk * P)[0]
    dev = key.device
    gidx = torch.arange(lo, lo + chunk, dtype=torch.int64, device=dev)
    key = torch.where(gidx < n, key, _PAD_KEY)
    comb, order = torch.sort((key << 31) | gidx)
    carried = [t[order] for t in tensors]
    # splitters: evenly spaced samples of every process, all-gathered
    s = min(_POD_SAMPLES, chunk)
    samples = comb[(torch.arange(s, device=dev) * chunk) // s]
    every = np.sort(exchange.allgather_host(samples.cpu().numpy()),
                    axis=None)
    spl = torch.from_numpy(every[(np.arange(1, P) * (P * s)) // P]).to(dev)
    dest = torch.searchsorted(spl, comb, right=True)
    got = exchange.alltoallv([comb, *carried],
                             torch.bincount(dest, minlength=P).tolist())
    order = torch.argsort(got[0])
    merged = [t[order] for t in got]
    # rebalance: this process's run is global [pref, pref + mine)
    mine = merged[0].shape[0]
    runs = exchange.allgather_host(np.asarray([mine], np.int64))[:, 0]
    pref = int(runs[:grid.rank].sum())
    bounds = np.clip(np.arange(P + 1) * chunk - pref, 0, mine)
    out = exchange.alltoallv(merged[1:], np.diff(bounds).tolist())
    return tuple(out)


def _sort_by_key(key: torch.Tensor, n: int, grid: ProcGrid, *tensors):
    """``tensors`` (this process's slices) in the order of (``key``,
    global index), the pad key from index ``n`` on: one stable sort in one
    process, the sample sort across a pod's processes."""
    if grid.is_pod:
        return _pod_sort(key, grid, tensors, n)
    return _sort_on(key, n, *tensors)


def dist_sort(x: torch.Tensor, grid: ProcGrid, *payloads: torch.Tensor,
              length: int | None = None, descending: bool = False):
    """The vector ``x`` (padded FullyDist layout, true prefix ``length``,
    default the padded length) sorted by (key, global index), in the same
    layout, with ``payloads`` carried: JAX's sample sort
    (``par::sampleSort``), whose result one stable sort of the whole vector
    gives element for element.  Padding sorts to the tail.  Returns
    ``sorted_x`` alone, or ``(sorted_x, *sorted_payloads)``.  On a pod
    ``x`` and the payloads are this process's slices, and so is the
    result."""
    n_pad = _whole(x, grid)
    n = n_pad if length is None else int(length)
    key = _sortable_u32(x)
    if descending:
        key = _PAD_KEY - key
    out = _sort_by_key(key, n, grid, x, *payloads)
    return out if len(out) > 1 else out[0]


def dist_sort_auto(x: torch.Tensor, grid: ProcGrid, *payloads: torch.Tensor,
                   length: int | None = None, descending: bool = False,
                   oversample: int = 32):
    """JAX's scale-safe sample sort, which sizes its exchange buffers from
    a planning pass: its result is :func:`dist_sort`'s, and so is the
    port's (``oversample``, JAX's splitter samples per device, has nothing
    to choose here: the pod's exchange is sized by the buckets' real
    counts)."""
    del oversample
    return dist_sort(x, grid, *payloads, length=length,
                     descending=descending)


def _gidx(x: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """The global indices (int32) of the slots of ``x``, this process's
    slice of a FullyDist vector."""
    lo = grid.vec_range(_whole(x, grid))[0]
    return torch.arange(lo, lo + x.shape[0], dtype=torch.int32,
                        device=x.device)


def perm_from_keys(keys: torch.Tensor, n: int,
                   grid: ProcGrid) -> torch.Tensor:
    """The permutation of [0, n) that sorting the random uint32 ``keys``
    (padded length; values in [0, 2^32), int64) carries the identity
    into, the padding slots holding ``n``: ``FullyDistVec::RandPerm``
    given its keys (int32).  On a pod ``keys`` and the result are this
    process's slices."""
    iota = _gidx(keys, grid)
    perm, = _sort_by_key(keys.to(torch.int64), n, grid, iota)
    return torch.where(iota < n, perm, n)


def dist_rand_perm(generator: torch.Generator, n: int,
                   grid: ProcGrid) -> torch.Tensor:
    """A random permutation of [0, n) in the FullyDist layout (padded
    length a multiple of ``grid.nprocs``, padding slots ``n``), on the
    grid's device: uint32 keys drawn from ``generator`` (on its own
    device, so that one CPU generator gives the card and the CPU the same
    permutation; JAX draws threefry keys, which cannot be carried
    across), then :func:`perm_from_keys`.  On a pod every process draws
    the whole vector's keys and keeps its slice, so that a generator of
    one seed gives every process its slice of one process's
    permutation."""
    p = grid.nprocs
    n_pad = -(-n // p) * p
    keys = torch.randint(0, 1 << 32, (n_pad,), generator=generator,
                         dtype=torch.int64, device=generator.device)
    lo, hi = grid.vec_range(n_pad)
    return perm_from_keys(keys[lo:hi].to(grid.device), n, grid)


def _targets(idx: torch.Tensor, mask: torch.Tensor,
             n_pad: int) -> torch.Tensor:
    """Each pair's output slot: its index where ``mask`` holds and the
    index lies in [0, n_pad); a dropped pair gets a slot of its own past
    the vector (``n_pad`` + its position), so that no one slot gathers
    them all."""
    pos = idx.to(torch.int32).to(torch.int64)
    ok = mask.to(torch.bool) & (pos >= 0) & (pos < n_pad)
    spare = n_pad + torch.arange(pos.shape[0], device=pos.device)
    return torch.where(ok, pos, spare)


def dist_route(idx: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
               init: torch.Tensor, grid: ProcGrid, *, combine: str = "set"):
    """Deliver the (idx, val) pairs where ``mask`` holds to the owner of
    each index (the SparseCommon alltoallv): ``init`` (its padded length
    is the index space) updated at every slot a pair hits.  ``combine``:
    ``set`` (the last pair in (device, slot) order, i.e. in flat order,
    wins), ``sum``, ``min`` or ``max``.  Returns ``(out, out_mask)``,
    the mask marking the slots hit.  On a pod the arguments and results
    are this process's slices; a pair goes to the process that holds its
    slot, and a dropped pair (masked out, or its index outside the whole
    vector) is not sent."""
    if combine not in _COMBINES:
        raise ValueError(f"combine must be one of {_COMBINES}, got "
                         f"{combine!r}")
    n_pad = init.shape[0]
    whole = _whole(init, grid)
    _whole(idx, grid)
    val = val.to(init.dtype)
    if grid.is_pod:
        pos = idx.to(torch.int32).to(torch.int64)
        keep = torch.nonzero(mask.to(torch.bool) & (pos >= 0)
                             & (pos < whole)).squeeze(1)
        idx, val = exchange.route_to_owners(pos[keep], [val[keep]], grid,
                                            whole)
        mask = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    tgt = _targets(idx, mask, n_pad)
    k = tgt.shape[0]
    dev = init.device
    hit = torch.zeros(n_pad + k, dtype=torch.bool, device=dev)
    hit[tgt] = True
    hit = hit[:n_pad]
    if combine == "set":
        win = torch.full((n_pad + k,), -1, dtype=torch.int64, device=dev)
        win.scatter_reduce_(0, tgt, torch.arange(k, device=dev), "amax")
        win = win[:n_pad]
        pick = torch.cat([val, init[:1]])     # a pod slice may get no pair
        out = torch.where(hit, pick[win.clamp(min=0)], init)
        return out, hit
    buf = torch.cat([init, torch.zeros(k, dtype=init.dtype, device=dev)])
    if combine == "sum":
        if buf.is_floating_point() and buf.is_cuda:
            buf.index_put_((tgt,), val, accumulate=True)
        else:
            buf.index_add_(0, tgt, val)
    else:
        buf.scatter_reduce_(0, tgt, val, "amin" if combine == "min"
                            else "amax")
    return buf[:n_pad], hit


def dist_gather(x: torch.Tensor, idx: torch.Tensor,
                grid: ProcGrid) -> torch.Tensor:
    """out[i] = x[idx[i]] (``FullyDistVec::operator()``); an index outside
    [0, len(x)) gives 0.  The JAX package's two owner exchanges (requests
    out, answers back) deliver exactly this; on a pod ``x``, ``idx`` and
    the result are this process's slices, ``len(x)`` the whole length,
    and each element comes from its owner."""
    whole = _whole(x, grid)
    _whole(idx, grid)
    i = idx.to(torch.int64)
    ok = (i >= 0) & (i < whole)
    got = exchange.gather_at(x, i.clamp(0, whole - 1), grid)
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def dist_apply_perm(x: torch.Tensor, perm: torch.Tensor,
                    grid: ProcGrid) -> torch.Tensor:
    """y[perm[i]] = x[i]; padding slots (perm == len) are dropped."""
    out, _ = dist_route(perm, x, perm < _whole(x, grid), torch.zeros_like(x),
                        grid, combine="set")
    return out


def dist_invert(val: torch.Tensor, mask: torch.Tensor, grid: ProcGrid):
    """Sparse-vector Invert (``FullyDistSpVec.h:89``): out[val[i]] = i for
    the live entries, a duplicate value keeping the largest index.
    Returns ``(out, out_mask)``, out int32 of ``val``'s padded length, -1
    where no entry landed."""
    init = torch.full((val.shape[0],), -1, dtype=torch.int32,
                      device=val.device)
    return dist_route(val.to(torch.int32), _gidx(val, grid), mask, init,
                      grid, combine="max")


def dist_uniq(val: torch.Tensor, mask: torch.Tensor, grid: ProcGrid):
    """Uniq (``FullyDistSpVec.cpp:1029``): of the live entries with one
    value (one ``_sortable_u32`` key: -0.0 and +0.0 differ) only the one of
    the smallest index stays, at its index.  A sort by (key, index), run
    heads kept, the survivors routed home.  Returns ``(out, out_mask)``.
    A dead slot takes the pad key (and index 0x7FFFFFFF), which a live
    NaN of bits 0x7FFFFFFF shares: that run's head is its first slot, live
    or dead.  On a pod the sort runs across the processes, and a slice's
    first element compares with the previous slice's last."""
    n_pad = _whole(val, grid)
    live = mask.to(torch.bool)
    key = torch.where(live, _sortable_u32(val), _PAD_KEY)
    gidx = torch.where(live, _gidx(val, grid), 0x7FFFFFFF)
    ks, is_, vs, ms = _sort_by_key(key, n_pad, grid, key, gidx, val, live)
    first = torch.ones(ks.shape[0], dtype=torch.bool, device=val.device)
    first[1:] = ks[1:] != ks[:-1]
    if grid.is_pod:
        lo = grid.vec_range(n_pad)[0]
        prev, = exchange.gather_range([ks], grid, max(lo - 1, 0), lo)
        if prev.numel():
            first[0] = prev[0] != ks[0]
    return dist_route(is_, vs, first & ms, torch.zeros_like(val), grid,
                      combine="set")
