"""Exchanges between the processes of a pod: the port's counterparts of the
JAX package's mesh collectives (``all_gather``, ``psum_scatter``,
``all_to_all``, ``ppermute``) and of ``multihost_utils``, for the block
grids of :mod:`parallel.grid` whose blocks live in several processes.

Every function here is collective: each process of the group calls it, in
the same order, with arguments of the same structure.  One primitive moves
the data, :func:`pull`: every process publishes a few 1-D tensors and takes
element ranges of its peers' published tensors.  It has two routes:

- CPU tensors go through the ``gloo`` group: the requests are all-gathered
  and every process sends what its peers asked for in one
  ``all_to_all_single``.  The CPU tests run this route.
- CUDA tensors go through CUDA IPC.  Each process owns one device buffer
  per purpose (an *arena*, ``csrc/ipc.cu``), exported once; its peers map
  it once and keep the mapping for the life of the group (opening a handle
  costs milliseconds).  An arena grows, by powers of two, only when a call
  needs more than every process has: all of them then free, reallocate and
  map anew together.  A pull copies each process's tensors into its own
  arena, synchronises its stream and meets the others at a ``gloo``
  barrier; then each copies its ranges straight out of the peers' mapped
  arenas, synchronises and meets them again, after which an arena may be
  written anew.  No kernel ever waits for a peer's write: without MPS, the
  kernels of two processes time-slice the card, and a spinning kernel
  would stall its peer.

The host side (counts, capacities, handles) travels in small
:func:`allgather_host` calls, and :func:`barrier` is the group's.  On top
of :func:`pull` sit what the distributed modules use: block stacks gathered
by position (the SUMMA panels, the Cannon skew), ranges of a FullyDist
vector, the semiring reduce of partial vectors onto their owners (the fan-in
of an SpMV or a column fold), all-to-all of variable-length buckets (the
sample sort, the tuple routing of a parallel read, a column k-select's
candidates, FastSV's hooks) and the element requests built on it, and
all-gather of variable-length arrays.
K9's hop across processes (:mod:`ops.kernels.ring`) writes into a peer's
arena (:func:`ring_slot`) with its own kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.semiring import _add_identity

__all__ = ["rank", "size", "barrier", "allgather_host", "any_proc",
           "max_proc", "pull", "gather_blocks", "gather_live", "gather_range",
           "reduce_to_owners", "alltoallv", "route_to_owners", "gather_at",
           "allgather_var", "gather_whole", "gather_table", "ring_slot",
           "close"]

#: Byte alignment of every tensor published in an arena.
_ALIGN = 256
#: The smallest arena, bytes.
_MIN_ARENA = 2 << 20


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """The group's barrier (JAX's ``sync_global_devices``)."""
    dist.barrier()


def allgather_host(values) -> np.ndarray:
    """Every process's ``values`` (a small host array, one shape and dtype
    in every process) stacked: (size, *shape), in rank order."""
    t = torch.from_numpy(np.array(values))     # a writable copy
    out = [torch.empty_like(t) for _ in range(size())]
    dist.all_gather(out, t)
    return np.stack([o.numpy() for o in out])


def any_proc(flag, grid: ProcGrid) -> bool:
    """Whether ``flag`` (a bool, or a 0-d bool tensor) holds in any process
    of the grid: the loop stops and branches that every process must take
    alike.  In one process ``bool(flag)``."""
    if not grid.is_pod:
        return bool(flag)
    return bool(allgather_host(np.asarray([bool(flag)])).any())


def max_proc(x: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """The largest of every process's 0-d ``x`` (exact: no arithmetic), a
    0-d tensor on ``x``'s device; in one process ``x`` itself."""
    if not grid.is_pod:
        return x
    got = allgather_host(x.reshape(1).cpu().numpy())
    return torch.from_numpy(got.max(axis=0)).reshape(()).to(x.device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _aligned(nbytes) -> np.ndarray:
    """Start offsets of tensors of ``nbytes`` packed with :data:`_ALIGN`
    alignment, and the total, as int64 (len + 1)."""
    sizes = -(-np.asarray(nbytes, np.int64) // _ALIGN) * _ALIGN
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def pull(tensors, wants) -> list:
    """Publish the 1-D ``tensors`` (every process the same count, dtypes and
    device type; lengths may differ) and fetch ``wants``: (peer, k, start,
    stop) element ranges of peer's tensor k, one tensor each, on the
    tensors' device.  A range of this process's own tensor is a copy of
    it."""
    tensors = [t.reshape(-1) for t in tensors]
    dev = tensors[0].device
    if dev.type == "cuda":
        return _pull_ipc(tensors, wants)
    if dev.type != "cpu":
        raise ValueError(f"no exchange for device {dev}")
    return _pull_gloo(tensors, wants)


def _pull_gloo(tensors, wants) -> list:
    n, me = size(), rank()
    asked = [None] * n
    dist.all_gather_object(asked, [tuple(int(v) for v in w) for w in wants])
    send, send_sizes = [], []
    for q in range(n):
        parts = [_bytes(tensors[k][a:b]) for p, k, a, b in asked[q]
                 if p == me]
        send += parts
        send_sizes.append(sum(int(x.numel()) for x in parts))
    recv_sizes = [0] * n
    for p, k, a, b in wants:
        recv_sizes[p] += (b - a) * tensors[k].element_size()
    out = torch.empty(sum(recv_sizes), dtype=torch.uint8)
    inp = torch.cat(send) if send else torch.empty(0, dtype=torch.uint8)
    dist.all_to_all_single(out, inp, recv_sizes, send_sizes)
    cursor = np.concatenate([[0], np.cumsum(recv_sizes)])[:-1]
    got = []
    for p, k, a, b in wants:
        nb = (b - a) * tensors[k].element_size()
        raw = out[cursor[p]:cursor[p] + nb].clone()
        cursor[p] += nb
        got.append(raw.view(tensors[k].dtype))
    return got


# ------------------------------------------------------------- CUDA IPC --

class _CudaMemory:
    """A device buffer this process allocated, seen through
    ``__cuda_array_interface__`` so that ``torch.as_tensor`` views it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


@dataclasses.dataclass
class _Arena:
    """One purpose's IPC buffer: this process's ``own`` (a uint8 tensor
    over ``ptr``) and every process's pointer as mapped here (``peers``,
    this process's own at its rank)."""

    ptr: int
    nbytes: int
    own: torch.Tensor
    peers: list
    device: int


#: name -> _Arena, for the life of the group (:func:`close` frees them).
_ARENAS: dict = {}
#: Which of the two ring slots the next hop writes.
_RING = {"next": 0}


def _lib():
    from combblas_tpu_torch.ops.kernels import _build
    return _build.library()


def _check(err: int, what: str) -> None:
    from combblas_tpu_torch.ops.kernels import _build
    _build.check(_lib(), err, what)


def _release(a: _Arena) -> None:
    lib, me = _lib(), rank()
    for q, p in enumerate(a.peers):
        if q != me:
            _check(lib.cbt_ipc_close(a.device, p), "cudaIpcCloseMemHandle")
    _check(lib.cbt_ipc_free(a.device, a.ptr), "cudaFree")


def _arena(name: str, need: int, dev: torch.device) -> _Arena:
    """The arena ``name`` of at least ``need`` bytes (``need`` must be the
    same in every process: the growth is collective)."""
    a = _ARENAS.get(name)
    if a is not None and a.nbytes >= need:
        return a
    nbytes = max(_MIN_ARENA, 1 << max(int(need) - 1, 1).bit_length())
    lib, n, me = _lib(), size(), rank()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    torch.cuda.synchronize(dev)
    barrier()     # no peer reads the old arenas any more
    if a is not None:
        _release(a)
        del _ARENAS[name]
    hbytes = lib.cbt_ipc_handle_bytes()
    handle = (ctypes.c_uint8 * hbytes)()
    ptr = ctypes.c_void_p()
    _check(lib.cbt_ipc_alloc(idx, nbytes, ctypes.addressof(ptr),
                             ctypes.addressof(handle)), "cudaMalloc (IPC)")
    handles = allgather_host(np.frombuffer(bytes(handle), np.uint8))
    peers = []
    for q in range(n):
        if q == me:
            peers.append(ptr.value)
            continue
        h = (ctypes.c_uint8 * hbytes).from_buffer_copy(handles[q].tobytes())
        got = ctypes.c_void_p()
        _check(lib.cbt_ipc_open(idx, ctypes.addressof(h),
                                ctypes.addressof(got)),
               "cudaIpcOpenMemHandle")
        peers.append(got.value)
    own = torch.as_tensor(_CudaMemory(ptr.value, nbytes), device=dev)
    a = _Arena(ptr=ptr.value, nbytes=nbytes, own=own, peers=peers,
               device=idx)
    _ARENAS[name] = a
    return a


def _pull_ipc(tensors, wants) -> list:
    dev = tensors[0].device
    me = rank()
    nbytes = [t.numel() * t.element_size() for t in tensors]
    offs = _aligned(nbytes)
    table = allgather_host(offs)          # every process's offsets
    arena = _arena("pull", int(table[:, -1].max()), dev)
    for t, o, nb in zip(tensors, offs, nbytes):
        if nb:
            arena.own[o:o + nb].copy_(_bytes(t))
    stream = torch.cuda.current_stream(dev)
    stream.synchronize()
    barrier()                             # every arena holds its tensors
    lib = _lib()
    got = []
    for p, k, a, b in wants:
        t = tensors[k]
        out = torch.empty(b - a, dtype=t.dtype, device=dev)
        if p == me:
            out.copy_(t[a:b])
        elif b > a:
            es = t.element_size()
            _check(lib.cbt_copy(out.data_ptr(),
                                arena.peers[p] + int(table[p, k]) + a * es,
                                (b - a) * es, stream.cuda_stream),
                   "cudaMemcpyAsync (IPC)")
        got.append(out)
    stream.synchronize()
    barrier()                             # no one reads the arenas now
    return got


def ring_slot(nbytes: int, dev: torch.device) -> _Arena:
    """The arena the next ring hop pushes into: two slots taken in turn, so
    that a hop's result stays valid while the next hop fills the other
    slot (a result lives until the hop after next).  ``nbytes`` is agreed
    on by all processes here."""
    need = int(allgather_host(np.asarray([nbytes], np.int64)).max())
    k = _RING["next"]
    _RING["next"] = 1 - k
    return _arena(f"ring{k}", need, dev)


def close() -> None:
    """Free this process's arenas and unmap its peers' (collective: after
    it no process reads another's buffers)."""
    if not _ARENAS:
        return
    for a in _ARENAS.values():
        torch.cuda.synchronize(a.device)
    barrier()
    for a in _ARENAS.values():
        _release(a)
    _ARENAS.clear()


# ------------------------------------------------------ grid exchanges --

def gather_blocks(stacks, grid: ProcGrid, positions) -> list:
    """Blocks of the (lr, lc, ...) local stacks at the global grid
    ``positions`` [(i, j), ...], each from its owner: per stack a
    (len(positions), ...) tensor, in the order of ``positions``.  When
    every process owns every position it asks for (always in one
    process, where no group is needed), no data moves."""
    lr, lc = grid.local_shape()
    r0, c0 = grid.origin()
    mine = [(i - r0) * lc + (j - c0) for i, j in positions]
    flat = [s.reshape(lr * lc, -1) for s in stacks]
    local = all(grid.owner(i, j) == grid.rank for i, j in positions)
    if not grid.is_pod or allgather_host(
            np.asarray([int(local)], np.int64)).min():
        idx = torch.as_tensor(mine, dtype=torch.int64,
                              device=stacks[0].device)
        return [f[idx].reshape(len(positions), *s.shape[2:])
                for f, s in zip(flat, stacks)]
    wants = []
    for i, j in positions:
        q = grid.owner(i, j)
        rq, cq = grid.origin(q)
        blk = (i - rq) * lc + (j - cq)
        for k, f in enumerate(flat):
            e = f.shape[1]
            wants.append((q, k, blk * e, (blk + 1) * e))
    got = pull([f.reshape(-1) for f in flat], wants)
    K = len(stacks)
    return [torch.stack(got[k::K]).reshape(len(positions), *s.shape[2:])
            for k, s in enumerate(stacks)]


def gather_live(stacks, grid: ProcGrid, positions, live,
                fills, capacity: int) -> list:
    """The blocks of the (lr, lc, cap) local stacks at the global grid
    ``positions``, each from its owner, moving only each block's live
    prefix: ``live`` is the (pr, pc) host table of live counts (``min(nnz,
    cap)``, the same in every process).  Per stack a (len(positions),
    ``capacity``) tensor: each block's live prefix, then the stack's pad
    value ``fills[k]``.  ``capacity`` must hold every requested block's
    live count; a block whose pads are the canonical ones comes back
    slot for slot."""
    lr, lc = grid.local_shape()
    r0, c0 = grid.origin()
    live = np.asarray(live, np.int64)
    mine = [(i, j, int(live[r0 + i, c0 + j])) for i in range(lr)
            for j in range(lc)]
    pub = [torch.cat([s[i, j, :k] for i, j, k in mine]) for s in stacks]
    wants, K = [], len(stacks)
    for i, j in positions:
        q = grid.owner(i, j)
        rq, cq = grid.origin(q)
        counts = live[rq:rq + lr, cq:cq + lc].reshape(-1)
        b = (i - rq) * lc + (j - cq)
        off = int(counts[:b].sum())
        for k in range(K):
            wants.append((q, k, off, off + int(counts[b])))
    got = pull(pub, wants)
    out = []
    for k, (s, fill) in enumerate(zip(stacks, fills)):
        o = torch.full((len(positions), capacity), fill, dtype=s.dtype,
                       device=s.device)
        for p in range(len(positions)):
            x = got[p * K + k]
            o[p, :x.shape[0]] = x
        out.append(o)
    return out


def _overlaps(lo: int, hi: int, spans):
    """(q, a, b): the part [a, b) of [lo, hi) within each span q."""
    for q, (s, e) in enumerate(spans):
        a, b = max(lo, s), min(hi, e)
        if a < b:
            yield q, a, b


def gather_range(vecs, grid: ProcGrid, lo: int, hi: int) -> list:
    """[lo, hi) of each FullyDist vector of ``vecs`` (this process's slices,
    of one padded length), from the processes that hold it; in one process
    the slices ``v[lo:hi]``."""
    if not grid.is_pod:
        return [v[lo:hi] for v in vecs]
    length = vecs[0].shape[0] * grid.nproc
    spans = [grid.vec_range(length, q) for q in range(grid.nproc)]
    wants, K = [], len(vecs)
    for q, a, b in _overlaps(lo, hi, spans):
        for k in range(K):
            wants.append((q, k, a - spans[q][0], b - spans[q][0]))
    got = pull(vecs, wants)
    return [torch.cat(got[k::K]) if got else v[:0]
            for k, v in enumerate(vecs)]


def reduce_to_owners(parts, spans, length: int, grid: ProcGrid,
                     kinds) -> list:
    """The fan-in of partial vectors: process q's ``parts`` cover
    ``spans[q]`` = [lo, hi) of a FullyDist vector of padded ``length``;
    every process gets its slice of each vector reduced over the processes
    whose span meets it, in rank order, with ``kinds[k]`` (the semiring
    add, 'sum' / 'min' / 'max'; slots no span covers hold its identity).
    A part may be an (R, hi - lo) stack of R partials over the span (every
    process the same R): all of them then meet in the one reduction, in
    (rank, row) order, as a one-process fold over a mesh axis adds its
    blocks in one pass."""
    mylo, myhi = grid.vec_range(length)
    parts = [p.reshape(-1, p.shape[-1]) for p in parts]
    R, K = parts[0].shape[0], len(parts)
    wants, place = [], []
    for q, a, b in _overlaps(mylo, myhi, spans):
        w, s = spans[q][1] - spans[q][0], spans[q][0]
        for r in range(R):
            for k in range(K):
                wants.append((q, k, r * w + a - s, r * w + b - s))
            place.append((a - mylo, b - mylo))
    got = pull(parts, wants)
    out = []
    for k, (p, kind) in enumerate(zip(parts, kinds)):
        rows = _add_identity(kind, p.dtype).to(p.device).expand(
            max(len(place), 1), myhi - mylo).clone()
        for r, (a, b) in enumerate(place):
            rows[r, a:b] = got[r * K + k]
        if kind == "sum":
            out.append(rows.sum(0, dtype=p.dtype))
        elif kind == "min":
            out.append(rows.amin(0))
        else:
            out.append(rows.amax(0))
    return out


def _alltoallv(arrays, table: np.ndarray) -> list:
    """:func:`alltoallv` given the whole [src, dst] count table."""
    n, me = size(), rank()
    starts = np.cumsum(table, axis=1) - table
    wants, K = [], len(arrays)
    for q in range(n):
        for k in range(K):
            a = int(starts[q, me])
            wants.append((q, k, a, a + int(table[q, me])))
    got = pull(arrays, wants)
    return [torch.cat(got[k::K]) for k in range(K)]


def alltoallv(arrays, counts) -> list:
    """All-to-all of variable-length buckets: each of the 1-D ``arrays``
    holds this process's buckets back to back by destination, bucket d of
    ``counts[d]`` elements (one count vector for all arrays).  Returns per
    array the buckets sent to this process, in source order."""
    return _alltoallv(arrays, allgather_host(np.asarray(counts, np.int64)))


def _by_owner(idx: torch.Tensor, grid: ProcGrid, length: int):
    """The stable order of global indices ``idx`` of a FullyDist vector of
    padded ``length`` by the process that holds each, and the host count
    of each process's."""
    owner = idx // (length // grid.nproc)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=grid.nproc).cpu().numpy()
    return order, counts


def route_to_owners(idx: torch.Tensor, vals, grid: ProcGrid,
                    length: int) -> list:
    """Each (global index, values) pair to the process whose slice of a
    FullyDist vector of padded ``length`` holds the index (``idx`` int64,
    ``vals`` 1-D tensors beside it): the pairs this process received, in
    source order and, from each source, in its order; the indices made
    local to this process's slice.  In one process the pairs as given."""
    if not grid.is_pod:
        return [idx, *vals]
    order, counts = _by_owner(idx, grid, length)
    got = alltoallv([idx[order]] + [v[order] for v in vals], counts)
    return [got[0] - grid.vec_range(length)[0]] + got[1:]


def gather_at(vec: torch.Tensor, idx: torch.Tensor,
              grid: ProcGrid) -> torch.Tensor:
    """``x[idx]`` for the FullyDist vector x of which ``vec`` is this
    process's slice, at any global indices ``idx`` (int64), each element
    from the process that holds it: the requests go to the owners, the
    values come back (two all-to-alls, one count table).  In one process
    ``vec[idx]``."""
    if not grid.is_pod:
        return vec[idx]
    length = vec.shape[0] * grid.nproc
    order, counts = _by_owner(idx, grid, length)
    table = allgather_host(np.asarray(counts, np.int64))    # [src, dst]
    asked, = _alltoallv([idx[order]], table)
    ans, = _alltoallv([vec[asked - grid.vec_range(length)[0]]],
                      np.ascontiguousarray(table.T))
    out = torch.empty(idx.shape[0], dtype=vec.dtype, device=vec.device)
    out[order] = ans
    return out


def allgather_var(arrays) -> list:
    """Every process's 1-D ``arrays`` (lengths may differ) concatenated in
    rank order."""
    n = size()
    lens = allgather_host(np.asarray([a.shape[0] for a in arrays], np.int64))
    wants, K = [], len(arrays)
    for q in range(n):
        for k in range(K):
            wants.append((q, k, 0, int(lens[q, k])))
    got = pull(arrays, wants)
    return [torch.cat(got[k::K]) for k in range(K)]


def gather_whole(vec: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """The whole FullyDist vector of which ``vec`` is this process's slice,
    in every process (the slices all-gathered in rank order); in one
    process ``vec`` itself.  For the maps a caller holds whole by
    contract, never to run a one-process body on a whole vector."""
    if not grid.is_pod:
        return vec
    return allgather_var([vec])[0]


def gather_table(local: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """The (pr, pc, ...) table of a per-block quantity (nnz, flops, slab
    counts) from every process's (lr, lc, ...) part, on ``local``'s device;
    in one process ``local`` itself."""
    if not grid.is_pod:
        return local
    lr, lc = grid.local_shape()
    rest = tuple(local.shape[2:])
    parts = allgather_host(local.reshape((lr, lc) + rest).cpu().numpy())
    out = np.empty((grid.pr, grid.pc) + rest, parts.dtype)
    for q in range(grid.nproc):
        r, c = grid.origin(q)
        out[r:r + lr, c:c + lc] = parts[q]
    return torch.from_numpy(out).to(local.device)
