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
of an SpMV), all-to-all of variable-length buckets (the sample sort, the
tuple routing of a parallel read) and all-gather of variable-length arrays.
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

__all__ = ["rank", "size", "barrier", "allgather_host", "pull",
           "gather_blocks", "gather_range", "reduce_to_owners", "alltoallv",
           "allgather_var", "gather_table", "ring_slot", "close"]

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


def _overlaps(lo: int, hi: int, spans):
    """(q, a, b): the part [a, b) of [lo, hi) within each span q."""
    for q, (s, e) in enumerate(spans):
        a, b = max(lo, s), min(hi, e)
        if a < b:
            yield q, a, b


def gather_range(vecs, grid: ProcGrid, lo: int, hi: int) -> list:
    """[lo, hi) of each FullyDist vector of ``vecs`` (this process's slices,
    of one padded length), from the processes that hold it."""
    length = vecs[0].shape[0] * grid.nproc
    spans = [grid.vec_range(length, q) for q in range(grid.nproc)]
    wants, K = [], len(vecs)
    for q, a, b in _overlaps(lo, hi, spans):
        for k in range(K):
            wants.append((q, k, a - spans[q][0], b - spans[q][0]))
    got = pull(vecs, wants)
    return [torch.cat(got[k::K]) for k in range(K)]


def reduce_to_owners(parts, spans, length: int, grid: ProcGrid,
                     kinds) -> list:
    """The fan-in of partial vectors: process q's ``parts`` cover
    ``spans[q]`` = [lo, hi) of a FullyDist vector of padded ``length``;
    every process gets its slice of each vector reduced over the processes
    whose span meets it, in rank order, with ``kinds[k]`` (the semiring
    add, 'sum' / 'min' / 'max'; slots no span covers hold its
    identity)."""
    mylo, myhi = grid.vec_range(length)
    wants, place, K = [], [], len(parts)
    for q, a, b in _overlaps(mylo, myhi, spans):
        for k in range(K):
            wants.append((q, k, a - spans[q][0], b - spans[q][0]))
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


def alltoallv(arrays, counts) -> list:
    """All-to-all of variable-length buckets: each of the 1-D ``arrays``
    holds this process's buckets back to back by destination, bucket d of
    ``counts[d]`` elements (one count vector for all arrays).  Returns per
    array the buckets sent to this process, in source order."""
    n, me = size(), rank()
    table = allgather_host(np.asarray(counts, np.int64))   # [src, dst]
    starts = np.cumsum(table, axis=1) - table
    wants, K = [], len(arrays)
    for q in range(n):
        for k in range(K):
            a = int(starts[q, me])
            wants.append((q, k, a, a + int(table[q, me])))
    got = pull(arrays, wants)
    return [torch.cat(got[k::K]) for k in range(K)]


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


def gather_table(local: torch.Tensor, grid: ProcGrid) -> torch.Tensor:
    """The (pr, pc) table of a per-block quantity (nnz, flops) from every
    process's (lr, lc) part, on ``local``'s device; in one process
    ``local`` itself."""
    if not grid.is_pod:
        return local
    lr, lc = grid.local_shape()
    parts = allgather_host(local.reshape(lr, lc).cpu().numpy())
    out = np.empty((grid.pr, grid.pc), parts.dtype)
    for q in range(grid.nproc):
        r, c = grid.origin(q)
        out[r:r + lr, c:c + lc] = parts[q]
    return torch.from_numpy(out).to(local.device)
