"""One-hop ring push of block stacks: the CUDA kernel ``csrc/ring.cu`` and
its plain version.

Counterpart of ``combblas_tpu/parallel/rma.py:_ring_shift_kernel`` (K9):
on a (pr, pc) grid the block at index d along the axis receives the block
of index (d-1) mod size, ``dst[i, (j+1) % pc] = src[i, j]`` along 'c' and
``dst[(i+1) % pr, j] = src[i, j]`` along 'r'.  Every stack keeps the grid
axes first, (pr, pc, *payload), and lies on one device; ``dst`` is a fresh
stack, like the JAX kernel's receive slot.  One call shifts several stacks
(an operand's row ids, column ids, values and nnz, or both operands) with
one kernel launch.

Across processes (``grid`` a pod, :mod:`parallel.grid`) every stack is this
process's (lr, lc, *payload) share, and a ring that leaves it continues in
the next process of the axis: the kernel pushes those blocks straight into
that process's receive slot (:func:`parallel.exchange.ring_slot`, mapped by
CUDA IPC), the TPU kernel's remote copy, and the rest into this process's
own slot.  :func:`ring_shift` copies the result out of the slot;
:func:`ring_hop`, the ring SUMMA's hop, hands out views of it, valid until
the hop after next.  Its plain version is the same hop through ``gloo`` on
host copies.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["ring_shift", "ring_hop", "ring_shift_plain",
           "ring_shift_pod_plain", "MAX_ARRAYS"]

#: Stacks one launch can move (``kMaxArrays`` in ``csrc/ring.cu``).
MAX_ARRAYS = 8
AXES = ("r", "c")


def ring_shift_plain(src: torch.Tensor, axis: str) -> torch.Tensor:
    """The push as a Python loop over the blocks along the ring."""
    pr, pc = src.shape[:2]
    dst = torch.empty_like(src)
    for i in range(pr):
        for j in range(pc):
            if axis == "c":
                dst[i, (j + 1) % pc] = src[i, j]
            else:
                dst[(i + 1) % pr, j] = src[i, j]
    return dst


def _geometry(src: torch.Tensor, axis: str):
    """(words per block, outer, ring, inner) of a (pr, pc, ...) stack."""
    pr, pc = src.shape[:2]
    nbytes = math.prod(src.shape[2:]) * src.element_size()
    if nbytes % 4:
        raise ValueError(f"a block of {nbytes} bytes is not whole 4-byte "
                         "words")
    if axis == "c":
        return nbytes // 4, pr, pc, 1
    return nbytes // 4, 1, pr, pc


def _pod_geometry(grid, src: torch.Tensor, axis: str):
    """(words per block, outer, ring, inner, next, prev) of this process's
    (lr, lc, ...) share of a stack on a pod ``grid``: ``next`` is the
    process whose ring index 0 this share's last ring index feeds, ``prev``
    the one that feeds this share's index 0 (this process where the ring
    is local)."""
    lr, lc = grid.local_shape()
    r0, c0 = grid.origin()
    if tuple(src.shape[:2]) != (lr, lc):
        raise ValueError(f"a stack of shape {tuple(src.shape)} is not this "
                         f"process's ({lr}, {lc}) blocks")
    words = _geometry(src, axis)[0]
    if axis == "c":
        return (words, lr, lc, 1, grid.owner(r0, (c0 + lc) % grid.pc),
                grid.owner(r0, (c0 - 1) % grid.pc))
    return (words, 1, lr, lc, grid.owner((r0 + lr) % grid.pr, c0),
            grid.owner((r0 - 1) % grid.pr, c0))


def ring_shift_pod_plain(srcs, axes, grid) -> list:
    """The hop across processes through ``gloo`` on host copies: each
    process's blocks move one ring index on, and the blocks at the end of
    its share go to the next process's index 0 (an exchange of host
    tensors).  Returns the stacks on the sources' device."""
    from combblas_tpu_torch.parallel import exchange

    host = [s.detach().cpu().contiguous() for s in srcs]
    wants = []
    for k, (h, axis) in enumerate(zip(host, axes)):
        words, outer, ring, inner, _nxt, prev = _pod_geometry(grid, h, axis)
        e = h[0, 0].numel()
        for o in range(outer):   # the previous process's last ring index
            start = ((o * ring + ring - 1) * inner) * e
            wants.append((prev, k, start, start + inner * e))
    got = iter(exchange.pull([h.reshape(-1) for h in host], wants))
    out = []
    for h, axis in zip(host, axes):
        _w, outer, ring, inner, _n, _p = _pod_geometry(grid, h, axis)
        v = h.reshape(outer, ring, inner, -1)
        d = torch.empty_like(v)
        d[:, 1:] = v[:, :-1]
        for o in range(outer):
            d[o, 0] = next(got).reshape(inner, -1)
        out.append(d.reshape(h.shape).to(srcs[0].device))
    return out


def _pod_slot(srcs, dev):
    """The ring slot the next hop of stacks like ``srcs`` pushes into, and
    the stacks' byte offsets in it (a collective step: every process takes
    the same slot, :func:`parallel.exchange.ring_slot`)."""
    from combblas_tpu_torch.parallel import exchange

    offs = exchange._aligned([s.numel() * s.element_size() for s in srcs])
    return exchange.ring_slot(int(offs[-1]), dev), offs


def _pod_launch(srcs, axes, grid, slot, offs) -> list:
    """One launch of ``csrc/ring.cu`` for every (contiguous) stack, pushing
    the blocks that leave this process into the next process's ``slot``
    and the rest into this process's.  Returns the views of this process's
    slot, which hold the hop's result once every process has passed
    :func:`_rendezvous`."""
    dev = srcs[0].device
    rows, crossed = [], False
    for src, axis, off in zip(srcs, axes, offs):
        words, outer, ring, inner, nxt, _prev = _pod_geometry(grid, src,
                                                              axis)
        crossed |= nxt != grid.rank
        rows += [src.data_ptr(), slot.ptr + int(off),
                 slot.peers[nxt] + int(off), words, outer, ring, inner]
    table = (ctypes.c_int64 * len(rows))(*rows)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.cbt_ring_shift(ctypes.addressof(table), len(rows) // 7,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ring_shift")
    LAUNCHES["ring_shift"] += 1
    if crossed:
        LAUNCHES["ring_shift_pod"] += 1
    return [slot.own[int(o):int(o) + s.numel() * s.element_size()]
            .view(s.dtype).view(s.shape) for s, o in zip(srcs, offs)]


def _rendezvous(dev) -> None:
    """The hop's rendezvous: this process's pushes have landed once its
    stream is done, and every push into its slot once all processes have
    met at the barrier."""
    from combblas_tpu_torch.parallel import exchange

    torch.cuda.current_stream(dev).synchronize()
    exchange.barrier()


def _pod_hop(srcs, axes, grid) -> list:
    """The hop across processes on the card: the next slot, one launch,
    the rendezvous; the results are views of the slot."""
    dev = srcs[0].device
    srcs = [s.contiguous() for s in srcs]
    out = _pod_launch(srcs, axes, grid, *_pod_slot(srcs, dev))
    _rendezvous(dev)
    return out


def _validate(srcs, axes) -> torch.device:
    if len(srcs) != len(axes) or not 1 <= len(srcs) <= MAX_ARRAYS:
        raise ValueError(f"1..{MAX_ARRAYS} stacks with one axis each, got "
                         f"{len(srcs)} and {len(axes)}")
    dev = srcs[0].device
    for src, axis in zip(srcs, axes):
        if axis not in AXES:
            raise ValueError(f"axis must be 'r' or 'c', got {axis!r}")
        if src.dim() < 2:
            raise ValueError("a stack has the grid's two axes first")
        if src.device != dev:
            raise ValueError(f"stacks on {src.device} and {dev}")
    return dev


def ring_shift(srcs: Sequence[torch.Tensor], axes: Sequence[str], *,
               plain: bool = False, grid=None) -> list:
    """Shift every stack ``srcs[k]`` one hop along ``axes[k]`` ('r' or
    'c'); returns the shifted stacks, fresh tensors.  CUDA tensors launch
    ``csrc/ring.cu`` once for all of them; CPU tensors, or ``plain=True``
    (the reference run), take :func:`ring_shift_plain`.  On a pod ``grid``
    the stacks are this process's shares and the hop crosses processes
    (the kernel's cross-process form, its result copied out of the ring
    slot, or :func:`ring_shift_pod_plain`)."""
    dev = _validate(srcs, axes)
    pod = grid is not None and grid.is_pod
    if dev.type == "cpu" or plain:
        if pod:
            return ring_shift_pod_plain(srcs, axes, grid)
        return [ring_shift_plain(s, ax) for s, ax in zip(srcs, axes)]
    if dev.type != "cuda":
        raise ValueError(f"no ring-shift kernel for device {dev}")
    if pod:
        return [x.clone() for x in _pod_hop(srcs, axes, grid)]
    srcs = [s.contiguous() for s in srcs]
    dsts = [torch.empty_like(s) for s in srcs]
    rows = []
    for src, dst, axis in zip(srcs, dsts, axes):
        rows += [src.data_ptr(), dst.data_ptr(), dst.data_ptr(),
                 *_geometry(src, axis)]
    table = (ctypes.c_int64 * len(rows))(*rows)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_ring_shift(ctypes.addressof(table), len(rows) // 7,
                                 stream)
    _build.check(lib, err, "ring_shift")
    LAUNCHES["ring_shift"] += 1
    return dsts


def ring_hop(srcs: Sequence[torch.Tensor], axes: Sequence[str],
             grid) -> list:
    """:func:`ring_shift` for a caller that hops the same stacks stage
    after stage, as the ring SUMMA does.  On a pod card the results are
    not copied: they are views of this process's ring slot, each valid
    until the hop after next (two slots are taken in turn), so the caller
    reads a hop's result before it makes the second hop after it and keeps
    no reference past that.  Elsewhere this is :func:`ring_shift`."""
    if grid.is_pod and _validate(srcs, axes).type == "cuda":
        return _pod_hop(srcs, axes, grid)
    return ring_shift(srcs, axes, grid=grid)
