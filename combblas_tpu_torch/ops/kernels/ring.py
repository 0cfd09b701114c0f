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
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from combblas_tpu_torch.ops.kernels import LAUNCHES, _build

__all__ = ["ring_shift", "ring_shift_plain", "MAX_ARRAYS"]

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


def ring_shift(srcs: Sequence[torch.Tensor], axes: Sequence[str], *,
               plain: bool = False) -> list:
    """Shift every stack ``srcs[k]`` one hop along ``axes[k]`` ('r' or
    'c'); returns the shifted stacks.  CUDA tensors launch ``csrc/ring.cu``
    once for all of them; CPU tensors, or ``plain=True`` (the reference
    run), take :func:`ring_shift_plain`."""
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
    if dev.type == "cpu" or plain:
        return [ring_shift_plain(s, ax) for s, ax in zip(srcs, axes)]
    if dev.type != "cuda":
        raise ValueError(f"no ring-shift kernel for device {dev}")
    srcs = [s.contiguous() for s in srcs]
    dsts = [torch.empty_like(s) for s in srcs]
    rows = []
    for src, dst, axis in zip(srcs, dsts, axes):
        rows += [src.data_ptr(), dst.data_ptr(), *_geometry(src, axis)]
    table = (ctypes.c_int64 * len(rows))(*rows)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cbt_ring_shift(ctypes.addressof(table), len(rows) // 6,
                                 stream)
    _build.check(lib, err, "ring_shift")
    LAUNCHES["ring_shift"] += 1
    return dsts
