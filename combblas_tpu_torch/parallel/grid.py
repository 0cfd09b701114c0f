"""ProcGrid — the block grid of the distributed layer (port of
``combblas_tpu/parallel/grid.py``).

The JAX package lays its blocks on a device ``Mesh`` with axes ('r', 'c'),
or ('l', 'r', 'c') with a leading layer axis, and ``shard_map`` hands every
device its own block.  The port keeps the same (layers, pr, pc) grid of
blocks.  In one process every block lies on one ``device``: the card,
unless the caller asks for ``device="cpu"``.  The body each device ran under
``shard_map`` becomes a function of one block that the public functions
call for every block.  Nothing is emulated: the blocks, the panels and the
schedules are the ones a TPU slice runs; only the memory is one card's.

A grid may span ``nproc`` processes (a pod, :func:`parallel.multihost.
pod_grid`).  ``jax.devices()`` is process-major and the JAX grid reshapes
it row-major, so process p owns the blocks at raster positions
[p·B/P, (p+1)·B/P) of the B = pr·pc blocks.  The port asks that these form
a rectangle of whole block rows, or a run of one block row: the local
stacks are then (lr, lc, ...) with every process's of one shape.  A grid of
one process is the grid of one device, and compares equal to it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from combblas_tpu_torch.device import resolve_device

__all__ = ["ProcGrid", "default_grid", "single_process"]


@dataclasses.dataclass(frozen=True)
class ProcGrid:
    """A (layers, pr, pc) grid of blocks; this process (``rank`` of
    ``nproc``) holds its share of them on ``device``.  Hashable."""

    pr: int
    pc: int
    layers: int
    device: torch.device
    nproc: int = 1
    rank: int = 0

    @staticmethod
    def make(pr: int | None = None, pc: int | None = None, layers: int = 1,
             device=None, nproc: int = 1, rank: int = 0) -> "ProcGrid":
        """The grid of ``pr`` x ``pc`` blocks (times ``layers``) on ``device``
        (the card when it is None).  Without sizes it is one block per
        layer, as the JAX package's grid over one chip.  ``nproc`` > 1
        spreads the blocks over that many processes (:mod:`multihost`)."""
        if pr is None or pc is None:
            pr = pc = 1
        if min(pr, pc, layers) < 1:
            raise ValueError(f"grid sizes must be positive: {pr}, {pc}, "
                             f"{layers}")
        if not 0 <= rank < nproc:
            raise ValueError(f"rank {rank} of {nproc} processes")
        g = ProcGrid(int(pr), int(pc), int(layers), resolve_device(device),
                     int(nproc), int(rank))
        if nproc > 1:
            g.local_shape()   # the ownership must be a rectangle
        return g

    @property
    def is3d(self) -> bool:
        return self.layers > 1

    @property
    def nprocs(self) -> int:
        """The number of blocks (the JAX package's device count)."""
        return self.layers * self.pr * self.pc

    @property
    def is_pod(self) -> bool:
        """Whether the blocks are spread over several processes."""
        return self.nproc > 1

    def grid2d(self) -> "ProcGrid":
        """The per-layer 2D grid of a 3D grid."""
        return dataclasses.replace(self, layers=1)

    def local_shape(self) -> tuple:
        """(lr, lc): the block rows and columns each process holds."""
        if self.nproc == 1:
            return self.pr, self.pc
        blocks = self.pr * self.pc
        if self.layers != 1 or blocks % self.nproc:
            raise ValueError(f"a {self.layers}x{self.pr}x{self.pc} grid "
                             f"cannot be split evenly over {self.nproc} "
                             "processes")
        per = blocks // self.nproc
        if per % self.pc == 0:
            return per // self.pc, self.pc
        if self.pc % per == 0:
            return 1, per
        raise ValueError(f"{per} blocks a process on a {self.pr}x{self.pc} "
                         "grid are neither whole block rows nor a run of "
                         "one")

    def origin(self, rank: int | None = None) -> tuple:
        """(r0, c0): the first block of process ``rank`` (default: this
        one)."""
        rank = self.rank if rank is None else rank
        lr, lc = self.local_shape()
        start = rank * lr * lc
        return start // self.pc, start % self.pc

    def owner(self, i: int, j: int) -> int:
        """The process that holds block (i, j)."""
        lr, lc = self.local_shape()
        return (i * self.pc + j) // (lr * lc)

    def local_blocks(self):
        """This process's blocks as global (i, j), in raster order."""
        lr, lc = self.local_shape()
        r0, c0 = self.origin()
        return [(r0 + a, c0 + b) for a in range(lr) for b in range(lc)]

    def vec_range(self, length: int, rank: int | None = None) -> tuple:
        """[lo, hi): the slice of a FullyDist vector of padded ``length``
        that process ``rank`` (default: this one) holds."""
        rank = self.rank if rank is None else rank
        if length % self.nproc:
            raise ValueError(f"length {length} is not a multiple of the "
                             f"{self.nproc} processes")
        chunk = length // self.nproc
        return rank * chunk, (rank + 1) * chunk


def default_grid(layers: int = 1, device=None) -> ProcGrid:
    """The grid with one block per layer on ``device``."""
    return ProcGrid.make(layers=layers, device=device)


def single_process(fn):
    """Decorate a distributed function that has no exchange across
    processes yet: a call whose grid (a ``ProcGrid`` argument, or the
    ``grid`` of a matrix argument) spans several processes raises
    ``NotImplementedError`` naming ROADMAP item 1.8, instead of computing
    on this process's share alone."""
    @functools.wraps(fn)
    def checked(*args, **kwargs):
        for x in (*args, *kwargs.values()):
            g = x if isinstance(x, ProcGrid) else getattr(x, "grid", None)
            if isinstance(g, ProcGrid) and g.is_pod:
                raise NotImplementedError(
                    f"{fn.__name__} across {g.nproc} processes is not "
                    "ported yet (ROADMAP item 1.8)")
        return fn(*args, **kwargs)
    return checked
