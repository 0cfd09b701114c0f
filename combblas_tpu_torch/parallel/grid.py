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
it row-major to (layers, pr, pc), so process p owns the blocks at raster
positions [p·B/P, (p+1)·B/P) of the B = layers·pr·pc blocks.  The port asks
that these form a box.  On a one-layer grid that is a rectangle of whole
block rows, or a run of one block row: the local stacks are then (lr, lc,
...), every process's of one shape.  On a layered grid it is whole layers,
or such a rectangle inside one layer: the local stacks are (ll, lr, lc,
...).  The raster order of (layers, pr, pc) is that of the one-layer
(layers·pr, pc) grid (:meth:`ProcGrid.flat`), so the layered ownership is
that grid's.  A grid of one process is the grid of one device, and
compares equal to it.
"""

from __future__ import annotations

import dataclasses

import torch

from combblas_tpu_torch.device import resolve_device

__all__ = ["ProcGrid", "default_grid"]


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
            g.local_shape3()   # the ownership must be a box
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
        """The per-layer 2D grid of a 3D grid: its sides and block dims.  It
        keeps ``nproc``, so on a layered pod its ownership is not the
        layered grid's (that is :meth:`local_shape3`, :meth:`origin3`,
        :meth:`owner3`)."""
        return dataclasses.replace(self, layers=1)

    def flat(self) -> "ProcGrid":
        """The one-layer (layers·pr, pc) grid over the same processes:
        block (i, j) of layer t is its block (t·pr + i, j), at the same
        raster position, so the one's ownership is the other's and the
        exchanges of :mod:`parallel.exchange` take (ll·lr, lc, ...) views
        of layered stacks.  A one-layer grid's is itself."""
        if self.layers == 1:
            return self
        return dataclasses.replace(self, pr=self.layers * self.pr, layers=1)

    def local_shape(self) -> tuple:
        """(lr, lc): the block rows and columns each process holds, on a
        one-layer grid (and of every layer in one process)."""
        if self.nproc == 1:
            return self.pr, self.pc
        blocks = self.pr * self.pc
        if self.layers != 1 or blocks % self.nproc:
            raise ValueError(f"a {self.layers}x{self.pr}x{self.pc} grid "
                             f"cannot be split evenly over {self.nproc} "
                             "processes by block rows (a layered grid's "
                             "share is local_shape3)")
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

    def local_shape3(self) -> tuple:
        """(ll, lr, lc): the layers, block rows and columns each process
        holds.  A share that is not a box (whole layers, or whole block
        rows or a run of one inside one layer) raises ``ValueError``."""
        if self.nproc == 1:
            return self.layers, self.pr, self.pc
        if self.nprocs % self.nproc:
            raise ValueError(f"a {self.layers}x{self.pr}x{self.pc} grid "
                             f"cannot be split evenly over {self.nproc} "
                             "processes")
        rows, lc = self.flat().local_shape()
        if rows % self.pr == 0:
            return rows // self.pr, self.pr, lc
        if self.pr % rows:
            raise ValueError(f"{rows} block rows a process on a "
                             f"{self.layers}x{self.pr}x{self.pc} grid are "
                             "neither whole layers nor a box inside one")
        return 1, rows, lc

    def origin3(self, rank: int | None = None) -> tuple:
        """(t0, r0, c0): the first block of process ``rank`` (default: this
        one)."""
        self.local_shape3()
        r, c = self.flat().origin(rank)
        return r // self.pr, r % self.pr, c

    def owner3(self, t: int, i: int, j: int) -> int:
        """The process that holds block (i, j) of layer t."""
        self.local_shape3()
        return self.flat().owner(t * self.pr + i, j)

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
