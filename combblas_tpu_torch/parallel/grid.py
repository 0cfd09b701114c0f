"""ProcGrid — the block grid of the distributed layer (port of
``combblas_tpu/parallel/grid.py``).

The JAX package lays its blocks on a device ``Mesh`` with axes ('r', 'c'),
or ('l', 'r', 'c') with a leading layer axis, and ``shard_map`` hands every
device its own block.  The port keeps the same (layers, pr, pc) grid of
blocks, with every block on one ``device``: the card, unless the caller asks
for ``device="cpu"``.  The body each device ran under ``shard_map`` becomes
a function of one block that the public functions call for every block.
Nothing is emulated: the blocks, the panels and the schedules are the ones a
TPU slice runs; only the memory is one card's.  Blocks spread over several
cards wait for a machine with two or more GPUs.
"""

from __future__ import annotations

import dataclasses

import torch

from combblas_tpu_torch.device import resolve_device

__all__ = ["ProcGrid", "default_grid"]


@dataclasses.dataclass(frozen=True)
class ProcGrid:
    """A (layers, pr, pc) grid of blocks on one device; hashable."""

    pr: int
    pc: int
    layers: int
    device: torch.device

    @staticmethod
    def make(pr: int | None = None, pc: int | None = None, layers: int = 1,
             device=None) -> "ProcGrid":
        """The grid of ``pr`` x ``pc`` blocks (times ``layers``) on ``device``
        (the card when it is None).  Without sizes it is one block per
        layer, as the JAX package's grid over one chip."""
        if pr is None or pc is None:
            pr = pc = 1
        if min(pr, pc, layers) < 1:
            raise ValueError(f"grid sizes must be positive: {pr}, {pc}, "
                             f"{layers}")
        return ProcGrid(int(pr), int(pc), int(layers), resolve_device(device))

    @property
    def is3d(self) -> bool:
        return self.layers > 1

    @property
    def nprocs(self) -> int:
        return self.layers * self.pr * self.pc

    def grid2d(self) -> "ProcGrid":
        """The per-layer 2D grid of a 3D grid."""
        return dataclasses.replace(self, layers=1)


def default_grid(layers: int = 1, device=None) -> ProcGrid:
    """The grid with one block per layer on ``device``."""
    return ProcGrid.make(layers=layers, device=device)
