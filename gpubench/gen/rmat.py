"""The benchmark's own R-MAT / Kronecker graph generator, in plain PyTorch.

A frozen copy of the construction in ``combblas_tpu_torch/gen/rmat.py``, so
that a change there does not move what is measured.  One uniform per
(level, edge) picks the quadrant at each of ``scale`` levels of the
recursive descent (R-MAT, Chakrabarti et al. 2004; the Graph500 Kronecker
generator); a random permutation scrambles the vertex ids; the edge list
is symmetrized, self loops removed, and duplicate edges summed into float32
values (so every value, product and sum of an A² is an integer).

A configuration fixes the edge draw (``graph_seed``): it is one data set,
as a Graph500 graph or a published matrix is.  The scramble is drawn from
a seed: the run's ``--seed``, so that every seed gives the same graph under
another labelling (the same work, in another order), or, for a traffic mix
that cycles through a fixed set of labellings, :func:`labelling_seed`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["INITIATORS", "Graph", "rmat_edges", "assemble", "make_graph",
           "labelling_seed"]

#: Quadrant probabilities (a, b, c, d) of the initiators.
INITIATORS = {
    # Graph500 specification, "Kronecker generator"
    "graph500": (0.57, 0.19, 0.19, 0.05),
    # SSCA #2 / CombBLAS 3DSpGEMM/mpipspgemm.cpp's SSCA option
    "ssca": (0.6, 0.4 / 3, 0.4 / 3, 0.4 / 3),
}
#: Edges drawn per batch of uniforms: bounds the (scale, batch) float32
#: draw (at scale 23, 386 MB).
_EDGE_CHUNK = 1 << 22


@dataclasses.dataclass
class Graph:
    """A sorted, duplicate-free sparse matrix on the device.

    ``row``/``col`` int32 and ``val`` float32 of the ``nnz`` entries in
    (row, col) order; ``row_ptr`` int64[n + 1]; ``slots`` the number of
    edge slots the generator drew (2 x edges when symmetrized), from which
    a program sizes its buffers."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row_ptr: torch.Tensor
    n: int
    slots: int

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def deg(self) -> torch.Tensor:
        """Stored entries per row, int64[n]."""
        return self.row_ptr[1:] - self.row_ptr[:-1]


def rmat_edges(gen: torch.Generator, scale: int, nedges: int, probs):
    """``nedges`` R-MAT edges over 2**scale vertices on the generator's
    device, unscrambled: (rows, cols) int32, duplicates and loops kept."""
    a, b, c, _d = probs
    dev = gen.device
    weights = (1 << torch.arange(scale - 1, -1, -1, dtype=torch.int32,
                                 device=dev))[:, None]
    rows = torch.empty(nedges, dtype=torch.int32, device=dev)
    cols = torch.empty(nedges, dtype=torch.int32, device=dev)
    for lo in range(0, nedges, _EDGE_CHUNK):
        hi = min(lo + _EDGE_CHUNK, nedges)
        u = torch.rand((scale, hi - lo), generator=gen, device=dev,
                       dtype=torch.float32)
        row_bit = (u >= a + b).to(torch.int32)
        col_bit = (((u >= a) & (u < a + b)) | (u >= a + b + c)).to(torch.int32)
        rows[lo:hi] = (row_bit * weights).sum(0, dtype=torch.int32)
        cols[lo:hi] = (col_bit * weights).sum(0, dtype=torch.int32)
    return rows, cols


def assemble(rows: torch.Tensor, cols: torch.Tensor, n: int, *,
             symmetrize: bool, remove_self_loops: bool) -> Graph:
    """Edge list -> :class:`Graph`: every edge weighs 1, duplicates sum."""
    slots = rows.shape[0] * (2 if symmetrize else 1)
    if symmetrize:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    key = rows.long() * n + cols.long()
    del rows, cols
    if remove_self_loops:
        key = key[key // n != key % n]
    key = torch.sort(key)[0]
    key, counts = torch.unique_consecutive(key, return_counts=True)
    row = (key // n).to(torch.int32)
    col = (key % n).to(torch.int32)
    del key
    row_ptr = torch.searchsorted(
        row, torch.arange(n + 1, dtype=torch.int32, device=row.device))
    return Graph(row=row, col=col, val=counts.to(torch.float32),
                 row_ptr=row_ptr, n=n, slots=slots)


def make_graph(spec: dict, seed: int, dev) -> Graph:
    """The graph of a configuration's ``graph`` block, scrambled by
    ``seed``: keys ``scale``, ``edgefactor``, ``initiator`` (a key of
    :data:`INITIATORS`), ``symmetrize``, ``remove_self_loops``,
    ``graph_seed``."""
    scale = int(spec["scale"])
    n = 1 << scale
    gen = torch.Generator(device=dev).manual_seed(int(spec["graph_seed"]))
    rows, cols = rmat_edges(gen, scale, int(spec["edgefactor"]) * n,
                            INITIATORS[spec["initiator"]])
    perm = torch.randperm(n, generator=torch.Generator(device=dev)
                          .manual_seed(int(seed)), device=dev)
    rows = perm[rows.long()].to(torch.int32)
    cols = perm[cols.long()].to(torch.int32)
    del perm
    return assemble(rows, cols, n, symmetrize=bool(spec["symmetrize"]),
                    remove_self_loops=bool(spec["remove_self_loops"]))


def labelling_seed(graph_seed: int, j: int) -> int:
    """The scramble seed of labelling ``j`` of a configuration's fixed set
    of labellings: the same for every run."""
    return int(np.random.SeedSequence([int(graph_seed), int(j)])
               .generate_state(1, np.uint64)[0])
