"""R-MAT (Kronecker) and Erdős–Rényi edge generators on the device (port
of ``combblas_tpu/gen/rmat.py``).

Same construction as the JAX package: one uniform per (level, edge) picks the
quadrant at each of ``scale`` levels of the recursive descent, then a random
vertex permutation scrambles the ids, then duplicate edges are summed into a
sorted SpCOO.  Random numbers come from an explicit ``torch.Generator``
instead of JAX's threefry, so the same seed gives OTHER edges than the JAX
generator: the two packages are compared on shared numpy inputs, never on
their generators' bits.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO, compress_sorted

__all__ = ["G500_PROBS", "SSCA_PROBS", "rmat_edges", "er_edges",
           "edges_to_coo", "rmat_matrix"]

#: Graph500 quadrant probabilities (a, b, c, d) = (.57, .19, .19, .05).
G500_PROBS = (0.57, 0.19, 0.19, 0.05)
#: SSCA initiator (.6, .4/3, .4/3, .4/3), the seg2 headline's matrix family.
SSCA_PROBS = (0.6, 0.4 / 3, 0.4 / 3, 0.4 / 3)
#: Edges drawn per batch: bounds the (scale, batch) float32 uniforms (at
#: scale 22, 2^22 edges take 369 MB instead of 2.9 GB for all 2^25).
_EDGE_CHUNK = 1 << 22


def rmat_edges(generator: torch.Generator, scale: int, nedges: int,
               probs=G500_PROBS, scramble: bool = True):
    """Generate ``nedges`` R-MAT edges over 2**scale vertices on the
    generator's device.  Returns (rows, cols) int32 tensors; self loops and
    duplicates are kept, as in the JAX package."""
    a, b, c, _d = probs
    dev = generator.device
    weights = (1 << torch.arange(scale - 1, -1, -1, dtype=torch.int32,
                                 device=dev))[:, None]
    rows = torch.empty(nedges, dtype=torch.int32, device=dev)
    cols = torch.empty(nedges, dtype=torch.int32, device=dev)
    for lo in range(0, nedges, _EDGE_CHUNK):
        hi = min(lo + _EDGE_CHUNK, nedges)
        u = torch.rand((scale, hi - lo), generator=generator, device=dev,
                       dtype=torch.float32)
        row_bit = (u >= a + b).to(torch.int32)
        col_bit = (((u >= a) & (u < a + b)) | (u >= a + b + c)).to(torch.int32)
        rows[lo:hi] = (row_bit * weights).sum(0, dtype=torch.int32)
        cols[lo:hi] = (col_bit * weights).sum(0, dtype=torch.int32)
    if scramble:
        perm = torch.randperm(1 << scale, generator=generator, device=dev,
                              dtype=torch.int64).to(torch.int32)
        rows, cols = perm[rows.long()], perm[cols.long()]
    return rows, cols


def er_edges(generator: torch.Generator, scale: int, nedges: int):
    """``nedges`` uniform Erdős–Rényi edges over 2**scale vertices (the
    reference's ER input class, ``3DSpGEMM/mpipspgemm.cpp``) on the
    generator's device: (rows, cols) int32, duplicates and loops kept."""
    n = 1 << scale
    dev = generator.device
    rows = torch.randint(0, n, (nedges,), generator=generator, device=dev,
                         dtype=torch.int32)
    cols = torch.randint(0, n, (nedges,), generator=generator, device=dev,
                         dtype=torch.int32)
    return rows, cols


def edges_to_coo(rows: torch.Tensor, cols: torch.Tensor, shape,
                 out_capacity: int, vals: torch.Tensor | None = None,
                 remove_self_loops: bool = False,
                 symmetrize: bool = False) -> SpCOO:
    """Assemble an edge list into a deduplicated sorted SpCOO on the device;
    duplicate edges are summed."""
    m, n = shape
    if vals is None:
        vals = torch.ones(rows.shape, dtype=torch.float32, device=rows.device)
    if symmetrize:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
        vals = torch.cat([vals, vals])
    valid = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    if remove_self_loops:
        valid = rows != cols
    r = torch.where(valid, rows, m).to(torch.int32)
    c = torch.where(valid, cols, n).to(torch.int32)
    v = torch.where(valid, vals, torch.zeros_like(vals))
    # one int64 key orders exactly as the pair (r, c); invalid entries sort
    # last because they carry (m, n)
    key = r.long() * (n + 1) + c.long()
    key, order = torch.sort(key, stable=True)
    r, c, v = r[order], c[order], v[order]
    nvalid = valid.sum()
    return compress_sorted(r, c, v, nvalid, (m, n), out_capacity=out_capacity)


def rmat_matrix(generator: torch.Generator, scale: int, edgefactor: int = 16,
                symmetrize: bool = False, remove_self_loops: bool = False,
                probs=G500_PROBS) -> SpCOO:
    """R-MAT adjacency matrix as a SpCOO with unit values (summed over
    duplicate edges), on the generator's device."""
    n = 1 << scale
    nedges = edgefactor * n
    rows, cols = rmat_edges(generator, scale, nedges, probs)
    out_cap = max(8, 1 << int(np.ceil(np.log2(
        nedges * (2 if symmetrize else 1)))))
    return edges_to_coo(rows, cols, (n, n), out_cap,
                        remove_self_loops=remove_self_loops,
                        symmetrize=symmetrize)
