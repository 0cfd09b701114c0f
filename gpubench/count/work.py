"""The work the benchmark counts: products, Graph500 edges, and the bytes
and operations a kernel's inputs need.

Every count is taken from the benchmark's own graph (nnz, degrees, shapes)
and never from a program's buffers, so a redesign of a kernel's layout,
pads or slots does not move the yardstick.  Bytes count each input read
once and each output written once.
"""

from __future__ import annotations

import torch

from gpubench.core.peaks import PEAKS

__all__ = ["a2_products", "components", "component_edges",
           "expand_work", "compress_work", "ell_sum_work", "ell_max_work",
           "bound_s"]

#: Bytes of one COO entry or product: int32 row, int32 column, float32
#: value.
COO_BYTES = 12


def a2_products(row_ptr: torch.Tensor, col: torch.Tensor) -> int:
    """The products of A·A: sum over k of nnz(A[:, k]) * nnz(A[k, :])."""
    n = row_ptr.shape[0] - 1
    row_len = row_ptr[1:] - row_ptr[:-1]
    col_len = torch.bincount(col.long(), minlength=n)
    return int((row_len * col_len).sum())


def components(row: torch.Tensor, col: torch.Tensor, n: int) -> torch.Tensor:
    """Connected-component labels (the least vertex id of each component)
    of the symmetric graph with entries (row, col): each tree's root hooks
    onto the least label across its edges, then pointer jumping, until
    nothing changes."""
    lab = torch.arange(n, dtype=torch.int64, device=row.device)
    r, c = row.long(), col.long()
    while True:
        old = lab
        lab = lab.scatter_reduce(0, lab[r], lab[c], "amin")
        while True:                       # pointer jumping to the root
            nxt = lab[lab]
            if torch.equal(nxt, lab):
                break
            lab = nxt
        if torch.equal(lab, old):
            return lab


def component_edges(row_ptr: torch.Tensor, row: torch.Tensor,
                    col: torch.Tensor) -> tuple:
    """Graph500's edge count of a search: half the summed degrees of the
    vertices in the root's component.  Returns (component label of each
    vertex, int64 edges of each label) on the graph's device."""
    n = row_ptr.shape[0] - 1
    lab = components(row, col, n)
    deg = row_ptr[1:] - row_ptr[:-1]
    edges = torch.zeros(n, dtype=torch.int64, device=lab.device)
    edges.index_add_(0, lab, deg)
    return lab, edges // 2


def expand_work(nnz_a: int, nnz_b: int, products: int) -> tuple:
    """(bytes, operations) of an expansion: A and B read once, each
    product written once, one multiply a product."""
    return (COO_BYTES * (nnz_a + nnz_b + products), products)


def compress_work(products: int, nnz_c: int) -> tuple:
    """(bytes, operations) of a compression: each product read once, each
    entry of C written once, one add a product."""
    return (COO_BYTES * (products + nnz_c), products)


def ell_sum_work(nnz: int, m: int, n: int, d: int) -> tuple:
    """(bytes, operations) of Y = A X, float32: A's entries read once at
    8 B (column, value), X (n, d) read once, Y (m, d) written once; a
    multiply and an add per entry and column."""
    return (8 * nnz + 4 * d * (n + m), 2 * nnz * d)


def ell_max_work(nnz: int, n: int, roots: int, sweeps: int) -> tuple:
    """(bytes, operations) of a batched BFS's max folds: per sweep, the
    graph's entries read once at 4 B, the frontier read and the output
    written once at 4 B a root and vertex; one max per entry and root."""
    return (sweeps * (4 * nnz + 2 * 4 * roots * n),
            sweeps * nnz * roots)


def bound_s(nbytes: float, ops: float, peaks: dict = PEAKS) -> float:
    """The least time the card could take: the larger of bytes over peak
    bandwidth and float32 operations over peak rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["fp32_flops_per_s"])
