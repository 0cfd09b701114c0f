"""Elementwise sparse ops: Apply / Prune / EWiseApply / EWiseMult / DimApply
(port of ``combblas_tpu/ops/ewise.py``).

Binary ops between two sparse matrices use one tagged sort over the
concatenated triple streams, as the JAX package does; union, intersection
and difference follow from per-segment presence flags.  Compaction keeps
order and reads the kept count on the host once (``torch.nonzero``), in
place of JAX's scatter with dropped indices: a scatter that sent every
dropped entry to one spare slot would serialise on that slot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from combblas_tpu_torch.ops.coo import SpCOO

__all__ = [
    "apply_values",
    "prune",
    "prune_i",
    "dim_apply",
    "prune_column",
    "ewise_apply",
    "ewise_mult",
    "set_difference",
    "add",
]


def apply_values(a: SpCOO, fn: Callable) -> SpCOO:
    """New matrix with fn applied to every stored value
    (``SpParMat::Apply``)."""
    return dataclasses.replace(a, val=torch.where(a.mask(), fn(a.val), 0))


def _keep_prefix(keep: torch.Tensor, out_cap: int, parts):
    """Move the entries where ``keep`` holds to the front, in order: each
    ``(tensor, pad)`` of ``parts`` becomes an ``out_cap`` buffer filled
    with ``pad`` past the kept ones.  Returns ``(nnz, buffers)``; ``nnz``
    counts every kept entry, also those past ``out_cap``, which are
    dropped."""
    idx = torch.nonzero(keep).squeeze(1)
    nnz = torch.tensor(idx.shape[0], dtype=torch.int64, device=keep.device)
    idx = idx[:out_cap]
    out = []
    for t, pad in parts:
        buf = torch.full((out_cap,), pad, dtype=t.dtype, device=t.device)
        buf[:idx.shape[0]] = t[idx]
        out.append(buf)
    return nnz, out


def _compact(a: SpCOO, keep: torch.Tensor,
             out_capacity: int | None = None) -> SpCOO:
    """Drop entries where ``keep`` is False, keeping order.  Pads are
    ``(m, n, 0)``; ``nnz`` counts every kept entry, even past
    ``out_capacity`` (those are dropped, not saturated), as in JAX."""
    m, n = a.shape
    out_cap = a.capacity if out_capacity is None else out_capacity
    nnz, (row, col, val) = _keep_prefix(keep & a.mask(), out_cap,
                                        ((a.row, m), (a.col, n), (a.val, 0)))
    return SpCOO(row=row, col=col, val=val, nnz=nnz, shape=a.shape)


def prune(a: SpCOO, pred: Callable, out_capacity: int | None = None) -> SpCOO:
    """Remove entries where pred(value) is True (``SpParMat::Prune``)."""
    return _compact(a, ~pred(a.val), out_capacity)


def prune_i(a: SpCOO, pred: Callable,
            out_capacity: int | None = None) -> SpCOO:
    """Remove entries where pred(row, col, value) is True (``PruneI``)."""
    return _compact(a, ~pred(a.row, a.col, a.val), out_capacity)


def _at(x: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """``x[idx]`` with pad indices clamped into range."""
    return x[idx.clamp(max=size - 1).long()]


def dim_apply(a: SpCOO, x: torch.Tensor, dim: str,
              fn: Callable = torch.mul) -> SpCOO:
    """Combine each entry with the vector element of its row ('row') or
    column ('col'): A_ij = fn(A_ij, x_i or x_j) (``SpParMat::DimApply``;
    column scaling is how MCL makes columns stochastic)."""
    m, n = a.shape
    if dim == "row":
        g = _at(x, a.row, m)
    elif dim == "col":
        g = _at(x, a.col, n)
    else:
        raise ValueError(dim)
    return dataclasses.replace(a, val=torch.where(a.mask(), fn(a.val, g), 0))


def prune_column(a: SpCOO, x: torch.Tensor, pred: Callable,
                 out_capacity: int | None = None) -> SpCOO:
    """Drop entry (i, j) when pred(A_ij, x_j) is True (``PruneColumn``)."""
    return _compact(a, ~pred(a.val, _at(x, a.col, a.shape[1])), out_capacity)


def ewise_apply(a: SpCOO, b: SpCOO, fn: Callable, *, a_default=0.0,
                b_default=0.0, mode: str = "union",
                out_capacity: int | None = None,
                a_present_only: bool = False,
                b_present_only: bool = False) -> SpCOO:
    """Generalized elementwise combine of two same-shape sparse matrices.

    ``mode='intersect'`` keeps entries present in both (EWiseMult),
    ``'a_minus_b'`` keeps entries of A absent from B (SetDifference),
    ``'union'`` keeps either, substituting the defaults for the missing
    side.  The concatenation is sorted by ``(row, col, tag)`` with one
    stable sort of the int64 key ``(row * (n + 1) + col) * 2 + tag``; pads
    carry ``(m, n)`` and sort last."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    m, n = a.shape
    dev = a.device
    cap = a.capacity + b.capacity
    out_cap = out_capacity if out_capacity is not None else cap
    vdt = torch.promote_types(a.val.dtype, b.val.dtype)
    row = torch.cat([a.row, b.row])
    col = torch.cat([a.col, b.col])
    tag = torch.cat([torch.zeros(a.capacity, dtype=torch.int64, device=dev),
                     torch.ones(b.capacity, dtype=torch.int64, device=dev)])
    val = torch.cat([a.val.to(vdt), b.val.to(vdt)])
    key = (row.long() * (n + 1) + col.long()) * 2 + tag
    order = torch.sort(key, stable=True)[1]
    row, col, tag, val = row[order], col[order], tag[order], val[order]
    nvalid = a.nnz + b.nnz
    idx = torch.arange(cap, device=dev)
    valid = idx < nvalid
    nxt = (idx + 1).clamp(max=cap - 1)
    prv = (idx - 1).clamp(min=0)
    same_next = (row == row[nxt]) & (col == col[nxt]) & (idx + 1 < nvalid)
    same_prev = (row == row[prv]) & (col == col[prv]) & (idx > 0)
    seg_start = valid & ~same_prev
    # at a segment start tag 0 is the A entry, and a B entry may follow it
    # (each matrix has unique keys)
    a_here = tag == 0
    b_next = same_next & (tag[nxt] == 1)
    a_dflt = torch.tensor(a_default, dtype=vdt, device=dev)
    b_dflt = torch.tensor(b_default, dtype=vdt, device=dev)
    a_val = torch.where(a_here, val, a_dflt)
    b_val = torch.where(a_here, torch.where(b_next, val[nxt], b_dflt), val)
    b_here = ~a_here | b_next
    if mode == "union":
        keep = seg_start
    elif mode == "intersect":
        keep = seg_start & a_here & b_here
    elif mode == "a_minus_b":
        keep = seg_start & a_here & ~b_here
    else:
        raise ValueError(mode)
    if a_present_only:
        keep = keep & a_here
    if b_present_only:
        keep = keep & b_here
    out_val = fn(a_val, b_val).to(vdt)
    nnz, (orow, ocol, oval) = _keep_prefix(
        keep, out_cap, ((row, m), (col, n), (out_val, 0)))
    return SpCOO(row=orow, col=ocol, val=oval, nnz=nnz, shape=a.shape)


def _take_a(x, y):
    return x


def _hadamard(x, y):
    return x * y


def ewise_mult(a: SpCOO, b: SpCOO, exclude: bool = False,
               out_capacity: int | None = None) -> SpCOO:
    """``EWiseMult(A, B, exclude)``: Hadamard product on the intersection,
    or A restricted to B's structural complement."""
    if exclude:
        return ewise_apply(a, b, _take_a, mode="a_minus_b",
                           out_capacity=out_capacity)
    return ewise_apply(a, b, _hadamard, mode="intersect",
                       out_capacity=out_capacity)


def set_difference(a: SpCOO, b: SpCOO,
                   out_capacity: int | None = None) -> SpCOO:
    """Entries of A whose positions are absent from B."""
    return ewise_mult(a, b, exclude=True, out_capacity=out_capacity)


def add(a: SpCOO, b: SpCOO, out_capacity: int | None = None) -> SpCOO:
    """Structural-union addition A + B (operator+ on SpParMat)."""
    return ewise_apply(a, b, torch.add, mode="union",
                       out_capacity=out_capacity)
