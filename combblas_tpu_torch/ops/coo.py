"""SpCOO — capacity-padded coordinate triples (port of ``combblas_tpu/ops/coo.py``).

Only the subset the seg2 SpGEMM slice needs.  The container keeps the JAX
package's contract: ``row``/``col``/``val`` have a fixed ``capacity``; the
first ``nnz`` entries are real and row-major (row, col) sorted, the rest are
sentinels ``(m, n, 0)`` that sort after every real entry.  ``row``/``col``
stay int32 (so the numpy bridge is exact); ``nnz`` is a 0-d int64 tensor on
the matrix's device, so device code never has to sync to read it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["SpCOO", "compress_sorted"]


def _round_capacity(n: int) -> int:
    """Round a capacity up to a power of two (at least 8), as the JAX
    package does."""
    if n <= 8:
        return 8
    return 1 << int(np.ceil(np.log2(n)))


@dataclasses.dataclass(frozen=True)
class SpCOO:
    """Padded COO sparse matrix with fixed capacity and a device-side nnz."""

    row: torch.Tensor  # int32[capacity]
    col: torch.Tensor  # int32[capacity]
    val: torch.Tensor  # dtype[capacity]
    nnz: torch.Tensor  # int64, 0-d
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row.device

    def mask(self) -> torch.Tensor:
        """Boolean mask of valid entries."""
        return torch.arange(self.capacity, device=self.device) < self.nnz

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_arrays(row, col, val, shape: Tuple[int, int],
                    capacity: int | None = None, sum_duplicates: bool = True,
                    dtype=None, device=None) -> "SpCOO":
        """Host-side constructor from numpy arrays: sorts, optionally sums
        duplicates, pads — the same steps as the JAX ``from_arrays``."""
        row = np.asarray(row, np.int32)
        col = np.asarray(col, np.int32)
        val = np.asarray(val, dtype if dtype is not None else None)
        if dtype is None and val.dtype == np.float64:
            val = val.astype(np.float32)
        m, n = shape
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        if sum_duplicates and row.size:
            key_new = np.empty(row.size, bool)
            key_new[0] = True
            key_new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
            seg = np.cumsum(key_new) - 1
            out_val = np.zeros(int(seg[-1]) + 1, val.dtype)
            np.add.at(out_val, seg, val)
            row, col, val = row[key_new], col[key_new], out_val
        nnz = row.size
        cap = _round_capacity(nnz) if capacity is None else capacity
        if cap < nnz:
            raise ValueError(f"capacity {cap} below nnz {nnz}")
        prow = np.full(cap, m, np.int32)
        pcol = np.full(cap, n, np.int32)
        pval = np.zeros(cap, val.dtype)
        prow[:nnz], pcol[:nnz], pval[:nnz] = row, col, val
        return SpCOO.from_numpy(prow, pcol, pval, nnz, (m, n), device)

    @staticmethod
    def from_dense(dense, capacity: int | None = None,
                   device=None) -> "SpCOO":
        dense = np.asarray(dense)
        row, col = np.nonzero(dense)
        return SpCOO.from_arrays(row, col, dense[row, col], dense.shape,
                                 capacity=capacity, device=device)

    @staticmethod
    def from_numpy(row, col, val, nnz: int, shape: Tuple[int, int],
                   device=None) -> "SpCOO":
        """The numpy bridge: padded arrays (as ``np.asarray`` of a JAX
        SpCOO's fields gives them) to a port SpCOO, bit for bit."""
        def dev(x):  # copy: the source may be a read-only JAX buffer view
            return torch.from_numpy(np.array(x, copy=True)).to(device)

        return SpCOO(
            row=dev(np.asarray(row, np.int32)),
            col=dev(np.asarray(col, np.int32)),
            val=dev(val),
            nnz=torch.tensor(int(nnz), dtype=torch.int64, device=device),
            shape=(int(shape[0]), int(shape[1])),
        )

    def to_numpy(self):
        """Inverse of :meth:`from_numpy`: (row, col, val, nnz, shape)."""
        return (self.row.cpu().numpy(), self.col.cpu().numpy(),
                self.val.cpu().numpy(), int(self.nnz), self.shape)

    # -- conversions ------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Dense (m, n) tensor; padding contributes nothing."""
        m, n = self.shape
        valid = self.mask()
        r = torch.where(valid, self.row, m).long()
        c = torch.where(valid, self.col, 0).long()
        v = torch.where(valid, self.val, torch.zeros_like(self.val))
        out = torch.zeros((m + 1, n), dtype=self.val.dtype, device=self.device)
        out.index_put_((r, c), v, accumulate=True)
        return out[:m]

    def row_ptr(self) -> torch.Tensor:
        """CSR row pointer int64[m+1] via searchsorted over the sorted row
        ids (pads carry row == m), clamped to nnz."""
        m = self.shape[0]
        bounds = torch.arange(m + 1, dtype=self.row.dtype, device=self.device)
        ptr = torch.searchsorted(self.row, bounds, side="left")
        return torch.minimum(ptr, self.nnz)


def compress_sorted(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                    nvalid, shape: Tuple[int, int],
                    sr: Semiring = PLUS_TIMES,
                    out_capacity: int | None = None) -> SpCOO:
    """Deduplicate a (row, col)-sorted triple stream with semiring addition
    (flag + prefix sum + segment reduction).  ``nvalid`` counts the real
    entries at the front; the rest must be sentinels that sort last.
    ``nnz`` saturates at ``out_capacity``; segments past it are dropped."""
    m, n = shape
    dev = row.device
    cap = row.shape[0]
    out_cap = cap if out_capacity is None else out_capacity
    idx = torch.arange(cap, device=dev)
    valid = idx < nvalid
    prev_row = torch.cat([torch.full((1,), -1, dtype=row.dtype, device=dev),
                          row[:-1]])
    prev_col = torch.cat([torch.full((1,), -1, dtype=col.dtype, device=dev),
                          col[:-1]])
    is_new = ((row != prev_row) | (col != prev_col)) & valid
    seg = torch.cumsum(is_new, 0) - 1
    nseg = torch.clamp(seg[-1] + 1, min=0) if cap else torch.zeros(
        (), dtype=torch.int64, device=dev)
    nnz_out = torch.clamp(nseg, max=out_cap)
    # out-of-range segments land on a dropped slot at index out_cap
    seg_sc = torch.where(valid & (seg < out_cap), seg, out_cap)
    if sr.add_kind == "sum":
        out_val = torch.zeros(out_cap + 1, dtype=val.dtype, device=dev)
        out_val.index_add_(0, seg_sc, torch.where(valid, val,
                                                  torch.zeros_like(val)))
    else:
        ident = sr.zero(val.dtype).to(dev)
        out_val = ident.repeat(out_cap + 1)
        out_val.scatter_reduce_(
            0, seg_sc, torch.where(valid, val, ident),
            reduce="amin" if sr.add_kind == "min" else "amax")
    out_val = out_val[:out_cap]
    live = torch.arange(out_cap, device=dev) < nnz_out
    out_val = torch.where(live, out_val, torch.zeros_like(out_val))
    # every entry of a segment carries the same (row, col): the scatter is
    # deterministic whichever write lands
    out_row = torch.full((out_cap + 1,), m, dtype=torch.int32, device=dev)
    out_row.scatter_(0, seg_sc, torch.where(valid, row, m).to(torch.int32))
    out_col = torch.full((out_cap + 1,), n, dtype=torch.int32, device=dev)
    out_col.scatter_(0, seg_sc, torch.where(valid, col, n).to(torch.int32))
    return SpCOO(row=out_row[:out_cap], col=out_col[:out_cap], val=out_val,
                 nnz=nnz_out.to(torch.int64), shape=(int(m), int(n)))
