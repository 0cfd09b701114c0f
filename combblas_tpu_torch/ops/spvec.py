"""SpVec — capacity-padded sparse vector (port of
``combblas_tpu/ops/spvec.py``).

The local level of ``FullyDistSpVec``: a sorted, deduplicated (index,
value) list with a fixed capacity and an ``nnz`` held on the device.  The
first ``nnz`` slots are real; the rest carry ``idx == length`` and value 0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from combblas_tpu_torch.device import resolve_device
from combblas_tpu_torch.ops.ewise import _keep_prefix

__all__ = ["SpVec"]


@dataclasses.dataclass(frozen=True)
class SpVec:
    """Padded sparse vector: the first nnz of (idx, val) are real, the rest
    sentinels (idx == length)."""

    idx: torch.Tensor  # int32[capacity], sorted ascending
    val: torch.Tensor  # dtype[capacity]
    nnz: torch.Tensor  # int64, 0-d
    length: int

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nnz

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_arrays(idx, val, length: int, capacity: int | None = None,
                    device=None) -> "SpVec":
        """From host arrays: sorted by index, padded to ``capacity`` (the
        next power of two, at least 8), on ``device`` (the card when it is
        None)."""
        device = resolve_device(device)
        idx = np.asarray(idx, np.int32)
        val = np.asarray(val)
        if val.dtype == np.float64:
            val = val.astype(np.float32)
        order = np.argsort(idx, kind="stable")
        idx, val = idx[order], val[order]
        nnz = idx.size
        cap = capacity or max(8, 1 << int(np.ceil(np.log2(max(nnz, 1)))))
        pidx = np.full(cap, length, np.int32)
        pval = np.zeros(cap, val.dtype)
        pidx[:nnz], pval[:nnz] = idx, val
        return SpVec(torch.from_numpy(pidx).to(device),
                     torch.from_numpy(pval).to(device),
                     torch.tensor(nnz, dtype=torch.int64, device=device),
                     int(length))

    @staticmethod
    def from_dense_mask(val: torch.Tensor, mask: torch.Tensor,
                        capacity: int | None = None) -> "SpVec":
        """Compact a masked-dense vector into index/value form."""
        n = val.shape[0]
        ar = torch.arange(n, dtype=torch.int32, device=val.device)
        nnz, (idx, v) = _keep_prefix(mask, capacity or n,
                                     ((ar, n), (val, 0)))
        return SpVec(idx, v, nnz, n)

    # -- conversions ------------------------------------------------------
    def to_dense(self, fill=0) -> torch.Tensor:
        out = torch.full((self.length + 1,), fill, dtype=self.val.dtype,
                         device=self.device)
        out[self.idx.clamp(max=self.length).long()] = torch.where(
            self.mask(), self.val, fill).to(self.val.dtype)
        return out[:self.length]

    def to_dense_mask(self) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.length
        dm = torch.zeros(n + 1, dtype=torch.bool, device=self.device)
        dm[self.idx.clamp(max=n).long()] = self.mask()
        return self.to_dense(), dm[:n]

    # -- FullyDistSpVec-parity ops ---------------------------------------
    def invert(self, new_length: int, capacity: int | None = None
               ) -> "SpVec":
        """Value <-> index swap (``FullyDistSpVec::Invert``).  Values must
        be integral and unique."""
        cap = capacity or self.capacity
        live = self.mask()
        nidx = torch.where(live, self.val.to(torch.int32), new_length)
        nval = torch.where(live, self.idx, 0).to(self.val.dtype)
        nidx, order = torch.sort(nidx, stable=True)
        return SpVec(nidx[:cap], nval[order][:cap], self.nnz,
                     int(new_length))

    def select(self, pred) -> "SpVec":
        """Keep entries whose value satisfies pred (``FilterByVal``)."""
        return self.select_by_mask(pred(self.val))

    def set_minus(self, other: "SpVec") -> "SpVec":
        """Entries of self at indices not present in other (``SetMinus``)."""
        present = torch.zeros(self.length + 1, dtype=torch.bool,
                              device=self.device)
        present[other.idx.clamp(max=other.length).long()] = other.mask()
        return self.select_by_mask(
            ~present[self.idx.clamp(max=self.length).long()])

    def select_by_mask(self, keep: torch.Tensor) -> "SpVec":
        nnz, (idx, val) = _keep_prefix(
            keep & self.mask(), self.capacity,
            ((self.idx, self.length), (self.val, 0)))
        return SpVec(idx, val, nnz, self.length)

    def sort_by_value(self) -> "SpVec":
        """Sort entries by value (``FullyDistSpVec::sort``): the idx order
        follows ascending value, equal values in index order."""
        big = (float("inf") if self.val.dtype.is_floating_point
               else torch.iinfo(self.val.dtype).max)
        v = torch.where(self.mask(), self.val, big)
        val_s, order = torch.sort(v, stable=True)
        val_s = torch.where(self.mask(), val_s, 0).to(self.val.dtype)
        return SpVec(self.idx[order], val_s, self.nnz, self.length)
