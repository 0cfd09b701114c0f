"""SpCOO — capacity-padded coordinate triples (port of ``combblas_tpu/ops/coo.py``).

The container keeps the JAX package's contract: ``row``/``col``/``val``
have a fixed ``capacity``; the first ``nnz`` entries are real and row-major
(row, col) sorted, the rest are sentinels ``(m, n, 0)`` that sort after
every real entry.  ``row``/``col`` stay int32 (so the numpy bridge is
exact); ``nnz`` is a 0-d int64 tensor on the matrix's device, so device
code never has to sync to read it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from combblas_tpu_torch.device import resolve_device
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["SpCOO", "sort_coo", "compress_sorted", "sort_compress_packed",
           "sort_compress", "merge", "row_split", "row_concat", "find"]


def find(a: "SpCOO"):
    """Matlab-style ``[i, j, v] = find(A)``: the live triples as host numpy
    arrays (the JAX ``find``), ready for :meth:`SpCOO.from_arrays`."""
    row, col, val, nnz, _shape = a.to_numpy()
    return row[:nnz], col[:nnz], val[:nnz]


def _pair_key(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """One int64 key that orders exactly as the int32 pair (row, col)."""
    return (row.long() << 32) + (col.long() + (1 << 31))


def _sort_pairs(row, col, *rest):
    """Stable sort of (row, col, *rest) by the pair (row, col), as the JAX
    package's ``lax.sort(..., num_keys=2)``."""
    order = torch.sort(_pair_key(row, col), stable=True)[1]
    return tuple(t[order] for t in (row, col, *rest))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


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
        duplicates, pads — the same steps as the JAX ``from_arrays``.  The
        tensors go to ``device``, the card when it is None."""
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
    def eye(n: int, value=1.0, dtype=torch.float32,
            capacity: int | None = None, device=None) -> "SpCOO":
        """Sparse identity scaled by ``value``, in O(n)."""
        idx = np.arange(n, dtype=np.int32)
        return SpCOO.from_arrays(idx, idx, np.full((n,), value, np.float32),
                                 (n, n), capacity=capacity,
                                 sum_duplicates=False,
                                 dtype=_np_dtype(dtype), device=device)

    @staticmethod
    def empty(shape: Tuple[int, int], capacity: int = 8,
              dtype=torch.float32, device=None) -> "SpCOO":
        m, n = shape
        device = resolve_device(device)
        return SpCOO(
            row=torch.full((capacity,), m, dtype=torch.int32, device=device),
            col=torch.full((capacity,), n, dtype=torch.int32, device=device),
            val=torch.zeros(capacity, dtype=dtype, device=device),
            nnz=torch.zeros((), dtype=torch.int64, device=device),
            shape=(int(m), int(n)),
        )

    @staticmethod
    def from_numpy(row, col, val, nnz: int, shape: Tuple[int, int],
                   device=None) -> "SpCOO":
        """The numpy bridge: padded arrays (as ``np.asarray`` of a JAX
        SpCOO's fields gives them) to a port SpCOO, bit for bit, on
        ``device`` (the card when it is None)."""
        device = resolve_device(device)

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

    def transpose(self) -> "SpCOO":
        """(n, m) transpose: swap the coordinates and re-sort."""
        m, n = self.shape
        valid = self.mask()
        t = SpCOO(row=torch.where(valid, self.col, n).to(torch.int32),
                  col=torch.where(valid, self.row, m).to(torch.int32),
                  val=self.val, nnz=self.nnz, shape=(n, m))
        return sort_coo(t)

    def astype(self, dtype: torch.dtype) -> "SpCOO":
        return dataclasses.replace(self, val=self.val.to(dtype))

    def with_capacity(self, capacity: int) -> "SpCOO":
        """Grow the padding with (m, n, 0) sentinels, or cut the buffer (nnz
        saturates at the new capacity)."""
        m, n = self.shape
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            return SpCOO(row=self.row[:capacity], col=self.col[:capacity],
                         val=self.val[:capacity],
                         nnz=torch.clamp(self.nnz, max=capacity),
                         shape=self.shape)
        pad = capacity - cap
        dev = self.device
        return SpCOO(
            row=torch.cat([self.row, torch.full((pad,), m, dtype=torch.int32,
                                                device=dev)]),
            col=torch.cat([self.col, torch.full((pad,), n, dtype=torch.int32,
                                                device=dev)]),
            val=torch.cat([self.val, torch.zeros(pad, dtype=self.val.dtype,
                                                 device=dev)]),
            nnz=self.nnz, shape=self.shape)


def sort_coo(a: SpCOO) -> SpCOO:
    """Restore the (row, col) sorted invariant (stable, as ``lax.sort``)."""
    row, col, val = _sort_pairs(a.row, a.col, a.val)
    return dataclasses.replace(a, row=row, col=col, val=val)


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
    out_cap = row.shape[0] if out_capacity is None else out_capacity
    # Only the real entries fold (one host sync to cut them): every pad sent
    # to one dropped slot would serialise the fold's atomics on that slot.
    k = min(max(int(nvalid), 0), row.shape[0])
    row, col, val = row[:k], col[:k], val[:k]
    is_new = torch.ones(k, dtype=torch.bool, device=dev)
    is_new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
    seg = torch.cumsum(is_new, 0) - 1
    nnz_out = (torch.clamp(seg[-1] + 1, max=out_cap) if k else
               torch.zeros((), dtype=torch.int64, device=dev))
    # segments past out_cap land on a dropped slot at index out_cap
    seg_sc = torch.clamp(seg, max=out_cap)
    if sr.add_kind == "sum":
        out_val = torch.zeros(out_cap + 1, dtype=val.dtype, device=dev)
        out_val.index_add_(0, seg_sc, val)
    else:
        out_val = sr.zero(val.dtype).to(dev).repeat(out_cap + 1)
        out_val.scatter_reduce_(
            0, seg_sc, val, reduce="amin" if sr.add_kind == "min" else "amax")
    out_val = out_val[:out_cap]
    live = torch.arange(out_cap, device=dev) < nnz_out
    out_val = torch.where(live, out_val, torch.zeros_like(out_val))
    # every entry of a segment carries the same (row, col): the scatter is
    # deterministic whichever write lands
    out_row = torch.full((out_cap + 1,), m, dtype=torch.int32, device=dev)
    out_row.scatter_(0, seg_sc, row.to(torch.int32))
    out_col = torch.full((out_cap + 1,), n, dtype=torch.int32, device=dev)
    out_col.scatter_(0, seg_sc, col.to(torch.int32))
    return SpCOO(row=out_row[:out_cap], col=out_col[:out_cap], val=out_val,
                 nnz=nnz_out.to(torch.int64), shape=(int(m), int(n)))


def row_split(a: SpCOO, nsplits: int) -> list:
    """Split into ``nsplits`` row bands of ``ceil(m / nsplits)`` rows, rows
    rebased band-local.  As in the JAX package, a band's pads carry the
    band's row count and an empty band has shape (1, n)."""
    m, n = a.shape
    band = -(-m // nsplits)
    rp = a.row_ptr()
    idx = torch.arange(a.capacity, device=a.device)
    zero = torch.zeros((), dtype=a.val.dtype, device=a.device)
    out = []
    for s in range(nsplits):
        lo, hi = rp[min(s * band, m)], rp[min((s + 1) * band, m)]
        src = torch.clamp(lo + idx, max=a.capacity - 1)
        rows_here = min(band, m - s * band) if s * band < m else 0
        sel = idx < (hi - lo)
        out.append(SpCOO(
            row=torch.where(sel, a.row[src] - s * band,
                            rows_here).to(torch.int32),
            col=torch.where(sel, a.col[src], n).to(torch.int32),
            val=torch.where(sel, a.val[src], zero),
            nnz=(hi - lo).to(torch.int64),
            shape=(max(rows_here, 1), n)))
    return out


def row_concat(parts: list) -> SpCOO:
    """Inverse of :func:`row_split`: stack the bands' rows and re-sort."""
    n = parts[0].shape[1]
    total_m = sum(p.shape[0] for p in parts)
    rows, cols, vals = [], [], []
    off = 0
    for p in parts:
        valid = p.mask()
        rows.append(torch.where(valid, p.row + off, total_m).to(torch.int32))
        cols.append(torch.where(valid, p.col, n).to(torch.int32))
        vals.append(torch.where(valid, p.val, torch.zeros_like(p.val)))
        off += p.shape[0]
    row, col, val = _sort_pairs(torch.cat(rows), torch.cat(cols),
                                torch.cat(vals))
    nnz = sum(p.nnz for p in parts)
    return SpCOO(row=row, col=col, val=val, nnz=nnz.to(torch.int64),
                 shape=(total_m, n))


def sort_compress_packed(key: torch.Tensor, v: torch.Tensor, nvalid,
                         shape: Tuple[int, int], sr: Semiring = PLUS_TIMES,
                         out_capacity: int | None = None) -> SpCOO:
    """Sort a packed int32-key stream (``key = i*(n+1) + j``; pads must sort
    after every real key) and fold duplicates: the stable sort, then
    :func:`compress_sorted` on the unpacked pairs.  Slots past ``nnz`` are
    (m, n, 0), as the JAX package decodes its pad key ``(m+1)*(n+1) - 1``;
    ``nnz`` saturates at ``out_capacity``."""
    stride = shape[1] + 1
    key, order = torch.sort(key, stable=True)
    return compress_sorted(key // stride, key % stride, v[order], nvalid,
                           shape, sr=sr, out_capacity=out_capacity)


def sort_compress(i: torch.Tensor, j: torch.Tensor, v: torch.Tensor, nvalid,
                  shape: Tuple[int, int], sr: Semiring = PLUS_TIMES,
                  out_capacity: int | None = None) -> SpCOO:
    """Sort a sentinel-padded triple stream and fold duplicates — the ESC
    back-end.  Packed int32 keys when ``(m+1)*(n+1) < 2^31``, else a sort
    by the pair (i, j)."""
    m, n = shape
    out_cap = i.shape[0] if out_capacity is None else out_capacity
    stride = n + 1  # the sentinel column n packs without collision
    if (m + 1) * stride < (1 << 31):
        key = i.to(torch.int32) * stride + j.to(torch.int32)
        return sort_compress_packed(key, v, nvalid, shape, sr=sr,
                                    out_capacity=out_cap)
    i, j, v = _sort_pairs(i, j, v)
    return compress_sorted(i, j, v, nvalid, shape, sr=sr,
                           out_capacity=out_cap)


def merge(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES,
          out_capacity: int | None = None) -> SpCOO:
    """Merge two matrices of one shape, folding duplicates with the
    semiring add: concatenate, sort, compress."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    row, col, val = _sort_pairs(torch.cat([a.row, b.row]),
                                torch.cat([a.col, b.col]),
                                torch.cat([a.val, b.val]))
    out_cap = (out_capacity if out_capacity is not None
               else a.capacity + b.capacity)
    return compress_sorted(row, col, val, a.nnz + b.nnz, a.shape, sr=sr,
                           out_capacity=out_cap)
