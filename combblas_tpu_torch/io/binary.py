"""Binary matrix / vector I/O (port of ``combblas_tpu/io/binary.py``).

The counterpart of ``ParallelBinaryWrite`` (``SpParMat.cpp:620``) and the
vector ``ParallelWrite`` / ``ParallelRead`` (``FullyDistSpVec.cpp:1209,
1310``), in the JAX package's own format, byte for byte:

    little-endian magic b'CBTPU1\\0\\0', int64 m, n, nnz, dtype tag,
    then nnz int32 rows, nnz int32 cols, nnz values

(a vector: int64 length, nnz, tag, then int32 indices and values).
"""

from __future__ import annotations

import struct

import numpy as np

from combblas_tpu_torch.io.mtx import _live_host
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spvec import SpVec

__all__ = ["write_binary", "read_binary", "write_vec_binary",
           "read_vec_binary"]

_MAGIC = b"CBTPU1\x00\x00"
_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64, 4: np.bool_}
_DTAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_binary(path: str, a: SpCOO) -> None:
    row, col, val = _live_host(a)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqqq", a.shape[0], a.shape[1], row.size,
                            _DTAGS[val.dtype]))
        f.write(row.astype("<i4").tobytes())
        f.write(col.astype("<i4").tobytes())
        f.write(val.tobytes())


def _check_magic(f, path: str) -> None:
    if f.read(8) != _MAGIC:
        raise ValueError(f"bad magic in {path}")


def _values(f, tag: int, nnz: int) -> np.ndarray:
    dt = np.dtype(_DTYPES[tag])
    return np.frombuffer(f.read(dt.itemsize * nnz), dt)


def read_binary(path: str, capacity: int | None = None,
                device=None) -> SpCOO:
    """A binary matrix as a SpCOO on ``device`` (the card when None);
    entries are sorted, duplicates kept."""
    with open(path, "rb") as f:
        _check_magic(f, path)
        m, n, nnz, tag = struct.unpack("<qqqq", f.read(32))
        row = np.frombuffer(f.read(4 * nnz), "<i4")
        col = np.frombuffer(f.read(4 * nnz), "<i4")
        val = _values(f, tag, nnz)
    return SpCOO.from_arrays(row, col, val, (m, n), capacity=capacity,
                             sum_duplicates=False, device=device)


def write_vec_binary(path: str, v: SpVec) -> None:
    nnz = int(v.nnz)
    idx = v.idx[:nnz].cpu().numpy()
    val = v.val[:nnz].cpu().numpy()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqq", v.length, nnz, _DTAGS[val.dtype]))
        f.write(idx.astype("<i4").tobytes())
        f.write(val.tobytes())


def read_vec_binary(path: str, capacity: int | None = None,
                    device=None) -> SpVec:
    """A binary sparse vector as a SpVec on ``device`` (the card when
    None)."""
    with open(path, "rb") as f:
        _check_magic(f, path)
        length, nnz, tag = struct.unpack("<qqq", f.read(24))
        idx = np.frombuffer(f.read(4 * nnz), "<i4")
        val = _values(f, tag, nnz)
    return SpVec.from_arrays(idx, val, length, capacity=capacity,
                             device=device)
