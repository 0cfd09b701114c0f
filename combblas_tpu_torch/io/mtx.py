"""Matrix Market I/O (port of ``combblas_tpu/io/mtx.py``).

The counterpart of the reference's ``mmio.c`` and ``SpParMat::ParallelReadMM``
(``SpParMat.cpp:3980``) / ``ParallelWriteMM`` (``SpParMat.cpp:4120``).
Reading is a host parse, then the triples go to the device.  The parse uses
the repo's C++ scanner (``csrc/mmparse.cpp``, a plain C ABI loaded through
``ctypes``) when ``csrc/libmmparse.so`` has been built, and numpy
otherwise; both are host parsers.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from combblas_tpu_torch.ops.coo import SpCOO

__all__ = ["read_mtx", "read_mtx_arrays", "write_mtx"]

_NATIVE: Optional[ctypes.CDLL] = None
_NATIVE_TRIED = False


def _load_native(path: str) -> ctypes.CDLL:
    """``ctypes`` binding of a built ``mmparse`` library."""
    lib = ctypes.CDLL(path)
    lib.mm_parse.restype = ctypes.c_longlong
    lib.mm_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # m
        ctypes.POINTER(ctypes.c_longlong),  # n
        ctypes.POINTER(ctypes.c_longlong),  # nnz (with symmetric halves)
        ctypes.POINTER(ctypes.c_int),       # flags: 1 pattern, 2 symmetric
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float32),
        ctypes.c_longlong,                  # capacity of the out arrays
    ]
    lib.mm_count.restype = ctypes.c_longlong
    lib.mm_count.argtypes = [ctypes.c_char_p]
    return lib


def _native_lib() -> Optional[ctypes.CDLL]:
    """The C++ parser, if ``csrc/libmmparse.so`` has been built."""
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cand = os.path.join(here, "csrc", "libmmparse.so")
        if os.path.exists(cand):
            _NATIVE = _load_native(cand)
    return _NATIVE


def _read_native(lib, path: str):
    cap = int(lib.mm_count(path.encode()))
    if cap < 0:
        return None
    m, n, nnz = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    flags = ctypes.c_int()
    row = np.empty(max(cap, 1), np.int32)
    col = np.empty(max(cap, 1), np.int32)
    val = np.empty(max(cap, 1), np.float32)
    got = int(lib.mm_parse(path.encode(), ctypes.byref(m), ctypes.byref(n),
                           ctypes.byref(nnz), ctypes.byref(flags), row, col,
                           val, cap))
    if got < 0:
        return None
    return row[:got], col[:got], val[:got], (m.value, n.value)


def read_mtx_arrays(path: str):
    """Parse a Matrix Market coordinate file to host numpy (row, col, val,
    shape): ``general`` / ``symmetric`` / ``skew-symmetric`` / ``hermitian``
    symmetry, ``pattern`` / ``real`` / ``integer`` fields, 1-based to
    0-based (``mmio.c`` semantics), and the headerless "m n nnz" triple
    files the reference's ``ReadDistribute`` accepts."""
    lib = _native_lib()
    if lib is not None:
        got = _read_native(lib, path)
        if got is not None:
            return got
    return _read_mtx_numpy(path)


def _triples(f, nnz: int) -> np.ndarray:
    return np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))


def _read_mtx_numpy(path: str):
    with open(path, "rb") as f:
        first = f.readline().decode()
        header = first.strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            try:
                m, n, nnz = (int(t) for t in first.split())
            except ValueError:
                raise ValueError(f"not a MatrixMarket file: {path}")
            data = _triples(f, nnz)
            row = data[:, 0].astype(np.int32) - 1
            col = data[:, 1].astype(np.int32) - 1
            val = (data[:, 2].astype(np.float32) if data.shape[1] > 2
                   else np.ones(row.shape[0], np.float32))
            return row, col, val, (m, n)
        _, _obj, fmt, field, symmetry = header[:5]
        if fmt != "coordinate":
            raise ValueError("only coordinate format supported")
        line = f.readline().decode()
        while line.startswith("%") or not line.strip():
            line = f.readline().decode()
        parts = line.split()
        m, n, nnz = int(parts[0]), int(parts[1]), int(parts[2])
        data = _triples(f, nnz)
    if nnz and data.shape[0] != nnz:
        raise ValueError(f"expected {nnz} entries, got {data.shape[0]}")
    row = data[:, 0].astype(np.int32) - 1
    col = data[:, 1].astype(np.int32) - 1
    if field == "pattern" or data.shape[1] < 3:
        val = np.ones(row.shape[0], np.float32)
    else:
        val = data[:, 2].astype(np.float32)
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = row != col
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        row, col = (np.concatenate([row, col[off]]),
                    np.concatenate([col, row[off]]))
        val = np.concatenate([val, sign * val[off]])
    return row, col, val, (m, n)


def read_mtx(path: str, capacity: int | None = None, dtype=None,
             device=None) -> SpCOO:
    """A Matrix Market file as a SpCOO on ``device`` (the card when
    None)."""
    row, col, val, shape = read_mtx_arrays(path)
    return SpCOO.from_arrays(row, col, val, shape, capacity=capacity,
                             dtype=dtype, device=device)


def _live_host(a: SpCOO):
    """The live (row, col, val) of ``a`` as host numpy arrays."""
    row, col, val, nnz, _ = a.to_numpy()
    return row[:nnz], col[:nnz], val[:nnz]


def write_mtx(path: str, a: SpCOO, comment: str = "") -> None:
    """Write a SpCOO as 1-based Matrix Market coordinate real general
    (``ParallelWriteMM``'s format, ``SpParMat.cpp:4120``)."""
    row, col, val = _live_host(a)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            f.write(f"%{comment}\n")
        f.write(f"{a.shape[0]}\t{a.shape[1]}\t{row.size}\n")
        for r, c, v in zip(row + 1, col + 1, val):
            f.write(f"{r}\t{c}\t{v:.9g}\n")
