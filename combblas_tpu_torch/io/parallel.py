"""Block-streamed matrix write and read of a DistSpMat (port of
``combblas_tpu/io/parallel.py``): the ``ParallelWriteMM`` /
``ParallelBinaryWrite`` / ``ParallelReadMM`` counterparts
(``SpParMat.cpp:4120``, ``:620``, ``:3980``).

The reference writes one file cooperatively: every rank formats its own
tuples, an exscan of byte counts gives each rank its offset, and the
writes land disjointly.  The port runs in one process, which holds every
block: the blocks stream to the file one at a time in raster order, read
from the block stack (the assembled matrix is never built), and the
byte-count exchange ``_allgather_host`` is the identity.  Reading parses
the whole file on the host and buckets the triples onto the grid.  The
multi-process exchange waits for blocks on several cards.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from combblas_tpu_torch.io.binary import _DTAGS, _MAGIC
from combblas_tpu_torch.io.mtx import read_mtx_arrays
from combblas_tpu_torch.ops.coo import _np_dtype
from combblas_tpu_torch.parallel.dist import DistSpMat, live_counts

__all__ = [
    "parallel_write_mtx",
    "parallel_write_binary",
    "parallel_read_mtx",
]

#: This process's rank among the writers (one process).
_RANK = 0


def _my_blocks(a: DistSpMat):
    """(i, j, row, col, val, nnz) of every block in raster order, one block
    on the host at a time."""
    pc = a.grid.pc
    for b, k in enumerate(live_counts(a)):
        i, j = divmod(b, pc)
        yield (i, j, a.row[i, j, :k].cpu().numpy(),
               a.col[i, j, :k].cpu().numpy(),
               a.val[i, j, :k].cpu().numpy(), k)


def _allgather_host(values: np.ndarray) -> np.ndarray:
    """The byte counts of every process, (nprocs, ...): one process."""
    return values[None]


def parallel_write_mtx(path: str, a: DistSpMat, comment: str = "") -> None:
    """Matrix Market write (``ParallelWriteMM``, ``SpParMat.cpp:4120``):
    the blocks' tuples, 1-based global coordinates, stream to the file."""
    mb, nb = a.block_shape()
    m, n = a.gshape
    total = int(a.nnz.sum())
    header = "%%MatrixMarket matrix coordinate real general\n"
    if comment:
        header += "".join(f"%{line}\n" for line in comment.splitlines())
    header = (header + f"{m} {n} {total}\n").encode()
    chunks = []
    for i, j, r, c, v, _k in _my_blocks(a):
        buf = io.StringIO()
        np.savetxt(buf, np.column_stack([r.astype(np.int64) + i * mb + 1,
                                         c.astype(np.int64) + j * nb + 1,
                                         v.astype(np.float64)]),
                   fmt="%d %d %.9g")
        chunks.append(buf.getvalue().encode())
    mine = b"".join(chunks)
    sizes = _allgather_host(np.asarray([len(mine)], np.int64))[:, 0]
    offset = len(header) + int(sizes[:_RANK].sum())
    with open(path, "wb") as f:
        f.write(header)
        f.truncate(len(header) + int(sizes.sum()))
    fd = os.open(path, os.O_WRONLY)
    try:
        os.pwrite(fd, mine, offset)
    finally:
        os.close(fd)


def parallel_write_binary(path: str, a: DistSpMat) -> None:
    """Binary write (``ParallelBinaryWrite``, ``SpParMat.cpp:620``) in
    ``io/binary.py``'s format: fixed-size records, so each block's offset
    is a prefix sum of the block nnz; rows, columns and values each laid
    out in block-raster order."""
    mb, nb = a.block_shape()
    m, n = a.gshape
    flat = np.asarray(live_counts(a), np.int64)
    total = int(flat.sum())
    dt = np.dtype(_np_dtype(a.val.dtype))
    head = _MAGIC + struct.pack("<qqqq", m, n, total, _DTAGS[dt])
    h = len(head)
    starts = np.concatenate([[0], np.cumsum(flat)[:-1]]).reshape(
        a.grid.pr, a.grid.pc)
    with open(path, "wb") as f:
        f.write(head)
        f.truncate(h + total * (4 + 4 + dt.itemsize))
    fd = os.open(path, os.O_WRONLY)
    try:
        for i, j, r, c, v, _k in _my_blocks(a):
            e = int(starts[i, j])
            os.pwrite(fd, (r.astype("<i4") + i * mb).tobytes(), h + 4 * e)
            os.pwrite(fd, (c.astype("<i4") + j * nb).tobytes(),
                      h + 4 * total + 4 * e)
            os.pwrite(fd, v.astype(dt).tobytes(),
                      h + 8 * total + dt.itemsize * e)
    finally:
        os.close(fd)


def parallel_read_mtx(path: str, grid, capacity: int | None = None
                      ) -> DistSpMat:
    """Matrix Market read onto the grid (``ParallelReadMM``,
    ``SpParMat.cpp:3980``), one process: the whole file parsed on the host
    (by the native scanner when built), its triples bucketed to their
    blocks on the grid's device."""
    row, col, val, shape = read_mtx_arrays(path)
    return DistSpMat.from_coo_arrays(row, col, val, shape, grid,
                                     capacity=capacity)
