"""Block-streamed matrix write and read of a DistSpMat (port of
``combblas_tpu/io/parallel.py``): the ``ParallelWriteMM`` /
``ParallelBinaryWrite`` / ``ParallelReadMM`` counterparts
(``SpParMat.cpp:4120``, ``:620``, ``:3980``).

The reference writes one file cooperatively: every rank formats its own
tuples, an exscan of byte counts gives each rank its offset, and the
writes land disjointly.  The port does the same with the processes of the
grid: every process formats the blocks it holds, one at a time in raster
order, read from its block stack (the assembled matrix is never built);
the byte counts are all-gathered (``_allgather_host``, the identity in one
process); process 0 writes the header and sizes the file; after a barrier
(JAX's ``sync_global_devices``) every process ``pwrite``s its bytes at its
own offset.  The files are byte for byte those of one process.

Reading in one process parses the whole file on the host and buckets the
triples onto the grid.  Across processes the body is split into byte
ranges extended to line boundaries, each process parses its range, and
the tuples go to the processes that own their blocks in one all-to-all of
host tensors, in file order, so duplicates sum as in one process.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import torch

from combblas_tpu_torch.io.binary import _DTAGS, _MAGIC
from combblas_tpu_torch.io.mtx import read_mtx_arrays
from combblas_tpu_torch.ops.coo import _np_dtype
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    block_dims,
    live_counts,
)

__all__ = [
    "parallel_write_mtx",
    "parallel_write_binary",
    "parallel_read_mtx",
]

def _my_blocks(a: DistSpMat):
    """(i, j, row, col, val, nnz) of every block this process holds, in
    raster order, one block on the host at a time."""
    lc = a.grid.local_shape()[1]
    r0, c0 = a.grid.origin()
    for b, k in enumerate(live_counts(a)):
        i, j = divmod(b, lc)
        yield (r0 + i, c0 + j, a.row[i, j, :k].cpu().numpy(),
               a.col[i, j, :k].cpu().numpy(),
               a.val[i, j, :k].cpu().numpy(), k)


def _allgather_host(values: np.ndarray, grid) -> np.ndarray:
    """Small host arrays of every process of the grid, (nproc, ...)."""
    if not grid.is_pod:
        return values[None]
    return exchange.allgather_host(values)


def _create(path: str, head: bytes, nbytes: int, grid) -> None:
    """Process 0 writes ``head`` and sizes the file to ``nbytes``; then
    every process of the grid meets at a barrier."""
    if grid.rank == 0:
        with open(path, "wb") as f:
            f.write(head)
            f.truncate(nbytes)
    if grid.is_pod:
        exchange.barrier()


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
    sizes = _allgather_host(np.asarray([len(mine)], np.int64), a.grid)[:, 0]
    offset = len(header) + int(sizes[:a.grid.rank].sum())
    _create(path, header, len(header) + int(sizes.sum()), a.grid)
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
    flat = torch.clamp(a.nnz, max=a.capacity).reshape(-1).cpu().numpy()
    total = int(flat.sum())
    dt = np.dtype(_np_dtype(a.val.dtype))
    head = _MAGIC + struct.pack("<qqqq", m, n, total, _DTAGS[dt])
    h = len(head)
    starts = np.concatenate([[0], np.cumsum(flat)[:-1]]).reshape(
        a.grid.pr, a.grid.pc)
    _create(path, head, h + total * (4 + 4 + dt.itemsize), a.grid)
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


def _my_range(path: str, grid):
    """This process's share of a ``general`` Matrix Market body: the lines
    whose first byte lies in its byte range of the body (a line straddling
    the range's end is finished here, one straddling its start belongs to
    the process before), parsed.  Returns (row, col, val) 0-based and the
    shape."""
    with open(path, "rb") as f:
        first = f.readline().decode()
        header = first.strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket" \
                or header[2] != "coordinate":
            raise NotImplementedError(
                f"{path}: a cooperative read across processes takes a "
                "MatrixMarket coordinate file (ROADMAP item 1.8)")
        if header[4] != "general":
            raise NotImplementedError(
                f"{path}: a {header[4]} file across processes is not "
                "ported yet (ROADMAP item 1.8)")
        line = f.readline()
        while line.startswith(b"%") or not line.strip():
            line = f.readline()
        m, n, _total = (int(t) for t in line.split()[:3])
        body = f.tell()
        end = f.seek(0, 2)
        span = end - body
        lo = body + grid.rank * span // grid.nproc
        hi = body + (grid.rank + 1) * span // grid.nproc
        f.seek(lo - 1)
        f.readline()          # the line in progress is the previous one's
        lo = f.tell()
        data = f.read(max(hi - lo, 0))
        if data and not data.endswith(b"\n"):
            data += f.readline()
    ncol = 2 if header[3] == "pattern" else 3
    arr = np.fromstring(data.decode(), dtype=np.float64, sep=" ") \
        if data.strip() else np.zeros(0)
    arr = arr.reshape(-1, ncol)
    row = arr[:, 0].astype(np.int64) - 1
    col = arr[:, 1].astype(np.int64) - 1
    val = (arr[:, 2].astype(np.float32) if ncol == 3
           else np.ones(row.shape[0], np.float32))
    return row, col, val, (m, n)


def parallel_read_mtx(path: str, grid, capacity: int | None = None
                      ) -> DistSpMat:
    """Matrix Market read onto the grid (``ParallelReadMM``,
    ``SpParMat.cpp:3980``).  One process: the whole file parsed on the
    host (by the native scanner when built), its triples bucketed to their
    blocks on the grid's device.  Across processes: each parses its byte
    range and the triples go to their blocks' owners (one all-to-all of
    host tensors), which bucket them."""
    if not grid.is_pod:
        row, col, val, shape = read_mtx_arrays(path)
        return DistSpMat.from_coo_arrays(row, col, val, shape, grid,
                                         capacity=capacity)
    row, col, val, shape = _my_range(path, grid)
    mb, nb = block_dims(shape, grid)
    owner = (row // mb * grid.pc + col // nb) // (
        grid.pr * grid.pc // grid.nproc)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=grid.nproc)
    got = exchange.alltoallv(
        [torch.from_numpy(x[order]) for x in (row, col, val)], counts)
    row, col, val = (t.numpy() for t in got)
    return DistSpMat.from_coo_arrays(row, col, val, shape, grid,
                                     capacity=capacity)
