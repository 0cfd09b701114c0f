"""Staged SUMMA, the memory-bounded distributed SpGEMM (the
``summa_spgemm_staged`` / ``calculate_phases`` part of
``combblas_tpu/parallel/memefficient.py``).

Stage s hands block (i, j) the blocks A(i, s) and B(s, j) (the JAX masked
``psum`` broadcast becomes indexing the source block), multiplies them into
a stage buffer and merges that into the block's running accumulator.  Peak
memory per block: one block pair's expansion plus two outputs, against the
all-gather SUMMA's whole-panel expansion.  ``mem_efficient_spgemm`` and
``block_spgemm`` need the distributed elementwise ops and SpMV, which are
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO, merge
from combblas_tpu_torch.parallel.dist import DistSpMat, local_block
from combblas_tpu_torch.parallel.summa import (
    _check_operands,
    _local_multiply,
    _run_blocks,
    summa_flops,
)
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["summa_spgemm_staged", "calculate_phases"]


def _bcast(m: DistSpMat, axis: str, i: int, j: int, src: int) -> SpCOO:
    """What block (i, j) receives from the block at index ``src`` along
    ``axis``: A(i, src) along 'c', B(src, j) along 'r'."""
    return local_block(m, i, src) if axis == "c" else local_block(m, src, j)


def _staged_block(a: DistSpMat, b: DistSpMat, i: int, j: int, *,
                  sr: Semiring, stage_flops_cap: int, out_capacity: int,
                  impl: str, chunk_cap: int) -> SpCOO:
    """Block (i, j) of C over pc stages (the JAX ``_staged_local``)."""
    mb, nb = a.block_shape()[0], b.block_shape()[1]
    acc = SpCOO.empty((mb, nb), capacity=out_capacity, dtype=a.val.dtype,
                      device=a.row.device)
    for s in range(a.grid.pc):
        cs = _local_multiply(_bcast(a, "c", i, j, s), _bcast(b, "r", i, j, s),
                             sr, impl=impl, flops_cap=stage_flops_cap,
                             out_capacity=stage_flops_cap, chunk_cap=chunk_cap)
        acc = merge(acc, cs, sr, out_capacity=out_capacity)
    return acc


def summa_spgemm_staged(a: DistSpMat, b: DistSpMat, sr: Semiring = PLUS_TIMES,
                        *, stage_flops_cap: int, out_capacity: int,
                        impl: str = "xla", chunk_cap: int = 0) -> DistSpMat:
    """Stage-looped SUMMA with per-stage block broadcasts and an
    incremental merge (``Mult_AnXBn_Synch``).  ``stage_flops_cap`` bounds
    one stage's products; ``impl`` / ``chunk_cap`` select the stage's local
    route as in :func:`combblas_tpu_torch.parallel.summa.summa_spgemm`.  C's
    blocks have ``out_capacity`` slots."""
    _check_operands(a, b)
    row, col, val, nnz = _run_blocks(
        (a.grid.pr, a.grid.pc),
        lambda i, j: _staged_block(a, b, i, j, sr=sr,
                                   stage_flops_cap=stage_flops_cap,
                                   out_capacity=out_capacity, impl=impl,
                                   chunk_cap=chunk_cap))
    return DistSpMat(row=row, col=col, val=val, nnz=nnz,
                     gshape=(a.gshape[0], b.gshape[1]), grid=a.grid)


def calculate_phases(a: DistSpMat, b: DistSpMat, per_device_mem_bytes: float,
                     bytes_per_product: int = 24,
                     est_c_nnz: float | None = None) -> int:
    """Phase count from the memory model (``CalculateNumberOfPhases``): the
    smallest p such that a phase's expansion, plus the accumulated output
    when ``est_c_nnz`` is given (12 bytes an entry, spread over the grid),
    fits ``per_device_mem_bytes``."""
    need = int(summa_flops(a, b).max()) * bytes_per_product
    if est_c_nnz is not None:
        per_dev_out = est_c_nnz * 12 / max(a.grid.pr * a.grid.pc, 1)
        avail = max(per_device_mem_bytes - per_dev_out,
                    per_device_mem_bytes * 0.25)
        return max(1, int(np.ceil(need / max(avail, 1.0))))
    return max(1, int(np.ceil(need / max(per_device_mem_bytes, 1.0))))
