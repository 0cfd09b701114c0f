"""Memory-bounded distributed SpGEMM: staged SUMMA and the phased (MCL)
path (port of ``combblas_tpu/parallel/memefficient.py``).

- :func:`summa_spgemm_staged`: stage s hands block (i, j) the blocks
  A(i, s) and B(s, j) (the JAX masked ``psum`` broadcast becomes indexing
  the source block), multiplies them into a stage buffer and merges that
  into the block's running accumulator.  Peak memory per block: one block
  pair's expansion plus two outputs, against the all-gather SUMMA's
  whole-panel expansion.
- :func:`mem_efficient_spgemm` (``MemEfficientSpGEMM``): B in column slabs,
  each physically repacked (``ColSplit``), multiplied with the whole A by
  :func:`combblas_tpu_torch.parallel.summa.summa_spgemm` on the route
  ``summa_impl_auto`` picks (the expansion and compress kernels for
  float32 values), pruned by ``phase_hook`` before the next slab starts,
  and summed with ``dist_add``.
- :func:`block_spgemm` (``BlockSpGEMM``): C one (row strip, column strip)
  block at a time.

On a pod (a grid over several processes) the staged SUMMA takes the blocks
A(i, s) and B(s, j) of its block rows and columns from their owners once a
call (``summa._panel_stacks``, as the all-gather SUMMA does); the slab
counts, and so every slab's capacity, are the whole table in every
process; the phase count reads global quantities only (``summa_flops``,
the sampling estimate summed over the processes).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from combblas_tpu_torch.ops.coo import SpCOO, merge
from combblas_tpu_torch.ops.spgemm import round_capacity_frac
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    block_dims,
    live_counts,
)
from combblas_tpu_torch.parallel.elementwise import _compact_blocks, dist_add
from combblas_tpu_torch.parallel.spmv import est_nnz_spgemm_sampling
from combblas_tpu_torch.parallel.summa import (
    _check_operands,
    _local_multiply,
    _layer,
    _panel_stacks,
    _run_blocks,
    summa_bounds,
    summa_chunk_bound,
    summa_flops,
    summa_impl_auto,
    summa_spgemm,
    summa_spgemm_auto,
)
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = ["summa_spgemm_staged", "mem_efficient_spgemm",
           "calculate_phases", "block_spgemm"]


def _stage_block(stack, i: int, j: int, shape) -> SpCOO:
    """Block (i, j) of a layer of a :func:`summa._panel_stacks` stack as an
    SpCOO."""
    r, c, v, n = stack
    return SpCOO(row=r[i, j], col=c[i, j], val=v[i, j], nnz=n[i, j],
                 shape=shape)


def _staged_block(a: DistSpMat, b: DistSpMat, i: int, j: int, stacks, *,
                  sr: Semiring, stage_flops_cap: int, out_capacity: int,
                  impl: str, chunk_cap: int) -> SpCOO:
    """Block (i, j) of C, counted from this process's first block, over pc
    stages (the JAX ``_staged_local``): stage s receives A(i, s) (the
    broadcast along 'c') and B(s, j) (along 'r') from ``stacks``."""
    mb, kb = a.block_shape()
    nb = b.block_shape()[1]
    acc = SpCOO.empty((mb, nb), capacity=out_capacity, dtype=a.val.dtype,
                      device=a.row.device)
    sa, sb = stacks
    for s in range(a.grid.pc):
        cs = _local_multiply(_stage_block(sa, i, s, (mb, kb)),
                             _stage_block(sb, s, j, (kb, nb)),
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
    stacks = _layer(_panel_stacks(a, b), 0)
    row, col, val, nnz = _run_blocks(
        a.grid.local_shape(),
        lambda i, j: _staged_block(a, b, i, j, stacks, sr=sr,
                                   stage_flops_cap=stage_flops_cap,
                                   out_capacity=out_capacity, impl=impl,
                                   chunk_cap=chunk_cap))
    return DistSpMat(row=row, col=col, val=val,
                     nnz=exchange.gather_table(nnz, a.grid),
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


def _slab_counts(m: DistSpMat, coord: str, bounds) -> np.ndarray:
    """counts[p, i, j]: block (i, j)'s live entries whose local ``coord``
    ('row' or 'col') lies in [bounds[p], bounds[p+1]), as host int64: the
    whole table in every process of a pod."""
    lr, lc = m.grid.local_shape()
    nph = len(bounds) - 1
    x = m.row if coord == "row" else m.col
    edges = torch.as_tensor(np.asarray(bounds[1:-1]), dtype=torch.int32,
                            device=x.device)
    out = torch.zeros((lr * lc, nph), dtype=torch.int64, device=x.device)
    for b, k in enumerate(live_counts(m)):
        i, j = divmod(b, lc)
        live = x[i, j, :k]
        inside = (live >= int(bounds[0])) & (live < int(bounds[-1]))
        ph = torch.bucketize(live[inside], edges, right=True)
        out[b] = torch.bincount(ph, minlength=nph)[:nph]
    table = exchange.gather_table(out.reshape(lr, lc, nph), m.grid)
    return table.permute(2, 0, 1).cpu().numpy()


def _col_slab_counts(b: DistSpMat, bounds) -> np.ndarray:
    """Per-(phase, block) slab entry counts for column-slab phasing:
    counts[p, i, j] = nnz of block (i, j) with column in [bounds[p],
    bounds[p+1]); read over each block's live entries only."""
    return _slab_counts(b, "col", bounds)


def _row_slab_counts(a: DistSpMat, bounds) -> np.ndarray:
    """The row-direction twin of :func:`_col_slab_counts`."""
    return _slab_counts(a, "row", bounds)


def _slab(m: DistSpMat, coord: str, lo: int, hi: int,
          slab_cap: int | None) -> DistSpMat:
    """The entries of every block whose local ``coord`` lies in [lo, hi),
    at the block's front ((row, col) sorted, as every block's entries
    are), ``(mb, nb, 0)`` pads behind; the blocks repacked to ``slab_cap``
    slots when it is below the capacity (nnz saturating there), else the
    capacity is kept."""
    x = m.row if coord == "row" else m.col
    cap = slab_cap if slab_cap is not None and slab_cap < m.capacity \
        else None
    return _compact_blocks(m, lambda i, j, k: (x[i, j, :k] >= lo)
                           & (x[i, j, :k] < hi), out_capacity=cap)


def _col_slab(b: DistSpMat, lo: int, hi: int,
              slab_cap: int | None = None) -> DistSpMat:
    """B's block-local columns [lo, hi), physically repacked to
    ``slab_cap`` entries a block (``ColSplit`` splits storage, so a phase's
    panel moves about 1/phases of B); without ``slab_cap`` the capacity is
    kept."""
    return _slab(b, "col", lo, hi, slab_cap)


def _row_slab(a: DistSpMat, lo: int, hi: int,
              slab_cap: int | None = None) -> DistSpMat:
    """A's block-local rows [lo, hi), physically repacked: the row-wise
    twin of :func:`_col_slab` (``BlockSplit``'s row direction)."""
    return _slab(a, "row", lo, hi, slab_cap)


def _slab_cap(counts: np.ndarray, capacity: int) -> int:
    """One slab's block capacity: its fullest block, rounded to a
    1/8-power-of-two step, at most the matrix's capacity."""
    return min(round_capacity_frac(max(int(counts.max()), 8)), capacity)


def mem_efficient_spgemm(a: DistSpMat, b: DistSpMat,
                         sr: Semiring = PLUS_TIMES,
                         phases: int | None = None,
                         per_device_mem_bytes: float = 2e9,
                         phase_hook: Callable[[DistSpMat], DistSpMat]
                         | None = None,
                         out_capacity: int | None = None,
                         impl: str | None = None) -> DistSpMat:
    """Phased SpGEMM over column slabs of B (``MemEfficientSpGEMM``).
    ``phase_hook`` runs on each phase's slab product before it is summed
    in (MCL passes its prune there).  Without ``phases`` the count comes
    from :func:`calculate_phases` on the sampling estimate of nnz(C), drawn
    from a generator seeded 0 on the matrices' device (JAX:
    ``PRNGKey(0)``).  ``impl`` (default ``summa_impl_auto``) is the local
    route of every phase's SUMMA."""
    _mb, nb = block_dims(b.gshape, b.grid)
    if phases is None:
        gen = torch.Generator(device=a.row.device).manual_seed(0)
        est_c = est_nnz_spgemm_sampling(a, b, gen)
        phases = calculate_phases(a, b, per_device_mem_bytes,
                                  est_c_nnz=est_c)
    phases = min(phases, nb)
    slab = -(-nb // phases)
    bounds = np.minimum(np.arange(phases + 1, dtype=np.int64) * slab, nb)
    counts = _col_slab_counts(b, bounds)
    if impl is None:
        impl = summa_impl_auto(a, b)
    acc = None
    for p in range(phases):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if lo >= hi:
            break
        bp = _col_slab(b, lo, hi, _slab_cap(counts[p], b.capacity))
        fc, oc = summa_bounds(a, bp)
        chunk_cap = summa_chunk_bound(a, bp, fc) if impl != "xla" else 0
        cp = summa_spgemm(a, bp, sr, flops_cap=fc, out_capacity=oc,
                          impl=impl, chunk_cap=chunk_cap)
        del bp
        if phase_hook is not None:
            cp = phase_hook(cp)
        acc = cp if acc is None else dist_add(
            acc, cp, out_capacity=out_capacity or (acc.capacity + cp.capacity))
    return acc


def block_spgemm(a: DistSpMat, b: DistSpMat, br: int, bc: int,
                 sr: Semiring = PLUS_TIMES):
    """C one block at a time (``BlockSpGEMM``): yields ``((i, j), C_ij)``
    for the br x bc grid of C blocks, C_ij the product of A's i-th row strip
    and B's j-th column strip, through ``summa_spgemm_auto``.  Strips are
    block-local ranges (every block splits its own rows br ways and its
    columns bc ways), so C_ij rides the whole grid with only its strip
    populated."""
    mb, _ = block_dims(a.gshape, a.grid)
    _, nb = block_dims(b.gshape, b.grid)
    rs, cs = -(-mb // br), -(-nb // bc)
    rbounds = np.minimum(np.arange(br + 1, dtype=np.int64) * rs, mb)
    cbounds = np.minimum(np.arange(bc + 1, dtype=np.int64) * cs, nb)
    rcounts = _row_slab_counts(a, rbounds)
    ccounts = _col_slab_counts(b, cbounds)
    for i in range(br):
        rlo, rhi = int(rbounds[i]), int(rbounds[i + 1])
        if rlo >= rhi:
            continue
        ap = _row_slab(a, rlo, rhi, _slab_cap(rcounts[i], a.capacity))
        for j in range(bc):
            clo, chi = int(cbounds[j]), int(cbounds[j + 1])
            if clo >= chi:
                continue
            bp = _col_slab(b, clo, chi, _slab_cap(ccounts[j], b.capacity))
            yield (i, j), summa_spgemm_auto(ap, bp, sr)
