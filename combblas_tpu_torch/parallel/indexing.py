"""Distributed SpRef / SpAsgn / matrix permutation on the block grid (port
of ``combblas_tpu/parallel/indexing.py``).

- :func:`dist_spref` is ``SpParMat::SubsRef_SR``: boolean selectors P and Q
  as DistSpMats and C = P·A·Q through ``summa_spgemm_auto``, so on the card
  its block products run the expansion and compress kernels (K1/K2 packed,
  K3/K4 wide).
- :func:`dist_spasgn` is ``SpParMat::SpAsgn``: the ri×ci block pruned,
  B embedded as Pᵀ·B·Qᵀ (two more SUMMA products), the two added.
- :func:`dist_permute` is ``RandPermute`` / ``RenameVertices``: every
  entry relabelled through the row and column maps and sent to its
  destination block (JAX's one ``all_to_all``), where each block sorts its
  (row, col) pairs and folds duplicates with the semiring
  (``compress_sorted``).  The port does that for every block at once: the
  live entries in (source block, slot) order, which is the order JAX's
  exchange delivers them in, one stable sort on (destination block, row,
  col) and one fold; the stacks equal JAX's slot for slot.

On a grid over several processes (a pod) every function here runs across
them: the selectors keep this process's triples (``from_coo_arrays``),
the products are the pod's SUMMA, and :func:`dist_permute` sends each
relabelled entry to the process that holds its destination block (one
``exchange.alltoallv``).  A process holds a run of whole blocks in raster
order (:meth:`ProcGrid.local_shape`), and it sends its entries in its
(block, slot) order; so the entries reach a destination in the global
(source block, slot) order, the one process's fold order, and a stable
sort on (destination block, row, col) folds duplicates as one process
does, bit for bit.  Index vectors and maps are host arrays (or tensors)
that every process holds whole.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _fold_runs,
    _live_entries,
    block_dims,
)
from combblas_tpu_torch.parallel.elementwise import _compact_blocks, dist_add
from combblas_tpu_torch.parallel.summa import summa_spgemm_auto
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring

__all__ = [
    "dist_selector",
    "dist_spref",
    "dist_prune_block",
    "dist_spasgn",
    "dist_permute",
]


def dist_selector(indices, n: int, grid, transpose: bool = False,
                  capacity: int | None = None) -> DistSpMat:
    """The distributed boolean extraction matrix: (k, n) with S[i,
    indices[i]] = 1, or its (n, k) transpose (the P / Q builders of
    ``SpParMat.cpp:2060-2130``), on the grid's device.  The default
    capacity is the fullest block's, over every process of a pod."""
    indices = np.asarray(indices, np.int64)
    k = indices.shape[0]
    rows = np.arange(k, dtype=np.int64)
    ones = np.ones(k, np.float32)
    if transpose:
        return DistSpMat.from_coo_arrays(indices, rows, ones, (n, k), grid,
                                         capacity=capacity)
    return DistSpMat.from_coo_arrays(rows, indices, ones, (k, n), grid,
                                     capacity=capacity)


def dist_spref(a: DistSpMat, ri, ci, sr: Semiring = PLUS_TIMES) -> DistSpMat:
    """A(ri, ci) = P·A·Q on the grid (``SpParMat.cpp:2028`` SubsRef_SR).
    Index vectors may repeat (matlab SpRef semantics)."""
    m, n = a.gshape
    p = dist_selector(ri, m, a.grid)
    q = dist_selector(ci, n, a.grid, transpose=True)
    pa = summa_spgemm_auto(p, a, sr)
    del p
    return summa_spgemm_auto(pa, q, sr)


def _space_masks(a: DistSpMat, ri, ci):
    """Row- and column-space membership masks (padded lengths)."""
    mb, nb = block_dims(a.gshape, a.grid)
    rm = np.zeros(a.grid.pr * mb, bool)
    cm = np.zeros(a.grid.pc * nb, bool)
    rm[np.asarray(ri, np.int64)] = True
    cm[np.asarray(ci, np.int64)] = True
    dev = a.row.device
    return torch.from_numpy(rm).to(dev), torch.from_numpy(cm).to(dev)


def dist_prune_block(a: DistSpMat, ri, ci) -> DistSpMat:
    """Remove every entry in rows ri × cols ci (``SpParMat::Prune(ri,
    ci)``): a membership mask per block, its kept entries compacted to the
    front; no communication."""
    rm, cm = _space_masks(a, ri, ci)
    mb, nb = block_dims(a.gshape, a.grid)
    r0, c0 = a.grid.origin()

    def keep(i, j, k):
        gi = ((r0 + i) * mb + a.row[i, j, :k].long()).clamp(
            max=rm.shape[0] - 1)
        gj = ((c0 + j) * nb + a.col[i, j, :k].long()).clamp(
            max=cm.shape[0] - 1)
        return ~(rm[gi] & cm[gj])

    return _compact_blocks(a, keep)


def dist_spasgn(a: DistSpMat, ri, ci, b: DistSpMat,
                sr: Semiring = PLUS_TIMES) -> DistSpMat:
    """A(ri, ci) = B (``SpParMat::SpAsgn``, ``SpParMat.cpp:2427``): prune
    the ri×ci block, embed B = Pᵀ·B·Qᵀ through transposed selectors (two
    SUMMA products, the reference's own formulation), then add."""
    m, n = a.gshape
    if (len(np.asarray(ri)), len(np.asarray(ci))) != tuple(b.gshape):
        raise ValueError(f"DIMMISMATCH: SpAsgn of a {b.gshape} operand at "
                         f"{len(ri)} x {len(ci)} indices")
    cleared = dist_prune_block(a, ri, ci)
    pt = dist_selector(ri, m, a.grid, transpose=True)   # (m, k1)
    qt = dist_selector(ci, n, a.grid)                   # (k2, n)
    ptb = summa_spgemm_auto(pt, b, sr)
    del pt
    emb = summa_spgemm_auto(ptb, qt, sr)
    del ptb
    return dist_add(cleared, emb,
                    out_capacity=cleared.capacity + emb.capacity)


def _space_map(x, length: int, dev) -> torch.Tensor:
    """A row or column map (host or device, int) as int64 on ``dev``, cut
    to ``length`` or padded with ``length`` (dropped)."""
    if isinstance(x, torch.Tensor):
        x = x.to(dev, torch.int64)
    else:
        x = torch.from_numpy(np.asarray(x).astype(np.int32)).to(
            dev, torch.int64)
    out = torch.full((length,), length, dtype=torch.int64, device=dev)
    k = min(x.shape[0], length)
    out[:k] = x[:k]
    return out


def _fold_dups(v: torch.Tensor, first: torch.Tensor,
               sr: Semiring) -> torch.Tensor:
    """The semiring sums of the runs of ``v`` that start where ``first``
    holds, each in entry order (JAX's segment reductions on the CPU)."""
    if sr.add_kind == "sum":
        return _fold_runs(v, first)
    seg = torch.cumsum(first, 0) - 1
    out = sr.zero(v.dtype).to(v.device).repeat(int(first.sum()))
    return out.scatter_reduce_(0, seg, v, "amin" if sr.add_kind == "min"
                               else "amax")


def dist_permute(a: DistSpMat, row_map, col_map=None,
                 sr: Semiring = PLUS_TIMES,
                 out_capacity: int | None = None) -> DistSpMat:
    """A'(row_map[i], col_map[j]) = A(i, j): relabel and one owner
    exchange (``MCL.cpp:497`` RandPermute, ``DistEdgeList.cpp:364``).

    ``row_map`` / ``col_map``: the row- and column-space maps (host arrays
    or tensors), cut to the padded lengths or padded with them; an entry
    whose map is negative or past the padded length is dropped.
    ``col_map`` defaults to ``row_map`` (a symmetric permutation of a
    square matrix).  A map that is not injective sends several entries to
    one place, where the semiring adds them.  The blocks keep ``a``'s
    capacity (or ``out_capacity``), doubled while a destination block
    receives more entries than that, as JAX retries (the fullest block of
    any process)."""
    grid = a.grid
    mb, nb = block_dims(a.gshape, grid)
    pc = grid.pc
    lr, lc = grid.local_shape()
    r0, c0 = grid.origin()
    nblk = lr * lc
    m_pad, n_pad = grid.pr * mb, pc * nb
    dev = a.row.device
    rm = _space_map(row_map, m_pad, dev)
    if col_map is None:
        if a.gshape[0] != a.gshape[1] or m_pad != n_pad:
            raise ValueError(f"a symmetric permutation needs a square "
                             f"matrix, got {a.gshape}")
        cm = rm
    else:
        cm = _space_map(col_map, n_pad, dev)
    bid, r, c, v = _live_entries(a)
    ni = rm[(r0 + bid // lc) * mb + r.long()]
    nj = cm[(c0 + bid % lc) * nb + c.long()]
    ok = (ni >= 0) & (ni < m_pad) & (nj >= 0) & (nj < n_pad)
    keep = torch.nonzero(ok).squeeze(1)
    ni, nj, v = ni[keep], nj[keep], v[keep]
    del bid, r, c, ok, keep
    bi, bj = ni // mb, nj // nb
    dest = bi * pc + bj                 # the global destination block
    lr_, lc_ = (ni - bi * mb).to(torch.int32), (nj - bj * nb).to(torch.int32)
    del ni, nj, bi, bj
    if grid.is_pod:     # each entry to its destination block's owner
        owner = dest // nblk
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=grid.nproc).tolist()
        del owner
        dest, lr_, lc_, v = exchange.alltoallv(
            [dest[order].to(torch.int32), lr_[order], lc_[order], v[order]],
            counts)
        del order
        dest = dest.long() - grid.rank * nblk
    key, order = torch.sort((dest * mb + lr_) * nb + lc_, stable=True)
    dest, lr_, lc_, v = dest[order], lr_[order], lc_[order], v[order]
    del order
    counts = exchange.gather_table(
        torch.bincount(dest, minlength=nblk).reshape(lr, lc), grid)
    cap = a.capacity if out_capacity is None else int(out_capacity)
    most = int(counts.max()) if counts.numel() else 0
    while most > cap:   # JAX's retry: a block received more than it holds
        cap *= 2
    first = torch.ones(key.shape[0], dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    del key
    vals = _fold_dups(v, first, sr) if v.numel() else v
    dest, lr_, lc_ = dest[first], lr_[first], lc_[first]
    nnz = torch.bincount(dest, minlength=nblk)
    pos = torch.arange(dest.shape[0], device=dev) - (
        torch.cumsum(nnz, 0) - nnz)[dest]
    row = torch.full((nblk, cap), mb, dtype=torch.int32, device=dev)
    col = torch.full((nblk, cap), nb, dtype=torch.int32, device=dev)
    val = torch.zeros((nblk, cap), dtype=a.val.dtype, device=dev)
    row[dest, pos] = lr_
    col[dest, pos] = lc_
    val[dest, pos] = vals
    return DistSpMat(row=row.reshape(lr, lc, cap),
                     col=col.reshape(lr, lc, cap),
                     val=val.reshape(lr, lc, cap),
                     nnz=exchange.gather_table(nnz.reshape(lr, lc), grid),
                     gshape=a.gshape, grid=grid)
