"""Distributed SpMV / SpMSpV over the block grid (port of
``combblas_tpu/parallel/spmv.py``).

Vectors keep the JAX package's FullyDist layout: one flat tensor of the
padded global length on the grid's device.  Under JAX, device (i, j)
gathers its block column's slice of x over mesh axis 'r', multiplies its
block, and the partial results meet in a reduce-scatter over 'c'.  Here the
per-block bodies run as one batched pass over every block's live entries,
block (i, j)'s segments offset by ``(i*pc + j)`` times the block length, so
the partials are a (pr, pc, mb) tensor; :func:`_axis_reduce_scatter` then
reduces it over the mesh axis and hands block (i, j) chunk j, as the
collective does.  Read in ``P(('r','c'))`` order (row space) or
``P(('c','r'))`` order (column space), the chunks are the padded vector in
natural index order: block (i, j)'s slice of a row-space vector starts at
``i*mb + j*mb/pc``.  Padded lengths are JAX's: ``pc*nb`` in and ``pr*mb``
out for ``A x``, the reverse for ``A^T x``.

On a grid spread over several processes every vector, row or column space,
is this process's contiguous slice of the natural order
(:meth:`ProcGrid.vec_range`, JAX's ``P(('r','c'))`` layout of the
process's blocks; JAX's strided ``P(('c','r'))`` layout is not kept).  A
process gathers the part of x its blocks read
(:func:`parallel.exchange.gather_range`; nothing moves where its own slice
is that part), folds its blocks' products into the part of y they cover,
and the fan-in (:func:`parallel.exchange.reduce_to_owners`) reduces every
slot over the processes that cover it, with the semiring add, onto the
process that holds it.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.ops.spmv import _segment_reduce
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.dist import (
    DistSpMat,
    _live_entries,
    block_dims,
    col_vec_len,
)
from combblas_tpu_torch.semiring import (
    MAX_FIRST,
    MIN_SECOND,
    PLUS_TIMES,
    Semiring,
)

__all__ = ["dist_spmv", "dist_spmsv_masked", "dist_bfs_pull_masked",
           "est_nnz_spgemm_sampling"]

_DIMS = {"r": 0, "c": 1}


def _axis_reduce(x: torch.Tensor, axis: str, sr: Semiring) -> torch.Tensor:
    """psum / pmin / pmax over mesh axis ``axis`` of per-block values
    ``x`` (pr, pc, ...): every block of the axis gets the reduction."""
    d = _DIMS[axis]
    if sr.add_kind == "sum":
        red = x.sum(d, keepdim=True, dtype=x.dtype)
    elif sr.add_kind == "min":
        red = x.amin(d, keepdim=True)
    else:
        red = x.amax(d, keepdim=True)
    return red.expand_as(x)


def _axis_reduce_scatter(x: torch.Tensor, axis: str,
                         sr: Semiring) -> torch.Tensor:
    """reduce_scatter with the semiring add of per-block vectors ``x``
    (pr, pc, L): the reduction over mesh axis ``axis``, of which the block
    at index ``idx`` on that axis keeps chunk ``idx`` (length L / axis
    size), as ``psum_scatter(tiled=True)`` and JAX's min/max fallback (a
    full reduce, then the slice) do.  Returns (pr, pc, L / axis size)."""
    d = _DIMS[axis]
    n_ax = x.shape[d]
    red = _axis_reduce(x, axis, sr)
    chunks = red.reshape(x.shape[0], x.shape[1], n_ax, -1)
    idx = torch.arange(n_ax, device=x.device)
    if d == 0:
        return chunks[idx, :, idx]
    return chunks[:, idx, idx]


def _row_space(y: torch.Tensor) -> torch.Tensor:
    """(pr, pc, chunk) per-block slices in ``P(('r','c'))`` order, flat."""
    return y.reshape(-1)


def _col_space(y: torch.Tensor) -> torch.Tensor:
    """(pr, pc, chunk) per-block slices in ``P(('c','r'))`` order, flat."""
    return y.transpose(0, 1).reshape(-1)


def _padded(x: torch.Tensor, length: int, dtype=None) -> torch.Tensor:
    """x cut or zero-padded to ``length`` (JAX: ``zeros().at[:k].set``)."""
    k = min(x.shape[0], length)
    out = torch.zeros(length, dtype=dtype or x.dtype, device=x.device)
    out[:k] = x[:k]
    return out


def _sum_ascends(sr: Semiring, seg: torch.Tensor) -> bool:
    """Whether ``sr`` sums and ``seg`` never decreases (then one pass and
    one host read)."""
    return sr.add_kind == "sum" and (
        seg.shape[0] < 2 or bool((seg[1:] >= seg[:-1]).all()))


def _segments(vals: torch.Tensor, seg: torch.Tensor, num: int,
              sr: Semiring, ascending: bool) -> torch.Tensor:
    """The fold of ``vals`` into ``num`` segments in a fixed order (see
    :func:`_fold`)."""
    if ascending and sr.add_kind == "sum" and vals.is_floating_point():
        return torch.segment_reduce(
            vals, "sum", lengths=torch.bincount(seg, minlength=num),
            unsafe=True)
    if sr.add_kind == "sum" and vals.is_floating_point() and vals.is_cuda:
        part = torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype,
                           device=vals.device)
        part.index_put_((seg,), vals, accumulate=True)
        return part
    return _segment_reduce(vals, seg, num, sr)


def _fold(vals: torch.Tensor, seg: torch.Tensor, dims, length: int,
          axis: str, sr: Semiring, ascending: bool = False) -> torch.Tensor:
    """Every block's fold of ``vals`` into its vector of ``length`` (``seg``
    = block index * length + local index; block index ``i*pc + j`` over
    ``dims`` = (pr, pc)), empty slots the add's identity, then the
    reduce-scatter of the (pr, pc, length) partials over mesh ``axis``.
    A float sum folds each segment in a fixed order, so that two runs sum
    alike (``index_add_``'s atomic adds on the card would land in another
    order on every run): where the caller knows that the segment ids
    ascend (``ascending``: the blocks' live entries of a row-sorted
    matrix, by row) one ``segment_reduce`` over the segments' lengths;
    otherwise, on the card,
    ``index_put_(accumulate=True)``, which sorts the entries by segment
    (stably) first and folds each in entry order.  ``vals`` may carry
    trailing dimensions (a dense SpMM's rows), flattened into the
    partials.  Returns (pr, pc, length * trailing / axis size)."""
    num = dims[0] * dims[1] * length
    part = _segments(vals, seg, num, sr, ascending)
    return _axis_reduce_scatter(part.reshape(dims[0], dims[1], -1), axis, sr)


# ------------------------------------------------ across processes (pods) --

def _pod_plan(a: DistSpMat, transpose: bool):
    """The vector lengths on a pod, in and out, and the span of the output
    that every process's blocks cover (its block columns for ``A^T x``,
    its block rows for ``A x``)."""
    g = a.grid
    mb, nb = block_dims(a.gshape, g)
    lr, lc = g.local_shape()
    if transpose:
        return g.pr * mb, g.pc * nb, [
            (g.origin(q)[1] * nb, (g.origin(q)[1] + lc) * nb)
            for q in range(g.nproc)]
    return g.pc * nb, g.pr * mb, [
        (g.origin(q)[0] * mb, (g.origin(q)[0] + lr) * mb)
        for q in range(g.nproc)]


def _pod_input(a: DistSpMat, vecs, in_len: int, transpose: bool,
               dtypes, d: int = 1) -> list:
    """The part of each vector of ``vecs`` (this process's slices of
    ``in_len``-long FullyDist vectors, as ``dtypes``) that this process's
    blocks read: its own slice where every process's blocks read exactly
    their own, else gathered from the processes that hold it.  With ``d``
    > 1 each vector is a slice of rows of ``d`` elements, flattened (a
    dense SpMM operand), and so is its part."""
    g = a.grid
    mb, nb = block_dims(a.gshape, g)
    lr, lc = g.local_shape()
    chunk = in_len // g.nproc * d
    vecs = [_padded(v, chunk, dt) for v, dt in zip(vecs, dtypes)]
    if transpose:
        starts = [g.origin(q)[0] * mb * d for q in range(g.nproc)]
        width = lr * mb * d
    else:
        starts = [g.origin(q)[1] * nb * d for q in range(g.nproc)]
        width = lc * nb * d
    if width == chunk and all(s == q * chunk for q, s in enumerate(starts)):
        return vecs
    lo = starts[g.rank]
    return exchange.gather_range(vecs, g, lo, lo + width)


def _pod_entries(a: DistSpMat, live, transpose: bool):
    """This process's live entries as (src index into its input part, dst
    index into its output span, values, block index within the share)."""
    mb, nb = block_dims(a.gshape, a.grid)
    lc = a.grid.local_shape()[1]
    bid, r, c, v = _live_entries(a) if live is None else live
    li, lj = bid // lc, bid % lc
    if transpose:
        return li * mb + r.clamp(max=mb - 1), lj * nb + c, v, bid
    return lj * nb + c.clamp(max=nb - 1), li * mb + r, v, bid


def _pod_spmv(a, x, sr, live):
    in_len, out_len, spans = _pod_plan(a, False)
    xp, = _pod_input(a, [x], in_len, False, [x.dtype])
    src, dst, v, _b = _pod_entries(a, live, False)
    prod = sr.mul(v, xp[src])
    width = spans[a.grid.rank][1] - spans[a.grid.rank][0]
    part = _segments(prod, dst, width, sr, _sum_ascends(sr, dst))
    y, = exchange.reduce_to_owners([part], spans, out_len, a.grid,
                                   [sr.add_kind])
    return y


def _pod_spmsv(a, x_val, x_mask, sr, transpose, edge_pred, live):
    in_len, out_len, spans = _pod_plan(a, transpose)
    xv, xm = _pod_input(a, [x_val, x_mask], in_len, transpose,
                        [x_val.dtype, torch.bool])
    src, dst, v, _b = _pod_entries(a, live, transpose)
    active = xm[src]
    if edge_pred is not None:
        active = active & edge_pred(v)
    v, src, dst = _active(active, v, src, dst)
    prod = sr.mul(v, xv[src])
    width = spans[a.grid.rank][1] - spans[a.grid.rank][0]
    part = _segments(prod, dst, width, sr,
                     not transpose and _sum_ascends(sr, dst))
    hit = torch.zeros(width, dtype=torch.int32, device=dst.device)
    hit[dst] = 1
    y, h = exchange.reduce_to_owners([part, hit], spans, out_len, a.grid,
                                     [sr.add_kind, "max"])
    zero = sr.zero(y.dtype).to(y.device)
    return torch.where(h > 0, y, zero), h > 0


def _pod_bfs_pull(a, front_mask, unvisited, live):
    g = a.grid
    mb = block_dims(a.gshape, g)[0]
    in_len, out_len, spans = _pod_plan(a, True)
    fm, = _pod_input(a, [front_mask], in_len, True, [torch.bool])
    uv, = _pod_input(a, [unvisited], out_len, False, [torch.bool])
    src, dst, _v, _b = _pod_entries(a, live, True)
    gsrc = g.origin()[0] * mb + src       # the global vertex id
    active = fm[src] & uv[dst]
    gsrc, dst = _active(active, gsrc, dst)
    width = spans[g.rank][1] - spans[g.rank][0]
    part = _segment_reduce((gsrc + 1).to(torch.int32), dst, width,
                           MAX_FIRST)
    y, = exchange.reduce_to_owners([part], spans, out_len, g, ["max"])
    return y, y > 0


def dist_spmv(a: DistSpMat, x: torch.Tensor, sr: Semiring = PLUS_TIMES,
              *, live=None) -> torch.Tensor:
    """y = A ._sr x.  ``x``: a column-space FullyDist vector (cut or
    zero-padded to ``pc*nb``).  Every block multiplies its block column's
    slice of x (JAX ``_local_spmv`` on every device); the partials meet in
    a reduce-scatter over 'c'.  Returns y in the row-space FullyDist
    layout, padded length ``pr*mb``; rows without a product hold the add's
    identity.  ``live``: ``a``'s ``_live_entries``, for a loop that
    multiplies one matrix many times.  On a pod, x and y are this
    process's slices."""
    if a.grid.is_pod:
        return _pod_spmv(a, x, sr, live)
    pr, pc = a.grid.pr, a.grid.pc
    mb, nb = block_dims(a.gshape, a.grid)
    xp = _padded(x, pc * nb)
    bid, r, c, v = _live_entries(a) if live is None else live
    prod = sr.mul(v, xp[(bid % pc) * nb + c.clamp(max=nb - 1)])
    seg = bid * mb + r
    return _row_space(_fold(prod, seg, (pr, pc), mb, "c", sr,
                            _sum_ascends(sr, seg)))


def _active(active: torch.Tensor, *xs):
    """The entries of each of ``xs`` where ``active`` holds (one host
    read): the folds then see no dropped entry, which would all land on
    one spare slot and serialise the card's atomics there."""
    idx = torch.nonzero(active).squeeze(1)
    return tuple(x[idx] for x in xs)


def _hits(seg: torch.Tensor, dims, length: int, axis: str) -> torch.Tensor:
    """Whether any entry landed on each slot, reduce-scattered over
    ``axis`` as JAX's segment-max of the active flags: (pr, pc, chunk)."""
    hit = torch.zeros(dims[0] * dims[1] * length, dtype=torch.int32,
                      device=seg.device)
    hit[seg] = 1
    return _axis_reduce_scatter(hit.reshape(dims[0], dims[1], length), axis,
                                MAX_FIRST) > 0


def dist_spmsv_masked(a: DistSpMat, x_val: torch.Tensor,
                      x_mask: torch.Tensor, sr: Semiring = PLUS_TIMES,
                      transpose: bool = False, edge_pred=None, *,
                      live=None):
    """Masked-sparse distributed SpMV: (values, mask) in, (values, mask)
    out.  ``transpose=True`` computes A^T ._sr x (the BFS direction): x is
    row space (padded to ``pr*mb``) and y column space (``pc*nb``);
    otherwise x is column space and y row space.  ``edge_pred(values)``
    drops the edges where it is False (late filtering).  Outputs without
    an active product hold the add's identity and a False mask.  ``live``
    as for :func:`dist_spmv`."""
    if a.grid.is_pod:
        return _pod_spmsv(a, x_val, x_mask, sr, transpose, edge_pred, live)
    pr, pc = a.grid.pr, a.grid.pc
    mb, nb = block_dims(a.gshape, a.grid)
    if transpose:
        in_len, src_n, dst_n, red_ax = pr * mb, mb, nb, "r"
    else:
        in_len, src_n, dst_n, red_ax = pc * nb, nb, mb, "c"
    xv = _padded(x_val, in_len)
    xm = _padded(x_mask, in_len, torch.bool)
    bid, r, c, v = _live_entries(a) if live is None else live
    if transpose:   # x indexed by rows (gathered over 'c'), out by columns
        src, dst, off = r, c, (bid // pc) * mb
    else:
        src, dst, off = c, r, (bid % pc) * nb
    srcc = off + src.clamp(max=src_n - 1)
    active = xm[srcc]
    if edge_pred is not None:
        active = active & edge_pred(v)
    v, srcc, seg = _active(active, v, srcc, bid * dst_n + dst)
    prod = sr.mul(v, xv[srcc])
    zero = sr.zero(prod.dtype).to(prod.device)
    y_loc = _fold(prod, seg, (pr, pc), dst_n, red_ax, sr,
                  not transpose and _sum_ascends(sr, seg))
    hit_loc = _hits(seg, (pr, pc), dst_n, red_ax)
    y_loc = torch.where(hit_loc, y_loc, zero)
    out = _col_space if transpose else _row_space
    return out(y_loc), out(hit_loc)


def dist_bfs_pull_masked(a: DistSpMat, front_mask: torch.Tensor,
                         unvisited: torch.Tensor, *, live=None):
    """Distributed bottom-up (pull) BFS step: every unvisited vertex v
    takes the largest frontier in-neighbour over the edges (u, v), as the
    candidate ``u + 1`` (int32; u = ``bi*mb + rr``).  ``front_mask`` is row
    space (cut or padded to ``pr*mb``), ``unvisited`` column space
    (``pc*nb``).  Returns (candidates, hit mask) in the column-space
    layout; candidates without a hit hold the int32 minimum.  ``live`` as
    for :func:`dist_spmv`."""
    if a.grid.is_pod:
        return _pod_bfs_pull(a, front_mask, unvisited, live)
    pr, pc = a.grid.pr, a.grid.pc
    mb, nb = block_dims(a.gshape, a.grid)
    fm = _padded(front_mask, pr * mb, torch.bool)
    uv = _padded(unvisited, pc * nb, torch.bool)
    bid, r, c, _v = _live_entries(a) if live is None else live
    src = (bid // pc) * mb + r.clamp(max=mb - 1)
    cc = c.clamp(max=nb - 1)
    active = fm[src] & uv[(bid % pc) * nb + cc]
    src, seg = _active(active, src, bid * nb + cc)
    y_loc = _fold((src + 1).to(torch.int32), seg, (pr, pc), nb, "r",
                  MAX_FIRST)
    return _col_space(y_loc), _col_space(y_loc > 0)


def _sampling_estimate(a: DistSpMat, b: DistSpMat, draws) -> float:
    """Cohen's estimate of nnz(A B) from the Exp(1) vectors ``draws`` over
    B's columns (column-space FullyDist vectors: on a pod this process's
    slices), one a round: min-propagate each through B, then A, with
    (min, select2nd) SpMVs; a row's estimate is (R - 1) / the sum of its R
    minima, and the total the sum over rows (on a pod each process's sum
    of its rows, then those sums in rank order)."""
    rounds = len(draws)
    acc = None
    live_a, live_b = _live_entries(a), _live_entries(b)
    for x in draws:
        m = dist_spmv(b, x, MIN_SECOND, live=live_b)
        m = torch.where(torch.isfinite(m), m, float("inf"))
        f = dist_spmv(a, m, MIN_SECOND, live=live_a)
        f = torch.where(torch.isfinite(f), f, float("inf"))
        acc = f if acc is None else acc[: f.shape[0]] + f
    lo = a.grid.vec_range(acc.shape[0] * a.grid.nproc)[0]
    acc = acc[: max(a.gshape[0] - lo, 0)]
    per_row = torch.where(torch.isfinite(acc) & (acc > 0),
                          (rounds - 1) / acc, 0.0)
    total = float(per_row.sum())
    if not a.grid.is_pod:
        return total
    return float(sum(exchange.allgather_host(np.asarray([total]))[:, 0]))


def est_nnz_spgemm_sampling(a: DistSpMat, b: DistSpMat,
                            generator: torch.Generator,
                            rounds: int = 16) -> float:
    """Sampling estimate of nnz(A B) (``EstPerProcessNnzSpMV``, Cohen's
    min-propagation estimator): per round, x[j] ~ Exp(1) over B's columns,
    drawn from ``generator`` (on the matrices' device; JAX takes a key),
    then ``m = B ._min x`` and ``f = A ._min m``; nnz of C's row i is about
    (R - 1) / sum_r f_r[i].  Costs 2R distributed SpMVs, whatever the size
    of the product.  On a pod every process draws the same vectors from
    its generator (seeded alike) and keeps its slices."""
    n = b.gshape[1]
    dev = b.row.device
    draws = [torch.empty(n, dtype=torch.float32, device=dev).exponential_(
        generator=generator) for _ in range(rounds)]
    if b.grid.is_pod:
        length = col_vec_len(b.gshape, b.grid)
        lo, hi = b.grid.vec_range(length)
        draws = [_padded(x, length)[lo:hi] for x in draws]
    return _sampling_estimate(a, b, draws)
