"""Streamed digest SpGEMM over row windows (port of
``combblas_tpu/ops/spgemm_seg.py``): the sorted-row uniform-width pipeline
("seg2") and the row-classed pipeline ("seg") it replaced as the headline.

Both expand each slab with int32 keys equal to B's column ids (K1, stride
0), so the stream is grouped by output row but unsorted within a row.  Each
row gets one window of a width strictly greater than its product count, so
every window ends in at least one sentinel:

  expand -> per-row window gather -> batched within-row sort
  (``torch.sort`` along dim 1) -> compress (K2) -> digest fold.

seg2 permutes A's rows by descending product count (the digest is invariant
under row permutation) and cuts them into slabs of one width each.  Rows
with fewer than ``flat_max_fl`` products ride flat slabs through
:func:`ops.spgemm._slab_digest_step` (int64 keys ``row*(n+1)+col``, one 1-D
sort).  :func:`seg2_plan` is the JAX package's numpy plan unchanged; its
TPU-sized constants are keyword parameters whose defaults equal the JAX
values, so plans match bit for bit.

seg keeps A's rows in place and cuts equal-flops slabs
(:func:`ops.spgemm._pallas_slab_plan`).  A row's class is the first width
of the half-octave ladder 128, 192, 256, 384, ... above its product count;
every slab sorts every class at the largest row count any slab has in it
(:func:`seg_plan`), and the classes are laid end to end, in class order,
into one buffer for K2.  That layout is JAX's, and it is kept: K2's float
sums depend on where a run falls in the stream.  The buffer is formed from
the stream and a window table (:func:`_window_table`) by one window sort
kernel (K10, :mod:`ops.kernels.winsort`), or in its plain version by
per-class ``torch.sort(dim=1)`` calls; :func:`_class_windows` keeps JAX's
per-class window gather, which the tests hold the table to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from combblas_tpu_torch.device import resolve_device
from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.kernels.compress import compress_sorted_packed
from combblas_tpu_torch.ops.kernels.expand import (
    KEY_SENTINEL,
    expand_chunks_compact,
)
from combblas_tpu_torch.ops.kernels.winsort import key_bits, window_sort
from combblas_tpu_torch.ops.spgemm import (
    SORT_ELEM_LIMIT,
    _out_cap,
    _pallas_slab_plan,
    _slab_digest_step,
    _slab_extract,
    check_sort_limit,
    round_capacity_frac,
    stream_capacity,
)
from combblas_tpu_torch.semiring import PLUS_TIMES, Semiring
from combblas_tpu_torch.utils.timers import span

__all__ = ["seg_zero_state", "seg_plan", "seg_prepare", "seg_step",
           "spgemm_streamed_seg", "seg2_plan", "seg2_prepare", "seg2_step",
           "spgemm_streamed_seg2"]

_SENT = KEY_SENTINEL[torch.int32]
_MIN_CLS = 7  # smallest window = 2^7
#: Granularity (elements) that window buffers and flat streams round to —
#: the JAX compress kernel's tile.
TILE = 32768


def _width_gran(L: int, tile: int = TILE) -> int:
    """Window count granularity so a class buffer S*L is a whole number of
    ``tile``-element tiles."""
    return max(tile // math.gcd(L, tile), 1)


def _row_flops_exact(a: SpCOO, b_rp: torch.Tensor, span_cap: int):
    """Exact int64 per-slab-local-row product counts (span_cap+1,) and the
    exclusive cumsum of their stream start offsets (pads land on
    span_cap)."""
    kk = b_rp.shape[0] - 1
    acol = torch.clamp(a.col.long(), max=kk - 1)
    cnt = torch.where(a.mask(), b_rp[acol + 1] - b_rp[acol], 0)
    rowfl = torch.zeros(span_cap + 1, dtype=torch.int64, device=a.device)
    rowfl.index_add_(0, torch.clamp(a.row.long(), max=span_cap), cnt)
    row_start = torch.cumsum(rowfl, 0) - rowfl
    return rowfl, row_start


def seg_zero_state(device=None):
    """Digest state (nnz int64, checksum f32, truncated bool, signed f32),
    zeroed, on ``device`` (the card when it is None).  ``signed`` sums C's
    values with the sign of their column's parity (odd columns negated),
    so it moves when a value lands under another column, which nnz and the
    checksum cannot see; the classed route folds it, seg2 carries it
    through at zero."""
    device = resolve_device(device)
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


# -- seg: row-classed slabs ---------------------------------------------

def _widths_upto(max_row: int) -> list[int]:
    """Half-octave window widths 128, 192, 256, 384, 512, ...; the last is
    the first width strictly greater than ``max_row``."""
    out = []
    c = _MIN_CLS
    while True:
        for w in (1 << c, 3 << (c - 1)):
            out.append(w)
            if w > max_row:
                return out
        c += 1


def seg_plan(a: SpCOO, b: SpCOO, num_slabs: int) -> dict:
    """Host (numpy) plan for the row-classed pipeline — the JAX ``seg_plan``
    key for key.

    Equal-flops row slabs from :func:`ops.spgemm._pallas_slab_plan` (wide),
    the class widths (:func:`_widths_upto` of the heaviest row's product
    count) and, per class, ``s_caps[i]``: the most rows of class ``i`` in
    any slab, rounded up so every class buffer is whole ``TILE``-element
    tiles.  Returns bounds, span_cap, slab_nnz_cap, chunk_cap, worst_fl,
    classes, s_caps, stream_cap and padded (elements a slab sorts)."""
    m, k = a.shape
    bounds, span_cap, slab_nnz_cap, chunk_cap, worst_fl = _pallas_slab_plan(
        a, b, num_slabs, wide=True)
    with span("spgemm.plan", a.row):
        # exact per-row flops over the whole matrix, classed on the host
        b_rp = b.row_ptr().cpu().numpy().astype(np.int64)
        nnz = int(a.nnz)
        arow = a.row[:nnz].cpu().numpy()
        acol = np.minimum(a.col[:nnz].cpu().numpy(), k - 1)
        cnt = b_rp[acol + 1] - b_rp[acol]
        rowfl = np.bincount(arow, weights=cnt, minlength=m).astype(np.int64)
        widths = _widths_upto(int(rowfl.max(initial=1)))
        nz = rowfl > 0
        # class of a row = first width strictly greater than its flops
        cls = np.searchsorted(np.asarray(widths, np.int64), rowfl,
                              side="right")
        S = len(bounds) - 1
        s_caps = []
        for i, w in enumerate(widths):
            per_slab = np.zeros((S,), np.int64)
            sel_rows = np.flatnonzero(nz & (cls == i))
            if sel_rows.size:
                sid = np.searchsorted(bounds, sel_rows, side="right") - 1
                per_slab = np.bincount(sid, minlength=S)
            cap = int(per_slab.max(initial=0))
            gran = _width_gran(w)
            s_caps.append(max(-(-max(cap, 1) // gran) * gran, gran))
        stream_cap = stream_capacity(worst_fl + widths[-1])
    # JAX builds the class key cls * (span_cap + 1) + row in int32 with cls
    # up to len(widths) + 1; the port's key is int64, but refuses the same
    # plans
    if (len(widths) + 2) * (span_cap + 1) >= 2**31:
        raise ValueError(
            "seg pipeline class key overflows int32: slab row span too large "
            f"(span_cap={span_cap}, classes={len(widths)}); raise num_slabs")
    return dict(
        bounds=bounds,
        span_cap=int(span_cap),
        slab_nnz_cap=int(slab_nnz_cap),
        chunk_cap=int(chunk_cap),
        worst_fl=int(worst_fl),
        classes=tuple(widths),
        s_caps=tuple(s_caps),
        stream_cap=int(stream_cap),
        padded=int(sum(sc * w for sc, w in zip(s_caps, widths))),
    )


def _class_windows(colstream, valstream, rowfl, row_start, *,
                   classes: tuple, s_caps: tuple, span_cap: int) -> list:
    """Group a slab's rows by class and gather each row's window from the
    stream.  Returns, per class, (col2d, val2d, rows_c, lens): the
    (s_caps[i], classes[i]) windows with lanes past ``lens`` at the
    sentinel / 0, windows in ascending row order, then dead windows (all
    sentinel, ``rows_c = span_cap``).  Windows stay inside the stream while
    ``stream_cap >= slab flops + classes[-1]`` (checked in
    :func:`seg_prepare`)."""
    dev = rowfl.device
    R = span_cap + 1
    ncls = len(classes)
    widths = torch.tensor(classes, dtype=rowfl.dtype, device=dev)
    cls = torch.searchsorted(widths, rowfl, right=True)
    cls = torch.where(rowfl > 0, cls, ncls + 1)  # empty rows sort last
    skey = torch.sort(cls * R + torch.arange(R, device=dev)).values
    # a class's dead windows read up to max(s_caps) keys past its start
    skey = torch.cat([skey, torch.full((max(s_caps),), (ncls + 2) * R,
                                       dtype=skey.dtype, device=dev)])
    cstarts = torch.searchsorted(skey[:R],
                                 torch.arange(ncls + 1, device=dev) * R)
    out = []
    for i, L in enumerate(classes):
        t = torch.arange(s_caps[i], device=dev)
        live = t < cstarts[i + 1] - cstarts[i]
        rows_c = torch.where(live, skey[cstarts[i] + t] % R, span_cap)
        lens = torch.where(live, rowfl[rows_c], 0)
        starts = torch.where(live, row_start[rows_c], 0)
        j = torch.arange(L, device=dev)
        idx = starts[:, None] + j[None, :]
        keep = j[None, :] < lens[:, None]
        col2d = torch.where(keep, colstream[idx], _SENT)
        val2d = torch.where(keep, valstream[idx], 0.0)
        del idx, keep
        out.append((col2d, val2d, rows_c, lens))
    return out


def _class_table(classes: tuple, s_caps: tuple, device) -> torch.Tensor:
    """The plan's classes on ``device``, int64 (4, classes): widths, window
    counts, each class's first window and its offset in the class buffer
    (classes end to end)."""
    w = np.asarray(classes, np.int64)
    sc = np.asarray(s_caps, np.int64)
    return torch.as_tensor(np.stack([w, sc, np.cumsum(sc) - sc,
                                     np.cumsum(sc * w) - sc * w]),
                           device=device)


def _window_table(rowfl, row_start, class_table, *, windows: int,
                  span_cap: int):
    """The slab's windows as :func:`_class_windows` lays them out, one entry
    each, in class order: (start, lens, dest, width), int64 of
    ``windows``: the row's first product in the stream (0 for a dead
    window), its product count (0), the window's offset in the class buffer
    and its class width.  ``class_table`` is :func:`_class_table` of the
    plan.  A fixed number of launches, whatever the classes, and no host
    sync."""
    dev = rowfl.device
    R = span_cap + 1
    ncls = class_table.shape[1]
    widths, caps, win_off, elem_off = class_table
    cls = torch.searchsorted(widths, rowfl, right=True)
    cls = torch.where(rowfl > 0, cls, ncls + 1)  # empty rows sort last
    skey = torch.sort(cls * R + torch.arange(R, device=dev)).values
    cstarts = torch.searchsorted(skey, torch.arange(ncls + 1, device=dev) * R)
    wcls = torch.repeat_interleave(torch.arange(ncls, device=dev), caps,
                                   output_size=windows)
    t = torch.arange(windows, device=dev) - win_off[wcls]
    live = t < (cstarts[1:] - cstarts[:-1])[wcls]
    rows = torch.where(live,
                       skey[torch.clamp(cstarts[wcls] + t, max=R - 1)] % R,
                       span_cap)
    width = widths[wcls]
    return (torch.where(live, row_start[rows], 0),
            torch.where(live, rowfl[rows], 0),
            elem_off[wcls] + t * width, width)


def _seg_slab_digest_step(a: SpCOO, b: SpCOO, b_rp, bounds, s: int, state,
                          sr: Semiring, *, span_cap: int, slab_nnz_cap: int,
                          slab_out_cap: int, stream_cap: int, classes: tuple,
                          s_caps: tuple, class_table: torch.Tensor,
                          plain: bool = False):
    """One slab of the classed digest: expand with int32 column keys (K1,
    stride 0), within-row sorts into one buffer laid out class after class
    (K10), one compress (K2), digest fold.  All on the device;
    ``plain=True`` runs the kernels' plain versions."""
    k = a.shape[1]
    with span("seg.slab", a.row):
        with span("seg.extract"):
            sub, _row_lo = _slab_extract(a, k, bounds, s, span_cap=span_cap,
                                         slab_nnz_cap=slab_nnz_cap)
        with span("seg.expand"):
            colstream, valstream, _total = expand_chunks_compact(
                sub.row, sub.col, sub.val, sub.mask(), b_rp, b.col, b.val, sr,
                stride=0, stream_cap=stream_cap, plain=plain)
        with span("seg.windows"):
            rowfl, row_start = _row_flops_exact(sub, b_rp, span_cap)
            table = _window_table(rowfl, row_start, class_table,
                                  windows=sum(s_caps), span_cap=span_cap)
        with span("seg.sort"):
            cat_k, cat_v = window_sort(
                colstream, valstream, table, classes=classes, s_caps=s_caps,
                key_bits=key_bits(b.shape[1]), plain=plain)
        del colstream, valstream, table
        with span("seg.compress"):
            okey, oval, nnz = compress_sorted_packed(
                cat_k, cat_v, sr, out_capacity=slab_out_cap, plain=plain)
        with span("seg.fold"):
            # entries past nnz hold 0, so plain sums are the live sums
            cs = oval.sum()
            # odd columns' values negated: the key's low bit shifted onto
            # the float32 value's sign bit
            sg = (oval.view(torch.int32) ^ (okey << 31)).view(
                torch.float32).sum()
            nnz_total, checksum, truncated, signed = state
            state = (nnz_total + nnz, checksum + cs,
                     truncated | (nnz >= slab_out_cap), signed + sg)
    return state


def seg_prepare(a: SpCOO, b: SpCOO, num_slabs: int,
                slab_out_cap: int | None = None):
    """Hoistable state for the classed digest: (plan, b_rp, class_table,
    bounds_dev, slab_out_cap).  ``class_table`` (:func:`_class_table`, the
    plan's classes on the device, read by the window table) takes the place
    of JAX's B lane tables, which the CUDA expansion does not need.  It
    depends on A's and B's structure only, so a caller may build it once
    and hand it to every :func:`spgemm_streamed_seg` of the same operands.

    Raises :class:`SpGEMMSortLimitError` where a class sort (``s_caps[i]``
    windows of ``classes[i]``) or the slab stream passes
    :data:`SORT_ELEM_LIMIT`, as the other slab routes do: raise
    ``num_slabs``."""
    plan = seg_plan(a, b, num_slabs)
    if plan["worst_fl"] + plan["classes"][-1] > plan["stream_cap"]:
        raise ValueError(
            f"windows of width {plan['classes'][-1]} would read past the "
            f"{plan['stream_cap']}-element stream of a slab of "
            f"{plan['worst_fl']} products")
    check_sort_limit(plan["stream_cap"], "seg slab stream", SORT_ELEM_LIMIT)
    for S_c, L in zip(plan["s_caps"], plan["classes"]):
        check_sort_limit(S_c * L, f"seg class sort ({S_c} windows of {L})",
                         SORT_ELEM_LIMIT)
    if slab_out_cap is None:
        slab_out_cap = round_capacity_frac(max(plan["worst_fl"], 2048))
    bounds_dev = torch.as_tensor(plan["bounds"].astype(np.int64),
                                 device=a.device)
    return (plan, b.row_ptr(),
            _class_table(plan["classes"], plan["s_caps"], a.device),
            bounds_dev, _out_cap(slab_out_cap))


def seg_step(a: SpCOO, b: SpCOO, prep, s: int, state,
             sr: Semiring = PLUS_TIMES, *, plain: bool = False):
    """One slab step of the classed digest on hoisted ``prep`` state (the
    host loop drives ``s``).  Returns the new digest state; nothing syncs
    with the host."""
    plan, b_rp, class_table, bounds_dev, slab_out_cap = prep
    return _seg_slab_digest_step(
        a, b, b_rp, bounds_dev, s, state, sr, span_cap=plan["span_cap"],
        slab_nnz_cap=plan["slab_nnz_cap"], slab_out_cap=slab_out_cap,
        stream_cap=plan["stream_cap"], classes=plan["classes"],
        s_caps=plan["s_caps"], class_table=class_table, plain=plain)


def spgemm_streamed_seg(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                        num_slabs: int | None = None,
                        slab_out_cap: int | None = None, prep=None):
    """Slab-streamed digest SpGEMM via the classed pipeline: every product
    formed, every duplicate merged, each slab folded into the digest.
    Returns (nnz_total int, checksum float, truncated bool, signed float);
    ``signed`` as in :func:`seg_zero_state`.

    ``prep``: a :func:`seg_prepare` of these operands, held by the caller
    (as :func:`ops.spmv.spmm` takes its ELL plan); the call then runs only
    the pass, with the same result bit for bit, and takes no
    ``num_slabs`` or ``slab_out_cap``.  Without ``prep`` the plan is built
    from ``num_slabs``."""
    if prep is None and num_slabs is None:
        raise ValueError("spgemm_streamed_seg needs num_slabs or prep")
    if prep is not None and (num_slabs, slab_out_cap) != (None, None):
        raise ValueError("a held prep fixes num_slabs and slab_out_cap: "
                         "pass neither")
    with span("seg.call", a.row):
        if prep is None:
            prep = seg_prepare(a, b, num_slabs, slab_out_cap)
        state = seg_zero_state(a.device)
        for s in range(len(prep[0]["bounds"]) - 1):
            state = seg_step(a, b, prep, s, state, sr)
        nnz, checksum, truncated, signed = state
        return int(nnz), float(checksum), bool(truncated), float(signed)


# -- seg2: sorted-row uniform-width slabs ---------------------------------

def _pow4_cap(n: int) -> int:
    """Round up to the next power of 4 (at least 256)."""
    n = max(n, 256)
    p = 1
    while p < n:
        p <<= 2
    return p


def _spad_for(w: int, n_class: int, flops_cap: int, pad_cap: int,
              tile: int = TILE) -> int:
    """Shared window count for width-``w`` slabs: fill a ~``flops_cap``
    sort area, never more windows than the class has rows, rounded so every
    window buffer is whole tiles."""
    gran = _width_gran(w, tile)
    sp = max(min(flops_cap // w, pad_cap // w), 1)
    sp = min(sp, -(-n_class // gran) * gran)
    return max(-(-sp // gran) * gran, gran)


def _class_area(w: int, n_class: int, flops_cap: int, pad_cap: int,
                tile: int = TILE) -> int:
    """Allocated (padded) elements for a class of ``n_class`` rows at width
    ``w``: #slabs x shared s_pad x w."""
    if n_class <= 0:
        return 0
    sp = _spad_for(w, n_class, flops_cap, pad_cap, tile)
    return -(-n_class // sp) * sp * w


def _choose_widths(fl_desc: np.ndarray, cands: list[int], max_widths: int,
                   flops_cap: int, pad_cap: int,
                   tile: int = TILE) -> list[int]:
    """Pick <= ``max_widths`` window widths from ``cands`` minimizing total
    allocated sort area when every row takes the smallest selected width
    strictly greater than its product count.  Small DP, O(K C^2)."""
    C = len(cands)
    req = np.searchsorted(cands, fl_desc, side="right")  # first cand > fl
    if req.max(initial=0) >= C:
        raise ValueError("candidate ladder does not cover the heaviest row")
    n = np.bincount(req, minlength=C)
    cum = np.cumsum(n)
    jmax = int(req.max(initial=0))
    K = max(min(max_widths, C), 1)
    INF = float("inf")
    f = [[INF] * C for _ in range(K + 1)]
    parent = [[-1] * C for _ in range(K + 1)]

    def seg_cost(ip, i):
        # bins (ip, i] served by width cands[i]; ip == -1 means from 0
        n_seg = int(cum[i] - (cum[ip] if ip >= 0 else 0))
        return float(_class_area(cands[i], n_seg, flops_cap, pad_cap, tile))

    for i in range(C):
        f[1][i] = seg_cost(-1, i)
    for k in range(2, K + 1):
        for i in range(C):
            best, barg = f[k - 1][i], i  # reuse k-1 solution (skip a width)
            for ip in range(i):
                c = f[k - 1][ip] + seg_cost(ip, i)
                if c < best:
                    best, barg = c, ip
            f[k][i] = best
            parent[k][i] = barg
    i = min(range(jmax, C), key=lambda j: f[K][j])
    sel = []
    k = K
    while k >= 1 and i >= 0:
        if not sel or sel[-1] != cands[i]:
            sel.append(cands[i])
        ip = parent[k][i] if k > 1 else -1
        if ip == i:
            k -= 1
            continue
        i = ip
        k -= 1
    return sorted(set(sel))


def seg2_plan(a: SpCOO, b: SpCOO, *, flops_cap: int = 1 << 28,
              pad_cap: int = 1 << 28, flat_max_fl: int = 1 << 9,
              max_widths: int = 14, flat_cap: int = 1 << 27,
              chunk_class: int = 1 << 22, tile: int = TILE,
              sort_elem_limit: int = SORT_ELEM_LIMIT):
    """Host (numpy) plan for the sorted-row uniform-width pipeline — the JAX
    ``seg2_plan`` unchanged.

    Builds ``a2`` (A's rows permuted by descending product count, rows and
    entries with no products dropped) and contiguous slab bounds over the
    sorted rows.  A windowed slab has one width ``w`` and a window count
    ``s_pad``; rows with fewer than ``flat_max_fl`` products go to flat
    slabs, cut at ``min(flops_cap, flat_cap)`` products and at
    ``chunk_class`` 128-product chunks.  ``flat_cap``, ``chunk_class``,
    ``tile`` and ``sort_elem_limit`` are the JAX package's TPU-sized
    constants; the defaults keep plans identical to it.

    Returns (a2, cfg); cfg carries bounds, the per-slab dicts, stream_cap,
    worst_fl, padded, flops, pad_ratio and the distinct shapes."""
    check_sort_limit(flops_cap, "seg2 slab budget", sort_elem_limit)
    m, k = a.shape
    arow_all, acol_all, aval_all, nnz, _shape = a.to_numpy()
    b_rp = b.row_ptr().cpu().numpy().astype(np.int64)
    arow = arow_all[:nnz]
    acol = np.minimum(acol_all[:nnz], k - 1)
    aval = aval_all[:nnz]
    cnt_e = b_rp[acol + 1] - b_rp[acol]
    rowfl = np.bincount(arow, weights=cnt_e, minlength=m).astype(np.int64)
    live_rows = np.flatnonzero(rowfl > 0)
    order = live_rows[np.argsort(-rowfl[live_rows], kind="stable")]
    R = len(order)
    fl = rowfl[order]  # descending
    newid = np.full(m, -1, np.int64)
    newid[order] = np.arange(R)
    keep = cnt_e > 0
    new_r = newid[arow[keep]].astype(np.int32)
    new_c = acol[keep].astype(np.int32)
    new_v = aval[keep]
    og = np.lexsort((new_c, new_r))
    new_r, new_c, new_v = new_r[og], new_c[og], new_v[og]
    a2 = SpCOO.from_arrays(new_r, new_c, new_v, (m, k), sum_duplicates=False,
                           dtype=aval.dtype, device=a.device)
    # per-sorted-row entry counts (for per-slab nnz caps)
    epr = np.bincount(new_r, minlength=R).astype(np.int64)
    epr_cum = np.concatenate([[0], np.cumsum(epr)])
    fl_cum = np.concatenate([[0], np.cumsum(fl)])

    min_w = 1 << _MIN_CLS
    # matrix-adaptive width ladder over the heavy (windowed) rows
    heavy = fl[fl >= flat_max_fl]
    n_heavy = int(heavy.size)
    if n_heavy:
        cands, c = [], min_w
        top = int(heavy[0])
        while c <= top:
            cands.extend(c * mlt // 4 for mlt in (4, 5, 6, 7))
            c <<= 1
        cands.append(c)
        cands = sorted({x for x in cands if x >= min_w})
        sel_w = np.asarray(
            _choose_widths(heavy, cands, max_widths, flops_cap, pad_cap,
                           tile), np.int64)
        # per-width shared window count, from the FULL class population
        req = np.searchsorted(sel_w, heavy, side="right")
        class_n = np.bincount(req, minlength=len(sel_w))
        spad_w = {int(sel_w[i]): _spad_for(int(sel_w[i]), int(class_n[i]),
                                           flops_cap, pad_cap, tile)
                  for i in range(len(sel_w)) if class_n[i] > 0}
    else:
        sel_w = np.asarray([min_w], np.int64)
        spad_w = {}

    flat_cut = min(flops_cap, flat_cap)
    comb = epr_cum + -(-fl_cum // 128)  # ~ nnz + 128-product chunks
    bounds = [0]
    slabs = []
    r = 0
    while r < R:
        f0 = int(fl[r])
        flat = f0 < flat_max_fl
        if flat:
            # flat slab: every remaining row, cut by the flops budget and
            # the chunk-count class
            w = min_w
            lim_flops = int(
                np.searchsorted(fl_cum, fl_cum[r] + flat_cut, side="right")
                - 1 - r)
            lim_chunk = int(
                np.searchsorted(comb, comb[r] + (chunk_class - 2),
                                side="right") - 1 - r)
            lim_flops = max(min(lim_flops, lim_chunk), 1)
            cnt = max(min(lim_flops, R - r), 1)
            s_pad = cnt
        else:
            wi = int(np.searchsorted(sel_w, f0, side="right"))
            w = int(sel_w[wi])  # smallest selected width strictly > f0
            # rows down to the previous selected width share the class
            w_low = int(sel_w[wi - 1]) if wi > 0 else flat_max_fl
            lim_class = int(np.searchsorted(-fl, -w_low, side="right") - r)
            s_pad = spad_w[w]
            cnt = max(min(s_pad, lim_class), 1)
        nnz_s = int(epr_cum[r + cnt] - epr_cum[r])
        fl_s = int(fl_cum[r + cnt] - fl_cum[r])
        ch_s = nnz_s + -(-fl_s // 128)
        slabs.append(dict(
            w=int(w), s_pad=int(s_pad), cnt=int(cnt),
            nnz_cap=_pow4_cap(nnz_s), chunk_cap=_pow4_cap(ch_s),
            flops=fl_s, padded=fl_s if flat else int(s_pad) * int(w),
            flat=flat,
            flat_stream_cap=(max(-(-(fl_s + 18 * 128) // tile) * tile, tile)
                             if flat else 0),
        ))
        r += cnt
        bounds.append(r)
    # one shared (s_pad, nnz_cap, chunk_cap, stream cap) per width
    by_shape = {}
    for sl in slabs:
        by_shape.setdefault(("flat",) if sl["flat"] else (sl["w"],),
                            []).append(sl)
    for group in by_shape.values():
        nnz_cap = max(sl["nnz_cap"] for sl in group)
        chunk_cap = max(sl["chunk_cap"] for sl in group)
        fsc = max(sl["flat_stream_cap"] for sl in group)
        s_pad = max(sl["s_pad"] for sl in group)
        for sl in group:
            sl["s_pad"] = int(s_pad)
            sl["nnz_cap"], sl["chunk_cap"] = int(nnz_cap), int(chunk_cap)
            sl["flat_stream_cap"] = int(fsc)
            if not sl["flat"]:
                sl["padded"] = int(s_pad) * int(sl["w"])
    worst_fl = max(s["flops"] for s in slabs)
    stream_cap = stream_capacity(worst_fl + max(s["w"] for s in slabs), tile)
    padded_total = sum(s["padded"] for s in slabs)
    flops_total = int(fl_cum[-1])
    shapes = sorted({(s["w"], s["s_pad"], s["nnz_cap"], s["chunk_cap"],
                      s["flat"], s["flat_stream_cap"])
                     for s in slabs})
    cfg = dict(
        bounds=np.asarray(bounds, np.int32), slabs=slabs,
        stream_cap=int(stream_cap), worst_fl=int(worst_fl),
        padded=int(padded_total), flops=flops_total,
        pad_ratio=padded_total / max(flops_total, 1), shapes=shapes,
    )
    return a2, cfg


def _seg2_slab_digest_step(a2: SpCOO, b: SpCOO, b_rp, bounds, s: int,
                           cnt: int, state, sr: Semiring, *, w: int,
                           s_pad: int, nnz_cap: int, stream_cap: int,
                           slab_out_cap: int, plain: bool = False):
    """One windowed slab: expand with int32 column keys (stride 0), one
    (s_pad, w) batched within-row sort, one compress, digest fold.  The
    ``cnt`` live windows are local rows [0, cnt); the rest are all-sentinel.
    All on the device; ``plain=True`` runs the kernels' plain versions."""
    k = a2.shape[1]
    dev = a2.device
    with span("seg2.slab", a2.row):
        with span("seg2.extract"):
            sub, _row_lo = _slab_extract(a2, k, bounds, s, span_cap=s_pad,
                                         slab_nnz_cap=nnz_cap)
        with span("seg2.expand"):
            colstream, valstream, _total = expand_chunks_compact(
                sub.row, sub.col, sub.val, sub.mask(), b_rp, b.col, b.val, sr,
                stride=0, stream_cap=stream_cap, plain=plain)
        with span("seg2.windows"):
            rowfl, row_start = _row_flops_exact(sub, b_rp, s_pad)
            live = torch.arange(s_pad, device=dev) < cnt
            lens = torch.where(live, rowfl[:s_pad], 0)
            starts = torch.where(live, row_start[:s_pad], 0)
            # window gather: every start + w stays inside the stream by the
            # plan's slack (stream_cap >= slab flops + w, checked in
            # seg2_step)
            j = torch.arange(w, device=dev)
            idx = starts[:, None] + j[None, :]
            keep = j[None, :] < lens[:, None]
            col2d = torch.where(keep, colstream[idx], _SENT)
            val2d = torch.where(keep, valstream[idx], 0.0)
            # release each (s_pad, w) temporary as soon as it is consumed:
            # the sort and the compress allocate several more of that size
            del idx, keep
        with span("seg2.sort"):
            col2d, perm = torch.sort(col2d, dim=1, stable=True)
            val2d = torch.gather(val2d, 1, perm)
            del perm
        with span("seg2.compress"):
            okey, oval, nnz = compress_sorted_packed(
                col2d.reshape(-1), val2d.reshape(-1), sr,
                out_capacity=slab_out_cap, plain=plain)
        with span("seg2.fold"):
            cs = oval.sum()  # entries past nnz hold 0
            nnz_total, checksum, truncated, signed = state
            state = (nnz_total + nnz, checksum + cs,
                     truncated | (nnz >= slab_out_cap), signed)
    return state


def seg2_prepare(a: SpCOO, b: SpCOO, *, flops_cap: int = 1 << 28,
                 pad_cap: int = 1 << 28, slab_out_cap: int | None = None,
                 max_widths: int = 14):
    """Hoistable state for the seg2 digest: (a2, cfg, b_rp, bounds_dev,
    slab_out_cap)."""
    a2, cfg = seg2_plan(a, b, flops_cap=flops_cap, pad_cap=pad_cap,
                        max_widths=max_widths)
    if slab_out_cap is None:
        slab_out_cap = round_capacity_frac(max(cfg["worst_fl"], 2048))
    slab_out_cap = max(-(-slab_out_cap // 128) * 128, 2048)
    bounds_dev = torch.as_tensor(cfg["bounds"].astype(np.int64),
                                 device=a.device)
    return a2, cfg, b.row_ptr(), bounds_dev, slab_out_cap


def seg2_step(b: SpCOO, prep, s: int, state, sr: Semiring = PLUS_TIMES, *,
              plain: bool = False):
    """One slab step on hoisted ``prep`` state (the host loop drives ``s``).
    Returns the new digest state; nothing syncs with the host."""
    a2, cfg, b_rp, bounds_dev, slab_out_cap = prep
    sl = cfg["slabs"][s]
    if sl["flat"]:
        return _slab_digest_step(
            a2, b, b_rp, bounds_dev, s, state[:3], sr,
            span_cap=sl["s_pad"], slab_nnz_cap=sl["nnz_cap"],
            slab_out_cap=slab_out_cap, stream_cap=sl["flat_stream_cap"],
            wide=True, plain=plain) + state[3:]
    if sl["flops"] + sl["w"] > cfg["stream_cap"]:
        raise ValueError(f"slab {s}: windows of width {sl['w']} would read "
                         f"past the {cfg['stream_cap']}-element stream")
    return _seg2_slab_digest_step(
        a2, b, b_rp, bounds_dev, s, sl["cnt"], state, sr,
        w=sl["w"], s_pad=sl["s_pad"], nnz_cap=sl["nnz_cap"],
        stream_cap=cfg["stream_cap"], slab_out_cap=slab_out_cap,
        plain=plain)


def spgemm_streamed_seg2(a: SpCOO, b: SpCOO, sr: Semiring = PLUS_TIMES, *,
                         flops_cap: int = 1 << 28, pad_cap: int = 1 << 28,
                         slab_out_cap: int | None = None,
                         max_widths: int = 14):
    """Slab-streamed digest SpGEMM via the seg2 pipeline: every product
    formed, every duplicate merged, each slab folded into the digest.
    Returns (nnz_total int, checksum float, truncated bool)."""
    prep = seg2_prepare(a, b, flops_cap=flops_cap, pad_cap=pad_cap,
                        slab_out_cap=slab_out_cap, max_widths=max_widths)
    state = seg_zero_state(a.device)
    for s in range(len(prep[1]["slabs"])):
        state = seg2_step(b, prep, s, state, sr)
    nnz, checksum, truncated, _signed = state
    return int(nnz), float(checksum), bool(truncated)
