#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``combblas_tpu_torch``) on one NVIDIA GPU.

Phases, each raising on failure:
  1. the card: its name and power limit from nvidia-smi; no CUDA -> exit 1;
  2. build the CUDA kernels from ``combblas_tpu_torch/csrc`` with nvcc;
  3. every kernel of the seg2 path against its plain PyTorch version on the
     card, at the main path's stream sizes (2^26 elements), for PLUS_TIMES,
     MIN_PLUS and MAX_SECOND, plus one saturating output capacity, with
     kernel and plain times from CUDA events; then the adversarial cases of
     the tiled designs, every output slot after poisoning the caching
     allocator: K1/K3 with a B row of 2^20 entries, 2^20 dead A entries and
     entries on empty B rows, K2/K4 with a run of 2^20 equal keys;
  4. an independent check: the port's scale-16 SSCA R-MAT A² digest against
     ``scipy.sparse`` on the host;
  5. the main path at full size: scale-22 SSCA ef-8 R-MAT A² through
     ``seg2_prepare`` / ``seg2_step``, every slab, the kernels' launch counts
     read around that run, and three slabs re-run with the plain versions;
  6. the SpMM/BFS kernels (ELL-8 sum and max folds, COO SpMM) against their
     plain versions at the shapes of phases 7 and 8 (d = 128 and d = 8),
     at the default piece length and at ``SMALL_PIECE`` (every hub split
     into many pieces), with kernel, plain and ``torch.sparse.mm`` times;
  7. SpMM at full size: a scale-21 ef-16 G500 R-MAT times a (n, 128) X
     through ``spmm(use_kernel=True)``, ``spmm_ell_blocked(nb=6)`` and
     ``spmm_pallas``, each checked against ``torch.sparse.mm``;
  8. BFS at full size: 64 roots on the same graph symmetrized, through
     ``bfs_batch_pull_big(nb=6)``, warm then timed; 4 roots validated
     Graph500-style against the edge list, 2 held against the push BFS (K1);
  9. the chunk-padded expansion K5 against its plain version at the shape
     of phase 10's A², for PLUS_TIMES, MIN_PLUS and MAX_SECOND;
 10. the narrow ``spgemm_pallas`` at full width: A² of the scale-15 G500
     ef-16 R-MAT (the largest square A² whose packed keys fit int32) through
     both routes, K5 -> sort -> K2 and K1 -> sort -> K2, equal to each other
     slot for slot and to ``scipy.sparse`` on the host;
 11. the materialized ``spgemm_auto`` A² of the scale-17 G500 ef-16 R-MAT in
     slabs of at most 2^27 products (``bench.py``'s ``bench_spgemm``): a
     first call with estimate and retry, a timed call with the output sized
     to nnz, checked against ``scipy.sparse``; its C stays on the card (as
     sorted int64 keys row*n+col and values) as the reference of 13 and 14;
 12. the ring push K9 against its plain version, bit for bit: the 4x4 block
     stacks of that A along both axes, phase 14's one launch that moves both
     operands, and a 2^26-element stack, with kernel, plain and
     ``torch.roll`` times;
 13. the distributed SUMMA on block grids on the card, A² of the same
     matrix: ``summa_spgemm_auto`` on a 2x2 grid (the wide route, K3 and K4)
     and a 4x4 grid (packed keys, K1 and K2), and ``summa_spgemm_staged`` on
     the 4x4 grid with ``summa_bounds``' caps; each C, through ``to_local``,
     equal to phase 11's C exactly;
 14. the ring SUMMA ``summa_spgemm_rma`` on the 4x4 grid (K9, p - 1 = 3
     launches a call) and ``summa3d_spgemm`` on a (2, 2, 2) grid, each C
     equal to phase 11's C exactly.

Every bound is the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over the card's float32 rate (67 TFLOP/s), both the H100 SXM's published
peaks.  The last stdout line is ``{"ok": true, "device": {...}}``, printed
only when every phase passed.  Details go to ``chiprun_out/chip_smoke.json``.

Usage: python3 chip_smoke.py [--seed 42] [--scale 22] [--check-scale 16]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from combblas_tpu_torch.gen.graph500 import (
    AUTO_FLOPS_CAP,
    AUTO_SCALE,
    GRAPH_SCALE,
    NARROW_SCALE,
    a2_matrix,
    bfs_frontier,
    bfs_roots,
    spmm_bfs_graphs,
)
from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
from combblas_tpu_torch.models.bfs import (
    bfs_batch_pull_big,
    bfs_push_local,
    validate_bfs,
)
from combblas_tpu_torch.ops.kernels import (
    LAUNCHES,
    _build,
    poison_allocator,
    reset_launches,
)
from combblas_tpu_torch.ops.kernels import compress as kc
from combblas_tpu_torch.ops.kernels import expand as ke
from combblas_tpu_torch.ops.kernels.ell import ell_fold, ell_pieces
from combblas_tpu_torch.ops.kernels.ring import ring_shift
from combblas_tpu_torch.ops.spgemm import (
    _pallas_slab_plan,
    round_capacity_frac,
    spgemm_auto,
    spgemm_flops,
    spgemm_pallas,
    spgemm_pallas_bounds,
    stream_capacity,
)
from combblas_tpu_torch.ops.spgemm_seg import (
    seg2_prepare,
    seg2_step,
    seg_zero_state,
)
from combblas_tpu_torch.ops.spmm_ell import spmm_ell_prepare
from combblas_tpu_torch.ops.spmm_ell_blocked import (
    ell_blocked_prepare,
    spmm_ell_blocked,
)
from combblas_tpu_torch.ops.spmm_kernel import (
    PIECE_LEN,
    _spmm_coo,
    spmm_pallas,
)
from combblas_tpu_torch.ops.spmv import spmm
from combblas_tpu_torch.parallel.dist import DistSpMat
from combblas_tpu_torch.parallel.grid import ProcGrid
from combblas_tpu_torch.profile_summa import grid_cells
from combblas_tpu_torch.semiring import MAX_SECOND, MIN_PLUS, PLUS_TIMES

SEMIRINGS = (PLUS_TIMES, MIN_PLUS, MAX_SECOND)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "expand_i32": ("combblas_tpu_torch/csrc/expand.cu",
                   "combblas_tpu/ops/pallas/expand_kernel.py:295"),
    "compress_i32": ("combblas_tpu_torch/csrc/compress.cu",
                     "combblas_tpu/ops/pallas/compress_kernel.py:242"),
    "expand_i64": ("combblas_tpu_torch/csrc/expand.cu",
                   "combblas_tpu/ops/pallas/expand_kernel.py:505"),
    "compress_i64": ("combblas_tpu_torch/csrc/compress.cu",
                     "combblas_tpu/ops/pallas/compress_kernel.py:496"),
    "ell_sum": ("combblas_tpu_torch/csrc/ell.cu",
                "combblas_tpu/ops/pallas/spmm_ell.py:141"),
    "ell_max": ("combblas_tpu_torch/csrc/ell.cu",
                "combblas_tpu/ops/pallas/spmm_ell_blocked.py:178"),
    "spmm_coo": ("combblas_tpu_torch/csrc/spmm_coo.cu",
                 "combblas_tpu/ops/pallas/spmm_kernel.py:119"),
    "expand_chunks_i32": ("combblas_tpu_torch/csrc/expand.cu",
                          "combblas_tpu/ops/pallas/expand_kernel.py:574"),
    "ring_shift": ("combblas_tpu_torch/csrc/ring.cu",
                   "combblas_tpu/parallel/rma.py:47"),
}
#: The forced small piece length of phase 6's second check (positions of
#: an ELL piece, entries of a K8 range).
SMALL_PIECE = 32
#: The H100 SXM's published peaks: HBM bytes/s and float32 FLOP/s outside
#: the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 3 --

def _expand_inputs(gen, dev, wide: bool, log2: int):
    """A slab's entries and a B over 2^(log2-4) columns whose product stream
    is ~2^log2 long: B rows of 0..16 entries (mean 8), 2^(log2-3) A
    entries."""
    k = n = 1 << (log2 - 4)
    deg = torch.randint(0, 17, (k,), generator=gen, device=dev)
    b_rp = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    b_rp[1:] = torch.cumsum(deg, 0)
    nb = int(b_rp[-1])
    b_col = torch.randint(0, n, (nb,), generator=gen, device=dev,
                          dtype=torch.int32)
    b_val = torch.rand(nb, generator=gen, device=dev) + 0.5
    na = 1 << (log2 - 3)
    rows = (1 << (log2 - 6)) if wide else (1 << (log2 - 10))
    a_row = torch.sort(torch.randint(0, rows, (na,), generator=gen,
                                     device=dev, dtype=torch.int32))[0]
    a_col = torch.randint(0, k, (na,), generator=gen, device=dev,
                          dtype=torch.int32)
    a_val = torch.rand(na, generator=gen, device=dev) + 0.5
    valid = torch.ones(na, dtype=torch.bool, device=dev)
    return (a_row, a_col, a_val, valid, b_rp, b_col, b_val), n


def check_expand(gen, dev, wide: bool, log2: int = 26) -> dict:
    args, n = _expand_inputs(gen, dev, wide, log2)
    fn = ke.expand_chunks_compact_wide if wide else ke.expand_chunks_compact
    stride = n + 1 if wide else 0
    cap = 1 << (log2 + 1)
    err = 0.0
    for sr in SEMIRINGS:
        key, val, total = fn(*args, sr, stride=stride, stream_cap=cap)
        pkey, pval, ptotal = fn(*args, sr, stride=stride, stream_cap=cap,
                                plain=True)
        t = int(ptotal)
        if int(total) != t or not torch.equal(key, pkey):
            raise AssertionError(f"expand wide={wide} {sr.name}: keys/count "
                                 f"differ ({int(total)} vs {t})")
        if not torch.equal(val.view(torch.int32), pval.view(torch.int32)):
            raise AssertionError(f"expand wide={wide} {sr.name}: values "
                                 "differ")
        err = max(err, float((val - pval).abs().max()))
    # saturating capacity: the first `small` products, the count unclamped
    small = t // 2
    skey, sval, stot = fn(*args, PLUS_TIMES, stride=stride, stream_cap=small)
    if int(stot) != t or not torch.equal(skey, pkey[:small]):
        raise AssertionError(f"expand wide={wide}: saturated run differs")
    ms = cuda_ms(lambda: fn(*args, PLUS_TIMES, stride=stride,
                            stream_cap=cap))
    plain_ms = cuda_ms(lambda: fn(*args, PLUS_TIMES, stride=stride,
                                  stream_cap=cap, plain=True), reps=2)
    # inputs: A's (row, col, val, valid), B's row pointer and (col, val);
    # outputs: the whole (key, val) stream of cap slots; one multiply each
    a_row, _a_col, _a_val, _valid, b_rp, b_col, _b_val = args
    nbytes = (a_row.numel() * 13 + b_rp.numel() * 8 + b_col.numel() * 8
              + cap * (12 if wide else 8))
    b = bound(nbytes, t)
    log(f"  expand {'i64' if wide else 'i32'}: {t} products, exact for "
        f"{[s.name for s in SEMIRINGS]}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, elements=t,
                library_ms=None, **b)


def _compress_inputs(gen, dev, wide: bool, log2: int):
    """A sorted 2^log2-element stream.  Windowed (int32): windows of 1024,
    each sorted with a sentinel tail, ~3 products per output entry.  Flat
    (int64): 2^(log2-6) rows of ~64 products over 48 columns, keyed
    row*(n+1)+col, sorted, sentinel-padded."""
    n_el = 1 << log2
    sent32 = torch.iinfo(torch.int32).max
    if not wide:
        s, w = 1 << (log2 - 10), 1024
        lens = torch.randint(0, w, (s, 1), generator=gen, device=dev)
        span = torch.clamp(lens // 3, min=1)
        keys = (torch.rand((s, w), generator=gen, device=dev) * span).long()
        keys = keys.to(torch.int32) * 4099
        j = torch.arange(w, device=dev)[None, :]
        keys = torch.where(j < lens, keys, sent32)
        keys = torch.sort(keys, dim=1)[0].reshape(-1)
        vals = torch.rand(n_el, generator=gen, device=dev) + 0.25
        return keys, vals, 0
    n = 1 << (log2 - 4)
    nreal = n_el - (1 << (log2 - 6))
    row = torch.sort(torch.randint(0, 1 << (log2 - 6), (nreal,),
                                   generator=gen, device=dev))[0]
    col = torch.randint(0, 48, (nreal,), generator=gen, device=dev)
    keys = torch.full((n_el,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    keys[:nreal] = torch.sort(row * (n + 1) + col * (n // 48))[0]
    vals = torch.rand(n_el, generator=gen, device=dev) + 0.25
    return keys, vals, n + 1


def check_compress(gen, dev, wide: bool, log2: int = 26) -> dict:
    """The compress kernel against its plain version.  Keys stay packed, so
    for int64 this is K4 alone; the (row, col) split that
    ``compress_sorted_wide`` adds is timed on its own line."""
    keys, vals, stride = _compress_inputs(gen, dev, wide, log2)
    fn = kc.compress_sorted_wide_keys if wide else kc.compress_sorted_packed
    cap = 1 << log2
    err = 0.0
    for sr in SEMIRINGS:
        gk, gv, gn = fn(keys, vals, sr, out_capacity=cap)
        pk, pv, pn = fn(keys, vals, sr, out_capacity=cap, plain=True)
        nnz = int(pn)
        if int(gn) != nnz or nnz == 0:
            raise AssertionError(f"compress wide={wide} {sr.name}: nnz "
                                 f"{int(gn)} vs {nnz}")
        if not torch.equal(gk, pk):
            raise AssertionError(f"compress wide={wide} {sr.name}: keys "
                                 "differ")
        if sr.add_kind == "sum":
            torch.testing.assert_close(gv, pv, rtol=1e-6, atol=0)
        elif not torch.equal(gv, pv):
            raise AssertionError(f"compress wide={wide} {sr.name}: values "
                                 "differ")
        err = max(err, float((gv - pv).abs().max()))
    small = -(-(nnz // 2) // 128) * 128
    gk, _gv, gn = fn(keys, vals, PLUS_TIMES, out_capacity=small)
    pk, _pv, pn = fn(keys, vals, PLUS_TIMES, out_capacity=small, plain=True)
    if int(gn) != small or int(pn) != small:
        raise AssertionError(f"compress wide={wide}: no saturation at {small}")
    if not torch.equal(gk, pk):
        raise AssertionError(f"compress wide={wide}: saturated keys differ")
    ms = cuda_ms(lambda: fn(keys, vals, PLUS_TIMES, out_capacity=cap))
    plain_ms = cuda_ms(lambda: fn(keys, vals, PLUS_TIMES, out_capacity=cap,
                                  plain=True), reps=2)
    log(f"  compress {'i64' if wide else 'i32'}: {keys.numel()} elements -> "
        f"{nnz}; agree for {[s.name for s in SEMIRINGS]} and saturation at "
        f"{small}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    # inputs: keys and values; outputs: cap (key, val) slots and the count;
    # one add per element
    ksize = keys.element_size()
    b = bound(keys.numel() * (ksize + 4) + cap * (ksize + 4) + 8,
              keys.numel())
    log(f"  compress {'i64' if wide else 'i32'} bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']})")
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               elements=keys.numel(), library_ms=None, **b)
    if wide:
        out["with_split_ms"] = cuda_ms(lambda: kc.compress_sorted_wide(
            keys, vals, PLUS_TIMES, out_capacity=cap, stride=stride))
        log(f"  compress i64 with the (row, col) split of "
            f"compress_sorted_wide: {out['with_split_ms']:.3f} ms")
    return out


def _quarters(gen, size, dev):
    """Values in {0.25, 0.5, 0.75, 1}: every run's sum is exact in float32
    whatever the fold order (the kernel folds a long run in its own order,
    the plain version's scatter_reduce in the card's)."""
    return torch.randint(1, 5, (size,), generator=gen, device=dev) / 4


def _adversarial_expand(gen, dev, wide: bool, log2: int = 20) -> dict:
    """K1/K3 on a B row of 2^log2 entries taken by 4 A entries, 2^log2
    consecutive dead A entries and 2^(log2-2) entries on empty B rows,
    between 2^log2 entries on rows of 0..16 each side: every slot against
    the plain version after poisoning, at a capacity past the total and one
    that cuts inside the first hub entry."""
    k = n = 1 << (log2 - 4)
    deg = torch.randint(0, 17, (k,), generator=gen, device=dev)
    deg[3] = 0
    deg[7] = 1 << log2
    b_rp = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    b_rp[1:] = torch.cumsum(deg, 0)
    nb = int(b_rp[-1])
    b_col = torch.randint(0, n, (nb,), generator=gen, device=dev,
                          dtype=torch.int32)
    b_val = torch.rand(nb, generator=gen, device=dev) + 0.5
    live, empty = 1 << log2, 1 << (log2 - 2)
    a_col = torch.cat([
        torch.randint(0, k, (live,), generator=gen, device=dev),
        torch.randint(0, k, (live,), generator=gen, device=dev),  # dead
        torch.full((empty,), 3, device=dev),                      # B row 0
        torch.randint(0, k, (live,), generator=gen, device=dev)])
    a_col = torch.where(a_col == 7, 8, a_col)  # the hub takes 4 entries
    a_col[[live // 2, 2 * live + empty + 5, 2 * live + empty + 7, -1]] = 7
    a_col = a_col.to(torch.int32)
    na = a_col.shape[0]
    valid = torch.ones(na, dtype=torch.bool, device=dev)
    valid[live:2 * live] = False
    rows = (1 << 10) if wide else (1 << 8)
    a_row = torch.sort(torch.randint(0, rows, (na,), generator=gen,
                                     device=dev, dtype=torch.int32))[0]
    a_val = torch.rand(na, generator=gen, device=dev) + 0.5
    args = (a_row, a_col, a_val, valid, b_rp, b_col, b_val)
    fn = ke.expand_chunks_compact_wide if wide else ke.expand_chunks_compact
    cnt = torch.where(valid, deg[a_col.long()], 0)
    total = int(cnt.sum())
    first_hub = int(cnt[:live // 2].sum())
    ksize = 8 if wide else 4
    caps = [total + 12345, first_hub + live // 2 + 3]
    for sr in SEMIRINGS:
        for cap in caps:
            poison_allocator([cap * ksize, cap * 4], dev)
            key, val, tot = fn(*args, sr, stride=n + 1, stream_cap=cap)
            pkey, pval, ptot = fn(*args, sr, stride=n + 1, stream_cap=cap,
                                  plain=True)
            if int(tot) != int(ptot) or int(tot) != total:
                raise AssertionError(f"adversarial expand wide={wide}: total "
                                     f"{int(tot)} vs {int(ptot)}")
            if not (torch.equal(key, pkey) and torch.equal(
                    val.view(torch.int32), pval.view(torch.int32))):
                raise AssertionError(f"adversarial expand wide={wide} "
                                     f"{sr.name} cap {cap}: slots differ")
    ms = cuda_ms(lambda: fn(*args, PLUS_TIMES, stride=n + 1,
                            stream_cap=caps[0]))
    log(f"  adversarial expand {'i64' if wide else 'i32'}: "
        f"{total} products (hub row 2^{log2} x 4, 2^{log2} dead, "
        f"2^{log2 - 2} on empty rows), every slot equal to plain at caps "
        f"{caps}; kernel {ms:.3f} ms")
    return dict(products=total, caps=caps, ms=ms)


def _adversarial_compress(gen, dev, wide: bool, log2: int = 20) -> dict:
    """K2/K4 on a stream of about 2^(log2+2) elements with a run of 2^log2
    equal keys in its middle, sentinel stretches between sorted stretches,
    and n not a multiple of the tile: every slot against the plain version
    after poisoning, at a capacity with room and one that cuts."""
    side = 3 << (log2 - 1)
    left = torch.sort(torch.randint(0, 1 << log2, (side,), generator=gen,
                                    device=dev))[0]
    right = torch.sort(torch.randint(2 << log2, 4 << log2, (side,),
                                     generator=gen, device=dev))[0]
    sent = torch.iinfo(torch.int64).max
    keys = torch.cat([left, torch.full((777,), sent, device=dev),
                      torch.full((1 << log2,), (1 << log2) + 7, device=dev),
                      right, torch.full((1001,), sent, device=dev),
                      left[:4093]])
    if not wide:
        keys = torch.where(keys == sent, torch.iinfo(torch.int32).max,
                           keys).to(torch.int32)
    vals = _quarters(gen, keys.shape[0], dev)
    fn = kc.compress_sorted_wide_keys if wide else kc.compress_sorted_packed
    head = torch.ones_like(keys, dtype=torch.bool)
    head[1:] = keys[1:] != keys[:-1]
    nnz = int((head & (keys != ke.KEY_SENTINEL[keys.dtype])).sum())
    caps = [nnz + 4096, nnz // 2 + 1]
    for sr in SEMIRINGS:
        for cap in caps:
            poison_allocator([cap * keys.element_size(), cap * 4], dev)
            gk, gv, gn = fn(keys, vals, sr, out_capacity=cap)
            pk, pv, pn = fn(keys, vals, sr, out_capacity=cap, plain=True)
            if int(gn) != int(pn) or int(gn) != min(nnz, cap):
                raise AssertionError(f"adversarial compress wide={wide}: nnz "
                                     f"{int(gn)} vs {int(pn)}")
            if not torch.equal(gk, pk):
                raise AssertionError(f"adversarial compress wide={wide} "
                                     f"{sr.name} cap {cap}: keys differ")
            if sr.add_kind == "sum":
                torch.testing.assert_close(gv, pv, rtol=1e-6, atol=0)
            elif not torch.equal(gv, pv):
                raise AssertionError(f"adversarial compress wide={wide} "
                                     f"{sr.name} cap {cap}: values differ")
    ms = cuda_ms(lambda: fn(keys, vals, PLUS_TIMES, out_capacity=caps[0]))
    log(f"  adversarial compress {'i64' if wide else 'i32'}: "
        f"{keys.shape[0]} elements -> {nnz} (one run of 2^{log2}), every slot "
        f"equal to plain at caps {caps}; kernel {ms:.3f} ms")
    return dict(elements=keys.shape[0], nnz=nnz, caps=caps, ms=ms)


def check_adversarial(gen, dev, log2: int = 20) -> dict:
    """Phase 3's adversarial cases for K1-K4 (tiles crossed by hub rows,
    long runs and dead stretches)."""
    return {f"{kind}_{'i64' if wide else 'i32'}": fn(gen, dev, wide, log2)
            for kind, fn in (("expand", _adversarial_expand),
                             ("compress", _adversarial_compress))
            for wide in (False, True)}


# ------------------------------------------------------------ phases 4, 5 --

def run_slabs(a, prep, dev, sync_each: bool):
    """Every slab of the digest; with ``sync_each`` one scalar sync per slab
    (its nnz), returning per-slab nnz deltas and seconds."""
    state = seg_zero_state(dev)
    nnz_prev, per_nnz, per_secs = 0, [], []
    for s in range(len(prep[1]["slabs"])):
        ts = time.perf_counter()
        state = seg2_step(a, prep, s, state, PLUS_TIMES)
        if sync_each:
            nnz_now = int(state[0])
            per_secs.append(time.perf_counter() - ts)
            per_nnz.append(nnz_now - nnz_prev)
            nnz_prev = nnz_now
    return state, per_nnz, per_secs


def check_scipy(seed: int, scale: int, dev) -> None:
    import scipy.sparse as sp

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, 8, probs=SSCA_PROBS)
    prep = seg2_prepare(a, a, flops_cap=1 << 20, max_widths=20)
    state, _, _ = run_slabs(a, prep, dev, sync_each=False)
    nnz, cks, trunc = int(state[0]), float(state[1]), bool(state[2])
    row, col, val, annz, shape = a.to_numpy()
    s = sp.csr_matrix((val[:annz].astype(np.float64),
                       (row[:annz], col[:annz])), shape=shape)
    c = s @ s
    ref_nnz, ref_cks = int(c.nnz), float(c.sum())
    rel = abs(cks - ref_cks) / abs(ref_cks)
    nw = sum(not sl["flat"] for sl in prep[1]["slabs"])
    log(f"  scale {scale}: {len(prep[1]['slabs'])} slabs ({nw} windowed), "
        f"nnz {nnz} vs scipy {ref_nnz}, checksum {cks!r} vs {ref_cks!r} "
        f"(rel {rel:.2e}), truncated {trunc}")
    if nnz != ref_nnz or trunc or not rel <= 1e-4:
        raise AssertionError("scale-%d digest disagrees with scipy" % scale)


def main_path(seed: int, scale: int, dev, details: dict) -> dict:
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, 8, probs=SSCA_PROBS)
    torch.cuda.synchronize()
    gen_secs = time.perf_counter() - t
    t = time.perf_counter()
    flops = spgemm_flops(a, a)
    prep = seg2_prepare(a, a, flops_cap=1 << 28, max_widths=20)
    plan_secs = time.perf_counter() - t
    cfg = prep[1]
    slabs = cfg["slabs"]
    if cfg["flops"] != flops:
        raise AssertionError(f"plan covers {cfg['flops']} of {flops} products")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, per_nnz, per_secs = run_slabs(a, prep, dev, sync_each=True)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    nnz_c, checksum, truncated = (int(state[0]), float(state[1]),
                                  bool(state[2]))
    n_win = sum(not sl["flat"] for sl in slabs)
    line = dict(
        scale=scale, seed=seed, nnz_a=int(a.nnz), flops=flops,
        slabs=len(slabs), windowed_slabs=n_win, shapes=len(cfg["shapes"]),
        pad_ratio=cfg["pad_ratio"], gen_secs=gen_secs, plan_secs=plan_secs,
        secs=secs, products_per_s=flops / secs, nnz_c=nnz_c,
        checksum=checksum, truncated=truncated,
        expand_launches=launches["expand_i32"] + launches["expand_i64"],
        compress_launches=(launches["compress_i32"]
                           + launches["compress_i64"]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(json.dumps(line))
    details["slabs"] = [dict(sl, nnz=per_nnz[s], secs=per_secs[s])
                        for s, sl in enumerate(slabs)]
    if truncated or nnz_c <= 0 or not math.isfinite(checksum):
        raise AssertionError("scale-22 digest is truncated or not finite")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(expand_i32=n_win, compress_i32=n_win,
                expand_i64=len(slabs) - n_win,
                compress_i64=len(slabs) - n_win)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    # three slabs again, kernels and plain versions, each from a zero state
    win = [s for s, sl in enumerate(slabs) if not sl["flat"]]
    flat = [s for s, sl in enumerate(slabs) if sl["flat"]]
    picks = []
    if win:
        picks.append(max(win, key=lambda s: slabs[s]["flops"]))
    picks.append(len(slabs) // 2)
    if flat:
        picks.append(flat[0])
    for s in dict.fromkeys(picks):
        got = seg2_step(a, prep, s, seg_zero_state(dev), PLUS_TIMES)
        ref = seg2_step(a, prep, s, seg_zero_state(dev), PLUS_TIMES,
                        plain=True)
        g_nnz, r_nnz = int(got[0]), int(ref[0])
        g_cks, r_cks = float(got[1]), float(ref[1])
        rel = abs(g_cks - r_cks) / max(abs(r_cks), 1e-30)
        log(f"  slab {s} ({'flat' if slabs[s]['flat'] else 'w=%d' % slabs[s]['w']}"
            f", {slabs[s]['flops']} products): nnz {g_nnz} kernels vs "
            f"{r_nnz} plain (main pass {per_nnz[s]}), checksum rel "
            f"{rel:.2e}")
        if not (g_nnz == r_nnz == per_nnz[s]) or not rel <= 1e-5:
            raise AssertionError(f"slab {s}: kernels and plain versions "
                                 "disagree")
        if bool(got[2]) or bool(ref[2]):
            raise AssertionError(f"slab {s}: truncated")
    return launches

# ------------------------------------------------------------ phases 6-8 --

def _csr(a):
    """``a`` as a torch sparse CSR tensor, for ``torch.sparse.mm``: the
    yardstick and the independent check, never used by the port."""
    nnz = int(a.nnz)
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(a.row_ptr(), a.col[:nnz].long(),
                                       a.val[:nnz], size=a.shape,
                                       check_invariants=False)


def _ell_bound(prep, x, nnz: int) -> dict:
    """Bytes: what the fold takes and gives (cols + vals over 8*P, the run
    table, X and Y once each); the piece table is the kernel's own
    bookkeeping.  Operations: a multiply and an add per entry and
    column."""
    p, d = prep["P"], x.shape[1]
    plan = p * 8 * 8 + prep["run_start"].numel() * 8
    y_bytes = prep["run_start"].shape[0] * 8 * d * 4
    return bound(plan + x.numel() * 4 + y_bytes, 2 * nnz * d)


def _same(got, want, op: str, what: str) -> float:
    """Max exact, sum within rtol 1e-5 (another order of additions); the
    largest absolute difference."""
    if op == "max":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel and plain differ")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0, msg=what)
    return float((got - want).abs().max())


def _pieces_line(pieces, d: int, op: str) -> dict:
    tiles = pieces.folds[:, 2]
    return dict(piece_len=pieces.piece_len, pieces=pieces.table.shape[0],
                split_groups=int((tiles > 0).sum()),
                scratch_bytes=pieces.tiles * 8 * d * (8 if op == "sum" else 4))


def check_ell(label: str, prep, x, op: str, nnz: int, csr=None) -> dict:
    """The ELL kernel against its plain version on one plan and X, on the
    plan's piece table and on pieces of ``SMALL_PIECE`` positions."""
    args = (prep["cols"].t(), prep["vals"].t(), prep["run_start"],
            prep["run_len"], x)
    kw = dict(bs_c=prep["bs_c"], op=op)
    want = ell_fold(*args, plain=True, **kw)
    small = ell_pieces(prep["run_start"], prep["run_len"], SMALL_PIECE)
    err = max(_same(ell_fold(*args, pieces=pieces, **kw), want, op,
                    f"ell_{op} {label} L={pieces.piece_len}")
              for pieces in (prep["pieces"], small))
    d = x.shape[1]
    group_len = prep["run_len"].sum(1)
    out = dict(label=label, max_abs_err=err,
               max_group_positions=int(group_len.max()),
               mean_group_positions=float(group_len.float().mean()),
               pad_ratio=8 * int(group_len.sum()) / nnz,
               **_pieces_line(prep["pieces"], d, op),
               small=_pieces_line(small, d, op),
               ms=cuda_ms(lambda: ell_fold(*args, pieces=prep["pieces"],
                                           **kw)),
               plain_ms=cuda_ms(lambda: ell_fold(*args, plain=True, **kw),
                                reps=2),
               library_ms=None, **_ell_bound(prep, x, nnz))
    if csr is not None:     # the sum over the plan's own row order is A @ X
        out["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x))
    log(f"  ell_{op} {label}: max abs err {err:.3g} (L = "
        f"{out['piece_len']} and {SMALL_PIECE}); kernel {out['ms']:.3f} "
        f"ms, plain {out['plain_ms']:.3f} ms, torch.sparse.mm "
        f"{out['library_ms'] if csr is None else round(out['library_ms'], 3)}"
        f" ms, bound {out['bound_ms']:.3f} ms ({out['bound_by']}); groups "
        f"of {out['mean_group_positions']:.1f} positions on average, the "
        f"longest {out['max_group_positions']}, ELL slots / nnz "
        f"{out['pad_ratio']:.3f}; {out['pieces']} pieces, "
        f"{out['split_groups']} groups split, scratch "
        f"{out['scratch_bytes']} B (L = {SMALL_PIECE}: {out['small']})")
    return out


def check_spmm_coo(label: str, a, x, csr) -> dict:
    """K8 against its plain version, at the default range length and at
    ``SMALL_PIECE`` entries."""
    want = spmm_pallas(a, x, plain=True)
    small = _spmm_coo(a.row_ptr(), a.col, a.val.float().contiguous(), x,
                      plain=False, piece_len=SMALL_PIECE)
    err = max(_same(got, want, "sum", f"spmm_coo {label} L={n}")
              for got, n in ((spmm_pallas(a, x), PIECE_LEN),
                             (small, SMALL_PIECE)))
    nnz, d = int(a.nnz), x.shape[1]
    rp = a.row_ptr()
    deg = rp[1:] - rp[:-1]
    b = bound((a.shape[0] + 1) * 8 + nnz * 8 + x.numel() * 4
              + a.shape[0] * d * 4, 2 * nnz * d)
    out = dict(label=label, max_abs_err=err,
               max_row_entries=int(deg.max()), piece_len=PIECE_LEN,
               split_rows=int((deg > PIECE_LEN).sum()),
               scratch_bytes=2 * -(-nnz // PIECE_LEN) * d * 8,
               ms=cuda_ms(lambda: spmm_pallas(a, x)),
               plain_ms=cuda_ms(lambda: spmm_pallas(a, x, plain=True),
                                reps=2),
               library_ms=cuda_ms(lambda: torch.sparse.mm(csr, x)), **b)
    log(f"  spmm_coo {label}: max abs err {err:.3g} (L = {PIECE_LEN} and "
        f"{SMALL_PIECE}); kernel {out['ms']:.3f} ms, plain "
        f"{out['plain_ms']:.3f} ms, torch.sparse.mm "
        f"{out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms "
        f"({out['bound_by']}); longest row {out['max_row_entries']}, "
        f"{out['split_rows']} rows split, scratch {out['scratch_bytes']} B")
    return out


def build_graphs(seed: int, scale: int, dev) -> dict:
    """The SpMM graph (G500 R-MAT, edgefactor 16), its symmetrized
    loop-free twin for BFS and X (``gen/graph500.py``), and the plans;
    with their set-up seconds."""
    t = time.perf_counter()
    g = spmm_bfs_graphs(seed, dev, scale)
    torch.cuda.synchronize()
    g["gen_secs"] = time.perf_counter() - t
    for key, make in (
            ("ell1", lambda: spmm_ell_prepare(g["a"])),
            ("ell6", lambda: ell_blocked_prepare(g["a"], 6)),
            ("bfs6", lambda: ell_blocked_prepare(g["s"], 6, relabel_cols=True,
                                                 binary=True)),
            ("bfs1", lambda: ell_blocked_prepare(g["s"], 1, relabel_cols=True,
                                                 binary=True))):
        t = time.perf_counter()
        g[key] = make()
        torch.cuda.synchronize()
        g[f"{key}_secs"] = time.perf_counter() - t
    log(f"  scale {scale}: A nnz {int(g['a'].nnz)}, symmetrized nnz "
        f"{int(g['s'].nnz)}, generated in {g['gen_secs']:.2f} s; prepare "
        f"secs: ell nb=1 {g['ell1_secs']:.3f}, nb=6 {g['ell6_secs']:.3f}, "
        f"bfs nb=6 {g['bfs6_secs']:.3f}, bfs nb=1 {g['bfs1_secs']:.3f}")
    return g


def check_spmm_bfs_kernels(g: dict, dev) -> dict:
    """Phase 6: every SpMM/BFS kernel against its plain version at the
    shapes of phases 7 and 8."""
    a, s = g["a"], g["s"]
    nnz_a, nnz_s = int(a.nnz), int(s.nnz)
    csr = _csr(a)
    f = bfs_frontier(g["bfs6"]["n_pad"], s.shape[0], dev)
    out = {
        "ell_sum": [check_ell("nb=1 d=128", g["ell1"], g["x"], "sum", nnz_a,
                              csr),
                    check_ell("nb=6 d=128", g["ell6"], g["x"], "sum", nnz_a,
                              csr),
                    check_ell("nb=1 d=8", g["ell1"], g["x8"], "sum", nnz_a,
                              csr)],
        "ell_max": [check_ell("nb=6 d=128", g["bfs6"], f, "max", nnz_s),
                    check_ell("nb=1 d=128", g["bfs1"], f, "max", nnz_s),
                    check_ell("nb=6 d=8", g["bfs6"], f[:, :8].contiguous(),
                              "max", nnz_s)],
        "spmm_coo": [check_spmm_coo("d=128", a, g["x"], csr),
                     check_spmm_coo("d=8", a, g["x8"], csr)],
    }
    return out


def spmm_full(g: dict) -> dict:
    """Phase 7: SpMM at full size through the port's entry points, launch
    counts read around one call of each (each route launches its one
    kernel once: ``ell_sum`` for the first two, K6 and K7's sum fold,
    ``spmm_coo`` for the third), then timed and checked against
    ``torch.sparse.mm``."""
    a, x = g["a"], g["x"]
    nnz, d = int(a.nnz), x.shape[1]
    routes = {
        "spmm_use_kernel": lambda: spmm(a, x, use_kernel=True,
                                        prep=g["ell1"]),
        "spmm_ell_blocked_nb6": lambda: spmm_ell_blocked(a, x,
                                                         prep=g["ell6"]),
        "spmm_pallas": lambda: spmm_pallas(a, x),
    }
    want = {"spmm_use_kernel": "ell_sum", "spmm_ell_blocked_nb6": "ell_sum",
            "spmm_pallas": "spmm_coo"}
    ys, by_route = {}, {}
    for name, fn in routes.items():
        torch.cuda.synchronize()
        reset_launches()
        ys[name] = fn()
        torch.cuda.synchronize()
        by_route[name] = {k: v for k, v in LAUNCHES.items() if v}
        if by_route[name] != {want[name]: 1}:
            raise AssertionError(f"{name} launched {by_route[name]}")
    launches = {k: sum(r.get(k, 0) for r in by_route.values())
                for k in LAUNCHES}
    ref = torch.sparse.mm(_csr(a), x)
    bytes_moved = nnz * (4 + 4 + 4) + nnz * d * 4 * 2   # bench_spmm's count
    out = dict(nnz=nnz, d=d, launches=launches, launches_by_route=by_route,
               prepare_secs={"ell_nb1": g["ell1_secs"],
                             "ell_nb6": g["ell6_secs"]})
    for name, fn in routes.items():
        torch.testing.assert_close(ys[name], ref, rtol=1e-4, atol=1e-6)
        secs = cuda_ms(fn) / 1e3
        out[name] = dict(secs=secs, gb_per_s=bytes_moved / secs / 1e9,
                         gflops=2 * nnz * d / secs / 1e9)
        log(f"  {name}: {secs:.5f} s, {out[name]['gb_per_s']:.1f} GB/s, "
            f"{out[name]['gflops']:.1f} GFLOP/s; agrees with "
            f"torch.sparse.mm at rtol 1e-4")
    log(f"  prepare secs: ell nb=1 {g['ell1_secs']:.3f}, nb=6 "
        f"{g['ell6_secs']:.3f}; launches by route {by_route}")
    return out


def bfs_full(g: dict, seed: int) -> dict:
    """Phase 8: 64-root BFS at full size as ``bench_bfs`` runs it: warm
    once, then timed; the ELL max launches of the first timed run must
    equal its level sweeps."""
    s, prep = g["s"], g["bfs6"]
    rp = s.row_ptr()
    deg = rp[1:] - rp[:-1]
    roots = bfs_roots(s, seed)
    p, lv = bfs_batch_pull_big(s, roots, prep=prep)            # warm
    torch.cuda.synchronize()
    times = []
    for rep in range(2):
        if rep == 0:
            reset_launches()
        t = time.perf_counter()
        p, lv = bfs_batch_pull_big(s, roots, prep=prep)
        int(lv[0, 0])                                  # scalar sync
        times.append(time.perf_counter() - t)
        if rep == 0:
            launches = dict(LAUNCHES)
    batch_secs = min(times)
    sweeps = int(lv.max()) + 1
    if launches["ell_max"] != sweeps:
        raise AssertionError(f"ell_max launched {launches['ell_max']} times "
                             f"for {sweeps} level sweeps")
    per_root = batch_secs / len(roots)
    vis = lv >= 0
    edges = ((vis.long() * deg[None, :]).sum(1) // 2).tolist()
    teps = [e / per_root for e in edges]
    hmean = len(teps) / sum(1.0 / t for t in teps if t > 0)
    for i, r in enumerate(roots[:4]):
        if not validate_bfs(s, int(r), p[i], lv[i]):
            raise AssertionError(f"BFS from root {r} does not validate")
    for i, r in enumerate(roots[:2]):
        pp, pl = bfs_push_local(s, int(r))
        if not torch.equal(pl, lv[i]):
            raise AssertionError(f"root {r}: pull and push levels differ")
        if not validate_bfs(s, int(r), pp, pl):
            raise AssertionError(f"root {r}: push BFS does not validate")
    out = dict(nnz=int(s.nnz), roots=len(roots), batch_secs=batch_secs,
               times=times, levels=sweeps - 1, sweeps=sweeps,
               visited=int(vis[0].sum()), gteps=hmean / 1e9,
               prepare_secs=g["bfs6_secs"], ell_max_launches=launches[
                   "ell_max"])
    log(f"  {len(roots)} roots: batch {batch_secs:.4f} s (runs {times}), "
        f"{sweeps - 1} levels ({sweeps} sweeps = {launches['ell_max']} "
        f"ell_max launches), visited {out['visited']}, harmonic-mean "
        f"{out['gteps']:.3f} GTEPS, prepare {g['bfs6_secs']:.3f} s; 4 roots "
        f"validate, 2 roots equal the push BFS's levels")
    return out


# ----------------------------------------------------------- phases 9-11 --

def check_expand_chunks(a) -> dict:
    """Phase 9: K5 against its plain version on A²'s inputs (B = A), at
    the chunk capacity ``spgemm_pallas_bounds`` gives phase 10: keys and
    values bit for bit."""
    b_rp = a.row_ptr()
    chunk_cap, _ = spgemm_pallas_bounds(a, a)
    stride = a.shape[1] + 1
    args = (a.row, a.col, a.val, a.mask(), b_rp, a.col, a.val)
    for sr in SEMIRINGS:
        key, val = ke.expand_chunks(*args, sr, stride=stride,
                                    chunk_cap=chunk_cap)
        pkey, pval = ke.expand_chunks(*args, sr, stride=stride,
                                      chunk_cap=chunk_cap, plain=True)
        if not torch.equal(key, pkey):
            raise AssertionError(f"expand_chunks {sr.name}: keys differ")
        if not torch.equal(val.view(torch.int32), pval.view(torch.int32)):
            raise AssertionError(f"expand_chunks {sr.name}: values differ")
    del key, val, pkey, pval
    products = spgemm_flops(a, a)
    ms = cuda_ms(lambda: ke.expand_chunks(*args, PLUS_TIMES, stride=stride,
                                          chunk_cap=chunk_cap))
    plain_ms = cuda_ms(lambda: ke.expand_chunks(
        *args, PLUS_TIMES, stride=stride, chunk_cap=chunk_cap, plain=True),
        reps=2)
    # inputs: A's (row, col, val, valid), B's row pointer and the B entries
    # that some A entry's row reaches; output: the whole chunk-padded
    # stream, pads included; one multiply a product
    k = a.shape[1]
    hit = torch.zeros(k, dtype=torch.bool, device=a.device)
    hit[a.col[:int(a.nnz)].long()] = True
    touched = int((b_rp[1:] - b_rp[:-1])[hit].sum())
    slots = chunk_cap * ke.CH
    b = bound(a.capacity * 13 + b_rp.numel() * 8 + touched * 8 + slots * 8,
              products)
    log(f"  expand_chunks: {products} products in {slots} slots "
        f"(chunk_cap {chunk_cap}), exact for {[s.name for s in SEMIRINGS]}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}); library: none (no "
        f"single PyTorch call expands products)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                products=products, slots=slots, chunk_cap=chunk_cap, **b)


def _scipy_square(a):
    """A @ A by ``scipy.sparse`` on the host from A's arrays, float64, with
    sorted column indices, and its seconds."""
    import scipy.sparse as sp

    row, col, val, nnz, shape = a.to_numpy()
    s = sp.csr_matrix((val[:nnz].astype(np.float64), (row[:nnz], col[:nnz])),
                      shape=shape)
    t = time.perf_counter()
    c = s @ s
    c.sort_indices()
    return c, time.perf_counter() - t


def check_against_scipy(c, ref, label: str) -> None:
    """The port's C equals scipy's A @ A: nnz, per-row counts, columns and
    values exact.  Every value is a sum of integer products; below 2^24
    every float32 partial sum is exact, in any order."""
    vmax = float(ref.data.max(initial=0.0))
    if not vmax < 2 ** 24:
        raise AssertionError(f"{label}: largest value {vmax} is not below "
                             "2^24, so float32 sums are not exact")
    row, col, val, nnz, shape = c.to_numpy()
    if nnz != ref.nnz:
        raise AssertionError(f"{label}: nnz {nnz} vs scipy {ref.nnz}")
    counts = np.bincount(row[:nnz], minlength=shape[0])
    if not np.array_equal(counts, np.diff(ref.indptr)):
        raise AssertionError(f"{label}: per-row counts differ from scipy")
    if not np.array_equal(col[:nnz], ref.indices):
        raise AssertionError(f"{label}: columns differ from scipy")
    if not np.array_equal(val[:nnz].astype(np.float64), ref.data):
        raise AssertionError(f"{label}: values differ from scipy")
    if not ((row[nnz:] == shape[0]).all() and (col[nnz:] == shape[1]).all()
            and (val[nnz:] == 0).all()):
        raise AssertionError(f"{label}: pads past nnz are not (m, n, 0)")


def _best_secs(fn, reps: int = 3):
    """Best host-clock seconds of ``reps`` synchronised calls after a warm
    one; the last result."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return min(times), times, out


def narrow_full(a) -> dict:
    """Phase 10: A² through ``spgemm_pallas`` without ``stream_cap`` (K5
    -> sort -> K2) and with it (K1 -> sort -> K2); the launch counts of one
    call of each route, read around that call alone."""
    flops = spgemm_flops(a, a)
    chunk_cap, out_cap = spgemm_pallas_bounds(a, a)
    routes = {"k5": dict(), "k1": dict(stream_cap=stream_capacity(flops))}
    want = {"k5": {"expand_chunks_i32": 1, "compress_i32": 1},
            "k1": {"expand_i32": 1, "compress_i32": 1}}
    out, cs = dict(nnz_a=int(a.nnz), flops=flops, chunk_cap=chunk_cap,
                   out_capacity=out_cap), {}
    for name, kw in routes.items():
        def run(kw=kw):
            return spgemm_pallas(a, a, chunk_cap=chunk_cap,
                                 out_capacity=out_cap, **kw)
        torch.cuda.synchronize()
        reset_launches()
        cs[name] = run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        if launches != want[name]:
            raise AssertionError(f"spgemm_pallas {name} launched {launches}")
        secs, times, _c = _best_secs(run)
        stream = (chunk_cap * ke.CH if name == "k5"
                  else kw["stream_cap"])
        out[name] = dict(secs=secs, times=times, products_per_s=flops / secs,
                         stream=stream, stream_per_product=stream / flops,
                         launches=launches)
        del _c
        log(f"  spgemm_pallas {name}: best {secs:.4f} s of {times}, "
            f"{flops / secs:.4g} products/s, stream {stream} = "
            f"{stream / flops:.3f} x products, launches {launches}")
    k5, k1 = cs["k5"], cs["k1"]
    if not (int(k5.nnz) == int(k1.nnz) and torch.equal(k5.row, k1.row)
            and torch.equal(k5.col, k1.col) and torch.equal(k5.val, k1.val)):
        raise AssertionError("spgemm_pallas: the K5 and K1 routes differ")
    ref, sp_secs = _scipy_square(a)
    check_against_scipy(k1, ref, "spgemm_pallas")
    out.update(nnz_c=int(k1.nnz), scipy_secs=sp_secs)
    log(f"  nnz(A) {int(a.nnz)}, {flops} products, nnz(A²) {int(k1.nnz)}; "
        f"both routes equal slot for slot and equal scipy (nnz, per-row "
        f"counts, columns, values; scipy took {sp_secs:.1f} s)")
    return out


def auto_full(a) -> dict:
    """Phase 11: ``spgemm_auto`` as ``bench_spgemm`` runs it: one call with
    the estimate and retry, then calls with ``out_capacity =
    round_capacity_frac(nnz)``: one warm, two timed, each of which must
    launch the expansion and the compress once a slab."""
    flops = spgemm_flops(a, a)
    plan = {}
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    c = spgemm_auto(a, a, max_flops_cap=AUTO_FLOPS_CAP, plan=plan)
    nnz = int(c.nnz)
    first_secs = time.perf_counter() - t
    first = dict(LAUNCHES)
    del c
    if plan["kind"] != "pallas_slabs":
        raise AssertionError(f"spgemm_auto took the {plan['kind']} route")
    bounds = _pallas_slab_plan(a, a, plan["num_slabs"], wide=plan["wide"])[0]
    slabs = len(bounds) - 1
    tag = "i64" if plan["wide"] else "i32"
    calls = first[f"compress_{tag}"] // slabs
    tight = round_capacity_frac(nnz)

    def run():
        return spgemm_auto(a, a, max_flops_cap=AUTO_FLOPS_CAP,
                           out_capacity=tight)

    run()                                                   # warm
    want = {f"expand_{tag}": slabs, f"compress_{tag}": slabs}
    times, c = [], None
    for _ in range(2):
        c = None                      # release the last C before the next
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        c = run()
        nnz_t = int(c.nnz)                                  # scalar sync
        times.append(time.perf_counter() - t)
        launches = {k: v for k, v in LAUNCHES.items() if v}
        if launches != want:
            raise AssertionError(f"spgemm_auto launched {launches}, want "
                                 f"{want}")
        if nnz_t != nnz:
            raise AssertionError(f"nnz {nnz_t} with out_capacity {tight}, "
                                 f"{nnz} before")
    secs = min(times)
    peak = torch.cuda.max_memory_allocated()
    ref, sp_secs = _scipy_square(a)
    check_against_scipy(c, ref, "spgemm_auto")
    c_ref = c_keys(c)
    del c
    out = dict(nnz_a=int(a.nnz), flops=flops, nnz_c=nnz, kind=plan["kind"],
               num_slabs=plan["num_slabs"], slabs=slabs, wide=plan["wide"],
               first_call_attempts=calls, retries=calls - 1,
               first_secs=first_secs, first_launches=first,
               out_capacity=tight, secs=secs, times=times,
               products_per_s=flops / secs, launches=launches,
               peak_mem_gb=peak / 2**30, scipy_secs=sp_secs)
    log(f"  plan {plan['kind']}: {plan['num_slabs']} slabs asked, {slabs} "
        f"run (wide {plan['wide']}); first call {first_secs:.2f} s with "
        f"{calls - 1} retries; timed {times} s -> {flops / secs:.4g} "
        f"products/s; nnz(A) {int(a.nnz)}, {flops} products, nnz(A²) {nnz}; "
        f"peak {peak / 2**30:.2f} GiB; launches {launches}; equals scipy "
        f"(scipy took {sp_secs:.1f} s)")
    return out, c_ref


# ---------------------------------------------------------- phases 12-14 --

def c_keys(c):
    """C's live entries as int64 keys ``row*n + col`` and values, on C's
    device (sorted when C is)."""
    nnz = int(c.nnz)
    return (c.row[:nnz].long() * c.shape[1] + c.col[:nnz].long(),
            c.val[:nnz])


def check_against_ref(c, ref, label: str) -> None:
    """A product equals phase 11's C (itself equal to scipy's): nnz, keys
    and values exact."""
    keys, vals = c_keys(c)
    if keys.shape != ref[0].shape:
        raise AssertionError(f"{label}: nnz {keys.shape[0]} vs phase 11's "
                             f"{ref[0].shape[0]}")
    if not torch.equal(keys, ref[0]):
        raise AssertionError(f"{label}: entries differ from phase 11's C")
    if not torch.equal(vals, ref[1]):
        raise AssertionError(f"{label}: values differ from phase 11's C")


def _bitwise_equal(got, want) -> bool:
    return all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
               for g, w in zip(got, want))


def _roll_all(stacks, axes):
    """``torch.roll`` of every stack one block along its axis: the
    yardstick, never used by the port."""
    return [torch.roll(x, 1, dims=1 if ax == "c" else 0)
            for x, ax in zip(stacks, axes)]


def _time_ring(stacks, axes) -> dict:
    """K9, its plain version and ``torch.roll`` on one set of stacks; the
    bound is every byte read once and written once."""
    nbytes = sum(x.numel() * x.element_size() for x in stacks)
    out = dict(ms=cuda_ms(lambda: ring_shift(stacks, axes)),
               plain_ms=cuda_ms(lambda: ring_shift(stacks, axes, plain=True),
                                reps=2),
               library_ms=cuda_ms(lambda: _roll_all(stacks, axes)),
               bytes=nbytes, max_abs_err=0.0, **bound(2 * nbytes, 0))
    out["share"] = out["bound_ms"] / out["ms"]
    return out


def check_ring(dm: DistSpMat, gen) -> dict:
    """Phase 12: K9 against its plain version, bit for bit: A's 4x4 block
    stacks (row ids, column ids, values, nnz) along each axis; phase 14's
    launch (A's stacks along 'c' and B's along 'r' at once, B = A); and one
    2^26-element float32 stack along each axis, whose bound share can be
    read.  Each launch also equals ``torch.roll``."""
    stacks = [dm.row, dm.col, dm.val, dm.nnz]
    cases = {f"a_{ax}": (stacks, [ax] * 4) for ax in ("c", "r")}
    cases["phase14"] = (stacks * 2, ["c"] * 4 + ["r"] * 4)
    big = torch.rand((4, 4, 1 << 22), generator=gen, device=dm.row.device)
    cases.update({f"big_{ax}": ([big], [ax]) for ax in ("c", "r")})
    out = {}
    for name, (srcs, axes) in cases.items():
        got = ring_shift(srcs, axes)
        if not _bitwise_equal(got, ring_shift(srcs, axes, plain=True)):
            raise AssertionError(f"ring_shift {name}: kernel and plain differ")
        if not _bitwise_equal(got, _roll_all(srcs, axes)):
            raise AssertionError(f"ring_shift {name}: differs from roll")
        del got
        out[name] = _time_ring(srcs, axes)
        r = out[name]
        log(f"  ring_shift {name}: {len(srcs)} stacks, {r['bytes']} bytes, "
            f"bit for bit; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch.roll {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share "
            f"{100 * r['share']:.1f} %")
    return out


def _grid_call(label: str, run, ref, flops: int) -> dict:
    """One warm call of ``run``, then two timed, the launch counts read
    around each (they must agree); the last C, through ``to_local``, equal
    to phase 11's C."""
    c = run()
    torch.cuda.synchronize()
    del c
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, launches, c = [], None, None
    for _ in range(2):
        c = None                      # release the last C before the next
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        c = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        got = {k: v for k, v in LAUNCHES.items() if v}
        if launches is not None and got != launches:
            raise AssertionError(f"{label}: launches {got} then {launches}")
        launches = got
    peak = torch.cuda.max_memory_allocated()
    nnz = c.nnz.reshape(-1)
    out = dict(secs=min(times), times=times, products_per_s=flops / min(
        times), launches=launches, peak_mem_gb=peak / 2**30,
        capacity=c.row.shape[-1], block_nnz_max=int(nnz.max()),
        block_nnz_min=int(nnz.min()),
        imbalance=float(nnz.max().float() / nnz.float().mean()))
    local = c.to_local()
    del c
    check_against_ref(local, ref, label)
    out["nnz"] = int(local.nnz)
    del local
    torch.cuda.empty_cache()
    log(f"  {label}: best {out['secs']:.4f} s of {times}, "
        f"{out['products_per_s']:.4g} products/s, launches {launches}, "
        f"block nnz {out['block_nnz_min']}-{out['block_nnz_max']} "
        f"(imbalance {out['imbalance']:.3f}), capacity {out['capacity']}, "
        f"peak {out['peak_mem_gb']:.2f} GiB; equals phase 11's C")
    return out


def grid_phase(cells, ref, flops: int) -> dict:
    """Phases 13 and 14: each grid product of ``profile_summa.grid_cells``
    timed (:func:`_grid_call`), its C equal to phase 11's, and its launches
    those of its route: ``summa_spgemm_auto`` the expansion and compress
    once a block an attempt, the staged SUMMA once a block a stage, the
    ring SUMMA K9 p - 1 times, the 3D SUMMA (plain ESC) none."""
    out = {}
    for label, call, info in cells:
        line = dict(info, **_grid_call(label, call, ref, flops))
        got, kind = line["launches"], label.split()[0]
        side = info["grid"][-1]
        blocks = side * side
        tag = "i64" if info["impl"] == "wide" else "i32"
        if kind == "summa_spgemm_auto":
            line["attempts"] = got.get(f"expand_{tag}", 0) // blocks
            line["retries"] = line["attempts"] - 1
            want = dict.fromkeys((f"expand_{tag}", f"compress_{tag}"),
                                 blocks * line["attempts"])
        elif kind == "summa_spgemm_staged":
            want = dict.fromkeys((f"expand_{tag}", f"compress_{tag}"),
                                 blocks * side)
        elif kind == "summa_spgemm_rma":
            want = {"ring_shift": side - 1}
        else:
            want = {}
        if got != want or line.get("attempts", 1) < 1:
            raise AssertionError(f"{label} launched {got}, want {want}")
        out[label] = line
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--check-scale", type=int, default=16)
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase_secs = {}

    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    details = {"card": card}

    # 2. build
    t = time.perf_counter()
    _build.library()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t:.1f} "
        f"s (nvcc {_build.build_seconds})")
    build_log = _build.BUILD_DIR / "build.log"
    ptx = build_log.read_text().splitlines() if build_log.exists() else []
    details["ptxas"] = [ln for ln in ptx if "registers" in ln
                        or "spill" in ln or "Compiling entry" in ln]
    phase_secs["2"] = time.perf_counter() - t

    # 3. kernels vs plain versions
    t = time.perf_counter()
    log("phase 3: kernels vs plain versions at main-path sizes")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k3 = {"expand_i32": check_expand(gen, dev, wide=False),
          "compress_i32": check_compress(gen, dev, wide=False),
          "expand_i64": check_expand(gen, dev, wide=True),
          "compress_i64": check_compress(gen, dev, wide=True)}
    torch.cuda.empty_cache()
    details["phase3_adversarial"] = check_adversarial(gen, dev)
    torch.cuda.empty_cache()
    phase_secs["3"] = time.perf_counter() - t

    # 4. independent end-to-end check
    t = time.perf_counter()
    log("phase 4: port digest vs scipy.sparse")
    check_scipy(args.seed, args.check_scale, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phase_secs["4"] = time.perf_counter() - t

    # 5. the main path at full size
    t = time.perf_counter()
    log(f"phase 5: scale-{args.scale} A² seg2 digest, every slab")
    launches = main_path(args.seed, args.scale, dev, details)
    torch.cuda.empty_cache()
    phase_secs["5"] = time.perf_counter() - t

    # 6. SpMM/BFS kernels vs plain versions at the shapes of phases 7, 8
    t = time.perf_counter()
    log(f"phase 6: SpMM/BFS kernels vs plain versions, scale-"
        f"{GRAPH_SCALE} ef-16 R-MAT")
    graphs = build_graphs(args.seed, GRAPH_SCALE, dev)
    k6 = check_spmm_bfs_kernels(graphs, dev)
    phase_secs["6"] = time.perf_counter() - t

    # 7. SpMM at full size
    t = time.perf_counter()
    log(f"phase 7: SpMM, scale-{GRAPH_SCALE} R-MAT x (n, 128)")
    spmm_line = spmm_full(graphs)
    log(json.dumps(dict(spmm_line, scale=GRAPH_SCALE)))
    phase_secs["7"] = time.perf_counter() - t

    # 8. BFS at full size
    t = time.perf_counter()
    log(f"phase 8: 64-root BFS, scale-{GRAPH_SCALE} symmetrized R-MAT")
    bfs_line = bfs_full(graphs, args.seed)
    log(json.dumps(dict(bfs_line, scale=GRAPH_SCALE)))
    phase_secs["8"] = time.perf_counter() - t
    del graphs
    torch.cuda.empty_cache()

    # 9. K5 vs its plain version at phase 10's shape
    t = time.perf_counter()
    log(f"phase 9: expand_chunks (K5) vs plain, scale-{NARROW_SCALE} A²")
    a15 = a2_matrix(args.seed, dev, NARROW_SCALE)
    k9 = check_expand_chunks(a15)
    torch.cuda.empty_cache()
    phase_secs["9"] = time.perf_counter() - t

    # 10. narrow spgemm_pallas, both routes
    t = time.perf_counter()
    log(f"phase 10: spgemm_pallas A², scale-{NARROW_SCALE} G500 ef-16")
    narrow_line = narrow_full(a15)
    log(json.dumps(dict(narrow_line, scale=NARROW_SCALE)))
    del a15
    torch.cuda.empty_cache()
    phase_secs["10"] = time.perf_counter() - t

    # 11. materialized spgemm_auto in slabs
    t = time.perf_counter()
    log(f"phase 11: spgemm_auto A², scale-{AUTO_SCALE} G500 ef-16, "
        f"max_flops_cap 2^{AUTO_FLOPS_CAP.bit_length() - 1}")
    torch.cuda.reset_peak_memory_stats()
    a17 = a2_matrix(args.seed, dev, AUTO_SCALE)
    auto_line, c_ref = auto_full(a17)
    log(json.dumps(dict(auto_line, scale=AUTO_SCALE)))
    torch.cuda.empty_cache()
    phase_secs["11"] = time.perf_counter() - t

    # 12. K9 vs its plain version at phase 14's shapes and at 2^26 elements
    t = time.perf_counter()
    log(f"phase 12: ring_shift (K9) vs plain, scale-{AUTO_SCALE} A's 4x4 "
        f"blocks and a 2^26-element stack")
    k12 = check_ring(DistSpMat.from_local(
        a17, ProcGrid.make(4, 4, device=dev)), gen)
    torch.cuda.empty_cache()
    phase_secs["12"] = time.perf_counter() - t

    # 13. SUMMA on block grids
    t = time.perf_counter()
    log(f"phase 13: summa_spgemm_auto / summa_spgemm_staged A², scale-"
        f"{AUTO_SCALE} G500 ef-16, on 2x2 and 4x4 block grids")
    cells = grid_cells(a17, dev)
    summa_line = grid_phase(cells[:3], c_ref, auto_line["flops"])
    log(json.dumps(dict(summa_line, scale=AUTO_SCALE)))
    phase_secs["13"] = time.perf_counter() - t

    # 14. ring SUMMA (K9) and 3D SUMMA
    t = time.perf_counter()
    log(f"phase 14: summa_spgemm_rma 4x4 and summa3d_spgemm 2x2x2 A², "
        f"scale-{AUTO_SCALE}")
    ring_line = grid_phase(cells[3:], c_ref, auto_line["flops"])
    log(json.dumps(dict(ring_line, scale=AUTO_SCALE)))
    del cells, a17, c_ref
    torch.cuda.empty_cache()
    phase_secs["14"] = time.perf_counter() - t

    launches.update(ell_sum=spmm_line["launches"]["ell_sum"],
                    spmm_coo=spmm_line["launches"]["spmm_coo"],
                    ell_max=bfs_line["ell_max_launches"],
                    expand_chunks_i32=narrow_line["k5"]["launches"][
                        "expand_chunks_i32"],
                    ring_shift=ring_line["summa_spgemm_rma 4x4"][
                        "launches"]["ring_shift"])
    measured = dict(k3, expand_chunks_i32=k9, ring_shift=k12["phase14"])
    for name, rows in k6.items():
        measured[name] = dict(rows[0], max_abs_err=max(
            r["max_abs_err"] for r in rows))
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    **{k: measured[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
               for name in KERNELS]
    for name, n_launch in launches.items():
        if n_launch < 1:
            raise AssertionError(f"{name} was not launched on its path")
    phase_secs["all"] = time.perf_counter() - t_start
    log(f"phase seconds: {json.dumps(phase_secs)}")
    details.update(kernels=kernels, phase3=k3, phase6=k6, spmm=spmm_line,
                   bfs=bfs_line, phase9=k9, narrow=narrow_line,
                   auto=auto_line, phase12=k12, summa=summa_line,
                   ring_3d=ring_line, phase_secs=phase_secs)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
