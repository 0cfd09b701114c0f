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
     of phase 10's A², for PLUS_TIMES, MIN_PLUS and MAX_SECOND, then on
     phase 3's adversarial K1 inputs (a hub row of 2^13 chunks taken 4
     times), every slot after poisoning, at a chunk capacity past the last
     live chunk and one that cuts inside the first hub entry;
 10. the narrow ``spgemm_pallas`` at full width: A² of the scale-15 G500
     ef-16 R-MAT (the largest square A² whose packed keys fit int32) through
     both routes, K5 -> sort -> K2 and K1 -> sort -> K2, equal to each other
     slot for slot and to ``scipy.sparse`` on the host;
 11. the materialized ``spgemm_auto`` A² of the scale-17 G500 ef-16 R-MAT in
     slabs of at most 2^27 products (``bench.py``'s ``bench_spgemm``): a
     first call with estimate and retry, a timed call with the output sized
     to nnz, checked against ``scipy.sparse``; its C stays on the card (as
     sorted int64 keys row*n+col and values) as the reference of 13 and 14;
     then K10 keyed by row alone on the heaviest slab's expansion stream
     against ``torch.sort`` and the value gather, slot for slot, both timed
     with CUDA events, with its bound (the ``kernels`` line's
     ``winsort_rows`` row, a ``{"k10_rows": ...}`` line);
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
     equal to phase 11's C exactly;
 15. single-device MCL as ``bench.py``'s ``bench_mcl`` runs it: ``mcl_local``
     on the scale-17 SSCA ef-8 R-MAT, symmetrized, no self loops, select
     64, recover_num 80, a 60 s budget; its expansions run ``spgemm_auto``
     in row slabs on the expansion and compress kernels (the wide pair, K3
     and K4, at this scale).  A timed run as a user calls it (launches
     read around the loop, labels equal to scipy's connected components of
     the last iterate), then a checked run of as many iterations: after
     every iteration each non-empty column sums to 1, nnz fits the
     capacity and no column is longer than recover_num; the first prune is
     held per column against the rule; iteration 1's expansion equals
     scipy's A @ A and iteration 3's the same call on the plain route
     (keys exact, values within 1e-5 relative); labels as above.  Then
     ``mcl_local`` on the card (K1 and K2 at this scale, at least one
     launch each an iteration) against the same call on CPU tensors (plain
     versions), scale 12 with seeded uniform weights: iterations, nnz per
     iteration and labels exact, and each iteration's step from the card's
     iterate redone on the CPU: values within 1e-5 relative, chaos within
     1e-5;
 16. ``spref`` (P·A·Q through ``spgemm_auto``: the expansion and compress
     kernels) and ``induced_subgraph`` of the scale-17 graph on a seeded
     half of its vertices, both equal to scipy's ``A[v][:, v]``;
 17. (run after phase 8, on its graph) the distributed SpMV and the
     algorithms on it, the scale-21 symmetrized graph on a 4x4 block grid:
     ``dist_spmv`` PLUS_TIMES against ``torch.sparse.mm`` (rtol 1e-4) and
     MIN_SECOND against the single-device ``spmv`` (exact); ``bfs_dist``
     and ``bfs_dir_opt_dist`` from 4 of phase 8's roots, Graph500-validated
     and with phase 8's levels; ``fastsv_dist`` and ``lacc_dist`` equal to
     ``fastsv_local`` and the component count to scipy's; ``luby_mis_dist``
     independent and maximal against the edge list;
 18. distributed HipMCL: ``mcl_dist`` on phase 15's graph with self loops,
     select 64, recover_num 80, on a 4x4 grid, ``phases=1`` (the packed
     route: K1 and K2 at least once each an iteration).  A timed run as a
     user calls it (labels against scipy's components of the last
     iterate); a checked run (every iterate column-stochastic within its
     capacity, iteration 1's expansion equal to scipy's A @ A and its
     prune to the threshold rule computed on the host, the labels);
     ``phases=2`` against ``phases=1`` for 3 iterations: each step from the
     same iterate gives the same expansion keys, values within 1e-6, and
     the same prune but for ties at a column's threshold broken by
     rounding (the compress kernel's sums associate as the stream's layout
     falls); after 3 iterations at most 1 % of the columns differ, the
     keys that differ reported; then scale 12 on a 2x2 grid, card against CPU
     (iterations, nnz and labels exact, each step redone on the CPU within
     1e-5; on the CPU 2 phases give the 1-phase iterate after 3
     iterations) and the ``layers=2`` route on a (2, 2, 2) grid with the 2D
     run's partition;
 19. the distributed vector layer and indexing on 4x4 grids (no kernel of
     their own): ``dist_sort`` and ``dist_sort_auto`` of 2^26 float32
     values (a sixteenth repeated, -0.0, +0.0, infinities and NaNs among
     them) with an int32 payload, equal to the host order on (key,
     index); ``dist_rand_perm``, ``dist_invert``, ``dist_uniq``,
     ``dist_gather`` and ``dist_route`` (every combine, duplicate indices)
     at 2^21 against numpy, every call repeated bit for bit;
     ``dist_permute`` of phase 17's matrix by a random permutation, equal
     to the host relabelling, and its inverse giving the matrix back; then
     ``dist_spref`` of phase 15's graph on phase 16's vertices equal to
     phase 16's ``spref``, ``dist_prune_block`` and ``dist_spasgn`` (twice
     the submatrix put back) equal to the host's, their products on K1
     and K2 (launches read around them);
 20. HipMCL with its preprocessing: ``mcl_dist(preprocess=True)`` on phase
     15's graph with self loops on its vertices of degree >= 1 only (the
     isolated ones stay empty), 4x4, one phase, a seeded generator: a
     timed run (K1/K2 each iteration), isolated vertices singletons
     labelled >= n, every cluster inside one connected component, labels
     equal to ``dist_remove_isolated`` + ``dist_rand_permute`` +
     ``mcl_dist`` composed by hand and to a second run; then scale 12 on
     2x2, card against CPU with one CPU generator;
 21. the orderings and betweenness centrality: ``rcm_order_dist`` (4x4) and
     ``rcm_order`` of the 128^3 7-point stencil relabelled at random
     (``dist_rand_perm`` + ``dist_permute``), each equal to a host
     Cuthill-McKee of its own parent rule (the BFS parent, or the
     earliest-labelled previous-level neighbour: the two orders differ by
     design), each within a bandwidth of 3 k^2; ``md_order_dist`` equal to
     ``md_order`` on the 24x24 5-point stencil; ``betweenness_centrality``
     and ``betweenness_centrality_dist`` (4x4) of phase 8's graph from 64
     of its roots, within 1e-4, and at scale 12 the card against the CPU
     within 1e-5;
 22. bipartite matchings of a scale-20 G500 ef-16 R-MAT (not symmetrized,
     seeded weights in (0, 1]): ``bp_maximal_matching``,
     ``bp_maximum_matching`` and ``awpm``, then ``dist_bp_maximal``,
     ``dist_bp_maximum`` and ``dist_awpm`` on 4x4, each checked on the
     host against the edge list (consistent mates, matched pairs edges,
     the maximal ones maximal), the maximum cardinalities equal to scipy's
     ``maximum_bipartite_matching``, every grid result equal to the local
     one mate for mate; at scale 12 ``awpm(complete=False)`` with at least
     half the weight of ``linear_sum_assignment``;
 23. multigrid on phase 21's 128^3 stencil with weights 6 / -1 on 4x4:
     ``mis2_dist`` (``mis2_verify_dist`` on the 0/1 pattern and a host
     check on the patterns of A and A²), ``restriction_op_dist`` (one
     entry a column, coarse vertices in their own aggregates, every
     vertex within two hops of its coarse vertex), ``galerkin_dist`` and
     ``galerkin`` of R and A on one block equal to scipy's R·A·Rᵀ
     exactly (both take the wide keys, K3/K4: the coarse x fine key space
     passes 2^31), launches read around each; local ``mis2`` +
     ``restriction_op`` of the 48^3 stencil, card against CPU with one
     CPU generator, and its ``galerkin`` on K1/K2;
 24. a ``TwitterGraph`` over phase 8's graph (seeded attributes, one an
     undirected edge, a window passing about a quarter): the subgraphs
     equal to the host filter, ``bfs_within`` and ``bfs_within_dist``
     (4x4) from 4 of phase 8's roots equal to a host BFS of the filtered
     graph and validated on it, ``mis_filtered_dist`` independent and
     maximal; ``parallel_write_mtx`` / ``parallel_write_binary`` of a 4x4
     scale-18 matrix read back by ``parallel_read_mtx`` / ``read_binary``
     equal; the CLI in process (``gen``, ``convert``, ``spgemm``,
     ``match --max``, ``bfs --dist``, ``cc``, ``galerkin``, ``mcl``), each
     line equal to the library call it wraps;
 25. (run right after phase 5, on its matrix) the row-classed seg digest
     of the scale-22 A² through ``seg_prepare`` / ``seg_step`` in slabs of
     2^28 products, one sync a slab: nnz equal to phase 5's, checksum
     within 1e-5 relative, not truncated, K1, K2 and the window sort's
     (K10) wide sort launched once a slab, its narrow kernel once a slab
     and width range, and nothing else; the whole pass again with the
     window sort's plain version in K10's place, the digest (signed sum
     included) equal bit for bit; on the heaviest slab K10's class buffer
     equal to the plain version's slot for slot, both timed (the
     ``kernels`` line's K10 rows); the heaviest, middle and last slabs
     again with the plain window sort (bit for bit) and with every plain
     version (nnz exact, checksum and signed sum within 1e-5 of the
     checksum); the scale-16 classed digest against scipy; the
     one-process ``initialize_multihost`` / ``is_coordinator`` /
     ``pod_grid``;
 26. the pod on the one card: block grids spread over several processes
     (fresh interpreters of this script, ``--pod-worker``, joined by
     ``gloo`` on 127.0.0.1, exchanging card tensors through CUDA IPC).
     Two processes: ``summa_spgemm_auto`` 2x2 of phase 11's A² (K3/K4),
     every block equal to phase 13's (per-block digests of the keys and
     value bits), and the cooperative ``parallel_write_mtx`` /
     ``parallel_write_binary`` of phase 24's scale-18 graph, byte for byte
     one process's files, ``parallel_read_mtx`` equal to one process's
     blocks.  Four processes: ``summa_spgemm_auto`` 4x4 (K1/K2) equal to
     phase 13's, ``summa_spgemm_rma`` 4x4 equal to phase 14's with K9's
     cross-process form launched, K9 across processes alone bit for bit
     its ``gloo`` plain version and timed, at the ring SUMMA's own launch
     (its skewed 4x4 stacks, one block row a process) and on A's 2x2
     blocks (one a process),
     ``bfs_dist`` of phase 8's graph from 4 of its roots (phase 8's
     levels, Graph500-valid), ``lacc_dist`` and ``luby_mis_dist`` of it
     (phase 17's labels and set), ``dist_rand_perm`` and ``dist_permute``
     of it (phase 19's permutation and blocks, by digest),
     ``dist_sort_auto`` of 2^26 float32 with a payload equal to
     ``torch.sort``'s stable order, phase 19's vector calls
     (``dist_rand_perm``, ``dist_invert``, ``dist_uniq``, ``dist_gather``,
     ``dist_apply_perm``, ``dist_route`` with every combine) on phase 19's
     inputs, every slice equal to phase 19's bit for bit, and
     ``dist_spref`` / ``dist_prune_block`` / ``dist_spasgn`` of phase 15's
     graph equal to phase 19's blocks (K1/K2 summed over the processes);
     item 1.8's step 4, the layered grid: ``summa3d_spgemm`` of the
     scale-16 A² on (2, 2, 2) over the 4 processes (a layer's block row
     each; phase 14's case, cut from scale 17 so that four workers fit the
     card), its caps from ``summa3d_layer_bounds`` over the processes,
     every block equal to a one-process call of this run (the compress
     kernel twice a block of a layer, summed over the processes).
     Four processes of their own: HipMCL's pod path, ``mcl_dist`` of phase
     18's matrix on the 4x4 grid, ``phases=1`` (K1/K2 at least once each
     an iteration, summed over the processes): phase 18's iteration count
     and labels bit for bit, every iterate's blocks equal to phase 18's by
     digest, and a ``phases=2`` run's third iterate equal to one
     process's; then ``mcl_dist(preprocess=True)`` of phase 20's matrix
     with phase 20's generator seed: phase 20's iterations, isolated count
     and labels bit for bit, K1/K2 each an iteration; the seconds per
     iteration, total and peak memory per worker of both beside phases 18
     and 20; and phase 18's scale-12 ``mcl_dist(layers=2, phases=2)`` on
     a 2x2 grid over the processes, its expansion on (2, 2, 2) over them:
     iterations, labels and the final iterate's blocks equal phase 18's
     one-process run.  Four processes of their own (``"algos"``), item 1.8's step
     3 on the 4x4 grid, each result equal to one process's of this run
     bit for bit (digests of every process's slices or blocks) and timed
     as the slowest process between two rendezvous: ``dist_spmm`` (sum
     and max, d = 32) and BC (phase 21's 64 roots) of phase 8's graph
     (phases 17 and 21), phase 24's filtered BFS from 4 roots, filtered
     MIS and materialization, ``dense_put`` / ``dense_add_sparse`` /
     ``dense_to_host`` / ``dense_reduce`` of a 4096-vertex graph (against
     the one-process calls and numpy), and below their phases' sizes (a
     pod level or step costs an exchange or more) ``rcm_order_dist`` of
     the relabelled 32^3 stencil (also the host Cuthill-McKee's),
     ``md_order_dist`` of the 12x12 stencil (also ``md_order``'s) and the
     three matchings of a scale-18 weighted R-MAT (scipy's maximum
     cardinality); phase 23's ``mis2_dist``, ``restriction_op_dist`` and
     ``galerkin_dist`` of the 128^3 stencil (K3/K4), and
     ``galerkin_dist`` on 16x16 over the processes (K1/K2), equal to
     phase 23's.

Every bound is the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over the card's float32 rate (67 TFLOP/s), both the H100 SXM's published
peaks.  The last stdout line is ``{"ok": true, "device": {...}}``, printed
only when every phase passed.  Details go to ``chiprun_out/chip_smoke.json``.

Usage: python3 chip_smoke.py [--seed 42] [--scale 22] [--check-scale 16]
(``--pod-worker`` is phase 26's own entry for its processes.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch

from card_inputs import (
    AUTO_FLOPS_CAP,
    AUTO_SCALE,
    EDGEFACTOR,
    GRAPH_SCALE,
    GRID3D,
    NARROW_SCALE,
    a2_matrix,
    bfs_frontier,
    bfs_roots,
    grid_cells,
    spmm_bfs_graphs,
)
from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
from combblas_tpu_torch.models.bfs import (
    bfs_batch_pull_big,
    bfs_push_local,
    validate_bfs,
)
from combblas_tpu_torch.ops import spgemm_seg
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
from combblas_tpu_torch.ops.kernels.winsort import (
    NARROW_MAX,
    key_bits,
    regimes,
    row_window_sort,
    window_sort,
    window_sort_plain,
)
from combblas_tpu_torch.ops.spgemm import (
    _pallas_slab_plan,
    _slab_extract,
    _slab_stats,
    round_capacity_frac,
    spgemm_auto,
    spgemm_flops,
    spgemm_pallas,
    spgemm_pallas_bounds,
    stream_capacity,
)
from combblas_tpu_torch.ops.spgemm_seg import (
    _row_flops_exact,
    _window_table,
    seg2_prepare,
    seg2_step,
    seg_prepare,
    seg_step,
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
from combblas_tpu_torch.parallel.dist import DistSpMat, _live_entries
from combblas_tpu_torch.parallel.grid import ProcGrid, default_grid
from combblas_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_coordinator,
    pod_grid,
)
from combblas_tpu_torch.semiring import (
    MAX_SECOND,
    MAX_TIMES,
    MIN_PLUS,
    PLUS_TIMES,
)

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
    "ring_shift_pod": ("combblas_tpu_torch/csrc/ring.cu",
                       "combblas_tpu/parallel/rma.py:47"),
    # K10 replaces no TPU kernel: the JAX package sorts the classed
    # digest's windows with XLA's sort
    "winsort_narrow": ("combblas_tpu_torch/csrc/winsort.cu", None),
    "winsort_wide": ("combblas_tpu_torch/csrc/winsort.cu", None),
    # K10 keyed by row replaces none either: the JAX package sorts the
    # expansion stream with lax.sort
    "winsort_rows": ("combblas_tpu_torch/csrc/winsort.cu", None),
}
#: The forced small piece length of phase 6's second check (positions of
#: an ELL piece, entries of a K8 range).
SMALL_PIECE = 32
#: The H100 SXM's published peaks: HBM bytes/s and float32 FLOP/s outside
#: the tensor cores.
HBM_BYTES_PER_S = 3.35e12
#: The smallest normal float32.  A relative difference is taken against
#: max(|value|, this): below it float32 spacing is absolute (2^-149), and
#: MCL's iterates hold such values once inflation has squared them a few
#: times, where a last-place difference is already 1e-4 relative.
F32_TINY = float(np.finfo(np.float32).tiny)
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


def _adversarial_expand_inputs(gen, dev, wide: bool, log2: int):
    """A B row of 2^log2 entries taken by 4 A entries, 2^log2 consecutive
    dead A entries and 2^(log2-2) entries on empty B rows, between 2^log2
    entries on rows of 0..16 each side: (args, B's columns, each entry's
    products, the A entries before the first hub entry)."""
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
    cnt = torch.where(valid, deg[a_col.long()], 0)
    return (a_row, a_col, a_val, valid, b_rp, b_col, b_val), n, cnt, live // 2


def _adversarial_expand(gen, dev, wide: bool, log2: int = 20) -> dict:
    """K1/K3 on :func:`_adversarial_expand_inputs`: every slot against the
    plain version after poisoning, at a capacity past the total and one
    that cuts inside the first hub entry."""
    args, n, cnt, hub = _adversarial_expand_inputs(gen, dev, wide, log2)
    fn = ke.expand_chunks_compact_wide if wide else ke.expand_chunks_compact
    total = int(cnt.sum())
    first_hub = int(cnt[:hub].sum())
    ksize = 8 if wide else 4
    caps = [total + 12345, first_hub + hub + 3]
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

def run_slabs(step, num_slabs: int, dev, sync_each: bool):
    """Every slab of a digest, ``state = step(s, state)``; with
    ``sync_each`` one scalar sync per slab (its nnz), returning per-slab nnz
    deltas and seconds."""
    state = seg_zero_state(dev)
    nnz_prev, per_nnz, per_secs = 0, [], []
    for s in range(num_slabs):
        ts = time.perf_counter()
        state = step(s, state)
        if sync_each:
            nnz_now = int(state[0])
            per_secs.append(time.perf_counter() - ts)
            per_nnz.append(nnz_now - nnz_prev)
            nnz_prev = nnz_now
    return state, per_nnz, per_secs


def check_scipy(seed: int, scale: int, dev, classed: bool = False) -> None:
    """The scale-``scale`` SSCA A² digest against scipy's product: through
    seg2 (phase 4) or, with ``classed``, the classed seg pipeline in slabs
    of ``SEG_CHECK_SLAB_FLOPS`` products (phase 25)."""
    import scipy.sparse as sp

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, 8, probs=SSCA_PROBS)
    if classed:
        prep = seg_prepare(a, a, num_slabs=-(-spgemm_flops(a, a)
                                              // SEG_CHECK_SLAB_FLOPS))
        n = len(prep[0]["bounds"]) - 1
        state, _, _ = run_slabs(
            lambda s, st: seg_step(a, a, prep, s, st, PLUS_TIMES), n, dev,
            sync_each=False)
        what = f"{n} classed slabs ({len(prep[0]['classes'])} classes)"
    else:
        prep = seg2_prepare(a, a, flops_cap=1 << 20, max_widths=20)
        slabs = prep[1]["slabs"]
        state, _, _ = run_slabs(
            lambda s, st: seg2_step(a, prep, s, st, PLUS_TIMES), len(slabs),
            dev, sync_each=False)
        what = (f"{len(slabs)} slabs "
                f"({sum(not sl['flat'] for sl in slabs)} windowed)")
    nnz, cks, trunc = int(state[0]), float(state[1]), bool(state[2])
    row, col, val, annz, shape = a.to_numpy()
    s = sp.csr_matrix((val[:annz].astype(np.float64),
                       (row[:annz], col[:annz])), shape=shape)
    c = s @ s
    ref_nnz, ref_cks = int(c.nnz), float(c.sum())
    rel = abs(cks - ref_cks) / abs(ref_cks)
    log(f"  scale {scale}: {what}, nnz {nnz} vs scipy {ref_nnz}, checksum "
        f"{cks!r} vs {ref_cks!r} (rel {rel:.2e}), truncated {trunc}")
    if nnz != ref_nnz or trunc or not rel <= 1e-4:
        raise AssertionError("scale-%d digest disagrees with scipy" % scale)


def main_path(seed: int, scale: int, dev, details: dict):
    """Phase 5.  Returns the launch counts, the phase's line and its
    matrix, which phase 25 multiplies again."""
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
    state, per_nnz, per_secs = run_slabs(
        lambda s, st: seg2_step(a, prep, s, st, PLUS_TIMES), len(slabs), dev,
        sync_each=True)
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
                compress_i64=len(slabs) - n_win,
                winsort_rows=len(slabs) - n_win)
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
    return launches, line, a


# ---------------------------------------------------------------- phase 25 --

#: Products per slab of phase 25's classed digest: the slab count is the
#: product count over this (``scripts/run_headline.py --seg``'s cut).
SEG_SLAB_FLOPS = 1 << 28
#: Products per slab of phase 25's scale-16 check against scipy.
SEG_CHECK_SLAB_FLOPS = 1 << 20


def _plain_window_sort(col, val, table, *, key_bits, plain, **kw):
    """The window sort's plain version in K10's place, K1 and K2 kept."""
    return window_sort_plain(col, val, table, **kw)


def _state_bits(state) -> list:
    """A digest state as ints: nnz, the checksum's bits, truncated, the
    signed sum's bits (one sync)."""
    nnz, cks, trunc, signed = state
    return [int(nnz), int(cks.reshape(1).view(torch.int32)), bool(trunc),
            int(signed.reshape(1).view(torch.int32))]


def k10_slab(a, prep, s: int) -> dict:
    """K10 on slab ``s`` of phase 25's plan: its class buffer against the
    window sort's plain version (the seg step's ``torch.sort(dim=1)``
    route) on the same K1 stream and window table, slot for slot and value
    bits included; both timed with CUDA events (K10 on a fresh copy of the
    stream each call, which it overwrites, the copy outside the timing)."""
    plan, b_rp, class_table, bounds, _cap = prep
    sub, _ = _slab_extract(a, a.shape[1], bounds, s,
                           span_cap=plan["span_cap"],
                           slab_nnz_cap=plan["slab_nnz_cap"])
    col, val, _total = ke.expand_chunks_compact(
        sub.row, sub.col, sub.val, sub.mask(), b_rp, a.col, a.val,
        PLUS_TIMES, stride=0, stream_cap=plan["stream_cap"])
    rowfl, row_start = _row_flops_exact(sub, b_rp, plan["span_cap"])
    table = _window_table(rowfl, row_start, class_table,
                          windows=sum(plan["s_caps"]),
                          span_cap=plan["span_cap"])
    del sub, rowfl, row_start
    kw = dict(classes=plan["classes"], s_caps=plan["s_caps"])
    bits = key_bits(a.shape[1])

    def timed(fn, reps):
        out, ms = None, []
        for _ in range(reps):
            args = (col.clone(), val.clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            del args
        return out, ms

    want, plain_ms = timed(
        lambda c, v: window_sort_plain(c, v, table, **kw), 3)
    before = dict(LAUNCHES)
    got, ms = timed(
        lambda c, v: window_sort(c, v, table, key_bits=bits, **kw), 5)
    launches = {k: (v - before[k]) // 5 for k, v in LAUNCHES.items()
                if v != before[k]}
    bad = (int((got[0] != want[0]).sum())
           + int((got[1].view(torch.int32) != want[1].view(torch.int32))
                 .sum()))
    live = int(table[1].sum())
    del got, want, col, val, table
    narrow = [(L, S) for L, S in zip(plan["classes"], plan["s_caps"])
              if L <= NARROW_MAX]
    # bytes: a product read (key and value), a slot written (key and value)
    line = dict(slab=s, products=live, padded=plan["padded"],
                windows=sum(plan["s_caps"]),
                narrow_windows=sum(S for _L, S in narrow),
                narrow_padded=sum(S * L for L, S in narrow),
                key_bits=bits, passes=-(-bits // 8), mismatched_slots=bad,
                max_abs_err=0.0 if bad == 0 else None,
                ms=statistics.median(ms), ms_each=ms,
                plain_ms=statistics.median(plain_ms), plain_ms_each=plain_ms,
                library_ms=statistics.median(plain_ms),
                launches_per_call=launches,
                **bound(8 * live + 8 * plan["padded"], 0))
    line["bound_share"] = line["bound_ms"] / line["ms"]
    log(json.dumps({"k10": line}))
    if bad:
        raise AssertionError(f"slab {s}: K10's class buffer differs from the "
                             f"plain version's in {bad} slots")
    return line


def seg_full(a, want: dict, dev, details: dict) -> dict:
    """Phase 25: the classed seg digest of phase 5's A² (``want`` is phase
    5's line), every slab with one scalar sync; the pass again with the
    plain window sort in K10's place; K10 alone on the heaviest slab; then
    three slabs again with the kernels and their plain versions."""
    flops = want["flops"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    prep = seg_prepare(a, a, num_slabs=-(-flops // SEG_SLAB_FLOPS))
    plan_secs = time.perf_counter() - t
    plan = prep[0]
    S = len(plan["bounds"]) - 1

    def step(s, state, plain=False):
        return seg_step(a, a, prep, s, state, PLUS_TIMES, plain=plain)

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, per_nnz, per_secs = run_slabs(step, S, dev, sync_each=True)
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    nnz_c, checksum, truncated, signed = (int(state[0]), float(state[1]),
                                          bool(state[2]), float(state[3]))
    rel = abs(checksum - want["checksum"]) / abs(want["checksum"])
    _nnz_s, _ch_s, fl_s = _slab_stats(a, a, prep[3], S)
    line = dict(
        slabs=S, classes=len(plan["classes"]), widest=plan["classes"][-1],
        padded=plan["padded"], pad_ratio=plan["padded"] * S / flops,
        span_cap=plan["span_cap"], stream_cap=plan["stream_cap"],
        slab_out_cap=prep[4], plan_secs=plan_secs, secs=secs,
        products_per_s=flops / secs, nnz_c=nnz_c, checksum=checksum,
        checksum_rel_vs_phase5=rel, truncated=truncated, signed=signed,
        launches={k: v for k, v in launches.items() if v},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    log(json.dumps(line))
    details["seg_slabs"] = [dict(flops=int(fl_s[s]), nnz=per_nnz[s],
                                 secs=per_secs[s]) for s in range(S)]
    if nnz_c != want["nnz_c"] or truncated or not rel <= 1e-5:
        raise AssertionError(
            f"classed digest (nnz {nnz_c}, checksum {checksum!r}, truncated "
            f"{truncated}) != phase 5's (nnz {want['nnz_c']}, checksum "
            f"{want['checksum']!r})")
    want_launches = dict.fromkeys(LAUNCHES, 0)
    want_launches.update(expand_i32=S, compress_i32=S)
    for cap, w0, w1 in regimes(plan["classes"], plan["s_caps"]):
        if w1 > w0:
            want_launches["winsort_narrow" if cap else "winsort_wide"] += S
    if launches != want_launches:
        raise AssertionError(f"launch counts {launches} != {want_launches}")
    # the pass again with the plain window sort: the signed sum is the part
    # of the digest that sees a value under another column
    with mock.patch.object(spgemm_seg, "window_sort", _plain_window_sort):
        twin, _, _ = run_slabs(step, S, dev, sync_each=False)
    got_bits, twin_bits = _state_bits(state), _state_bits(twin)
    log(f"  the pass with the plain window sort: digest bits {twin_bits} "
        f"vs K10's {got_bits}")
    if got_bits != twin_bits:
        raise AssertionError("the plain window sort's pass gives another "
                             "digest than K10's")
    line["k10"] = k10_slab(a, prep, int(np.argmax(fl_s)))
    # the heaviest, the middle and the last slab again, from a zero state:
    # with the plain window sort in K10's place (bit for bit) and with every
    # plain version (K2's plain sums run in another order)
    for s in dict.fromkeys([int(np.argmax(fl_s)), S // 2, S - 1]):
        got = step(s, seg_zero_state(dev))
        with mock.patch.object(spgemm_seg, "window_sort",
                               _plain_window_sort):
            mid = step(s, seg_zero_state(dev))
        ref = step(s, seg_zero_state(dev), plain=True)
        g_nnz, r_nnz = int(got[0]), int(ref[0])
        g_cks, r_cks = float(got[1]), float(ref[1])
        g_sgn, r_sgn = float(got[3]), float(ref[3])
        s_rel = abs(g_cks - r_cks) / max(abs(r_cks), 1e-30)
        sgn_rel = abs(g_sgn - r_sgn) / max(abs(r_cks), 1e-30)
        same = _state_bits(got) == _state_bits(mid)
        log(f"  slab {s} ({int(fl_s[s])} products): nnz {g_nnz} kernels vs "
            f"{r_nnz} plain (main pass {per_nnz[s]}), checksum rel "
            f"{s_rel:.2e}, signed sum {g_sgn!r} vs {r_sgn!r} ({sgn_rel:.2e} "
            f"of the checksum); with the plain window sort bit for bit: "
            f"{same}")
        if not (g_nnz == r_nnz == per_nnz[s]) or not s_rel <= 1e-5:
            raise AssertionError(f"slab {s}: kernels and plain versions "
                                 "disagree")
        if not sgn_rel <= 1e-5 or not same:
            raise AssertionError(f"slab {s}: the signed sums disagree")
        if bool(got[2]) or bool(ref[2]):
            raise AssertionError(f"slab {s}: truncated")
    del prep, got, mid, ref, twin
    torch.cuda.empty_cache()
    return line


def multihost_one_process() -> None:
    """Phase 25's single-process join: a no-op, rank 0, and the pod grid
    equal to the default grid on the card."""
    n, coord = initialize_multihost(), is_coordinator()
    grid, want = pod_grid(), default_grid()
    log(f"  initialize_multihost() = {n}, is_coordinator() = {coord}, "
        f"pod_grid() = {grid}")
    if n != 1 or not coord or grid != want:
        raise AssertionError(f"one-process multihost: {n}, {coord}, {grid} "
                             f"(default grid {want})")

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
    loop-free twin for BFS and X (``card_inputs.py``), and the plans;
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
    g["bfs_check"] = (roots[:DIST_BFS_ROOTS], lv[:DIST_BFS_ROOTS].clone())
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


def adversarial_expand_chunks(gen, dev, log2: int = 20) -> dict:
    """K5 on phase 3's adversarial inputs (a B row of 2^log2 entries, so
    2^(log2-7) chunks, taken by 4 A entries; 2^log2 dead entries; 2^(log2-2)
    entries on empty B rows): every slot against the plain version after
    poisoning, for every semiring, at a chunk capacity past the last live
    chunk and one that cuts inside the first hub entry."""
    args, n, cnt, hub = _adversarial_expand_inputs(gen, dev, False, log2)
    nch = -(-cnt // ke.CH)
    chunks = int(nch.sum())
    caps = [chunks + 97, int(nch[:hub].sum()) + (1 << (log2 - 8)) + 3]
    for sr in SEMIRINGS:
        for cap in caps:
            poison_allocator([cap * ke.CH * 4] * 2, dev)
            key, val = ke.expand_chunks(*args, sr, stride=n + 1,
                                        chunk_cap=cap)
            pkey, pval = ke.expand_chunks(*args, sr, stride=n + 1,
                                          chunk_cap=cap, plain=True)
            if not (torch.equal(key, pkey) and torch.equal(
                    val.view(torch.int32), pval.view(torch.int32))):
                raise AssertionError(f"adversarial expand_chunks {sr.name} "
                                     f"chunk_cap {cap}: slots differ")
    del key, val, pkey, pval
    ms = [cuda_ms(lambda cap=cap: ke.expand_chunks(
        *args, PLUS_TIMES, stride=n + 1, chunk_cap=cap)) for cap in caps]
    log(f"  adversarial expand_chunks: {int(cnt.sum())} products in {chunks} "
        f"chunks (hub row 2^{log2} x 4, 2^{log2} dead, 2^{log2 - 2} on "
        f"empty rows), every slot equal to plain at chunk caps {caps}; "
        f"kernel {ms[0]:.3f} / {ms[1]:.3f} ms")
    return dict(products=int(cnt.sum()), chunks=chunks, caps=caps, ms=ms)


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


def check_against_scipy(c, ref, label: str, rtol: float | None = None
                        ) -> float:
    """The port's C equals scipy's A @ A: nnz, per-row counts and columns
    exact; values exact, or with ``rtol`` within that relative difference
    (to ``F32_TINY`` for subnormal values).
    Exact values need every value to be a sum of integer products below
    2^24, where every float32 partial sum is exact, in any order.  Returns
    the largest relative value difference."""
    vmax = float(ref.data.max(initial=0.0))
    if rtol is None and not vmax < 2 ** 24:
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
    diff = np.abs(val[:nnz].astype(np.float64) - ref.data)
    rel = float((diff / np.maximum(np.abs(ref.data), F32_TINY)).max()) \
        if nnz else 0.0
    if not (rel <= rtol if rtol is not None else not diff.any()):
        raise AssertionError(f"{label}: values differ from scipy (largest "
                             f"relative difference {rel})")
    if not ((row[nnz:] == shape[0]).all() and (col[nnz:] == shape[1]).all()
            and (val[nnz:] == 0).all()):
        raise AssertionError(f"{label}: pads past nnz are not (m, n, 0)")
    return rel


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
    -> ``torch.sort`` -> K2) and with it (K1 -> K10 keyed by row -> K2);
    the launch counts of one call of each route, read around that call
    alone."""
    flops = spgemm_flops(a, a)
    chunk_cap, out_cap = spgemm_pallas_bounds(a, a)
    routes = {"k5": dict(), "k1": dict(stream_cap=stream_capacity(flops))}
    want = {"k5": {"expand_chunks_i32": 1, "compress_i32": 1},
            "k1": {"expand_i32": 1, "compress_i32": 1, "winsort_rows": 1}}
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
    want = {f"expand_{tag}": slabs, f"compress_{tag}": slabs,
            "winsort_rows": slabs}
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
    k10 = k10_rows_slab(a, plan)
    out = dict(nnz_a=int(a.nnz), flops=flops, nnz_c=nnz, kind=plan["kind"],
               num_slabs=plan["num_slabs"], slabs=slabs, wide=plan["wide"],
               first_call_attempts=calls, retries=calls - 1,
               first_secs=first_secs, first_launches=first,
               out_capacity=tight, secs=secs, times=times,
               products_per_s=flops / secs, launches=launches,
               peak_mem_gb=peak / 2**30, scipy_secs=sp_secs, k10_rows=k10)
    log(f"  plan {plan['kind']}: {plan['num_slabs']} slabs asked, {slabs} "
        f"run (wide {plan['wide']}); first call {first_secs:.2f} s with "
        f"{calls - 1} retries; timed {times} s -> {flops / secs:.4g} "
        f"products/s; nnz(A) {int(a.nnz)}, {flops} products, nnz(A²) {nnz}; "
        f"peak {peak / 2**30:.2f} GiB; launches {launches}; equals scipy "
        f"(scipy took {sp_secs:.1f} s)")
    return out, c_ref


def k10_rows_slab(a, plan: dict) -> dict:
    """K10 keyed by row alone on the heaviest slab of phase 11's plan: the
    slab's compacted expansion stream (K3's int64 keys when the plan is
    wide, else K1's packed int32 keys), sorted by ``row_window_sort``
    against ``torch.sort(stable=True)`` and the value gather on copies of
    the same stream, slot for slot and value bits included; both timed
    with CUDA events (the copy outside the timing)."""
    wide = plan["wide"]
    bounds, span_cap, slab_nnz_cap, _ch, worst_fl = _pallas_slab_plan(
        a, a, plan["num_slabs"], wide=wide)
    bounds = torch.as_tensor(bounds.astype(np.int64), device=a.device)
    fl_s = _slab_stats(a, a, bounds, bounds.shape[0] - 1)[2]
    s = int(np.argmax(fl_s))
    sub, _ = _slab_extract(a, a.shape[1], bounds, s, span_cap=span_cap,
                           slab_nnz_cap=slab_nnz_cap)
    n = a.shape[1]
    expand = (ke.expand_chunks_compact_wide if wide
              else ke.expand_chunks_compact)
    key, val, total = expand(sub.row, sub.col, sub.val, sub.mask(),
                             a.row_ptr(), a.col, a.val, PLUS_TIMES,
                             stride=n + 1,
                             stream_cap=stream_capacity(worst_fl))
    live = int(total)
    del sub
    bits = key_bits(n)

    def library(k, v):
        k, order = torch.sort(k, stable=True)
        return k, v[order]

    def timed(fn, reps):
        out, ms = None, []
        for _ in range(reps):
            args = (key.clone(), val.clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            del args
        return out, ms

    want, lib_ms = timed(library, 3)
    before = dict(LAUNCHES)
    got, ms = timed(lambda k, v: row_window_sort(
        k, v, rows=span_cap, stride=n + 1, key_bits=bits), 5)
    launches = {k: (v - before[k]) // 5 for k, v in LAUNCHES.items()
                if v != before[k]}
    bad = (int((got[0] != want[0]).sum())
           + int((got[1].view(torch.int32) != want[1].view(torch.int32))
                 .sum()))
    del got, want, key, val
    # bytes: a product's key and value read once and written once
    per = 2 * ((8 if wide else 4) + 4)
    line = dict(slab=s, slabs=bounds.shape[0] - 1, products=live,
                stream_slots=stream_capacity(worst_fl), rows=span_cap,
                key="int64" if wide else "int32", key_bits=bits,
                mismatched_slots=bad, max_abs_err=0.0 if bad == 0 else None,
                ms=statistics.median(ms), ms_each=ms,
                plain_ms=statistics.median(lib_ms), plain_ms_each=lib_ms,
                library_ms=statistics.median(lib_ms),
                launches_per_call=launches, **bound(per * live, 0))
    line["bound_share"] = line["bound_ms"] / line["ms"]
    log(json.dumps({"k10_rows": line}))
    if bad:
        raise AssertionError(f"slab {s}: K10 keyed by row differs from the "
                             f"library sort in {bad} slots")
    if launches != {"winsort_rows": 1}:
        raise AssertionError(f"row_window_sort launched {launches}")
    return line


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
        imbalance=float(nnz.max().float() / nnz.float().mean()),
        block_shape=list(c.block_shape()),
        digests=block_digests(c) if isinstance(c, DistSpMat) else None)
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


def summa3d_launches(grid, block_shape) -> dict:
    """The compress launches of one ``summa3d_spgemm`` on the (l, pr, pc)
    ``grid`` whose product has blocks ``block_shape`` (mb, nb / l), summed
    over the processes: every block of every layer folds its partial
    product, (mb, nb), and its slice of the fiber's reduction, (mb, nb /
    l), each with K2 where the block's packed keys fit, else K4."""
    l, pr, pc = grid
    mb, nbs = block_shape
    want = {}
    for n in (nbs * l, nbs):
        k = "compress_" + ("i32" if (mb + 1) * (n + 1) < 1 << 31 else "i64")
        want[k] = want.get(k, 0) + l * pr * pc
    return want


def grid_phase(cells, ref, flops: int) -> dict:
    """Phases 13 and 14: each grid product of ``card_inputs.grid_cells``
    timed (:func:`_grid_call`), its C equal to phase 11's, and its launches
    those of its route: ``summa_spgemm_auto`` the expansion and compress
    once a block an attempt, the staged SUMMA once a block a stage, the
    ring SUMMA K9 p - 1 times, the 3D SUMMA the compress kernel twice a
    block of a layer (:func:`summa3d_launches`)."""
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
            want = dict.fromkeys((f"expand_{tag}", f"compress_{tag}",
                                  "winsort_rows"), blocks * line["attempts"])
        elif kind == "summa_spgemm_staged":
            want = dict.fromkeys((f"expand_{tag}", f"compress_{tag}",
                                  "winsort_rows"), blocks * side)
        elif kind == "summa_spgemm_rma":
            want = {"ring_shift": side - 1}
        else:
            want = summa3d_launches(info["grid"], line["block_shape"])
        if got != want or line.get("attempts", 1) < 1:
            raise AssertionError(f"{label} launched {got}, want {want}")
        out[label] = line
    return out


# ---------------------------------------------------------- phases 15-16 --

#: Phase 15 runs ``bench.py``'s MCL configuration (``bench_mcl``: SSCA
#: R-MAT, edge factor 8, symmetrized, no self loops, select 64, recover_num
#: 80) at phase 11's scale, the largest at which ``spgemm_auto`` is proven
#: on the card, under a 60 s budget.
MCL_SCALE = AUTO_SCALE
MCL_EDGEFACTOR = 8
MCL_PARAMS = dict(select=64, recover_num=80)
MCL_DEADLINE_SECS = 60.0
#: The card-against-CPU MCL run's scale.
MCL_CHECK_SCALE = 12


def mcl_graph(seed: int, dev, scale: int):
    """``bench_mcl``'s graph from a generator seeded ``seed`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return rmat_matrix(gen, scale, MCL_EDGEFACTOR, symmetrize=True,
                       remove_self_loops=True, probs=SSCA_PROBS)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_iterate(a, p) -> dict:
    """One MCL iterate, counted and summed (float64) apart from the port's
    reductions: ``nnz`` within the capacity (``_compact`` drops entries
    past it), every non-empty column summing to 1 within 1e-5, no column
    longer than ``max(select, recover_num)``."""
    m, n = a.shape
    nnz = int(a.nnz)
    if nnz > a.capacity:
        raise AssertionError(f"iterate nnz {nnz} past its capacity "
                             f"{a.capacity}: entries were dropped")
    row, col = a.row[:nnz].long(), a.col[:nnz].long()
    if nnz and not (int(row.max()) < m and int(col.max()) < n):
        raise AssertionError("iterate holds a pad inside nnz")
    cnt = torch.bincount(col, minlength=n)
    sums = torch.zeros(n, dtype=torch.float64, device=a.device)
    sums.index_add_(0, col, a.val[:nnz].double())
    live = cnt > 0
    err = float((sums[live] - 1).abs().max()) if nnz else 0.0
    if not err <= 1e-5:
        raise AssertionError(f"a column of the iterate sums to 1 +- {err}")
    longest = int(cnt.max())
    if longest > max(p.select, p.recover_num):
        raise AssertionError(f"a column keeps {longest} entries")
    return dict(max_col_sum_err=err, longest_col=longest,
                empty_cols=int((~live).sum()))


def check_prune(a2, out, p) -> dict:
    """The first prune held per column against the rule itself: the kept
    count is min(select, #{|v| >= cutoff}), or min(recover_num, column
    nnz) where recovery fired; the kept entries are entries of the input
    with their values; the least kept |v| is at least the largest dropped
    |v|; outside recovered columns every kept |v| reaches the cutoff."""
    n = a2.shape[1]
    nnz, onnz = int(a2.nnz), int(out.nnz)
    if nnz > a2.capacity or onnz > out.capacity:
        raise AssertionError("prune input or output past its capacity")
    col = a2.col[:nnz].long()
    av = a2.val[:nnz].abs()
    cnt = torch.bincount(col, minlength=n)
    cut = torch.bincount(col[av >= p.cutoff], minlength=n)
    floor = int(p.recover_pct * min(p.recover_num, p.select))
    rec = torch.clamp(cut, max=p.select) < floor
    want = torch.where(rec, torch.clamp(cnt, max=p.recover_num),
                       torch.clamp(cut, max=p.select))
    ocol = out.col[:onnz].long()
    if not torch.equal(torch.bincount(ocol, minlength=n), want):
        raise AssertionError("prune: kept counts differ from the rule")
    key = a2.row[:nnz].long() * n + col
    okey = out.row[:onnz].long() * n + ocol
    pos = torch.searchsorted(key, okey).clamp(max=max(nnz - 1, 0))
    if not (torch.equal(key[pos], okey)
            and torch.equal(a2.val[:nnz][pos], out.val[:onnz])):
        raise AssertionError("prune: a kept entry is not an input entry")
    kept = torch.zeros(nnz, dtype=torch.bool, device=a2.device)
    kept[pos] = True
    lo = torch.full((n,), float("inf"), device=a2.device)
    lo.scatter_reduce_(0, col[kept], av[kept], "amin")
    hi = torch.full((n,), float("-inf"), device=a2.device)
    hi.scatter_reduce_(0, col[~kept], av[~kept], "amax")
    if not bool((lo >= hi).all()):
        raise AssertionError("prune: a dropped |v| exceeds a kept one")
    if not bool(((av[kept] >= p.cutoff) | rec[col[kept]]).all()):
        raise AssertionError("prune: an entry under the cutoff was kept "
                             "without recovery")
    return dict(in_nnz=nnz, in_capacity=a2.capacity, out_nnz=onnz,
                recovered_cols=int((rec & (cnt > 0)).sum()),
                selected_cols=int((cut > p.select).sum()))


#: The iteration of phase 15's checked run whose expansion is also run on
#: the plain route on the card: the first whose plan froze on the pruned
#: iterate's capacity (iteration 2 makes that plan, 3 reuses it).
MCL_PLAIN_ITER = 3
#: An MCL expansion against scipy (float64) or the plain route: float32
#: sums of positive terms, folded in another order.
MCL_EXPAND_RTOL = 1e-5


def _same_entries(got, want, label: str, rtol: float) -> float:
    """Two SpCOOs on one device hold the same live entries: nnz, rows and
    columns exact, values within ``rtol`` relative (to ``F32_TINY`` for
    subnormal values).  Returns the largest relative value difference."""
    nnz = int(want.nnz)
    if not (int(got.nnz) == nnz
            and torch.equal(got.row[:nnz], want.row[:nnz])
            and torch.equal(got.col[:nnz], want.col[:nnz])):
        raise AssertionError(f"{label}: the entries' keys differ")
    gv, wv = got.val[:nnz].double(), want.val[:nnz].double()
    rel = float(((gv - wv).abs() / wv.abs().clamp(min=F32_TINY)).max()) \
        if nnz else 0.0
    if not rel <= rtol:
        raise AssertionError(f"{label}: values differ by {rel} relative")
    return rel


class MCLWatch:
    """Instruments one ``mcl_local`` run by wrapping what it calls through
    its module.  With ``light`` only the last iterate is kept, by reference
    and without a sync, so the loop runs as a user's does.  Otherwise, per
    iteration: the expansion's seconds, plan and attempts, the prune's
    seconds, the iterate's nnz, capacity and chaos, each stage ended by a
    sync (so the split's seconds include those syncs); with ``checks`` the
    checks above, iteration 1's expansion against scipy and iteration
    ``MCL_PLAIN_ITER``'s against the same call on the plain route, their
    seconds taken out of the iteration's; with ``keep``, host copies of
    each iteration's input and output iterates.  ``last`` is the last
    iterate, whose structure gives the labels; ``cap`` the loop's iterate
    capacity bound."""

    def __init__(self, p, checks: bool = False, keep: bool = False,
                 light: bool = False):
        self.p, self.checks, self.keep, self.light = p, checks, keep, light
        self.rows, self.cur = [], self._row()
        self.last = self.prune = self.cap = None

    @staticmethod
    def _row():
        return dict(attempts=0, check_secs=0.0)

    def __enter__(self):
        from combblas_tpu_torch.models import mcl as mcl_mod
        from combblas_tpu_torch.ops import spgemm as spgemm_mod
        names = [(mcl_mod, "chaos")]
        if not self.light:
            names += [(mcl_mod, "_mcl_iteration"), (mcl_mod, "spgemm_auto"),
                      (mcl_mod, "_mcl_prune"), (spgemm_mod, "spgemm_pallas"),
                      (spgemm_mod, "spgemm_pallas_rowchunked")]
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in names]
        orig = {name: fn for _mod, name, fn in self._saved}

        def iteration(a, p, cap, plan):
            self.cap = cap
            if self.keep:
                self.cur["input"] = _host_copy(a)
            return orig["_mcl_iteration"](a, p, cap, plan)

        def expansion(a, b, *args, **kw):
            t = time.perf_counter()
            c = orig["spgemm_auto"](a, b, *args, **kw)
            _sync(a.device)
            plan = kw["plan"]
            self.cur.update(expand_secs=time.perf_counter() - t,
                            products=spgemm_flops(a, b),
                            plan=dict(kind=plan["kind"],
                                      slabs=plan.get("num_slabs"),
                                      wide=plan.get("wide")))
            if self.checks:
                self._check_expansion(orig["spgemm_auto"], a, b, c, args, kw)
            return c

        def attempt(name):
            def run(*args, **kw):
                self.cur["attempts"] += 1
                return orig[name](*args, **kw)
            return run

        def prune(a, p, out_capacity):
            t = time.perf_counter()
            out = orig["_mcl_prune"](a, p, out_capacity)
            _sync(a.device)
            self.cur.update(prune_secs=time.perf_counter() - t,
                            expanded_nnz=int(a.nnz),
                            expanded_capacity=a.capacity)
            if self.checks and self.prune is None:
                t = time.perf_counter()
                self.prune = check_prune(a, out, p)
                self.cur["check_secs"] += time.perf_counter() - t
            return out

        def chaos(a):
            self.last = a
            ch = orig["chaos"](a)
            if self.light:
                return ch
            _sync(a.device)
            self.cur.update(nnz=int(a.nnz), capacity=a.capacity)
            if self.keep:
                self.cur["output"] = _host_copy(a)
            if self.checks:
                t = time.perf_counter()
                self.cur.update(check_iterate(a, self.p))
                self.cur["check_secs"] += time.perf_counter() - t
            return ch

        wrappers = dict(_mcl_iteration=iteration, spgemm_auto=expansion,
                        _mcl_prune=prune, chaos=chaos,
                        spgemm_pallas=attempt("spgemm_pallas"),
                        spgemm_pallas_rowchunked=attempt(
                            "spgemm_pallas_rowchunked"))
        for mod, name, _fn in self._saved:
            setattr(mod, name, wrappers[name])
        return self

    def _check_expansion(self, spgemm_auto, a, b, c, args, kw) -> None:
        """Iteration 1's A² against scipy's; iteration ``MCL_PLAIN_ITER``'s
        against the same call (a copy of its held plan) on the plain
        route, on the card."""
        it = len(self.rows) + 1
        t = time.perf_counter()
        if it == 1:
            ref, secs = _scipy_square(a)
            self.cur.update(scipy_rel_diff=check_against_scipy(
                c, ref, "MCL expansion 1", rtol=MCL_EXPAND_RTOL),
                scipy_secs=secs)
        elif it == MCL_PLAIN_ITER:
            attempts = self.cur["attempts"]
            ref = spgemm_auto(a, b, *args, **dict(
                kw, plan=dict(kw["plan"]), plain=True))
            self.cur.update(attempts=attempts, plain_rel_diff=_same_entries(
                c, ref, f"MCL expansion {it} vs the plain route",
                MCL_EXPAND_RTOL))
        self.cur["check_secs"] += time.perf_counter() - t

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def on_iter(self, it: int, ch: float, secs: float) -> None:
        self.cur.update(it=it, chaos=ch, secs=secs,
                        iter_secs=secs - self.cur["check_secs"])
        self.rows.append(self.cur)
        self.cur = self._row()


def _host_copy(a):
    """A SpCOO's copy on the CPU."""
    return dataclasses.replace(a, row=a.row.cpu(), col=a.col.cpu(),
                               val=a.val.cpu(), nnz=a.nnz.cpu())


def run_mcl(a, p, deadline_secs: float | None = None, **watch):
    """``mcl_local(a, p)`` under an :class:`MCLWatch` made with ``watch``;
    returns (labels, iterations, watch, wall seconds)."""
    from combblas_tpu_torch.models.mcl import mcl_local

    with MCLWatch(p, **watch) as w:
        _sync(a.device)
        t = time.perf_counter()
        deadline = None if deadline_secs is None else t + deadline_secs
        labels, iters = mcl_local(a, p, on_iter=w.on_iter, deadline=deadline)
        _sync(a.device)
        wall = time.perf_counter() - t
    return labels, iters, w, wall


def check_labels(labels, a) -> int:
    """The labels equal scipy's connected components of the iterate's
    structure (weakly connected, as the port merges A with its transpose),
    each mapped to the component's least vertex id.  Returns the number of
    clusters."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if int(a.nnz) > a.capacity:
        raise AssertionError(f"iterate nnz {int(a.nnz)} past its capacity "
                             f"{a.capacity}: entries were dropped")
    row, col, _val, nnz, shape = a.to_numpy()
    n = shape[0]
    g = coo_matrix((np.ones(nnz, np.int8), (row[:nnz], col[:nnz])),
                   shape=shape).tocsr()
    ncomp, comp = connected_components(g, directed=True, connection="weak")
    least = np.full(ncomp, n, np.int64)
    np.minimum.at(least, comp, np.arange(n))
    if not np.array_equal(labels.cpu().numpy().astype(np.int64),
                          least[comp]):
        raise AssertionError("MCL labels differ from scipy's components")
    return int(ncomp)


def mcl_step_syncs(a, p, cap: int) -> dict:
    """The host syncs (CUDA sync debug mode's warnings) of one
    ``mcl_local`` iteration from iterate ``a`` with its plan held, as the
    loop runs it, by stage: expansion, prune, and inflation +
    normalisation + chaos."""
    from combblas_tpu_torch.models import mcl

    plan = {}
    mcl._mcl_iteration(a, p, cap, plan)
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def syncs():
            return sum("synchroniz" in str(w.message) for w in caught)

        def after(fn):
            def run(*args, **kw):
                out = fn(*args, **kw)
                seen.append(syncs())
                return out
            return run

        saved = [(name, getattr(mcl, name))
                 for name in ("spgemm_auto", "_mcl_prune")]
        for name, fn in saved:
            setattr(mcl, name, after(fn))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mcl._mcl_iteration(a, p, cap, plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for name, fn in saved:
                setattr(mcl, name, fn)
        total = syncs()
    expand, prune = seen
    return dict(expand=expand, prune=prune - expand, rest=total - prune)


def _mcl_steps(rows, p, cap: int) -> dict:
    """Each card iteration's step (``_mcl_iteration``, the loop's own
    body) again on the CPU (plain versions) from the card's own input
    iterate.  The output iterate's nnz and keys must be equal, its values
    within 1e-5 relative, its chaos within 1e-5 (chaos is a column max less
    a column sum of squares, each at most 1: its rounding error is
    absolute)."""
    from combblas_tpu_torch.models.mcl import _mcl_iteration

    val_rel, chaos_abs = [], []
    for r in rows:
        want, ch = _mcl_iteration(r["input"], p, cap, {})
        val_rel.append(_same_entries(
            r["output"], want, f"MCL step {r['it']}, card vs CPU", 1e-5))
        chaos_abs.append(abs(r["chaos"] - ch))
    if max(chaos_abs) > 1e-5:
        raise AssertionError(f"MCL steps, card vs CPU: chaos {chaos_abs}")
    return dict(step_val_max_rel_diff=max(val_rel),
                step_chaos_max_abs_diff=max(chaos_abs))


def _chaos_diffs(x, y):
    rel = max(abs(a - b) / abs(b) if b else abs(a) for a, b in zip(x, y))
    return rel, max(abs(a - b) for a, b in zip(x, y))


def mcl_card_vs_cpu(seed: int, dev, scale: int = MCL_CHECK_SCALE,
                    params: dict = MCL_PARAMS) -> dict:
    """``mcl_local`` with ``params`` on the card against the same call on
    CPU tensors (the plain versions), on an SSCA graph whose values are
    seeded uniform(0.5, 1.5) weights, so that no two entries tie and no
    select boundary rests on the kernels' summation order: no iterate past
    its capacity (where one is, ``_compact`` drops entries and the runs
    part), iterations, the nnz of every iterate and the labels exact, and
    the card run launches the narrow expansion and compress (K1, K2) at
    least once an iteration.
    Chaos is held step by step (:func:`_mcl_steps`); whole-run chaos
    differences, card against CPU and against a second card run, are
    reported, not held: over whole runs MCL's inflation amplifies last-bit
    differences (the card's folds and atomics sum in other orders)."""
    from combblas_tpu_torch.models.mcl import MCLParams
    from combblas_tpu_torch.ops.coo import SpCOO

    g = mcl_graph(seed, dev, scale)
    row, col, _val, nnz, shape = g.to_numpy()
    val = np.zeros(g.capacity, np.float32)
    val[:nnz] = np.random.default_rng(seed).uniform(0.5, 1.5, nnz)
    p = MCLParams(**params)
    runs = {}
    for name, d in (("card", dev), ("card_again", dev),
                    ("cpu", torch.device("cpu"))):
        a = SpCOO.from_numpy(row, col, val, nnz, shape, device=d)
        _sync(d)
        reset_launches()
        labels, iters, w, wall = run_mcl(a, p, keep=name == "card")
        runs[name] = dict(labels=labels.cpu(), iters=iters, wall=wall,
                          rows=w.rows, cap=w.cap,
                          nnz=[r["nnz"] for r in w.rows],
                          chaos=[r["chaos"] for r in w.rows],
                          plans=[r["plan"] for r in w.rows],
                          launches={k: v for k, v in LAUNCHES.items() if v})
    for name, r in runs.items():
        if max(r["nnz"]) > r["cap"]:
            raise AssertionError(f"MCL {name} run: an iterate of "
                                 f"{max(r['nnz'])} entries passed its "
                                 f"capacity {r['cap']}")
    card, cpu = runs["card"], runs["cpu"]
    launches = card["launches"]
    if not all(launches.get(k, 0) >= card["iters"]
               for k in ("expand_i32", "compress_i32")):
        raise AssertionError(f"MCL card run of {card['iters']} iterations "
                             f"launched {launches}")
    for other in ("card_again", "cpu"):
        o = runs[other]
        if card["iters"] != o["iters"] or card["nnz"] != o["nnz"]:
            raise AssertionError(f"MCL card vs {other}: iterations "
                                 f"{card['iters']} vs {o['iters']}, nnz "
                                 f"{card['nnz']} vs {o['nnz']}")
        if not torch.equal(card["labels"], o["labels"]):
            raise AssertionError(f"MCL card vs {other}: labels differ")
    t = time.perf_counter()
    steps = _mcl_steps(card["rows"], p, card["cap"])
    rel, absd = _chaos_diffs(card["chaos"], cpu["chaos"])
    rel2, abs2 = _chaos_diffs(runs["card_again"]["chaos"], card["chaos"])
    out = dict(scale=scale, nnz=int(nnz), params=params,
               iters=card["iters"], iterate_nnz=card["nnz"],
               capacity_bound=card["cap"], plans=card["plans"],
               launches=launches,
               chaos_card=card["chaos"], chaos_cpu=cpu["chaos"],
               chaos_max_rel_diff=rel, chaos_max_abs_diff=absd,
               card_rerun_chaos_max_rel_diff=rel2,
               card_rerun_chaos_max_abs_diff=abs2,
               card_secs=card["wall"], cpu_secs=cpu["wall"],
               step_check_secs=time.perf_counter() - t,
               clusters=int(torch.unique(card["labels"]).numel()), **steps)
    log(f"  card vs CPU, scale {scale}: {card['iters']} iterations, nnz "
        f"and labels equal (and on a second card run); card launches "
        f"{launches}; one step from the card's iterate: values "
        f"{steps['step_val_max_rel_diff']:.3g} rel, chaos "
        f"{steps['step_chaos_max_abs_diff']:.3g} abs; whole runs: chaos "
        f"{rel:.3g} rel ({absd:.3g} abs), card against card {rel2:.3g} "
        f"({abs2:.3g}); card {card['wall']:.2f} s, CPU {cpu['wall']:.2f} s")
    return out


def _expand_compress_launches(launches: dict, label: str) -> None:
    """Every expansion launch has its compress, and there is one."""
    pairs = [(launches.get(f"expand_{w}", 0), launches.get(f"compress_{w}",
                                                           0))
             for w in ("i32", "i64")]
    if sum(e for e, _ in pairs) < 1 or any(e != c for e, c in pairs):
        raise AssertionError(f"{label} launched {launches}")


def mcl_full(a) -> dict:
    """Phase 15: ``bench_mcl`` on the card, twice.  The timed run is
    ``mcl_local`` as a user calls it (``on_iter`` alone): its seconds, the
    expansion and compress launches read around it, peak memory, and its
    labels against scipy.  The checked run, under :class:`MCLWatch` for as
    many iterations, splits each iteration by stage (each stage ended by a
    sync) and checks every iterate, the first prune against the rule,
    iteration 1's expansion against scipy, iteration ``MCL_PLAIN_ITER``'s
    against the plain route, and its labels against scipy."""
    from combblas_tpu_torch.models.mcl import MCLParams

    p = MCLParams(**MCL_PARAMS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    labels, iters, lw, wall = run_mcl(a, p, MCL_DEADLINE_SECS, light=True)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    _expand_compress_launches(launches, "MCL")
    t = time.perf_counter()
    clusters = check_labels(labels, lw.last)
    label_check_secs = time.perf_counter() - t
    timed = lw.rows
    del labels, lw
    torch.cuda.empty_cache()
    pc = dataclasses.replace(p, max_iters=int(iters))
    reset_launches()
    labels, iters_c, w, wall_c = run_mcl(a, pc, checks=True)
    launches_c = {k: v for k, v in LAUNCHES.items() if v}
    _expand_compress_launches(launches_c, "MCL (checked run)")
    clusters_c = check_labels(labels, w.last)
    syncs = mcl_step_syncs(w.last, p, w.cap)
    rows = w.rows
    secs = [r["secs"] for r in timed]
    steady = sorted(secs[2:] or secs)
    chaos = [r["chaos"] for r in timed]
    out = dict(
        scale=MCL_SCALE, nnz=int(a.nnz), iters=int(iters),
        converged=bool(chaos[-1] < p.eps),
        first_iter_secs=secs[0], steady_secs_per_iter=steady[len(steady) // 2],
        total_secs=wall, clusters=clusters,
        params=dict(MCL_PARAMS, eps=p.eps, cutoff=p.cutoff,
                    inflation=p.inflation),
        deadline_secs=MCL_DEADLINE_SECS, chaos=chaos, iter_secs=secs,
        launches=launches, peak_mem_gb=peak / 2**30,
        label_check_secs=label_check_secs,
        checked_run=dict(
            iters=int(iters_c), clusters=clusters_c,
            same_as_timed=bool(iters_c == iters and clusters_c == clusters),
            chaos=[r["chaos"] for r in rows],
            iterate_nnz=[r["nnz"] for r in rows],
            iterate_capacity=[r["capacity"] for r in rows],
            capacity_bound=w.cap,
            expanded_nnz=[r["expanded_nnz"] for r in rows],
            expanded_capacity=[r["expanded_capacity"] for r in rows],
            products=[r["products"] for r in rows],
            plans=[r["plan"] for r in rows],
            retries=[r["attempts"] - 1 for r in rows],
            iter_secs_with_syncs=[r["iter_secs"] for r in rows],
            expand_secs=[r["expand_secs"] for r in rows],
            prune_secs=[r["prune_secs"] for r in rows],
            check_secs=[r["check_secs"] for r in rows],
            total_secs_with_checks=wall_c,
            longest_col=[r["longest_col"] for r in rows],
            max_col_sum_err=max(r["max_col_sum_err"] for r in rows),
            first_prune=w.prune,
            expansion1_scipy_rel_diff=rows[0]["scipy_rel_diff"],
            expansion1_scipy_secs=rows[0]["scipy_secs"],
            plain_iter=MCL_PLAIN_ITER,
            plain_rel_diff=rows[MCL_PLAIN_ITER - 1]["plain_rel_diff"],
            launches=launches_c, syncs_per_iter=syncs))
    c = out["checked_run"]
    split = sum(c["expand_secs"]) / sum(c["iter_secs_with_syncs"])
    log(f"  timed run: {iters} iterations, converged {out['converged']}, "
        f"{clusters} clusters (equal scipy's); first {secs[0]:.4f} s, "
        f"steady {out['steady_secs_per_iter']:.4f} s/iter, total "
        f"{wall:.3f} s; launches {launches}; peak {peak / 2**30:.2f} GiB")
    log(f"  checked run: {iters_c} iterations, {clusters_c} clusters "
        f"(equal scipy's); {split:.1%} of its synced iterations in the "
        f"expansion; every iterate and the first prune checked; expansion "
        f"1 vs scipy {c['expansion1_scipy_rel_diff']:.3g} rel (scipy "
        f"{c['expansion1_scipy_secs']:.1f} s), expansion {MCL_PLAIN_ITER} "
        f"vs the plain route {c['plain_rel_diff']:.3g} rel; host syncs an "
        f"iteration {syncs}")
    return out


def _scipy_block(a, v):
    """A[v][:, v] by scipy on the host, float64, sorted indices."""
    import scipy.sparse as sp

    row, col, val, nnz, shape = a.to_numpy()
    s = sp.csr_matrix((val[:nnz].astype(np.float64), (row[:nnz], col[:nnz])),
                      shape=shape)
    c = s[v][:, v].tocsr()
    c.sort_indices()
    return c


def indexing_full(a, seed: int) -> dict:
    """Phase 16: ``spref`` (P·A·Q through ``spgemm_auto``) and
    ``induced_subgraph`` of the scale-17 graph on a seeded half of its
    vertices, each equal to scipy's ``A[v][:, v]``: keys and values exact
    (every value a count of duplicate edges, each output one product)."""
    from combblas_tpu_torch.ops.indexing import induced_subgraph, spref

    n = a.shape[0]
    v = np.random.default_rng(seed).permutation(n)[:n // 2]
    ref = _scipy_block(a, v)
    out = dict(scale=MCL_SCALE, vertices=len(v), nnz_ref=int(ref.nnz))
    calls = {"spref": lambda: spref(a, v, v),
             "induced_subgraph": lambda: induced_subgraph(a, v)}
    for name, call in calls.items():
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        c = call()
        nnz = int(c.nnz)
        secs = time.perf_counter() - t
        launches = {k: cnt for k, cnt in LAUNCHES.items() if cnt}
        check_against_scipy(c, ref, name)
        out[name] = dict(secs=secs, nnz=nnz, capacity=c.capacity,
                         launches=launches)
        del c
    _expand_compress_launches(out["spref"]["launches"], "spref")
    log(f"  spref {out['spref']['secs']:.3f} s, launches "
        f"{out['spref']['launches']}; induced_subgraph "
        f"{out['induced_subgraph']['secs']:.3f} s; both equal scipy's "
        f"A[v][:, v] ({ref.nnz} entries)")
    return out


# ---------------------------------------------------------- phases 17-18 --

#: The block grid of phases 17 and 18's full-size runs (side x side).
DIST_SIDE = 4
#: Roots of phase 8 that phase 17 runs both distributed BFS variants from.
DIST_BFS_ROOTS = 4


def _edges_in_component(deg, levels) -> int:
    """Graph500's edge count of a search: the undirected edges of the
    vertices it reached."""
    return int((deg * (levels >= 0)).sum()) // 2


def _fold_routes_ms(dm, live, x) -> dict:
    """``dist_spmv`` PLUS_TIMES's fold of the products into the blocks'
    partials, timed by route on the same products: ``segment_reduce`` over
    the ascending segment ids (the route taken) and
    ``index_put_(accumulate=True)`` (which sorts them first); the two
    results within 1e-5 relative of each other (each folds a segment in
    its own fixed order)."""
    pr, pc = dm.grid.pr, dm.grid.pc
    mb, nb = dm.block_shape()
    bid, r, c, v = live
    xp = torch.zeros(pc * nb, dtype=x.dtype, device=x.device)
    xp[:x.shape[0]] = x
    prod = v * xp[(bid % pc) * nb + c.clamp(max=nb - 1)]
    seg = bid * mb + r
    num = pr * pc * mb

    def by_segments():
        return torch.segment_reduce(prod, "sum", lengths=torch.bincount(
            seg, minlength=num), unsafe=True)

    def by_index_put():
        return torch.zeros(num, dtype=prod.dtype, device=prod.device
                           ).index_put_((seg,), prod, accumulate=True)

    torch.testing.assert_close(by_segments(), by_index_put(), rtol=1e-5,
                               atol=1e-6)
    return dict(fold_segment_reduce=cuda_ms(by_segments),
                fold_index_put=cuda_ms(by_index_put))


def dist_graph_full(s, roots, want_levels, seed: int,
                    refs: dict | None = None) -> dict:
    """Phase 17: the distributed SpMV and the algorithms on it, on ``s``
    (phase 8's graph) distributed over a 4x4 block grid of the card.
    ``dist_spmv`` PLUS_TIMES against ``torch.sparse.mm`` (rtol 1e-4) and
    MIN_SECOND against the single-device ``spmv`` (exact); ``bfs_dist`` and
    ``bfs_dir_opt_dist`` from ``roots``, each Graph500-validated, with
    levels equal to ``want_levels`` (phase 8's); ``fastsv_dist`` and
    ``lacc_dist`` labels equal to ``fastsv_local``'s and the component
    count equal to scipy's; ``luby_mis_dist`` independent and maximal,
    checked on the host against the edge list.  ``refs`` gets ``"lacc"``
    (the labels of the n vertices) and ``"mis"`` (the padded set), which
    phase 26's pod must give again."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from combblas_tpu_torch.models import bfs as bfs_mod
    from combblas_tpu_torch.models.cc import (
        count_components,
        fastsv_dist,
        fastsv_local,
    )
    from combblas_tpu_torch.models.lacc import lacc_dist
    from combblas_tpu_torch.models.mis import luby_mis_dist
    from combblas_tpu_torch.ops.spmv import spmv
    from combblas_tpu_torch.parallel.spmv import dist_spmv
    from combblas_tpu_torch.semiring import MIN_SECOND

    dev = s.device
    n = s.shape[0]
    _sync(dev)
    t = time.perf_counter()
    dm = DistSpMat.from_local(s, ProcGrid.make(DIST_SIDE, DIST_SIDE,
                                               device=dev))
    _sync(dev)
    out = dict(n=n, nnz=int(s.nnz), grid=[DIST_SIDE, DIST_SIDE],
               block_capacity=dm.capacity,
               block_imbalance=float(dm.load_imbalance()),
               distribute_secs=time.perf_counter() - t)
    # SpMV
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(n, generator=gen, device=dev)
    csr = _csr(s)
    y = dist_spmv(dm, x)
    torch.testing.assert_close(y[:n], torch.sparse.mm(csr, x[:, None])[:, 0],
                               rtol=1e-4, atol=1e-6)
    if not torch.equal(dist_spmv(dm, x), y):
        raise AssertionError("dist_spmv PLUS_TIMES: two calls differ")
    xi = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    if not torch.equal(dist_spmv(dm, xi, MIN_SECOND)[:n],
                       spmv(s, xi, MIN_SECOND)):
        raise AssertionError("dist_spmv MIN_SECOND differs from spmv")
    live = _live_entries(dm)
    out["spmv_ms"] = dict(
        dist_plus_times=cuda_ms(lambda: dist_spmv(dm, x)),
        dist_plus_times_live=cuda_ms(lambda: dist_spmv(dm, x, live=live)),
        dist_min_second=cuda_ms(lambda: dist_spmv(dm, xi, MIN_SECOND)),
        local_plus_times=cuda_ms(lambda: spmv(s, x)),
        torch_sparse_mm=cuda_ms(lambda: torch.sparse.mm(csr, x[:, None])),
        **_fold_routes_ms(dm, live, x))
    del csr, live, y
    # BFS from phase 8's roots
    rp = s.row_ptr()
    deg = rp[1:] - rp[:-1]
    pulls = []
    pull = bfs_mod.dist_bfs_pull_masked

    def counted(*args, **kw):
        pulls.append(1)
        return pull(*args, **kw)

    out["bfs"] = []
    bfs_mod.dist_bfs_pull_masked = counted
    try:
        for i, r in enumerate(roots):
            for name, fn in (("bfs_dist", bfs_mod.bfs_dist),
                             ("bfs_dir_opt_dist", bfs_mod.bfs_dir_opt_dist)):
                pulls.clear()
                _sync(dev)
                t = time.perf_counter()
                par, lv = fn(dm, int(r))
                _sync(dev)
                secs = time.perf_counter() - t
                par, lv = par[:n], lv[:n]
                if not validate_bfs(s, int(r), par, lv):
                    raise AssertionError(f"{name} from {r} does not "
                                         "validate")
                if not torch.equal(lv, want_levels[i]):
                    raise AssertionError(f"{name} from {r}: levels differ "
                                         "from phase 8's")
                levels = int(lv.max()) + 1
                edges = _edges_in_component(deg, lv)
                out["bfs"].append(dict(
                    fn=name, root=int(r), levels=levels,
                    pull_levels=len(pulls), push_levels=levels - len(pulls),
                    secs=secs, edges=edges, teps=edges / secs))
    finally:
        bfs_mod.dist_bfs_pull_masked = pull
    # components
    _sync(dev)
    secs = {}
    labels = {}
    for name, fn in (("fastsv_local", lambda: fastsv_local(s)),
                     ("fastsv_dist", lambda: fastsv_dist(dm)[:n]),
                     ("lacc_dist", lambda: lacc_dist(dm)[:n])):
        t = time.perf_counter()
        labels[name] = fn()
        _sync(dev)
        secs[name] = time.perf_counter() - t
    for name in ("fastsv_dist", "lacc_dist"):
        if not torch.equal(labels[name], labels["fastsv_local"]):
            raise AssertionError(f"{name} labels differ from fastsv_local's")
    row, col, _v, nnz, _shape = s.to_numpy()
    g = coo_matrix((np.ones(nnz, np.int8), (row[:nnz], col[:nnz])),
                   shape=(n, n)).tocsr()
    ncomp = int(connected_components(g, directed=False)[0])
    if count_components(labels["fastsv_local"]) != ncomp:
        raise AssertionError("component count differs from scipy's")
    out["components"] = dict(count=ncomp, secs=secs)
    # MIS
    _sync(dev)
    t = time.perf_counter()
    mis = luby_mis_dist(dm, torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    mis_secs = time.perf_counter() - t
    in_set = mis[:n].cpu().numpy()
    r_, c_ = row[:nnz], col[:nnz]
    if (in_set[r_] & in_set[c_]).any():
        raise AssertionError("luby_mis_dist: an edge inside the set")
    covered = in_set.copy()
    covered[r_[in_set[c_]]] = True
    if not covered.all():
        raise AssertionError("luby_mis_dist: the set is not maximal")
    out["mis"] = dict(size=int(in_set.sum()), secs=mis_secs)
    if refs is not None:
        refs.update(lacc=labels["lacc_dist"].cpu().numpy(),
                    mis=mis.cpu().numpy(), lacc_secs=secs["lacc_dist"],
                    mis_secs=mis_secs, spmm=pod_spmm_refs(dm, seed))
    b = out["bfs"]
    log(f"  4x4 grid: block capacity {dm.capacity}, imbalance "
        f"{out['block_imbalance']:.3f}, distributed in "
        f"{out['distribute_secs']:.2f} s; dist_spmv "
        f"{out['spmv_ms']['dist_plus_times']:.3f} ms (spmv "
        f"{out['spmv_ms']['local_plus_times']:.3f}, torch.sparse.mm "
        f"{out['spmv_ms']['torch_sparse_mm']:.3f}), equal to both")
    for r in b:
        log(f"  {r['fn']} root {r['root']}: {r['levels']} levels "
            f"({r['push_levels']} push, {r['pull_levels']} pull), "
            f"{r['secs']:.4f} s, {r['teps'] / 1e9:.3f} GTEPS; validates, "
            f"levels equal phase 8's")
    log(f"  components: {ncomp} (scipy's), fastsv_dist and lacc_dist equal "
        f"fastsv_local; secs {secs}; MIS of {out['mis']['size']} vertices "
        f"in {mis_secs:.3f} s, independent and maximal")
    del dm
    return out


#: Phase 18's card-against-CPU run: the scale and grid side.
MCL_DIST_CHECK_SCALE = 12
MCL_DIST_CHECK_SIDE = 2
#: The iterations of phase 18's 2-phase runs, against 1-phase runs: keys
#: exact, values within ``MCL_PHASES_RTOL`` where the folds are sequential
#: (the CPU's plain versions).
MCL_PHASES_ITERS = 3
MCL_PHASES_RTOL = 1e-6


def _with_loops(a):
    """``a`` plus the identity (``mcl_local``'s ``add_self_loops``, which
    ``mcl_dist`` leaves to its caller)."""
    from combblas_tpu_torch.ops.coo import SpCOO, merge

    eye = SpCOO.eye(a.shape[0], dtype=a.val.dtype, device=a.device)
    return merge(a, eye, PLUS_TIMES)


def _dist_host_copy(m):
    """A DistSpMat's copy on a CPU grid of the same shape."""
    grid = dataclasses.replace(m.grid, device=torch.device("cpu"))
    return dataclasses.replace(m, row=m.row.cpu(), col=m.col.cpu(),
                               val=m.val.cpu(), nnz=m.nnz.cpu(), grid=grid)


def check_dist_iterate(m) -> dict:
    """One ``mcl_dist`` iterate: no block past its capacity, every
    non-empty column summing to 1 within 1e-5 (float64 sums of its live
    entries)."""
    if int(m.nnz.max()) > m.capacity:
        raise AssertionError(f"a block holds {int(m.nnz.max())} entries "
                             f"past its capacity {m.capacity}")
    loc = m.to_local()
    nnz = int(loc.nnz)
    n = loc.shape[1]
    col = loc.col[:nnz].long()
    sums = torch.zeros(n, dtype=torch.float64, device=col.device)
    sums.index_add_(0, col, loc.val[:nnz].double())
    cnt = torch.bincount(col, minlength=n)
    err = float((sums[cnt > 0] - 1).abs().max()) if nnz else 0.0
    if not err <= 1e-5:
        raise AssertionError(f"a column of the iterate sums to 1 +- {err}")
    return dict(max_col_sum_err=err, longest_col=int(cnt.max()),
                max_block_nnz=int(m.nnz.max()), capacity=m.capacity)


def _entries(mats):
    """The live entries of DistSpMats with disjoint entries, together, on
    their device: int64 keys row*n + col in ascending order, the values
    beside them, and the shape."""
    parts = [m.to_local() for m in mats]
    n = parts[0].shape[1]
    keys = torch.cat([x.row[:int(x.nnz)].long() * n + x.col[:int(x.nnz)]
                      for x in parts])
    vals = torch.cat([x.val[:int(x.nnz)] for x in parts])
    if len(parts) > 1:
        keys, order = torch.sort(keys)
        vals = vals[order]
    return keys, vals, parts[0].shape


def _host_thresholds(cs, vs, n: int, p):
    """``dist_mcl_prune``'s per-column thresholds in numpy, from the
    entries' columns ``cs`` and values ``vs`` sorted by column, then value
    descending: (thresholds, recovered columns, selected columns)."""
    cnt = np.bincount(cs, minlength=n)
    start = np.cumsum(cnt) - cnt

    def kth(k):
        idx = np.minimum(start + k - 1, max(len(vs) - 1, 0))
        return np.where(cnt >= k, vs[idx] if len(vs) else 0,
                        -np.inf).astype(np.float32)

    def stats(mask):
        return (np.bincount(cs[mask], minlength=n),
                np.bincount(cs[mask], weights=vs[mask], minlength=n))

    nnz_p, sums = stats(vs > np.float32(p.cutoff))
    thresh = np.full(n, np.float32(p.cutoff), np.float32)
    recover = (nnz_p < p.recover_num) & (cnt > nnz_p) & (
        sums < p.recover_pct)
    if p.recover_num > 0 and recover.any():
        thresh[recover] = kth(p.recover_num)[recover]
    sel = ~recover & (nnz_p > p.select)
    if p.select > 0 and sel.any():
        thresh[sel] = kth(p.select)[sel]
        if p.recover_num > 0:
            nnz1, sums1 = stats(~(vs < thresh[cs]))
            resel = sel & (nnz1 < p.recover_num) & (sums1 < p.recover_pct)
            thresh[resel] = kth(p.recover_num)[resel]
    return thresh, recover & (cnt > 0), sel


def check_dist_prune(c, out, p):
    """``dist_mcl_prune``'s output held, column by column, against the
    threshold rule computed in numpy on the host from its input ``c``: the
    same thresholds (cutoff, Kselect at recover_num or select, the
    recovery after selection) and exactly the input's entries at or above
    them, values unchanged.  The entries are ordered on the card (two
    stable sorts: value descending, then column) and copied to the host.
    Returns the statistics and, for :func:`mcl_dist_phases`, the input's
    keys and values and the output's keys (on the card) and the
    thresholds."""
    keys, vals, shape = _entries([c])
    n = shape[1]
    col = keys % n
    order = torch.sort(vals, descending=True, stable=True)[1]
    order = order[torch.sort(col[order], stable=True)[1]]
    thresh, recover, sel = _host_thresholds(col[order].cpu().numpy(),
                                            vals[order].cpu().numpy(), n, p)
    del order
    hk, hv = keys.cpu().numpy(), vals.cpu().numpy()
    keep = ~(hv < thresh[hk % n])
    okeys, ovals, _ = _entries([out])
    if not (np.array_equal(okeys.cpu().numpy(), hk[keep])
            and np.array_equal(ovals.cpu().numpy(), hv[keep])):
        raise AssertionError("dist_mcl_prune differs from the threshold "
                             "rule computed on the host")
    stats = dict(in_nnz=int(hk.shape[0]), out_nnz=int(okeys.shape[0]),
                 recovered_cols=int(recover.sum()),
                 selected_cols=int(sel.sum()))
    return stats, dict(keys=keys, vals=vals, out_keys=okeys, thresh=thresh)


#: The largest relative difference of a 1-phase and a 2-phase expansion
#: value on the card: the compress kernel folds a run of equal keys
#: thread by thread (8 items each), so where a run crosses a thread's edge
#: depends on the stream's layout, and the association of its sum with it.
MCL_PHASES_EXPAND_RTOL = 1e-6
#: One step of each from the same iterate: the 1-phase and 2-phase output
#: iterates' values outside the tie-flip columns (the expansions' 1e-6,
#: squared by the inflation and divided by a column sum so summed).
MCL_PHASES_STEP_RTOL = 1e-5
#: After ``MCL_PHASES_ITERS`` iterations on the card, the 1-phase and the
#: 2-phase iterates may differ in at most this share of the columns (in a
#: key, or in a value by more than ``MCL_PHASES_ITERATE_RTOL`` relative).
#: Each step's own difference is held to tie flips of the rule; those and
#: the ties that rounding breaks differently in the next steps spread only
#: along the iterate's structure, while a fault of the slab route (a slab
#: lost, summed twice or truncated) reaches a whole slab, half the columns.
MCL_PHASES_MAX_DIFF_COLS = 0.01
MCL_PHASES_ITERATE_RTOL = 1e-4


def _phase_step_check(first: dict, seen: list, ref: tuple, out, n: int,
                      it: int) -> dict:
    """One iteration's 2-phase step against the 1-phase step from the same
    input iterate.  The 2-phase slabs' expansions and prunes (``seen``)
    against the 1-phase expansion and prune (``first``, from
    :func:`check_dist_prune`): the expansions' keys equal and values
    within ``MCL_PHASES_EXPAND_RTOL``, the prunes equal except where an
    entry lies within that much of its column's threshold (an exact tie of
    the rule, broken by rounding).  The 2-phase output iterate ``out``
    (the slabs summed by ``dist_add``, inflated, normalised) against the
    1-phase one (``ref``: keys and values from :func:`_entries`): outside
    the columns of those tie flips the same keys and values within
    ``MCL_PHASES_STEP_RTOL``; inside them the keys the prunes left."""
    keys, vals, _ = _entries([c for c, _ in seen])
    okeys = _entries([o for _, o in seen])[0]
    label = f"phases=2 vs phases=1, iteration {it}"
    if not torch.equal(keys, first["keys"]):
        raise AssertionError(f"{label}: the expansions' keys differ")
    v1 = first["vals"].double()
    rel = float(((vals.double() - v1).abs()
                 / v1.abs().clamp(min=F32_TINY)).max())
    if not rel <= MCL_PHASES_EXPAND_RTOL:
        raise AssertionError(f"{label}: expansion values differ by {rel} "
                             f"relative")
    differing = int((vals != first["vals"]).sum())
    flips = torch.cat([first["out_keys"][~torch.isin(first["out_keys"],
                                                     okeys)],
                       okeys[~torch.isin(okeys, first["out_keys"])]])
    fv = v1[torch.searchsorted(keys, flips)]
    t = torch.from_numpy(first["thresh"]).to(keys.device).double()[
        flips % n]
    if not bool(((fv - t).abs() <= MCL_PHASES_EXPAND_RTOL * t.abs()).all()):
        raise AssertionError(f"{label}: a kept entry away from its column's "
                             f"threshold differs")
    del keys, vals, v1
    flip_cols = torch.unique(flips % n)
    k1, x1 = ref
    k2, x2, _ = _entries([out])
    if not (torch.equal(k1[torch.isin(k1 % n, flip_cols)], first["out_keys"][
            torch.isin(first["out_keys"] % n, flip_cols)])
            and torch.equal(k2[torch.isin(k2 % n, flip_cols)],
                            okeys[torch.isin(okeys % n, flip_cols)])):
        raise AssertionError(f"{label}: an iterate's keys in a tie-flip "
                             f"column differ from its prune's")
    m1, m2 = ~torch.isin(k1 % n, flip_cols), ~torch.isin(k2 % n, flip_cols)
    if not torch.equal(k1[m1], k2[m2]):
        raise AssertionError(f"{label}: the iterates' keys differ outside "
                             f"the tie-flip columns")
    y1 = x1[m1].double()
    step_rel = float(((x2[m2].double() - y1).abs()
                      / y1.abs().clamp(min=F32_TINY)).max()) \
        if y1.numel() else 0.0
    if not step_rel <= MCL_PHASES_STEP_RTOL:
        raise AssertionError(f"{label}: the iterates' values differ by "
                             f"{step_rel} relative outside the tie-flip "
                             f"columns")
    return dict(expand_nnz=int(first["keys"].shape[0]),
                expand_max_rel_diff=rel, values_differing=differing,
                prune_nnz=[int(first["out_keys"].shape[0]),
                           int(okeys.shape[0])],
                tie_flips=int(flips.shape[0]),
                tie_flip_cols=int(flip_cols.numel()),
                iterate_nnz=[int(k1.shape[0]), int(k2.shape[0])],
                iterate_max_rel_diff=step_rel)


def mcl_dist_phases(dm, p, local3) -> dict:
    """``phases=2`` against ``phases=1`` on the card, for
    ``MCL_PHASES_ITERS`` iterations of a 2-phase run.  Every iteration,
    held: its input iterate also goes through one 1-phase iteration, whose
    prune is held against the host rule (:func:`check_dist_prune`), and
    the 2-phase step against it (:func:`_phase_step_check`: expansion,
    prune and output iterate).  After the last iteration, against the
    1-phase run's iterate ``local3`` (compacted): the columns that differ
    (a key in one iterate and not the other, or a value more than
    ``MCL_PHASES_ITERATE_RTOL`` apart) number at most
    ``MCL_PHASES_MAX_DIFF_COLS`` of the columns; the keys that differ and
    the largest value difference are reported."""
    from combblas_tpu_torch.models import mcl as mcl_mod

    seen, steps, last = [], [], []
    orig_prune = mcl_mod.dist_mcl_prune
    orig_iteration = mcl_mod._mcl_dist_iteration
    n = dm.gshape[1]

    def prune(c, *args, **kw):
        out = orig_prune(c, *args, **kw)
        seen.append((c, out))
        return out

    def iteration(a, p_, expand):
        one = []

        def hook(c):
            out = orig_prune(c, p_)
            one.append((c, out))
            return out

        ref = orig_iteration(a, p_,
                             lambda m: mcl_mod._expand_2d(m, hook, 1))[0]
        ref = _entries([ref])[:2]
        stats, first = check_dist_prune(*one[0], p_)
        del one
        seen.clear()
        out = orig_iteration(a, p_, expand)
        steps.append(dict(_phase_step_check(first, seen, ref, out[0], n,
                                            len(steps) + 1),
                          one_phase_prune=stats))
        seen.clear()
        del first, ref
        last[:] = [out[0]]
        return out

    mcl_mod.dist_mcl_prune = prune
    mcl_mod._mcl_dist_iteration = iteration
    try:
        mcl_mod.mcl_dist(dm, dataclasses.replace(p, max_iters=MCL_PHASES_ITERS),
                         phases=2)
    finally:
        mcl_mod.dist_mcl_prune = orig_prune
        mcl_mod._mcl_dist_iteration = orig_iteration
    if len(steps) != MCL_PHASES_ITERS:
        raise AssertionError(f"phases=2: {len(steps)} iterations, not "
                             f"{MCL_PHASES_ITERS}")
    digests3 = block_digests(last[0])
    k2, x2, _ = _entries(last)
    del last
    k1 = local3.row[:int(local3.nnz)].long() * n + local3.col[
        :int(local3.nnz)]
    x1 = local3.val[:int(local3.nnz)]
    c1, c2 = torch.isin(k1, k2), torch.isin(k2, k1)
    common = ((x1[c1].double() - x2[c2]).abs()
              / x1[c1].double().abs().clamp(min=F32_TINY))
    cols = torch.unique(torch.cat([k1[~c1] % n, k2[~c2] % n,
                                   k1[c1][common > MCL_PHASES_ITERATE_RTOL]
                                   % n]))
    cap = int(MCL_PHASES_MAX_DIFF_COLS * n)
    if cols.numel() > cap:
        raise AssertionError(
            f"phases=2 vs phases=1 after {MCL_PHASES_ITERS} iterations: "
            f"{cols.numel()} columns differ, more than {cap}")
    out = dict(iters=MCL_PHASES_ITERS, steps=steps, digests3=digests3,
               iterate_nnz=[int(k1.shape[0]), int(k2.shape[0])],
               keys_only_in_1=int((~c1).sum()), keys_only_in_2=int(
                   (~c2).sum()),
               cols_differing=int(cols.numel()), cols_cap=cap,
               common_max_rel_diff=float(common.max()) if common.numel()
               else 0.0)
    log(f"  phases=2 vs phases=1, each of {MCL_PHASES_ITERS} steps from the "
        f"same iterate: expansions equal in keys, values within "
        f"{max(s['expand_max_rel_diff'] for s in steps):.3g} rel; prunes "
        f"equal but {[s['tie_flips'] for s in steps]} tie flips at a column "
        f"threshold; iterates equal outside them, values within "
        f"{max(s['iterate_max_rel_diff'] for s in steps):.3g} rel; after {MCL_PHASES_ITERS} iterations "
        f"{out['keys_only_in_1']} + {out['keys_only_in_2']} of "
        f"{out['iterate_nnz'][0]} keys differ, {out['cols_differing']} "
        f"columns (at most {cap}), common values within "
        f"{out['common_max_rel_diff']:.3g} rel")
    return out


class MCLDistWatch:
    """Instruments ``mcl_dist`` by wrapping, through its module,
    ``_mcl_dist_iteration`` (the loop's body) and, unless ``light``,
    ``mem_efficient_spgemm`` (the expansion) and ``dist_mcl_prune`` (the
    prune inside it).  ``light``: per iteration its host seconds (the body
    ends in a host read of the chaos) and the last iterate by reference,
    nothing else.  Otherwise each stage is ended by a sync and timed, and
    with ``checks`` every iterate is checked (:func:`check_dist_iterate`),
    iteration 1's expansion is held against scipy's A @ A and its prune
    against the host rule; ``keep`` keeps each iteration's input and
    output iterates on the host; ``keep_local`` the compacted output of
    the iteration of that number; ``digests`` the :func:`block_digests` of
    every output iterate (outside its timing)."""

    def __init__(self, p, light: bool = False, checks: bool = False,
                 keep: bool = False, keep_local: int | None = None,
                 digests: bool = False):
        self.p, self.light, self.checks, self.keep = p, light, checks, keep
        self.keep_local, self.digests = keep_local, digests
        self.rows, self.cur = [], self._row()
        self.last = self.prune = self.local = None

    @staticmethod
    def _row():
        return dict(check_secs=0.0, prune_secs=0.0)

    def __enter__(self):
        from combblas_tpu_torch.models import mcl as mcl_mod

        names = ["_mcl_dist_iteration"]
        if not self.light:
            names += ["mem_efficient_spgemm", "dist_mcl_prune"]
        self._saved = [(name, getattr(mcl_mod, name)) for name in names]
        self._mod = mcl_mod
        orig = dict(self._saved)

        def iteration(a, p, expand):
            it = len(self.rows) + 1
            self.cur["input_ref"] = a
            if self.keep:
                self.cur["input"] = _dist_host_copy(a)
            t = time.perf_counter()
            out, ch = orig["_mcl_dist_iteration"](a, p, expand)
            secs = time.perf_counter() - t
            self.last = out
            self.cur.update(it=it, chaos=ch, secs=secs)
            if not self.light:
                self.cur.update(nnz=int(out.total_nnz()),
                                capacity=out.capacity)
            if self.checks:
                t = time.perf_counter()
                self.cur.update(check_dist_iterate(out))
                self.cur["check_secs"] += time.perf_counter() - t
            if self.keep:
                self.cur["output"] = _dist_host_copy(out)
            if it == self.keep_local:
                self.local = out.to_local()
            if self.digests:
                self.cur["digests"] = block_digests(out)
            self.cur.pop("input_ref")
            self.cur["iter_secs"] = secs - self.cur["check_secs"]
            self.rows.append(self.cur)
            self.cur = self._row()
            return out, ch

        def expansion(a, b, *args, **kw):
            _sync(a.row.device)
            t = time.perf_counter()
            c = orig["mem_efficient_spgemm"](a, b, *args, **kw)
            _sync(a.row.device)
            self.cur["spgemm_secs"] = time.perf_counter() - t
            return c

        def prune(c, p, *args, **kw):
            dev = c.row.device
            _sync(dev)
            first = self.checks and not self.rows and self.prune is None
            if first:
                t = time.perf_counter()
                ref, scipy_secs = _scipy_square(self.cur["input_ref"]
                                                .to_local())
                self.cur.update(scipy_secs=scipy_secs,
                                scipy_rel_diff=check_against_scipy(
                                    c.to_local(), ref, "mcl_dist expansion 1",
                                    rtol=MCL_EXPAND_RTOL))
                del ref
                self.cur["check_secs"] += time.perf_counter() - t
            t = time.perf_counter()
            out = orig["dist_mcl_prune"](c, p, *args, **kw)
            _sync(dev)
            self.cur["prune_secs"] += time.perf_counter() - t
            self.cur.update(expanded_nnz=int(c.total_nnz()),
                            expanded_capacity=c.capacity,
                            expanded_max_block_nnz=int(c.nnz.max()))
            if int(c.nnz.max()) >= c.capacity:
                raise AssertionError("an expansion block saturated its "
                                     f"capacity {c.capacity}")
            if first:
                t = time.perf_counter()
                self.prune = check_dist_prune(c, out, p)[0]
                self.cur["check_secs"] += time.perf_counter() - t
            return out

        wrappers = dict(_mcl_dist_iteration=iteration,
                        mem_efficient_spgemm=expansion,
                        dist_mcl_prune=prune)
        for name, _fn in self._saved:
            setattr(mcl_mod, name, wrappers[name])
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved:
            setattr(self._mod, name, fn)


def run_mcl_dist(dm, p, **watch):
    """``mcl_dist(dm, p, ...)`` under an :class:`MCLDistWatch`; ``phases``,
    ``layers``, ``grid3``, ``preprocess`` and ``generator`` go to
    ``mcl_dist``, the rest to the watch.
    Returns (labels, iterations, watch, wall seconds, launches)."""
    from combblas_tpu_torch.models.mcl import mcl_dist

    kw = {k: watch.pop(k) for k in ("phases", "layers", "grid3",
                                    "preprocess", "generator")
          if k in watch}
    with MCLDistWatch(p, **watch) as w:
        _sync(dm.row.device)
        reset_launches()
        t = time.perf_counter()
        labels, iters = mcl_dist(dm, p, **kw)
        _sync(dm.row.device)
        wall = time.perf_counter() - t
        launches = {k: v for k, v in LAUNCHES.items() if v}
    return labels, iters, w, wall, launches


def _k1k2_each_iteration(launches: dict, iters: int, label: str) -> None:
    if not all(launches.get(k, 0) >= iters
               for k in ("expand_i32", "compress_i32")):
        raise AssertionError(f"{label}: {iters} iterations launched "
                             f"{launches}")


def mcl_dist_card_vs_cpu(seed: int, dev, scale: int = MCL_DIST_CHECK_SCALE,
                         side: int = MCL_DIST_CHECK_SIDE,
                         params: dict = MCL_PARAMS,
                         refs: dict | None = None) -> dict:
    """``mcl_dist`` on a side x side grid of the card against the same call
    on CPU tensors (plain versions), on phase 15's check graph (seeded
    uniform(0.5, 1.5) weights) with self loops: iterations, nnz of every
    iterate and labels exact; each iteration's step redone on the CPU from
    the card's input iterate, its output's keys exact and values within
    1e-5 relative, chaos within 1e-5; the card run launches K1 and K2 at
    least once an iteration.  On the CPU, a 2-phase run's iterate after
    ``MCL_PHASES_ITERS`` iterations equals the 1-phase run's (keys exact,
    values within ``MCL_PHASES_RTOL``).  Then the 3D route on a (side, side, 2) grid
    (``layers=2``, ``phases=2``) on the card, twice: its labels equal the
    2D run's (both are each component's least vertex), and the second
    run's labels, iterations and final iterate are the first's bits.  ``refs`` (when given)
    gets, under ``"mcl_layers"``, what phase 26's pod must give again: the
    graph, the layered run's labels, iterations and final iterate's
    :func:`block_digests`, its seconds and peak."""
    from combblas_tpu_torch.models import mcl as mcl_mod
    from combblas_tpu_torch.ops.coo import SpCOO

    g = mcl_graph(seed, dev, scale)
    row, col, _val, nnz, shape = g.to_numpy()
    val = np.zeros(g.capacity, np.float32)
    val[:nnz] = np.random.default_rng(seed).uniform(0.5, 1.5, nnz)
    p = mcl_mod.MCLParams(**params)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        a = _with_loops(SpCOO.from_numpy(row, col, val, nnz, shape, device=d))
        dm = DistSpMat.from_local(a, ProcGrid.make(side, side, device=d))
        labels, iters, w, wall, launches = run_mcl_dist(
            dm, p, keep=name == "card", keep_local=MCL_PHASES_ITERS)
        runs[name] = dict(labels=labels.cpu(), iters=iters, wall=wall,
                          rows=w.rows, nnz=[r["nnz"] for r in w.rows],
                          chaos=[r["chaos"] for r in w.rows],
                          launches=launches, dm=dm, local=w.local)
    card, cpu = runs["card"], runs["cpu"]
    _k1k2_each_iteration(card["launches"], card["iters"],
                         "mcl_dist card run")
    if card["iters"] != cpu["iters"] or card["nnz"] != cpu["nnz"]:
        raise AssertionError(f"mcl_dist card vs CPU: iterations "
                             f"{card['iters']} vs {cpu['iters']}, nnz "
                             f"{card['nnz']} vs {cpu['nnz']}")
    if not torch.equal(card["labels"], cpu["labels"]):
        raise AssertionError("mcl_dist card vs CPU: labels differ")
    t = time.perf_counter()
    val_rel, chaos_abs = [], []

    def hook(c):
        return mcl_mod.dist_mcl_prune(c, p)

    for r in card["rows"]:
        want, ch = mcl_mod._mcl_dist_iteration(
            r["input"], p, lambda m: mcl_mod._expand_2d(m, hook, 1))
        val_rel.append(_same_entries(r["output"].to_local(), want.to_local(),
                                     f"mcl_dist step {r['it']}, card vs CPU",
                                     1e-5))
        chaos_abs.append(abs(r["chaos"] - ch))
    if max(chaos_abs) > 1e-5:
        raise AssertionError(f"mcl_dist steps, card vs CPU: chaos "
                             f"{chaos_abs}")
    step_secs = time.perf_counter() - t
    # where every fold is sequential (the CPU), 2 phases give the 1-phase
    # iterate (columns prune independently; the slabs' columns are disjoint)
    t = time.perf_counter()
    _l, _i, w2, _wall, _ = run_mcl_dist(
        cpu["dm"], dataclasses.replace(p, max_iters=MCL_PHASES_ITERS),
        light=True, phases=2)
    phases_rel = _same_entries(w2.last.to_local(), cpu["local"],
                               "mcl_dist on the CPU, phases=2 vs phases=1",
                               MCL_PHASES_RTOL)
    phases_secs = time.perf_counter() - t
    del w2, _l
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs3 = []
    for _ in range(2):      # the second run must give the same bits
        _sync(dev)
        t = time.perf_counter()
        with MCLDistWatch(p, light=True) as w3:
            labels3, iters3 = mcl_mod.mcl_dist(
                card["dm"], p, phases=2, layers=2,
                grid3=ProcGrid.make(side, side, 2, device=dev))
        _sync(dev)
        runs3.append((time.perf_counter() - t, labels3.cpu(), iters3,
                      block_digests(w3.last)))
    secs3 = runs3[0][0]
    peak3 = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (torch.equal(runs3[0][1], runs3[1][1]) and runs3[0][2:] ==
            runs3[1][2:]):
        raise AssertionError("mcl_dist layers=2: two runs differ in their "
                             "labels, iterations or final iterate's bits")
    if refs is not None:
        a = card["dm"].to_local()
        k = int(a.nnz)
        refs["mcl_layers"] = dict(
            graph=dict(row=a.row[:k].cpu().numpy(),
                       col=a.col[:k].cpu().numpy(),
                       val=a.val[:k].cpu().numpy(), shape=np.asarray(shape)),
            params=params, scale=scale, labels=labels3.cpu().numpy(),
            iters=int(iters3), digests=runs3[0][3], secs=secs3,
            peak_gib=peak3)
    del w3, runs3
    if not torch.equal(labels3.cpu(), card["labels"]):
        raise AssertionError("mcl_dist layers=2: partition differs from "
                             "the 2D run's")
    rel, absd = _chaos_diffs(card["chaos"], cpu["chaos"])
    out = dict(scale=scale, grid=[side, side], nnz=int(nnz), params=params,
               iters=card["iters"], iterate_nnz=card["nnz"],
               launches=card["launches"], card_secs=card["wall"],
               cpu_secs=cpu["wall"], step_check_secs=step_secs,
               step_val_max_rel_diff=max(val_rel),
               step_chaos_max_abs_diff=max(chaos_abs),
               chaos_max_rel_diff=rel, chaos_max_abs_diff=absd,
               clusters=int(torch.unique(card["labels"]).numel()),
               cpu_phases2=dict(iters=MCL_PHASES_ITERS, secs=phases_secs,
                                max_rel_diff=phases_rel),
               layers2=dict(iters=iters3, secs=secs3, phases=2,
                            peak_gib=peak3, repeat_same_bits=True))
    log(f"  card vs CPU, scale {scale}, {side}x{side}: {card['iters']} "
        f"iterations, nnz and labels equal; card launches "
        f"{card['launches']}; one step from the card's iterate: values "
        f"{max(val_rel):.3g} rel, chaos {max(chaos_abs):.3g} abs; whole "
        f"runs: chaos {rel:.3g} rel; card {card['wall']:.2f} s, CPU "
        f"{cpu['wall']:.2f} s, step redo {step_secs:.1f} s; on the CPU "
        f"phases=2 equals phases=1 after {MCL_PHASES_ITERS} iterations "
        f"({phases_rel:.3g} rel); layers=2 "
        f"({side}, {side}, 2): {iters3} iterations in {secs3:.2f} s, the "
        f"same partition, a second run the same bits")
    return out


def mcl_dist_full(a, seed: int, local_line: dict,
                  refs: dict | None = None) -> dict:
    """Phase 18: ``mcl_dist`` on phase 15's graph with self loops, on a 4x4
    grid of the card, ``phases=1`` (the packed route, K1 and K2).  A timed
    run as a user calls it (:class:`MCLDistWatch` ``light``: per-iteration
    host seconds; the K1/K2 launches read around the loop, at least one
    each an iteration; labels against scipy's components of the last
    iterate); a checked run of as many iterations (every iterate,
    iteration 1's expansion against scipy and its prune against the host
    rule, the labels); a ``phases=2`` run of 3 iterations, each step held
    against the 1-phase step from its input and the last iterate against
    the checked run's third (:func:`mcl_dist_phases`); then the scale-12
    card-against-CPU
    run and its 3D route (:func:`mcl_dist_card_vs_cpu`).  ``local_line``
    is phase 15's, reported beside.  ``refs`` gets ``"mcl"``, what phase
    26's pod MCL is held against: the matrix (host arrays), the timed
    run's labels, iterations and times, the checked run's nnz and block
    digests of every iterate, and the digests of the ``phases=2`` run's
    third iterate."""
    from combblas_tpu_torch.models.mcl import MCLParams

    dev = a.device
    p = MCLParams(**MCL_PARAMS)
    a = _with_loops(a)
    n, nnz = a.shape[0], int(a.nnz)
    grid = ProcGrid.make(DIST_SIDE, DIST_SIDE, device=dev)
    dm = DistSpMat.from_local(a, grid)
    host = dict(row=a.row[:nnz].cpu().numpy(), col=a.col[:nnz].cpu().numpy(),
                val=a.val[:nnz].cpu().numpy(), shape=np.asarray(a.shape))
    del a
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    labels, iters, lw, wall, launches = run_mcl_dist(dm, p, light=True)
    peak = torch.cuda.max_memory_allocated()
    _k1k2_each_iteration(launches, iters, "mcl_dist")
    t = time.perf_counter()
    clusters = check_labels(labels[:n], lw.last.to_local())
    label_check_secs = time.perf_counter() - t
    timed = lw.rows
    host_labels = labels.cpu().numpy()
    del labels, lw
    torch.cuda.empty_cache()
    pc = dataclasses.replace(p, max_iters=int(iters))
    labels_c, iters_c, w, wall_c, launches_c = run_mcl_dist(
        dm, pc, checks=True, keep_local=MCL_PHASES_ITERS,
        digests=refs is not None)
    _k1k2_each_iteration(launches_c, iters_c, "mcl_dist (checked run)")
    clusters_c = check_labels(labels_c[:n], w.last.to_local())
    rows, first_prune, local3 = w.rows, w.prune, w.local
    del labels_c, w
    torch.cuda.empty_cache()
    t = time.perf_counter()
    phases2 = mcl_dist_phases(dm, p, local3)
    del local3
    phases2["secs"] = time.perf_counter() - t
    digests3 = phases2.pop("digests3")
    del dm
    torch.cuda.empty_cache()
    secs = [r["secs"] for r in timed]
    steady = sorted(secs[2:] or secs)
    chaos = [r["chaos"] for r in timed]
    expand = [r["spgemm_secs"] - r["prune_secs"] - r["check_secs"]
              for r in rows]
    prune = [r["prune_secs"] for r in rows]
    synced = [r["iter_secs"] for r in rows]
    out = dict(
        scale=MCL_SCALE, n=n, nnz=nnz,
        grid=[DIST_SIDE, DIST_SIDE], phases=1, iters=int(iters),
        converged=bool(chaos[-1] < p.eps), clusters=clusters,
        first_iter_secs=secs[0], steady_secs_per_iter=steady[len(steady) // 2],
        total_secs=wall, iter_secs=secs, chaos=chaos, launches=launches,
        peak_mem_gb=peak / 2**30, label_check_secs=label_check_secs,
        params=dict(MCL_PARAMS, eps=p.eps, cutoff=p.cutoff,
                    inflation=p.inflation),
        mcl_local=dict(iters=local_line["iters"],
                       clusters=local_line["clusters"],
                       steady_secs_per_iter=local_line[
                           "steady_secs_per_iter"],
                       peak_mem_gb=local_line["peak_mem_gb"]),
        checked_run=dict(
            iters=int(iters_c), clusters=clusters_c,
            same_as_timed=bool(iters_c == iters and clusters_c == clusters),
            iterate_nnz=[r["nnz"] for r in rows],
            iterate_capacity=[r["capacity"] for r in rows],
            expanded_nnz=[r["expanded_nnz"] for r in rows],
            expanded_capacity=[r["expanded_capacity"] for r in rows],
            longest_col=[r["longest_col"] for r in rows],
            max_col_sum_err=max(r["max_col_sum_err"] for r in rows),
            iter_secs_with_syncs=synced, expand_secs=expand,
            prune_secs=prune, total_secs_with_checks=wall_c,
            first_prune=first_prune,
            expansion1_scipy_rel_diff=rows[0]["scipy_rel_diff"],
            expansion1_scipy_secs=rows[0]["scipy_secs"],
            launches=launches_c),
        phases2=phases2)
    out["rest_secs"] = wall - sum(secs)
    if refs is not None:
        refs["mcl"] = dict(
            graph=host, labels=host_labels, iters=int(iters),
            nnz=[r["nnz"] for r in rows],
            digests=[r.pop("digests") for r in rows], digests3=digests3,
            one={k: out[k] for k in ("first_iter_secs",
                                     "steady_secs_per_iter", "total_secs",
                                     "rest_secs", "peak_mem_gb")})
    split = sum(expand) / sum(synced)
    log(f"  timed run, {DIST_SIDE}x{DIST_SIDE}, phases=1: {iters} iterations, converged "
        f"{out['converged']}, {clusters} clusters (equal scipy's; "
        f"mcl_local: {local_line['clusters']}, the top-k prune drops ties "
        f"this threshold prune keeps); first {secs[0]:.4f} s, steady "
        f"{out['steady_secs_per_iter']:.4f} s/iter (mcl_local "
        f"{local_line['steady_secs_per_iter']:.4f}), total {wall:.3f} s; "
        f"launches {launches}; peak {peak / 2**30:.2f} GiB")
    log(f"  checked run: {iters_c} iterations, {clusters_c} clusters; "
        f"{split:.1%} of its synced iterations in the expansion, "
        f"{sum(prune) / sum(synced):.1%} in the prune; expansion 1 vs scipy "
        f"{rows[0]['scipy_rel_diff']:.3g} rel; the first prune equals the "
        f"host rule")
    return out


# ---------------------------------------------------------- phases 19-21 --

#: Phase 19's sorted vector: 2^SORT_LOG2 float32 values.
SORT_LOG2 = 26
#: The length of phase 19's other vectors: 2^21 less a few, so that on a
#: 4x4 grid the RandPerm has padding slots.
VEC_LEN = (1 << 21) - 5
#: Float32 bit patterns planted among the sorted values: -0.0, +0.0, +inf,
#: -inf and NaNs of either sign and several payloads.
SPECIAL_BITS = (0x80000000, 0x00000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001)
#: Phase 21's RCM input: the 7-point stencil of a RCM_SIDE^3 grid.
RCM_SIDE = 128
#: Phase 21's minimum-degree input: the 5-point stencil of a MD_SIDE^2
#: grid (both orders are host-paced n-step loops).
MD_SIDE = 24
#: Phase 21's betweenness centrality: phase 8's first BC_SOURCES roots in
#: batches of BC_BATCH, local against the 4x4 grid within BC_RTOL; at
#: BC_CHECK_SCALE the card against the CPU within BC_CHECK_RTOL.
BC_SOURCES = 64
BC_BATCH = 32
BC_RTOL = 1e-4
BC_CHECK_SCALE = 12
BC_CHECK_RTOL = 1e-5
#: Phase 20's card-against-CPU run: scale and grid side.
PREPROCESS_CHECK_SCALE = 12
PREPROCESS_CHECK_SIDE = 2


def host_u32(x: np.ndarray) -> np.ndarray:
    """numpy's twin of ``parallel.vector._sortable_u32`` for float32
    values: the order-preserving uint32 key, in int64."""
    b = x.view(np.uint32).astype(np.int64)
    return np.where(b >= 1 << 31, 0xFFFFFFFF - b, b | (1 << 31))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(_bits(a), _bits(b))


def sort_values(gen, n: int, dev) -> torch.Tensor:
    """``n`` float32 normals from ``gen``, a sixteenth of the slots copying
    another slot's value, and ``n / 2^16`` copies of each of
    ``SPECIAL_BITS`` at random slots."""
    x = torch.randn(n, generator=gen, device=dev)
    k = n // 16
    dst = torch.randint(0, n, (k,), generator=gen, device=dev)
    x[dst] = x[torch.randint(0, n, (k,), generator=gen, device=dev)]
    special = torch.from_numpy(np.array(SPECIAL_BITS, np.uint32).view(
        np.float32)).to(dev)
    reps = max(n >> 16, 1)
    pos = torch.randint(0, n, (reps * special.numel(),), generator=gen,
                        device=dev)
    x[pos] = special.repeat(reps)
    return x


def _host_sorted_order(x: np.ndarray) -> np.ndarray:
    """The order of (host key, index): one sort of the key shifted past the
    index bits, which is ``np.lexsort((index, key))`` for unique
    indices."""
    n = x.shape[0]
    key = host_u32(x)
    shift = max(int(n - 1).bit_length(), 1)
    packed = np.sort((key << shift) | np.arange(n, dtype=np.int64))
    return packed & ((1 << shift) - 1)


def check_sorts(grid, gen, log2: int = SORT_LOG2) -> dict:
    """``dist_sort`` and ``dist_sort_auto`` of 2^log2 float32 values
    (:func:`sort_values`) with a random int32 payload on ``grid``: values
    bit for bit and payloads equal to the host order on (key, index);
    times from CUDA events (and ``torch.sort`` of the floats, which ties
    -0.0 with +0.0, for scale)."""
    from combblas_tpu_torch.parallel.vector import dist_sort, dist_sort_auto

    dev = grid.device
    n = 1 << log2
    x = sort_values(gen, n, dev)
    pay = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    order = _host_sorted_order(x.cpu().numpy())
    xs_h, pay_h = x.cpu().numpy()[order], pay.cpu().numpy()[order]
    out = dict(n=n, grid=[grid.pr, grid.pc], specials=len(SPECIAL_BITS),
               special_copies=max(n >> 16, 1))
    for name, fn in (("dist_sort", dist_sort),
                     ("dist_sort_auto", dist_sort_auto)):
        xs, ps = fn(x, grid, pay)
        if not (np.array_equal(xs.cpu().numpy().view(np.uint32),
                               xs_h.view(np.uint32))
                and np.array_equal(ps.cpu().numpy(), pay_h)):
            raise AssertionError(f"{name}: differs from the host order")
        out[f"{name}_ms"] = cuda_ms(lambda: fn(x, grid, pay), reps=3)
        del xs, ps
    out["torch_sort_ms"] = cuda_ms(lambda: torch.sort(x, stable=True), reps=3)
    log(f"  dist_sort / dist_sort_auto of 2^{log2} float32 (with -0.0, "
        f"+0.0, NaNs) and an int32 payload: {out['dist_sort_ms']:.2f} / "
        f"{out['dist_sort_auto_ms']:.2f} ms (torch.sort "
        f"{out['torch_sort_ms']:.2f} ms); both equal the host order")
    return out


def _twice(fn, label: str):
    """``fn()`` twice: the outputs must be equal bit for bit."""
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if not all(_same_bits(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: two calls differ")
    return a if len(a) > 1 else a[0]


def _host_route(idx, val, mask, init, combine: str):
    """numpy's ``dist_route``: pairs where ``mask`` holds and the index is
    in range, ``set`` keeping the last one a slot receives."""
    n_pad = init.shape[0]
    ok = mask & (idx >= 0) & (idx < n_pad)
    i, v = idx[ok].astype(np.int64), val[ok]
    out, hit = init.copy(), np.zeros(n_pad, bool)
    hit[i] = True
    if combine == "set":
        _, last = np.unique(i[::-1], return_index=True)
        last = i.size - 1 - last
        out[i[last]] = v[last]
    else:
        ufunc = dict(sum=np.add, min=np.minimum, max=np.maximum)[combine]
        ufunc.at(out, i, v)
    return out, hit


def check_vectors(grid, gen, n: int = VEC_LEN,
                  refs: dict | None = None) -> dict:
    """Phase 19's other vector functions at length ``n`` on ``grid``,
    against numpy: ``dist_rand_perm`` a permutation with its padding
    slots ``n`` (two generators of one seed give one permutation);
    ``dist_invert`` of it and of values with duplicates (largest index
    kept); ``dist_uniq`` of floats with repeats, -0.0 and NaNs (smallest
    index kept, by key, a dead slot taking the pad key); ``dist_gather``
    with indices out of range; ``dist_apply_perm`` by the permutation; and
    ``dist_route`` with every combine on quarter-integer values (sums
    exact) with duplicate, masked and out-of-range indices.  Every call
    is made twice, on random floats for the route, and must repeat bit for
    bit.  Times from CUDA events.  ``refs`` gets ``"vectors"``: every
    input and output on the host, which phase 26's pod must give again."""
    from combblas_tpu_torch.parallel.vector import (
        dist_apply_perm,
        dist_gather,
        dist_invert,
        dist_rand_perm,
        dist_route,
        dist_uniq,
    )

    dev = grid.device
    held = {}

    def kept(**arrays):
        held.update({k: v.cpu().numpy() for k, v in arrays.items()})
    seed = int(torch.randint(0, 1 << 30, (1,), generator=gen, device=dev))
    perm = _twice(lambda: dist_rand_perm(torch.Generator(
        device=dev).manual_seed(seed), n, grid), "dist_rand_perm")
    n_pad = perm.shape[0]
    ph = perm.cpu().numpy()
    if not (np.array_equal(np.sort(ph[:n]), np.arange(n))
            and (ph[n:] == n).all() and n_pad > n):
        raise AssertionError("dist_rand_perm: not a permutation with its "
                             "padding sentinels")
    ms = dict(dist_rand_perm=cuda_ms(lambda: dist_rand_perm(
        torch.Generator(device=dev).manual_seed(seed), n, grid), reps=3))
    kept(perm=perm)
    # invert: of the permutation, and of values with duplicates
    live = torch.rand(n_pad, generator=gen, device=dev) < 0.8
    dup = torch.randint(0, n_pad // 4, (n_pad,), generator=gen, device=dev,
                        dtype=torch.int32)
    for label, val, mask in (("perm", perm, perm < n), ("dup", dup, live)):
        got, hit = _twice(lambda: dist_invert(val, mask, grid),
                          f"dist_invert ({label})")
        v, m = val.cpu().numpy(), mask.cpu().numpy()
        want = np.full(n_pad, -1, np.int64)
        np.maximum.at(want, v[m], np.nonzero(m)[0])
        if not (np.array_equal(got.cpu().numpy(), want)
                and np.array_equal(hit.cpu().numpy(), want >= 0)):
            raise AssertionError(f"dist_invert ({label}) differs from numpy")
        kept(**{f"invert_{label}": got, f"invert_{label}_hit": hit})
    ms["dist_invert"] = cuda_ms(lambda: dist_invert(dup, live, grid), reps=3)
    kept(dup=dup, live=live)
    # uniq: floats with repeats and specials
    fv = sort_values(gen, n_pad, dev)
    fv[torch.randint(0, n_pad, (n_pad // 2,), generator=gen, device=dev)] = \
        fv[torch.randint(0, 1024, (n_pad // 2,), generator=gen, device=dev)]
    got, hit = _twice(lambda: dist_uniq(fv, live, grid), "dist_uniq")
    fh, lh = fv.cpu().numpy(), live.cpu().numpy()
    # the first slot of each key, a dead slot keyed 0xFFFFFFFF (as a live
    # NaN 0x7FFFFFFF is): that run's head is live only if no dead slot
    # comes before it, in the JAX package as here
    _, first = np.unique(np.where(lh, host_u32(fh), 0xFFFFFFFF),
                         return_index=True)
    keep = first[lh[first]]
    want, whit = np.zeros(n_pad, np.float32), np.zeros(n_pad, bool)
    want[keep], whit[keep] = fh[keep], True
    if not (np.array_equal(got.cpu().numpy().view(np.uint32),
                           want.view(np.uint32))
            and np.array_equal(hit.cpu().numpy(), whit)):
        raise AssertionError("dist_uniq differs from numpy")
    kept(fv=fv, uniq=got, uniq_hit=hit)
    ms["dist_uniq"] = cuda_ms(lambda: dist_uniq(fv, live, grid), reps=3)
    # gather
    x = torch.randn(n_pad, generator=gen, device=dev)
    gi = torch.randint(-5, n_pad + 5, (n_pad,), generator=gen, device=dev)
    got = _twice(lambda: dist_gather(x, gi, grid), "dist_gather")
    gih, xh = gi.cpu().numpy(), x.cpu().numpy()
    ok = (gih >= 0) & (gih < n_pad)
    if not np.array_equal(got.cpu().numpy(),
                          np.where(ok, xh[np.clip(gih, 0, n_pad - 1)], 0)):
        raise AssertionError("dist_gather differs from numpy")
    kept(x=x, gi=gi, gather=got)
    ms["dist_gather"] = cuda_ms(lambda: dist_gather(x, gi, grid), reps=3)
    # apply_perm: y[perm[i]] = x[i]; the padding slots all name slot n,
    # where the last of them lands (JAX's rule: perm < n_pad routes)
    got = _twice(lambda: dist_apply_perm(x, perm, grid), "dist_apply_perm")
    want = np.zeros(n_pad, np.float32)
    want[ph[:n]] = xh[:n]
    want[n] = xh[n_pad - 1]
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("dist_apply_perm differs from numpy")
    kept(apply_perm=got)
    ms["dist_apply_perm"] = cuda_ms(lambda: dist_apply_perm(x, perm, grid),
                                    reps=3)
    # route: duplicates (every slot about twice), masked, out of range
    ri = torch.randint(0, n_pad // 2, (n_pad,), generator=gen, device=dev)
    ri[torch.randint(0, n_pad, (64,), generator=gen, device=dev)] = n_pad + 1
    ri[torch.randint(0, n_pad, (64,), generator=gen, device=dev)] = -3
    rq = torch.randint(-64, 64, (n_pad,), generator=gen, device=dev) / 4.0
    init = torch.randint(-64, 64, (n_pad,), generator=gen, device=dev) / 4.0
    rf = torch.randn(n_pad, generator=gen, device=dev)
    kept(ri=ri, rq=rq, init=init, rf=rf)
    for combine in ("set", "sum", "min", "max"):
        got, hit = _twice(lambda: dist_route(ri, rq, live, init, grid,
                                             combine=combine),
                          f"dist_route({combine})")
        want, whit = _host_route(ri.cpu().numpy(), rq.cpu().numpy(), lh,
                                 init.cpu().numpy(), combine)
        if not (np.array_equal(got.cpu().numpy(), want)
                and np.array_equal(hit.cpu().numpy(), whit)):
            raise AssertionError(f"dist_route({combine}) differs from numpy")
        gotf, hitf = _twice(lambda: dist_route(ri, rf, live, init, grid,
                                               combine=combine),
                            f"dist_route({combine}) on random floats")
        kept(**{f"route_{combine}": got, f"route_{combine}_hit": hit,
                f"route_{combine}_rf": gotf, f"route_{combine}_rf_hit": hitf})
        ms[f"dist_route_{combine}"] = cuda_ms(lambda: dist_route(
            ri, rf, live, init, grid, combine=combine), reps=3)
    out = dict(n=n, n_pad=n_pad, grid=[grid.pr, grid.pc], ms=ms)
    if refs is not None:
        refs["vectors"] = dict(held, seed=np.asarray(seed), n=np.asarray(n),
                               ms=ms)
    log(f"  vectors of {n} ({n_pad} padded): rand_perm, invert, uniq, "
        f"gather, apply_perm and route (set/sum/min/max) equal numpy and "
        f"repeat bit for bit; ms "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    return out


def _host_permuted(s, perm: np.ndarray):
    """The host relabelling of ``s``'s entries by ``perm``: (rows, cols,
    values) sorted by (row, col)."""
    row, col, val, nnz, shape = s.to_numpy()
    r, c = perm[row[:nnz]].astype(np.int64), perm[col[:nnz]].astype(np.int64)
    order = np.argsort(r * shape[1] + c)
    return r[order], c[order], val[:nnz][order]


def _same_live(a, b) -> bool:
    """Every block's nnz and live prefix equal, slot for slot."""
    return torch.equal(a.nnz, b.nnz) and all(
        _same_bits(x, y) for x, y in zip(_live_entries(a), _live_entries(b)))


def permute_full(s, seed: int, side: int = DIST_SIDE,
                 refs: dict | None = None) -> dict:
    """``dist_permute`` of phase 17's matrix ``s`` on a side x side grid by
    a ``dist_rand_perm`` permutation: equal to the host relabelling of the
    entries (keys and values exact), repeated bit for bit, and the inverse
    permutation (``dist_invert``) gives the matrix back, every block's
    live entries exact.  Host seconds and retries (capacity doublings).
    ``refs`` gets ``"permute"``: the padded permutation and the output's
    :func:`block_digests`, which phase 26's pod must give again."""
    from combblas_tpu_torch.parallel.indexing import dist_permute
    from combblas_tpu_torch.parallel.vector import dist_invert, dist_rand_perm

    dev = s.device
    n = s.shape[0]
    grid = ProcGrid.make(side, side, device=dev)
    dm = DistSpMat.from_local(s, grid)
    full = dist_rand_perm(torch.Generator(device=dev).manual_seed(seed), n,
                          grid)
    perm = full[:n]
    _sync(dev)
    t = time.perf_counter()
    out = dist_permute(dm, perm)
    _sync(dev)
    secs = time.perf_counter() - t
    again = dist_permute(dm, perm)
    if not all(_same_bits(x, y) for x, y in (
            (out.row, again.row), (out.col, again.col), (out.val, again.val),
            (out.nnz, again.nnz))):
        raise AssertionError("dist_permute: two calls differ")
    del again
    if refs is not None:
        refs["permute"] = dict(perm=full.cpu().numpy(),
                               digests=block_digests(out), secs=secs)
    t = time.perf_counter()
    r, c, v = _host_permuted(s, perm.cpu().numpy())
    loc = out.to_local()
    k = int(loc.nnz)
    if not (k == r.size and np.array_equal(loc.row[:k].cpu().numpy(), r)
            and np.array_equal(loc.col[:k].cpu().numpy(), c)
            and np.array_equal(loc.val[:k].cpu().numpy(), v)):
        raise AssertionError("dist_permute differs from the host relabelling")
    host_secs = time.perf_counter() - t
    del loc, r, c, v
    inv, hit = dist_invert(full, full < n, grid)
    if not bool(hit[:n].all()):
        raise AssertionError("dist_invert of the permutation missed slots")
    _sync(dev)
    t = time.perf_counter()
    back = dist_permute(out, inv[:n])
    _sync(dev)
    back_secs = time.perf_counter() - t
    if not _same_live(back, dm):
        raise AssertionError("dist_permute by the inverse: not the matrix")
    line = dict(n=n, nnz=int(s.nnz), grid=[side, side], secs=secs,
                inverse_secs=back_secs, host_check_secs=host_secs,
                capacity_in=dm.capacity, capacity_out=out.capacity,
                retries=int(math.log2(out.capacity // dm.capacity)))
    log(f"  dist_permute of {line['nnz']} entries, {side}x{side}: "
        f"{secs:.3f} s, {line['retries']} retries (capacity "
        f"{dm.capacity} -> {out.capacity}); equals the host relabelling, "
        f"repeats bit for bit; the inverse ({back_secs:.3f} s) gives the "
        f"matrix back")
    return line


def half_vertices(n: int, seed: int) -> np.ndarray:
    """Phase 16's vertex set: a seeded half of the vertices."""
    return np.random.default_rng(seed).permutation(n)[:n // 2]


def _entries_equal(got, r, c, v, label: str, rtol: float = 0.0) -> float:
    """A SpCOO's live entries equal (r, c) exactly and v within ``rtol``
    relative; returns the largest relative difference."""
    k = int(got.nnz)
    if not (k == r.size and np.array_equal(got.row[:k].cpu().numpy(), r)
            and np.array_equal(got.col[:k].cpu().numpy(), c)):
        raise AssertionError(f"{label}: the entries' keys differ")
    gv = got.val[:k].cpu().numpy().astype(np.float64)
    rel = float((np.abs(gv - v) / np.maximum(np.abs(v), F32_TINY)).max()) \
        if k else 0.0
    if not rel <= rtol:
        raise AssertionError(f"{label}: values differ by {rel} relative")
    return rel


def dist_indexing_full(a, seed: int, side: int = DIST_SIDE,
                       refs: dict | None = None) -> dict:
    """``dist_spref``, ``dist_prune_block`` and ``dist_spasgn`` of phase 15's
    graph on a side x side grid, on phase 16's vertices: ``dist_spref``
    against phase 16's local ``spref`` (keys exact, values within 1e-6
    relative); the block prune against the host's mask of the entries;
    ``dist_spasgn`` of twice the submatrix back into A against the host
    assignment (A with its v x v entries doubled), keys and values exact.
    The K1/K2 (or K3/K4) launches of ``dist_spref`` and ``dist_spasgn``
    are read around the calls.  ``refs`` gets ``"indexing"``: the graph's
    arrays and the :func:`block_digests` of the three outputs, which phase
    26's pod must give again."""
    from combblas_tpu_torch.ops.indexing import spref
    from combblas_tpu_torch.parallel.elementwise import dist_apply
    from combblas_tpu_torch.parallel.indexing import (
        dist_prune_block,
        dist_spasgn,
        dist_spref,
    )

    dev = a.device
    n = a.shape[0]
    v = half_vertices(n, seed)
    dm = DistSpMat.from_local(a, ProcGrid.make(side, side, device=dev))
    out = dict(scale=int(n).bit_length() - 1, vertices=len(v),
               grid=[side, side])
    _sync(dev)
    reset_launches()
    t = time.perf_counter()
    sub = dist_spref(dm, v, v)
    nnz_sub = int(sub.total_nnz())
    out["spref_secs"] = time.perf_counter() - t
    out["spref_launches"] = {k: c for k, c in LAUNCHES.items() if c}
    _expand_compress_launches(out["spref_launches"], "dist_spref")
    ref = spref(a, v, v)
    out["spref_rel_diff"] = _same_entries(sub.to_local(), ref,
                                          "dist_spref vs spref", 1e-6)
    out["spref_nnz"] = nnz_sub
    del ref
    row, col, val, nnz, _shape = a.to_numpy()
    row, col = row[:nnz].astype(np.int64), col[:nnz].astype(np.int64)
    val = val[:nnz].astype(np.float64)
    inv = np.zeros(n, bool)
    inv[v] = True
    blk = inv[row] & inv[col]
    _sync(dev)
    t = time.perf_counter()
    pruned = dist_prune_block(dm, v, v)
    _sync(dev)
    out["prune_block_secs"] = time.perf_counter() - t
    _entries_equal(pruned.to_local(), row[~blk], col[~blk], val[~blk],
                   "dist_prune_block")
    digests = dict(spref=block_digests(sub), prune_block=block_digests(pruned))
    del pruned
    b2 = dist_apply(sub, lambda x: 2.0 * x)
    _sync(dev)
    reset_launches()
    t = time.perf_counter()
    asg = dist_spasgn(dm, v, v, b2)
    _sync(dev)
    out["spasgn_secs"] = time.perf_counter() - t
    out["spasgn_launches"] = {k: c for k, c in LAUNCHES.items() if c}
    _expand_compress_launches(out["spasgn_launches"], "dist_spasgn")
    _entries_equal(asg.to_local(), row, col, np.where(blk, 2 * val, val),
                   "dist_spasgn")
    if refs is not None:
        g_row, g_col, g_val, g_nnz, g_shape = a.to_numpy()
        refs["indexing"] = dict(
            digests=dict(digests, spasgn=block_digests(asg)),
            graph=dict(row=g_row[:g_nnz], col=g_col[:g_nnz],
                       val=g_val[:g_nnz], shape=np.asarray(g_shape)),
            secs={k: out[f"{k}_secs"] for k in ("spref", "prune_block",
                                                 "spasgn")})
    out["launches"] = {k: out["spref_launches"].get(k, 0)
                       + out["spasgn_launches"].get(k, 0)
                       for k in set(out["spref_launches"])
                       | set(out["spasgn_launches"])}
    log(f"  dist_spref {out['spref_secs']:.3f} s ({nnz_sub} entries, equal "
        f"phase 16's spref, {out['spref_rel_diff']:.3g} rel; launches "
        f"{out['spref_launches']}), dist_prune_block "
        f"{out['prune_block_secs']:.3f} s, dist_spasgn "
        f"{out['spasgn_secs']:.3f} s (launches {out['spasgn_launches']}); "
        f"prune and assignment equal the host's")
    return out


def _loops_on_live(a):
    """``a`` plus self loops on its vertices of degree >= 1 only (HipMCL's
    order: isolated vertices removed, then loops added), and the mask of
    those vertices."""
    from combblas_tpu_torch.ops.coo import SpCOO, merge

    rp = a.row_ptr()
    live = (rp[1:] > rp[:-1]).cpu().numpy()
    idx = np.nonzero(live)[0]
    eye = SpCOO.from_arrays(idx, idx, np.ones(idx.size, np.float32), a.shape,
                            sum_duplicates=False, device=a.device)
    return merge(a, eye, PLUS_TIMES), live


def _hand_preprocessed(dm, p, generator):
    """``mcl_dist(preprocess=True)`` composed by hand: RemoveIsolated and
    RandPermute, ``mcl_dist`` of that matrix, its labels mapped back to
    the original vertices."""
    from combblas_tpu_torch.models import mcl as mcl_mod

    n = dm.gshape[1]
    b, vmap, _ = mcl_mod.dist_remove_isolated(dm)
    b, perm = mcl_mod.dist_rand_permute(b, generator)
    labels, iters = mcl_mod.mcl_dist(b, p)
    lab = labels.cpu().numpy()
    comp = np.where(vmap >= 0, perm[np.maximum(vmap, 0)], -1)
    return np.where(vmap >= 0, lab[np.maximum(comp, 0)],
                    n + np.arange(n)), iters


def check_cluster_labels(lab: np.ndarray, a, live: np.ndarray) -> int:
    """Preprocessed MCL labels: every isolated vertex a singleton labelled
    n + its index, apart from every other label; every cluster inside one
    connected component of ``a`` (scipy).  Returns the cluster count."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = a.shape[0]
    iso = np.nonzero(~live)[0]
    if not (np.array_equal(lab[iso], n + iso)
            and not np.isin(lab[live], lab[iso]).any()):
        raise AssertionError("an isolated vertex is not a singleton >= n")
    row, col, _val, nnz, shape = a.to_numpy()
    g = coo_matrix((np.ones(nnz, np.int8), (row[:nnz], col[:nnz])),
                   shape=shape)
    _, comp = connected_components(g, directed=True, connection="weak")
    clusters = np.unique(lab).size
    if np.unique(np.stack([lab, comp]), axis=1).shape[1] != clusters:
        raise AssertionError("a cluster spans two connected components")
    return clusters


def mcl_preprocess_full(a, seed: int, side: int = DIST_SIDE,
                        refs: dict | None = None) -> dict:
    """Phase 20: ``mcl_dist(preprocess=True)`` on phase 15's graph plus
    self loops on its vertices of degree >= 1, a side x side grid, one
    phase, a seeded generator: a timed run as a user calls it (per
    iteration host seconds, K1/K2 at least once an iteration); its labels
    checked (:func:`check_cluster_labels`); equal to the hand-composed
    preprocessing (:func:`_hand_preprocessed`) with a generator of the
    same seed; a second run with the same seed bit-identical.  ``refs``
    gets ``"mcl_preprocess"``: the graph's arrays, the seed, the labels,
    the iterations and the isolated count, which phase 26's pod must give
    again, and the timed run's seconds and peak."""
    from combblas_tpu_torch.models.mcl import MCLParams

    dev = a.device
    p = MCLParams(**MCL_PARAMS)
    a, live = _loops_on_live(a)
    n, nnz = a.shape[0], int(a.nnz)
    dm = DistSpMat.from_local(a, ProcGrid.make(side, side, device=dev))

    def generator():
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    labels, iters, lw, wall, launches = run_mcl_dist(
        dm, p, light=True, preprocess=True, generator=generator())
    peak = torch.cuda.max_memory_allocated()
    _k1k2_each_iteration(launches, iters, "mcl_dist(preprocess=True)")
    lab = labels.cpu().numpy()
    clusters = check_cluster_labels(lab, a, live)
    rows = lw.rows
    del lw
    t = time.perf_counter()
    hand, hand_iters = _hand_preprocessed(dm, p, generator())
    hand_secs = time.perf_counter() - t
    if hand_iters != iters or not np.array_equal(hand, lab):
        raise AssertionError("mcl_dist(preprocess=True) differs from the "
                             "hand-composed preprocessing")
    labels2, iters2, _w, wall2, _l = run_mcl_dist(
        dm, p, light=True, preprocess=True, generator=generator())
    if iters2 != iters or not torch.equal(labels2, labels):
        raise AssertionError("mcl_dist(preprocess=True): two runs differ")
    secs = [r["secs"] for r in rows]
    steady = sorted(secs[2:] or secs)
    chaos = [r["chaos"] for r in rows]
    out = dict(scale=int(n).bit_length() - 1, n=n, nnz=nnz,
               isolated=int((~live).sum()), grid=[side, side], phases=1,
               iters=int(iters), converged=bool(chaos[-1] < p.eps),
               clusters=clusters, first_iter_secs=secs[0],
               steady_secs_per_iter=steady[len(steady) // 2],
               total_secs=wall, second_run_secs=wall2, iter_secs=secs,
               launches=launches,
               launches_per_iter={k: c / iters for k, c in launches.items()},
               peak_mem_gb=peak / 2**30, hand_composed_secs=hand_secs)
    if refs is not None:
        g_row, g_col, g_val, g_nnz, g_shape = a.to_numpy()
        refs["mcl_preprocess"] = dict(
            graph=dict(row=g_row[:g_nnz], col=g_col[:g_nnz],
                       val=g_val[:g_nnz], shape=np.asarray(g_shape),
                       seed=np.asarray(seed)),
            labels=lab, iters=int(iters), isolated=out["isolated"],
            one={k: out[k] for k in ("first_iter_secs",
                                     "steady_secs_per_iter", "total_secs",
                                     "peak_mem_gb")})
    log(f"  {out['isolated']} isolated vertices of {n}; {iters} iterations, "
        f"converged {out['converged']}, {clusters} clusters; first "
        f"{secs[0]:.4f} s, steady {out['steady_secs_per_iter']:.4f} s/iter, "
        f"total {wall:.3f} s; launches {launches}; peak "
        f"{out['peak_mem_gb']:.2f} GiB; labels equal the hand-composed "
        f"preprocessing, and a second run's")
    return out


def mcl_preprocess_card_vs_cpu(seed: int, dev,
                               scale: int = PREPROCESS_CHECK_SCALE,
                               side: int = PREPROCESS_CHECK_SIDE) -> dict:
    """``mcl_dist(preprocess=True)`` at ``scale`` on a side x side grid of
    the card against the same call on CPU tensors, both drawing the
    permutation from a CPU generator of one seed: iterations and labels
    exact, K1/K2 on the card at least once an iteration."""
    from combblas_tpu_torch.models.mcl import MCLParams, mcl_dist
    from combblas_tpu_torch.ops.coo import SpCOO

    cpu = torch.device("cpu")
    g, _live = _loops_on_live(mcl_graph(seed, cpu, scale))
    row, col, val, nnz, shape = g.to_numpy()
    p = MCLParams(**MCL_PARAMS)
    runs = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        dm = DistSpMat.from_local(SpCOO.from_numpy(row, col, val, nnz, shape,
                                                   device=d),
                                  ProcGrid.make(side, side, device=d))
        _sync(dev)
        reset_launches()
        t = time.perf_counter()
        labels, iters = mcl_dist(dm, p, preprocess=True,
                                 generator=torch.Generator().manual_seed(seed))
        _sync(dev)
        runs[name] = dict(labels=labels.cpu(), iters=iters,
                          secs=time.perf_counter() - t,
                          launches={k: c for k, c in LAUNCHES.items() if c})
    card, cpu_run = runs["card"], runs["cpu"]
    _k1k2_each_iteration(card["launches"], card["iters"],
                         "mcl_dist(preprocess=True) card run")
    if card["iters"] != cpu_run["iters"] or not torch.equal(
            card["labels"], cpu_run["labels"]):
        raise AssertionError("mcl_dist(preprocess=True) card vs CPU differ")
    log(f"  card vs CPU, scale {scale}, {side}x{side}: {card['iters']} "
        f"iterations, labels equal; card {card['secs']:.2f} s, CPU "
        f"{cpu_run['secs']:.2f} s")
    return dict(scale=scale, grid=[side, side], iters=card["iters"],
                card_secs=card["secs"], cpu_secs=cpu_run["secs"],
                launches=card["launches"])


def stencil(k: int, dims: int, dev, diagonal: bool):
    """The (2*dims+1)-point stencil of a k^dims grid (natural vertex
    order) as global COO tensors on ``dev``: rows, columns, ones."""
    ids = torch.arange(k ** dims, device=dev).reshape((k,) * dims)
    rows, cols = ([ids.reshape(-1)], [ids.reshape(-1)]) if diagonal else \
        ([], [])
    for ax in range(dims):
        lo = ids.narrow(ax, 0, k - 1).reshape(-1)
        hi = ids.narrow(ax, 1, k - 1).reshape(-1)
        rows += [lo, hi]
        cols += [hi, lo]
    r, c = torch.cat(rows), torch.cat(cols)
    return r, c, torch.ones(r.shape[0], device=dev)


def _grid_dist(r, c, v, n: int, grid):
    from combblas_tpu_torch.parallel.dist import _bucket_blocks

    R, C, V, counts = _bucket_blocks(r, c, v, (n, n), grid, None)
    return DistSpMat(row=R, col=C, val=V, nnz=counts, gshape=(n, n),
                     grid=grid)


def _host_levels(indptr, indices, s: int, n: int) -> np.ndarray:
    """BFS levels from ``s`` on the host CSR, -1 where unreached."""
    lev = np.full(n, -1, np.int64)
    stamp = np.zeros(n, np.int64)
    lev[s] = 0
    front, d = np.array([s]), 0
    while front.size:
        starts, lens = indptr[front], indptr[front + 1] - indptr[front]
        off = np.repeat(starts - np.cumsum(lens) + lens, lens)
        nb = indices[off + np.arange(int(lens.sum()))]
        nb = nb[lev[nb] < 0]
        stamp[nb] = np.arange(nb.size)       # one survivor per vertex
        nb = nb[stamp[nb] == np.arange(nb.size)]
        d += 1
        lev[nb] = d
        front = nb
    return lev


def host_rcm(row: np.ndarray, col: np.ndarray, n: int,
             ppv_rounds: int = 8) -> dict:
    """An independent host reverse Cuthill-McKee of a symmetric pattern
    (COO sorted by row, diagonal included), for both parent rules: per
    component a start of least degree, the pseudo-peripheral search of
    ``models/ordering.py``, BFS levels, and within each level the order
    (key, degree, id), the key being the position of the largest-id
    previous-level neighbour (``"parent"``: ``rcm_order``'s BFS parent)
    or the least position among the previous-level neighbours
    (``"min_label"``: ``rcm_order_dist``'s SelectMinSR).  Returns
    {rule: order}."""
    deg = np.bincount(row, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    rules = ("parent", "min_label")
    pos = {rule: np.full(n, -1, np.int64) for rule in rules}
    done = np.zeros(n, bool)
    counter = 0
    while counter < n:
        cand = np.nonzero(~done)[0]
        s = int(cand[np.argmin(deg[cand])])
        last = -1
        for _ in range(ppv_rounds):
            lev = _host_levels(indptr, col, s, n)
            ecc = int(lev.max())
            if ecc <= last:
                break
            last = ecc
            far = np.nonzero(lev == ecc)[0]
            s = int(far[np.argmin(deg[far])])
        lev = _host_levels(indptr, col, s, n)
        done |= lev >= 0
        step = (lev[row] >= 0) & (lev[col] == lev[row] + 1)
        u, w = row[step], col[step]
        by = np.argsort(lev[w], kind="stable")
        u, w = u[by], w[by]
        lw = lev[w]
        members = np.argsort(lev, kind="stable")
        lev_sorted = lev[members]
        scratch = dict(parent=np.full(n, -1, np.int64),
                       min_label=np.full(n, n, np.int64))
        for rule in rules:
            pos[rule][s] = counter
        base = counter + 1
        for lvl in range(1, int(lev.max()) + 1):
            a, b = np.searchsorted(lw, [lvl, lvl + 1])
            ma, mb = np.searchsorted(lev_sorted, [lvl, lvl + 1])
            mem = members[ma:mb]
            for rule in rules:
                p, sc = pos[rule], scratch[rule]
                if rule == "parent":
                    np.maximum.at(sc, w[a:b], u[a:b])
                    key = p[sc[mem]]
                else:
                    np.minimum.at(sc, w[a:b], p[u[a:b]])
                    key = sc[mem]
                order = mem[np.lexsort((mem, deg[mem], key))]
                p[order] = base + np.arange(order.size)
            base += mem.size
        counter = base
    return {rule: np.argsort(pos[rule])[::-1].copy() for rule in rules}


def bandwidth(row: torch.Tensor, col: torch.Tensor, order) -> int:
    """The bandwidth of the pattern (row, col) under ``order`` (order[i] =
    the i-th vertex)."""
    order = torch.as_tensor(np.asarray(order), device=row.device)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=row.device,
                              dtype=order.dtype)
    return int((pos[row.long()] - pos[col.long()]).abs().max())


def relabelled_stencil(seed: int, dev, k: int, grid):
    """The 7-point stencil of a k^3 grid (diagonal included) on the
    one-process ``grid``, relabelled at random by ``dist_rand_perm`` +
    ``dist_permute``: (the matrix, the natural order's bandwidth)."""
    from combblas_tpu_torch.parallel.indexing import dist_permute
    from combblas_tpu_torch.parallel.vector import dist_rand_perm

    n = k ** 3
    r, c, v = stencil(k, 3, dev, diagonal=True)
    natural_bw = int((r - c).abs().max())
    dm0 = _grid_dist(r, c, v, n, grid)
    del r, c, v
    perm = dist_rand_perm(torch.Generator(device=dev).manual_seed(seed), n,
                          grid)[:n]
    return dist_permute(dm0, perm), natural_bw


def rcm_full(seed: int, dev, k: int = RCM_SIDE,
             side: int = DIST_SIDE) -> dict:
    """Phase 21's RCM: the 7-point stencil of a k^3 grid (diagonal
    included) on a side x side grid, relabelled at random by
    ``dist_rand_perm`` + ``dist_permute``; ``rcm_order_dist`` on the grid
    and ``rcm_order`` on its local copy, each equal to
    :func:`host_rcm` with its own parent rule, each a permutation whose
    bandwidth is at most 3 k^2, beside the natural (k^2) and relabelled
    orders' bandwidths."""
    from combblas_tpu_torch.models.ordering import rcm_order, rcm_order_dist

    n = k ** 3
    grid = ProcGrid.make(side, side, device=dev)
    dm, natural_bw = relabelled_stencil(seed, dev, k, grid)
    loc = dm.to_local()
    nnz = int(loc.nnz)
    row, col = loc.row[:nnz], loc.col[:nnz]
    _sync(dev)
    t = time.perf_counter()
    o_dist = rcm_order_dist(dm)
    dist_secs = time.perf_counter() - t
    _sync(dev)
    t = time.perf_counter()
    o_local = rcm_order(loc).cpu().numpy()
    local_secs = time.perf_counter() - t
    t = time.perf_counter()
    want = host_rcm(row.cpu().numpy().astype(np.int64),
                    col.cpu().numpy().astype(np.int64), n)
    host_secs = time.perf_counter() - t
    for name, got, rule in (("rcm_order_dist", o_dist, "min_label"),
                            ("rcm_order", o_local, "parent")):
        if not np.array_equal(np.sort(got), np.arange(n)):
            raise AssertionError(f"{name}: not a permutation")
        if not np.array_equal(got, want[rule]):
            raise AssertionError(f"{name}: differs from the host "
                                 f"Cuthill-McKee of its rule")
    bw = dict(natural=natural_bw, relabelled=bandwidth(row, col, np.arange(n)),
              rcm_order_dist=bandwidth(row, col, o_dist),
              rcm_order=bandwidth(row, col, o_local))
    limit = 3 * k * k
    if max(bw["rcm_order_dist"], bw["rcm_order"]) > limit:
        raise AssertionError(f"RCM bandwidth past 3 k^2 = {limit}: {bw}")
    out = dict(k=k, n=n, nnz=nnz, grid=[side, side],
               rcm_order_dist_secs=dist_secs, rcm_order_secs=local_secs,
               host_reference_secs=host_secs, bandwidth=bw,
               bandwidth_over_k2={key: b / (k * k) for key, b in bw.items()},
               same_order=bool(np.array_equal(o_dist, o_local)),
               positions_differing=int((o_dist != o_local).sum()))
    log(f"  RCM of the {k}^3 7-point stencil ({nnz} entries), relabelled, "
        f"{side}x{side}: rcm_order_dist {dist_secs:.2f} s, rcm_order "
        f"{local_secs:.2f} s, each equal to the host Cuthill-McKee of its "
        f"parent rule (the two orders differ at "
        f"{out['positions_differing']} positions); bandwidths {bw} (3k^2 = "
        f"{limit})")
    return out


def md_full(dev, k: int = MD_SIDE, side: int = DIST_SIDE) -> dict:
    """Phase 21's minimum degree: ``md_order_dist`` on a side x side grid
    equal to ``md_order``, on the 5-point stencil of a k^2 grid."""
    from combblas_tpu_torch.models.ordering import md_order, md_order_dist
    from combblas_tpu_torch.ops.coo import SpCOO

    n = k * k
    r, c, v = stencil(k, 2, dev, diagonal=False)
    a = SpCOO.from_arrays(r.cpu().numpy(), c.cpu().numpy(), v.cpu().numpy(),
                          (n, n), device=dev)
    dm = _grid_dist(r, c, v, n, ProcGrid.make(side, side, device=dev))
    t = time.perf_counter()
    want = md_order(a).cpu().numpy()
    local_secs = time.perf_counter() - t
    t = time.perf_counter()
    got = md_order_dist(dm).cpu().numpy()
    dist_secs = time.perf_counter() - t
    if not np.array_equal(got, want):
        raise AssertionError("md_order_dist differs from md_order")
    log(f"  minimum degree of the {k}x{k} 5-point stencil: md_order_dist "
        f"({side}x{side}) {dist_secs:.2f} s equals md_order {local_secs:.2f} "
        f"s")
    return dict(k=k, n=n, md_order_secs=local_secs,
                md_order_dist_secs=dist_secs)


def _bc_rel(a: np.ndarray, b: np.ndarray) -> float:
    """The largest |a - b| / max(|a|, |b|) (0 where both are 0)."""
    den = np.maximum(np.abs(a), np.abs(b))
    d = np.abs(a - b)
    return float(np.where(den > 0, d / np.where(den > 0, den, 1), 0).max())


def bc_full(s, seed: int, side: int = DIST_SIDE,
            refs: dict | None = None) -> dict:
    """Phase 21's betweenness centrality on phase 8's graph ``s`` from its
    first ``BC_SOURCES`` roots in batches of ``BC_BATCH``:
    ``betweenness_centrality`` (gather SpMM) and
    ``betweenness_centrality_dist`` on a side x side grid within
    ``BC_RTOL`` relative, all scores finite; seconds, BC TEPS (sources x
    undirected edges / seconds) and peak memory of each.  ``refs`` gets
    ``"bc"``: the digest of the grid's scores, which phase 26's pod must
    give again, and its seconds."""
    from combblas_tpu_torch.models.bc import (
        betweenness_centrality,
        betweenness_centrality_dist,
    )

    dev = s.device
    roots = bfs_roots(s, seed)[:BC_SOURCES]
    edges = int(s.nnz) // 2
    dm = DistSpMat.from_local(s, ProcGrid.make(side, side, device=dev))
    out = dict(n=s.shape[0], nnz=int(s.nnz), sources=len(roots),
               batch=BC_BATCH, grid=[side, side])
    scores = {}
    for name, run in (
            ("local", lambda: betweenness_centrality(s, BC_BATCH, roots)),
            ("dist", lambda: betweenness_centrality_dist(dm, BC_BATCH,
                                                         roots))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _sync(dev)
        t = time.perf_counter()
        scores[name] = run()
        secs = time.perf_counter() - t
        if not np.isfinite(scores[name]).all():
            raise AssertionError(f"betweenness_centrality ({name}): "
                                 f"scores not finite")
        out[name] = dict(secs=secs, teps=len(roots) * edges / secs,
                         peak_mem_gb=torch.cuda.max_memory_allocated()
                         / 2**30)
    out["rel_diff"] = _bc_rel(scores["dist"], scores["local"])
    if not out["rel_diff"] <= BC_RTOL:
        raise AssertionError(f"BC local vs distributed: {out['rel_diff']} "
                             f"relative")
    out["max_score"] = float(scores["local"].max())
    if refs is not None:
        refs["bc"] = dict(digest=vec_digest(torch.from_numpy(
            scores["dist"])), secs=out["dist"]["secs"])
    log(f"  BC from {len(roots)} roots, batches of {BC_BATCH}: local "
        f"{out['local']['secs']:.3f} s ({out['local']['teps'] / 1e9:.3f} "
        f"GTEPS, peak {out['local']['peak_mem_gb']:.2f} GiB), "
        f"{side}x{side} {out['dist']['secs']:.3f} s "
        f"({out['dist']['teps'] / 1e9:.3f} GTEPS, peak "
        f"{out['dist']['peak_mem_gb']:.2f} GiB); equal within "
        f"{out['rel_diff']:.3g} relative")
    return out


def bc_card_vs_cpu(seed: int, dev, scale: int = BC_CHECK_SCALE) -> dict:
    """``betweenness_centrality`` of the scale-``scale`` symmetrized G500
    graph (built on the CPU, copied to the card) from its first
    ``BC_SOURCES`` roots, on the card and on the CPU: within
    ``BC_CHECK_RTOL`` relative."""
    from combblas_tpu_torch.models.bc import betweenness_centrality
    from combblas_tpu_torch.ops.coo import SpCOO

    cpu = torch.device("cpu")
    s = spmm_bfs_graphs(seed, cpu, scale)["s"]
    roots = bfs_roots(s, seed)[:BC_SOURCES]
    sc = SpCOO.from_numpy(*s.to_numpy(), device=dev)
    got = betweenness_centrality(sc, BC_BATCH, roots)
    want = betweenness_centrality(s, BC_BATCH, roots)
    rel = _bc_rel(got, want)
    if not rel <= BC_CHECK_RTOL:
        raise AssertionError(f"BC card vs CPU: {rel} relative")
    log(f"  BC card vs CPU, scale {scale}: within {rel:.3g} relative")
    return dict(scale=scale, rel_diff=rel)


# ---------------------------------------------------------- phases 22-24 --

#: Phase 22's matchings: a G500 R-MAT of this scale (ef 16), not
#: symmetrized, rows and columns the two vertex classes.
MATCH_SCALE = 20
#: Phase 22's weight check: ``awpm(complete=False)`` against
#: ``linear_sum_assignment`` on the dense matrix of this scale.
MATCH_WEIGHT_SCALE = 12
#: Phase 23's local MIS-2 / ``restriction_op`` / ``galerkin`` stencil side:
#: R's attachment is a host loop over the stored edges (three sweeps, as
#: JAX's), about a second a sweep at 48^3 (0.77M entries), and R·A·Rᵀ of
#: this size still has packed keys (K1/K2), which the 128^3 products,
#: with coarse x fine key spaces past 2^31, do not (K3/K4).
MG_LOCAL_SIDE = 48
#: Phase 23's grid for R·A·Rᵀ at 128^3 on packed keys: 16 x 16 blocks of
#: R (188,715 x 2^21 at seed 42) span 11,808 x 131,072 < 2^31 keys, so
#: both products take K1/K2 (on 4x4 and on one block they go wide).
MG_PACKED_SIDE = 16
#: Phase 24: the time window of the semantic graph (latest in [begin,
#: end] of 1000 buckets, retweet count > 0 in 5 of 6 edges: about a
#: quarter of the edges pass), the I/O matrix's scale, and the scale of the
#: CLI's ``mcl`` graph.
TWITTER_WINDOW = (200, 499)
IO_SCALE = 18
CLI_MCL_SCALE = 12


class Calls:
    """Count the calls of module functions (``(module, name)`` pairs) while
    active, keeping each one's last result; the modules' own calls go
    through the patched names."""

    def __init__(self, *targets):
        self.targets = targets
        self.counts = {}
        self.last = {}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.counts[name] = 0
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.counts[_name] += 1
                self.last[_name] = _fn(*a, **k)
                return self.last[_name]

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _timed(fn, dev):
    """(result, seconds) of ``fn()``, the card idle before and after."""
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t


def _host_keys(row, col, n: int) -> np.ndarray:
    """Sorted int64 keys row * n + col of host (or card) coordinates."""
    if isinstance(row, torch.Tensor):
        row, col = row.cpu().numpy(), col.cpu().numpy()
    return np.sort(row.astype(np.int64) * n + col.astype(np.int64))


def _has_keys(keys: np.ndarray, want: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(keys, want).clip(max=max(len(keys) - 1, 0))
    return (keys[pos] == want) if len(keys) else np.zeros(len(want), bool)


def check_matching(keys, row, col, n: int, mr, mc, maximal: bool) -> int:
    """Host check of a matching of the (m, n) edge list ``keys`` (sorted
    row * n + col): mates consistent both ways, every matched pair an edge;
    ``maximal``: no edge has both ends free.  Returns the cardinality."""
    mr = mr.cpu().numpy().astype(np.int64)
    mc = mc.cpu().numpy().astype(np.int64)
    r = np.nonzero(mr >= 0)[0]
    c = np.nonzero(mc >= 0)[0]
    if not ((mc[mr[r]] == r).all() and (mr[mc[c]] == c).all()):
        raise AssertionError("mates are not consistent")
    if not _has_keys(keys, r * n + mr[r]).all():
        raise AssertionError("a matched pair is not an edge")
    if maximal and ((mr[row] < 0) & (mc[col] < 0)).any():
        raise AssertionError("an edge has both ends free: not maximal")
    return int(r.size)


def weighted_rmat(seed: int, dev, scale: int):
    """Phase 22's bipartite graph: a G500 ef-16 R-MAT with seeded uniform
    weights in (0, 1] on its entries."""
    from combblas_tpu_torch.ops.coo import SpCOO

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = rmat_matrix(gen, scale, EDGEFACTOR)
    k = int(a.nnz)
    val = torch.zeros_like(a.val)
    val[:k] = 1.0 - torch.rand(k, generator=gen, device=dev)
    return SpCOO(row=a.row, col=a.col, val=val, nnz=a.nnz, shape=a.shape)


def matching_full(seed: int, dev, scale: int = MATCH_SCALE,
                  side: int = DIST_SIDE,
                  weight_scale: int = MATCH_WEIGHT_SCALE) -> dict:
    """Phase 22: ``bp_maximal_matching``, ``bp_maximum_matching`` and
    ``awpm`` of the weighted G500 R-MAT, then ``dist_bp_maximal``,
    ``dist_bp_maximum`` and ``dist_awpm`` on a side x side grid: each
    checked on the host against the edge list (mates consistent, matched
    pairs edges, the maximal ones maximal), the maximum cardinalities
    (and AWPM's completed one) equal to scipy's, each grid result equal to
    the local one mate for mate (as the CPU tests show JAX's are); then
    ``awpm(complete=False)`` at ``weight_scale`` with at least half the
    weight of ``linear_sum_assignment(maximize=True)``."""
    from scipy.optimize import linear_sum_assignment
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    from combblas_tpu_torch.models import matching as mm
    from combblas_tpu_torch.parallel import matching as pm

    a = weighted_rmat(seed, dev, scale)
    m, n = a.shape
    k = int(a.nnz)
    row = a.row[:k].cpu().numpy().astype(np.int64)
    col = a.col[:k].cpu().numpy().astype(np.int64)
    keys = row * n + col            # a's entries are (row, col) sorted
    t = time.perf_counter()
    want = int((maximum_bipartite_matching(csr_matrix(
        (np.ones(k, np.int8), (row, col)), shape=(m, n)),
        perm_type="column") >= 0).sum())
    scipy_secs = time.perf_counter() - t
    out = dict(scale=scale, m=m, n=n, nnz=k, scipy_maximum=want,
               scipy_secs=scipy_secs)
    local = {}
    targets = ((mm, "_propose_accept"), (mm, "_dominant_round"),
               (mm, "_alt_bfs"), (mm, "_alt_level"))
    for name, fn, maximal in (
            ("bp_maximal_matching", mm.bp_maximal_matching, True),
            ("bp_maximum_matching", mm.bp_maximum_matching, False),
            ("awpm", mm.awpm, False)):
        with Calls(*targets) as calls:
            (mr, mc), secs = _timed(lambda: fn(a), dev)
        card = check_matching(keys, row, col, n, mr, mc, maximal)
        if name != "bp_maximal_matching" and card != want:
            raise AssertionError(f"{name}: cardinality {card}, scipy {want}")
        local[name] = (mr, mc)
        out[name] = dict(secs=secs, cardinality=card,
                         rounds=calls.counts["_propose_accept"]
                         + calls.counts["_dominant_round"],
                         phases=calls.counts["_alt_bfs"],
                         levels=calls.counts["_alt_level"])
        log(f"  {name}: {card} matched in {secs:.3f} s, {out[name]}")
    dm = DistSpMat.from_local(a, ProcGrid.make(side, side, device=dev))
    targets = ((pm, "_propose_accept_round"), (pm, "_dist_dominant"),
               (pm, "_dist_alt_bfs"), (pm, "_dist_alt_level"))
    for name, fn, ref in (("dist_bp_maximal", pm.dist_bp_maximal,
                           "bp_maximal_matching"),
                          ("dist_bp_maximum", pm.dist_bp_maximum,
                           "bp_maximum_matching"),
                          ("dist_awpm", pm.dist_awpm, "awpm")):
        with Calls(*targets) as calls:
            (mr, mc), secs = _timed(lambda: fn(dm), dev)
        mr, mc = mr[:m], mc[:n]
        if not (torch.equal(mr, local[ref][0])
                and torch.equal(mc, local[ref][1])):
            raise AssertionError(f"{name} differs from {ref}")
        out[name] = dict(secs=secs, grid=[side, side],
                         cardinality=out[ref]["cardinality"],
                         rounds=calls.counts["_propose_accept_round"]
                         + calls.counts["_dist_dominant"],
                         phases=calls.counts["_dist_alt_bfs"],
                         levels=calls.counts["_dist_alt_level"])
        log(f"  {name} {side}x{side}: equal to {ref}, {secs:.3f} s, "
            f"{out[name]}")
    del dm, a, local
    # the weight of the 1/2-approximation against the optimum
    a = weighted_rmat(seed + 1, dev, weight_scale)
    m = a.shape[0]
    k = int(a.nnz)
    r, c, v = (x[:k].cpu().numpy() for x in (a.row, a.col, a.val))
    dense = np.zeros(a.shape, np.float32)
    dense[r, c] = v
    mr, _ = mm.awpm(a, complete=False)
    mr = mr.cpu().numpy()
    got = float(dense[np.nonzero(mr >= 0)[0], mr[mr >= 0]].sum())
    ri, ci = linear_sum_assignment(dense, maximize=True)
    best = float(dense[ri, ci].sum())
    if not got >= 0.5 * best:
        raise AssertionError(f"awpm weight {got} below half of {best}")
    out["awpm_weight"] = dict(scale=weight_scale, awpm=got, optimum=best,
                              ratio=got / best)
    log(f"  awpm(complete=False) at scale {weight_scale}: weight {got:.2f}, "
        f"{got / best:.4f} of linear_sum_assignment's {best:.2f}")
    return out


def mg_stencil(k: int, dev):
    """The 7-point stencil of a k^3 grid with integer weights, 6 on the
    diagonal and -1 off it (every product and sum of R·A·Rᵀ exact in
    float32): global COO tensors on ``dev``."""
    r, c, _ = stencil(k, 3, dev, diagonal=True)
    return r, c, torch.where(r == c, 6.0, -1.0)


def _host_csr(r, c, v, n: int):
    from scipy.sparse import csr_matrix

    m = csr_matrix((v.cpu().numpy(), (r.cpu().numpy(), c.cpu().numpy())),
                   shape=(n, n))
    m.sort_indices()
    return m


def check_mis2_host(pattern, in_set: np.ndarray) -> None:
    """MIS-2 on the host from the patterns of A (no diagonal) and A²: no
    two set vertices within two hops, every vertex within two hops of the
    set (or in it)."""
    near = ((pattern + pattern @ pattern) != 0).tocsr()
    s = np.nonzero(in_set)[0]
    sub = near[s][:, s].tocsr()
    sub.setdiag(0)
    sub.eliminate_zeros()
    if sub.nnz:
        raise AssertionError(f"MIS-2: {sub.nnz} set pairs within two hops")
    if not (in_set | (near[:, s].getnnz(axis=1) > 0)).all():
        raise AssertionError("MIS-2: a vertex is farther than two hops")
    return near


def _coarse_vertices(in_set: np.ndarray, agg: np.ndarray) -> np.ndarray:
    """R's coarse vertex of every aggregate: the MIS-2 vertices in order,
    then the vertices that became coarse themselves (each alone in an
    aggregate past them), checked to map to their own aggregates."""
    s = np.nonzero(in_set)[0]
    left = np.nonzero(agg >= s.size)[0]
    cv = np.concatenate([s, left])
    if not np.array_equal(agg[cv], np.arange(cv.size)):
        raise AssertionError("a coarse vertex is not in its own aggregate")
    return cv


def check_r_host(rows, cols, n: int, in_set, near_keys=None,
                 pattern=None) -> dict:
    """R on the host: one entry a column (each fine vertex in one
    aggregate), every coarse vertex in its own, and each fine vertex
    within two hops of its coarse vertex (``near_keys``: sorted keys of the
    pattern of A + A²), or, for the local rule, every aggregate a connected
    piece of ``pattern`` around its coarse vertex."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if not np.array_equal(np.bincount(cols, minlength=n), np.ones(n)):
        raise AssertionError("R: a column without exactly one entry")
    agg = np.empty(n, np.int64)
    agg[cols] = rows
    cv = _coarse_vertices(in_set, agg)
    far = 0
    if near_keys is not None:
        fine = np.arange(n)
        tgt = cv[agg]
        ok = (tgt == fine) | _has_keys(near_keys, fine * n + tgt)
        far = int((~ok).sum())
        if far:
            raise AssertionError(f"R: {far} vertices past two hops")
    if pattern is not None:
        p = pattern.tocoo()
        same = agg[p.row] == agg[p.col]
        inner = coo_matrix((np.ones(int(same.sum())), (p.row[same],
                                                       p.col[same])),
                           shape=(n, n))
        ncomp, lab = connected_components(inner, directed=False)
        if ncomp != cv.size or np.unique(lab[cv]).size != cv.size:
            raise AssertionError("R: an aggregate is not connected")
    return dict(ncoarse=int(cv.size), mis2=int(in_set.sum()),
                self_coarse=int(cv.size - in_set.sum()))


def _same_as_scipy(c, ref, label: str) -> None:
    """A SpCOO (or DistSpMat) equal to the scipy matrix ``ref`` exactly:
    the same nonzeros (scipy drops the sums that cancel to 0, the port
    keeps them as stored zeros)."""
    if isinstance(c, DistSpMat):
        c = c.to_local()
    k = int(c.nnz)
    val = c.val[:k].cpu().numpy()
    nz = val != 0
    ncols = ref.shape[1]
    got = (c.row[:k].cpu().numpy().astype(np.int64) * ncols
           + c.col[:k].cpu().numpy())[nz]
    ref = ref.tocoo()
    ref.eliminate_zeros()
    order = np.lexsort((ref.col, ref.row))
    want = ref.row[order].astype(np.int64) * ncols + ref.col[order]
    if not (np.array_equal(got, want) and np.array_equal(
            val[nz], ref.data[order].astype(np.float32))):
        raise AssertionError(f"{label}: R·A·Rᵀ differs from scipy's")


def _galerkin_launches(label: str, run, dev):
    """(result, seconds, launches) of one Galerkin product, the expansion
    and compress kernels' launches read around it (at least one of one
    pair, each expansion with its compress)."""
    reset_launches()
    c, secs = _timed(run, dev)
    launches = {k: v for k, v in LAUNCHES.items() if v}
    _expand_compress_launches(launches, label)
    return c, secs, launches


def _r_scipy(rows, cols, shape):
    from scipy.sparse import csr_matrix

    return csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=shape)


def multigrid_full(seed: int, dev, k: int = RCM_SIDE, side: int = DIST_SIDE,
                   local_k: int = MG_LOCAL_SIDE,
                   packed_side: int = MG_PACKED_SIDE,
                   refs: dict | None = None) -> dict:
    """Phase 23: the k^3 7-point stencil (6 / -1) on a side x side grid:
    ``mis2_dist`` (``mis2_verify_dist`` on the 0/1 pattern, and a host
    check on the patterns of A and A²), ``restriction_op_dist`` (R checked
    on the host), ``galerkin_dist(R, A)`` and ``galerkin`` of R and A on
    one block, both equal to scipy's R·A·Rᵀ exactly, the expansion and
    compress kernels' launches read around each (both wide, K3/K4), and
    ``galerkin_dist`` on a ``packed_side`` grid, whose blocks' keys pack
    (K1/K2, at least one launch each); then at ``local_k``^3
    local ``mis2`` + ``restriction_op`` (host checks, R card against CPU
    exactly with one CPU generator) and ``galerkin`` (K1/K2) against
    scipy.  ``refs`` gets ``"mg"``: the set's digest, the block digests of
    R and of both grids' R·A·Rᵀ, and the seconds, which phase 26's pod
    must give again."""
    from combblas_tpu_torch.models import multigrid as mg
    from combblas_tpu_torch.ops.coo import SpCOO

    n = k ** 3
    grid = ProcGrid.make(side, side, device=dev)
    r, c, v = mg_stencil(k, dev)
    dm = _grid_dist(r, c, v, n, grid)
    off = r != c
    pat = _grid_dist(r[off], c[off], torch.ones_like(v[off]), n, grid)
    a_host = _host_csr(r, c, v, n)
    p_host = _host_csr(r[off], c[off], torch.ones_like(v[off]), n)
    del r, c, v, off
    out = dict(k=k, n=n, nnz=a_host.nnz, grid=[side, side])
    gen = torch.Generator(device=dev).manual_seed(seed)
    with Calls((mg, "_priorities")) as calls:
        in_set, secs = _timed(lambda: mg.mis2_dist(dm, gen), dev)
    if not mg.mis2_verify_dist(pat, in_set):
        raise AssertionError("mis2_verify_dist fails")
    t = time.perf_counter()
    near = check_mis2_host(p_host, in_set)
    near_keys = _host_keys(*near.nonzero(), n)
    out["mis2_dist"] = dict(secs=secs, rounds=calls.counts["_priorities"],
                            size=int(in_set.sum()),
                            host_check_secs=time.perf_counter() - t)
    log(f"  mis2_dist: {out['mis2_dist']}")
    del pat
    with Calls((mg, "mis2_dist")) as calls:
        R, secs = _timed(lambda: mg.restriction_op_dist(
            dm, torch.Generator(device=dev).manual_seed(seed + 1)), dev)
    r_set = calls.last["mis2_dist"]
    rl = R.to_local()
    nr = int(rl.nnz)
    rows = rl.row[:nr].cpu().numpy().astype(np.int64)
    cols = rl.col[:nr].cpu().numpy().astype(np.int64)
    out["restriction_op_dist"] = dict(secs=secs, shape=list(R.gshape),
                                      **check_r_host(rows, cols, n, r_set,
                                                     near_keys=near_keys))
    log(f"  restriction_op_dist: {out['restriction_op_dist']}")
    del near, near_keys
    r_s = _r_scipy(rows, cols, R.gshape)
    ref = (r_s @ a_host @ r_s.T).tocsr()
    cd, secs, launches = _galerkin_launches(
        "galerkin_dist", lambda: mg.galerkin_dist(R, dm), dev)
    _same_as_scipy(cd, ref, "galerkin_dist")
    out["galerkin_dist"] = dict(secs=secs, nnz=int(cd.total_nnz()),
                                launches=launches)
    log(f"  galerkin_dist {side}x{side}: equal to scipy, {out['galerkin_dist']}")
    if refs is not None:
        refs["mg"] = dict(
            mis2=vec_digest(torch.from_numpy(in_set)),
            r=block_digests(R), galerkin=block_digests(cd),
            secs=dict(mis2_dist=out["mis2_dist"]["secs"],
                      restriction_op_dist=out["restriction_op_dist"]["secs"],
                      galerkin_dist=secs))
    del cd
    # a grid whose blocks' coarse x fine keys pack into int32: K1/K2
    gp = ProcGrid.make(packed_side, packed_side, device=dev)
    r, c, v = mg_stencil(k, dev)
    dmp = _grid_dist(r, c, v, n, gp)
    del r, c, v
    rp = DistSpMat.from_coo_arrays(rows, cols, np.ones(nr, np.float32),
                                   R.gshape, gp)
    cp, secs, launches_p = _galerkin_launches(
        f"galerkin_dist {packed_side}x{packed_side}",
        lambda: mg.galerkin_dist(rp, dmp), dev)
    _k1k2_each_iteration(launches_p, 1, f"galerkin_dist {packed_side}x"
                         f"{packed_side} at {k}^3")
    _same_as_scipy(cp, ref, f"galerkin_dist {packed_side}x{packed_side}")
    if refs is not None:
        refs["mg"]["packed"] = block_digests(cp)
        refs["mg"]["secs"]["galerkin_dist_packed"] = secs
    out["galerkin_dist_packed"] = dict(secs=secs, grid=[packed_side] * 2,
                                       nnz=int(cp.total_nnz()),
                                       launches=launches_p)
    log(f"  galerkin_dist {packed_side}x{packed_side}: equal to scipy, "
        f"{out['galerkin_dist_packed']}")
    del cp, dmp, rp
    a_loc = dm.to_local()
    cl, secs, launches_l = _galerkin_launches(
        "galerkin", lambda: mg.galerkin(rl, a_loc), dev)
    _same_as_scipy(cl, ref, "galerkin")
    out["galerkin"] = dict(secs=secs, nnz=int(cl.nnz), launches=launches_l)
    log(f"  galerkin (one block): equal to scipy, {out['galerkin']}")
    del cl, a_loc, rl, R, dm, ref
    # local MIS-2 + restriction_op (host loop), card against CPU
    n = local_k ** 3
    r, c, v = mg_stencil(local_k, dev)
    host = [x.cpu().numpy() for x in (r, c, v)]
    a_host = _host_csr(r, c, v, n)
    p_host = _host_csr(r[r != c], c[r != c], v[r != c], n)
    del r, c, v
    runs = {}
    for where in (dev, torch.device("cpu")):
        a = SpCOO.from_arrays(*host, (n, n), device=where)
        with Calls((mg, "_priorities"), (mg, "mis2")) as calls:
            R, secs = _timed(lambda: mg.restriction_op(
                a, torch.Generator().manual_seed(seed + 2)), where)
        runs[where.type] = (R, calls.last["mis2"].cpu().numpy(), secs,
                            calls.counts["_priorities"], a)
    R, s_card, secs, rounds, a = runs[dev.type]
    R_cpu, s_cpu, cpu_secs, _, _ = runs["cpu"]
    if not (np.array_equal(s_card, s_cpu) and all(
            torch.equal(getattr(R, f).cpu(), getattr(R_cpu, f))
            for f in ("row", "col", "val", "nnz"))):
        raise AssertionError("restriction_op: card and CPU differ")
    check_mis2_host(p_host, s_card)
    nr = int(R.nnz)
    rows = R.row[:nr].cpu().numpy().astype(np.int64)
    cols = R.col[:nr].cpu().numpy().astype(np.int64)
    line = dict(k=local_k, n=n, secs=secs, cpu_secs=cpu_secs,
                mis2_rounds=rounds, shape=list(R.shape),
                **check_r_host(rows, cols, n, s_card, pattern=p_host))
    r_s = _r_scipy(rows, cols, R.shape)
    cs, gsecs, launches_s = _galerkin_launches(
        "galerkin (local)", lambda: mg.galerkin(R, a), dev)
    _same_as_scipy(cs, (r_s @ a_host @ r_s.T).tocsr(), "galerkin (local)")
    _k1k2_each_iteration(launches_s, 1, f"galerkin at {local_k}^3")
    line.update(galerkin_secs=gsecs, galerkin_nnz=int(cs.nnz),
                launches=launches_s)
    out["local"] = line
    log(f"  restriction_op {local_k}^3: card = CPU, {line}")
    total = {}
    for part in (out["galerkin_dist"], out["galerkin_dist_packed"],
                 out["galerkin"], line):
        for name, cnt in part["launches"].items():
            total[name] = total.get(name, 0) + cnt
    out["launches"] = total
    return out


def _twitter_codes(s, seed: int):
    """Seeded attributes of the symmetric graph ``s``, one draw an
    undirected edge (both of its entries get it): follower, retweet count
    in [0, 5], latest time bucket in [0, 1000); packed on the host.
    Returns the packed codes of ``s``'s live entries (host float32)."""
    from combblas_tpu_torch.models.semantic import pack_twitter

    n = s.shape[0]
    k = int(s.nnz)
    dev = s.device
    r, c = s.row[:k].long(), s.col[:k].long()
    order = torch.argsort(torch.minimum(r, c) * n + torch.maximum(r, c),
                          stable=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = k // 2
    pair = torch.empty(k, dtype=torch.int64, device=dev)
    pair[order] = torch.arange(k, device=dev) // 2
    fol = torch.rand(half, generator=gen, device=dev) < 0.5
    cnt = torch.randint(0, 6, (half,), generator=gen, device=dev)
    lat = torch.randint(0, 1000, (half,), generator=gen, device=dev)
    return pack_twitter(fol[pair].cpu().numpy(), cnt[pair].cpu().numpy(),
                        lat[pair].cpu().numpy())


def _host_window(codes: np.ndarray, begin: int, end: int) -> np.ndarray:
    """The time-window filter decoded on the host."""
    x = codes.astype(np.int64) - 1
    cnt, lat = (x >> 1) % 128, x // 256
    return (cnt > 0) & (lat >= begin) & (lat <= end)


def _same_entries_host(a, r, c, v, label: str) -> None:
    if isinstance(a, DistSpMat):
        a = a.to_local()
    k = int(a.nnz)
    if not (k == len(r) and np.array_equal(a.row[:k].cpu().numpy(), r)
            and np.array_equal(a.col[:k].cpu().numpy(), c)
            and np.array_equal(a.val[:k].cpu().numpy(), v)):
        raise AssertionError(f"{label} differs from the host filter")


def _run_cli(argv, dev) -> str:
    """``cli.main(argv)`` in process; its printed line(s)."""
    import contextlib
    import io

    from combblas_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv, device=dev)
    return buf.getvalue().strip()


def _untimed(line: str) -> str:
    import re

    return re.sub(r"[ ,]*(in )?\d+\.\d+s$", "", line)


def cli_full(seed: int, dev) -> dict:
    """Phase 24's CLI: each command line run in process on files under
    ``chiprun_out/cli``, each printed line held against the library call it
    wraps (and scipy where it counts)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import (
        connected_components,
        maximum_bipartite_matching,
    )

    from combblas_tpu_torch.io.binary import read_binary
    from combblas_tpu_torch.io.mtx import read_mtx, write_mtx
    from combblas_tpu_torch.models.bfs import bfs_dist
    from combblas_tpu_torch.models.mcl import MCLParams, mcl_local
    from combblas_tpu_torch.models.multigrid import galerkin, restriction_op
    from combblas_tpu_torch.ops.coo import SpCOO, merge

    d = os.path.join("chiprun_out", "cli")
    os.makedirs(d, exist_ok=True)
    g18, m18 = os.path.join(d, "g18.bin"), os.path.join(d, "g18.mtx")
    out, secs = {}, {}

    def run(name, argv):
        t = time.perf_counter()
        line = _run_cli(argv, dev)
        secs[name] = time.perf_counter() - t
        out[name] = line
        log(f"  cli {' '.join(argv)}: {line}")
        return _untimed(line)

    line = run("gen", ["gen", "--scale", str(IO_SCALE), "--seed", str(seed),
                       "-o", g18])
    a = read_binary(g18, device=dev)
    lib = rmat_matrix(torch.Generator(device=dev).manual_seed(seed),
                      IO_SCALE, 16)
    k = int(lib.nnz)
    if line != f"gen: rmat scale {IO_SCALE}, nnz {k}" or int(a.nnz) != k \
            or not all(torch.equal(getattr(a, f)[:k], getattr(lib, f)[:k])
                       for f in ("row", "col", "val")):
        raise AssertionError(f"gen: {line}")
    del lib
    run("convert", ["convert", g18, "-o", m18])
    b = read_mtx(m18, device=dev)
    if not all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("row", "col", "val", "nnz")):
        raise AssertionError("convert: the .mtx differs from the .bin")
    del b
    line = run("spgemm", ["spgemm", g18])
    want = f"spgemm: C {a.shape} nnz {int(spgemm_auto(a, a).nnz)}"
    if line != want:
        raise AssertionError(f"spgemm: {line} vs {want}")
    k = int(a.nnz)
    row, col = (x[:k].cpu().numpy() for x in (a.row, a.col))
    host = csr_matrix((np.ones(k, np.int8), (row, col)), shape=a.shape)
    line = run("match", ["match", g18, "--max"])
    card = int((maximum_bipartite_matching(host, perm_type="column")
                >= 0).sum())
    if line != f"match[maximum]: cardinality {card}":
        raise AssertionError(f"match: {line}, scipy {card}")
    s = merge(a, a.transpose())
    root = int(bfs_roots(s, seed, 1)[0])
    line = run("bfs", ["bfs", g18, "--dist", "--symmetrize", "--root",
                       str(root)])
    _, lv = bfs_dist(DistSpMat.from_local(s, default_grid(device=dev)), root)
    lv = lv[: s.shape[0]]
    want = (f"bfs: visited {int((lv >= 0).sum())} vertices, max level "
            f"{int(lv.max())}")
    if line != want:
        raise AssertionError(f"bfs: {line} vs {want}")
    del s
    line = run("cc", ["cc", g18])
    ncomp = connected_components(host, directed=False)[0]
    if line != f"cc[fastsv]: {ncomp} components":
        raise AssertionError(f"cc: {line}, scipy {ncomp}")
    del a, host
    # galerkin on a stencil, mcl on a scale-12 graph
    st = os.path.join(d, "stencil.mtx")
    ks = 24
    r, c, v = mg_stencil(ks, dev)
    sten = SpCOO.from_arrays(*(x.cpu().numpy() for x in (r, c, v)),
                             (ks ** 3, ks ** 3), device=dev)
    write_mtx(st, sten)
    line = run("galerkin", ["galerkin", st, "--seed", str(seed)])
    rr = restriction_op(sten, torch.Generator(device=dev).manual_seed(seed))
    cc = galerkin(rr, sten)
    want = f"galerkin: coarse {cc.shape} nnz {int(cc.nnz)} (R {rr.shape})"
    if line != want:
        raise AssertionError(f"galerkin: {line} vs {want}")
    g12 = os.path.join(d, "g12.bin")
    run("gen12", ["gen", "--scale", str(CLI_MCL_SCALE), "--seed",
                  str(seed), "--symmetrize", "-o", g12])
    line = run("mcl", ["mcl", g12, "--select", "64"])
    labels, iters = mcl_local(read_binary(g12, device=dev),
                              MCLParams(select=64))
    want = (f"mcl: {len(np.unique(labels.cpu().numpy()))} clusters in "
            f"{iters} iterations")
    if line != want:
        raise AssertionError(f"mcl: {line} vs {want}")
    shutil.rmtree(d)     # chiprun_out/ stays small enough to come back
    return dict(lines=out, secs=secs)


def semantic_io_cli_full(s, roots, seed: int, side: int = DIST_SIDE,
                         refs: dict | None = None) -> dict:
    """Phase 24: a ``TwitterGraph`` over phase 8's graph with seeded
    symmetric attributes and a time window passing about a quarter of the
    edges: ``subgraph_within`` and ``materialize_filtered_dist`` equal to
    the host filter; ``bfs_within`` and ``bfs_within_dist`` (side x side)
    from ``roots``, levels equal to each other and to a host BFS of the
    filtered graph, parents validated on it; ``mis_filtered_dist``
    independent and maximal on the filtered edges.  Then the block-
    streamed I/O of a side x side scale-``IO_SCALE`` matrix read back,
    and the CLI (:func:`cli_full`).  ``refs`` gets ``"filtered"``: the
    digests of the materialized blocks, of the 4 processes' slices of each
    BFS's parents and levels and of the MIS, and the seconds, which phase
    26's pod must give again."""
    from combblas_tpu_torch.io.binary import read_binary
    from combblas_tpu_torch.io.parallel import (
        parallel_read_mtx,
        parallel_write_binary,
        parallel_write_mtx,
    )
    from combblas_tpu_torch.models.filtered import (
        materialize_filtered_dist,
        mis_filtered_dist,
    )
    from combblas_tpu_torch.models.semantic import (
        TwitterGraph,
        tweet_within_interval,
    )
    from combblas_tpu_torch.ops.coo import SpCOO

    dev = s.device
    n = s.shape[0]
    k = int(s.nnz)
    begin, end = TWITTER_WINDOW
    codes = _twitter_codes(s, seed)
    val = torch.zeros(s.capacity, dtype=torch.float32, device=dev)
    val[:k] = torch.from_numpy(codes).to(dev)
    tg = TwitterGraph(SpCOO(row=s.row, col=s.col, val=val, nnz=s.nnz,
                            shape=s.shape))
    keep = _host_window(codes, begin, end)
    hr = s.row[:k].cpu().numpy()[keep]
    hc = s.col[:k].cpu().numpy()[keep]
    out = dict(n=n, nnz=k, window=[begin, end], passing=int(keep.sum()),
               passing_share=float(keep.mean()))
    sub, secs = _timed(lambda: tg.subgraph_within(begin, end), dev)
    _same_entries_host(sub, hr, hc, codes[keep], "subgraph_within")
    out["subgraph_secs"] = secs
    dm, secs = _timed(lambda: tg.distribute(ProcGrid.make(side, side,
                                                          device=dev)), dev)
    out["distribute_secs"] = secs
    pred = tweet_within_interval(begin, end)
    dsub, secs = _timed(lambda: materialize_filtered_dist(dm, pred), dev)
    _same_entries_host(dsub, hr, hc, codes[keep], "materialize_filtered_dist")
    out["materialize_dist_secs"] = secs
    nproc = POD_SCENARIOS["algos"]
    fref = dict(mat=block_digests(dsub), bfs=[], secs=dict(materialize=secs))
    del dsub
    indptr = np.searchsorted(hr, np.arange(n + 1))
    out["bfs"] = []
    for root in roots:
        root = int(root)
        (p1, l1), t1 = _timed(lambda: tg.bfs_within(root, begin, end), dev)
        (p2, l2), t2 = _timed(lambda: tg.bfs_within_dist(dm, root, begin,
                                                          end), dev)
        fref["bfs"].append(dict(root=root, secs=t2,
                                parents=slice_digests(p2, nproc),
                                levels=slice_digests(l2, nproc)))
        p2, l2 = p2[:n], l2[:n]
        want = _host_levels(indptr, hc, root, n)
        if not (torch.equal(l1, l2) and np.array_equal(
                l1.cpu().numpy(), want)):
            raise AssertionError(f"filtered BFS from {root}: levels differ")
        for p, lv in ((p1, l1), (p2, l2)):
            if not validate_bfs(sub, root, p, lv):
                raise AssertionError(f"filtered BFS from {root} does not "
                                     f"validate")
        out["bfs"].append(dict(root=root, local_secs=t1, dist_secs=t2,
                               visited=int((l1 >= 0).sum()),
                               levels=int(l1.max())))
    log(f"  filtered BFS from {len(roots)} roots: levels equal local, "
        f"{side}x{side} and host, parents validate: {out['bfs']}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    in_set, secs = _timed(lambda: mis_filtered_dist(dm, gen, pred), dev)
    fref["mis"] = slice_digests(in_set, nproc)
    fref["secs"]["mis"] = secs
    if refs is not None:
        refs["filtered"] = fref
    in_set = in_set[:n].cpu().numpy()
    hit = np.zeros(n, bool)
    hit[hr[in_set[hc]]] = True
    if (in_set[hr] & in_set[hc]).any() or not (in_set | hit).all():
        raise AssertionError("mis_filtered_dist: not a maximal independent "
                             "set of the filtered edges")
    out["mis_filtered_dist"] = dict(secs=secs, size=int(in_set.sum()))
    log(f"  subgraph_within / materialize_filtered_dist equal the host "
        f"filter ({out['passing']} of {k} entries); mis_filtered_dist "
        f"{out['mis_filtered_dist']}")
    del dm, sub, tg, val
    torch.cuda.empty_cache()
    # block-streamed I/O of a side x side matrix
    d = os.path.join("chiprun_out", "io")
    os.makedirs(d, exist_ok=True)
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(seed), IO_SCALE,
                    16)
    grid = ProcGrid.make(side, side, device=dev)
    dm = DistSpMat.from_local(a, grid)
    pm, pb = os.path.join(d, "a.mtx"), os.path.join(d, "a.bin")
    io_secs = {}
    for name, fn in (
            ("parallel_write_mtx", lambda: parallel_write_mtx(pm, dm)),
            ("parallel_write_binary", lambda: parallel_write_binary(pb, dm)),
            ("parallel_read_mtx", lambda: parallel_read_mtx(pm, grid)),
            ("read_binary", lambda: read_binary(pb, device=dev))):
        io_secs[name] = _timed(fn, dev)
    back, bin_back = io_secs["parallel_read_mtx"][0], io_secs[
        "read_binary"][0]
    if not all(torch.equal(getattr(back, f), getattr(dm, f))
               for f in ("row", "col", "val", "nnz")):
        raise AssertionError("parallel_read_mtx: stacks differ")
    loc = dm.to_local()
    kk = int(loc.nnz)
    _same_entries_host(bin_back, *(x[:kk].cpu().numpy()
                                   for x in (loc.row, loc.col, loc.val)),
                       "read_binary")
    out["io"] = dict(scale=IO_SCALE, nnz=kk, bytes_mtx=os.path.getsize(pm),
                     bytes_bin=os.path.getsize(pb),
                     secs={k_: v for k_, (_, v) in io_secs.items()})
    shutil.rmtree(d)     # chiprun_out/ stays small enough to come back
    log(f"  I/O {side}x{side} scale {IO_SCALE}: stacks and entries read "
        f"back equal, {out['io']}")
    del a, dm, back, bin_back, loc
    out["cli"] = cli_full(seed, dev)
    return out


# ---------------------------------------------------------------- phase 26 --

#: The processes of phase 26's pods on the one card, and each pod's
#: timeout (on expiry every worker is killed).  ``"mcl"`` is a launch of
#: its own, so that its workers' peak memory is its own.
POD_SCENARIOS = {"two": 2, "four": 4, "mcl": 4, "algos": 4}
POD_TIMEOUT_SECS = 420
#: Phase 26's sample sort: phase 19's length.
POD_SORT_LOG2 = 26
#: Phase 26's ``"algos"`` launch: the dense SpMM's width (and its two
#: semirings), the dense matrices' graph scale, and the sizes of the
#: host-paced cases, cut below their one-process phases' (every level or
#: step of a pod costs one exchange or more): RCM's stencil side (phase
#: 21: 128), minimum degree's (phase 21: 24) and the matchings' R-MAT
#: scale (phase 22: 20).
POD_SPMM_D = 32
POD_SPMM = (("sum", PLUS_TIMES), ("max", MAX_TIMES))
POD_DENSE_SCALE = 12
POD_RCM_SIDE = 32
POD_MD_SIDE = 12
POD_MATCH_SCALE = 18


def vec_digest(x: torch.Tensor, lo: int = 0) -> int:
    """The elements of ``x`` (flattened; ``lo`` the global index of its
    first), each one's bits times a hash of its global index, summed
    modulo 2^64: two vectors with the same bits at the same indices have
    the same digest, whatever order the sum runs in."""
    x = x.reshape(-1).contiguous()
    if x.dtype == torch.bool:
        bits = x.long()
    elif x.element_size() == 8:
        bits = x.view(torch.int64)
    else:
        bits = x.to(torch.int32) if x.element_size() < 4 else x.view(
            torch.int32)
        bits = bits.long()
    t = torch.arange(lo + 1, lo + 1 + bits.numel(), device=x.device)
    w = ((t * 0x9E3779B1) & 0x7FFFFFFF) | 1
    return int((bits * w).sum())


def slice_digests(x: torch.Tensor, nproc: int) -> list:
    """:func:`vec_digest` of each of the ``nproc`` processes' slices of the
    whole FullyDist vector (or row-major rows) ``x``."""
    flat = x.reshape(-1)
    k = flat.numel() // nproc
    return [vec_digest(flat[q * k:(q + 1) * k], q * k)
            for q in range(nproc)]


def spmm_operand(seed: int, dev, rows: int) -> torch.Tensor:
    """Phase 26's dense SpMM operand: (rows, ``POD_SPMM_D``) normal floats
    drawn on the card from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed + 26)
    return torch.randn((rows, POD_SPMM_D), generator=gen, device=dev)


def pod_spmm_refs(dm, seed: int) -> dict:
    """The ``"algos"`` launch's ``dist_spmm`` references on phase 17's
    one-process 4x4 grid ``dm``: per semiring the digests of the 4
    processes' slices of Y, and the seconds of the call."""
    from combblas_tpu_torch.parallel.dense import dist_spmm
    from combblas_tpu_torch.parallel.dist import col_vec_len
    dev = dm.row.device
    x = spmm_operand(seed, dev, col_vec_len(dm.gshape, dm.grid))
    out = {}
    for name, sr in POD_SPMM:
        y, secs = _timed(lambda sr=sr: dist_spmm(dm, x, sr), dev)
        out[name] = dict(digests=slice_digests(y, POD_SCENARIOS["algos"]),
                         secs=secs)
    return out


def block_digests(c) -> list:
    """[i, j, nnz, keys, values] of each of this process's blocks of ``c``
    ([t, i, j, ...] of a layered ``Dist3DSpMat``): the live entries' keys
    (row * 2^32 + col) and value bits, each times a hash of its slot,
    summed modulo 2^64.  Two blocks whose live slots hold the same keys and
    the same value bits in the same order have the same digest; the sums
    of integers do not depend on the order they run in."""
    if isinstance(c, DistSpMat):
        origin, shape = c.grid.origin(), c.grid.local_shape()
    else:
        origin, shape = c.grid.origin3(), c.grid.local_shape3()
    live = torch.clamp(c.local_nnz, max=c.capacity).reshape(-1).tolist()
    out = []
    for b, idx in enumerate(np.ndindex(*shape)):
        k = live[b]
        t = torch.arange(1, k + 1, device=c.row.device)
        w = ((t * 0x9E3779B1) & 0x7FFFFFFF) | 1
        key = (c.row[idx][:k].long() << 32) | c.col[idx][:k].long()
        bits = c.val[idx][:k].contiguous().view(torch.int32).long()
        out.append([o + x for o, x in zip(origin, idx)] + [
            k, int((key * w).sum()), int((bits * w).sum())])
    return out


def _pod_sync(dev) -> None:
    from combblas_tpu_torch.parallel import exchange
    torch.cuda.synchronize(dev)
    exchange.barrier()


def _pod_call(label: str, fn, dev) -> tuple:
    """``fn()`` between two rendezvous of the pod, its launches counted:
    (result, dict of secs and launches)."""
    _pod_sync(dev)
    reset_launches()
    t = time.perf_counter()
    got = fn()
    _pod_sync(dev)
    secs = time.perf_counter() - t
    return got, dict(secs=secs, launches={k: v for k, v in LAUNCHES.items()
                                         if v})


def _pod_summa(dm, dev) -> dict:
    from combblas_tpu_torch.parallel.summa import summa_spgemm_auto
    side = dm.grid.pr
    c, line = _pod_call(f"summa {side}x{side}",
                        lambda: summa_spgemm_auto(dm, dm), dev)
    line.update(digests=block_digests(c), capacity=c.capacity,
                nnz=int(c.nnz.sum()))
    return line


#: Phase 26's layered A²: phase 14's (2, 2, 2) ``summa3d_spgemm``, cut
#: from scale 17 to 16 so that four workers fit the card (at scale 17 even
#: two workers, a layer each, ran out of its memory).
POD_3D_SCALE = 16


def _summa3d_call(a, g3):
    """The (2, 2, 2) ``summa3d_spgemm`` of A² on ``g3`` (one process, or
    over the processes), its caps from ``summa3d_layer_bounds``: (call,
    caps)."""
    from combblas_tpu_torch.parallel.summa3d import (
        Dist3DSpMat,
        summa3d_layer_bounds,
        summa3d_spgemm,
    )
    a3 = Dist3DSpMat.from_dist2d(a, g3, "col")
    b3 = Dist3DSpMat.from_dist2d(a, g3, "row")
    fc, oc = summa3d_layer_bounds(a3, b3)
    return (lambda: summa3d_spgemm(a3, b3, flops_cap=fc, out_capacity=oc),
            (fc, oc))


def summa3d_one(seed: int, dev) -> dict:
    """Phase 26's one-process reference of the layered A²: the
    scale-``POD_3D_SCALE`` (2, 2, 2) product timed (a warm call, then the
    best of two), its blocks digested, its caps and peak."""
    a = a2_matrix(seed, dev, POD_3D_SCALE)
    call, caps = _summa3d_call(a, ProcGrid.make(GRID3D[1], GRID3D[2],
                                                GRID3D[0], device=dev))
    c = call()
    del c
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        c = None
        _sync(dev)
        t = time.perf_counter()
        c = call()
        _sync(dev)
        secs.append(time.perf_counter() - t)
    out = dict(digests=block_digests(c), caps=list(caps), secs=min(secs),
               times=secs, nnz=int(c.nnz.sum()),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del c, call
    torch.cuda.empty_cache()
    return out


def _pod_summa3d(a, dev) -> dict:
    """The layered A² on a (2, 2, 2) grid over the processes (a layer's
    block row each over 4), its caps from ``summa3d_layer_bounds`` over the
    processes: the call timed between two rendezvous, its blocks digested,
    the caps and the peak memory."""
    from combblas_tpu_torch.parallel.multihost import pod_grid
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    call, caps = _summa3d_call(a, pod_grid(
        layers=GRID3D[0], pr=GRID3D[1], pc=GRID3D[2], device=dev))
    c, line = _pod_call("summa3d 2x2x2", call, dev)
    line.update(digests=block_digests(c), caps=list(caps),
                nnz=int(c.nnz.sum()), block_shape=list(c.block_shape()),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return line


def _pod_rma(dm, dev) -> dict:
    from combblas_tpu_torch.parallel.rma import summa_spgemm_rma
    from combblas_tpu_torch.parallel.summa import summa_bounds
    fc, oc = summa_bounds(dm, dm)
    c, line = _pod_call("rma 4x4", lambda: summa_spgemm_rma(
        dm, dm, stage_flops_cap=fc, out_capacity=oc), dev)
    line.update(digests=block_digests(c), nnz=int(c.nnz.sum()))
    return line


#: Bytes read between two timed K9 pushes across processes: past the
#: H100's 50 MB L2, so that no push finds its stacks there.
POD_FLUSH_BYTES = 256 << 20
#: Cycles the card sleeps before a timed push (about 1 ms), so that the
#: host has queued the push before its start event is reached.
POD_SLEEP_CYCLES = 2_000_000


def _pod_k9_case(srcs, axes, g, dev, reps: int = 5) -> dict:
    """K9's cross-process form on this process's ``srcs``: the hop as the
    ring SUMMA makes it (:func:`ring_hop`) against its ``gloo`` plain
    version, bit for bit; then its times.  ``ms``: one launch with this
    process pushing alone (the others wait at a barrier, so no other
    context shares the card), by CUDA events, L2 flushed before each
    push and the push queued behind a sleep (checked: the start event is
    not reached before the push is queued); ``hop_ms``: the whole hop with
    every process pushing and the rendezvous, on the host clock (the least
    of ``reps``);
    ``plain_ms``: the plain version on the host clock."""
    from combblas_tpu_torch.ops.kernels.ring import (
        _pod_launch,
        _pod_slot,
        ring_hop,
        ring_shift_pod_plain,
    )
    from combblas_tpu_torch.parallel import exchange
    srcs = [x.contiguous() for x in srcs]
    want = ring_shift_pod_plain(srcs, axes, g)
    if not _bitwise_equal(ring_hop(srcs, axes, g), want):
        raise AssertionError("K9 across processes: kernel and gloo plain "
                             "version differ")
    del want
    nbytes = sum(x.numel() * x.element_size() for x in srcs)
    hop = []
    for _ in range(reps):
        _pod_sync(dev)
        t = time.perf_counter()
        ring_hop(srcs, axes, g)
        hop.append((time.perf_counter() - t) * 1e3)
    slot, offs = _pod_slot(srcs, dev)
    flush = torch.empty(POD_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    start = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    solo = []
    for turn in range(exchange.size()):
        _pod_sync(dev)
        if exchange.rank() != turn:
            continue
        for k in range(reps):
            flush.sum()
            torch.cuda._sleep(POD_SLEEP_CYCLES)
            start[k].record()
            _pod_launch(srcs, axes, g, slot, offs)
            end[k].record()
            if start[k].query():
                raise AssertionError("the card reached a timed push's "
                                     "start before the push was queued")
        torch.cuda.synchronize(dev)
        solo = [s.elapsed_time(e) for s, e in zip(start, end)]
    _pod_sync(dev)
    t = time.perf_counter()
    ring_shift_pod_plain(srcs, axes, g)
    plain_ms = (time.perf_counter() - t) * 1e3
    return dict(ms=sum(solo) / reps, hop_ms=min(hop), plain_ms=plain_ms,
                bytes=nbytes, max_abs_err=0.0)


def _pod_k9(dm, a, dev) -> dict:
    """K9's cross-process form held against its ``gloo`` plain version
    and timed (:func:`_pod_k9_case`), first at the ring SUMMA's own launch
    (``main``): ``dm``'s 4x4 blocks over the 4 processes after Cannon's
    skew, A's (1, 4) shares along 'c' (a ring inside the process) and B's
    along 'r' (every block crossing) in one launch; then on A's 2x2
    blocks (one a process, both axes crossing) along each axis and both
    at once."""
    from combblas_tpu_torch.parallel.multihost import pod_grid
    from combblas_tpu_torch.parallel.rma import _skew
    out = {"main": _pod_k9_case([*_skew(dm, "c"), *_skew(dm, "r")],
                                ["c"] * 4 + ["r"] * 4, dm.grid, dev)}
    torch.cuda.empty_cache()
    g = pod_grid(pr=2, pc=2, device=dev)
    d2 = DistSpMat.from_local(a, g)
    stacks = [d2.row, d2.col, d2.val, d2.local_nnz]
    for name, (srcs, axes) in {
            "2x2_c": (stacks, ["c"] * 4), "2x2_r": (stacks, ["r"] * 4),
            "2x2_both": (stacks * 2, ["c"] * 4 + ["r"] * 4)}.items():
        out[name] = _pod_k9_case(srcs, axes, g, dev)
    return out


def _pod_bfs(s, dm, dev, d: str) -> dict:
    """``bfs_dist`` of phase 8's graph ``s`` (``dm`` on a 4x4 grid over the
    processes) from phase 8's first roots: levels equal phase 8's,
    Graph500-valid."""
    from combblas_tpu_torch.models.bfs import bfs_dist
    from combblas_tpu_torch.parallel import exchange
    n = s.shape[0]
    roots = np.load(os.path.join(d, "roots.npy"))
    want = np.load(os.path.join(d, "levels.npy"))
    runs = []
    for i, r in enumerate(roots):
        (par, lv), line = _pod_call("bfs", lambda r=r: bfs_dist(dm, int(r)),
                                    dev)
        par, lv = exchange.allgather_var([par, lv])
        par, lv = par[:n], lv[:n]
        if not np.array_equal(lv.cpu().numpy(), want[i]):
            raise AssertionError(f"bfs_dist across processes from {r}: "
                                 "levels differ from phase 8's")
        if exchange.rank() == 0 and not validate_bfs(s, int(r), par, lv):
            raise AssertionError(f"bfs_dist across processes from {r} does "
                                 "not validate")
        runs.append(dict(line, root=int(r), levels=int(lv.max()) + 1))
    return dict(runs=runs, nnz=int(s.nnz))


def _whole_equal(got, want: np.ndarray, label: str) -> None:
    """This process's slice ``got`` of a vector, all-gathered, equals
    ``want`` (a host array, cut to the same length) byte for byte."""
    from combblas_tpu_torch.parallel import exchange
    whole = exchange.allgather_var([got])[0].cpu().numpy()
    k = min(whole.shape[0], want.shape[0])
    if whole.shape[0] < want.shape[0] or not np.array_equal(
            whole[:k].view(np.uint8), np.ascontiguousarray(want[:k])
            .view(np.uint8)):
        raise AssertionError(f"{label} across processes differs from one "
                             "process's")


def _pod_lacc_mis(dm, dev, d: str, seed: int) -> dict:
    """``lacc_dist`` and ``luby_mis_dist`` (phase 17's seed) of phase 8's
    graph on the 4x4 grid over the processes: the labels and the set equal
    phase 17's."""
    from combblas_tpu_torch.models.lacc import lacc_dist
    from combblas_tpu_torch.models.mis import luby_mis_dist
    labels, lacc = _pod_call("lacc", lambda: lacc_dist(dm), dev)
    _whole_equal(labels, np.load(os.path.join(d, "lacc.npy")), "lacc_dist")
    in_set, mis = _pod_call("mis", lambda: luby_mis_dist(
        dm, torch.Generator(device=dev).manual_seed(seed)), dev)
    _whole_equal(in_set, np.load(os.path.join(d, "mis.npy")),
                 "luby_mis_dist")
    return dict(lacc=lacc, mis=mis)


def _pod_permute(s, dm, dev, d: str, seed: int) -> dict:
    """Phase 19's permutation of phase 8's graph across the processes:
    ``dist_rand_perm`` of phase 19's seed (this process's slice equal to
    phase 19's), then ``dist_permute`` of ``dm`` by it, its blocks
    digested for the parent."""
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.indexing import dist_permute
    from combblas_tpu_torch.parallel.vector import dist_rand_perm
    n, g = s.shape[0], dm.grid
    perm, line = _pod_call("dist_rand_perm", lambda: dist_rand_perm(
        torch.Generator(device=dev).manual_seed(seed), n, g), dev)
    _whole_equal(perm, np.load(os.path.join(d, "perm.npy")),
                 "dist_rand_perm")
    whole = exchange.gather_whole(perm, g)[:n]
    out, permute = _pod_call("dist_permute", lambda: dist_permute(dm, whole),
                             dev)
    permute.update(digests=block_digests(out), capacity=out.capacity,
                   rand_perm_secs=line["secs"])
    return permute


#: Phase 19's vector calls that phase 26 repeats across processes: name ->
#: (function name, the inputs' keys in phase 19's ``refs``, keyword
#: arguments, the outputs' keys).
POD_VECTOR_CALLS = {
    "dist_invert_perm": ("dist_invert", ("perm", "perm_live"), {},
                         ("invert_perm", "invert_perm_hit")),
    "dist_invert_dup": ("dist_invert", ("dup", "live"), {},
                        ("invert_dup", "invert_dup_hit")),
    "dist_uniq": ("dist_uniq", ("fv", "live"), {}, ("uniq", "uniq_hit")),
    "dist_gather": ("dist_gather", ("x", "gi"), {}, ("gather",)),
    "dist_apply_perm": ("dist_apply_perm", ("x", "perm"), {},
                        ("apply_perm",)),
    **{f"dist_route_{c}{t}": ("dist_route",
                              ("ri", v, "live", "init"), dict(combine=c),
                              (f"route_{c}{t}", f"route_{c}{t}_hit"))
       for c in ("set", "sum", "min", "max")
       for t, v in (("", "rq"), ("_rf", "rf"))},
}


def _pod_vectors(dev, d: str) -> dict:
    """Phase 19's vector functions at its length on a 4x4 grid over the
    processes, on phase 19's inputs (``d/vectors.npz``): ``dist_rand_perm``
    of phase 19's seed, then every call of :data:`POD_VECTOR_CALLS` on
    this process's slices; every output equal to phase 19's bit for bit.
    Host seconds a call between two rendezvous."""
    from combblas_tpu_torch.parallel import vector
    from combblas_tpu_torch.parallel.multihost import pod_grid
    z = np.load(os.path.join(d, "vectors.npz"))
    g = pod_grid(pr=DIST_SIDE, pc=DIST_SIDE, device=dev)
    n, n_pad = int(z["n"]), z["perm"].shape[0]
    lo, hi = g.vec_range(n_pad)
    ins = {k: torch.from_numpy(z[k][lo:hi]).to(dev) for k in (
        "perm", "dup", "live", "fv", "x", "gi", "ri", "rq", "init", "rf")}
    ins["perm_live"] = ins["perm"] < n
    perm, line = _pod_call("dist_rand_perm", lambda: vector.dist_rand_perm(
        torch.Generator(device=dev).manual_seed(int(z["seed"])), n, g), dev)
    _whole_equal(perm, z["perm"], "dist_rand_perm")
    secs = dict(dist_rand_perm=line["secs"])
    for name, (fn, args, kw, outs) in POD_VECTOR_CALLS.items():
        got, line = _pod_call(name, lambda fn=fn, args=args, kw=kw: getattr(
            vector, fn)(*(ins[k] for k in args), g, **kw), dev)
        got = got if isinstance(got, tuple) else (got,)
        for x, key in zip(got, outs):
            _whole_equal(x, z[key], f"{name} ({key})")
        secs[name] = line["secs"]
    return dict(n=n, n_pad=n_pad, secs=secs)


def _pod_indexing(dev, d: str, seed: int) -> dict:
    """Phase 19's ``dist_spref``, ``dist_prune_block`` and ``dist_spasgn``
    of phase 15's graph (``d/indexing_graph.npz``) on phase 16's vertices,
    on a 4x4 grid over the processes: each output's blocks digested for
    the parent, the launches read around each call."""
    from combblas_tpu_torch.parallel.elementwise import dist_apply
    from combblas_tpu_torch.parallel.indexing import (
        dist_prune_block,
        dist_spasgn,
        dist_spref,
    )
    from combblas_tpu_torch.parallel.multihost import pod_grid
    z = np.load(os.path.join(d, "indexing_graph.npz"))
    shape = tuple(int(x) for x in z["shape"])
    dm = DistSpMat.from_coo_arrays(z["row"], z["col"], z["val"], shape,
                                   pod_grid(pr=DIST_SIDE, pc=DIST_SIDE,
                                            device=dev))
    del z
    v = half_vertices(shape[0], seed)
    sub, spref = _pod_call("dist_spref", lambda: dist_spref(dm, v, v), dev)
    pruned, prune = _pod_call("dist_prune_block",
                              lambda: dist_prune_block(dm, v, v), dev)
    prune["digests"] = block_digests(pruned)
    del pruned
    b2 = dist_apply(sub, lambda x: 2.0 * x)
    spref["digests"] = block_digests(sub)
    del sub
    asg, spasgn = _pod_call("dist_spasgn", lambda: dist_spasgn(dm, v, v, b2),
                            dev)
    spasgn["digests"] = block_digests(asg)
    return dict(spref=spref, prune_block=prune, spasgn=spasgn)


def _pod_sort(dev, seed: int) -> dict:
    """``dist_sort_auto`` of phase 19's kind of 2^26 float32 with an int32
    payload on a 4x4 grid over the processes: this process's slice equal
    to ``torch.sort``'s stable order of the whole vector, element for
    element."""
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.multihost import pod_grid
    from combblas_tpu_torch.parallel.vector import (_sortable_u32,
                                                    dist_sort_auto)
    n = 1 << POD_SORT_LOG2
    x = sort_values(torch.Generator(device=dev).manual_seed(seed + 26), n,
                    dev)
    # the duplicate-index writes of sort_values land in any order on the
    # card: every process takes process 0's vector
    x, = exchange.pull([x], [(0, 0, 0, n)])
    g = pod_grid(pr=DIST_SIDE, pc=DIST_SIDE, device=dev)
    lo, hi = g.vec_range(n)
    xs = x[lo:hi].clone()
    ps = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    (sx, sp), line = _pod_call("sort", lambda: dist_sort_auto(xs, g, ps),
                               dev)
    order = torch.sort(_sortable_u32(x), stable=True)[1][lo:hi]
    if not (_same_bits(sx, x[order]) and torch.equal(sp, order.int())):
        raise AssertionError("dist_sort_auto across processes differs from "
                             "torch.sort's order")
    return dict(line, n=n)


def _pod_io(dev, d: str, seed: int) -> dict:
    """The scale-``IO_SCALE`` graph of phase 24 on a 2x2 grid over the 2
    processes: the cooperative writes (the parent holds them against one
    process's files) and the cooperative read of one process's file, equal
    to this process's blocks."""
    from combblas_tpu_torch.io.parallel import (
        parallel_read_mtx,
        parallel_write_binary,
        parallel_write_mtx,
    )
    from combblas_tpu_torch.parallel.multihost import pod_grid
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(seed), IO_SCALE,
                    16)
    g = pod_grid(pr=2, pc=2, device=dev)
    dm = DistSpMat.from_local(a, g)
    out = {}
    for name, fn in (
            ("parallel_write_mtx", lambda: parallel_write_mtx(
                os.path.join(d, "pod.mtx"), dm)),
            ("parallel_write_binary", lambda: parallel_write_binary(
                os.path.join(d, "pod.bin"), dm)),
            ("parallel_read_mtx", lambda: parallel_read_mtx(
                os.path.join(d, "one.mtx"), g))):
        got, out[name] = _pod_call(name, fn, dev)
    if not all(torch.equal(getattr(got, f), getattr(dm, f))
               for f in ("row", "col", "val", "nnz")):
        raise AssertionError("parallel_read_mtx across processes: blocks "
                             "differ from one process's")
    return out


def _pod_mcl(dev, d: str) -> dict:
    """``mcl_dist`` of phase 18's matrix (the parent saved it to
    ``d/mcl_graph.npz``), select 64, recover_num 80, on a 4x4 grid over
    the processes, ``phases=1`` (K1/K2): a timed run as a user calls it
    (each iteration's host seconds: an iteration ends in the chaos's max
    over the processes, a rendezvous; the launches read around the run;
    ``rest_secs`` what is not an iteration: the first normalisation, the
    transpose, the sum and FastSV; the peak memory; its label slice saved
    to ``d/mcl_labels_rank<r>.npy``: :func:`_pod_mcl_timed`); a run of as
    many iterations that digests every iterate's blocks
    (:func:`block_digests`); and a ``phases=2`` run of
    ``MCL_PHASES_ITERS`` iterations, its last iterate digested.  Each run
    is watched by :class:`MCLDistWatch` ``light``, as phase 18's timed
    run is."""
    from combblas_tpu_torch.models import mcl as mcl_mod
    dm, p, line = _pod_mcl_timed(np.load(os.path.join(d, "mcl_graph.npz")),
                                 dev, d, "mcl")
    torch.cuda.empty_cache()
    with MCLDistWatch(p, light=True, digests=True) as w:
        mcl_mod.mcl_dist(dm, dataclasses.replace(p, max_iters=line["iters"]))
    line["digests"] = [r["digests"] for r in w.rows]
    del w
    with MCLDistWatch(p, light=True) as w:
        mcl_mod.mcl_dist(dm, dataclasses.replace(
            p, max_iters=MCL_PHASES_ITERS), phases=2)
    line["digests3"] = block_digests(w.last)
    return line


def _pod_mcl_timed(z, dev, d: str, tag: str, **kw):
    """The matrix of ``z`` (host arrays) on a 4x4 grid over the processes,
    and ``mcl_dist(.., **kw)`` of it timed as a user calls it, watched by
    :class:`MCLDistWatch` ``light``: each iteration's host seconds (an
    iteration ends in the chaos's max over the processes, a rendezvous),
    the launches read around the run, ``rest_secs`` what is not an
    iteration, the peak memory; its label slice saved to
    ``d/<tag>_labels_rank<r>.npy``.  Returns (matrix, params, line)."""
    from combblas_tpu_torch.models import mcl as mcl_mod
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.multihost import pod_grid
    g = pod_grid(pr=DIST_SIDE, pc=DIST_SIDE, device=dev)
    dm = DistSpMat.from_coo_arrays(z["row"], z["col"], z["val"],
                                   tuple(int(x) for x in z["shape"]), g)
    p = mcl_mod.MCLParams(**MCL_PARAMS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with MCLDistWatch(p, light=True) as w:
        (labels, iters), line = _pod_call(
            tag, lambda: mcl_mod.mcl_dist(dm, p, **kw), dev)
    secs = [r["iter_secs"] for r in w.rows]
    line.update(iters=int(iters), iter_secs=secs,
                rest_secs=line["secs"] - sum(secs),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    np.save(os.path.join(d, f"{tag}_labels_rank{exchange.rank()}.npy"),
            labels.cpu().numpy())
    return dm, p, line


def _pod_mcl_layers(dev, d: str) -> dict:
    """Phase 18's scale-12 ``mcl_dist(layers=2, phases=2)`` (the parent
    saved its graph to ``d/mcl_layers_graph.npz``) on a 2x2 grid over the
    processes, its expansion on a (2, 2, 2) grid over them, timed as a user
    calls it and watched ``light``: the iterations, the seconds, the final
    iterate's digests, the peak; its label slice saved to
    ``d/mcl_layers_labels_rank<r>.npy``."""
    from combblas_tpu_torch.models import mcl as mcl_mod
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.multihost import pod_grid
    z = np.load(os.path.join(d, "mcl_layers_graph.npz"))
    side = MCL_DIST_CHECK_SIDE
    g = pod_grid(pr=side, pc=side, device=dev)
    g3 = pod_grid(layers=2, pr=side, pc=side, device=dev)
    dm = DistSpMat.from_coo_arrays(z["row"], z["col"], z["val"],
                                   tuple(int(x) for x in z["shape"]), g)
    p = mcl_mod.MCLParams(**MCL_PARAMS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with MCLDistWatch(p, light=True) as w:
        (labels, iters), line = _pod_call(
            "mcl_dist layers=2", lambda: mcl_mod.mcl_dist(
                dm, p, phases=2, layers=2, grid3=g3), dev)
    line.update(iters=int(iters), digests=block_digests(w.last),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    np.save(os.path.join(d, f"mcl_layers_labels_rank{exchange.rank()}.npy"),
            labels.cpu().numpy())
    return line


def _pod_mcl_preprocess(dev, d: str) -> dict:
    """``mcl_dist(preprocess=True)`` of phase 20's matrix
    (``d/preprocess_graph.npz``, with phase 20's generator seed) on a 4x4
    grid over the processes, timed as :func:`_pod_mcl` times its run
    (:func:`_pod_mcl_timed`)."""
    z = np.load(os.path.join(d, "preprocess_graph.npz"))
    gen = torch.Generator(device=dev).manual_seed(int(z["seed"]))
    return _pod_mcl_timed(z, dev, d, "mcl_preprocess", preprocess=True,
                          generator=gen)[2]


def _pod_dense(g, dev, seed: int) -> dict:
    """``dense_put`` / ``dense_add_sparse`` / ``dense_to_host`` /
    ``dense_reduce`` of a quarter-valued dense 2^``POD_DENSE_SCALE``-square
    matrix and the R-MAT graph of that scale on the 4x4 grid over the
    processes: each share and slice equal, bit for bit, to the same calls
    on a one-process 4x4 grid in this process and to numpy (the values
    are quarters, so every sum is exact)."""
    from combblas_tpu_torch.parallel import dense
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(seed),
                    POD_DENSE_SCALE, 16)
    n = a.shape[0]
    x = (np.random.default_rng(seed).integers(-40, 40, (n, n)) / 4.0
         ).astype(np.float32)
    one = ProcGrid.make(DIST_SIDE, DIST_SIDE, device=dev)
    mats = {"pod": (g, DistSpMat.from_local(a, g)),
            "one": (one, DistSpMat.from_local(a, one))}
    got, secs = {}, {}
    for key, (grid, m) in mats.items():
        put, secs[f"dense_put_{key}"] = _timed(
            lambda grid=grid: dense.dense_put(x, grid), dev)
        add, secs[f"dense_add_sparse_{key}"] = _timed(
            lambda m=m, put=put: dense.dense_add_sparse(put, m), dev)
        host, secs[f"dense_to_host_{key}"] = _timed(
            lambda grid=grid, add=add: dense.dense_to_host(
                add, (n, n), grid=grid), dev)
        red = {}
        for dim in ("row", "col"):
            red[dim], secs[f"dense_reduce_{dim}_{key}"] = _timed(
                lambda grid=grid, add=add, dim=dim: dense.dense_reduce(
                    add, dim, grid=grid), dev)
        got[key] = (put, add, host, red)
    k = int(a.nnz)
    want = x.copy()
    np.add.at(want, (a.row[:k].cpu().numpy(), a.col[:k].cpu().numpy()),
              a.val[:k].cpu().numpy())
    put, add, host, red = got["pod"]
    put1, add1, host1, red1 = got["one"]
    mb, nb = put1.shape[0] // DIST_SIDE, put1.shape[1] // DIST_SIDE
    (r0, c0), (lr, lc) = g.origin(), g.local_shape()
    share = (slice(r0 * mb, (r0 + lr) * mb), slice(c0 * nb, (c0 + lc) * nb))
    rlo, rhi = g.vec_range(DIST_SIDE * mb)
    clo, chi = g.vec_range(DIST_SIDE * nb)
    if not (_bitwise_equal([put, add, red["row"], red["col"]],
                           [put1[share].contiguous(),
                            add1[share].contiguous(), red1["row"][rlo:rhi],
                            red1["col"][clo:chi]])
            and np.array_equal(host, host1) and np.array_equal(host, want)
            and np.array_equal(red1["row"][:n].cpu().numpy(), want.sum(1))
            and np.array_equal(red1["col"][:n].cpu().numpy(),
                               want.sum(0))):
        raise AssertionError("the dense matrices across processes differ "
                             "from one process's or numpy's")
    return dict(n=n, nnz=k, secs=secs)


def _pod_filtered(s, g, dev, d: str, seed: int) -> dict:
    """Phase 24's ``TwitterGraph`` over phase 8's graph ``s`` on the 4x4
    grid over the processes: ``materialize_filtered_dist`` (block
    digests), ``bfs_within_dist`` from phase 8's first roots and
    ``mis_filtered_dist`` (digests of this process's slices)."""
    from combblas_tpu_torch.models.filtered import (
        materialize_filtered_dist,
        mis_filtered_dist,
    )
    from combblas_tpu_torch.models.semantic import (
        TwitterGraph,
        tweet_within_interval,
    )
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.parallel.dist import row_vec_len
    begin, end = TWITTER_WINDOW
    k = int(s.nnz)
    val = torch.zeros(s.capacity, dtype=torch.float32, device=dev)
    val[:k] = torch.from_numpy(_twitter_codes(s, seed)).to(dev)
    tg = TwitterGraph(SpCOO(row=s.row, col=s.col, val=val, nnz=s.nnz,
                            shape=s.shape))
    dm = tg.distribute(g)
    pred = tweet_within_interval(begin, end)
    sub, mat = _pod_call("materialize_filtered_dist",
                         lambda: materialize_filtered_dist(dm, pred), dev)
    mat["digests"] = block_digests(sub)
    del sub
    lo = g.vec_range(row_vec_len(dm.gshape, g))[0]
    out = dict(materialize=mat, bfs=[])
    for root in np.load(os.path.join(d, "roots.npy")):
        (par, lv), line = _pod_call("bfs_within_dist", lambda r=int(root): (
            tg.bfs_within_dist(dm, r, begin, end)), dev)
        out["bfs"].append(dict(line, root=int(root),
                               parents=vec_digest(par, lo),
                               levels=vec_digest(lv, lo)))
    in_set, line = _pod_call("mis_filtered_dist", lambda: mis_filtered_dist(
        dm, torch.Generator(device=dev).manual_seed(seed), pred), dev)
    out["mis"] = dict(line, digest=vec_digest(in_set, lo))
    return out


def _pod_multigrid(g, dev, seed: int) -> dict:
    """Phase 23 on the 4x4 grid over the processes: ``mis2_dist`` (the
    whole set's digest), ``restriction_op_dist`` and ``galerkin_dist``
    (block digests; K3/K4) of the ``RCM_SIDE``^3 stencil, then
    ``galerkin_dist`` of the same R and A on a 16x16 grid over the
    processes (K1/K2); each call's launches."""
    from combblas_tpu_torch.models import multigrid as mg
    from combblas_tpu_torch.parallel.multihost import pod_grid
    k = RCM_SIDE
    n = k ** 3
    r, c, v = mg_stencil(k, dev)
    dm = _grid_dist(r, c, v, n, g)
    in_set, mis2 = _pod_call("mis2_dist", lambda: mg.mis2_dist(
        dm, torch.Generator(device=dev).manual_seed(seed)), dev)
    mis2["digest"] = vec_digest(torch.from_numpy(in_set))
    R, rop = _pod_call("restriction_op_dist", lambda: mg.restriction_op_dist(
        dm, torch.Generator(device=dev).manual_seed(seed + 1)), dev)
    rop["digests"] = block_digests(R)
    cd, gal = _pod_call("galerkin_dist", lambda: mg.galerkin_dist(R, dm),
                        dev)
    gal["digests"] = block_digests(cd)
    del cd
    rl = R.to_local()
    nr = int(rl.nnz)
    gp = pod_grid(pr=MG_PACKED_SIDE, pc=MG_PACKED_SIDE, device=dev)
    rp = DistSpMat.from_coo_arrays(rl.row[:nr].cpu().numpy(),
                                   rl.col[:nr].cpu().numpy(),
                                   np.ones(nr, np.float32), R.gshape, gp)
    del rl, R, dm
    dmp = _grid_dist(r, c, v, n, gp)
    del r, c, v
    cp, packed = _pod_call("galerkin_dist_packed",
                           lambda: mg.galerkin_dist(rp, dmp), dev)
    packed["digests"] = block_digests(cp)
    return dict(mis2_dist=mis2, restriction_op_dist=rop, galerkin_dist=gal,
                galerkin_dist_packed=packed)


def _pod_algos(dev, d: str, seed: int) -> dict:
    """Item 1.8's step 3 on the 4x4 grid over the processes, each call
    timed between two rendezvous and its result digested for the parent:
    ``dist_spmm`` (sum and max, d = ``POD_SPMM_D``) and BC (phase 21's
    roots) of phase 8's graph, phase 24's filtered traversals of it, the
    dense matrices (:func:`_pod_dense`), ``rcm_order_dist`` of the
    relabelled ``POD_RCM_SIDE``^3 stencil (the parent's,
    ``d/rcm_graph.npz``), ``md_order_dist`` of the ``POD_MD_SIDE``^2
    stencil, the three matchings of the scale-``POD_MATCH_SCALE``
    weighted R-MAT, and phase 23's multigrid setup
    (:func:`_pod_multigrid`)."""
    from combblas_tpu_torch.models.bc import betweenness_centrality_dist
    from combblas_tpu_torch.models.ordering import (
        md_order_dist,
        rcm_order_dist,
    )
    from combblas_tpu_torch.parallel import matching as pm
    from combblas_tpu_torch.parallel.dense import dist_spmm
    from combblas_tpu_torch.parallel.dist import col_vec_len
    from combblas_tpu_torch.parallel.multihost import pod_grid
    g = pod_grid(pr=DIST_SIDE, pc=DIST_SIDE, device=dev)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    s = spmm_bfs_graphs(seed, dev, GRAPH_SCALE)["s"]
    dm = DistSpMat.from_local(s, g)
    n_pad = col_vec_len(dm.gshape, g)
    lo, hi = g.vec_range(n_pad)
    x = spmm_operand(seed, dev, n_pad)[lo:hi].clone()
    for name, sr in POD_SPMM:
        y, line = _pod_call(f"dist_spmm {name}",
                            lambda sr=sr: dist_spmm(dm, x, sr), dev)
        out[f"spmm_{name}"] = dict(line, digest=vec_digest(
            y, lo * POD_SPMM_D))
    del x, y
    roots = bfs_roots(s, seed)[:BC_SOURCES]
    scores, line = _pod_call("betweenness_centrality_dist",
                             lambda: betweenness_centrality_dist(
                                 dm, BC_BATCH, roots), dev)
    out["bc"] = dict(line, digest=vec_digest(torch.from_numpy(scores)))
    del dm
    torch.cuda.empty_cache()
    out["filtered"] = _pod_filtered(s, g, dev, d, seed)
    del s
    torch.cuda.empty_cache()
    out["dense"] = _pod_dense(g, dev, seed)
    torch.cuda.empty_cache()
    z = np.load(os.path.join(d, "rcm_graph.npz"))
    n = int(z["n"])
    dm = DistSpMat.from_coo_arrays(z["row"], z["col"], z["val"], (n, n), g)
    order, line = _pod_call("rcm_order_dist", lambda: rcm_order_dist(dm),
                            dev)
    out["rcm"] = dict(line, digest=vec_digest(torch.from_numpy(order)))
    k = POD_MD_SIDE
    r, c, v = stencil(k, 2, dev, diagonal=False)
    dm = _grid_dist(r, c, v, k * k, g)
    order, line = _pod_call("md_order_dist", lambda: md_order_dist(dm), dev)
    out["md"] = dict(line, digest=vec_digest(order))
    dm = DistSpMat.from_local(weighted_rmat(seed, dev, POD_MATCH_SCALE), g)
    for name in ("dist_bp_maximal", "dist_bp_maximum", "dist_awpm"):
        (mr, mc), line = _pod_call(name, lambda fn=getattr(pm, name): fn(
            dm), dev)
        out[name] = dict(line, row=vec_digest(mr, g.vec_range(
            mr.shape[0] * g.nproc)[0]), col=vec_digest(mc, g.vec_range(
                mc.shape[0] * g.nproc)[0]))
    del dm
    torch.cuda.empty_cache()
    out["multigrid"] = _pod_multigrid(g, dev, seed)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def pod_worker(scenario: str, rank: int, nproc: int, port: int, d: str,
               seed: int) -> int:
    """One process of a phase-26 pod on the card (``--pod-worker``): joins
    the group, runs its scenario and writes its results to
    ``d/<scenario>_rank<rank>.json``."""
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.multihost import pod_grid
    dev = torch.device("cuda", 0)
    initialize_multihost(f"127.0.0.1:{port}", nproc, rank)
    _build.library()          # the parent's build, loaded
    res = dict(rank=rank)
    if scenario == "two":
        a = a2_matrix(seed, dev, AUTO_SCALE)
        res["summa_2x2"] = _pod_summa(DistSpMat.from_local(
            a, pod_grid(pr=2, pc=2, device=dev)), dev)
        del a
        torch.cuda.empty_cache()
        res["io"] = _pod_io(dev, d, seed)
    elif scenario == "mcl":
        res["mcl"] = _pod_mcl(dev, d)
        torch.cuda.empty_cache()
        res["mcl_preprocess"] = _pod_mcl_preprocess(dev, d)
        torch.cuda.empty_cache()
        res["mcl_layers"] = _pod_mcl_layers(dev, d)
    elif scenario == "algos":
        res["algos"] = _pod_algos(dev, d, seed)
    else:
        a = a2_matrix(seed, dev, AUTO_SCALE)
        dm = DistSpMat.from_local(a, pod_grid(pr=4, pc=4, device=dev))
        res["summa_4x4"] = _pod_summa(dm, dev)
        torch.cuda.empty_cache()
        res["rma_4x4"] = _pod_rma(dm, dev)
        torch.cuda.empty_cache()
        res["k9"] = _pod_k9(dm, a, dev)
        del a, dm
        torch.cuda.empty_cache()
        res["summa3d_2x2x2"] = _pod_summa3d(
            a2_matrix(seed, dev, POD_3D_SCALE), dev)
        torch.cuda.empty_cache()
        s = spmm_bfs_graphs(seed, dev, GRAPH_SCALE)["s"]
        dm = DistSpMat.from_local(s, pod_grid(pr=DIST_SIDE, pc=DIST_SIDE,
                                              device=dev))
        res["bfs"] = _pod_bfs(s, dm, dev, d)
        res["lacc_mis"] = _pod_lacc_mis(dm, dev, d, seed)
        res["permute"] = _pod_permute(s, dm, dev, d, seed)
        del s, dm
        torch.cuda.empty_cache()
        res["sort"] = _pod_sort(dev, seed)
        torch.cuda.empty_cache()
        res["vectors"] = _pod_vectors(dev, d)
        torch.cuda.empty_cache()
        res["indexing"] = _pod_indexing(dev, d, seed)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(d, f"{scenario}_rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    exchange.close()
    torch.distributed.destroy_process_group()
    return 0


def _run_pod(scenario: str, d: str, seed: int) -> list:
    """Start the scenario's workers (fresh interpreters of this script, all
    on the one card), wait for all of them, kill all on the timeout or on
    a failure; returns their results in rank order."""
    import socket

    nproc = POD_SCENARIOS[scenario]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--pod-worker", scenario, str(r), str(nproc), str(port), d],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nproc)]
    outs = []
    try:
        deadline = time.perf_counter() + POD_TIMEOUT_SECS
        for p in procs:
            left = max(deadline - time.perf_counter(), 1.0)
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:    # every rank's tail: the first to fail may be any of them
        raise AssertionError(f"pod {scenario}: " + "\n".join(failed))
    res = []
    for r in range(nproc):
        with open(os.path.join(d, f"{scenario}_rank{r}.json")) as fh:
            res.append(json.load(fh))
    return res


def _same_digests(ranks, key: str, want: list, label: str) -> None:
    got = sorted(tuple(x) for r in ranks for x in r[key]["digests"])
    if got != sorted(tuple(x) for x in want):
        raise AssertionError(f"{label}: blocks differ from one process's")


def _sum_launches(ranks, key: str) -> dict:
    out = {}
    for r in ranks:
        for k, v in r[key]["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def pod_full(seed: int, refs: dict, dev) -> dict:
    """Phase 26: the pod on the one card.  A 2-process pod (2 blocks
    each): ``summa_spgemm_auto`` 2x2 of phase 11's A² (K3/K4) equal to
    phase 13's blocks, and the cooperative I/O of phase 24's graph (files
    byte for byte one process's, the read equal to one process's blocks);
    a 4-process pod: ``summa_spgemm_auto`` 4x4 (K1/K2) equal to phase
    13's, the ring SUMMA 4x4 equal to phase 14's (K9 across processes), K9
    across processes alone against its ``gloo`` plain version, the layered
    (2, 2, 2) ``summa3d_spgemm`` of the scale-16 A² against one process's
    (:func:`summa3d_one`, :func:`check_pod_summa3d`), ``bfs_dist``
    from 4 of phase 8's roots, ``lacc_dist`` and ``luby_mis_dist`` (phase
    17's), phase 19's permutation of that graph, ``dist_sort_auto`` of
    2^26 float32, phase 19's vector calls and its SpRef / block prune /
    SpAsgn; then HipMCL's pod path in a 4-process launch of its own
    (:func:`_pod_mcl`, :func:`check_pod_mcl`), with its preprocessing
    (:func:`_pod_mcl_preprocess`, :func:`check_pod_mcl_preprocess`) and
    the layered ``mcl_dist`` (:func:`_pod_mcl_layers`,
    :func:`check_pod_mcl_layers`); then
    item 1.8's step 3 in a 4-process launch of its own (:func:`_pod_algos`
    against :func:`algos_refs` and the references of phases 17, 21, 23
    and 24, :func:`check_pod_algos`)."""
    d = os.path.abspath(os.path.join("chiprun_out", "pod"))
    os.makedirs(d, exist_ok=True)
    try:
        return _pod_phase(seed, refs, dev, d)
    finally:
        shutil.rmtree(d)   # chiprun_out/ stays small enough to come back


def _pod_phase(seed: int, refs: dict, dev, d: str) -> dict:
    from combblas_tpu_torch.io.parallel import (
        parallel_write_binary,
        parallel_write_mtx,
    )
    np.save(os.path.join(d, "roots.npy"), np.asarray(refs["roots"]))
    np.save(os.path.join(d, "levels.npy"), refs["levels"])
    np.savez(os.path.join(d, "mcl_graph.npz"), **refs["mcl"]["graph"])
    np.savez(os.path.join(d, "mcl_layers_graph.npz"),
             **refs["mcl_layers"]["graph"])
    for name in ("lacc", "mis"):
        np.save(os.path.join(d, f"{name}.npy"), refs[name])
    np.save(os.path.join(d, "perm.npy"), refs["permute"]["perm"])
    np.savez(os.path.join(d, "vectors.npz"), **{
        k: v for k, v in refs["vectors"].items() if isinstance(v, np.ndarray)})
    np.savez(os.path.join(d, "indexing_graph.npz"),
             **refs["indexing"]["graph"])
    np.savez(os.path.join(d, "preprocess_graph.npz"),
             **refs["mcl_preprocess"]["graph"])
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(seed), IO_SCALE,
                    16)
    dm = DistSpMat.from_local(a, ProcGrid.make(2, 2, device=dev))
    parallel_write_mtx(os.path.join(d, "one.mtx"), dm)
    parallel_write_binary(os.path.join(d, "one.bin"), dm)
    del a, dm
    torch.cuda.empty_cache()
    out = {}
    t = time.perf_counter()
    two = _run_pod("two", d, seed)
    out["two_secs"] = time.perf_counter() - t
    for ext in ("mtx", "bin"):
        with open(os.path.join(d, f"pod.{ext}"), "rb") as f1, \
                open(os.path.join(d, f"one.{ext}"), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"parallel_write across 2 processes: "
                                     f"the .{ext} file differs from one "
                                     "process's")
    _same_digests(two, "summa_2x2", refs["summa_spgemm_auto 2x2"],
                  "summa_spgemm_auto 2x2 across 2 processes")
    t = time.perf_counter()
    one3 = summa3d_one(seed, dev)
    out["summa3d_one_secs"] = time.perf_counter() - t
    t = time.perf_counter()
    four = _run_pod("four", d, seed)
    out["four_secs"] = time.perf_counter() - t
    _same_digests(four, "summa_4x4", refs["summa_spgemm_auto 4x4"],
                  "summa_spgemm_auto 4x4 across 4 processes")
    _same_digests(four, "rma_4x4", refs["summa_spgemm_rma 4x4"],
                  "summa_spgemm_rma 4x4 across 4 processes")
    out["summa3d"] = check_pod_summa3d(four, one3)
    _same_digests(four, "permute", refs["permute"]["digests"],
                  "dist_permute of phase 8's graph across 4 processes")
    index = [r["indexing"] for r in four]
    for key in ("spref", "prune_block", "spasgn"):
        _same_digests(index, key, refs["indexing"]["digests"][key],
                      f"dist_{key} of phase 15's graph across 4 processes")
    launches = {"summa_2x2": _sum_launches(two, "summa_2x2"),
                "summa_4x4": _sum_launches(four, "summa_4x4"),
                "rma_4x4": _sum_launches(four, "rma_4x4"),
                "spref": _sum_launches(index, "spref"),
                "spasgn": _sum_launches(index, "spasgn")}
    want = {"summa_2x2": ("expand_i64", "compress_i64"),
            "summa_4x4": ("expand_i32", "compress_i32"),
            "rma_4x4": ("ring_shift", "ring_shift_pod"),
            "spref": ("expand_i32", "compress_i32"),
            "spasgn": ("expand_i32", "compress_i32")}
    for key, names in want.items():
        if any(launches[key].get(k, 0) < 1 for k in names):
            raise AssertionError(f"pod {key} launched {launches[key]}, "
                                 f"want {names}")
    k9 = {}
    for case in four[0]["k9"]:   # the slowest process's, as the hop waits
        k9[case] = {k: max(r["k9"][case][k] for r in four) for k in (
            "ms", "hop_ms", "plain_ms", "bytes", "max_abs_err")}
        k9[case].update(bound(2 * k9[case]["bytes"], 0))
    peaks = {f"{sc}_rank{r['rank']}": r["peak_gib"]
             for sc, ranks in (("two", two), ("four", four)) for r in ranks}
    out.update(
        launches=launches, k9=k9, peak_gib=peaks,
        secs={key: max(r[key]["secs"] for r in ranks)
              for key, ranks in (("summa_2x2", two), ("summa_4x4", four),
                                 ("rma_4x4", four), ("sort", four))},
        io_secs={k: max(r["io"][k]["secs"] for r in two)
                 for k in two[0]["io"]},
        bfs=[dict(root=run["root"], levels=run["levels"], secs=max(
            r["bfs"]["runs"][i]["secs"] for r in four))
            for i, run in enumerate(four[0]["bfs"]["runs"])],
        vectors=dict(secs={k: max(r["vectors"]["secs"][k] for r in four)
                           for k in four[0]["vectors"]["secs"]},
                     one_process_ms=refs["vectors"]["ms"]),
        permute=dict(secs=max(r["permute"]["secs"] for r in four),
                     rand_perm_secs=max(r["permute"]["rand_perm_secs"]
                                        for r in four),
                     capacity=four[0]["permute"]["capacity"],
                     one_process_secs=refs["permute"]["secs"]),
        lacc_mis={k: dict(secs=max(r["lacc_mis"][k]["secs"] for r in four),
                          one_process_secs=refs[f"{k}_secs"])
                  for k in ("lacc", "mis")},
        indexing={k: dict(secs=max(r["indexing"][k]["secs"] for r in four),
                          one_process_secs=refs["indexing"]["secs"][k])
                  for k in ("spref", "prune_block", "spasgn")})
    log(f"  2 processes: summa_spgemm_auto 2x2 equals phase 13's blocks "
        f"({out['secs']['summa_2x2']:.3f} s, launches "
        f"{launches['summa_2x2']}); I/O files byte-equal, read equal "
        f"({out['io_secs']})")
    log(f"  4 processes: summa_spgemm_auto 4x4 equals phase 13's "
        f"({out['secs']['summa_4x4']:.3f} s, {launches['summa_4x4']}); "
        f"summa_spgemm_rma 4x4 equals phase 14's "
        f"({out['secs']['rma_4x4']:.3f} s, {launches['rma_4x4']}); "
        f"bfs_dist levels equal phase 8's and validate ({out['bfs']}); "
        f"dist_sort_auto 2^{POD_SORT_LOG2} equals torch.sort "
        f"({out['secs']['sort']:.3f} s)")
    log(f"  4 processes: phase 19's vector calls at {VEC_LEN} equal phase "
        f"19's bit for bit (secs {out['vectors']['secs']}); dist_permute of "
        f"phase 8's graph equals phase 19's blocks "
        f"({out['permute']['secs']:.3f} s, one process "
        f"{out['permute']['one_process_secs']:.3f}); lacc_dist and "
        f"luby_mis_dist equal phase 17's ({out['lacc_mis']}); dist_spref / "
        f"dist_prune_block / dist_spasgn equal phase 19's "
        f"({out['indexing']}; launches {launches['spref']}, "
        f"{launches['spasgn']})")
    for case, r in k9.items():
        log(f"  K9 across 4 processes ({case}): bit for bit its gloo plain "
            f"version; one push alone {r['ms']:.4f} ms (CUDA events, L2 "
            f"flushed), hop with rendezvous {r['hop_ms']:.3f} ms, gloo "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bytes']} bytes a process; the slowest process's)")
    log(f"  peak GiB per worker: {peaks}")
    t = time.perf_counter()
    mcl = _run_pod("mcl", d, seed)
    out["mcl_secs"] = time.perf_counter() - t
    out["mcl"] = check_pod_mcl(mcl, refs["mcl"], d)
    out["mcl_preprocess"] = check_pod_mcl_preprocess(
        mcl, refs["mcl_preprocess"], d)
    out["mcl_layers"] = check_pod_mcl_layers(mcl, refs["mcl_layers"], d)
    out["launches"].update(mcl=out["mcl"]["launches"],
                           mcl_preprocess=out["mcl_preprocess"]["launches"])
    t = time.perf_counter()
    one = algos_refs(seed, dev, d)
    out["algos_refs_secs"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    algos = _run_pod("algos", d, seed)
    out["algos_secs"] = time.perf_counter() - t
    out["algos"] = check_pod_algos(algos, refs, one)
    out["launches"]["galerkin"] = {}
    for part in out["algos"]["launches"].values():
        for k, v in part.items():
            out["launches"]["galerkin"][k] = out["launches"]["galerkin"].get(
                k, 0) + v
    log(f"  item 1.8's step 3 across 4 processes, 4x4 ({out['algos_secs']:.1f}"
        f" s launch, one-process references {out['algos_refs_secs']:.1f} s): "
        f"every result equal to one process's: "
        f"{json.dumps({k: v for k, v in out['algos'].items() if k != 'launches'})}"
        f"; Galerkin launches {out['algos']['launches']}")
    return out


def algos_refs(seed: int, dev, d: str) -> dict:
    """The one-process references of the ``"algos"`` launch's host-paced
    cases at their cut sizes, on a 4x4 grid of the card, each timed:
    ``rcm_order_dist`` of the relabelled ``POD_RCM_SIDE``^3 stencil (equal
    to :func:`host_rcm`'s ``"min_label"`` order; its entries saved to
    ``d/rcm_graph.npz`` for the workers), ``md_order_dist`` of the
    ``POD_MD_SIDE``^2 stencil (equal to ``md_order``), and the three
    matchings of the scale-``POD_MATCH_SCALE`` weighted R-MAT (checked on
    the host, the maximum cardinalities equal to scipy's): digests of
    the results, as the processes hold them."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    from combblas_tpu_torch.models.ordering import (
        md_order,
        md_order_dist,
        rcm_order_dist,
    )
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.parallel import matching as pm
    grid = ProcGrid.make(DIST_SIDE, DIST_SIDE, device=dev)
    nproc = POD_SCENARIOS["algos"]
    out = {}
    k = POD_RCM_SIDE
    n = k ** 3
    dm, _ = relabelled_stencil(seed, dev, k, grid)
    loc = dm.to_local()
    nnz = int(loc.nnz)
    row, col, val = (x[:nnz].cpu().numpy() for x in (loc.row, loc.col,
                                                      loc.val))
    del loc
    np.savez(os.path.join(d, "rcm_graph.npz"), row=row, col=col, val=val,
             n=np.asarray(n))
    order, secs = _timed(lambda: rcm_order_dist(dm), dev)
    if not np.array_equal(order, host_rcm(row.astype(np.int64),
                                          col.astype(np.int64), n)[
                                              "min_label"]):
        raise AssertionError(f"rcm_order_dist of the {k}^3 stencil differs "
                             "from the host Cuthill-McKee")
    out["rcm"] = dict(digest=vec_digest(torch.from_numpy(order)), secs=secs,
                      n=n, nnz=nnz)
    k = POD_MD_SIDE
    n = k * k
    r, c, v = stencil(k, 2, dev, diagonal=False)
    want = md_order(SpCOO.from_arrays(r.cpu().numpy(), c.cpu().numpy(),
                                      v.cpu().numpy(), (n, n), device=dev))
    order, secs = _timed(lambda: md_order_dist(_grid_dist(r, c, v, n, grid)),
                         dev)
    if not torch.equal(order, want):
        raise AssertionError("md_order_dist differs from md_order")
    out["md"] = dict(digest=vec_digest(order), secs=secs, n=n)
    a = weighted_rmat(seed, dev, POD_MATCH_SCALE)
    m, n = a.shape
    k = int(a.nnz)
    row = a.row[:k].cpu().numpy().astype(np.int64)
    col = a.col[:k].cpu().numpy().astype(np.int64)
    keys = row * n + col
    scipy_max = int((maximum_bipartite_matching(csr_matrix(
        (np.ones(k, np.int8), (row, col)), shape=(m, n)),
        perm_type="column") >= 0).sum())
    dm = DistSpMat.from_local(a, grid)
    for name in ("dist_bp_maximal", "dist_bp_maximum", "dist_awpm"):
        (mr, mc), secs = _timed(lambda fn=getattr(pm, name): fn(dm), dev)
        card = check_matching(keys, row, col, n, mr[:m], mc[:n],
                              name == "dist_bp_maximal")
        if name != "dist_bp_maximal" and card != scipy_max:
            raise AssertionError(f"{name}: cardinality {card}, scipy "
                                 f"{scipy_max}")
        out[name] = dict(row=slice_digests(mr, nproc),
                         col=slice_digests(mc, nproc), secs=secs,
                         cardinality=card)
    out["matching"] = dict(scale=POD_MATCH_SCALE, nnz=k,
                           scipy_maximum=scipy_max)
    return out


def check_pod_algos(ranks, refs: dict, one: dict) -> dict:
    """The ``"algos"`` launch against one process of this run: every
    digest equal (``refs`` from phases 17, 21, 23 and 24; ``one`` from
    :func:`algos_refs`), the Galerkin products' launches (summed over the
    processes) K3/K4 on 4x4 and K1/K2 on 16x16.  Returns each case's
    seconds (the slowest process's) beside one process's, the launches
    and every worker's peak."""
    got = [r["algos"] for r in ranks]

    def same(label: str, mine, want) -> None:
        if mine != want:
            raise AssertionError(f"{label} across {len(ranks)} processes "
                                 "differs from one process's")

    def secs(fn) -> float:
        return max(fn(x) for x in got)

    out = {}
    for name, _sr in POD_SPMM:
        same(f"dist_spmm {name}", [x[f"spmm_{name}"]["digest"] for x in got],
             refs["spmm"][name]["digests"])
        out[f"dist_spmm_{name}"] = dict(
            secs=secs(lambda x: x[f"spmm_{name}"]["secs"]),
            one_process_secs=refs["spmm"][name]["secs"])
    same("betweenness_centrality_dist", [x["bc"]["digest"] for x in got],
         [refs["bc"]["digest"]] * len(got))
    out["bc"] = dict(secs=secs(lambda x: x["bc"]["secs"]),
                     one_process_secs=refs["bc"]["secs"])
    f = refs["filtered"]
    _same_digests([x["filtered"] for x in got], "materialize", f["mat"],
                  "materialize_filtered_dist across processes")
    for i, want in enumerate(f["bfs"]):
        for key in ("parents", "levels"):
            same(f"bfs_within_dist from {want['root']} ({key})",
                 [x["filtered"]["bfs"][i][key] for x in got], want[key])
    same("mis_filtered_dist", [x["filtered"]["mis"]["digest"] for x in got],
         f["mis"])
    out["filtered"] = dict(
        materialize=dict(secs=secs(lambda x: x["filtered"]["materialize"][
            "secs"]), one_process_secs=f["secs"]["materialize"]),
        bfs=[dict(root=want["root"], secs=secs(
            lambda x, i=i: x["filtered"]["bfs"][i]["secs"]),
            one_process_secs=want["secs"]) for i, want in enumerate(
                f["bfs"])],
        mis=dict(secs=secs(lambda x: x["filtered"]["mis"]["secs"]),
                 one_process_secs=f["secs"]["mis"]))
    out["dense"] = dict(n=got[0]["dense"]["n"], secs={
        k: secs(lambda x, k=k: x["dense"]["secs"][k])
        for k in got[0]["dense"]["secs"]})
    for name in ("rcm", "md"):
        same(name, [x[name]["digest"] for x in got],
             [one[name]["digest"]] * len(got))
        out[name] = dict(n=one[name]["n"], secs=secs(
            lambda x, name=name: x[name]["secs"]),
            one_process_secs=one[name]["secs"])
    for name in ("dist_bp_maximal", "dist_bp_maximum", "dist_awpm"):
        for key in ("row", "col"):
            same(f"{name} ({key})", [x[name][key] for x in got],
                 one[name][key])
        out[name] = dict(secs=secs(lambda x, name=name: x[name]["secs"]),
                         one_process_secs=one[name]["secs"],
                         cardinality=one[name]["cardinality"])
    mg = refs["mg"]
    same("mis2_dist", [x["multigrid"]["mis2_dist"]["digest"] for x in got],
         [mg["mis2"]] * len(got))
    multi = [x["multigrid"] for x in got]
    _same_digests(multi, "restriction_op_dist", mg["r"],
                  "restriction_op_dist across processes")
    _same_digests(multi, "galerkin_dist", mg["galerkin"],
                  "galerkin_dist 4x4 across processes")
    _same_digests(multi, "galerkin_dist_packed", mg["packed"],
                  f"galerkin_dist {MG_PACKED_SIDE}x{MG_PACKED_SIDE} across "
                  "processes")
    launches = {key: _sum_launches(multi, key)
                for key in ("galerkin_dist", "galerkin_dist_packed")}
    for key, names in (("galerkin_dist", ("expand_i64", "compress_i64")),
                       ("galerkin_dist_packed", ("expand_i32",
                                                 "compress_i32"))):
        if any(launches[key].get(k, 0) < 1 for k in names):
            raise AssertionError(f"pod {key} launched {launches[key]}, want "
                                 f"{names}")
    out["multigrid"] = {key: dict(secs=secs(lambda x, key=key: x[
        "multigrid"][key]["secs"]), one_process_secs=mg["secs"][key])
        for key in ("mis2_dist", "restriction_op_dist", "galerkin_dist",
                    "galerkin_dist_packed")}
    out.update(launches=launches, matching=one["matching"],
               peak_gib=[x["peak_gib"] for x in got])
    return out


def check_pod_mcl_preprocess(ranks, ref: dict, d: str) -> dict:
    """The preprocessed pod MCL against phase 20 (``ref``, from
    :func:`mcl_preprocess_full`): the iteration count equal; every
    process's label slice, put together and cut to n, equal to phase 20's
    labels bit for bit, phase 20's isolated count among them; K1 and K2,
    summed over the processes, launched at least once each an iteration.
    Reports the slowest process's seconds and every worker's peak beside
    phase 20's."""
    iters = ref["iters"]
    got = [r["mcl_preprocess"]["iters"] for r in ranks]
    if got != [iters] * len(ranks):
        raise AssertionError(f"mcl_dist(preprocess=True) across processes: "
                             f"iterations {got}, phase 20 took {iters}")
    want = ref["labels"]
    n = want.shape[0]
    labels = np.concatenate([np.load(os.path.join(
        d, f"mcl_preprocess_labels_rank{r['rank']}.npy")) for r in ranks])[:n]
    if not np.array_equal(labels, want):
        raise AssertionError("mcl_dist(preprocess=True) across processes: "
                             "labels differ from phase 20's")
    isolated = int((labels >= n).sum())
    if isolated != ref["isolated"]:
        raise AssertionError(f"mcl_dist(preprocess=True) across processes: "
                             f"{isolated} isolated vertices, phase 20 had "
                             f"{ref['isolated']}")
    launches = _sum_launches(ranks, "mcl_preprocess")
    _k1k2_each_iteration(launches, iters,
                         "mcl_dist(preprocess=True) across processes")
    out = dict(
        grid=[DIST_SIDE, DIST_SIDE], processes=len(ranks), iters=iters,
        isolated=isolated, clusters=int(np.unique(labels).size),
        **_pod_mcl_secs(ranks, "mcl_preprocess", iters), launches=launches,
        one_process=ref["one"])
    secs = out["iter_secs"]
    one = ref["one"]
    log(f"  mcl_dist(preprocess=True) across 4 processes, 4x4: {iters} "
        f"iterations, {isolated} isolated vertices and labels "
        f"({out['clusters']} distinct) equal phase 20's; launches "
        f"{launches}; first {secs[0]:.4f} s, steady "
        f"{out['steady_secs_per_iter']:.4f} s/iter, total "
        f"{out['total_secs']:.3f} s, rest (preprocessing, normalisation, "
        f"transpose, FastSV, labels back) {out['rest_secs']:.3f} s, peak GiB "
        f"per worker {[round(x, 2) for x in out['peak_gib']]}; one process "
        f"(phase 20): first {one['first_iter_secs']:.4f} s, steady "
        f"{one['steady_secs_per_iter']:.4f} s/iter, total "
        f"{one['total_secs']:.3f} s, peak {one['peak_mem_gb']:.2f} GiB")
    return out


def _pod_mcl_secs(ranks, key: str, iters: int) -> dict:
    """The slowest process's seconds of the timed pod MCL run ``key``:
    each iteration's, the first, the steady (the median from the third
    on), the total and the rest; and every worker's peak."""
    secs = [max(r[key]["iter_secs"][i] for r in ranks)
            for i in range(iters)]
    steady = sorted(secs[2:] or secs)
    return dict(first_iter_secs=secs[0],
                steady_secs_per_iter=steady[len(steady) // 2],
                total_secs=max(r[key]["secs"] for r in ranks),
                rest_secs=max(r[key]["rest_secs"] for r in ranks),
                iter_secs=secs, peak_gib=[r[key]["peak_gib"] for r in ranks])


def check_pod_summa3d(ranks, one: dict) -> dict:
    """The layered pod's A² against one process's (:func:`summa3d_one`):
    the caps equal in every process, every block equal by digest (nnz
    included), the compress kernel launched twice a block of a layer over
    the processes (:func:`summa3d_launches`).  Reports the
    slowest process's seconds and every worker's peak beside one
    process's."""
    for r in ranks:
        if r["summa3d_2x2x2"]["caps"] != one["caps"]:
            raise AssertionError(f"summa3d across processes: caps "
                                 f"{r['summa3d_2x2x2']['caps']}, one "
                                 f"process {one['caps']}")
    _same_digests(ranks, "summa3d_2x2x2", one["digests"],
                  f"summa3d_spgemm 2x2x2 across {len(ranks)} processes")
    launches = _sum_launches(ranks, "summa3d_2x2x2")
    want = summa3d_launches([2, 2, 2], ranks[0]["summa3d_2x2x2"][
        "block_shape"])
    if launches != want:
        raise AssertionError(f"summa3d across processes launched "
                             f"{launches}, want {want}")
    out = dict(grid=[2, 2, 2], processes=len(ranks), scale=POD_3D_SCALE,
               launches=launches, secs=max(r["summa3d_2x2x2"]["secs"] for r in ranks),
               peak_gib=[r["summa3d_2x2x2"]["peak_gib"] for r in ranks],
               nnz=one["nnz"], caps=one["caps"],
               one_process_secs=one["secs"], one_process_times=one["times"],
               one_process_peak_gib=one["peak_gib"])
    log(f"  summa3d_spgemm (2, 2, 2) of the scale-{POD_3D_SCALE} A² over "
        f"{len(ranks)} processes: every block equals one process's, caps "
        f"{one['caps']}; {out['secs']:.3f} s (one process "
        f"{one['secs']:.4f}), peak GiB a worker "
        f"{[round(x, 2) for x in out['peak_gib']]} (one process "
        f"{one['peak_gib']:.2f})")
    return out


def check_pod_mcl_layers(ranks, ref: dict, d: str) -> dict:
    """The layered pod MCL against phase 18's one-process scale-12
    ``mcl_dist(layers=2, phases=2)``: the iterations equal, the label
    slices put together equal bit for bit, the final iterate's blocks
    equal by digest.  Reports the slowest process's seconds and every
    worker's peak beside one process's."""
    got = [r["mcl_layers"]["iters"] for r in ranks]
    if got != [ref["iters"]] * len(ranks):
        raise AssertionError(f"mcl_dist(layers=2) across processes: "
                             f"iterations {got}, one process {ref['iters']}")
    labels = np.concatenate([np.load(os.path.join(
        d, f"mcl_layers_labels_rank{r['rank']}.npy")) for r in ranks])
    if not np.array_equal(labels, ref["labels"]):
        raise AssertionError("mcl_dist(layers=2) across processes: labels "
                             "differ from one process's")
    _same_digests(ranks, "mcl_layers", ref["digests"],
                  "mcl_dist(layers=2) final iterate across processes")
    out = dict(grid=[2, MCL_DIST_CHECK_SIDE, MCL_DIST_CHECK_SIDE],
               processes=len(ranks), scale=ref["scale"],
               iters=ref["iters"],
               secs=max(r["mcl_layers"]["secs"] for r in ranks),
               peak_gib=[r["mcl_layers"]["peak_gib"] for r in ranks],
               launches=_sum_launches(ranks, "mcl_layers"),
               one_process_secs=ref["secs"],
               one_process_peak_gib=ref["peak_gib"])
    log(f"  mcl_dist(layers=2, phases=2) scale {ref['scale']}, "
        f"(2, {MCL_DIST_CHECK_SIDE}, {MCL_DIST_CHECK_SIDE}) over "
        f"{len(ranks)} processes: {ref['iters']} iterations, labels and the "
        f"final iterate's blocks equal one process's; {out['secs']:.3f} s "
        f"(one process {ref['secs']:.3f}), peak GiB a worker "
        f"{[round(x, 3) for x in out['peak_gib']]} (one process "
        f"{ref['peak_gib']:.3f})")
    return out


def check_pod_mcl(ranks, ref: dict, d: str) -> dict:
    """The pod MCL against phase 18 (``ref``, from :func:`mcl_dist_full`):
    the iteration count equal; every process's label slice, put together,
    equal to phase 18's labels bit for bit; every iterate's blocks equal to
    phase 18's by digest (nnz included); the ``phases=2`` run's third
    iterate equal to one process's; K1 and K2, summed over the processes,
    launched at least once each an iteration.  Reports the slowest
    process's seconds (each iteration's, first and steady, the run's total
    and its rest) and every worker's peak beside one process's."""
    iters = ref["iters"]
    got = [r["mcl"]["iters"] for r in ranks]
    if got != [iters] * len(ranks):
        raise AssertionError(f"mcl_dist across processes: iterations {got}, "
                             f"phase 18 took {iters}")
    labels = np.concatenate([np.load(os.path.join(
        d, f"mcl_labels_rank{r['rank']}.npy")) for r in ranks])
    if not np.array_equal(labels, ref["labels"]):
        raise AssertionError("mcl_dist across processes: labels differ from "
                             "phase 18's")
    for it in range(iters):
        want = sorted(tuple(x) for x in ref["digests"][it])
        if sorted(tuple(x) for r in ranks
                  for x in r["mcl"]["digests"][it]) != want:
            raise AssertionError(f"mcl_dist across processes: iterate "
                                 f"{it + 1}'s blocks differ from phase 18's")
    if sorted(tuple(x) for r in ranks for x in r["mcl"]["digests3"]) != \
            sorted(tuple(x) for x in ref["digests3"]):
        raise AssertionError(f"mcl_dist(phases=2) across processes: iterate "
                             f"{MCL_PHASES_ITERS}'s blocks differ from one "
                             "process's")
    launches = {}
    for r in ranks:
        for k, v in r["mcl"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    _k1k2_each_iteration(launches, iters, "mcl_dist across processes")
    out = dict(
        grid=[DIST_SIDE, DIST_SIDE], processes=len(ranks), phases=1,
        iters=iters, clusters=int(np.unique(labels).size),
        iterate_nnz=[sum(x[2] for x in ref["digests"][i])
                     for i in range(iters)],
        **_pod_mcl_secs(ranks, "mcl", iters), launches=launches,
        one_process=ref["one"])
    secs = out["iter_secs"]
    if out["iterate_nnz"] != ref["nnz"]:
        raise AssertionError("mcl_dist: phase 18's digests and nnz disagree")
    one = ref["one"]
    log(f"  mcl_dist across 4 processes, 4x4, phases=1: {iters} iterations "
        f"and labels ({out['clusters']} distinct) equal phase 18's, every "
        f"iterate's blocks equal by digest; phases=2 iterate "
        f"{MCL_PHASES_ITERS} equals one process's; launches {launches}")
    log(f"  pod MCL (slowest process): first {secs[0]:.4f} s, steady "
        f"{out['steady_secs_per_iter']:.4f} s/iter, total "
        f"{out['total_secs']:.3f} s, rest (normalisation, transpose, "
        f"FastSV) {out['rest_secs']:.3f} s, peak GiB per worker "
        f"{[round(x, 2) for x in out['peak_gib']]}; one process (phase 18): "
        f"first {one['first_iter_secs']:.4f} s, steady "
        f"{one['steady_secs_per_iter']:.4f} s/iter, total "
        f"{one['total_secs']:.3f} s, rest {one['rest_secs']:.3f} s, peak "
        f"{one['peak_mem_gb']:.2f} GiB")
    return out



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--check-scale", type=int, default=16)
    ap.add_argument("--pod-worker", nargs=5, default=None,
                    metavar=("SCENARIO", "RANK", "NPROC", "PORT", "DIR"),
                    help="run one process of phase 26's pod (started by "
                    "phase 26 itself)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase_secs = {}

    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.pod_worker is not None:
        sc, rank, nproc, port, d = args.pod_worker
        return pod_worker(sc, int(rank), int(nproc), int(port), d,
                          args.seed)
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
    launches, main_line, a22 = main_path(args.seed, args.scale, dev, details)
    torch.cuda.empty_cache()
    phase_secs["5"] = time.perf_counter() - t

    # 25. the classed seg digest of phase 5's matrix, one-process multihost
    t = time.perf_counter()
    log(f"phase 25: scale-{args.scale} A² classed seg digest of phase 5's "
        f"matrix, every slab; scale-{args.check_scale} against scipy; "
        f"one-process multihost")
    seg_line = seg_full(a22, main_line, dev, details)
    del a22
    torch.cuda.empty_cache()
    check_scipy(args.seed, args.check_scale, dev, classed=True)
    multihost_one_process()
    torch.cuda.empty_cache()
    phase_secs["25"] = time.perf_counter() - t

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

    # 17. distributed SpMV and its algorithms on phase 8's graph
    t = time.perf_counter()
    log(f"phase 17: dist_spmv, bfs_dist, bfs_dir_opt_dist, fastsv_dist, "
        f"lacc_dist, luby_mis_dist, scale-{GRAPH_SCALE} symmetrized R-MAT "
        f"on a {DIST_SIDE}x{DIST_SIDE} block grid")
    s21 = graphs["s"]        # phase 8's graph, for phases 19, 21 and 24
    roots21 = graphs["bfs_check"][0]
    pod_refs = dict(roots=np.asarray(roots21),
                    levels=graphs["bfs_check"][1].cpu().numpy())
    dist_line = dist_graph_full(s21, *graphs["bfs_check"], args.seed,
                                refs=pod_refs)
    log(json.dumps(dict(dist_line, scale=GRAPH_SCALE)))
    phase_secs["17"] = time.perf_counter() - t
    del graphs
    torch.cuda.empty_cache()

    # 9. K5 vs its plain version at phase 10's shape
    t = time.perf_counter()
    log(f"phase 9: expand_chunks (K5) vs plain, scale-{NARROW_SCALE} A²")
    a15 = a2_matrix(args.seed, dev, NARROW_SCALE)
    k9 = check_expand_chunks(a15)
    torch.cuda.empty_cache()
    details["phase9_adversarial"] = adversarial_expand_chunks(gen, dev)
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
    pod_refs.update({k: v.pop("digests") for k, v in summa_line.items()})
    log(json.dumps(dict(summa_line, scale=AUTO_SCALE)))
    phase_secs["13"] = time.perf_counter() - t

    # 14. ring SUMMA (K9) and 3D SUMMA
    t = time.perf_counter()
    log(f"phase 14: summa_spgemm_rma 4x4 and summa3d_spgemm 2x2x2 A², "
        f"scale-{AUTO_SCALE}")
    ring_line = grid_phase(cells[3:], c_ref, auto_line["flops"])
    pod_refs.update({k: v.pop("digests") for k, v in ring_line.items()})
    log(json.dumps(dict(ring_line, scale=AUTO_SCALE)))
    del cells, a17, c_ref
    torch.cuda.empty_cache()
    phase_secs["14"] = time.perf_counter() - t

    # 15. MCL at full size, then card against CPU
    t = time.perf_counter()
    log(f"phase 15: mcl_local, bench_mcl's configuration, scale-{MCL_SCALE}"
        f" SSCA ef-{MCL_EDGEFACTOR} R-MAT, {MCL_DEADLINE_SECS:.0f} s budget")
    a_mcl = mcl_graph(args.seed, dev, MCL_SCALE)
    mcl_line = mcl_full(a_mcl)
    torch.cuda.empty_cache()
    mcl_line["card_vs_cpu"] = mcl_card_vs_cpu(args.seed, dev)
    log(json.dumps(mcl_line))
    phase_secs["15"] = time.perf_counter() - t

    # 16. indexing: spref (K1/K2) and induced_subgraph
    t = time.perf_counter()
    log(f"phase 16: spref and induced_subgraph of the scale-{MCL_SCALE} "
        f"graph on half its vertices")
    index_line = indexing_full(a_mcl, args.seed)
    log(json.dumps(index_line))
    torch.cuda.empty_cache()
    phase_secs["16"] = time.perf_counter() - t

    # 18. distributed HipMCL on phase 15's graph, then card against CPU
    t = time.perf_counter()
    log(f"phase 18: mcl_dist, phase 15's graph with self loops, "
        f"{DIST_SIDE}x{DIST_SIDE} grid, phases=1")
    mcl_dist_line = mcl_dist_full(a_mcl, args.seed, mcl_line, pod_refs)
    torch.cuda.empty_cache()
    mcl_dist_line["card_vs_cpu"] = mcl_dist_card_vs_cpu(args.seed, dev,
                                                        refs=pod_refs)
    log(json.dumps(mcl_dist_line))
    torch.cuda.empty_cache()
    phase_secs["18"] = time.perf_counter() - t

    # 19. the distributed vector layer and indexing
    t = time.perf_counter()
    grid44 = ProcGrid.make(DIST_SIDE, DIST_SIDE, device=dev)
    log(f"phase 19: dist_sort / dist_sort_auto of 2^{SORT_LOG2} float32, "
        f"the vector functions at {VEC_LEN}, dist_permute of phase 17's "
        f"graph, dist_spref / dist_prune_block / dist_spasgn of phase 15's, "
        f"{DIST_SIDE}x{DIST_SIDE}")
    vector_line = dict(sorts=check_sorts(grid44, gen),
                       vectors=check_vectors(grid44, gen, refs=pod_refs))
    torch.cuda.empty_cache()
    vector_line["permute"] = permute_full(s21, args.seed, refs=pod_refs)
    torch.cuda.empty_cache()
    vector_line["indexing"] = dist_indexing_full(a_mcl, args.seed,
                                                 refs=pod_refs)
    log(json.dumps(vector_line))
    torch.cuda.empty_cache()
    phase_secs["19"] = time.perf_counter() - t

    # 20. HipMCL with its preprocessing
    t = time.perf_counter()
    log(f"phase 20: mcl_dist(preprocess=True), phase 15's graph with self "
        f"loops on its vertices of degree >= 1, {DIST_SIDE}x{DIST_SIDE}")
    preprocess_line = mcl_preprocess_full(a_mcl, args.seed, refs=pod_refs)
    del a_mcl
    torch.cuda.empty_cache()
    preprocess_line["card_vs_cpu"] = mcl_preprocess_card_vs_cpu(args.seed,
                                                                dev)
    log(json.dumps(preprocess_line))
    torch.cuda.empty_cache()
    phase_secs["20"] = time.perf_counter() - t

    # 21. the orderings and betweenness centrality
    t = time.perf_counter()
    log(f"phase 21: rcm_order(_dist) of the {RCM_SIDE}^3 stencil, "
        f"md_order(_dist) of the {MD_SIDE}x{MD_SIDE} stencil, "
        f"betweenness_centrality(_dist) of phase 8's graph")
    order_line = dict(rcm=rcm_full(args.seed, dev))
    torch.cuda.empty_cache()
    order_line["md"] = md_full(dev)
    order_line["bc"] = bc_full(s21, args.seed, refs=pod_refs)
    torch.cuda.empty_cache()
    order_line["bc"]["card_vs_cpu"] = bc_card_vs_cpu(args.seed, dev)
    log(json.dumps(order_line))
    phase_secs["21"] = time.perf_counter() - t

    # 22. bipartite matchings, local and on the grid
    t = time.perf_counter()
    log(f"phase 22: matchings of the scale-{MATCH_SCALE} G500 R-MAT, local "
        f"and {DIST_SIDE}x{DIST_SIDE}")
    torch.cuda.reset_peak_memory_stats()
    match_line = matching_full(args.seed, dev)
    match_line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps(match_line))
    torch.cuda.empty_cache()
    phase_secs["22"] = time.perf_counter() - t

    # 23. MIS-2, restriction and Galerkin products
    t = time.perf_counter()
    log(f"phase 23: mis2_dist / restriction_op_dist / galerkin(_dist) of "
        f"the {RCM_SIDE}^3 stencil, {DIST_SIDE}x{DIST_SIDE}; local "
        f"restriction_op at {MG_LOCAL_SIDE}^3")
    torch.cuda.reset_peak_memory_stats()
    mg_line = multigrid_full(args.seed, dev, refs=pod_refs)
    mg_line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(json.dumps(mg_line))
    torch.cuda.empty_cache()
    phase_secs["23"] = time.perf_counter() - t

    # 24. filtered traversals, semantic graphs, I/O and the CLI
    t = time.perf_counter()
    log(f"phase 24: TwitterGraph over phase 8's graph, filtered BFS / MIS "
        f"local and {DIST_SIDE}x{DIST_SIDE}, block-streamed I/O at scale "
        f"{IO_SCALE}, the CLI")
    torch.cuda.reset_peak_memory_stats()
    semantic_line = semantic_io_cli_full(s21, roots21, args.seed,
                                         refs=pod_refs)
    semantic_line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del s21
    log(json.dumps(semantic_line))
    torch.cuda.empty_cache()
    phase_secs["24"] = time.perf_counter() - t

    # 26. the pod: block grids over several processes on the one card
    t = time.perf_counter()
    log(f"phase 26: the pod on one card: summa_spgemm_auto 2x2 over 2 "
        f"processes and 4x4 over 4, summa_spgemm_rma 4x4 (K9 across "
        f"processes), bfs_dist / lacc_dist / luby_mis_dist / dist_permute "
        f"of phase 8's graph, dist_sort_auto 2^{POD_SORT_LOG2}, phase 19's "
        f"vector calls and SpRef / SpAsgn, cooperative I/O at scale "
        f"{IO_SCALE}, summa3d_spgemm (2, 2, 2) of the scale-{POD_3D_SCALE}"
        f" A² over 4 processes; mcl_dist of phase 18's matrix and "
        f"mcl_dist(preprocess=True) of phase 20's, 4x4 over 4 processes, "
        f"phase 18's layered scale-12 mcl_dist over 4; "
        f"item 1.8's step 3 (dense SpMM, BC, RCM, MD, matchings, "
        f"multigrid, filtered traversals), 4x4 over 4 processes")
    torch.cuda.empty_cache()
    pod_line = pod_full(args.seed, pod_refs, dev)
    log(json.dumps(pod_line))
    phase_secs["26"] = time.perf_counter() - t

    launches.update(ell_sum=spmm_line["launches"]["ell_sum"],
                    spmm_coo=spmm_line["launches"]["spmm_coo"],
                    ell_max=bfs_line["ell_max_launches"],
                    expand_chunks_i32=narrow_line["k5"]["launches"][
                        "expand_chunks_i32"],
                    ring_shift=ring_line["summa_spgemm_rma 4x4"][
                        "launches"]["ring_shift"],
                    ring_shift_pod=pod_line["launches"]["rma_4x4"][
                        "ring_shift_pod"],
                    winsort_narrow=seg_line["launches"].get(
                        "winsort_narrow", 0),
                    winsort_wide=seg_line["launches"].get("winsort_wide", 0))
    # K10's two regimes run in one call: both rows carry that call's times
    measured = dict(k3, expand_chunks_i32=k9, ring_shift=k12["phase14"],
                    ring_shift_pod=dict(pod_line["k9"]["main"],
                                        library_ms=None),
                    winsort_narrow=seg_line["k10"],
                    winsort_wide=seg_line["k10"],
                    winsort_rows=auto_line["k10_rows"])
    for name, rows in k6.items():
        measured[name] = dict(rows[0], max_abs_err=max(
            r["max_abs_err"] for r in rows))
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    **{k: measured[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
               for name in KERNELS]
    for k in kernels:    # K1-K4 also carry the MCL and indexing paths
        if k["name"] in ("expand_i32", "compress_i32", "expand_i64",
                         "compress_i64"):
            k.update(launches_mcl=mcl_line["launches"].get(k["name"], 0),
                     launches_mcl_dist=mcl_dist_line["launches"].get(
                         k["name"], 0),
                     launches_spref=index_line["spref"]["launches"].get(
                         k["name"], 0),
                     launches_dist_indexing=vector_line["indexing"][
                         "launches"].get(k["name"], 0),
                     launches_mcl_preprocess=preprocess_line[
                         "launches"].get(k["name"], 0),
                     launches_galerkin=mg_line["launches"].get(k["name"],
                                                               0),
                     launches_pod_mcl=pod_line["launches"]["mcl"].get(
                         k["name"], 0),
                     launches_pod_dist_indexing=sum(
                         pod_line["launches"][c].get(k["name"], 0)
                         for c in ("spref", "spasgn")),
                     launches_pod_mcl_preprocess=pod_line["launches"][
                         "mcl_preprocess"].get(k["name"], 0),
                     launches_pod_galerkin=pod_line["launches"][
                         "galerkin"].get(k["name"], 0),
                     launches_seg=seg_line["launches"].get(k["name"], 0),
                     launches_summa3d=ring_line["summa3d_spgemm 2x2x2"][
                         "launches"].get(k["name"], 0),
                     launches_pod_summa3d=pod_line["summa3d"][
                         "launches"].get(k["name"], 0))
    for name, n_launch in launches.items():
        if n_launch < 1:
            raise AssertionError(f"{name} was not launched on its path")
    phase_secs["all"] = time.perf_counter() - t_start
    log(f"phase seconds: {json.dumps(phase_secs)}")
    details.update(kernels=kernels, phase3=k3, phase6=k6, spmm=spmm_line,
                   bfs=bfs_line, phase9=k9, narrow=narrow_line,
                   auto=auto_line, seg=seg_line, phase12=k12,
                   summa=summa_line, ring_3d=ring_line, mcl=mcl_line,
                   indexing=index_line, dist=dist_line,
                   mcl_dist=mcl_dist_line,
                   vectors=vector_line, mcl_preprocess=preprocess_line,
                   orderings=order_line, matching=match_line,
                   multigrid=mg_line, semantic_io_cli=semantic_line,
                   pod=pod_line, phase_secs=phase_secs)
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
