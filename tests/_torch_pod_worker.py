"""One process of a pod of the port, for ``tests/test_torch_pod.py``.

``python tests/_torch_pod_worker.py RANK NPROC HOST:PORT SIDE OUTDIR``
joins a ``gloo`` group of NPROC CPU processes, builds a SIDE x SIDE block
grid spread over them (``pod_grid``) and runs, across the process boundary,
every function of the pod slice on the inputs of :func:`inputs` (seeded
numpy, or the port's R-MAT from a seed, which the test's parent rebuilds):
SUMMA (``summa_bounds``, ``summa_spgemm``, ``summa_spgemm_auto``), the ring
SUMMA and its hop (K9's plain version through ``gloo``), ``dist_spmv``,
``bfs_dist`` and ``bfs_dir_opt_dist``, ``dist_sort_auto``, the cooperative
writes and read, ``to_dense``, HipMCL's path (the distributed elementwise
ops, reductions, k-selects and transpose, the staged and phased SpGEMM,
the sampling estimate, ``dist_mcl_prune``, ``mcl_dist`` and
``fastsv_dist``), HipMCL's preprocessing and what lies under it (the
vector layer's RandPerm, routes, gathers, Invert and Uniq; the selectors,
SpRef, the block prune, SpAsgn and ``dist_permute``;
``dist_remove_isolated``, ``dist_rand_permute`` and
``mcl_dist(preprocess=True)``, also with the permutation the parent
writes to OUTDIR/jax_perm.npy on 2x2), ``lacc_dist``, ``luby_mis_dist``,
the dense matrices and ``dist_spmm``, betweenness centrality, the
orderings (RCM, minimum degree), the three matchings, the multigrid setup
(MIS-2, its check, R and R·A·Rᵀ) and the filtered traversals, and the
layered grid (:func:`layered`: the 3D SUMMA, its phased form and bounds,
and ``mcl_dist(layers=2)``).  Each process saves
what it holds to OUTDIR/rankR.npz; the parent compares.  Imports no JAX.
"""

import json
import os
import sys

import numpy as np

SEED = 60
#: The sort's padded length and true prefix.
SORT_PAD, SORT_LEN = 64, 61
BFS_N = 37
BFS_ROOTS = (0, 5)
#: Hand-written triples (1-based, duplicates, out of order) of the read.
READ_SHAPE = (9, 11)
#: The k of the column k-selects, and the candidate cap of a per-column k.
KSELECT_K, KSELECT_CAP = 3, 4
#: The phased SpGEMM's per-device budget (bytes) when the phase count comes
#: from the sampling estimate: small enough for several phases.
PHASE_BUDGET = 3000.0
#: ``dist_mcl_prune``'s parameters (select, recovery and its fallback).
PRUNE_PARAMS = dict(select=6, recover_num=9, cutoff=0.01, recover_pct=0.9)
#: ``mcl_dist``'s parameters on the scale-7 R-MAT.
MCL_PARAMS = dict(max_iters=30, select=8, recover_num=10)
#: The vector layer's padded length (a multiple of the 4x4 grid's 16
#: blocks) and the RandPerm's n (padding slots behind it).
VEC_PAD, PERM_N = 96, 93
#: Seeds of the port's own draws: the RandPerm, the preprocessing's
#: permutation and the MIS priorities.
PERM_SEED, PRE_SEED, MIS_SEED = 7, 8, 9
#: SpRef's row and column indices (repeats, out of order) into the 30 x 26
#: matrix ``a``, and SpAsgn's (distinct).
SPREF_ROWS = (3, 0, 17, 17, 29, 8, 12, 3, 21)
SPREF_COLS = (25, 1, 1, 9, 14, 0, 22)
SPASGN_ROWS = (4, 27, 11, 0, 19, 8)
SPASGN_COLS = (2, 13, 25, 7, 18)
#: The dense operand's width, BC's batch, the RCM start, the sides of the
#: minimum-degree stencil (2D) and the multigrid stencil (3D), and the
#: seeds of the MIS-2 / R and the filtered MIS draws.
SPMM_D, BC_BATCH, RCM_START, MD_SIDE, MG_SIDE = 5, 16, 5, 5, 8
MG_SEED, FMIS_SEED = 11, 12


def rand_sparse(m, n, density, seed):
    """``tests/test_coo.py``'s generator, without its imports."""
    rng = np.random.default_rng(seed)
    dense = rng.random((m, n)).astype(np.float32)
    dense[rng.random((m, n)) > density] = 0.0
    return dense


def inputs(seed: int = SEED) -> dict:
    """The scenario's inputs, the same in every process and the parent."""
    rng = np.random.default_rng(seed)
    g = rand_sparse(BFS_N, BFS_N, 0.08, seed + 2)
    g = ((g + g.T) > 0).astype(np.float32)
    np.fill_diagonal(g, 0.0)
    x = rng.standard_normal(SORT_PAD).astype(np.float32)
    x[:8] = x[8:16]                      # duplicates
    x[16:20] = np.array([0x80000000, 0, 0x7FC00000, 0xFF800000],
                        np.uint32).view(np.float32)   # -0, +0, NaN, -inf
    tri_r = rng.integers(1, READ_SHAPE[0] + 1, 40)
    tri_c = rng.integers(1, READ_SHAPE[1] + 1, 40)
    tri_v = (rng.integers(-8, 8, 40) / 4.0).astype(np.float32)
    a = rand_sparse(30, 26, 0.2, seed)
    a2 = rand_sparse(30, 26, 0.3, seed + 3)
    kv = rng.integers(0, KSELECT_CAP + 2, 26).astype(np.int32)
    return dict(a=a, b=rand_sparse(26, 34, 0.2, seed + 1), g=g, a2=a2,
                spmv_x=rng.standard_normal(BFS_N).astype(np.float32),
                sort_x=x, sort_p=np.arange(SORT_PAD, dtype=np.int32),
                tri=(tri_r, tri_c, tri_v),
                row_x=rng.standard_normal(30).astype(np.float32),
                col_x=rng.standard_normal(26).astype(np.float32),
                thresh=rng.random(26).astype(np.float32) * 0.6,
                kvec=kv, expansion=expansion(), comps=components(seed + 4))


def expansion(n=64, seed=40):
    """An expansion-like matrix: about half of each column filled,
    columns summing to about 1, values spread over two decades."""
    d = rand_sparse(n, n, 0.5, seed=seed) ** 4
    return (d / np.maximum(d.sum(0), 1e-9)[None, :]).astype(np.float32)


def components(seed, sizes=(9, 7, 12, 1, 5, 1, 6)):
    """A symmetric graph of several components (two of them isolated
    vertices), its vertices shuffled so that every component spreads over
    the processes."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    d = np.zeros((n, n), np.float32)
    lo = 0
    for k in sizes:
        blk = (rng.random((k, k)) < 0.4).astype(np.float32)
        blk[np.arange(k - 1), np.arange(1, k)] = 1.0      # a path: connected
        d[lo:lo + k, lo:lo + k] = blk
        lo += k
    d = ((d + d.T) > 0).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    perm = rng.permutation(n)
    return d[np.ix_(perm, perm)]


def special_floats(rng, n):
    """Normal floats with -0.0, +0.0, both infinities and NaNs of either
    sign and several payloads among them."""
    x = rng.standard_normal(n).astype(np.float32)
    specials = np.array([0x80000000, 0x00000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF,
                         0x7F800001], np.uint32).view(np.float32)
    x[rng.choice(n, 2 * specials.size, replace=False)] = np.tile(specials, 2)
    return x


def vec_inputs(seed: int = SEED + 10) -> dict:
    """The vector layer's inputs, all of length ``VEC_PAD``: RandPerm keys;
    route pairs (every slot hit about twice, some masked out, some past the
    vector, a few negative) with float and int values; gather indices past
    both ends; Invert values with duplicates; Uniq values: floats with
    -0.0 and NaNs of which one value fills 60 live slots (its sorted run
    crosses a slice boundary on every pod), ints, and the pad-key case (a
    live NaN of bits 0x7FFFFFFF beside a dead slot, which comes first or
    last)."""
    rng = np.random.default_rng(seed)
    n = VEC_PAD
    ridx = rng.integers(0, n // 2, n).astype(np.int32)
    ridx[rng.choice(n, 6, replace=False)] = n + 3
    ridx[rng.choice(n, 4, replace=False)] = -rng.integers(1, 20, 4)
    uf = special_floats(rng, n)
    run = rng.choice(n, 60, replace=False)
    uf[run] = uf[run[0]] if np.isfinite(uf[run[0]]) else 0.5
    umask = rng.random(n) < 0.75
    umask[run] = True
    pad = np.full(n, 0x7FFFFFFF, np.uint32).view(np.float32)
    pad[::3] = np.arange(0, n, 3, dtype=np.float32)
    pad_mask = [np.ones(n, bool), np.ones(n, bool)]
    pad_mask[0][1] = False          # a dead slot before every live NaN
    pad_mask[1][n - 1] = False      # a dead slot after them
    return dict(
        keys=rng.integers(0, 1 << 32, n, dtype=np.int64),
        ridx=ridx, rmask=rng.random(n) < 0.8,
        rval_f=rng.standard_normal(n).astype(np.float32),
        rinit_f=rng.standard_normal(n).astype(np.float32),
        rval_i=rng.integers(-50, 50, n).astype(np.int32),
        rinit_i=rng.integers(-50, 50, n).astype(np.int32),
        gx=rng.standard_normal(n).astype(np.float32),
        gidx=rng.integers(-5, n + 5, n).astype(np.int32),
        inv=rng.integers(0, n // 3, n).astype(np.int32),
        inv_mask=rng.random(n) < 0.7,
        uniq_f=uf, uniq_f_mask=umask,
        uniq_i=rng.integers(0, 30, n).astype(np.int32),
        uniq_i_mask=rng.random(n) < 0.75,
        uniq_pad0=pad, uniq_pad0_mask=pad_mask[0],
        uniq_pad1=pad, uniq_pad1_mask=pad_mask[1])


def index_inputs(seed: int = SEED + 11) -> dict:
    """SpAsgn's operand, ``dist_permute``'s maps: a permutation of the BFS
    graph's vertices, and maps of ``a``'s rows and columns that send
    several entries to one place (and drop a few)."""
    rng = np.random.default_rng(seed)
    rmap = rng.integers(0, 30, 30)
    rmap[rng.choice(30, 3, replace=False)] = -1
    cmap = rng.integers(0, 26, 26)
    cmap[rng.choice(26, 2, replace=False)] = 40
    return dict(asg=rand_sparse(len(SPASGN_ROWS), len(SPASGN_COLS), 0.5,
                                seed + 1),
                perm=rng.permutation(BFS_N), rmap=rmap, cmap=cmap)


def components_loops(seed=SEED + 4):
    """:func:`components` with a self loop on every vertex of degree >= 1
    (its two isolated vertices stay empty columns)."""
    d = components(seed)
    live = d.any(axis=0)
    d[live, live] = 1.0
    return d


def rmat7_isolated(seed=4):
    """The seeded scale-7 SSCA R-MAT of edgefactor 4, symmetrized, uniform
    weights, with self loops only on its vertices of degree >= 1
    (HipMCL's order): its isolated vertices stay empty columns."""
    import torch

    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    g = torch.Generator().manual_seed(seed)
    a = rmat_matrix(g, 7, 4, symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    row, col, _val, nnz, shape = a.to_numpy()
    w = np.random.default_rng(seed).uniform(0.5, 1.5, nnz).astype(np.float32)
    live = np.unique(row[:nnz])
    return (np.concatenate([row[:nnz], live]),
            np.concatenate([col[:nnz], live]),
            np.concatenate([w, np.ones(live.size, np.float32)]), shape)


def rmat7(seed=1):
    """A seeded scale-7 SSCA R-MAT, symmetrized, uniform(0.5, 1.5)
    weights, with self loops: (rows, cols, values, shape)."""
    import torch

    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    g = torch.Generator().manual_seed(seed)
    a = rmat_matrix(g, 7, 8, symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    row, col, _val, nnz, shape = a.to_numpy()
    n = shape[0]
    w = np.random.default_rng(seed).uniform(0.5, 1.5, nnz).astype(np.float32)
    r = np.concatenate([row[:nnz], np.arange(n)])
    c = np.concatenate([col[:nnz], np.arange(n)])
    return r, c, np.concatenate([w, np.ones(n, np.float32)]), shape


def stencil(k: int, dims: int) -> tuple:
    """The k^dims grid's (2 dims + 1)-point stencil, 2 dims on the
    diagonal, -1 off it: (rows, cols, values, n)."""
    n = k ** dims
    idx = np.arange(n).reshape((k,) * dims)
    rows, cols = [np.arange(n)], [np.arange(n)]
    for ax in range(dims):
        a = np.take(idx, np.arange(k - 1), axis=ax).reshape(-1)
        b = np.take(idx, np.arange(1, k), axis=ax).reshape(-1)
        rows += [a, b]
        cols += [b, a]
    r, c = np.concatenate(rows), np.concatenate(cols)
    v = np.where(r == c, 2.0 * dims, -1.0).astype(np.float32)
    return r, c, v, n


def md_stencil() -> tuple:
    """The minimum degree's graph: the 5-point stencil's pattern off the
    diagonal (its pattern SpMVs read positive values): (rows, cols, n)."""
    r, c, _v, n = stencil(MD_SIDE, 2)
    off = r != c
    return r[off], c[off], n


def codes_graph(seed: int = SEED + 12) -> np.ndarray:
    """The BFS graph with edge codes 1 or 2 (symmetric)."""
    g = inputs()["g"]
    w = 1.0 + (np.random.default_rng(seed).random(g.shape) < 0.5)
    w = np.triu(w, 1)
    return (g * (w + w.T)).astype(np.float32)


def heavy(v):
    return v > 1.5


def small(v):
    return v < 0.5


def doubled(v):
    return v * 2.0


def below(v, t):
    return v < t


def squared(v):
    return v * v


def hook(c):
    """The phased SpGEMM's hook: a prune of every slab product."""
    from combblas_tpu_torch.parallel.elementwise import dist_prune
    return dist_prune(c, lambda v: v < 0.3)


def write_triples(path: str, tri) -> None:
    """The read's input file: a MatrixMarket ``general`` header, then the
    triples one a line, duplicates and all."""
    r, c, v = tri
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n% pod\n")
        f.write(f"{READ_SHAPE[0]} {READ_SHAPE[1]} {len(r)}\n")
        for x in zip(r, c, v):
            f.write(f"{x[0]} {x[1]} {x[2]:.9g}\n")


def _stacks(m, tag, out):
    for f in ("row", "col", "val"):
        out[f"{tag}_{f}"] = getattr(m, f).numpy()
    out[f"{tag}_nnz"] = m.nnz.numpy()


def elementwise(g, inp, dist, out) -> None:
    """The 12 functions of ``parallel/elementwise.py``."""
    import torch

    from combblas_tpu_torch.parallel import elementwise as el
    from combblas_tpu_torch.parallel.dist import dist_vec
    from combblas_tpu_torch.semiring import MAX_FIRST, MIN_PLUS, PLUS_TIMES
    a, a2 = dist(inp["a"]), dist(inp["a2"])
    _stacks(el.dist_apply(a, doubled), "apply", out)
    _stacks(el.dist_prune(a, small), "prune", out)
    for ex in (False, True):
        _stacks(el.dist_ewise_mult(a, a2, exclude=ex), f"emult{int(ex)}",
                out)
    _stacks(el.dist_add(a, a2), "add", out)
    rx, cx = dist_vec(inp["row_x"], g), dist_vec(inp["col_x"], g)
    _stacks(el.dist_dim_apply(a, rx, "row"), "dimapply_row", out)
    _stacks(el.dist_dim_apply(a, cx, "col", torch.add), "dimapply_col", out)
    _stacks(el.dist_prune_column(a, dist_vec(inp["thresh"], g), below),
            "prunecol", out)
    for dim in ("row", "col"):
        for name, sr in (("plus", PLUS_TIMES), ("min", MIN_PLUS),
                         ("max", MAX_FIRST)):
            out[f"reduce_{dim}_{name}"] = el.dist_reduce(a, dim, sr).numpy()
    out["reduce_premap"] = el.dist_reduce(a, "col", premap=squared).numpy()
    out["nnz_per_col"] = el.dist_nnz_per_col(a).numpy()
    kv = dist_vec(inp["kvec"], g)
    out["ksel_int"] = el.dist_kselect_col(a, KSELECT_K).numpy()
    out["ksel_vec"] = el.dist_kselect_col(a, kv, k_cap=KSELECT_CAP).numpy()
    out["ksel_full"] = el.dist_kselect_col(a, kv, full_gather=True).numpy()
    out["ksel2_int"] = el.dist_kselect2_col(a, KSELECT_K).numpy()
    out["ksel2_vec"] = el.dist_kselect2_col(a, kv).numpy()
    out["ksel_checked"] = el.dist_kselect_col_checked(a, kv).numpy()
    _stacks(el.dist_transpose(a), "transpose", out)


def memefficient(g, inp, a, b, out) -> None:
    """``parallel/memefficient.py`` and the sampling estimate."""
    import torch

    from combblas_tpu_torch.parallel import memefficient as me
    from combblas_tpu_torch.parallel.spmv import est_nnz_spgemm_sampling
    from combblas_tpu_torch.parallel.summa import summa_bounds
    fc, oc = summa_bounds(a, b)
    _stacks(me.summa_spgemm_staged(a, b, stage_flops_cap=fc,
                                   out_capacity=oc), "staged", out)
    est = est_nnz_spgemm_sampling(a, b, torch.Generator().manual_seed(0))
    out["estimate"] = np.asarray(est)
    out["phases"] = np.asarray([
        me.calculate_phases(a, b, PHASE_BUDGET),
        me.calculate_phases(a, b, PHASE_BUDGET, est_c_nnz=est)])
    for ph in (1, 2):
        _stacks(me.mem_efficient_spgemm(a, b, phases=ph, impl="xla"),
                f"phased{ph}", out)
        _stacks(me.mem_efficient_spgemm(a, b, phases=ph), f"phased{ph}_k",
                out)
    _stacks(me.mem_efficient_spgemm(a, b, per_device_mem_bytes=PHASE_BUDGET),
            "phased_auto", out)
    _stacks(me.mem_efficient_spgemm(a, b, phases=2, phase_hook=hook,
                                    impl="xla"), "phased_hook", out)
    for (i, j), c in me.block_spgemm(a, b, 2, 2):
        _stacks(c, f"block{i}{j}", out)


def mcl(g, inp, dist, out) -> None:
    """``dist_mcl_prune`` and ``mcl_dist`` (its final iterate caught at
    the transpose)."""
    from combblas_tpu_torch.models import mcl as tmcl
    from combblas_tpu_torch.parallel.dist import DistSpMat
    e = dist(inp["expansion"])
    for k2 in (False, True):
        _stacks(tmcl.dist_mcl_prune(e, tmcl.MCLParams(**PRUNE_PARAMS),
                                    use_kselect2=k2), f"mclprune{int(k2)}",
                out)
    r, c, w, shape = rmat7()
    m = DistSpMat.from_coo_arrays(r, c, w, shape, g)
    seen, orig = {}, tmcl.dist_transpose

    def caught(x):
        seen["a"] = x
        return orig(x)

    tmcl.dist_transpose = caught
    try:
        labels, iters = tmcl.mcl_dist(m, tmcl.MCLParams(**MCL_PARAMS))
    finally:
        tmcl.dist_transpose = orig
    out["mcl_labels"] = labels.numpy()
    out["mcl_iters"] = np.asarray(iters)
    _stacks(seen["a"], "mcl_final", out)


#: The 3D SUMMA's output capacity that saturates some fibers of ``a`` x
#: ``b`` on the (2, side, side) grids, and the 4-layer overflow case's
#: (its fiber chunks hold 2048 entries).
SAT_CAP3, OVER_CAP4 = 24, 4096
#: The layered ``mcl_dist``'s R-MAT seed (``test_torch_mcl_dist.py``'s).
MCL3_SEED = 3


def overflow_pair(seed: int = SEED + 14):
    """Two 256 x 256 matrices whose 4-layer product on a 2x2 grid
    overflows the fiber (0, 0) only: A's columns 0-31 are dense in rows
    0-127 and empty below, B's rows 0-31 dense in columns 0-31 and empty
    beside (layer 0's partial block (0, 0) sends its 4096 entries to
    destination layer 0, whose chunk holds 2048); sparse entries
    elsewhere."""
    rng = np.random.default_rng(seed)
    a = rand_sparse(256, 256, 0.02, seed)
    b = rand_sparse(256, 256, 0.02, seed + 1)
    a[:128, :32] = rng.random((128, 32)).astype(np.float32) + 0.5
    a[128:, :32] = 0.0
    b[:32, :32] = rng.random((32, 32)).astype(np.float32) + 0.5
    b[:32, 32:] = 0.0
    return a, b


def doubled3(c):
    """The phased 3D SpGEMM's hook: every value of the phase doubled."""
    import dataclasses
    return dataclasses.replace(c, val=c.val * 2)


def _stacks3(m, tag, out):
    _stacks(m, tag, out)
    out[f"{tag}_origin3"] = np.asarray(m.grid.origin3())


def layered(g, side, inp, dist, out) -> None:
    """The layered grid over the processes: ``pod_grid(layers=2)``,
    ``Dist3DSpMat.from_dist2d`` ('col' from the pod's 2D ``a``, 'row' from
    ``b`` given whole), ``summa3d_bounds``, ``summa3d_spgemm`` (also at
    ``SAT_CAP3``, and on a 4-layer 2x2 grid whose fiber (0, 0) overflows),
    ``mem_efficient_spgemm3d(phases=2)`` with a hook, ``to_local``,
    ``to_dist2d`` and ``mcl_dist(layers=2, phases=2)`` (its final iterate
    caught at the transpose).  ``layered_ran`` names the calls that ran
    (none refuses a pod)."""
    from combblas_tpu_torch.models import mcl as tmcl
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.parallel import summa3d as t3
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.multihost import pod_grid
    ran = []
    g3 = pod_grid(layers=2, pr=side, pc=side, device="cpu")
    ran.append("pod_grid_layers")
    out["origin3"] = np.asarray(g3.origin3())
    out["local_shape3"] = np.asarray(g3.local_shape3())
    a3 = t3.Dist3DSpMat.from_dist2d(dist(inp["a"]), g3, "col")
    b3 = t3.Dist3DSpMat.from_dist2d(
        SpCOO.from_dense(inp["b"], device="cpu"), g3, "row")
    _stacks3(a3, "a3", out)
    _stacks3(b3, "b3", out)
    fc, oc = t3.summa3d_bounds(a3, b3)
    ran.append("summa3d_bounds")
    out["bounds3"] = np.asarray([fc, oc])
    c3 = t3.summa3d_spgemm(a3, b3, flops_cap=fc, out_capacity=oc)
    ran.append("summa3d_spgemm")
    _stacks3(c3, "c3", out)
    _stacks3(t3.summa3d_spgemm(a3, b3, flops_cap=fc, out_capacity=SAT_CAP3),
             "c3sat", out)
    _stacks3(t3.mem_efficient_spgemm3d(a3, b3, phases=2,
                                       phase_hook=doubled3), "me3", out)
    ran.append("mem_efficient_spgemm3d")
    row, col, val, nnz, _shape = c3.to_local().to_numpy()
    out["c3_local"] = np.stack([row[:nnz], col[:nnz]])
    out["c3_local_val"] = val[:nnz]
    _stacks(c3.to_dist2d(g), "c3_2d", out)
    g4 = pod_grid(layers=4, pr=2, pc=2, device="cpu")
    oa, ob = (SpCOO.from_dense(x, device="cpu") for x in overflow_pair())
    a4 = t3.Dist3DSpMat.from_dist2d(oa, g4, "col")
    b4 = t3.Dist3DSpMat.from_dist2d(ob, g4, "row")
    _stacks3(t3.summa3d_spgemm(a4, b4, flops_cap=t3.summa3d_bounds(a4, b4)[0],
                               out_capacity=OVER_CAP4), "over4", out)
    r, c, w, shape = rmat7(MCL3_SEED)
    m = DistSpMat.from_coo_arrays(r, c, w, shape, g)
    seen, orig = {}, tmcl.dist_transpose

    def caught(x):
        seen["a"] = x
        return orig(x)

    tmcl.dist_transpose = caught
    try:
        labels, iters = tmcl.mcl_dist(m, tmcl.MCLParams(**MCL_PARAMS),
                                      phases=2, layers=2, grid3=g3)
    finally:
        tmcl.dist_transpose = orig
    ran.append("mcl_dist_layers")
    out["mcl3_labels"] = labels.numpy()
    out["mcl3_iters"] = np.asarray(iters)
    _stacks(seen["a"], "mcl3_final", out)
    out["layered_ran"] = np.asarray(json.dumps(ran))


#: The vector layer's route cases: (tag, value dtype suffix, combine).
ROUTES = [(f"route_{k}_{c}", k, c) for k in ("f", "i")
          for c in ("set", "sum", "min", "max")]
#: The Uniq cases of :func:`vec_inputs`.
UNIQS = ("uniq_f", "uniq_i", "uniq_pad0", "uniq_pad1")


def vectors(g, full, out) -> None:
    """``parallel/vector.py`` on this process's slices of
    :func:`vec_inputs`: every result put together (``full``)."""
    import torch

    from combblas_tpu_torch.parallel import vector as tv
    v = vec_inputs()
    lo, hi = g.vec_range(VEC_PAD)

    def sl(x):
        return torch.from_numpy(np.ascontiguousarray(x[lo:hi]))

    out["perm_keys"] = full(tv.perm_from_keys(sl(v["keys"]), PERM_N, g))
    perm = tv.dist_rand_perm(torch.Generator().manual_seed(PERM_SEED),
                             PERM_N, g)
    out["rand_perm"] = full(perm)
    for tag, k, combine in ROUTES:
        o, m = tv.dist_route(sl(v["ridx"]), sl(v[f"rval_{k}"]),
                             sl(v["rmask"]), sl(v[f"rinit_{k}"]), g,
                             combine=combine)
        out[tag], out[f"{tag}_hit"] = full(o), full(m)
    out["gather"] = full(tv.dist_gather(sl(v["gx"]), sl(v["gidx"]), g))
    out["apply_perm"] = full(tv.dist_apply_perm(sl(v["gx"]), perm, g))
    for tag, (val, mask) in (("invert", (sl(v["inv"]), sl(v["inv_mask"]))),
                             ("invert_perm", (perm, perm < PERM_N))):
        o, m = tv.dist_invert(val, mask, g)
        out[tag], out[f"{tag}_hit"] = full(o), full(m)
    for tag in UNIQS:
        o, m = tv.dist_uniq(sl(v[tag]), sl(v[f"{tag}_mask"]), g)
        out[tag], out[f"{tag}_hit"] = full(o), full(m)


def indexing(g, inp, dist, out) -> None:
    """``parallel/indexing.py``: the two selectors, SpRef, the block prune
    and SpAsgn of ``a``; ``dist_permute`` of the BFS graph by a
    permutation, and of ``a`` by maps that fold duplicates (plus-times,
    min-plus, and from a capacity of 8, so that it retries)."""
    from combblas_tpu_torch.parallel import indexing as ti
    from combblas_tpu_torch.semiring import MIN_PLUS
    a, gr = dist(inp["a"]), dist(inp["g"])
    ix = index_inputs()
    _stacks(ti.dist_selector(SPREF_ROWS, 30, g), "sel", out)
    _stacks(ti.dist_selector(SPREF_COLS, 26, g, transpose=True), "selt",
            out)
    _stacks(ti.dist_spref(a, SPREF_ROWS, SPREF_COLS), "spref", out)
    _stacks(ti.dist_prune_block(a, SPASGN_ROWS, SPASGN_COLS), "pruneblk",
            out)
    _stacks(ti.dist_spasgn(a, SPASGN_ROWS, SPASGN_COLS, dist(ix["asg"])),
            "spasgn", out)
    _stacks(ti.dist_permute(gr, ix["perm"]), "permute", out)
    _stacks(ti.dist_permute(a, ix["rmap"], ix["cmap"]), "permute_fold", out)
    _stacks(ti.dist_permute(a, ix["rmap"], ix["cmap"], sr=MIN_PLUS),
            "permute_min", out)
    _stacks(ti.dist_permute(a, ix["rmap"], ix["cmap"], out_capacity=8),
            "permute_retry", out)


def mcl_preprocess(g, full, out, outdir, side) -> None:
    """HipMCL's preprocessing of :func:`rmat7_isolated`:
    ``dist_remove_isolated``, ``dist_rand_permute`` and
    ``mcl_dist(preprocess=True)`` from a seeded generator; on 2x2 also
    ``mcl_dist(preprocess=True)`` with the parent's permutation
    (OUTDIR/jax_perm.npy) in place of the port's draw."""
    import torch

    from combblas_tpu_torch.models import mcl as tmcl
    from combblas_tpu_torch.parallel.dist import DistSpMat
    r, c, w, shape = rmat7_isolated()
    m = DistSpMat.from_coo_arrays(r, c, w, shape, g)
    b, vmap, k = tmcl.dist_remove_isolated(m)
    _stacks(b, "rmiso", out)
    out["rmiso_map"], out["rmiso_k"] = vmap, np.asarray(k)
    b2, perm = tmcl.dist_rand_permute(b, torch.Generator().manual_seed(
        PRE_SEED))
    _stacks(b2, "randpermute", out)
    out["randpermute_perm"] = perm
    p = tmcl.MCLParams(**MCL_PARAMS)
    labels, iters = tmcl.mcl_dist(m, p, preprocess=True,
                                  generator=torch.Generator().manual_seed(
                                      PRE_SEED))
    out["mclpre_labels"], out["mclpre_iters"] = full(labels), np.asarray(
        iters)
    # 41 vertices, two of them isolated: the label slices carry pad slots
    d = components_loops()
    r, c = np.nonzero(d)
    labels, iters = tmcl.mcl_dist(
        DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, g), p,
        preprocess=True, generator=torch.Generator().manual_seed(PRE_SEED))
    out["mclpre_comps"], out["mclpre_comps_iters"] = full(labels), \
        np.asarray(iters)
    if side != 2:
        return
    given = np.load(os.path.join(outdir, "jax_perm.npy"))
    orig = tmcl.dist_rand_perm

    def jax_perm(generator, n, grid):
        lo, hi = grid.vec_range(given.shape[0])
        return torch.from_numpy(given[lo:hi])

    tmcl.dist_rand_perm = jax_perm
    try:
        labels, iters = tmcl.mcl_dist(m, p, preprocess=True)
    finally:
        tmcl.dist_rand_perm = orig
    out["mclpre_jax_labels"] = full(labels)
    out["mclpre_jax_iters"] = np.asarray(iters)


def algos(g, inp, dist, full, out) -> None:
    """Item 1.8's step 3: ``parallel/dense.py`` (with the calls that must
    refuse a share without its grid), BC, the orderings, the matchings,
    the multigrid setup and the filtered traversals."""
    import torch

    from combblas_tpu_torch.models import multigrid as mg
    from combblas_tpu_torch.models.bc import betweenness_centrality_dist
    from combblas_tpu_torch.models.filtered import (
        bfs_filtered_dist,
        materialize_filtered_dist,
        mis_filtered_dist,
    )
    from combblas_tpu_torch.models.ordering import md_order_dist, \
        rcm_order_dist
    from combblas_tpu_torch.parallel import dense, matching
    from combblas_tpu_torch.parallel.dist import DistSpMat, col_vec_len
    from combblas_tpu_torch.semiring import MAX_TIMES, MIN_PLUS, PLUS_TIMES
    a, gr = dist(inp["a"]), dist(inp["g"])
    d = dense_inputs()
    lo, hi = g.vec_range(col_vec_len(a.gshape, g))
    x = torch.from_numpy(d["spmm_x"][lo:hi])
    for name, sr in (("plus", PLUS_TIMES), ("min", MIN_PLUS),
                     ("max", MAX_TIMES)):
        y = dense.dist_spmm(a, x, sr)
        out[f"spmm_{name}"] = full(y.reshape(-1)).reshape(-1, SPMM_D)
    for tag in ("dense_x", "dense_q"):
        put = dense.dense_put(d[tag], g)
        out[f"{tag}_put"] = put.numpy()
        added = dense.dense_add_sparse(put, a)
        out[f"{tag}_add"] = added.numpy()
        out[f"{tag}_host"] = dense.dense_to_host(added, d[tag].shape, grid=g)
        for dim in ("row", "col"):
            out[f"{tag}_{dim}"] = full(dense.dense_reduce(put, dim, grid=g))
    refused = {}
    for name, call in (("dense_to_host", lambda: dense.dense_to_host(
            put, (3, 3))), ("dense_reduce", lambda: dense.dense_reduce(
                put, "row"))):
        try:
            call()
            refused[name] = ""
        except ValueError as e:
            refused[name] = str(e)
    out["dense_refused"] = np.asarray(json.dumps(refused))
    out["bc"] = betweenness_centrality_dist(gr, batch_size=BC_BATCH)
    out["rcm_comps"] = rcm_order_dist(dist(inp["comps"]))
    out["rcm_g"] = rcm_order_dist(gr, start=RCM_START)
    r, c, n = md_stencil()
    out["md"] = md_order_dist(DistSpMat.from_coo_arrays(
        r, c, np.ones(r.shape[0]), (n, n), g)).numpy()
    for tag, fn in (("maximal", matching.dist_bp_maximal),
                    ("maximum", matching.dist_bp_maximum),
                    ("awpm", matching.dist_awpm),
                    ("awpm_greedy", lambda m: matching.dist_awpm(
                        m, complete=False))):
        mr, mc = fn(a)
        out[f"{tag}_row"], out[f"{tag}_col"] = full(mr), full(mc)
    r, c, v, n = stencil(MG_SIDE, 3)
    st = DistSpMat.from_coo_arrays(r, c, v, (n, n), g)
    off = r != c
    st01 = DistSpMat.from_coo_arrays(r[off], c[off], np.ones(off.sum()),
                                     (n, n), g)
    s2 = mg.mis2_dist(st, torch.Generator().manual_seed(MG_SEED))
    out["mis2"] = s2
    out["mis2_ok"] = np.asarray([mg.mis2_verify_dist(st01, s2),
                                 mg.mis2_verify_dist(st01, ~s2)])
    rop = mg.restriction_op_dist(st, torch.Generator().manual_seed(MG_SEED))
    _stacks(rop, "restrict", out)
    _stacks(mg.galerkin_dist(rop, st), "galerkin", out)
    gw = dist(codes_graph())
    _stacks(materialize_filtered_dist(gw, heavy), "fmat", out)
    for root in BFS_ROOTS:
        parents, levels = bfs_filtered_dist(gw, root, heavy)
        out[f"fbfs{root}_parents"] = full(parents)
        out[f"fbfs{root}_levels"] = full(levels)
    out["fmis"] = full(mis_filtered_dist(
        gw, torch.Generator().manual_seed(FMIS_SEED), heavy))


def dense_inputs(seed: int = SEED + 13) -> dict:
    """``dist_spmm``'s operand (the column-space rows of ``a``'s 26
    columns, padded for the 4x4 grid, which the 2x2 grid's length
    divides), and two dense 30 x 26 matrices: normal floats, and quarters
    (whose sums are exact in any order)."""
    rng = np.random.default_rng(seed)
    return dict(
        spmm_x=rng.standard_normal((32, SPMM_D)).astype(np.float32),
        dense_x=rng.standard_normal((30, 26)).astype(np.float32),
        dense_q=(rng.integers(-40, 40, (30, 26)) / 4.0).astype(np.float32))


def main() -> None:
    rank, nproc, addr, side, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], int(sys.argv[4]),
                                       sys.argv[5])
    import torch

    from combblas_tpu_torch.io.parallel import (
        parallel_read_mtx,
        parallel_write_binary,
        parallel_write_mtx,
    )
    from combblas_tpu_torch.models.bfs import bfs_dir_opt_dist, bfs_dist
    from combblas_tpu_torch.models.lacc import lacc_dist
    from combblas_tpu_torch.models.mis import luby_mis_dist
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.ops.kernels.ring import ring_shift
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.dist import DistSpMat, dist_vec
    from combblas_tpu_torch.parallel.multihost import (
        initialize_multihost,
        is_coordinator,
        pod_grid,
    )
    from combblas_tpu_torch.parallel.rma import summa_spgemm_rma
    from combblas_tpu_torch.parallel.spmv import dist_spmv
    from combblas_tpu_torch.parallel.summa import (
        summa_bounds,
        summa_spgemm,
        summa_spgemm_auto,
    )
    from combblas_tpu_torch.parallel.vector import dist_sort_auto
    from combblas_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    torch.set_num_threads(1)     # tiny tensors; the processes share cores
    assert initialize_multihost(addr, nproc, rank) == nproc
    g = pod_grid(pr=side, pc=side, device="cpu")
    inp = inputs()
    out = dict(origin=np.asarray(g.origin()),
               local_shape=np.asarray(g.local_shape()),
               coordinator=np.asarray(is_coordinator()))

    def full(x):
        return exchange.allgather_var([x])[0].numpy()

    def dist(d):
        return DistSpMat.from_local(SpCOO.from_dense(d, device="cpu"), g)

    a, b, gr = dist(inp["a"]), dist(inp["b"]), dist(inp["g"])
    _stacks(a, "a", out)
    out["a_dense"] = a.to_dense()
    # SUMMA and the ring SUMMA
    fc, oc = summa_bounds(a, b)
    out["bounds"] = np.asarray([fc, oc])
    _stacks(summa_spgemm(a, b, PLUS_TIMES, flops_cap=fc, out_capacity=oc),
            "summa", out)
    _stacks(summa_spgemm_auto(a, b), "auto", out)
    for name, sr in (("rma_plus", PLUS_TIMES), ("rma_min", MIN_PLUS)):
        _stacks(summa_spgemm_rma(a, b, sr, stage_flops_cap=fc,
                                 out_capacity=oc), name, out)
    for axis in ("c", "r"):
        got = ring_shift([a.row, a.col, a.val, a.local_nnz], [axis] * 4,
                         grid=g)
        for f, x in zip(("row", "col", "val", "nnz"), got):
            out[f"hop_{axis}_{f}"] = x.numpy()
    # SpMV and BFS
    out["spmv"] = full(dist_spmv(gr, dist_vec(inp["spmv_x"], g)))
    for root in BFS_ROOTS:
        for name, fn in (("bfs", bfs_dist), ("diropt", bfs_dir_opt_dist)):
            parents, levels = fn(gr, root)
            out[f"{name}{root}_parents"] = full(parents)
            out[f"{name}{root}_levels"] = full(levels)
    # the sample sort
    xs = dist_vec(inp["sort_x"], g)
    ps = dist_vec(inp["sort_p"], g)
    for desc in (False, True):
        sx, sp = dist_sort_auto(xs, g, ps, length=SORT_LEN, descending=desc)
        out[f"sort{int(desc)}_x"] = full(sx)
        out[f"sort{int(desc)}_p"] = full(sp)
    # cooperative I/O
    parallel_write_mtx(os.path.join(outdir, "pod.mtx"), a, comment="pod")
    parallel_write_binary(os.path.join(outdir, "pod.bin"), a)
    _stacks(parallel_read_mtx(os.path.join(outdir, "in.mtx"), g), "read",
            out)
    elementwise(g, inp, dist, out)
    memefficient(g, inp, a, b, out)
    mcl(g, inp, dist, out)
    from combblas_tpu_torch.models.cc import fastsv_dist
    out["fastsv_g"] = fastsv_dist(gr).numpy()
    out["fastsv_comps"] = fastsv_dist(dist(inp["comps"])).numpy()
    # HipMCL's preprocessing and what lies under it; LACC and MIS
    vectors(g, full, out)
    indexing(g, inp, dist, out)
    mcl_preprocess(g, full, out, outdir, side)
    comps = dist(inp["comps"])
    for tag, m in (("g", gr), ("comps", comps)):
        out[f"lacc_{tag}"] = full(lacc_dist(m))
        out[f"mis_{tag}"] = full(luby_mis_dist(
            m, torch.Generator().manual_seed(MIS_SEED)))
    algos(g, inp, dist, full, out)
    layered(g, side, inp, dist, out)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    exchange.close()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
