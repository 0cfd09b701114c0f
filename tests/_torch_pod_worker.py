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
``fastsv_dist``), and the refusals of functions not ported to a pod.  Each
process saves what it holds to OUTDIR/rankR.npz; the parent compares.
Imports no JAX.
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
    from combblas_tpu_torch.models.mcl import mcl_dist
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
    from combblas_tpu_torch.parallel.vector import dist_route, dist_sort_auto
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
    # what a pod refuses
    refused = {}
    for name, call in (
            ("mcl_dist_preprocess", lambda: mcl_dist(gr, preprocess=True)),
            ("mcl_dist_layers", lambda: mcl_dist(gr, layers=2)),
            ("lacc_dist", lambda: lacc_dist(gr)),
            ("dist_route", lambda: dist_route(xs, xs, xs > 0, xs, g)),
            ("pod_grid_layers", lambda: pod_grid(layers=2, device="cpu"))):
        try:
            call()
            refused[name] = ""
        except NotImplementedError as e:
            refused[name] = str(e)
    out["refused"] = np.asarray(json.dumps(refused))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    exchange.close()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
