"""One process of a pod of the port, for ``tests/test_torch_pod.py``.

``python tests/_torch_pod_worker.py RANK NPROC HOST:PORT SIDE OUTDIR``
joins a ``gloo`` group of NPROC CPU processes, builds a SIDE x SIDE block
grid spread over them (``pod_grid``) and runs, across the process boundary,
every function of the pod slice on the inputs of :func:`inputs` (seeded
numpy, which the test's parent rebuilds): SUMMA (``summa_bounds``,
``summa_spgemm``, ``summa_spgemm_auto``), the ring SUMMA and its hop (K9's
plain version through ``gloo``), ``dist_spmv``, ``bfs_dist`` and
``bfs_dir_opt_dist``, ``dist_sort_auto``, the cooperative writes and read,
``to_dense``, and the refusals of functions not ported to a pod.  Each
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
    return dict(a=rand_sparse(30, 26, 0.2, seed),
                b=rand_sparse(26, 34, 0.2, seed + 1), g=g,
                spmv_x=rng.standard_normal(BFS_N).astype(np.float32),
                sort_x=x, sort_p=np.arange(SORT_PAD, dtype=np.int32),
                tri=(tri_r, tri_c, tri_v))


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
    from combblas_tpu_torch.models.mcl import mcl_dist
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.ops.kernels.ring import ring_shift
    from combblas_tpu_torch.parallel import exchange
    from combblas_tpu_torch.parallel.dist import DistSpMat, dist_vec
    from combblas_tpu_torch.parallel.elementwise import dist_transpose
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
    # what a pod refuses
    refused = {}
    for name, call in (
            ("dist_transpose", lambda: dist_transpose(a)),
            ("mcl_dist", lambda: mcl_dist(gr)),
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
