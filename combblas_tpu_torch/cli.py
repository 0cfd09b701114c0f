"""Command-line entry points (port of ``combblas_tpu/cli.py``): the counterparts
of the reference's application executables as subcommands over shared I/O
and grid setup, on the card:

    python -m combblas_tpu_torch.cli bfs      graph.mtx --root 0
    python -m combblas_tpu_torch.cli cc       graph.mtx [--algo fastsv|lacc]
    python -m combblas_tpu_torch.cli mcl      graph.mtx --inflation 2
    python -m combblas_tpu_torch.cli bc       graph.mtx --batch 32
    python -m combblas_tpu_torch.cli spgemm   A.mtx B.mtx -o C.mtx
    python -m combblas_tpu_torch.cli gen      --scale 14 -o rmat.mtx
    python -m combblas_tpu_torch.cli convert  A.mtx -o A.bin
    python -m combblas_tpu_torch.cli match    bipartite.mtx [--max|--awpm]
    python -m combblas_tpu_torch.cli rcm      graph.mtx
    python -m combblas_tpu_torch.cli galerkin graph.mtx --seed 0

``--dist`` (bfs, cc, mcl) runs the distributed variant on ``default_grid``.
A ``.bin`` path is the binary format, any other Matrix Market.  The same
ten subcommands as the JAX package's are registered; ``cmd_md``,
``cmd_fbfs``, ``cmd_fmis`` and ``cmd_spgemm3d`` are callable functions
without a subcommand, as there.  Random draws (``gen``, ``galerkin``,
``fmis``) come from a ``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from combblas_tpu_torch.device import resolve_device


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _load(path, device, symmetrize=False):
    from combblas_tpu_torch.io.binary import read_binary
    from combblas_tpu_torch.io.mtx import read_mtx
    from combblas_tpu_torch.ops.coo import merge

    a = (read_binary(path, device=device) if path.endswith(".bin")
         else read_mtx(path, device=device))
    if symmetrize:
        a = merge(a, a.transpose())
    return a


def _save(path, a):
    from combblas_tpu_torch.io.binary import write_binary
    from combblas_tpu_torch.io.mtx import write_mtx

    (write_binary if path.endswith(".bin") else write_mtx)(path, a)


def _generator(args) -> torch.Generator:
    return torch.Generator(device=resolve_device(args.device)).manual_seed(
        args.seed)


def _grid(a):
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import default_grid

    return DistSpMat.from_local(a, default_grid(device=a.device))


def cmd_bfs(args):
    a = _load(args.matrix, args.device, symmetrize=args.symmetrize)
    if args.dist:
        from combblas_tpu_torch.models.bfs import bfs_dist

        A = _grid(a)
        t0 = time.perf_counter()
        parents, levels = bfs_dist(A, args.root)
    else:
        from combblas_tpu_torch.models.bfs import bfs_dir_opt_local, bfs_local

        fn = bfs_dir_opt_local if args.dir_opt else bfs_local
        t0 = time.perf_counter()
        parents, levels = fn(a, args.root)
    lv = _host(levels)
    visited = int((lv >= 0).sum())
    print(f"bfs: visited {visited} vertices, max level {int(lv.max())}, "
          f"{time.perf_counter() - t0:.3f}s")


def cmd_cc(args):
    from combblas_tpu_torch.models.cc import (
        count_components,
        fastsv_dist,
        fastsv_local,
    )
    from combblas_tpu_torch.models.lacc import lacc_local

    a = _load(args.matrix, args.device, symmetrize=True)
    if args.dist:
        labels = fastsv_dist(_grid(a))
        n = a.shape[0]
    else:
        labels = (lacc_local if args.algo == "lacc" else fastsv_local)(a)
        n = None
    print(f"cc[{args.algo}]: {count_components(labels, n)} components")


def cmd_mcl(args):
    from combblas_tpu_torch.models.mcl import MCLParams, mcl_dist, mcl_local

    a = _load(args.matrix, args.device)
    p = MCLParams(inflation=args.inflation, select=args.select,
                  max_iters=args.max_iters)
    if args.dist:
        labels, iters = mcl_dist(_grid(a), p, phases=args.phases,
                                 verbose=args.verbose)
    else:
        labels, iters = mcl_local(a, p, verbose=args.verbose)
    lab = _host(labels)[: a.shape[0]]
    print(f"mcl: {len(np.unique(lab))} clusters in {iters} iterations")


def cmd_bc(args):
    from combblas_tpu_torch.models.bc import betweenness_centrality

    a = _load(args.matrix, args.device, symmetrize=args.symmetrize)
    n = a.shape[0]
    sources = None if args.batches is None else np.arange(
        min(n, args.batches * args.batch))
    bc = betweenness_centrality(a, batch_size=args.batch, sources=sources)
    top = np.argsort(bc)[::-1][:5]
    print("bc top5:", [(int(v), round(float(bc[v]), 2)) for v in top])


def cmd_spgemm(args):
    from combblas_tpu_torch.ops.spgemm import spgemm_auto
    from combblas_tpu_torch.semiring import get_semiring

    a = _load(args.a, args.device)
    b = _load(args.b, args.device) if args.b else a
    t0 = time.perf_counter()
    c = spgemm_auto(a, b, get_semiring(args.semiring))
    nnz = int(c.nnz)
    print(f"spgemm: C {c.shape} nnz {nnz} in {time.perf_counter() - t0:.3f}s")
    if args.output:
        _save(args.output, c)


def cmd_galerkin(args):
    """The Galerkin coarse-operator command
    (``ReleaseTests/GalerkinNew.cpp:105``): the MIS-2 restriction R, then
    R·A·Rᵀ."""
    from combblas_tpu_torch.models.multigrid import galerkin, restriction_op

    a = _load(args.matrix, args.device)
    t0 = time.perf_counter()
    r = restriction_op(a, _generator(args))
    c = galerkin(r, a)
    print(f"galerkin: coarse {c.shape} nnz {int(c.nnz)} "
          f"(R {r.shape}) in {time.perf_counter() - t0:.3f}s")
    if args.output:
        _save(args.output, c)


def cmd_gen(args):
    from combblas_tpu_torch.gen.rmat import rmat_matrix

    a = rmat_matrix(_generator(args), scale=args.scale,
                    edgefactor=args.edgefactor, symmetrize=args.symmetrize)
    print(f"gen: rmat scale {args.scale}, nnz {int(a.nnz)}")
    if args.output:
        _save(args.output, a)


def cmd_convert(args):
    _save(args.output, _load(args.matrix, args.device))
    print(f"convert: {args.matrix} -> {args.output}")


def cmd_match(args):
    from combblas_tpu_torch.models.matching import (
        awpm,
        bp_maximal_matching,
        bp_maximum_matching,
    )

    a = _load(args.matrix, args.device)
    if args.awpm:
        mr, _mc = awpm(a)
        kind = "awpm"
    elif args.max:
        mr, _mc = bp_maximum_matching(a)
        kind = "maximum"
    else:
        mr, _mc = bp_maximal_matching(a)
        kind = "maximal"
    print(f"match[{kind}]: cardinality {int((_host(mr) >= 0).sum())}")


def _print_order(name: str, order) -> None:
    order = _host(order)
    print(f"{name}:", " ".join(map(str, order[: min(20, len(order))])),
          "..." if len(order) > 20 else "")


def cmd_rcm(args):
    from combblas_tpu_torch.models.ordering import rcm_order

    _print_order("rcm", rcm_order(_load(args.matrix, args.device,
                                        symmetrize=True)))


def cmd_md(args):
    from combblas_tpu_torch.models.ordering import md_order

    _print_order("md", md_order(_load(args.matrix, args.device,
                                      symmetrize=True)))


def _window(args):
    lo, hi = args.begin, args.end
    return lambda v: (v >= lo) & (v <= hi)


def cmd_fbfs(args):
    """Filtered BFS with a value-window predicate (``FilteredBFS.cpp``):
    edges whose values lie outside [--begin, --end] are skipped."""
    from combblas_tpu_torch.models.filtered import bfs_filtered

    a = _load(args.matrix, args.device, symmetrize=args.symmetrize)
    t0 = time.perf_counter()
    _parents, levels = bfs_filtered(a, args.root, _window(args))
    lv = _host(levels)
    print(f"fbfs: visited {(lv >= 0).sum()} / {a.shape[0]} "
          f"depth {lv.max()} in {time.perf_counter() - t0:.3f}s")


def cmd_fmis(args):
    """Filtered maximal independent set (``FilteredMIS.cpp``)."""
    from combblas_tpu_torch.models.filtered import mis_filtered

    a = _load(args.matrix, args.device, symmetrize=True)
    t0 = time.perf_counter()
    in_set = _host(mis_filtered(a, _generator(args), _window(args)))
    print(f"fmis: |MIS| {int(in_set.sum())} / {a.shape[0]} "
          f"in {time.perf_counter() - t0:.3f}s")


def cmd_spgemm3d(args):
    """The 3D split-layer SpGEMM command (``3DSpGEMM/mpipspgemm.cpp`` /
    ``Applications/SpGEMM3D.cpp``): A² on a (layers, side, side) grid of
    as many blocks as the default grid of ``--layers`` layers holds (one
    a layer: every block lies on the one card)."""
    from combblas_tpu_torch.parallel.grid import ProcGrid, default_grid
    from combblas_tpu_torch.parallel.summa3d import (
        Dist3DSpMat,
        summa3d_bounds,
        summa3d_spgemm,
    )

    a = _load(args.matrix, args.device)
    layers = args.layers
    n_blocks = default_grid(layers, device=a.device).nprocs
    side = int((n_blocks // layers) ** 0.5)
    grid = ProcGrid.make(side, side, layers=layers, device=a.device)
    A = Dist3DSpMat.from_dist2d(a, grid, "col")
    B = Dist3DSpMat.from_dist2d(a, grid, "row")
    flops_cap, out_cap = summa3d_bounds(A, B)
    t0 = time.perf_counter()
    c = summa3d_spgemm(A, B, flops_cap=flops_cap, out_capacity=out_cap)
    nnz = int(c.nnz.sum())
    print(f"spgemm3d[layers={layers}]: nnz {nnz} "
          f"in {time.perf_counter() - t0:.3f}s")


def main(argv=None, device=None):
    """Parse ``argv`` (the command line when None) and run its subcommand.
    ``device``: where the matrices go (the card when None; the tests pass
    ``"cpu"``)."""
    ap = argparse.ArgumentParser(prog="combblas_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--dist", action="store_true",
                       help="run distributed on the default grid")

    p = sub.add_parser("bfs"); p.add_argument("matrix"); common(p)
    p.add_argument("--root", type=int, default=0)
    p.add_argument("--dir-opt", action="store_true")
    p.add_argument("--symmetrize", action="store_true")
    p.set_defaults(fn=cmd_bfs)

    p = sub.add_parser("cc"); p.add_argument("matrix"); common(p)
    p.add_argument("--algo", choices=["fastsv", "lacc"], default="fastsv")
    p.set_defaults(fn=cmd_cc)

    p = sub.add_parser("mcl"); p.add_argument("matrix"); common(p)
    p.add_argument("--inflation", type=float, default=2.0)
    p.add_argument("--select", type=int, default=1100)
    p.add_argument("--phases", type=int, default=1)
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_mcl)

    p = sub.add_parser("bc"); p.add_argument("matrix")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--batches", type=int, default=None)
    p.add_argument("--symmetrize", action="store_true")
    p.set_defaults(fn=cmd_bc)

    p = sub.add_parser("spgemm"); p.add_argument("a")
    p.add_argument("b", nargs="?")
    p.add_argument("-o", "--output")
    p.add_argument("--semiring", default="plus_times")
    p.set_defaults(fn=cmd_spgemm)

    p = sub.add_parser("gen")
    p.add_argument("--scale", type=int, default=14)
    p.add_argument("--edgefactor", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--symmetrize", action="store_true")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_gen)

    p = sub.add_parser("convert"); p.add_argument("matrix")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("match"); p.add_argument("matrix")
    p.add_argument("--max", action="store_true")
    p.add_argument("--awpm", action="store_true")
    p.set_defaults(fn=cmd_match)

    p = sub.add_parser("rcm"); p.add_argument("matrix")
    p.set_defaults(fn=cmd_rcm)

    p = sub.add_parser("galerkin"); p.add_argument("matrix")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output")
    p.set_defaults(fn=cmd_galerkin)

    args = ap.parse_args(argv)
    args.device = device
    args.fn(args)


if __name__ == "__main__":
    main()
