"""The port's pod: block grids spread over 2 and 4 processes joined by
``gloo`` on 127.0.0.1, held against the JAX package's one-process results.

Each scenario is one launch of ``tests/_torch_pod_worker.py`` in NPROC
processes (its own timeout; on expiry every process is killed) that runs
the whole slice across the process boundary: SUMMA, the ring SUMMA and its
hop (K9's plain version through ``gloo``), ``dist_spmv``, ``bfs_dist``,
``dist_sort_auto``, the cooperative writes and read, and the refusals.
The parent runs JAX on its virtual CPU mesh (2x2 grids; JAX has no 4x4
mesh on 8 devices) and the port in one process, and compares every
process's blocks and vectors:

- against the port in one process, exactly (values bit for bit: the
  panels are assembled in the same block order);
- against JAX: integers, keys and files exactly, min/max values exactly,
  sums within rtol 1e-5 (the port's local folds run in another order than
  XLA's, as in ``test_torch_summa.py``).
"""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.io import parallel as jpar  # noqa: E402
from combblas_tpu.models import bfs as jbfs  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu.parallel import rma as jrma  # noqa: E402
from combblas_tpu.parallel import spmv as jsp  # noqa: E402
from combblas_tpu.parallel import summa as jsu  # noqa: E402
from combblas_tpu.parallel import vector as jvec  # noqa: E402
from combblas_tpu_torch.io import parallel as tpar  # noqa: E402
from combblas_tpu_torch.models import bfs as tbfs  # noqa: E402
from combblas_tpu_torch.ops.kernels.ring import ring_shift  # noqa: E402
from combblas_tpu_torch.parallel import rma as trma  # noqa: E402
from combblas_tpu_torch.parallel import spmv as tsp  # noqa: E402
from combblas_tpu_torch.parallel import summa as tsu  # noqa: E402
from combblas_tpu_torch.parallel import vector as tvec  # noqa: E402
from combblas_tpu_torch.parallel.dist import dist_vec  # noqa: E402
from combblas_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from tests import _torch_pod_worker as W  # noqa: E402
from tests.test_torch_dist import dist_pair, tgrid  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: name -> (processes, grid side)
SCENARIOS = {"2proc_2x2": (2, 2), "4proc_2x2": (4, 2), "4proc_4x4": (4, 4)}
LAUNCH_TIMEOUT_SECS = 300


def _launch(nproc: int, side: int, outdir: Path) -> list:
    W.write_triples(str(outdir / "in.mtx"), W.inputs()["tri"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("MASTER_ADDR", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_pod_worker.py"),
         str(r), str(nproc), f"127.0.0.1:{port}", str(side), str(outdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LAUNCH_TIMEOUT_SECS)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """name -> (per-rank results, the output directory), each scenario
    launched once, at its first use."""
    cache = {}

    def get(name):
        if name not in cache:
            out = tmp_path_factory.mktemp(name)
            cache[name] = (_launch(*SCENARIOS[name], out), out)
        return cache[name]
    return get


@functools.lru_cache(maxsize=None)
def _refs(side: int):
    """The port in one process and, on 2x2, JAX, on the worker's
    inputs."""
    inp = W.inputs()
    ja, ta = dist_pair(inp["a"], side, side) if side == 2 else (
        None, _one(inp["a"], side))
    jb, tb = dist_pair(inp["b"], side, side) if side == 2 else (
        None, _one(inp["b"], side))
    jg, tg = dist_pair(inp["g"], side, side) if side == 2 else (
        None, _one(inp["g"], side))
    return inp, (ja, jb, jg), (ta, tb, tg)


def _one(d, side):
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.parallel.dist import DistSpMat
    return DistSpMat.from_local(SpCOO.from_dense(d, device="cpu"),
                                tgrid(side, side))


def _share(x, r):
    """Process ``r``'s blocks of a full (pr, pc, ...) stack."""
    (r0, c0), (lr, lc) = r["origin"], r["local_shape"]
    return np.asarray(x)[r0:r0 + lr, c0:c0 + lc]


def _same_share(ranks, tag, full, exact=True):
    """Every process's ``tag`` stacks equal its share of ``full`` (a port or
    JAX DistSpMat); the nnz table in every process equals ``full``'s."""
    for r in ranks:
        for f in ("row", "col"):
            np.testing.assert_array_equal(
                r[f"{tag}_{f}"], _share(getattr(full, f), r), err_msg=f)
        np.testing.assert_array_equal(r[f"{tag}_nnz"], np.asarray(full.nnz))
        want = _share(getattr(full, "val"), r)
        if exact:
            np.testing.assert_array_equal(r[f"{tag}_val"].view(np.uint32),
                                          want.view(np.uint32))
        else:
            np.testing.assert_allclose(r[f"{tag}_val"], want, rtol=1e-5,
                                       atol=0)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_layout(pods, name):
    """Each process holds its raster run of blocks, the one coordinator is
    rank 0, the stacks are its share of the one-process stacks and
    ``to_dense`` gives every process the whole matrix."""
    ranks, _ = pods(name)
    nproc, side = SCENARIOS[name]
    inp, jm, tm = _refs(side)
    blocks = side * side // nproc
    for q, r in enumerate(ranks):
        start = q * blocks
        assert tuple(r["origin"]) == (start // side, start % side)
        assert int(np.prod(r["local_shape"])) == blocks
        assert bool(r["coordinator"]) == (q == 0)
        np.testing.assert_array_equal(r["a_dense"], inp["a"])
    _same_share(ranks, "a", tm[0])
    if jm[0] is not None:
        _same_share(ranks, "a", jm[0])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_summa(pods, name):
    """``summa_bounds`` equal everywhere; ``summa_spgemm`` (the plain ESC
    route) and ``summa_spgemm_auto`` (the kernel route's plain version,
    with its retries) equal the one-process calls slot for slot, and
    JAX's ``summa_spgemm`` on 2x2."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    _inp, (ja, jb, _), (ta, tb, _) = _refs(side)
    fc, oc = tsu.summa_bounds(ta, tb)
    for r in ranks:
        assert tuple(r["bounds"]) == (fc, oc)
    _same_share(ranks, "summa", tsu.summa_spgemm(
        ta, tb, PLUS_TIMES, flops_cap=fc, out_capacity=oc))
    _same_share(ranks, "auto", tsu.summa_spgemm_auto(ta, tb))
    if ja is not None:
        assert jsu.summa_bounds(ja, jb) == (fc, oc)
        _same_share(ranks, "summa", jsu.summa_spgemm(
            ja, jb, jsr.PLUS_TIMES, flops_cap=fc, out_capacity=oc),
            exact=False)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_rma(pods, name):
    """The ring SUMMA across processes (K9's hops through ``gloo``) equals
    the one-process ring SUMMA slot for slot, and JAX's
    ``summa_spgemm_rma`` on 2x2 (min-plus exactly, plus-times within rtol
    1e-5)."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    _inp, (ja, jb, _), (ta, tb, _) = _refs(side)
    fc, oc = tsu.summa_bounds(ta, tb)
    for tag, tsr_, jsr_ in (("rma_plus", PLUS_TIMES, jsr.PLUS_TIMES),
                            ("rma_min", MIN_PLUS, jsr.MIN_PLUS)):
        _same_share(ranks, tag, trma.summa_spgemm_rma(
            ta, tb, tsr_, stage_flops_cap=fc, out_capacity=oc))
        if ja is not None:
            _same_share(ranks, tag, jrma.summa_spgemm_rma(
                ja, jb, jsr_, stage_flops_cap=fc, out_capacity=oc,
                interpret=True), exact=tag == "rma_min")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_ring_hop(pods, name):
    """One hop of A's stacks along each axis across processes equals the
    one-process hop of the whole stack, every process its share."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    ta = _refs(side)[2][0]
    for axis in ("c", "r"):
        want = ring_shift([ta.row, ta.col, ta.val, ta.nnz], [axis] * 4)
        for r in ranks:
            for f, w in zip(("row", "col", "val", "nnz"), want):
                np.testing.assert_array_equal(
                    r[f"hop_{axis}_{f}"], _share(w.numpy(), r), err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_spmv_bfs(pods, name):
    """``dist_spmv`` within rtol 1e-5 of JAX's and of one process's;
    ``bfs_dist`` parents and levels exactly JAX's (2x2) and one
    process's, from two roots; ``bfs_dir_opt_dist`` one process's."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp, (_, _, jg), (_, _, tg) = _refs(side)
    x = dist_vec(inp["spmv_x"], tg.grid)
    want = tsp.dist_spmv(tg, x).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["spmv"], want, rtol=1e-5, atol=1e-6)
    if jg is not None:
        np.testing.assert_allclose(
            ranks[0]["spmv"], np.asarray(jsp.dist_spmv(
                jg, jdist.dist_vec(inp["spmv_x"], jg.grid))),
            rtol=1e-5, atol=1e-6)
    for root in W.BFS_ROOTS:
        tp, tl = tbfs.bfs_dist(tg, root)
        dp, dl = tbfs.bfs_dir_opt_dist(tg, root)
        for r in ranks:
            np.testing.assert_array_equal(r[f"bfs{root}_parents"],
                                          tp.numpy())
            np.testing.assert_array_equal(r[f"bfs{root}_levels"],
                                          tl.numpy())
            np.testing.assert_array_equal(r[f"diropt{root}_parents"],
                                          dp.numpy())
            np.testing.assert_array_equal(r[f"diropt{root}_levels"],
                                          dl.numpy())
        if jg is not None:
            jp, jl = jbfs.bfs_dist(jg, root)
            np.testing.assert_array_equal(ranks[0][f"bfs{root}_parents"],
                                          np.asarray(jp))
            np.testing.assert_array_equal(ranks[0][f"bfs{root}_levels"],
                                          np.asarray(jl))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_sort(pods, name):
    """``dist_sort_auto`` across processes, ascending and descending, with
    an int32 payload and a true prefix: bit for bit the one-process sort's
    and JAX's sample sort's (2x2)."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp, (_, _, jg), (_, _, tg) = _refs(side)
    for desc in (False, True):
        tx, tp = tvec.dist_sort_auto(
            torch.from_numpy(inp["sort_x"]), tg.grid,
            torch.from_numpy(inp["sort_p"]), length=W.SORT_LEN,
            descending=desc)
        for r in ranks:
            np.testing.assert_array_equal(
                r[f"sort{int(desc)}_x"].view(np.uint32),
                tx.numpy().view(np.uint32))
            np.testing.assert_array_equal(r[f"sort{int(desc)}_p"],
                                          tp.numpy())
        if jg is not None:
            jx, jp = jvec.dist_sort_auto(
                jdist.dist_vec(inp["sort_x"], jg.grid), jg.grid,
                jdist.dist_vec(inp["sort_p"], jg.grid), length=W.SORT_LEN,
                descending=desc)
            np.testing.assert_array_equal(
                ranks[0][f"sort{int(desc)}_x"].view(np.uint32),
                np.asarray(jx).view(np.uint32))
            np.testing.assert_array_equal(ranks[0][f"sort{int(desc)}_p"],
                                          np.asarray(jp))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_io(pods, name, tmp_path):
    """The cooperative writes are byte for byte one process's files (and
    JAX's on 2x2); the cooperative read of a file with duplicates out of
    order gives every process its share of one process's blocks (and
    JAX's)."""
    ranks, out = pods(name)
    side = SCENARIOS[name][1]
    _inp, (ja, _, _), (ta, _, _) = _refs(side)
    tpar.parallel_write_mtx(str(tmp_path / "one.mtx"), ta, comment="pod")
    tpar.parallel_write_binary(str(tmp_path / "one.bin"), ta)
    for ext in ("mtx", "bin"):
        assert (out / f"pod.{ext}").read_bytes() == (
            tmp_path / f"one.{ext}").read_bytes(), ext
    if ja is not None:
        jpar.parallel_write_mtx(str(tmp_path / "j.mtx"), ja, comment="pod")
        jpar.parallel_write_binary(str(tmp_path / "j.bin"), ja)
        for ext in ("mtx", "bin"):
            assert (out / f"pod.{ext}").read_bytes() == (
                tmp_path / f"j.{ext}").read_bytes(), ext
    _same_share(ranks, "read", tpar.parallel_read_mtx(
        str(out / "in.mtx"), tgrid(side, side)))
    if ja is not None:
        _same_share(ranks, "read", jpar.parallel_read_mtx(
            str(out / "in.mtx"), ja.grid))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_refuses_unported(pods, name):
    """A distributed function with no exchange across processes yet raises
    ``NotImplementedError`` naming ROADMAP item 1.8 on a pod grid, in every
    process, and so does a layered pod grid."""
    ranks, _ = pods(name)
    for r in ranks:
        refused = json.loads(str(r["refused"]))
        assert set(refused) == {"dist_transpose", "mcl_dist", "dist_route",
                                "pod_grid_layers"}
        for what, msg in refused.items():
            assert "ROADMAP item 1.8" in msg, (what, msg)

