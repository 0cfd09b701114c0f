"""The port's pod: block grids spread over 2 and 4 processes joined by
``gloo`` on 127.0.0.1, held against the JAX package's one-process results.

Each scenario is one launch of ``tests/_torch_pod_worker.py`` in NPROC
processes (its own timeout; on expiry every process is killed) that runs
the whole slice across the process boundary: SUMMA, the ring SUMMA and its
hop (K9's plain version through ``gloo``), ``dist_spmv``, ``bfs_dist``,
``dist_sort_auto``, the cooperative writes and read, HipMCL's path (the
distributed elementwise ops and k-selects, the staged and phased SpGEMM,
the sampling estimate, ``dist_mcl_prune``, ``mcl_dist``, ``fastsv_dist``),
HipMCL's preprocessing and what lies under it (the vector layer, the
distributed indexing, ``dist_permute``, ``dist_remove_isolated``,
``dist_rand_permute``, ``mcl_dist(preprocess=True)``), ``lacc_dist``,
``luby_mis_dist``, item 1.8's step 3 (the dense matrices and
``dist_spmm``, BC, RCM and minimum degree, the three matchings, MIS-2,
R and R·A·Rᵀ, the filtered BFS, MIS and prune) and item 1.8's step 4,
the layered grid (the 3D SUMMA, its phased form and bounds, and
``mcl_dist(layers=2)``).  The parent runs JAX on its virtual CPU mesh
(2x2 and (2, 2, 2) grids; JAX has no 4x4 mesh on 8 devices) and the port
in one process, and compares every process's blocks and vectors:

- against the port in one process, exactly (values bit for bit: the
  panels are assembled in the same block order, and the column sums meet
  in the one-process order); the sampling estimate within 1e-6 relative
  (its row sums meet in another order), the phase counts equal;
- against JAX: integers, keys, labels, iteration counts, selections and
  files exactly, min/max values exactly, sums within rtol 1e-5 (the port's
  local folds run in another order than XLA's, as in
  ``test_torch_summa.py``).  JAX takes the ``"xla"`` route on the CPU and
  the port its kernel routes' plain versions, so ``mem_efficient_spgemm``
  is compared on ``impl="xla"``, and ``block_spgemm`` and ``mcl_dist``'s
  final iterate compacted (``to_local``), as ``test_torch_mcl_dist.py``
  does; JAX's sampling draws are threefry, so the estimate is held against
  one process only.  For the same reason the RandPerm and the MIS are held
  against one process (the MIS also on its invariants), ``perm_from_keys``
  against JAX's sort of the same keys, and the preprocessed ``mcl_dist``
  against JAX's given JAX's permutation (the parent writes it to the
  scenario's directory).  SpRef and SpAsgn are compared with JAX's
  compacted (``to_local``), as ``test_torch_dist_indexing.py`` does; the
  float route sums and ``dist_permute``'s folds of duplicates equal one
  process's bit for bit and JAX's within rtol 1e-5.

Step 3 is held to one process bit for bit (float sums by their bits:
``dist_spmm``'s blocks meet in the one-process order; BC's scores),
except ``dense_reduce`` of normal floats, whose blocks' partials meet in
another order than one process's ``torch.sum`` over a whole row (rtol
1e-5; of quarter values, whose sums are exact, bit for bit).  Against
JAX on 2x2: ``dist_spmm`` sums and ``dense_reduce`` within rtol 1e-5,
min / max exactly; BC within rtol 1e-5; the orders, the mates and the
filtered BFS exactly; the filtered prune on compacted entries exactly;
``galerkin_dist`` of one R (the port's host triples on both sides)
compacted, within rtol 1e-5.  MIS-2, R and the filtered MIS (JAX draws
threefry) are held to one process and to their invariants.
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
import jax.numpy as jnp  # noqa: E402

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.io import parallel as jpar  # noqa: E402
from combblas_tpu.models import bc as jbc  # noqa: E402
from combblas_tpu.models import bfs as jbfs  # noqa: E402
from combblas_tpu.models import cc as jcc  # noqa: E402
from combblas_tpu.models import filtered as jfil  # noqa: E402
from combblas_tpu.models import lacc as jlacc  # noqa: E402
from combblas_tpu.models import mcl as jmcl  # noqa: E402
from combblas_tpu.models import multigrid as jmg  # noqa: E402
from combblas_tpu.models import ordering as jord  # noqa: E402
from combblas_tpu.parallel import dense as jdense  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu.parallel import elementwise as jel  # noqa: E402
from combblas_tpu.parallel import indexing as jix  # noqa: E402
from combblas_tpu.parallel import matching as jpm  # noqa: E402
from combblas_tpu.parallel import memefficient as jme  # noqa: E402
from combblas_tpu.parallel import rma as jrma  # noqa: E402
from combblas_tpu.parallel import spmv as jsp  # noqa: E402
from combblas_tpu.parallel import summa as jsu  # noqa: E402
from combblas_tpu.parallel import vector as jvec  # noqa: E402
from combblas_tpu_torch.io import parallel as tpar  # noqa: E402
from combblas_tpu_torch.models import bc as tbc  # noqa: E402
from combblas_tpu_torch.models import bfs as tbfs  # noqa: E402
from combblas_tpu_torch.models import cc as tcc  # noqa: E402
from combblas_tpu_torch.models import filtered as tfil  # noqa: E402
from combblas_tpu_torch.models import lacc as tlacc  # noqa: E402
from combblas_tpu_torch.models import mcl as tmcl  # noqa: E402
from combblas_tpu_torch.models import mis as tmis  # noqa: E402
from combblas_tpu_torch.models import multigrid as tmg  # noqa: E402
from combblas_tpu_torch.models import ordering as tord  # noqa: E402
from combblas_tpu_torch.parallel import dense as tdense  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from combblas_tpu_torch.parallel import elementwise as tel  # noqa: E402
from combblas_tpu_torch.parallel import indexing as tix  # noqa: E402
from combblas_tpu_torch.parallel import matching as tpm  # noqa: E402
from combblas_tpu_torch.parallel import memefficient as tme  # noqa: E402
from combblas_tpu_torch.ops.kernels.ring import ring_shift  # noqa: E402
from combblas_tpu_torch.parallel import rma as trma  # noqa: E402
from combblas_tpu_torch.parallel import spmv as tsp  # noqa: E402
from combblas_tpu_torch.parallel import summa as tsu  # noqa: E402
from combblas_tpu_torch.parallel import vector as tvec  # noqa: E402
from combblas_tpu_torch.parallel.dist import dist_vec  # noqa: E402
from combblas_tpu_torch.semiring import (  # noqa: E402
    MAX_FIRST,
    MAX_TIMES,
    MIN_PLUS,
    PLUS_TIMES,
)
from tests import _torch_pod_worker as W  # noqa: E402
from tests.test_torch_dist import dist_pair, jgrid, tgrid  # noqa: E402
from tests.test_torch_multigrid import check_mis2, check_r  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: name -> (processes, grid side)
SCENARIOS = {"2proc_2x2": (2, 2), "4proc_2x2": (4, 2), "4proc_4x4": (4, 4)}
LAUNCH_TIMEOUT_SECS = 300


@functools.lru_cache(maxsize=None)
def _jax_pre_perm() -> np.ndarray:
    """JAX's permutation of the preprocessed ``mcl_dist`` (its default key,
    on 2x2) of the worker's isolated-vertex R-MAT."""
    n = W.rmat7_isolated()[3][1]
    return np.asarray(jvec.dist_rand_perm(jax.random.PRNGKey(17), n,
                                          jgrid(2, 2)))


def _launch(nproc: int, side: int, outdir: Path) -> list:
    W.write_triples(str(outdir / "in.mtx"), W.inputs()["tri"])
    if side == 2:
        np.save(outdir / "jax_perm.npy", _jax_pre_perm())
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
    """No function refuses a pod: in every process the layered grid, the
    3D SUMMA's three functions and the layered ``mcl_dist`` ran across the
    processes, and the layered grid's share is the raster run of
    ``jax.devices()`` reshaped to (layers, pr, pc)."""
    ranks, _ = pods(name)
    nproc, side = SCENARIOS[name]
    owner = np.arange(2 * side * side).reshape(2, side, side) // (
        2 * side * side // nproc)
    for q, r in enumerate(ranks):
        assert json.loads(str(r["layered_ran"])) == [
            "pod_grid_layers", "summa3d_bounds", "summa3d_spgemm",
            "mem_efficient_spgemm3d", "mcl_dist_layers"]
        (t0, r0, c0), (ll, lr, lc) = r["origin3"], r["local_shape3"]
        mine = np.argwhere(owner == q)
        assert mine.min(0).tolist() == [t0, r0, c0]
        assert (mine.max(0) - mine.min(0) + 1).tolist() == [ll, lr, lc]
        assert len(mine) == ll * lr * lc


#: The 3D stacks of the worker's :func:`layered`.
_STACKS3 = ("a3", "b3", "c3", "c3sat", "me3", "over4")


def _same_share3(ranks, tag, full, exact=True):
    """Every process's layered ``tag`` stacks equal its (ll, lr, lc) box of
    ``full`` (a port or JAX ``Dist3DSpMat``, or its numpy fields by name);
    the nnz table in every process equals ``full``'s."""
    get = (full.get if isinstance(full, dict)
           else lambda f: np.asarray(getattr(full, f)))
    for r in ranks:
        (t0, r0, c0) = r[f"{tag}_origin3"]
        ll, lr, lc = r[f"{tag}_row"].shape[:3]

        def box(x):
            return np.asarray(x)[t0:t0 + ll, r0:r0 + lr, c0:c0 + lc]

        for f in ("row", "col"):
            np.testing.assert_array_equal(r[f"{tag}_{f}"], box(get(f)),
                                          err_msg=f"{tag} {f}")
        np.testing.assert_array_equal(r[f"{tag}_nnz"], get("nnz"),
                                      err_msg=f"{tag} nnz")
        want = box(get("val"))
        if exact:
            np.testing.assert_array_equal(r[f"{tag}_val"].view(np.uint32),
                                          want.view(np.uint32))
        else:
            np.testing.assert_allclose(r[f"{tag}_val"], want, rtol=1e-5,
                                       atol=0)


@functools.lru_cache(maxsize=None)
def _one_layered(side: int) -> dict:
    """The worker's :func:`layered` in one process (its grids the one
    process's): every stack, table and label by tag."""
    out = {}
    g = tgrid(side, side)
    W.layered(g, side, W.inputs(), lambda d: _one(d, side), out)
    return out


@functools.lru_cache(maxsize=None)
def _jax_layered():
    """JAX's 3D calls of :func:`layered` on its (2, 2, 2) mesh of eight
    virtual CPU devices: the stacks by tag, the bounds, ``to_local`` and
    ``to_dist2d`` of the product."""
    import combblas_tpu.parallel.summa3d as j3
    inp = W.inputs()
    g3 = jgrid(2, 2, 2)
    a3 = j3.Dist3DSpMat.from_dist2d(JCOO.from_dense(inp["a"]), g3, "col")
    b3 = j3.Dist3DSpMat.from_dist2d(JCOO.from_dense(inp["b"]), g3, "row")
    fc, oc = j3.summa3d_bounds(a3, b3)
    c3 = j3.summa3d_spgemm(a3, b3, flops_cap=fc, out_capacity=oc)
    mats = dict(a3=a3, b3=b3, c3=c3, c3sat=j3.summa3d_spgemm(
        a3, b3, flops_cap=fc, out_capacity=W.SAT_CAP3),
        me3=j3.mem_efficient_spgemm3d(a3, b3, phases=2,
                                      phase_hook=W.doubled3))
    return mats, (fc, oc), c3.to_local(), c3.to_dist2d(jgrid(2, 2))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_summa3d(pods, name):
    """The layered grid across processes: ``from_dist2d`` ('col' and
    'row'), ``summa3d_spgemm`` (also at an output capacity that saturates
    some fibers, and on a 4-layer 2x2 grid whose fiber (0, 0) alone
    overflows), ``mem_efficient_spgemm3d(phases=2)`` with a hook: every
    process's stacks are its box of one process's bit for bit, the nnz
    tables exact; ``summa3d_bounds``, ``to_local`` and ``to_dist2d`` equal
    one process's.  On (2, 2, 2) the stacks equal JAX's (integers exactly,
    sums within rtol 1e-5), and so do the bounds, ``to_local`` and
    ``to_dist2d``."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    one = _one_layered(side)
    for tag in _STACKS3:
        _same_share3(ranks, tag, {f: one[f"{tag}_{f}"] for f in (
            "row", "col", "val", "nnz")})
    over = ranks[0]["over4_nnz"].reshape(4, 4)
    assert (over[:, 0] == W.OVER_CAP4).all()
    assert (over[:, 1:] < W.OVER_CAP4).all()
    assert (one["c3sat_nnz"] == W.SAT_CAP3).any()
    for r in ranks:
        for k in ("bounds3", "c3_local", "c3_local_val"):
            np.testing.assert_array_equal(r[k], one[k], err_msg=k)
    _same_share(ranks, "c3_2d", _one_layered_2d(side))
    if side == 2:
        mats, bounds, loc, d2 = _jax_layered()
        for tag, m in mats.items():
            _same_share3(ranks, tag, m, exact=tag in ("a3", "b3"))
        for r in ranks:
            assert tuple(r["bounds3"]) == bounds
            k = int(loc.nnz)
            np.testing.assert_array_equal(r["c3_local"], np.stack(
                [np.asarray(loc.row)[:k], np.asarray(loc.col)[:k]]))
            np.testing.assert_allclose(r["c3_local_val"],
                                       np.asarray(loc.val)[:k], rtol=1e-5,
                                       atol=0)
        _same_share(ranks, "c3_2d", d2, exact=False)


def _one_layered_2d(side: int):
    """One process's ``to_dist2d`` of :func:`layered`'s product."""
    one = _one_layered(side)
    return tdist.DistSpMat.from_numpy_blocks(
        one["c3_2d_row"], one["c3_2d_col"], one["c3_2d_val"],
        one["c3_2d_nnz"], (30, 34), tgrid(side, side))


@functools.lru_cache(maxsize=None)
def _jax_mcl3():
    r, c, w, shape = W.rmat7(W.MCL3_SEED)
    m = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(2, 2))
    return _mcl_run(jmcl, jel, m, phases=2, layers=2, grid3=jgrid(2, 2, 2))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_mcl_layers(pods, name):
    """``mcl_dist(layers=2, phases=2)`` of the scale-7 R-MAT of
    ``test_torch_mcl_dist.py`` (select 8, recover_num 10), its expansion
    on the layered grid over the processes: the label slices, the
    iteration count and the final iterate equal one process's bit for
    bit; on (2, 2, 2) the labels and iterations equal JAX's and the final
    iterate JAX's compacted (keys exact, values rtol 1e-5)."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    one = _one_layered(side)
    _same_vec(_vec_of(ranks, "mcl3_labels"), one["mcl3_labels"])
    for r in ranks:
        assert int(r["mcl3_iters"]) == int(one["mcl3_iters"])
    n = W.rmat7(W.MCL3_SEED)[3][0]
    final = tdist.DistSpMat.from_numpy_blocks(
        one["mcl3_final_row"], one["mcl3_final_col"], one["mcl3_final_val"],
        one["mcl3_final_nnz"], (n, n), tgrid(side, side))
    _same_share(ranks, "mcl3_final", final)
    if side == 2:
        jlabels, jiters, jfinal = _jax_mcl3()
        _same_vec(_vec_of(ranks, "mcl3_labels"), jlabels)
        assert int(ranks[0]["mcl3_iters"]) == jiters
        _same_local(_assemble(ranks, "mcl3_final", 2, final.gshape), jfinal)


# ------------------------------------------------------ HipMCL's pod path --

def _vec_of(ranks, tag):
    """A FullyDist vector from every process's slice, in rank order."""
    return np.concatenate([r[tag] for r in ranks])


def _same_vec(got, want, exact=True):
    """Vectors equal: bit for bit (floats by their bits), or sums within
    rtol 1e-5."""
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if not exact:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    elif got.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got, want)


def _assemble(ranks, tag, side, gshape):
    """The one-process DistSpMat of every process's ``tag`` stacks."""
    cap = ranks[0][f"{tag}_row"].shape[-1]
    full = {f: np.empty((side, side, cap), ranks[0][f"{tag}_{f}"].dtype)
            for f in ("row", "col", "val")}
    for r in ranks:
        (r0, c0), (lr, lc) = r["origin"], r["local_shape"]
        for f, x in full.items():
            x[r0:r0 + lr, c0:c0 + lc] = r[f"{tag}_{f}"]
    return tdist.DistSpMat.from_numpy_blocks(
        full["row"], full["col"], full["val"], ranks[0][f"{tag}_nnz"],
        gshape, tgrid(side, side))


def _same_local(t, j):
    """Compacted (``to_local``) port and JAX matrices: keys exact, values
    within rtol 1e-5."""
    jl, tl = j.to_local(), t.to_local()
    k = int(jl.nnz)
    assert int(tl.nnz) == k
    np.testing.assert_array_equal(tl.row[:k].numpy(), np.asarray(jl.row)[:k])
    np.testing.assert_array_equal(tl.col[:k].numpy(), np.asarray(jl.col)[:k])
    np.testing.assert_allclose(tl.val[:k].numpy(), np.asarray(jl.val)[:k],
                               rtol=1e-5, atol=0)


#: The tags of the elementwise stacks, and of the vectors with JAX
#: compared within rtol (float sums).
_EW_SUMS = ("reduce_row_plus", "reduce_col_plus", "reduce_premap")


def _elementwise(mod, a, a2, vec, ints, add):
    """The worker's elementwise calls in one process of ``mod`` (the port's
    or JAX's elementwise module): (stacks by tag, vectors by tag)."""
    inp = W.inputs()
    st = dict(apply=mod.dist_apply(a, W.doubled),
              prune=mod.dist_prune(a, W.small),
              emult0=mod.dist_ewise_mult(a, a2),
              emult1=mod.dist_ewise_mult(a, a2, exclude=True),
              add=mod.dist_add(a, a2),
              dimapply_row=mod.dist_dim_apply(a, vec(inp["row_x"]), "row"),
              dimapply_col=mod.dist_dim_apply(a, vec(inp["col_x"]), "col",
                                              add),
              prunecol=mod.dist_prune_column(a, vec(inp["thresh"]),
                                             W.below),
              transpose=mod.dist_transpose(a))
    srs = ints["srs"]
    kv = vec(inp["kvec"])
    vs = {f"reduce_{dim}_{name}": mod.dist_reduce(a, dim, sr)
          for dim in ("row", "col") for name, sr in srs.items()}
    vs.update(reduce_premap=mod.dist_reduce(a, "col", premap=W.squared),
              nnz_per_col=mod.dist_nnz_per_col(a),
              ksel_int=mod.dist_kselect_col(a, W.KSELECT_K),
              ksel_vec=mod.dist_kselect_col(a, kv, k_cap=W.KSELECT_CAP),
              ksel_full=mod.dist_kselect_col(a, kv, full_gather=True),
              ksel2_int=mod.dist_kselect2_col(a, W.KSELECT_K),
              ksel2_vec=mod.dist_kselect2_col(a, kv),
              ksel_checked=mod.dist_kselect_col_checked(a, kv))
    return st, {k: np.asarray(v) for k, v in vs.items()}


@functools.lru_cache(maxsize=None)
def _one_elementwise(side: int):
    inp = W.inputs()
    return _elementwise(
        tel, _one(inp["a"], side), _one(inp["a2"], side),
        lambda x: dist_vec(x, tgrid(side, side)),
        dict(srs=dict(plus=PLUS_TIMES, min=MIN_PLUS, max=MAX_FIRST)),
        torch.add)


@functools.lru_cache(maxsize=None)
def _jax_elementwise():
    inp = W.inputs()
    g = jgrid(2, 2)
    return _elementwise(
        jel, dist_pair(inp["a"], 2, 2)[0], dist_pair(inp["a2"], 2, 2)[0],
        lambda x: jdist.dist_vec(x, g),
        dict(srs=dict(plus=jsr.PLUS_TIMES, min=jsr.MIN_PLUS,
                      max=jsr.MAX_FIRST)), jnp.add)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_elementwise(pods, name):
    """The 12 functions of ``parallel/elementwise.py`` across processes:
    block-local ops, dimension ops reading vector spans, the column and
    row folds (sums in the one-process order), Kselect1 with an int k, a
    per-column k under ``k_cap`` and ``full_gather``, Kselect2, the
    checked pair and the transpose: every process's blocks and slices
    equal one process's bit for bit, and JAX's on 2x2."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    stacks, vecs = _one_elementwise(side)
    for tag, m in stacks.items():
        _same_share(ranks, tag, m)
    for tag, v in vecs.items():
        _same_vec(_vec_of(ranks, tag), v)
    if side == 2:
        jstacks, jvecs = _jax_elementwise()
        for tag, m in jstacks.items():
            _same_share(ranks, tag, m)
        for tag, v in jvecs.items():
            _same_vec(_vec_of(ranks, tag), v, exact=tag not in _EW_SUMS)


def _memefficient(me, a, b, **kw):
    """The worker's ``"xla"``-route phased products and the staged SUMMA
    in one process of ``me`` (the port's or JAX's module)."""
    fc, oc = tsu.summa_bounds(a, b) if me is tme else jsu.summa_bounds(a, b)
    out = dict(staged=me.summa_spgemm_staged(a, b, stage_flops_cap=fc,
                                             out_capacity=oc))
    for ph in (1, 2):
        out[f"phased{ph}"] = me.mem_efficient_spgemm(a, b, phases=ph,
                                                     impl="xla")
    out["phased_hook"] = me.mem_efficient_spgemm(
        a, b, phases=2, phase_hook=kw["hook"], impl="xla")
    return out


def _jax_hook(c):
    return jel.dist_prune(c, lambda v: v < 0.3)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_memefficient(pods, name):
    """The staged SUMMA, ``calculate_phases``, ``mem_efficient_spgemm``
    (phases 1 and 2 on both routes, the count from the sampling estimate,
    a hook) and every block ``block_spgemm`` yields: every process's
    blocks equal one process's bit for bit; the sampling estimate within
    1e-6 relative and the phase counts equal; the ``"xla"`` products
    JAX's on 2x2 (rtol 1e-5), ``block_spgemm``'s compacted blocks too."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp = W.inputs()
    ta, tb = _one(inp["a"], side), _one(inp["b"], side)
    est = tsp.est_nnz_spgemm_sampling(ta, tb, torch.Generator().manual_seed(0))
    for r in ranks:
        assert abs(float(r["estimate"]) - est) <= 1e-6 * abs(est)
        np.testing.assert_array_equal(r["phases"], [
            tme.calculate_phases(ta, tb, W.PHASE_BUDGET),
            tme.calculate_phases(ta, tb, W.PHASE_BUDGET, est_c_nnz=est)])
    assert ranks[0]["phases"][1] > 1
    want = _memefficient(tme, ta, tb, hook=W.hook)
    for ph in (1, 2):
        want[f"phased{ph}_k"] = tme.mem_efficient_spgemm(ta, tb, phases=ph)
    want["phased_auto"] = tme.mem_efficient_spgemm(
        ta, tb, per_device_mem_bytes=W.PHASE_BUDGET)
    blocks = dict(tme.block_spgemm(ta, tb, 2, 2))
    for (i, j), c in blocks.items():
        want[f"block{i}{j}"] = c
    for tag, m in want.items():
        _same_share(ranks, tag, m)
    if side == 2:
        ja, jb = dist_pair(inp["a"], 2, 2)[0], dist_pair(inp["b"], 2, 2)[0]
        for tag, m in _memefficient(jme, ja, jb, hook=_jax_hook).items():
            _same_share(ranks, tag, m, exact=False)
        for (i, j), c in jme.block_spgemm(ja, jb, 2, 2):
            _same_local(_assemble(ranks, f"block{i}{j}", 2, c.gshape), c)


@functools.lru_cache(maxsize=None)
def _one_mcl(side: int):
    """One process's ``dist_mcl_prune`` (both k-selects) of the worker's
    expansion and ``mcl_dist`` of its R-MAT: (prunes, labels, iterations,
    final iterate)."""
    e = _one(W.inputs()["expansion"], side)
    prunes = [tmcl.dist_mcl_prune(e, tmcl.MCLParams(**W.PRUNE_PARAMS),
                                  use_kselect2=k2) for k2 in (False, True)]
    r, c, w, shape = W.rmat7()
    m = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(side, side))
    return (prunes, *_mcl_run(tmcl, tel, m))


def _mcl_run(mcl_mod, el_mod, m, **kw):
    """``mcl_mod.mcl_dist(m, **kw)`` with its final iterate caught where it
    is transposed."""
    seen, orig = {}, el_mod.dist_transpose

    def caught(x):
        seen["a"] = x
        return orig(x)

    targets = [el_mod] + ([mcl_mod] if hasattr(mcl_mod, "dist_transpose")
                          else [])
    for t in targets:
        t.dist_transpose = caught
    try:
        labels, iters = mcl_mod.mcl_dist(
            m, mcl_mod.MCLParams(**W.MCL_PARAMS), **kw)
    finally:
        for t in targets:
            t.dist_transpose = orig
    return np.asarray(labels), int(iters), seen["a"]


@functools.lru_cache(maxsize=None)
def _jax_mcl():
    e = dist_pair(W.inputs()["expansion"], 2, 2)[0]
    prunes = [jmcl.dist_mcl_prune(e, jmcl.MCLParams(**W.PRUNE_PARAMS),
                                  use_kselect2=k2) for k2 in (False, True)]
    r, c, w, shape = W.rmat7()
    m = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(2, 2))
    return (prunes, *_mcl_run(jmcl, jel, m))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_mcl(pods, name):
    """``dist_mcl_prune`` with Kselect1 and Kselect2, then ``mcl_dist`` of
    a scale-7 SSCA R-MAT (select 8, recover_num 10) across processes:
    every process's prunes, label slice and final iterate equal one
    process's bit for bit, the iteration counts equal; on 2x2 the prunes
    equal JAX's slot for slot, the labels and iterations exactly, the
    final iterate compacted (keys exact, values rtol 1e-5)."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    prunes, labels, iters, final = _one_mcl(side)
    for k2, m in enumerate(prunes):
        _same_share(ranks, f"mclprune{k2}", m)
    _same_vec(_vec_of(ranks, "mcl_labels"), labels)
    for r in ranks:
        assert int(r["mcl_iters"]) == iters
    _same_share(ranks, "mcl_final", final)
    if side == 2:
        jprunes, jlabels, jiters, jfinal = _jax_mcl()
        for k2, m in enumerate(jprunes):
            _same_share(ranks, f"mclprune{k2}", m)
        _same_vec(_vec_of(ranks, "mcl_labels"), jlabels)
        assert int(ranks[0]["mcl_iters"]) == jiters
        _same_local(_assemble(ranks, "mcl_final", 2, final.gshape), jfinal)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_fastsv(pods, name):
    """``fastsv_dist`` across processes on the BFS graph and on a graph of
    7 components spread over the processes: the label slices equal one
    process's, and JAX's on 2x2, and count the components."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp = W.inputs()
    for tag, d in (("fastsv_g", inp["g"]), ("fastsv_comps", inp["comps"])):
        got = _vec_of(ranks, tag)
        _same_vec(got, tcc.fastsv_dist(_one(d, side)).numpy())
        if side == 2:
            _same_vec(got, np.asarray(jcc.fastsv_dist(
                dist_pair(d, 2, 2)[0])))
    n = inp["comps"].shape[0]
    assert tcc.count_components(_vec_of(ranks, "fastsv_comps"), n) == 7


# ------------------------------------------- HipMCL's preprocessing, LACC --

def _vector_results(mod, grid, put, perm, keys_perm) -> dict:
    """The worker's vector calls in one process of ``mod`` (the port's or
    JAX's vector module) on ``grid``, ``put`` making a vector of a host
    array; ``perm`` is the port's RandPerm (host), ``keys_perm`` the
    permutation of the keys: results by tag, as numpy."""
    v = W.vec_inputs()
    out = dict(perm_keys=keys_perm)
    for tag, k, combine in W.ROUTES:
        out[tag], out[f"{tag}_hit"] = mod.dist_route(
            put(v["ridx"]), put(v[f"rval_{k}"]), put(v["rmask"]),
            put(v[f"rinit_{k}"]), grid, combine=combine)
    out["gather"] = mod.dist_gather(put(v["gx"]), put(v["gidx"]), grid)
    out["apply_perm"] = mod.dist_apply_perm(put(v["gx"]), put(perm), grid)
    out["invert"], out["invert_hit"] = mod.dist_invert(
        put(v["inv"]), put(v["inv_mask"]), grid)
    out["invert_perm"], out["invert_perm_hit"] = mod.dist_invert(
        put(perm), put(perm < W.PERM_N), grid)
    for tag in W.UNIQS:
        out[tag], out[f"{tag}_hit"] = mod.dist_uniq(
            put(v[tag]), put(v[f"{tag}_mask"]), grid)
    return {k: np.asarray(x) for k, x in out.items()}


@functools.lru_cache(maxsize=None)
def _one_vectors(side: int):
    """One process's vector results, and its RandPerm."""
    g = tgrid(side, side)
    perm = tvec.dist_rand_perm(torch.Generator().manual_seed(W.PERM_SEED),
                               W.PERM_N, g).numpy()
    keys = W.vec_inputs()["keys"]
    got = _vector_results(tvec, g, lambda x: torch.from_numpy(np.array(x)),
                          perm, tvec.perm_from_keys(torch.from_numpy(keys),
                                                    W.PERM_N, g))
    return got, perm


@functools.lru_cache(maxsize=None)
def _jax_vectors():
    """JAX's vector results on 2x2, given the port's RandPerm; JAX's
    RandPerm of the worker's keys is its ``dist_sort`` of them carrying
    the identity, the slots past n marked n (``dist_rand_perm``'s body
    without its threefry draw)."""
    jg = jgrid(2, 2)
    keys = W.vec_inputs()["keys"].astype(np.uint32)
    iota = np.arange(W.VEC_PAD, dtype=np.int32)
    _, kp = jvec.dist_sort(jdist.dist_vec(keys, jg), jg,
                           jdist.dist_vec(iota, jg), length=W.PERM_N)
    kp = np.where(iota < W.PERM_N, np.asarray(kp), W.PERM_N)
    return _vector_results(jvec, jg, lambda x: jdist.dist_vec(x, jg),
                           _one_vectors(2)[1], kp)


#: The vector results that are float sums.
_VEC_SUMS = ("route_f_sum",)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_vectors(pods, name):
    """``perm_from_keys``, ``dist_rand_perm``, ``dist_route`` (every
    combine, float and int, duplicate / masked / out-of-range / negative
    indices), ``dist_gather``, ``dist_apply_perm``, ``dist_invert`` and
    ``dist_uniq`` (a run of one value across a slice boundary; the pad-key
    NaN beside a dead slot) across processes: every process's slices,
    put together, equal one process's vectors bit for bit, and JAX's on
    2x2 (the float sum within rtol 1e-5)."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    want, perm = _one_vectors(side)
    for r in ranks:
        _same_vec(r["rand_perm"], perm)
        for tag, v in want.items():
            _same_vec(r[tag], v)
    assert (perm[W.PERM_N:] == W.PERM_N).all() and np.array_equal(
        np.sort(perm[:W.PERM_N]), np.arange(W.PERM_N))
    if side == 2:
        for tag, v in _jax_vectors().items():
            _same_vec(ranks[0][tag], v, exact=tag not in _VEC_SUMS)


def _index_results(ix, a, gr, b, grid, sr_min) -> dict:
    """The worker's indexing calls in one process of ``ix`` (the port's or
    JAX's indexing module): DistSpMats by tag."""
    m = W.index_inputs()
    return dict(
        sel=ix.dist_selector(W.SPREF_ROWS, 30, grid),
        selt=ix.dist_selector(W.SPREF_COLS, 26, grid, transpose=True),
        spref=ix.dist_spref(a, W.SPREF_ROWS, W.SPREF_COLS),
        pruneblk=ix.dist_prune_block(a, W.SPASGN_ROWS, W.SPASGN_COLS),
        spasgn=ix.dist_spasgn(a, W.SPASGN_ROWS, W.SPASGN_COLS, b),
        permute=ix.dist_permute(gr, m["perm"]),
        permute_fold=ix.dist_permute(a, m["rmap"], m["cmap"]),
        permute_min=ix.dist_permute(a, m["rmap"], m["cmap"], sr=sr_min),
        permute_retry=ix.dist_permute(a, m["rmap"], m["cmap"],
                                      out_capacity=8))


#: Products (compared with JAX compacted) and float folds of duplicates.
_IX_PRODUCTS = ("spref", "spasgn")
_IX_SUMS = ("permute_fold", "permute_retry")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_indexing(pods, name):
    """The selectors, SpRef, the block prune, SpAsgn and ``dist_permute``
    (a permutation; maps that fold duplicates under plus-times and
    min-plus and drop entries; a capacity that retries) across processes:
    every process's blocks equal one process's slot for slot, values bit
    for bit; on 2x2 JAX's slot for slot (fold sums within rtol 1e-5),
    SpRef and SpAsgn compacted."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp = W.inputs()
    asg = W.index_inputs()["asg"]
    want = _index_results(tix, _one(inp["a"], side), _one(inp["g"], side),
                          _one(asg, side), tgrid(side, side), MIN_PLUS)
    for tag, m in want.items():
        _same_share(ranks, tag, m)
    assert want["permute_retry"].capacity > 8
    if side == 2:
        jm = _index_results(
            jix, dist_pair(inp["a"], 2, 2)[0], dist_pair(inp["g"], 2, 2)[0],
            dist_pair(asg, 2, 2)[0], jgrid(2, 2), jsr.MIN_PLUS)
        for tag, m in jm.items():
            if tag in _IX_PRODUCTS:
                _same_local(_assemble(ranks, tag, 2, m.gshape), m)
            else:
                _same_share(ranks, tag, m, exact=tag not in _IX_SUMS)


@functools.lru_cache(maxsize=None)
def _one_preprocess(side: int):
    """One process's ``dist_remove_isolated``, ``dist_rand_permute`` and
    ``mcl_dist(preprocess=True)`` (the R-MAT and the components graph)."""
    g = tgrid(side, side)
    r, c, w, shape = W.rmat7_isolated()
    m = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, g)
    b, vmap, k = tmcl.dist_remove_isolated(m)
    b2, perm = tmcl.dist_rand_permute(b, torch.Generator().manual_seed(
        W.PRE_SEED))
    p = tmcl.MCLParams(**W.MCL_PARAMS)
    labels, iters = tmcl.mcl_dist(m, p, preprocess=True,
                                  generator=torch.Generator().manual_seed(
                                      W.PRE_SEED))
    d = W.components_loops()
    r, c = np.nonzero(d)
    cl, ci = tmcl.mcl_dist(
        tdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, g), p,
        preprocess=True, generator=torch.Generator().manual_seed(
            W.PRE_SEED))
    return dict(rmiso=b, randpermute=b2), vmap, k, perm, (
        labels.numpy(), iters), (cl.numpy(), ci)


@functools.lru_cache(maxsize=None)
def _jax_preprocess():
    """JAX's ``dist_remove_isolated`` and ``mcl_dist(preprocess=True)``
    (its default key) on 2x2."""
    r, c, w, shape = W.rmat7_isolated()
    m = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(2, 2))
    b, vmap, k = jmcl.dist_remove_isolated(m)
    labels, iters = jmcl.mcl_dist(m, jmcl.MCLParams(**W.MCL_PARAMS),
                                  preprocess=True)
    return b, np.asarray(vmap), int(k), np.asarray(labels), int(iters)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_mcl_preprocess(pods, name):
    """HipMCL's preprocessing across processes: ``dist_remove_isolated``
    (blocks, the whole keep map in every process, the kept count),
    ``dist_rand_permute`` (blocks, the whole permutation) and
    ``mcl_dist(preprocess=True)`` of an R-MAT with isolated vertices and
    of a 41-vertex graph (its label slices padded, a pad slot i labelled
    n + i): one process's bit for bit; on 2x2 the removal equals JAX's and
    the labels and iterations, given JAX's permutation, JAX's."""
    ranks, _ = pods(name)
    nproc, side = SCENARIOS[name]
    mats, vmap, k, perm, (labels, iters), (cl, ci) = _one_preprocess(side)
    assert 0 < k < vmap.shape[0]
    for tag, m in mats.items():
        _same_share(ranks, tag, m)
    nc = cl.shape[0]
    pad = -(-nc // nproc) * nproc
    assert pad > nc
    for r in ranks:
        np.testing.assert_array_equal(r["rmiso_map"], vmap)
        assert int(r["rmiso_k"]) == k
        np.testing.assert_array_equal(r["randpermute_perm"], perm)
        _same_vec(r["mclpre_labels"], labels)
        assert int(r["mclpre_iters"]) == iters
        got = r["mclpre_comps"]
        assert got.shape == (pad,)
        _same_vec(got[:nc], cl)
        np.testing.assert_array_equal(got[nc:], nc + np.arange(nc, pad))
        assert int(r["mclpre_comps_iters"]) == ci
    if side == 2:
        jb, jvmap, jk, jlabels, jiters = _jax_preprocess()
        _same_share(ranks, "rmiso", jb)
        np.testing.assert_array_equal(vmap, jvmap)
        assert k == jk
        for r in ranks:
            _same_vec(r["mclpre_jax_labels"], jlabels)
            assert int(r["mclpre_jax_iters"]) == jiters


def _mis_ok(d, in_set):
    """No edge inside the set, every vertex outside it beside one in it."""
    adj = d != 0
    s = np.asarray(in_set, bool)
    assert not (adj & s[:, None] & s[None, :]).any(), "not independent"
    assert (s | (adj & s[None, :]).any(1)).all(), "not maximal"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_lacc_mis(pods, name):
    """``lacc_dist`` and ``luby_mis_dist`` across processes on the BFS
    graph and the 7-component graph: the label and set slices, put
    together, equal one process's (the MIS drawn from one seed); the
    labels JAX's on 2x2 and the components counted; the set independent
    and maximal."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp = W.inputs()
    for tag in ("g", "comps"):
        d = inp[tag]
        n = d.shape[0]
        one = _one(d, side)
        labels = tlacc.lacc_dist(one).numpy()
        mis = tmis.luby_mis_dist(one, torch.Generator().manual_seed(
            W.MIS_SEED)).numpy()
        for r in ranks:
            _same_vec(r[f"lacc_{tag}"], labels)
            _same_vec(r[f"mis_{tag}"], mis)
        _mis_ok(d, mis[:n])
        assert not mis[n:].any()
        if side == 2:
            _same_vec(labels, np.asarray(jlacc.lacc_dist(
                dist_pair(d, 2, 2)[0])))
    n = inp["comps"].shape[0]
    assert tcc.count_components(ranks[0]["lacc_comps"], n) == 7


# ------------------------------------------ item 1.8's step 3 on a pod --

#: ``dist_spmm``'s semirings by tag.
_SPMM = {"plus": (PLUS_TIMES, jsr.PLUS_TIMES), "min": (MIN_PLUS, jsr.MIN_PLUS),
         "max": (MAX_TIMES, jsr.MAX_TIMES)}


def _same_rows(got, want, exact=True):
    """Dense rows equal: bit for bit, or within rtol 1e-5."""
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _rect(x, r, side):
    """Process ``r``'s rectangle of blocks of a padded dense matrix."""
    x = np.asarray(x)
    mb, nb = x.shape[0] // side, x.shape[1] // side
    (r0, c0), (lr, lc) = r["origin"], r["local_shape"]
    return x[r0 * mb:(r0 + lr) * mb, c0 * nb:(c0 + lc) * nb]


def _dense_results(dense, a, grid, put, tag):
    """The worker's dense calls of ``W.dense_inputs()[tag]`` in one
    process of ``dense`` (the port's or JAX's module)."""
    x = W.dense_inputs()[tag]
    p = put(x, grid)
    added = dense.dense_add_sparse(p, a)
    return dict(put=np.asarray(p), add=np.asarray(added),
                host=dense.dense_to_host(added, x.shape),
                row=np.asarray(dense.dense_reduce(p, "row")),
                col=np.asarray(dense.dense_reduce(p, "col")))


@functools.lru_cache(maxsize=None)
def _jax_dense_bc():
    """JAX's ``dist_spmm``, dense calls and BC on 2x2."""
    inp = W.inputs()
    ja, jg = dist_pair(inp["a"], 2, 2)[0], dist_pair(inp["g"], 2, 2)[0]
    x = W.dense_inputs()["spmm_x"]
    n_pad = tdist.col_vec_len(ja.gshape, tgrid(2, 2))
    spmm = {k: np.asarray(jdense.dist_spmm(ja, jnp.asarray(x[:n_pad]), j))
            for k, (_t, j) in _SPMM.items()}
    dense = {tag: _dense_results(jdense, ja, ja.grid, jdense.dense_put, tag)
             for tag in ("dense_x", "dense_q")}
    return spmm, dense, jbc.betweenness_centrality_dist(
        jg, batch_size=W.BC_BATCH)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_dense_bc(pods, name):
    """``dist_spmm`` (plus-times, min-plus, max-times) of a 30 x 26
    matrix, ``dense_put`` / ``dense_add_sparse`` / ``dense_to_host`` /
    ``dense_reduce`` and BC of the BFS graph in batches of 16, across
    processes: one process's bit for bit (``dense_reduce`` of normal
    floats within rtol 1e-5), JAX's on 2x2; ``dense_to_host`` and
    ``dense_reduce`` of a share without its grid refuse."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp = W.inputs()
    ta, tg = _one(inp["a"], side), _one(inp["g"], side)
    x = torch.from_numpy(W.dense_inputs()["spmm_x"])
    spmm = {k: tdense.dist_spmm(ta, x, t).numpy()
            for k, (t, _j) in _SPMM.items()}
    dense = {tag: _dense_results(tdense, ta, ta.grid, tdense.dense_put, tag)
             for tag in ("dense_x", "dense_q")}
    bc = tbc.betweenness_centrality_dist(tg, batch_size=W.BC_BATCH)
    for r in ranks:
        for k, want in spmm.items():
            _same_rows(r[f"spmm_{k}"], want)
        for tag, want in dense.items():
            for f in ("put", "add"):
                _same_rows(r[f"{tag}_{f}"], _rect(want[f], r, side))
            _same_rows(r[f"{tag}_host"], want["host"])
            for f in ("row", "col"):
                _same_rows(r[f"{tag}_{f}"], want[f], exact=tag == "dense_q")
        np.testing.assert_array_equal(r["bc"], bc)
        for what, msg in json.loads(str(r["dense_refused"])).items():
            assert "needs the matrix's grid" in msg, (what, msg)
    if side == 2:
        jspmm, jdense_, jbc_ = _jax_dense_bc()
        for k, want in jspmm.items():
            _same_rows(ranks[0][f"spmm_{k}"], want, exact=k != "plus")
        for tag, want in jdense_.items():
            for f in ("put", "add"):
                for r in ranks:
                    _same_rows(r[f"{tag}_{f}"], _rect(want[f], r, side))
            _same_rows(ranks[0][f"{tag}_host"], want["host"])
            for f in ("row", "col"):
                _same_rows(ranks[0][f"{tag}_{f}"], want[f], exact=False)
        np.testing.assert_allclose(ranks[0]["bc"], jbc_, rtol=1e-5,
                                   atol=1e-6)


def _md_graph(grid, mod):
    r, c, n = W.md_stencil()
    return mod.DistSpMat.from_coo_arrays(r, c, np.ones(r.shape[0]), (n, n),
                                         grid)


@functools.lru_cache(maxsize=None)
def _jax_orderings():
    inp = W.inputs()
    return (jord.rcm_order_dist(dist_pair(inp["comps"], 2, 2)[0]),
            jord.rcm_order_dist(dist_pair(inp["g"], 2, 2)[0],
                                start=W.RCM_START),
            np.asarray(jord.md_order_dist(_md_graph(jgrid(2, 2), jdist))))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_orderings(pods, name):
    """``rcm_order_dist`` of the 7-component graph and of the BFS graph
    from a given start, and ``md_order_dist`` of the 5 x 5 stencil,
    across processes: every process's whole order equals one process's,
    JAX's on 2x2, and the minimum degree ``md_order``'s."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    inp = W.inputs()
    want = dict(
        rcm_comps=tord.rcm_order_dist(_one(inp["comps"], side)),
        rcm_g=tord.rcm_order_dist(_one(inp["g"], side), start=W.RCM_START),
        md=tord.md_order_dist(_md_graph(tgrid(side, side), tdist)).numpy())
    r, c, n = W.md_stencil()
    from combblas_tpu_torch.ops.coo import SpCOO
    np.testing.assert_array_equal(want["md"], tord.md_order(
        SpCOO.from_arrays(r, c, np.ones(r.shape[0], np.float32), (n, n),
                          device="cpu")).numpy())
    for rk in ranks:
        for tag, w in want.items():
            np.testing.assert_array_equal(rk[tag], w, err_msg=tag)
    if side == 2:
        for tag, w in zip(("rcm_comps", "rcm_g", "md"), _jax_orderings()):
            np.testing.assert_array_equal(ranks[0][tag], w, err_msg=tag)


#: The matchings the worker runs, by tag: (port call, JAX call).
_MATCHINGS = {
    "maximal": (tpm.dist_bp_maximal, jpm.dist_bp_maximal),
    "maximum": (tpm.dist_bp_maximum, jpm.dist_bp_maximum),
    "awpm": (tpm.dist_awpm, jpm.dist_awpm),
    "awpm_greedy": (lambda m: tpm.dist_awpm(m, complete=False),
                    lambda m: jpm.dist_awpm(m, complete=False))}


@functools.lru_cache(maxsize=None)
def _jax_matchings():
    ja = dist_pair(W.inputs()["a"], 2, 2)[0]
    return {k: tuple(np.asarray(x) for x in j(ja))
            for k, (_t, j) in _MATCHINGS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_matchings(pods, name):
    """``dist_bp_maximal``, ``dist_bp_maximum`` and ``dist_awpm`` (with and
    without the completion) of the weighted 30 x 26 matrix across
    processes: the mate slices, put together, equal one process's and
    JAX's (2x2) exactly, padding slots included."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    ta = _one(W.inputs()["a"], side)
    for tag, (t, _j) in _MATCHINGS.items():
        mr, mc = t(ta)
        for r in ranks:
            _same_vec(r[f"{tag}_row"], mr.numpy())
            _same_vec(r[f"{tag}_col"], mc.numpy())
    assert (ranks[0]["maximum_row"] >= 0).sum() >= (
        ranks[0]["maximal_row"] >= 0).sum()
    if side == 2:
        for tag, (mr, mc) in _jax_matchings().items():
            _same_vec(ranks[0][f"{tag}_row"], mr)
            _same_vec(ranks[0][f"{tag}_col"], mc)


def _mg_graph(grid):
    r, c, v, n = W.stencil(W.MG_SIDE, 3)
    return tdist.DistSpMat.from_coo_arrays(r, c, v, (n, n), grid)


@functools.lru_cache(maxsize=None)
def _one_multigrid(side: int):
    """One process's MIS-2, R and R·A·Rᵀ of the 8³ stencil."""
    st = _mg_graph(tgrid(side, side))
    s2 = tmg.mis2_dist(st, torch.Generator().manual_seed(W.MG_SEED))
    rop = tmg.restriction_op_dist(st, torch.Generator().manual_seed(
        W.MG_SEED))
    return s2, rop, tmg.galerkin_dist(rop, st)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_multigrid(pods, name):
    """``mis2_dist``, ``mis2_verify_dist``, ``restriction_op_dist`` and
    ``galerkin_dist`` of the 8³ stencil across processes: the set, R's
    blocks and R·A·Rᵀ's blocks equal one process's bit for bit; the set
    is a distance-2 MIS (and the check says so, and refuses its
    complement), every fine vertex lies within two hops of its coarse
    vertex; on 2x2 R·A·Rᵀ equals JAX's ``galerkin_dist`` of the same R,
    compacted, within rtol 1e-5."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    s2, rop, gal = _one_multigrid(side)
    for r in ranks:
        np.testing.assert_array_equal(r["mis2"], s2)
        np.testing.assert_array_equal(r["mis2_ok"], [True, False])
    _same_share(ranks, "restrict", rop)
    _same_share(ranks, "galerkin", gal)
    r_, c_, v_, n = W.stencil(W.MG_SIDE, 3)
    d = np.zeros((n, n), np.float32)
    d[r_, c_] = v_
    check_mis2(d, s2)
    check_r(d, rop.to_dense(), hops=2)
    if side == 2:
        rl = rop.to_local()
        k = int(rl.nnz)
        jr = jdist.DistSpMat.from_local(JCOO.from_arrays(
            rl.row[:k].numpy(), rl.col[:k].numpy(), rl.val[:k].numpy(),
            rop.gshape), jgrid(2, 2))
        ja = jdist.DistSpMat.from_coo_arrays(r_, c_, v_, (n, n), jgrid(2, 2))
        _same_local(_assemble(ranks, "galerkin", 2, gal.gshape),
                    jmg.galerkin_dist(jr, ja))


@functools.lru_cache(maxsize=None)
def _jax_filtered():
    jg = dist_pair(W.codes_graph(), 2, 2)[0]
    bfs = {root: tuple(np.asarray(x) for x in jfil.bfs_filtered_dist(
        jg, root, W.heavy)) for root in W.BFS_ROOTS}
    return jfil.materialize_filtered_dist(jg, W.heavy), bfs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pod_filtered(pods, name):
    """``materialize_filtered_dist``, ``bfs_filtered_dist`` from two roots
    and ``mis_filtered_dist`` of the BFS graph with edge codes 1 / 2, the
    heavy edges kept, across processes: one process's bit for bit; the
    prune JAX's on compacted entries exactly and the BFS JAX's exactly
    (2x2); the MIS independent and maximal in the filtered graph."""
    ranks, _ = pods(name)
    side = SCENARIOS[name][1]
    d = W.codes_graph()
    tw = _one(d, side)
    _same_share(ranks, "fmat", tfil.materialize_filtered_dist(tw, W.heavy))
    fmis = tfil.mis_filtered_dist(tw, torch.Generator().manual_seed(
        W.FMIS_SEED), W.heavy).numpy()
    for root in W.BFS_ROOTS:
        p, lv = tfil.bfs_filtered_dist(tw, root, W.heavy)
        for r in ranks:
            _same_vec(r[f"fbfs{root}_parents"], p.numpy())
            _same_vec(r[f"fbfs{root}_levels"], lv.numpy())
    for r in ranks:
        _same_vec(r["fmis"], fmis)
    n = d.shape[0]
    _mis_ok(np.where(W.heavy(d), d, 0.0), fmis[:n])
    assert not fmis[n:].any()
    if side == 2:
        jmat, jbfs_ = _jax_filtered()
        got = _assemble(ranks, "fmat", 2, jmat.gshape).to_local()
        want = jmat.to_local()
        k = int(want.nnz)
        assert int(got.nnz) == k
        for f in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(got, f)[:k].numpy(),
                                          np.asarray(getattr(want, f))[:k])
        for root, (p, lv) in jbfs_.items():
            _same_vec(ranks[0][f"fbfs{root}_parents"], p)
            _same_vec(ranks[0][f"fbfs{root}_levels"], lv)
