"""The port's block grid and DistSpMat vs the JAX package's ProcGrid and
DistSpMat, on shared numpy inputs.

JAX lays its blocks on a virtual CPU mesh of pr*pc devices; the port keeps
the same (pr, pc, cap) block stacks on one device (the CPU here).  Stacks,
pads, nnz and every layout helper must agree slot for slot.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu.parallel.grid import ProcGrid as JGrid  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from combblas_tpu_torch.parallel import multihost as tmh  # noqa: E402
from combblas_tpu_torch.parallel.grid import ProcGrid as TGrid  # noqa: E402
from combblas_tpu_torch.parallel.grid import default_grid  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402

GRIDS = [(1, 1), (2, 2), (4, 2), (2, 4), (1, 8), (8, 1), (2, 3)]


def jgrid(pr, pc, layers=1):
    return JGrid.make(pr, pc, layers=layers,
                      devices=jax.devices()[: pr * pc * layers])


def tgrid(pr, pc, layers=1):
    return TGrid.make(pr, pc, layers=layers, device="cpu")


def dist_pair(d, pr=2, pc=2, capacity=None):
    """(JAX DistSpMat, port DistSpMat) of the dense array ``d``."""
    j = jdist.DistSpMat.from_local(JCOO.from_dense(d), jgrid(pr, pc),
                                   capacity=capacity)
    t = tdist.DistSpMat.from_local(TCOO.from_dense(d, device="cpu"),
                                   tgrid(pr, pc), capacity=capacity)
    return j, t


def assert_same_blocks(t, j, exact=False):
    """Port stacks == JAX stacks: rows, cols, nnz and pads exact; values
    exact or within rtol 1e-5 (sums fold in another order)."""
    for f in ("row", "col", "nnz"):
        jx, tx = np.asarray(getattr(j, f)), getattr(t, f).cpu().numpy()
        assert jx.shape == tx.shape, (f, jx.shape, tx.shape)
        np.testing.assert_array_equal(tx, jx, err_msg=f)
    jv, tv = np.asarray(j.val), t.val.cpu().numpy()
    assert jv.shape == tv.shape
    if exact:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=0)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("gshape", [(1, 1), (19, 23), (64, 64), (31, 7),
                                    (100, 3), (5, 97)])
def test_block_dims_and_vec_lens(grid, gshape):
    jg, tg = jgrid(*grid), tgrid(*grid)
    assert tdist.block_dims(gshape, tg) == jdist.block_dims(gshape, jg)
    assert tdist.row_vec_len(gshape, tg) == jdist.row_vec_len(gshape, jg)
    assert tdist.col_vec_len(gshape, tg) == jdist.col_vec_len(gshape, jg)


def test_grid_shape_and_equality():
    g = tgrid(2, 4)
    jg = jgrid(2, 4)
    assert (g.pr, g.pc, g.layers, g.nprocs, g.is3d) == (
        jg.pr, jg.pc, jg.layers, jg.nprocs, jg.is3d)
    g3, jg3 = tgrid(2, 2, 2), jgrid(2, 2, 2)
    assert (g3.layers, g3.nprocs, g3.is3d) == (jg3.layers, jg3.nprocs,
                                                jg3.is3d)
    assert g3.grid2d() == tgrid(2, 2) and not g3.grid2d().is3d
    assert g == tgrid(2, 4) and g != tgrid(4, 2) and hash(g) == hash(
        tgrid(2, 4))
    one = TGrid.make(device="cpu")
    assert (one.pr, one.pc, one.layers) == (1, 1, 1)
    assert default_grid(2, device="cpu") == TGrid(1, 1, 2, one.device)
    with pytest.raises(ValueError):
        TGrid.make(0, 2, device="cpu")


def test_grid_device_defaults_to_the_card():
    """Without a device the grid is on the card; with no card it raises."""
    if torch.cuda.is_available():
        assert TGrid.make(2, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TGrid.make(2, 2)


@pytest.mark.parametrize("grid", [(2, 2), (4, 2), (1, 8)])
@pytest.mark.parametrize("capacity", [None, 300])
def test_from_coo_arrays_matches_jax(grid, capacity):
    """Global triples with duplicates: the same block stacks slot for slot
    (pads and the power-of-two capacity included), duplicates summed."""
    rng = np.random.default_rng(sum(grid) + (capacity or 0))
    m, n, e = 37, 29, 300
    r = rng.integers(0, m, e)
    c = rng.integers(0, n, e)
    v = rng.random(e).astype(np.float32)
    j = jdist.DistSpMat.from_coo_arrays(r, c, v, (m, n), jgrid(*grid),
                                        capacity=capacity)
    t = tdist.DistSpMat.from_coo_arrays(r, c, v, (m, n), tgrid(*grid),
                                        capacity=capacity)
    assert_same_blocks(t, j)
    assert t.capacity == j.capacity and t.block_shape() == j.block_shape()
    assert t.gshape == j.gshape and t.dtype == torch.float32


@pytest.mark.parametrize("grid", [(2, 2), (4, 2), (2, 3)])
def test_to_local_roundtrip_matches_jax(grid):
    d = rand_sparse(19, 23, 0.3, seed=50)
    j, t = dist_pair(d, *grid)
    assert_same_blocks(t, j, exact=True)
    jl, tl = j.to_local(), t.to_local()
    row, col, val, nnz, shape = tl.to_numpy()
    assert (nnz, shape) == (int(jl.nnz), tuple(jl.shape))
    np.testing.assert_array_equal(row, np.asarray(jl.row))
    np.testing.assert_array_equal(col, np.asarray(jl.col))
    np.testing.assert_array_equal(val, np.asarray(jl.val))
    np.testing.assert_allclose(t.to_dense(), d, rtol=1e-6)
    assert int(t.total_nnz()) == int(j.total_nnz()) == np.count_nonzero(d)


def test_from_numpy_blocks_is_bit_for_bit():
    d = rand_sparse(30, 26, 0.15, seed=60)
    j, _ = dist_pair(d, 4, 2)
    t = tdist.DistSpMat.from_numpy_blocks(
        np.asarray(j.row), np.asarray(j.col), np.asarray(j.val),
        np.asarray(j.nnz), j.gshape, tgrid(4, 2))
    assert_same_blocks(t, j, exact=True)
    assert t.nnz.dtype == torch.int64
    np.testing.assert_allclose(t.to_dense(), d, rtol=1e-6)
    with pytest.raises(ValueError):
        tdist.DistSpMat.from_numpy_blocks(
            np.asarray(j.row), np.asarray(j.col), np.asarray(j.val),
            np.asarray(j.nnz), j.gshape, tgrid(2, 4))


def test_load_imbalance_and_local_block():
    d = rand_sparse(40, 40, 0.2, seed=51)
    d[:10, :10] = 1.0                  # a heavy block
    j, t = dist_pair(d, 2, 2)
    assert float(t.load_imbalance()) == pytest.approx(
        float(j.load_imbalance()), rel=1e-6)
    blk = tdist.local_block(t, 1, 0)
    jb = jdist.local_block(j, j.row[1:2, 0:1], j.col[1:2, 0:1],
                           j.val[1:2, 0:1], j.nnz[1:2, 0:1])
    assert blk.shape == tuple(jb.shape)
    assert int(blk.nnz) == int(jb.nnz)
    np.testing.assert_array_equal(blk.row.numpy(), np.asarray(jb.row))
    np.testing.assert_array_equal(blk.col.numpy(), np.asarray(jb.col))


@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
def test_dist_vec_and_global_put(grid):
    x = np.arange(1, 20, dtype=np.float32)
    jv = np.asarray(jdist.dist_vec(x, jgrid(*grid)))
    tv = tdist.dist_vec(x, tgrid(*grid))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tdist.DistVec(tgrid(*grid), 19).padded == jdist.DistVec(
        jgrid(*grid), 19).padded
    y = tmh.global_put(np.arange(6, dtype=np.int32), tgrid(*grid))
    assert y.dtype == torch.int32 and y.tolist() == list(range(6))
