"""The port's 3D split-layer SpGEMM vs the JAX package's on a (2, 2, 2)
grid: JAX on eight virtual CPU devices, the port's (l, pr, pc) block stacks
on the CPU.  Stacks, nnz (the saturated retry signal included) and pads
exact; values exact for min/max folds, within rtol 1e-5 for sums."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.parallel import summa3d as j3  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel import summa3d as t3  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    assert_same_blocks,
    jgrid,
    tgrid,
)


def _pair3(d, split, layers=2, side=2):
    j = j3.Dist3DSpMat.from_dist2d(JCOO.from_dense(d),
                                   jgrid(side, side, layers), split)
    t = t3.Dist3DSpMat.from_dist2d(TCOO.from_dense(d, device="cpu"),
                                   tgrid(side, side, layers), split)
    return j, t


def _same_local(t, j):
    tl, jl = t.to_local(), j.to_local()
    row, col, val, nnz, shape = tl.to_numpy()
    assert (nnz, shape) == (int(jl.nnz), tuple(jl.shape))
    np.testing.assert_array_equal(row, np.asarray(jl.row))
    np.testing.assert_array_equal(col, np.asarray(jl.col))
    np.testing.assert_allclose(val, np.asarray(jl.val), rtol=1e-5)


@pytest.mark.parametrize("split", ["col", "row"])
@pytest.mark.parametrize("shape", [(17, 13), (16, 16), (9, 30)])
def test_3d_layout_matches_jax(split, shape):
    d = rand_sparse(*shape, 0.3, seed=80)
    j, t = _pair3(d, split)
    assert_same_blocks(t, j, exact=True)
    assert t.layer_shape() == j.layer_shape()
    assert t.block_shape() == j.block_shape()
    _same_local(t, j)
    np.testing.assert_allclose(t.to_local().to_dense().numpy(), d, rtol=1e-6)


def test_3d_to_dist2d_matches_jax():
    d = rand_sparse(17, 13, 0.3, seed=80)
    j, t = _pair3(d, "col")
    assert_same_blocks(t.to_dist2d(tgrid(2, 2)), j.to_dist2d(jgrid(2, 2)),
                       exact=True)
    with pytest.raises(ValueError):
        t3.Dist3DSpMat.from_dist2d(TCOO.from_dense(d, device="cpu"),
                                   tgrid(2, 2), "col")


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_times"])
@pytest.mark.parametrize("seeds", [(81, 82), (83, 83)])
def test_summa3d_matches_jax(sr_name, seeds):
    da = rand_sparse(16, 16, 0.35, seed=seeds[0])
    db = rand_sparse(16, 16, 0.35, seed=seeds[1])
    ja, ta = _pair3(da, "col")
    jb, tb = _pair3(db, "row")
    fc, oc = j3.summa3d_bounds(ja, jb)
    assert t3.summa3d_bounds(ta, tb) == (fc, oc)
    jc = j3.summa3d_spgemm(ja, jb, jsr.get_semiring(sr_name), flops_cap=fc,
                           out_capacity=oc)
    tc = t3.summa3d_spgemm(ta, tb, tsr.get_semiring(sr_name), flops_cap=fc,
                           out_capacity=oc)
    assert tc.split == jc.split == "blockcol"
    assert tc.block_shape() == jc.block_shape()
    assert_same_blocks(tc, jc, exact=sr_name != "plus_times")
    _same_local(tc, jc)


def test_summa3d_fiber_overflow_saturates_like_jax():
    """Four layers, every product in the first layer's column range: one
    layer sends 4096 entries where the fiber chunk holds max(2*ceil(4096/4),
    2048) = 2048, so the fiber's nnz saturates at out_capacity on both (the
    retry signal)."""
    rng = np.random.default_rng(86)
    d = np.zeros((128, 128), np.float32)
    d[:, :32] = rng.random((128, 32)).astype(np.float32) + 0.5
    ja, ta = _pair3(d, "col", layers=4, side=1)
    jb, tb = _pair3(d, "row", layers=4, side=1)
    fc, _ = j3.summa3d_bounds(ja, jb)
    oc = 4096
    jc = j3.summa3d_spgemm(ja, jb, flops_cap=fc, out_capacity=oc)
    tc = t3.summa3d_spgemm(ta, tb, flops_cap=fc, out_capacity=oc)
    assert (np.asarray(jc.nnz) == oc).all()
    assert_same_blocks(tc, jc)


@pytest.mark.parametrize("phases", [1, 2, 3])
def test_mem_efficient_spgemm3d_matches_jax(phases):
    da = rand_sparse(16, 16, 0.35, seed=84)
    db = rand_sparse(16, 16, 0.35, seed=85)
    ja, ta = _pair3(da, "col")
    jb, tb = _pair3(db, "row")
    jc = j3.mem_efficient_spgemm3d(ja, jb, phases=phases)
    tc = t3.mem_efficient_spgemm3d(ta, tb, phases=phases)
    assert_same_blocks(tc, jc)
    np.testing.assert_allclose(tc.to_local().to_dense().numpy(), da @ db,
                               rtol=1e-4, atol=1e-6)
