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
from combblas_tpu_torch.gen.rmat import rmat_matrix  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.spgemm import (  # noqa: E402
    round_capacity_frac,
    spgemm_auto,
    spgemm_flops,
)
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


def _layer_panel_counts(a3, b3) -> np.ndarray:
    """(l, pr, pc) products of each block's layer panels, from the blocks'
    entries: A's block (t, i, s) and B's block (t, s, j) meet on layer t's
    inner index s * kb + (A's column, B's row)."""
    l, pr, pc = a3.nnz.shape
    kb = a3.block_shape()[1]
    assert b3.block_shape()[0] == kb
    out = np.zeros((l, pr, pc), np.int64)
    for t in range(l):
        cnt_a = np.zeros((pr, pc * kb), np.int64)
        cnt_b = np.zeros((pc, pr * kb), np.int64)
        for i, s in np.ndindex(pr, pc):
            k = int(a3.nnz[t, i, s])
            np.add.at(cnt_a[i], s * kb + a3.col[t, i, s, :k].numpy(), 1)
        for s, j in np.ndindex(pr, pc):
            k = int(b3.nnz[t, s, j])
            np.add.at(cnt_b[j], s * kb + b3.row[t, s, j, :k].numpy(), 1)
        out[t] = cnt_a @ cnt_b.T
    return out


def _banded(n: int) -> np.ndarray:
    i, j = np.indices((n, n))
    return np.where(abs(i - j) <= 2, (i + 2 * j) % 5 + 1, 0).astype(
        np.float32)


def _empty_block_row(n: int) -> np.ndarray:
    """Rows n/2 .. n-1 empty, so that the last block row of each grid of
    the test holds no entry."""
    rng = np.random.default_rng(87)
    d = np.where(rng.random((n, n)) < 0.15,
                 rng.integers(1, 4, (n, n)), 0).astype(np.float32)
    d[n // 2:] = 0
    return d


def _rmat(n: int):
    gen = torch.Generator().manual_seed(88)
    a = rmat_matrix(gen, int(np.log2(n)), edgefactor=4)
    return a.to_dense().numpy()


@pytest.mark.parametrize("matrix", ["rmat", "banded", "empty_block_row"])
@pytest.mark.parametrize("layers, pr, pc", [(2, 2, 2), (4, 2, 2), (2, 3, 3),
                                            (2, 4, 4), (4, 4, 4)])
def test_summa3d_layer_bounds(matrix, layers, pr, pc):
    """The 3D SUMMA's caps from each block's layer panels: the largest
    block's exact count rounded as ``summa_bounds`` rounds, within the
    whole-product bound, and enough for the product: C equals
    ``spgemm_auto``'s slot for slot, no fiber saturated."""
    n = 64
    d = {"rmat": _rmat, "banded": _banded,
         "empty_block_row": _empty_block_row}[matrix](n)
    a = TCOO.from_dense(torch.from_numpy(d), device="cpu")
    g = tgrid(pr, pc, layers)
    a3 = t3.Dist3DSpMat.from_dist2d(a, g, "col")
    b3 = t3.Dist3DSpMat.from_dist2d(a, g, "row")
    if matrix == "empty_block_row":
        assert int(a3.nnz[:, -1].sum()) == 0
    counts = _layer_panel_counts(a3, b3)
    assert counts.sum() == spgemm_flops(a, a)
    fc, oc = t3.summa3d_layer_bounds(a3, b3)
    assert fc == oc == round_capacity_frac(int(counts.max()))
    assert fc <= t3.summa3d_bounds(a3, b3)[0]
    c = t3.summa3d_spgemm(a3, b3, flops_cap=fc, out_capacity=oc)
    assert int(c.nnz.max()) < oc
    got, want = c.to_local(), spgemm_auto(a, a)
    nnz = int(want.nnz)
    assert int(got.nnz) == nnz > 0
    for f in ("row", "col", "val"):
        assert torch.equal(getattr(got, f)[:nnz], getattr(want, f)[:nnz]), f
