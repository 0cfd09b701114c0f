"""The port's distributed elementwise ops, reductions, transpose and
k-select (``parallel/elementwise.py``) vs the JAX package's, on shared
numpy inputs, on 1x1, 2x2 and 4x2 grids (JAX on the virtual CPU devices).

Tolerances: every block stack through ``assert_same_blocks`` (rows,
columns, nnz and pads exact; values exact where no sum is involved, else
rtol 1e-5); vectors exact except float sums (rtol 1e-5); k-select
thresholds exact.  The ValueError paths are JAX's: a per-column k with no
candidate bound, a transpose on a non-square grid.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.parallel import elementwise as jel  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.parallel import elementwise as tel  # noqa: E402
from combblas_tpu_torch.parallel.dist import col_vec_len  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import assert_same_blocks, dist_pair  # noqa: E402

GRIDS = [(1, 1), (2, 2), (4, 2)]
SQUARE = [(1, 1), (2, 2)]


def _vec(t, j, exact=True):
    jx, tx = np.asarray(j), t.cpu().numpy()
    assert tx.shape == jx.shape and tx.dtype == jx.dtype, (tx.shape,
                                                            jx.shape)
    if exact:
        np.testing.assert_array_equal(tx, jx)
    else:
        np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=0)


def _pair(grid, m=37, n=29, density=0.2, seed=20):
    return dist_pair(rand_sparse(m, n, density, seed=seed), *grid)


def _jdouble(v):
    return v * 2.0


def _tdouble(v):
    return v * 2.0


def _jsmall(v):
    return v < 0.5


def _tsmall(v):
    return v < 0.5


def _below(v, t):
    return v < t


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_apply_and_prune(grid):
    j, t = _pair(grid)
    assert_same_blocks(tel.dist_apply(t, _tdouble),
                       jel.dist_apply(j, _jdouble), exact=True)
    assert_same_blocks(tel.dist_prune(t, _tsmall),
                       jel.dist_prune(j, _jsmall), exact=True)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("out_capacity", [None, 128])
def test_dist_ewise_mult(grid, exclude, out_capacity):
    j1, t1 = _pair(grid, seed=21)
    j2, t2 = _pair(grid, density=0.4, seed=22)
    assert_same_blocks(
        tel.dist_ewise_mult(t1, t2, exclude=exclude,
                            out_capacity=out_capacity),
        jel.dist_ewise_mult(j1, j2, exclude=exclude,
                            out_capacity=out_capacity), exact=True)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("out_capacity", [None, 64])
def test_dist_add(grid, out_capacity):
    j1, t1 = _pair(grid, seed=23)
    j2, t2 = _pair(grid, density=0.1, seed=24)
    got = tel.dist_add(t1, t2, out_capacity=out_capacity)
    want = jel.dist_add(j1, j2, out_capacity=out_capacity)
    assert got.capacity == want.capacity
    assert_same_blocks(got, want, exact=True)


def test_binary_ops_need_aligned_operands():
    _, t1 = _pair((2, 2))
    _, t2 = _pair((2, 2), m=29, n=37)
    with pytest.raises(ValueError):
        tel.dist_add(t1, t2)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dim", ["row", "col"])
def test_dist_dim_apply(grid, dim):
    j, t = _pair(grid)
    x = np.random.default_rng(1).random(45).astype(np.float32) + 0.5
    assert_same_blocks(
        tel.dist_dim_apply(t, torch.from_numpy(x), dim),
        jel.dist_dim_apply(j, jnp.asarray(x), dim), exact=True)
    assert_same_blocks(
        tel.dist_dim_apply(t, torch.from_numpy(x), dim, torch.add),
        jel.dist_dim_apply(j, jnp.asarray(x), dim, jnp.add), exact=True)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_prune_column(grid):
    j, t = _pair(grid, density=0.5)
    th = np.linspace(0.2, 0.8, 40).astype(np.float32)
    assert_same_blocks(
        tel.dist_prune_column(t, torch.from_numpy(th), _below),
        jel.dist_prune_column(j, jnp.asarray(th), _below), exact=True)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dim", ["row", "col"])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus",
                                     "max_first"])
def test_dist_reduce(grid, dim, sr_name):
    j, t = _pair(grid)
    _vec(tel.dist_reduce(t, dim, tsr.get_semiring(sr_name)),
         jel.dist_reduce(j, dim, jsr.get_semiring(sr_name)),
         exact=sr_name != "plus_times")


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_reduce_premap(grid):
    j, t = _pair(grid)
    _vec(tel.dist_reduce(t, "col", premap=lambda v: v * v),
         jel.dist_reduce(j, "col", premap=lambda v: v * v), exact=False)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_nnz_per_col(grid):
    j, t = _pair(grid, density=0.3)
    _vec(tel.dist_nnz_per_col(t), jel.dist_nnz_per_col(j))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_dist_kselect_col_static_k(grid, k):
    """A Python int k is its own candidate cap; thresholds exact, -inf
    where a column holds fewer than k entries."""
    j, t = _pair(grid, 48, 21, density=0.5)
    _vec(tel.dist_kselect_col(t, k), jel.dist_kselect_col(j, k))
    _vec(tel.dist_kselect2_col(t, k), jel.dist_kselect2_col(j, k))
    _vec(tel.dist_kselect_col_checked(t, k),
         jel.dist_kselect_col_checked(j, k))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("k_cap", [2, 4, 9])
def test_dist_kselect_col_per_column_k(grid, k_cap):
    """A per-column k with a candidate cap: every block ships at most
    k_cap candidates a column and k is clipped to k_cap; the full gather
    without a cap; both exact against JAX, and Kselect2 too."""
    j, t = _pair(grid, 48, 21, density=0.6, seed=25)
    kv = np.random.default_rng(k_cap).integers(
        0, 8, col_vec_len(t.gshape, t.grid)).astype(np.int32)
    _vec(tel.dist_kselect_col(t, torch.from_numpy(kv), k_cap=k_cap),
         jel.dist_kselect_col(j, jnp.asarray(kv), k_cap=k_cap))
    _vec(tel.dist_kselect_col(t, torch.from_numpy(kv), full_gather=True),
         jel.dist_kselect_col(j, jnp.asarray(kv), full_gather=True))
    _vec(tel.dist_kselect2_col(t, torch.from_numpy(kv)),
         jel.dist_kselect2_col(j, jnp.asarray(kv)))
    _vec(tel.dist_kselect_col_checked(t, torch.from_numpy(kv)),
         jel.dist_kselect_col_checked(j, jnp.asarray(kv)))


def test_dist_kselect_negative_and_tied_values():
    """Kselect2's bisection on negative values and ties (the 32-bit
    order-preserving image) and Kselect1's ranks agree with JAX's."""
    d = rand_sparse(30, 11, 0.6, seed=26)
    d = np.where(d != 0, np.round((d - 0.5) * 8) / 4 + 0.125, 0).astype(
        np.float32)
    for grid in GRIDS:
        j, t = dist_pair(d, *grid)
        for k in (1, 2, 5):
            _vec(tel.dist_kselect_col(t, k), jel.dist_kselect_col(j, k))
            _vec(tel.dist_kselect2_col(t, k), jel.dist_kselect2_col(j, k))


def test_dist_kselect_col_raises_as_jax():
    """A per-column k without k_cap or full_gather raises ValueError, as
    JAX does."""
    j, t = _pair((2, 2))
    kv = np.full(col_vec_len(t.gshape, t.grid), 2, np.int32)
    with pytest.raises(ValueError, match="k_cap"):
        jel.dist_kselect_col(j, jnp.asarray(kv))
    with pytest.raises(ValueError, match="k_cap"):
        tel.dist_kselect_col(t, torch.from_numpy(kv))


@pytest.mark.parametrize("grid", SQUARE)
@pytest.mark.parametrize("shape", [(37, 29), (30, 30)])
def test_dist_transpose(grid, shape):
    j, t = _pair(grid, *shape)
    got, want = tel.dist_transpose(t), jel.dist_transpose(j)
    assert got.gshape == want.gshape
    assert_same_blocks(got, want, exact=True)
    assert_same_blocks(tel.dist_transpose(got), j, exact=True)


def test_dist_transpose_needs_square_grid():
    j, t = _pair((4, 2))
    with pytest.raises(AssertionError):
        jel.dist_transpose(j)
    with pytest.raises(ValueError, match="square grid"):
        tel.dist_transpose(t)


def test_live_prefix_only():
    """Slots past a block's nnz are never read: garbage there changes
    nothing (the ops read each block's live prefix)."""
    _, t = _pair((2, 2), density=0.3)
    dirty_val = t.val.clone()
    idx = torch.arange(t.capacity)[None, None, :] >= t.nnz[..., None]
    dirty_val[idx] = 7.0
    dirty = type(t)(row=t.row, col=t.col, val=dirty_val, nnz=t.nnz,
                    gshape=t.gshape, grid=t.grid)
    for fn in (lambda m: tel.dist_reduce(m, "col"),
               lambda m: tel.dist_kselect_col(m, 2),
               lambda m: tel.dist_apply(m, _tdouble).val):
        assert torch.equal(fn(dirty), fn(t))
