"""The port's distributed SpMV family (``parallel/spmv.py``) vs the JAX
package's, on shared numpy inputs.

JAX runs its ``shard_map`` bodies on a virtual CPU mesh of pr*pc devices;
the port runs them as one batched pass over the (pr, pc, cap) block stack
on the CPU.  Grids 1x1, 2x2 and 4x2 (the non-square grid is where a mix-up
of the row-space ``P(('r','c'))`` and column-space ``P(('c','r'))`` layouts
would show).  Tolerances: padded lengths, integer outputs, masks and
min/max folds exact; float sums rtol 1e-5 (they fold in another order).
The sampling estimator's min-propagation chain is held equal (rtol 1e-5)
given the same numpy Exp(1) draws on both sides, since the two packages'
random streams differ; its estimate, from the port's own generator, within
20 % of the true nnz(A B).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.parallel import spmv as jsp  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.parallel import spmv as tsp  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel.dist import DistSpMat  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    assert_same_blocks,
    dist_pair,
    tgrid,
)

GRIDS = [(1, 1), (2, 2), (4, 2)]


def _same(t, j, exact=True):
    jx = np.asarray(j)
    tx = t.cpu().numpy()
    assert tx.shape == jx.shape and tx.dtype == jx.dtype, (tx.shape,
                                                            jx.shape)
    if exact:
        np.testing.assert_array_equal(tx, jx)
    else:
        np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=0)


def _pair(grid, m=37, n=29, seed=3):
    return dist_pair(rand_sparse(m, n, 0.15, seed=seed), *grid)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("sr_name", ["plus_times", "min_second",
                                     "max_second"])
@pytest.mark.parametrize("xlen", [29, 40, 17])
def test_dist_spmv_matches_jax(grid, sr_name, xlen):
    """y = A x over the grid: padded length pr*mb, every slot equal (sums
    rtol 1e-5, min/max exact, the identity on empty rows); x shorter or
    longer than pc*nb is padded or cut as JAX does."""
    j, t = _pair(grid)
    x = np.random.default_rng(xlen).random(xlen).astype(np.float32)
    yj = jsp.dist_spmv(j, jnp.asarray(x), jsr.get_semiring(sr_name))
    yt = tsp.dist_spmv(t, torch.from_numpy(x), tsr.get_semiring(sr_name))
    _same(yt, yj, exact=sr_name != "plus_times")


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_spmv_int_vector_min_second(grid):
    """FastSV's SpMV: an int32 vector through (min, select2nd), empty rows
    holding the int32 maximum."""
    j, t = _pair(grid, 41, 41, seed=4)
    x = np.random.default_rng(1).permutation(41).astype(np.int32)
    _same(tsp.dist_spmv(t, torch.from_numpy(x), tsr.MIN_SECOND),
          jsp.dist_spmv(j, jnp.asarray(x), jsr.MIN_SECOND))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("sr_name", ["max_second", "plus_times"])
@pytest.mark.parametrize("pred", [False, True])
def test_dist_spmsv_masked_matches_jax(grid, transpose, sr_name, pred):
    """Masked SpMSpV both ways (A x: column space in, row space out; A^T x
    the reverse) and with an edge predicate: values and masks equal."""
    j, t = _pair(grid, 37, 37, seed=5)
    rng = np.random.default_rng(7)
    x = (np.arange(40, dtype=np.int32) + 1 if sr_name == "max_second"
         else rng.random(40).astype(np.float32))
    mask = rng.random(40) < 0.3
    sr_j, sr_t = jsr.get_semiring(sr_name), tsr.get_semiring(sr_name)
    ej = (lambda v: v > 0.5) if pred else None
    et = (lambda v: v > 0.5) if pred else None
    yj, mj = jsp.dist_spmsv_masked(j, jnp.asarray(x), jnp.asarray(mask),
                                   sr_j, transpose=transpose, edge_pred=ej)
    yt, mt = tsp.dist_spmsv_masked(t, torch.from_numpy(x),
                                   torch.from_numpy(mask), sr_t,
                                   transpose=transpose, edge_pred=et)
    _same(mt, mj)
    _same(yt, yj, exact=sr_name != "plus_times")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("density", [0.05, 0.3])
def test_dist_bfs_pull_masked_matches_jax(grid, density):
    """The pull step: int32 candidates bi*mb + rr + 1 (the int32 minimum
    where nothing hits) and the hit mask, column-space layout."""
    j, t = _pair(grid, 37, 37, seed=6)
    rng = np.random.default_rng(8)
    front = rng.random(40) < density
    unvisited = rng.random(40) < 0.6
    yj, mj = jsp.dist_bfs_pull_masked(j, jnp.asarray(front),
                                      jnp.asarray(unvisited))
    yt, mt = tsp.dist_bfs_pull_masked(t, torch.from_numpy(front),
                                      torch.from_numpy(unvisited))
    _same(yt, yj)
    _same(mt, mj)


@pytest.mark.parametrize("axis", ["r", "c"])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_second",
                                     "max_second"])
def test_axis_reduce_scatter_hands_out_chunks(axis, sr_name):
    """Block (i, j) keeps chunk i (axis 'r') or j (axis 'c') of the
    reduction over that axis, as ``psum_scatter(tiled=True)`` / the
    min-max fallback do."""
    sr = tsr.get_semiring(sr_name)
    x = torch.arange(4 * 2 * 8, dtype=torch.float32).reshape(4, 2, 8) % 7
    out = tsp._axis_reduce_scatter(x, axis, sr)
    d = 0 if axis == "r" else 1
    red = {"sum": x.sum(d), "min": x.amin(d), "max": x.amax(d)}[sr.add_kind]
    n_ax = x.shape[d]
    assert out.shape == ((4, 2, 2) if axis == "r" else (4, 2, 4))
    for i in range(4):
        for jj in range(2):
            idx = i if axis == "r" else jj
            src = red[jj] if axis == "r" else red[i]
            chunk = 8 // n_ax
            assert torch.equal(out[i, jj], src[idx * chunk:(idx + 1) * chunk])


def _jax_chain(ja, jb, draws):
    """JAX's estimator loop (``est_nnz_spgemm_sampling``) on given draws."""
    acc = None
    for x in draws:
        m = jsp.dist_spmv(jb, jnp.asarray(x), jsr.MIN_SECOND)
        m = jnp.where(jnp.isfinite(m), m, jnp.inf)
        f = jsp.dist_spmv(ja, m, jsr.MIN_SECOND)
        f = jnp.where(jnp.isfinite(f), f, jnp.inf)
        acc = f if acc is None else acc[: f.shape[0]] + f
    acc = acc[: ja.gshape[0]]
    per_row = jnp.where(jnp.isfinite(acc) & (acc > 0),
                        (len(draws) - 1) / acc, 0.0)
    return float(jnp.sum(per_row))


@pytest.mark.parametrize("grid", GRIDS)
def test_sampling_chain_matches_jax(grid):
    """The min-propagation chain through B then A, on the same Exp(1)
    draws: the estimate equal within rtol 1e-5."""
    da = rand_sparse(37, 31, 0.1, seed=9)
    db = rand_sparse(31, 43, 0.1, seed=10)
    ja, ta = dist_pair(da, *grid)
    jb, tb = dist_pair(db, *grid)
    rng = np.random.default_rng(11)
    draws = [rng.exponential(size=43).astype(np.float32) for _ in range(8)]
    want = _jax_chain(ja, jb, draws)
    got = tsp._sampling_estimate(ta, tb,
                                 [torch.from_numpy(x) for x in draws])
    assert got == pytest.approx(want, rel=1e-5)


def test_sampling_estimate_near_true_nnz():
    """The estimate from the port's own generator lies within 20 % of the
    true nnz(A B), and the same seed gives the same estimate."""
    da = rand_sparse(120, 120, 0.04, seed=12)
    _, ta = dist_pair(da, 2, 2)
    true = np.count_nonzero((da != 0).astype(np.float64)
                            @ (da != 0).astype(np.float64))
    est = tsp.est_nnz_spgemm_sampling(
        ta, ta, torch.Generator().manual_seed(0), rounds=32)
    again = tsp.est_nnz_spgemm_sampling(
        ta, ta, torch.Generator().manual_seed(0), rounds=32)
    assert est == again
    assert abs(est - true) <= 0.2 * true, (est, true)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (4, 2), (2, 3)])
@pytest.mark.parametrize("capacity", [None, 500])
def test_from_local_builds_the_host_stacks(grid, capacity):
    """``from_local`` (the live triples of an SpCOO) and
    ``from_coo_arrays`` (host arrays) give the same stacks slot for slot
    (the large graphs of the card run are distributed through
    ``from_local``), and a capacity below a block's count raises."""
    d = rand_sparse(41, 33, 0.2, seed=13)
    a = TCOO.from_dense(d, device="cpu")
    r, c = np.nonzero(d)
    got = DistSpMat.from_local(a, tgrid(*grid), capacity=capacity)
    want = DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, tgrid(*grid),
                                     capacity=capacity)
    assert_same_blocks(got, want, exact=True)
    with pytest.raises(ValueError, match="past the capacity"):
        DistSpMat.from_local(a, tgrid(*grid), capacity=4)
