"""The port's distributed dense matrices and SpMM (``parallel/dense.py``)
vs the JAX package's, on shared numpy inputs, on 1x1, 2x2 and 4x2 grids.

Tolerances: placement, ``dense_add_sparse`` (one add a place) and the
min / max SpMMs exact; the plus-times SpMM and ``dense_reduce`` within
rtol 1e-5 (the sums fold in another order than XLA's).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.parallel import dense as jdense  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.parallel import dense as tdense  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402

GRIDS = [(1, 1), (2, 2), (4, 2)]


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grids(request):
    return jgrid(*request.param), tgrid(*request.param)


def pair(d, jg, tg):
    r, c = np.nonzero(d)
    return (jdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, jg),
            tdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, tg))


def test_dense_put_and_to_host_match_jax(grids):
    jg, tg = grids
    x = np.random.default_rng(0).random((10, 14)).astype(np.float32)
    want = np.asarray(jdense.dense_put(x, jg))
    got = tdense.dense_put(x, tg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdense.dense_to_host(got, (10, 14)), x)
    big = tdense.dense_put(x, tg, gshape=(20, 30))
    np.testing.assert_array_equal(
        big.numpy(), np.asarray(jdense.dense_put(x, jg, gshape=(20, 30))))


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_times"])
@pytest.mark.parametrize("rows", ["padded", "short"])
def test_dist_spmm_matches_jax(grids, name, rows):
    """Y = A ·_sr X on an 18 x 12 matrix; X has the padded column-space
    length, or only the 12 true rows (zero-padded by the call)."""
    jg, tg = grids
    d = rand_sparse(18, 12, 0.4, seed=110)
    j, t = pair(d, jg, tg)
    n_pad = tdist.col_vec_len(d.shape, tg)
    x = np.random.default_rng(1).standard_normal((n_pad, 8)).astype(
        np.float32)
    if rows == "short":
        x = x[:12]
    want = np.asarray(jdense.dist_spmm(j, jnp.asarray(x),
                                       jsr.get_semiring(name)))
    got = tdense.dist_spmm(t, torch.from_numpy(x), tsr.get_semiring(name))
    assert got.shape == want.shape
    if name == "plus_times":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy()[:18], d @ x[:12], rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_dense_add_sparse_matches_jax(grids):
    jg, tg = grids
    d = rand_sparse(12, 13, 0.3, seed=111)
    j, t = pair(d, jg, tg)
    x = np.random.default_rng(2).random(
        tdense.dense_put(d, tg).shape).astype(np.float32)
    want = np.asarray(jdense.dense_add_sparse(jdense.dense_put(x, jg), j))
    got = tdense.dense_add_sparse(torch.from_numpy(x), t)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", ["row", "col"])
def test_dense_reduce_matches_jax(grids, dim):
    jg, tg = grids
    x = np.random.default_rng(3).random((10, 14)).astype(np.float32)
    want = np.asarray(jdense.dense_reduce(jdense.dense_put(x, jg), dim))
    got = tdense.dense_reduce(tdense.dense_put(x, tg), dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dim", ["row", "col"])
def test_dense_to_host_and_reduce_with_grid_unchanged(grids, dim):
    """In one process, passing the grid (the keyword a pod needs) changes
    nothing: the corner and the sums equal the calls without it, bit for
    bit."""
    _jg, tg = grids
    x = np.random.default_rng(4).random((10, 14)).astype(np.float32)
    put = tdense.dense_put(x, tg)
    np.testing.assert_array_equal(
        tdense.dense_to_host(put, (10, 14), grid=tg),
        tdense.dense_to_host(put, (10, 14)))
    np.testing.assert_array_equal(
        tdense.dense_reduce(put, dim, grid=tg).numpy().view(np.uint32),
        tdense.dense_reduce(put, dim).numpy().view(np.uint32))
