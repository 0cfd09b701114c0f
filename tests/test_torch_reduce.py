"""The port's ``ops/reduce.py`` vs the JAX package's on shared numpy
inputs, empty rows and columns included: integer outputs and min/max
exact, sums within rtol 1e-6."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops import reduce as jred  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops import reduce as tred  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _matrix(seed, m=37, n=29, e=150, dtype=np.float32, cap_extra=21):
    """A random (m, n) matrix with empty rows and columns, mixed-sign
    values and pads."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m - 3, e)          # the last 3 rows stay empty
    c = rng.integers(0, n, e)
    c[c == 7] = 8                          # column 7 stays empty
    if np.issubdtype(dtype, np.integer):
        v = rng.integers(-50, 50, e).astype(dtype)
    else:
        v = (rng.random(e) - 0.3).astype(dtype)
    a = JCOO.from_arrays(r, c, v, (m, n), sum_duplicates=True)
    return JCOO.from_arrays(np.asarray(a.row)[:int(a.nnz)],
                            np.asarray(a.col)[:int(a.nnz)],
                            np.asarray(a.val)[:int(a.nnz)], (m, n),
                            capacity=int(a.nnz) + cap_extra)


def _check(got, want, sr_name):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    if sr_name == "plus_times" and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_first"])
@pytest.mark.parametrize("dim", ["row", "col"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("seed", [0, 1])
def test_reduce_dim(sr_name, dim, dtype, seed):
    ja = _matrix(seed, dtype=dtype)
    got = tred.reduce_dim(_port(ja), dim, tsr.get_semiring(sr_name))
    _check(got, jred.reduce_dim(ja, dim, jsr.get_semiring(sr_name)),
           sr_name)


def _jsq(v):
    return v * v


def _tsq(v):
    return v * v


def _jabs(v):
    return jax.numpy.abs(v)


@pytest.mark.parametrize("premap", ["square", "abs"])
@pytest.mark.parametrize("sr_name", ["plus_times", "max_first"])
@pytest.mark.parametrize("dim", ["row", "col"])
def test_reduce_dim_premap(premap, sr_name, dim):
    ja = _matrix(2)
    jf, tf = (_jsq, _tsq) if premap == "square" else (_jabs, torch.abs)
    got = tred.reduce_dim(_port(ja), dim, tsr.get_semiring(sr_name),
                          premap=tf)
    _check(got, jred.reduce_dim(ja, dim, jsr.get_semiring(sr_name),
                                premap=jf), sr_name)


@pytest.mark.parametrize("dim", ["row", "col"])
@pytest.mark.parametrize("seed", [0, 3])
def test_nnz_per(dim, seed):
    ja = _matrix(seed)
    got = tred.nnz_per(_port(ja), dim)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jred.nnz_per(ja, dim)))


def test_reduce_empty_matrix():
    """No live entry: every row and column holds the identity."""
    ja = JCOO.from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.float32), (5, 4))
    for name in ("plus_times", "min_plus", "max_first"):
        got = tred.reduce_dim(_port(ja), "col", tsr.get_semiring(name))
        _check(got, jred.reduce_dim(ja, "col", jsr.get_semiring(name)), name)
