"""The port's ``ops/kselect.py`` vs the JAX package's on shared numpy
inputs, tie-heavy values included: ranks, k-th values and selections
exact.  JAX's CPU sort leaves equal (column, value) pairs in input order;
the port breaks ties by entry id, so the two agree exactly."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.ops import kselect as jks  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch.ops import kselect as tks  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _matrix(seed, values, m=60, n=25, e=500, dtype=np.float32):
    """Random (m, n) matrix; ``values``: 'ties' draws from {1, 2, 3},
    'signed' mixed-sign reals with some -0.0 and 0.0, 'int' int32."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, e)
    c = rng.integers(0, n, e)
    c[c == 3] = 4                               # an empty column
    if values == "ties":
        v = rng.integers(1, 4, e).astype(dtype)
    elif values == "int":
        v = rng.integers(-5, 5, e).astype(np.int32)
    else:
        v = (rng.random(e) - 0.5).astype(dtype)
        v[::17] = 0.0
        v[5::23] = -0.0
    a = JCOO.from_arrays(r, c, v, (m, n), sum_duplicates=False)
    # keep the first entry of each duplicate key, so ties stay ties
    row, col = np.asarray(a.row), np.asarray(a.col)
    nnz = int(a.nnz)
    first = np.ones(nnz, bool)
    first[1:] = (row[1:nnz] != row[:nnz - 1]) | (col[1:nnz] != col[:nnz - 1])
    return JCOO.from_arrays(row[:nnz][first], col[:nnz][first],
                            np.asarray(a.val)[:nnz][first], (m, n),
                            capacity=int(first.sum()) + 9,
                            dtype=v.dtype)


VALUES = ["ties", "signed", "int"]


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_col_rank(values, seed):
    ja = _matrix(seed, values)
    got = tks.col_rank(_port(ja))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jks.col_rank(ja)))


@pytest.mark.parametrize("values", ["ties", "signed"])
@pytest.mark.parametrize("k", [1, 3, 40, "vector"])
def test_kselect_col(values, k):
    ja = _matrix(4, values)
    if k == "vector":   # 0 and past every column's count included
        k = np.random.default_rng(5).integers(0, 45, ja.shape[1]).astype(
            np.int32)
        tk, jk = torch.from_numpy(k), jnp.asarray(k)
    else:
        tk = jk = k
    np.testing.assert_array_equal(tks.kselect_col(_port(ja), tk).numpy(),
                                  np.asarray(jks.kselect_col(ja, jk)))


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("k", [1, 2, 5, "vector"])
@pytest.mark.parametrize("out_cap", [None, 30])
def test_select_top_k_per_col(values, k, out_cap):
    ja = _matrix(6, values)
    if k == "vector":
        k = np.random.default_rng(7).integers(0, 8, ja.shape[1]).astype(
            np.int32)
        tk, jk = torch.from_numpy(k), jnp.asarray(k)
    else:
        tk = jk = k
    t = tks.select_top_k_per_col(_port(ja), tk, out_capacity=out_cap)
    j = jks.select_top_k_per_col(ja, jk, out_capacity=out_cap)
    assert t.capacity == j.capacity and int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))


def test_desc_order_is_total_and_stable():
    """The packed float32 key orders by (col asc, value desc), ties by
    entry id, across signs, zeros and infinities."""
    v = torch.tensor([1.0, -0.0, 0.0, -2.5, float("inf"), -float("inf"),
                      3.0, 1.0, -1e-30, 1e-30, 0.0, 1.0],
                     dtype=torch.float32)
    col = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 2, 2],
                       dtype=torch.int32)
    got = tks.col_desc_order(col, v).numpy()
    want = np.lexsort((np.arange(12), -(v.numpy() + 0.0), col.numpy()))
    np.testing.assert_array_equal(got, want)
