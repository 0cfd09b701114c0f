"""The port's ``ops/spvec.py`` (``SpVec``) vs the JAX package's on shared
numpy inputs: every slot exact, pads included."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.ops.spvec import SpVec as JVec  # noqa: E402
from combblas_tpu_torch.ops.spvec import SpVec as TVec  # noqa: E402


def _port(v):
    return TVec(torch.from_numpy(np.array(v.idx)),
                torch.from_numpy(np.array(v.val)),
                torch.tensor(int(v.nnz)), v.length)


def _same(t, j):
    assert t.length == j.length and t.capacity == j.capacity
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))


def _vec(seed, length=50, k=17, dtype=np.float32, capacity=None):
    rng = np.random.default_rng(seed)
    idx = rng.choice(length, k, replace=False)
    if np.issubdtype(dtype, np.integer):
        val = rng.permutation(length)[:k].astype(dtype)
    else:
        val = (rng.random(k) - 0.5).astype(dtype)
    return idx, val, length, capacity


@pytest.mark.parametrize("capacity", [None, 40])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_from_arrays(capacity, dtype):
    idx, val, length, _ = _vec(0, dtype=dtype)
    _same(TVec.from_arrays(idx, val, length, capacity, device="cpu"),
          JVec.from_arrays(idx, val, length, capacity))


@pytest.mark.parametrize("capacity", [None, 64, 5])
def test_from_dense_mask(capacity):
    rng = np.random.default_rng(1)
    val = rng.random(37).astype(np.float32)
    mask = rng.random(37) < 0.4
    _same(TVec.from_dense_mask(torch.from_numpy(val), torch.from_numpy(mask),
                               capacity),
          JVec.from_dense_mask(jnp.asarray(val), jnp.asarray(mask), capacity))


@pytest.mark.parametrize("fill", [0, -1.5])
def test_to_dense_and_mask(fill):
    jv = JVec.from_arrays(*_vec(2)[:3])
    tv = _port(jv)
    np.testing.assert_array_equal(tv.to_dense(fill).numpy(),
                                  np.asarray(jv.to_dense(fill)))
    td, tm = tv.to_dense_mask()
    jd, jm = jv.to_dense_mask()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("capacity", [None, 20])
def test_invert(capacity):
    jv = JVec.from_arrays(*_vec(3, dtype=np.int32)[:3])
    _same(_port(jv).invert(60, capacity), jv.invert(60, capacity))


def test_select_and_select_by_mask():
    jv = JVec.from_arrays(*_vec(4)[:3])
    _same(_port(jv).select(lambda v: v > 0), jv.select(lambda v: v > 0))
    keep = np.random.default_rng(5).random(jv.capacity) < 0.5
    _same(_port(jv).select_by_mask(torch.from_numpy(keep)),
          jv.select_by_mask(jnp.asarray(keep)))


def test_set_minus():
    jv = JVec.from_arrays(*_vec(6)[:3])
    jo = JVec.from_arrays(*_vec(7, k=25)[:3])
    _same(_port(jv).set_minus(_port(jo)), jv.set_minus(jo))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_sort_by_value(dtype):
    jv = JVec.from_arrays(*_vec(8, dtype=dtype)[:3])
    _same(_port(jv).sort_by_value(), jv.sort_by_value())
