"""Port SpMV / SpMSpV / SpMM (``ops/spmv.py``) vs ``combblas_tpu/ops/spmv.py``
on shared numpy inputs, for PLUS_TIMES, MIN_PLUS and MAX_SECOND.  Integer
outputs and masks are exact; float values agree within rtol 1e-5 (sums in
another order)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops import spmv as jspmv  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.pallas.spmm_ell import (  # noqa: E402
    spmm_ell as spmm_ell_jax,
)
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops import spmv as tspmv  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.spmm_ell import spmm_ell_prepare  # noqa: E402

SEMIRINGS = ["plus_times", "min_plus", "max_second"]


def _matrix(seed, m=60, n=45):
    """(m, n) with empty rows and columns, a hub row, mixed-sign values."""
    rng = np.random.default_rng(seed)
    ad = (rng.random((m, n)) < 0.1) * rng.standard_normal((m, n))
    ad[3] = (rng.random(n) < 0.7) * (rng.random(n) + 0.5)
    ad[10:14] = 0.0
    ad[:, 5] = 0.0
    ja = JCOO.from_dense(ad.astype(np.float32))
    ta = TCOO.from_numpy(np.asarray(ja.row), np.asarray(ja.col),
                         np.asarray(ja.val), int(ja.nnz), ja.shape,
                         device="cpu")
    return ja, ta


def _check(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _x(rng, length, sr_name, d=None):
    shape = (length,) if d is None else (length, d)
    if sr_name == "max_second":
        return rng.integers(1, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("transpose", [False, True])
def test_spmv_matches_jax(sr_name, transpose):
    ja, ta = _matrix(1)
    rng = np.random.default_rng(2)
    x = _x(rng, ja.shape[0] if transpose else ja.shape[1], sr_name)
    jf = jspmv.spmv_transpose if transpose else jspmv.spmv
    tf = tspmv.spmv_transpose if transpose else tspmv.spmv
    want = jf(ja, jnp.asarray(x), jsr.get_semiring(sr_name))
    got = tf(ta, torch.from_numpy(x), tsr.get_semiring(sr_name))
    _check(got, want)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("transpose", [False, True])
def test_spmsv_masked_matches_jax(sr_name, transpose):
    ja, ta = _matrix(3)
    rng = np.random.default_rng(4)
    length = ja.shape[0] if transpose else ja.shape[1]
    x = _x(rng, length, sr_name)
    mask = rng.random(length) < 0.3
    jy, jm = jspmv.spmsv_masked(ja, jnp.asarray(x), jnp.asarray(mask),
                                jsr.get_semiring(sr_name),
                                transpose=transpose)
    ty, tm = tspmv.spmsv_masked(ta, torch.from_numpy(x),
                                torch.from_numpy(mask),
                                tsr.get_semiring(sr_name),
                                transpose=transpose)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tm.any()) and not bool(tm.all())
    _check(ty, jy)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("d", [8, 128])
def test_spmm_matches_jax(sr_name, use_kernel, d):
    """Both routes: use_kernel=True takes the ELL-8 kernel (its plain
    version on the CPU) for PLUS_TIMES float32 only, as JAX's use_pallas
    does; the other semirings take the gather route either way."""
    ja, ta = _matrix(5)
    rng = np.random.default_rng(6)
    x = _x(rng, ja.shape[1], sr_name, d)
    if use_kernel and sr_name == "plus_times":
        # JAX's use_pallas route is spmm_ell, which runs on the CPU only
        # in interpret mode
        want = spmm_ell_jax(ja, jnp.asarray(x), interpret=True)
    else:
        want = jspmv.spmm(ja, jnp.asarray(x), jsr.get_semiring(sr_name),
                          use_pallas=use_kernel)
    got = tspmv.spmm(ta, torch.from_numpy(x), tsr.get_semiring(sr_name),
                     use_kernel=use_kernel)
    _check(got, want)


def test_spmm_kernel_route_takes_prep():
    """The kernel route takes a plan and keeps X's dtype."""
    ja, ta = _matrix(7)
    x = np.random.default_rng(8).random((ja.shape[1], 16)).astype(
        np.float32)
    prep = spmm_ell_prepare(ta)
    before = dict(LAUNCHES)
    got = tspmv.spmm(ta, torch.from_numpy(x), use_kernel=True, prep=prep)
    assert LAUNCHES == before
    dense = np.asarray(ja.to_dense())
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=1e-5, atol=1e-5)
    half = tspmv.spmm(ta, torch.from_numpy(x).half(), use_kernel=True,
                      prep=prep)
    assert half.dtype == torch.float16
