"""Port ``spmm_pallas`` (``ops/spmm_kernel.py``, K8) vs the JAX Pallas kernel
``combblas_tpu/ops/pallas/spmm_kernel.py:spmm_pallas`` in interpret mode,
on shared numpy inputs.  Sums run in another order: rtol 1e-5."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.gen.rmat import rmat_matrix  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.pallas.spmm_kernel import (  # noqa: E402
    spmm_pallas as spmm_pallas_jax,
)
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.spmm_kernel import spmm_pallas  # noqa: E402


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _case(kind):
    rng = np.random.default_rng(0)
    if kind == "small":
        ad = (rng.random((16, 12)) < 0.4) * rng.random((16, 12))
        return JCOO.from_dense(ad.astype(np.float32))
    if kind == "hub":
        m, n = 300, 257
        ad = (rng.random((m, n)) < 0.05) * rng.random((m, n))
        ad[7] = (rng.random(n) < 0.6) * 1.0   # hub row: many 8-entry groups
        ad[8] = 0                             # empty row
        return JCOO.from_dense(ad.astype(np.float32))
    return rmat_matrix(jax.random.PRNGKey(2), scale=9, edgefactor=8)


@pytest.mark.parametrize("kind", ["small", "hub", "rmat9"])
@pytest.mark.parametrize("d", [8, 128])
def test_spmm_pallas_matches_jax(kind, d):
    ja = _case(kind)
    x = np.random.default_rng(d).random((ja.shape[1], d)).astype(np.float32)
    want = np.asarray(spmm_pallas_jax(ja, jnp.asarray(x), interpret=True))
    before = dict(LAUNCHES)
    got = spmm_pallas(_port(ja), torch.from_numpy(x))
    assert LAUNCHES == before  # CPU tensors never count as kernel launches
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_spmm_pallas_empty_and_dtype():
    ja = JCOO.empty((6, 5))
    x = np.ones((5, 4), np.float32)
    want = np.asarray(spmm_pallas_jax(ja, jnp.asarray(x), interpret=True))
    got = spmm_pallas(_port(ja), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.zeros((6, 4)))
    half = spmm_pallas(_port(_case("small")),
                       torch.ones((12, 3), dtype=torch.float16))
    assert half.dtype == torch.float16


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_spmm_pallas_plain_chunks(chunk, monkeypatch):
    """The plain version folds the entries chunk by chunk; any chunk size
    gives JAX's product, including chunks that split a row."""
    import combblas_tpu_torch.ops.spmm_kernel as sk
    monkeypatch.setattr(sk, "_PLAIN_CHUNK", chunk)
    ja = _case("hub")
    x = np.random.default_rng(3).random((ja.shape[1], 8)).astype(np.float32)
    want = np.asarray(spmm_pallas_jax(ja, jnp.asarray(x), interpret=True))
    got = spmm_pallas(_port(ja), torch.from_numpy(x), plain=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
