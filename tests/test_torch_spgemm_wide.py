"""The port's flat-slab multiply ``spgemm_wide`` vs the JAX package's
``spgemm_pallas_wide`` (interpret mode) on the same numpy inputs.  Rows and
columns of C exact, nnz exact; values exact for min/max and within rtol
1e-6 for sum (the two fold duplicate runs in another order)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.spgemm import (  # noqa: E402
    spgemm_pallas_bounds,
    spgemm_pallas_wide,
    stream_capacity,
)
from combblas_tpu.ops.spgemm import spgemm_flops as j_flops  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops import spgemm as tsp  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _rand(m, k, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((m, k)) < density) * (rng.random((m, k)) + 0.25)
    return d.astype(np.float32)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_second"])
def test_spgemm_wide_matches_jax(sr_name):
    ad = _rand(72, 60, 0.15, 3)
    ad[5] = 0.0  # an empty A row
    bd = _rand(60, 50, 0.2, 4)
    bd[:, 7] = 0.0  # an empty C column
    ja, jb = JCOO.from_dense(ad), JCOO.from_dense(bd)
    chunk_cap, out_cap = spgemm_pallas_bounds(ja, jb)
    scap = stream_capacity(int(j_flops(ja, jb)))
    jc = spgemm_pallas_wide(ja, jb, jsr.get_semiring(sr_name),
                            chunk_cap=chunk_cap, out_capacity=out_cap,
                            stream_cap=scap, interpret=True)
    tc = tsp.spgemm_wide(TCOO.from_dense(ad, device="cpu"),
                         TCOO.from_dense(bd, device="cpu"),
                         tsr.get_semiring(sr_name), out_capacity=out_cap,
                         stream_cap=scap)
    nnz = int(jc.nnz)
    assert int(tc.nnz) == nnz > 0
    assert tc.shape == tuple(jc.shape) and tc.capacity == jc.capacity
    # live entries and the (m, n, 0) pads past nnz
    np.testing.assert_array_equal(tc.row.numpy(), np.asarray(jc.row))
    np.testing.assert_array_equal(tc.col.numpy(), np.asarray(jc.col))
    got, want = tc.val.numpy(), np.asarray(jc.val)
    if sr_name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
