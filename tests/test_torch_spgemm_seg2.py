"""The port's seg2 slice vs the JAX package on the same R-MAT matrices: the
host plan must be identical, and the digest (nnz exact, checksum within
rtol 1e-5) must agree after every slab.  The JAX pipelines differ among
themselves by ~1e-7 relative (docs/DESIGN.md), and the port folds sums in
another order."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.gen.rmat import rmat_matrix  # noqa: E402
from combblas_tpu.ops import spgemm as jsp  # noqa: E402
from combblas_tpu.ops import spgemm_seg as jseg  # noqa: E402
from combblas_tpu.semiring import PLUS_TIMES as J_PT  # noqa: E402
from combblas_tpu_torch.gen.rmat import SSCA_PROBS  # noqa: E402
from combblas_tpu_torch.ops import spgemm as tsp  # noqa: E402
from combblas_tpu_torch.ops import spgemm_seg as tseg  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.semiring import PLUS_TIMES as T_PT  # noqa: E402


def _jax_rmat(scale, seed=42):
    return rmat_matrix(jax.random.PRNGKey(seed), scale=scale, edgefactor=8,
                       probs=SSCA_PROBS)


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


@pytest.mark.parametrize("scale", [8, 9])
@pytest.mark.parametrize("caps", [(1 << 14, 1 << 16, 14), (1 << 28, 1 << 28, 14),
                                  (1 << 13, 1 << 15, 3)])
def test_seg2_plan_identical(scale, caps):
    flops_cap, pad_cap, max_widths = caps
    ja = _jax_rmat(scale)
    ta = _port(ja)
    assert tsp.spgemm_flops(ta, ta) == jsp.spgemm_flops(ja, ja)
    ja2, jcfg = jseg.seg2_plan(ja, ja, flops_cap=flops_cap, pad_cap=pad_cap,
                               max_widths=max_widths)
    ta2, tcfg = tseg.seg2_plan(ta, ta, flops_cap=flops_cap, pad_cap=pad_cap,
                               max_widths=max_widths)
    assert set(tcfg) == set(jcfg)
    np.testing.assert_array_equal(tcfg["bounds"], jcfg["bounds"])
    assert tcfg["bounds"].dtype == jcfg["bounds"].dtype
    assert tcfg["slabs"] == jcfg["slabs"]
    for key in ("stream_cap", "worst_fl", "padded", "flops", "pad_ratio",
                "shapes"):
        assert tcfg[key] == jcfg[key], key
    row, col, val, nnz, shape = ta2.to_numpy()
    assert nnz == int(ja2.nnz) and shape == tuple(ja2.shape)
    np.testing.assert_array_equal(row, np.asarray(ja2.row))
    np.testing.assert_array_equal(col, np.asarray(ja2.col))
    np.testing.assert_array_equal(val, np.asarray(ja2.val))


def test_seg2_digest_matches_jax_every_slab():
    """Scale-8 SSCA ef-8 A² with flops_cap 2^14, pad_cap 2^16: one windowed
    and two flat slabs, JAX kernels in interpret mode."""
    ja = _jax_rmat(8)
    ta = _port(ja)
    kw = dict(flops_cap=1 << 14, pad_cap=1 << 16)
    jprep = jseg.seg2_prepare(ja, ja, **kw)
    tprep = tseg.seg2_prepare(ta, ta, **kw)
    slabs = tprep[1]["slabs"]
    assert [s["flat"] for s in slabs] == [False, True, True]
    assert tprep[4] == jprep[5]  # slab_out_cap
    jstate = jseg.seg_zero_state()
    tstate = tseg.seg_zero_state("cpu")
    for s in range(len(slabs)):
        jstate = jseg.seg2_step(ja, jprep, s, jstate, J_PT, interpret=True)
        tstate = tseg.seg2_step(ta, tprep, s, tstate, T_PT)
        j_nnz = int(jstate[0]) + (int(jstate[1]) << 16)
        assert int(tstate[0]) == j_nnz, s
        np.testing.assert_allclose(float(tstate[1]), float(jstate[2]),
                                   rtol=1e-5)
        assert bool(tstate[2]) == bool(jstate[3]) is False
    # and against an independent dense product
    d = ta.to_dense().double().numpy()
    ref = d @ d
    assert int(tstate[0]) == int((ref != 0).sum())
    np.testing.assert_allclose(float(tstate[1]), ref.sum(), rtol=1e-5)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_second"])
def test_streamed_seg2_matches_dense_reference(sr_name):
    """Whole slice on a skewed matrix against a dense semiring product in
    float64, for one semiring of each add kind."""
    from combblas_tpu_torch import semiring as tsr

    rng = np.random.default_rng(7)
    m = k = n = 120
    ad = np.zeros((m, k), np.float32)
    for i in range(m):
        deg = min(int(rng.pareto(0.7) + 1), k)
        cols = rng.choice(k, size=deg, replace=False)
        ad[i, cols] = rng.random(deg).astype(np.float32) + 0.1
    bd = ((rng.random((k, n)) < 0.2) * (rng.random((k, n)) + 0.5)).astype(
        np.float32)
    sr = tsr.get_semiring(sr_name)
    nnz, cks, trunc = tseg.spgemm_streamed_seg2(
        TCOO.from_dense(ad, device="cpu"),
        TCOO.from_dense(bd, device="cpu"), sr, flops_cap=1 << 12,
        pad_cap=1 << 16, max_widths=3)
    am = ad != 0
    bm = bd != 0
    hit = (am.astype(np.int64) @ bm.astype(np.int64)) > 0
    prod = sr.mul(torch.from_numpy(ad)[:, :, None],
                  torch.from_numpy(bd)[None, :, :]).double().numpy()
    mask = am[:, :, None] & bm[None, :, :]
    if sr.add_kind == "sum":
        ref = np.where(mask, prod, 0.0).sum(1)
    elif sr.add_kind == "min":
        ref = np.where(mask, prod, np.inf).min(1)
    else:
        ref = np.where(mask, prod, -np.inf).max(1)
    assert not trunc
    assert nnz == int(hit.sum())
    np.testing.assert_allclose(cks, ref[hit].sum(), rtol=1e-5)


def test_seg2_truncation_flag():
    """A slab output capacity below the slab's nnz sets ``truncated``."""
    rng = np.random.default_rng(1)
    d = ((rng.random((64, 64)) < 0.3) * rng.random((64, 64))).astype(
        np.float32)
    a = TCOO.from_dense(d, device="cpu")
    full = int(((d @ d) != 0).sum())
    assert full > 2048
    nnz, _cks, trunc = tseg.spgemm_streamed_seg2(a, a, T_PT)
    assert not trunc and nnz == full
    nnz, _cks, trunc = tseg.spgemm_streamed_seg2(a, a, T_PT,
                                                 slab_out_cap=2048)
    # the windowed slab (2 rows) fits; the flat slab saturates at 2048
    assert trunc and 2048 < nnz < full
