"""The port's 2D SUMMA family (all-gather SUMMA on every route, the auto
dispatcher with its retries, the staged SUMMA) vs the JAX package's, on a
2x2 grid: JAX on four virtual CPU devices, the port's blocks on the CPU.

JAX's kernel routes ("pallas", "wide") run in interpret mode, once per
route; the port's run the kernels' plain versions on CPU tensors.  Rows,
columns, nnz and pads must match exactly; values exactly for min/max folds
and within rtol 1e-5 for sums.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.parallel import memefficient as jme  # noqa: E402
from combblas_tpu.parallel import summa as jsu  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.parallel import memefficient as tme  # noqa: E402
from combblas_tpu_torch.parallel import summa as tsu  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    assert_same_blocks,
    dist_pair,
    tgrid,
)

SEMIRINGS = ["plus_times", "min_plus", "max_times"]


def _operands(seed=60, shape_a=(30, 26), shape_b=(26, 34), density=0.15,
              grid=(2, 2)):
    ja, ta = dist_pair(rand_sparse(*shape_a, density, seed=seed), *grid)
    jb, tb = dist_pair(rand_sparse(*shape_b, density, seed=seed + 1), *grid)
    return ja, jb, ta, tb


def _exact(sr_name):
    return tsr.get_semiring(sr_name).add_kind != "sum"


@pytest.mark.parametrize("seed", [60, 62, 100])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_summa_flops_and_bounds_exact(seed, grid):
    ja, jb, ta, tb = _operands(seed, grid=grid)
    np.testing.assert_array_equal(tsu.summa_flops(ta, tb).numpy(),
                                  np.asarray(jsu.summa_flops(ja, jb)))
    assert tsu.summa_bounds(ta, tb) == jsu.summa_bounds(ja, jb)
    fc = jsu.summa_bounds(ja, jb)[0]
    assert tsu.summa_chunk_bound(ta, tb, fc) == jsu.summa_chunk_bound(
        ja, jb, fc)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_summa_xla_route_matches_jax(sr_name):
    ja, jb, ta, tb = _operands()
    fc, oc = jsu.summa_bounds(ja, jb)
    jc = jsu.summa_spgemm(ja, jb, jsr.get_semiring(sr_name), flops_cap=fc,
                          out_capacity=oc)
    tc = tsu.summa_spgemm(ta, tb, tsr.get_semiring(sr_name), flops_cap=fc,
                          out_capacity=oc)
    assert_same_blocks(tc, jc, exact=_exact(sr_name))


@pytest.mark.parametrize("impl", ["pallas", "wide"])
def test_summa_kernel_routes_match_jax(impl):
    """The panel product on the expansion/compress kernels' route: JAX's
    Pallas kernels interpreted, the port's plain versions; C's blocks have
    max(ceil128(out_capacity), 2048) slots on both."""
    ja, jb, ta, tb = _operands(seed=100, shape_a=(20, 16),
                               shape_b=(16, 18), density=0.3)
    fc, oc = jsu.summa_bounds(ja, jb)
    cc = jsu.summa_chunk_bound(ja, jb, fc)
    jc = jsu.summa_spgemm(ja, jb, flops_cap=fc, out_capacity=oc, impl=impl,
                          chunk_cap=cc, interpret=True)
    tc = tsu.summa_spgemm(ta, tb, flops_cap=fc, out_capacity=oc, impl=impl,
                          chunk_cap=cc)
    assert tc.capacity == max(-(-oc // 128) * 128, 2048)
    assert_same_blocks(tc, jc)


def test_summa_impl_auto():
    """float32 values take the kernel routes on any device (JAX: only on a
    TPU); packed keys while (mb+1)*(nb+1) < 2^31, else wide; float64 takes
    the plain ESC route."""
    _ja, _jb, ta, tb = _operands()
    assert tsu.summa_impl_auto(ta, tb) == "pallas"
    wide = tsu.DistSpMat(ta.row, ta.col, ta.val, ta.nnz, (100_000, 26),
                         ta.grid)
    tall = tsu.DistSpMat(tb.row, tb.col, tb.val, tb.nnz, (26, 100_000),
                         tb.grid)
    assert tsu.summa_impl_auto(wide, tall) == "wide"
    f64 = tsu.DistSpMat(ta.row, ta.col, ta.val.double(), ta.nnz, ta.gshape,
                        ta.grid)
    assert tsu.summa_impl_auto(f64, tb) == "xla"


@pytest.mark.parametrize("side, impl", [(2, "wide"), (4, "pallas")])
def test_summa_impl_auto_at_scale_17(side, impl):
    """The A² of a scale-17 matrix (chip_smoke phase 13): 2x2 blocks have
    mb = nb = 65,536, so (mb+1)*(nb+1) >= 2^31 and keys must be wide; 4x4
    blocks (32,768) fit packed int32 keys."""
    big = tsu.DistSpMat.from_coo_arrays([0, 5], [7, 0], [1.0, 2.0],
                                        (1 << 17, 1 << 17),
                                        tgrid(side, side))
    assert big.block_shape() == ((1 << 17) // side,) * 2
    assert tsu.summa_impl_auto(big, big) == impl


@pytest.fixture
def attempts(monkeypatch):
    """Counts each package's summa_spgemm calls inside summa_spgemm_auto,
    and sets the route each takes (``attempts["impl"][pkg]``; JAX's kernel
    routes would need a TPU)."""
    out = {"jax": 0, "port": 0, "impl": {"jax": "xla", "port": "xla"}}
    for pkg, mod in (("jax", jsu), ("port", tsu)):
        def wrapped(*args, _fn=mod.summa_spgemm, _pkg=pkg, **kw):
            out[_pkg] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, "summa_spgemm", wrapped)
        monkeypatch.setattr(mod, "summa_impl_auto",
                            lambda a, b, _pkg=pkg: out["impl"][_pkg])
    return out


@pytest.mark.parametrize("nnz_estimate", [None, 8, 40])
def test_summa_auto_retries_match_jax(attempts, nnz_estimate):
    ja, jb, ta, tb = _operands(seed=62, shape_a=(24, 24), shape_b=(24, 24),
                               density=0.2)
    jc = jsu.summa_spgemm_auto(ja, jb, nnz_estimate=nnz_estimate)
    tc = tsu.summa_spgemm_auto(ta, tb, nnz_estimate=nnz_estimate)
    assert attempts["port"] == attempts["jax"] >= 1
    if nnz_estimate == 8:
        assert attempts["port"] > 1           # it did retry
    assert_same_blocks(tc, jc)


def test_summa_auto_kernel_route_retries(attempts):
    """The port on its kernel route (plain versions on the CPU) against
    JAX on its plain route: the same attempts, block nnz and product; C's
    capacity is the kernel route's."""
    attempts["impl"]["port"] = "pallas"
    ja, jb, ta, tb = _operands(seed=62, shape_a=(24, 24), shape_b=(24, 24),
                               density=0.2)
    jc = jsu.summa_spgemm_auto(ja, jb, nnz_estimate=8)
    tc = tsu.summa_spgemm_auto(ta, tb, nnz_estimate=8)
    assert attempts["port"] == attempts["jax"] > 1
    np.testing.assert_array_equal(tc.nnz.numpy(), np.asarray(jc.nnz))
    np.testing.assert_allclose(tc.to_dense(), jc.to_dense(), rtol=1e-5)
    assert tc.capacity == max(-(-jc.capacity // 128) * 128, 2048)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_staged_matches_jax(sr_name):
    ja, jb, ta, tb = _operands(seed=100, shape_a=(20, 16), shape_b=(16, 18),
                               density=0.3)
    fc, oc = jsu.summa_bounds(ja, jb)
    jc = jme.summa_spgemm_staged(ja, jb, jsr.get_semiring(sr_name),
                                 stage_flops_cap=fc, out_capacity=oc)
    tc = tme.summa_spgemm_staged(ta, tb, tsr.get_semiring(sr_name),
                                 stage_flops_cap=fc, out_capacity=oc)
    assert_same_blocks(tc, jc, exact=_exact(sr_name))


def test_staged_kernel_route_matches_jax():
    """The staged SUMMA on the port's kernel route (plain versions here)
    equals JAX's staged SUMMA on its plain route, block for block."""
    ja, jb, ta, tb = _operands(seed=100, shape_a=(20, 16), shape_b=(16, 18),
                               density=0.3)
    fc, oc = jsu.summa_bounds(ja, jb)
    jc = jme.summa_spgemm_staged(ja, jb, stage_flops_cap=fc, out_capacity=oc)
    tc = tme.summa_spgemm_staged(ta, tb, stage_flops_cap=fc, out_capacity=oc,
                                 impl="pallas",
                                 chunk_cap=tsu.summa_chunk_bound(ta, tb, fc))
    assert_same_blocks(tc, jc)


@pytest.mark.parametrize("budget", [1e3, 1e5, 1e12])
@pytest.mark.parametrize("est_c_nnz", [None, 50.0, 1e6])
def test_calculate_phases_matches_jax(budget, est_c_nnz):
    ja, _jb, ta, _tb = _operands(seed=104, shape_a=(16, 16), density=0.4)
    assert tme.calculate_phases(ta, ta, budget, est_c_nnz=est_c_nnz) == \
        jme.calculate_phases(ja, ja, budget, est_c_nnz=est_c_nnz)


def test_grids_must_match_and_be_square():
    _ja, _jb, ta, tb = _operands()
    _ja2, _jb2, ta42, _tb42 = _operands(grid=(4, 2))
    _ja3, _jb3, sq42, _tb3 = _operands(shape_a=(24, 24), grid=(4, 2))
    fc, oc = tsu.summa_bounds(ta, tb)
    with pytest.raises(ValueError, match="GRIDMISMATCH"):
        tsu.summa_spgemm(ta, ta42, flops_cap=fc, out_capacity=oc)
    with pytest.raises(ValueError, match="DIMMISMATCH"):
        tsu.summa_spgemm(ta, ta, flops_cap=fc, out_capacity=oc)
    with pytest.raises(ValueError, match="square grid"):
        tsu.summa_flops(sq42, sq42)
