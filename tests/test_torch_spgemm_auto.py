"""The port's ``spgemm_auto`` vs the JAX package's: the same plan dicts,
retries and results.

JAX takes its kernel routes only on a TPU backend, so for float32 operands
the test sets JAX's ``_pallas_backend_ok`` to true and runs its kernels in
interpret mode; the port's routes ask only that both value types be float32.
Non-float32 values take the plain ESC routes in both (JAX in 64-bit mode).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops import spgemm as jsp  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops import spgemm as tsp  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402

ROUTES = ("spgemm_pallas", "spgemm_pallas_rowchunked", "spgemm",
          "spgemm_rowchunked")


@pytest.fixture
def calls(monkeypatch):
    """Counts each package's top-level route calls; JAX's kernel routes
    run interpreted, as on a TPU backend."""
    monkeypatch.setattr(jsp, "_pallas_backend_ok", lambda a, b: True)
    counts = {pkg: dict.fromkeys(ROUTES, 0) for pkg in ("jax", "port")}
    for pkg, mod in (("jax", jsp), ("port", tsp)):
        for name in ROUTES:
            def wrapped(*args, _fn=getattr(mod, name), _pkg=pkg, _name=name,
                        **kw):
                counts[_pkg][_name] += 1
                if _pkg == "jax" and _name.startswith("spgemm_pallas"):
                    kw["interpret"] = True
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, wrapped)
    return counts


def _dense_operands(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    ad = (rng.random((60, 50)) < 0.12) * (rng.random((60, 50)) + 0.5)
    bd = (rng.random((50, 70)) < 0.12) * (rng.random((50, 70)) + 0.5)
    out = []
    for d in (ad, bd):
        r, c = np.nonzero(d)
        out.append((r, c, d[r, c].astype(dtype), d.shape))
    return out


def _pair(seed, dtype=np.float32):
    (ar, ac, av, ash), (br, bc, bv, bsh) = _dense_operands(seed, dtype)
    ja = JCOO.from_arrays(ar, ac, av, ash, dtype=dtype)
    jb = JCOO.from_arrays(br, bc, bv, bsh, dtype=dtype)
    return ja, jb, _port(ja), _port(jb)


def _tall_pair():
    """A (5000 x 64) times B (64 x 2^20): packed keys overflow int32, so the
    plan takes slabs, and wide ones (the span limit needs 3 slabs, memory
    only 1)."""
    rng = np.random.default_rng(1)
    m, k, n = 5000, 64, 1 << 20
    ja = JCOO.from_arrays(rng.integers(0, m, 900), rng.integers(0, k, 900),
                          rng.random(900) + 0.5, (m, k))
    jb = JCOO.from_arrays(rng.integers(0, k, 500), rng.integers(0, n, 500),
                          rng.random(500) + 0.5, (k, n))
    return ja, jb, _port(ja), _port(jb)


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _same(t, j):
    assert t.shape == tuple(j.shape)
    assert t.capacity == j.capacity
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val), rtol=1e-5)


def _same_plan(tplan, jplan):
    """Equal dicts; the key's last item is the semiring's id, which
    differs between the packages' semiring objects."""
    assert tplan.keys() == jplan.keys()
    assert tplan["key"][:-1] == jplan["key"][:-1]
    for k in jplan:
        if k != "key":
            assert tplan[k] == jplan[k], (k, tplan[k], jplan[k])


@pytest.mark.parametrize("case", ["pallas", "narrow_slabs", "wide_slabs"])
def test_auto_plan_and_result_match_jax(calls, case):
    if case == "wide_slabs":
        ja, jb, ta, tb = _tall_pair()
        kw = {}
    else:
        ja, jb, ta, tb = _pair(2)
        # a cap below the products forces narrow slabs (the key range
        # needs one)
        flops = int(jsp.spgemm_flops(ja, jb))
        kw = ({} if case == "pallas"
              else {"max_flops_cap": flops // 3})
    jplan, tplan = {}, {}
    jc = jsp.spgemm_auto(ja, jb, jsr.PLUS_TIMES, plan=jplan, **kw)
    tc = tsp.spgemm_auto(ta, tb, tsr.PLUS_TIMES, plan=tplan, **kw)
    _same_plan(tplan, jplan)
    kind = "pallas" if case == "pallas" else "pallas_slabs"
    assert tplan["kind"] == kind
    if kind == "pallas_slabs":
        assert tplan["wide"] == (case == "wide_slabs")
    _same(tc, jc)
    # slab steps call spgemm_pallas themselves: count the route's own calls
    # (a retry makes two)
    route = "spgemm_pallas" if kind == "pallas" else "spgemm_pallas_rowchunked"
    assert calls["port"][route] == calls["jax"][route] >= 1


def test_auto_retries_like_jax(calls):
    """An nnz_estimate far below nnz: both double out_cap the same number
    of times and end on the same buffer."""
    ja, jb, ta, tb = _pair(3)
    jplan, tplan = {}, {}
    jc = jsp.spgemm_auto(ja, jb, plan=jplan, nnz_estimate=100)
    tc = tsp.spgemm_auto(ta, tb, plan=tplan, nnz_estimate=100)
    assert calls["jax"]["spgemm_pallas"] >= 3
    assert calls["port"] == calls["jax"]
    _same_plan(tplan, jplan)
    assert tplan["out_cap"] > 100
    _same(tc, jc)


def test_auto_reuses_a_held_plan(calls):
    """A second call with the same dict, on operands of the same
    capacities and shapes whose products stay within [flops_ok/64,
    flops_ok], keeps the plan; a product 64x smaller replans."""
    ja, jb, ta, tb = _pair(4)
    jplan, tplan = {}, {}
    jsp.spgemm_auto(ja, jb, plan=jplan)
    tsp.spgemm_auto(ta, tb, plan=tplan)
    frozen = dict(tplan)
    # the same capacities, a third of A's entries
    keep = np.arange(ja.capacity) < int(ja.nnz) // 3
    row = np.where(keep, np.asarray(ja.row), ja.shape[0])
    col = np.where(keep, np.asarray(ja.col), ja.shape[1])
    val = np.where(keep, np.asarray(ja.val), 0).astype(np.float32)
    ja2 = JCOO.from_arrays(row[keep], col[keep], val[keep], ja.shape,
                           capacity=ja.capacity)
    ta2 = _port(ja2)
    assert int(tsp.spgemm_flops(ta2, tb)) * 64 >= frozen["flops_ok"]
    jc = jsp.spgemm_auto(ja2, jb, plan=jplan)
    tc = tsp.spgemm_auto(ta2, tb, plan=tplan)
    assert tplan == frozen
    _same_plan(tplan, jplan)
    _same(tc, jc)
    tiny = JCOO.from_arrays([0], [0], [1.0], ja.shape, capacity=ja.capacity)
    jsp.spgemm_auto(tiny, jb, plan=jplan)
    tsp.spgemm_auto(_port(tiny), tb, plan=tplan)
    assert tplan["flops_ok"] < frozen["flops_ok"]
    _same_plan(tplan, jplan)


@pytest.mark.parametrize("kind", ["sort", "rowchunked"])
def test_auto_non_f32_takes_the_esc_routes(kind):
    """float64 values: ``sort`` with room, ``rowchunked`` under a small
    max_flops_cap; no kernel route in either package."""
    with jax.enable_x64(True):
        ja, jb, ta, tb = _pair(5, np.float64)
        assert ta.val.dtype == torch.float64
        flops = int(tsp.spgemm_flops(ta, tb))
        kw = {} if kind == "sort" else {"max_flops_cap": flops // 4}
        jplan, tplan = {}, {}
        jc = jsp.spgemm_auto(ja, jb, jsr.PLUS_TIMES, plan=jplan, **kw)
        tc = tsp.spgemm_auto(ta, tb, tsr.PLUS_TIMES, plan=tplan, **kw)
        assert tplan["kind"] == kind
        _same_plan(tplan, jplan)
        assert tc.val.dtype == torch.float64
        _same(tc, jc)
