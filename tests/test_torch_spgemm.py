"""The port's materialized SpGEMM family (``ops/spgemm.py``) and its K5
expansion vs the JAX package on shared numpy inputs, JAX kernels in
interpret mode.  Whole arrays are compared, pads included: keys, rows,
columns and nnz exact; K5's values bit for bit (one f32 multiply each); C's
values within rtol 1e-5 (runs of sums fold in other orders)."""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_kernel_cases as cases  # noqa: E402
from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops import spgemm as jsp  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.pallas.expand_kernel import (  # noqa: E402
    build_chunk_meta,
    expand_chunks,
)
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops import spgemm as tsp  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.kernels import expand as texp  # noqa: E402

#: B's rows with 1, 127, 128, 129 and 300 entries (ragged chunks) and one
#: empty row that A entries hit.
B_ROWS = [1, 127, 128, 129, 300, 0]


def _operands(seed=0):
    """A (40 x 30) and B (30 x 400) built dense; A's buffer ends in an
    empty tail (power-of-two capacity)."""
    rng = np.random.default_rng(seed)
    m, k, n = 40, 30, 400
    ad = (rng.random((m, k)) < 0.1) * (rng.random((m, k)) + 0.5)
    ad[:, :len(B_ROWS)] += rng.random((m, len(B_ROWS))) < 0.3
    ad[7] = 0.0                                        # an empty A row
    bd = np.zeros((k, n))
    for r, length in enumerate(B_ROWS):
        bd[r, rng.choice(n, length, replace=False)] = rng.random(length) + .5
    rest = slice(len(B_ROWS), k)
    bd[rest] = (rng.random((k - len(B_ROWS), n)) < 0.03) * (
        rng.random((k - len(B_ROWS), n)) + 0.5)
    ja = JCOO.from_dense(ad.astype(np.float32))
    jb = JCOO.from_dense(bd.astype(np.float32))
    assert int(ja.nnz) < ja.capacity
    return ja, jb


def _tall_operands(seed=1):
    """A (5000 x 64) times B (64 x 2^20): a packed-key row span of at most
    2046 rows, so narrow slab plans split spans and spgemm_auto picks wide
    slabs.  Few entries, so the interpreted kernels stay cheap."""
    rng = np.random.default_rng(seed)
    m, k, n = 5000, 64, 1 << 20
    ar = rng.integers(0, m, 900)
    ac = rng.integers(0, k, 900)
    br = rng.integers(0, k, 500)
    bc = rng.integers(0, n, 500)
    ja = JCOO.from_arrays(ar, ac, rng.random(900) + 0.5, (m, k))
    jb = JCOO.from_arrays(br, bc, rng.random(500) + 0.5, (k, n))
    return ja, jb


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _same(t, j):
    """Port SpCOO ``t`` equals JAX SpCOO ``j`` slot for slot."""
    assert t.shape == tuple(j.shape)
    assert t.capacity == j.capacity
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val), rtol=1e-5)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
@pytest.mark.parametrize("chunks", ["padded", "truncated"])
def test_expand_chunks_matches_k5(sr_name, chunks):
    """K5's chunk-padded stream: ragged chunks of B rows of 1-300 entries,
    A entries on an empty B row, A's empty tail, and dummy chunks up to
    chunk_cap (or chunks past a too-small chunk_cap dropped)."""
    ja, jb = _operands()
    n = jb.shape[1]
    chunk_cap, _ = jsp.spgemm_pallas_bounds(ja, jb)
    if chunks == "truncated":
        chunk_cap = 32
    b_rp = jb.row_ptr()
    meta, metaf, total_ch, _fl = build_chunk_meta(
        ja.row, ja.col, ja.val, ja.mask(), b_rp[:-1], b_rp[1:], n + 1,
        chunk_cap)
    assert (int(total_ch) < chunk_cap) == (chunks == "padded")
    bc2, bv2 = jsp._tables_2d(jb)
    jk, jv = expand_chunks(meta, metaf, bc2, bv2, jsr.get_semiring(sr_name),
                           interpret=True)
    ta, tb = _port(ja), _port(jb)
    before = dict(LAUNCHES)
    tk, tv = texp.expand_chunks(ta.row, ta.col, ta.val, ta.mask(),
                                tb.row_ptr(), tb.col, tb.val,
                                tsr.get_semiring(sr_name), stride=n + 1,
                                chunk_cap=chunk_cap)
    assert LAUNCHES == before  # CPU tensors never count as kernel launches
    assert tk.shape == (chunk_cap * 128,) and tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("name", cases.EXPAND_CASES)
def test_expand_chunks_edge_cases_match_jax(name):
    """K5 on the tiled kernels' edge cases cut at one chunk (a hub B row of
    5 chunks and 37 products taken by several A entries, 10^4 dead entries
    and 3000 on empty B rows, no products at all), at a chunk capacity past
    the last live chunk, the smallest JAX takes, and one that cuts inside a
    hub entry: the port's stream against JAX's, keys exact, values bit for
    bit, pads and dummy chunks included."""
    case = cases.expand_case(name, texp.CH)
    n = case["n"]
    rp = jnp.asarray(case["b_rp"].astype(np.int32))
    bc2, bv2 = jsp._tables_2d(types.SimpleNamespace(
        shape=(rp.shape[0] - 1, n), col=jnp.asarray(case["b_col"]),
        val=jnp.asarray(case["b_val"])))
    t = {k: torch.from_numpy(case[k]) for k in (
        "a_row", "a_col", "a_val", "a_valid", "b_rp", "b_col", "b_val")}
    for chunk_cap in cases.expand_chunk_caps(case):
        meta, metaf, _, _ = build_chunk_meta(
            jnp.asarray(case["a_row"]), jnp.asarray(case["a_col"]),
            jnp.asarray(case["a_val"]), jnp.asarray(case["a_valid"]),
            rp[:-1], rp[1:], n + 1, chunk_cap)
        jk, jv = expand_chunks(meta, metaf, bc2, bv2, jsr.PLUS_TIMES,
                               interpret=True)
        tk, tv = texp.expand_chunks(t["a_row"], t["a_col"], t["a_val"],
                                    t["a_valid"], t["b_rp"], t["b_col"],
                                    t["b_val"], tsr.PLUS_TIMES, stride=n + 1,
                                    chunk_cap=chunk_cap)
        assert tk.shape == (chunk_cap * 128,)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(jv).view(np.int32))


def test_expand_chunks_wrapper_rejects_bad_inputs():
    ja, jb = _operands()
    ta, tb = _port(ja), _port(jb)
    args = [ta.row, ta.col, ta.val, ta.mask(), tb.row_ptr(), tb.col, tb.val,
            tsr.PLUS_TIMES]
    with pytest.raises(ValueError):
        texp.expand_chunks(*args, stride=401, chunk_cap=0)
    bad = list(args)
    bad[6] = tb.val.double()
    with pytest.raises(TypeError):
        texp.expand_chunks(*bad, stride=401, chunk_cap=256)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
@pytest.mark.parametrize("route", ["k5", "k1"])
def test_spgemm_pallas_matches_jax(sr_name, route):
    """Both narrow routes: without stream_cap (K5) and with it (K1)."""
    ja, jb = _operands()
    ta, tb = _port(ja), _port(jb)
    chunk_cap, out_cap = jsp.spgemm_pallas_bounds(ja, jb)
    assert tsp.spgemm_pallas_bounds(ta, tb) == (chunk_cap, out_cap)
    scap = None
    if route == "k1":
        scap = jsp.stream_capacity(int(jsp.spgemm_flops(ja, jb)))
    jc = jsp.spgemm_pallas(ja, jb, jsr.get_semiring(sr_name),
                           chunk_cap=chunk_cap, out_capacity=out_cap,
                           stream_cap=scap, interpret=True)
    tc = tsp.spgemm_pallas(ta, tb, tsr.get_semiring(sr_name),
                           chunk_cap=chunk_cap, out_capacity=out_cap,
                           stream_cap=scap)
    assert 0 < int(jc.nnz) < jc.capacity
    _same(tc, jc)


def test_spgemm_pallas_rejects_overflowing_keys():
    ja, jb = _tall_operands()
    with pytest.raises(ValueError, match="overflow"):
        tsp.spgemm_pallas(_port(ja), _port(jb), chunk_cap=256,
                          out_capacity=2048)
    with pytest.raises(tsp.SpGEMMSortLimitError):
        tsp.spgemm_pallas(_port(ja), _port(jb), chunk_cap=1 << 24,
                          out_capacity=2048)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
def test_esc_routes_match_jax(sr_name):
    """spgemm, spgemm_rowchunked (3 uniform slabs) and spgemm_dense."""
    ja, jb = _operands()
    ta, tb = _port(ja), _port(jb)
    jsr_, tsr_ = jsr.get_semiring(sr_name), tsr.get_semiring(sr_name)
    flops_cap, out_cap = jsp.spgemm_bounds(ja, jb)
    assert tsp.spgemm_bounds(ta, tb) == (flops_cap, out_cap)
    _same(tsp.spgemm(ta, tb, tsr_, flops_cap=flops_cap,
                     out_capacity=out_cap),
          jsp.spgemm(ja, jb, jsr_, flops_cap=flops_cap, out_capacity=out_cap))
    slab_cap, slab_rows = jsp._slab_bounds_host(ja, jb, 3)
    assert tsp._slab_bounds_host(ta, tb, 3) == (slab_cap, slab_rows)
    for cap in (out_cap, 1024):          # 1024 saturates: nnz stops there
        _same(tsp.spgemm_rowchunked(ta, tb, tsr_, num_slabs=3,
                                    slab_rows=slab_rows, flops_cap=slab_cap,
                                    out_capacity=cap),
              jsp.spgemm_rowchunked(ja, jb, jsr_, num_slabs=3,
                                    slab_rows=slab_rows, flops_cap=slab_cap,
                                    out_capacity=cap))
    _same(tsp.spgemm_dense(ta, tb, tsr_, out_capacity=out_cap),
          jsp.spgemm_dense(ja, jb, jsr_, out_capacity=out_cap))


def test_expand_products_truncates_at_flops_cap():
    """Products past flops_cap are dropped; total stays the true count."""
    ja, jb = _operands()
    ta, tb = _port(ja), _port(jb)
    ji, jj, jv, jt = jsp._expand(ja, jb, jb.row_ptr(), jsr.PLUS_TIMES, 500)
    ti, tj, tv, tt = tsp._expand(ta, tb, tb.row_ptr(), tsr.PLUS_TIMES, 500)
    assert int(tt) == int(jt) > 500
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("which", ["square", "tall"])
@pytest.mark.parametrize("num_slabs", [1, 3, 5])
@pytest.mark.parametrize("wide", [False, True])
def test_slab_plan_matches_jax(which, num_slabs, wide):
    """Equal-flops boundaries, span splitting (tall: at most 2046 rows a
    narrow slab) and the capacities: the same tuple as JAX's."""
    ja, jb = _operands() if which == "square" else _tall_operands()
    jp = jsp._pallas_slab_plan(ja, jb, num_slabs, wide=wide)
    tp = tsp._pallas_slab_plan(_port(ja), _port(jb), num_slabs, wide=wide)
    assert tp[0].dtype == np.int32
    np.testing.assert_array_equal(tp[0], np.asarray(jp[0]))
    assert tp[1:] == tuple(jp[1:])
    if which == "tall" and not wide:
        assert len(tp[0]) - 1 >= 3     # spans were split


@pytest.mark.parametrize("case", ["narrow", "wide", "narrow_truncated",
                                  "tall_narrow"])
def test_spgemm_pallas_rowchunked_matches_jax(case):
    """Assembled slab output, all out_capacity + slab_out_cap slots; the
    truncated case overflows out_capacity, so nnz == out_capacity."""
    ja, jb = _tall_operands() if case == "tall_narrow" else _operands()
    wide = case == "wide"
    _, out_cap = jsp.spgemm_pallas_bounds(ja, jb)
    if case == "narrow_truncated":
        out_cap = 3000
    jc = jsp.spgemm_pallas_rowchunked(ja, jb, jsr.PLUS_TIMES, num_slabs=3,
                                      out_capacity=out_cap, wide=wide,
                                      interpret=True)
    tc = tsp.spgemm_pallas_rowchunked(_port(ja), _port(jb), tsr.PLUS_TIMES,
                                      num_slabs=3, out_capacity=out_cap,
                                      wide=wide)
    assert tc.capacity > out_cap
    if case == "narrow_truncated":
        assert int(jc.nnz) == out_cap
    _same(tc, jc)


@pytest.mark.parametrize("wide", [False, True])
def test_spgemm_pallas_streamed_matches_jax(wide):
    ja, jb = _operands()
    jn, jcs, jtr = jsp.spgemm_pallas_streamed(ja, jb, jsr.PLUS_TIMES,
                                              num_slabs=3, wide=wide,
                                              interpret=True)
    tn, tcs, ttr = tsp.spgemm_pallas_streamed(_port(ja), _port(jb),
                                              tsr.PLUS_TIMES, num_slabs=3,
                                              wide=wide)
    assert tn == int(jn) > 0
    assert ttr is bool(jtr) is False
    np.testing.assert_allclose(tcs, float(jcs), rtol=1e-5)
    # a slab_out_cap below a slab's nnz flags truncation in both
    jn, _, jtr = jsp.spgemm_pallas_streamed(ja, jb, num_slabs=3, wide=wide,
                                            slab_out_cap=2048,
                                            interpret=True)
    tn, _, ttr = tsp.spgemm_pallas_streamed(_port(ja), _port(jb),
                                            num_slabs=3, wide=wide,
                                            slab_out_cap=2048)
    assert (tn, ttr) == (int(jn), bool(jtr))
