"""The port's row-classed seg pipeline vs the JAX package on the same
matrices: the host plan key for key, the class windows exactly, and the
digest (nnz exact, checksum within rtol 1e-5) after every slab, with the
JAX kernels in interpret mode at the sizes of ``tests/test_spgemm_seg.py``.
K2 folds in the stream's order and the layout is JAX's, but the port's plain
compress sums a run in another association, hence the tolerance."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.gen.rmat import rmat_matrix  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops import spgemm_seg as jseg  # noqa: E402
from combblas_tpu.semiring import MIN_PLUS as J_MP  # noqa: E402
from combblas_tpu.semiring import PLUS_TIMES as J_PT  # noqa: E402
from combblas_tpu_torch.gen.rmat import SSCA_PROBS  # noqa: E402
from combblas_tpu_torch.ops import spgemm_seg as tseg  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels.expand import (  # noqa: E402
    expand_chunks_compact,
)
from combblas_tpu_torch.ops.kernels.winsort import (  # noqa: E402
    key_bits,
    window_sort,
)
from combblas_tpu_torch.ops.spgemm import _slab_extract  # noqa: E402
from combblas_tpu_torch.semiring import MIN_PLUS as T_MP  # noqa: E402
from combblas_tpu_torch.semiring import PLUS_TIMES as T_PT  # noqa: E402

SEMIRINGS = {"plus_times": (J_PT, T_PT), "min_plus": (J_MP, T_MP)}


def _skewed(seed=7, size=200):
    """``tests/test_spgemm_seg.py``'s power-law case: a few hub rows with
    wide windows, many short rows; B dense-ish at 0.2."""
    rng = np.random.default_rng(seed)
    m = k = n = size
    ad = np.zeros((m, k), np.float32)
    for i in range(m):
        deg = min(int(rng.pareto(0.7) + 1), k)
        cols = rng.choice(k, size=deg, replace=False)
        ad[i, cols] = rng.random(deg).astype(np.float32) + 0.1
    bd = (rng.random((k, n)) < 0.2).astype(np.float32) * 0.5
    return ad, bd


def _uniform150():
    rng = np.random.default_rng(3)
    ad = (rng.random((150, 150)) < 0.08).astype(np.float32)
    return ad, ad


def _pair(case):
    """(JAX A, JAX B, port A, port B) with identical padded arrays."""
    if case == "rmat8":
        ja = rmat_matrix(jax.random.PRNGKey(42), scale=8, edgefactor=8,
                         probs=SSCA_PROBS)
        jb = ja
    else:
        ad, bd = _skewed() if case == "skewed200" else _uniform150()
        ja, jb = JCOO.from_dense(ad), JCOO.from_dense(bd)
    return ja, jb, _port(ja), _port(jb)


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


@pytest.mark.parametrize("max_row", [0, 1, 127, 128, 191, 192, 1000,
                                     (1 << 20) + 5])
def test_widths_upto_equals_jax(max_row):
    assert tseg._widths_upto(max_row) == jseg._widths_upto(max_row)


@pytest.mark.parametrize("case,num_slabs", [
    ("skewed200", 1), ("skewed200", 3), ("skewed200", 4),
    ("uniform150", 5), ("rmat8", 1), ("rmat8", 3)])
def test_seg_plan_identical(case, num_slabs):
    ja, jb, ta, tb = _pair(case)
    jplan = jseg.seg_plan(ja, jb, num_slabs)
    tplan = tseg.seg_plan(ta, tb, num_slabs)
    assert set(tplan) == set(jplan)
    np.testing.assert_array_equal(tplan["bounds"], jplan["bounds"])
    assert tplan["bounds"].dtype == np.asarray(jplan["bounds"]).dtype
    for key in set(jplan) - {"bounds"}:
        assert tplan[key] == jplan[key], key
        assert type(tplan[key]) is type(jplan[key]), key


@pytest.mark.parametrize("case,num_slabs", [("skewed200", 3),
                                            ("skewed200", 4), ("rmat8", 3)])
def test_class_windows_identical(case, num_slabs):
    """Both packages' ``_class_windows`` on one slab stream (the port's K1
    plain version): windows, row ids and lengths equal, slot for slot."""
    _ja, _jb, ta, tb = _pair(case)
    plan = tseg.seg_plan(ta, tb, num_slabs)
    b_rp = tb.row_ptr()
    bounds = torch.as_tensor(plan["bounds"].astype(np.int64))
    kw = dict(classes=plan["classes"], s_caps=plan["s_caps"],
              span_cap=plan["span_cap"])
    live_seen = 0
    for s in range(len(plan["bounds"]) - 1):
        sub, _ = _slab_extract(ta, ta.shape[1], bounds, s,
                               span_cap=plan["span_cap"],
                               slab_nnz_cap=plan["slab_nnz_cap"])
        col, val, _total = expand_chunks_compact(
            sub.row, sub.col, sub.val, sub.mask(), b_rp, tb.col, tb.val,
            T_PT, stride=0, stream_cap=plan["stream_cap"])
        rowfl, row_start = tseg._row_flops_exact(sub, b_rp, plan["span_cap"])
        got = tseg._class_windows(col, val, rowfl, row_start, **kw)
        want = jseg._class_windows(
            jax.numpy.asarray(col.numpy()), jax.numpy.asarray(val.numpy()),
            jax.numpy.asarray(rowfl.numpy().astype(np.int32)),
            jax.numpy.asarray(row_start.numpy().astype(np.int32)), **kw)
        assert len(got) == len(want) == len(plan["classes"])
        for g, w in zip(got, want):
            for gx, wx in zip(g, w):
                np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
            live_seen += int((g[3] > 0).sum())
    # every row with products got exactly one live window
    assert live_seen == int((tseg._row_flops_exact(
        ta, b_rp, ta.shape[0])[0][:-1] > 0).sum())


def _slab_streams(case, num_slabs):
    """(plan, each slab's (K1 plain stream, rowfl, row_start)) of a case's
    A x B."""
    _ja, _jb, ta, tb = _pair(case)
    plan = tseg.seg_plan(ta, tb, num_slabs)
    b_rp = tb.row_ptr()
    bounds = torch.as_tensor(plan["bounds"].astype(np.int64))
    out = []
    for s in range(len(plan["bounds"]) - 1):
        sub, _ = _slab_extract(ta, ta.shape[1], bounds, s,
                               span_cap=plan["span_cap"],
                               slab_nnz_cap=plan["slab_nnz_cap"])
        col, val, _total = expand_chunks_compact(
            sub.row, sub.col, sub.val, sub.mask(), b_rp, tb.col, tb.val,
            T_PT, stride=0, stream_cap=plan["stream_cap"])
        out.append((col, val) + tseg._row_flops_exact(sub, b_rp,
                                                      plan["span_cap"]))
    return plan, tb.shape[1], out


@pytest.mark.parametrize("case", ["skewed200", "rmat8"])
def test_window_table_matches_class_windows(case):
    """The window table gives each of ``_class_windows``' windows, in its
    order, the row's stream start (0 when dead), its live length, its
    offset in the class buffer (classes end to end) and its width; the
    window sort's plain version on it gives the seg step's class buffer
    bit for bit."""
    plan, n_cols, slabs = _slab_streams(case, 3)
    kw = dict(classes=plan["classes"], s_caps=plan["s_caps"])
    assert len(slabs) == 3
    for col, val, rowfl, row_start in slabs:
        start, lens, dest, width = tseg._window_table(
            rowfl, row_start,
            tseg._class_table(plan["classes"], plan["s_caps"], "cpu"),
            windows=sum(plan["s_caps"]), span_cap=plan["span_cap"])
        wins = tseg._class_windows(col, val, rowfl, row_start,
                                   span_cap=plan["span_cap"], **kw)
        w0 = off = 0
        sorted_k, sorted_v = [], []
        for (col2d, val2d, rows_c, lens_c), L in zip(wins, plan["classes"]):
            S = col2d.shape[0]
            win = slice(w0, w0 + S)
            live = lens_c > 0
            assert torch.equal(lens[win], lens_c)
            assert torch.equal(start[win],
                               torch.where(live, row_start[rows_c], 0))
            assert torch.equal(dest[win], off + L * torch.arange(S))
            assert torch.equal(width[win], torch.full((S,), L))
            k, perm = torch.sort(col2d, dim=1, stable=True)
            sorted_k.append(k.reshape(-1))
            sorted_v.append(torch.gather(val2d, 1, perm).reshape(-1))
            w0 += S
            off += S * L
        assert w0 == start.shape[0] and off == plan["padded"]
        cat_k, cat_v = window_sort(col, val, (start, lens, dest, width),
                                   key_bits=key_bits(n_cols), **kw)
        assert torch.equal(cat_k, torch.cat(sorted_k))
        assert torch.equal(cat_v.view(torch.int32),
                           torch.cat(sorted_v).view(torch.int32))


@pytest.mark.parametrize("sr_name", sorted(SEMIRINGS))
@pytest.mark.parametrize("num_slabs", [1, 3, 4])
def test_seg_digest_matches_jax_every_slab(num_slabs, sr_name):
    j_sr, t_sr = SEMIRINGS[sr_name]
    ja, jb, ta, tb = _pair("skewed200")
    jprep = jseg.seg_prepare(ja, jb, num_slabs)
    tprep = tseg.seg_prepare(ta, tb, num_slabs)
    assert tprep[4] == jprep[4]  # slab_out_cap
    # the port's class table in the place of JAX's B lane tables
    widths, caps, _w0, _e0 = tprep[2].tolist()
    assert (tuple(widths), tuple(caps)) == (jprep[0]["classes"],
                                            jprep[0]["s_caps"])
    jstate = jseg.seg_zero_state()
    tstate = tseg.seg_zero_state("cpu")
    S = len(tprep[0]["bounds"]) - 1
    assert S == num_slabs
    for s in range(S):
        jstate = jseg.seg_step(ja, jb, jprep, s, jstate, j_sr,
                               interpret=True)
        tstate = tseg.seg_step(ta, tb, tprep, s, tstate, t_sr)
        j_nnz = int(jstate[0]) + (int(jstate[1]) << 16)
        assert int(tstate[0]) == j_nnz, s
        np.testing.assert_allclose(float(tstate[1]), float(jstate[2]),
                                   rtol=1e-5)
        assert bool(tstate[2]) == bool(jstate[3]) is False
    got = tseg.spgemm_streamed_seg(ta, tb, t_sr, num_slabs=num_slabs)
    assert got == (int(tstate[0]), float(tstate[1]), False,
                   float(tstate[3]))


@pytest.mark.parametrize("case", ["dense-0-0.04", "dense-1-0.15", "skewed"])
def test_seg_equals_seg2_and_dense(case):
    """The classed digest against the port's seg2 digest and a dense
    float64 product."""
    if case == "skewed":
        ad, bd = _skewed(seed=11, size=120)
    else:
        _, seed, density = case.split("-")
        rng = np.random.default_rng(int(seed))
        ad = ((rng.random((96, 80)) < float(density))
              * rng.random((96, 80))).astype(np.float32)
        bd = ((rng.random((80, 64)) < float(density))
              * rng.random((80, 64))).astype(np.float32)
    a = TCOO.from_dense(ad, device="cpu")
    b = TCOO.from_dense(bd, device="cpu")
    nnz, cks, trunc, signed = tseg.spgemm_streamed_seg(a, b, T_PT,
                                                       num_slabs=3)
    nnz2, cks2, trunc2 = tseg.spgemm_streamed_seg2(
        a, b, T_PT, flops_cap=1 << 12, pad_cap=1 << 16)
    ref = ad.astype(np.float64) @ bd.astype(np.float64)
    assert not trunc and not trunc2
    assert nnz == nnz2 == int((ref != 0).sum())
    np.testing.assert_allclose(cks, cks2, rtol=1e-5)
    np.testing.assert_allclose(cks, ref.sum(), rtol=1e-5)
    # odd columns negated
    sign = 1 - 2 * (np.arange(ref.shape[1]) % 2)
    assert abs(signed - (ref * sign).sum()) <= 1e-5 * np.linalg.norm(ref)


def _span_cap_patched(monkeypatch, module, span_cap):
    orig = module._pallas_slab_plan

    def plan(a, b, num_slabs, wide=False):
        bounds, _span, nnz_cap, chunk_cap, worst_fl = orig(a, b, num_slabs,
                                                           wide=wide)
        return bounds, span_cap, nnz_cap, chunk_cap, worst_fl

    monkeypatch.setattr(module, "_pallas_slab_plan", plan)


@pytest.mark.parametrize("over", [False, True])
def test_class_key_guard_refuses_jax_plans(monkeypatch, over):
    """The port refuses a plan exactly when JAX's int32 class-key assertion
    does: a span one row past the limit fails in both, one at it passes."""
    ja, jb, ta, tb = _pair("skewed200")
    ncls = len(tseg.seg_plan(ta, tb, 4)["classes"])
    span = (2**31 - 1) // (ncls + 2) - 1 + int(over)
    _span_cap_patched(monkeypatch, jseg, span)
    _span_cap_patched(monkeypatch, tseg, span)
    if over:
        with pytest.raises(AssertionError, match="int32 class-key"):
            jseg.seg_plan(ja, jb, 4)
        with pytest.raises(ValueError, match="class key overflows int32"):
            tseg.seg_plan(ta, tb, 4)
    else:
        assert jseg.seg_plan(ja, jb, 4)["span_cap"] == span
        assert tseg.seg_plan(ta, tb, 4)["span_cap"] == span


def test_stream_overrun_raises(monkeypatch):
    """A stream shorter than a slab's flops plus the widest window would
    make the window gather read past it: ``seg_prepare`` refuses."""
    _ja, _jb, ta, tb = _pair("skewed200")
    monkeypatch.setattr(tseg, "stream_capacity",
                        lambda flops, tile=tseg.TILE: flops - 1)
    with pytest.raises(ValueError, match="read past"):
        tseg.seg_prepare(ta, tb, 4)
    # a stream of exactly that length is enough
    monkeypatch.setattr(tseg, "stream_capacity",
                        lambda flops, tile=tseg.TILE: flops)
    assert tseg.spgemm_streamed_seg(ta, tb, T_PT, num_slabs=4) == \
        tseg.spgemm_streamed_seg(ta, tb, T_PT, num_slabs=4)


def test_seg_truncation_flag():
    """A slab output capacity below a slab's nnz sets ``truncated``."""
    rng = np.random.default_rng(1)
    d = ((rng.random((64, 64)) < 0.3) * rng.random((64, 64))).astype(
        np.float32)
    a = TCOO.from_dense(d, device="cpu")
    full = int(((d @ d) != 0).sum())
    assert full > 2048
    nnz, _cks, trunc, _sg = tseg.spgemm_streamed_seg(a, a, T_PT,
                                                     num_slabs=1)
    assert not trunc and nnz == full
    nnz, _cks, trunc, _sg = tseg.spgemm_streamed_seg(a, a, T_PT, num_slabs=1,
                                                     slab_out_cap=2048)
    assert trunc and nnz == 2048
