"""Port expansion (``ops/kernels/expand.py``) vs the JAX Pallas kernels K1
``expand_chunks_compact`` and K3 ``expand_chunks_compact_wide``, run in
interpret mode on shared numpy inputs.  Keys and counts must be exact and
f32 values bitwise equal (one multiply per product, in the same type)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.pallas.expand_kernel import (  # noqa: E402
    CH,
    build_chunk_meta,
    expand_chunks_compact,
    expand_chunks_compact_wide,
)
from combblas_tpu.ops.spgemm import _tables_2d, stream_capacity  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.kernels import expand as texp  # noqa: E402

SEMIRINGS = ["plus_times", "min_plus", "max_second", "or_and"]


def _operands(seed):
    """A (40 x 50) with empty rows; B (50 x 300) with empty rows and one row
    longer than a 128-lane chunk."""
    rng = np.random.default_rng(seed)
    m, k, n = 40, 50, 300
    ad = ((rng.random((m, k)) < 0.08) * rng.standard_normal((m, k)))
    ad[5:9] = 0.0
    bd = ((rng.random((k, n)) < 0.05) * rng.standard_normal((k, n)))
    bd[[3, 11, 12]] = 0.0
    bd[7] = (rng.random(n) < 0.7) * (rng.random(n) + 0.5)
    ad[:, 7] += (rng.random(m) < 0.3)  # A entries that hit the long B row
    ja = JCOO.from_dense(ad.astype(np.float32))
    jb = JCOO.from_dense(bd.astype(np.float32))
    return ja, jb


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _jax_meta(ja, jb, stride):
    b_rp = jb.row_ptr()
    rp = np.asarray(b_rp).astype(np.int64)
    nnz = int(ja.nnz)
    acol = np.asarray(ja.col)[:nnz]
    cnt = rp[acol + 1] - rp[acol]
    chunks = int((-(-cnt // CH)).sum())
    chunk_cap = max(-(-chunks // 16) * 16, 16)
    meta, metaf, _, flops = build_chunk_meta(
        ja.row, ja.col, ja.val, ja.mask(), b_rp[:-1], b_rp[1:], stride,
        chunk_cap)
    return meta, metaf, int(flops)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("stride_kind", ["zero", "packed"])
def test_expand_i32_matches_k1(sr_name, stride_kind):
    ja, jb = _operands(1)
    n = jb.shape[1]
    stride = 0 if stride_kind == "zero" else n + 1
    meta, metaf, flops = _jax_meta(ja, jb, stride)
    cap = stream_capacity(flops)
    bc2, bv2 = _tables_2d(jb)
    jk, jv, jt = expand_chunks_compact(meta, metaf, bc2, bv2,
                                       jsr.get_semiring(sr_name),
                                       stream_cap=cap, interpret=True)
    ta, tb = _port(ja), _port(jb)
    before = dict(LAUNCHES)
    tk, tv, tt = texp.expand_chunks_compact(
        ta.row, ta.col, ta.val, ta.mask(), tb.row_ptr(), tb.col, tb.val,
        tsr.get_semiring(sr_name), stride=stride, stream_cap=cap)
    assert LAUNCHES == before  # CPU tensors never count as kernel launches
    assert int(tt) == int(jt) == flops > 0
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_expand_i64_matches_k3(sr_name):
    ja, jb = _operands(2)
    n = jb.shape[1]
    meta, metaf, flops = _jax_meta(ja, jb, 0)
    cap = stream_capacity(flops)
    bc2, bv2 = _tables_2d(jb)
    jr, jc, jv, jt = expand_chunks_compact_wide(
        meta, metaf, bc2, bv2, jsr.get_semiring(sr_name), stream_cap=cap,
        interpret=True)
    ta, tb = _port(ja), _port(jb)
    tk, tv, tt = texp.expand_chunks_compact_wide(
        ta.row, ta.col, ta.val, ta.mask(), tb.row_ptr(), tb.col, tb.val,
        tsr.get_semiring(sr_name), stride=n + 1, stream_cap=cap)
    assert int(tt) == int(jt) == flops
    assert tk.dtype == torch.int64
    key = tk.numpy()
    row, col = np.divmod(key[:flops], n + 1)
    np.testing.assert_array_equal(row, np.asarray(jr)[:flops])
    np.testing.assert_array_equal(col, np.asarray(jc)[:flops])
    assert np.all(key[flops:] == np.iinfo(np.int64).max)
    assert np.all(np.asarray(jr)[flops:] == np.iinfo(np.int32).max)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


def test_expand_truncates_at_capacity_and_empty_a():
    ja, jb = _operands(3)
    ta, tb = _port(ja), _port(jb)
    sr = tsr.PLUS_TIMES
    full_k, full_v, total = texp.expand_chunks_compact(
        ta.row, ta.col, ta.val, ta.mask(), tb.row_ptr(), tb.col, tb.val, sr,
        stride=0, stream_cap=4096)
    small_k, small_v, total2 = texp.expand_chunks_compact(
        ta.row, ta.col, ta.val, ta.mask(), tb.row_ptr(), tb.col, tb.val, sr,
        stride=0, stream_cap=100)
    assert int(total2) == int(total) > 100
    assert torch.equal(small_k, full_k[:100])
    assert torch.equal(small_v, full_v[:100])
    none = torch.zeros_like(ta.mask())
    ek, ev, et = texp.expand_chunks_compact(
        ta.row, ta.col, ta.val, none, tb.row_ptr(), tb.col, tb.val, sr,
        stride=0, stream_cap=256)
    assert int(et) == 0
    assert bool((ek == np.iinfo(np.int32).max).all())
    assert bool((ev == 0).all())


def test_expand_wrapper_rejects_bad_inputs():
    ja, jb = _operands(4)
    ta, tb = _port(ja), _port(jb)
    args = [ta.row, ta.col, ta.val, ta.mask(), tb.row_ptr(), tb.col, tb.val,
            tsr.PLUS_TIMES]
    bad_val = list(args)
    bad_val[2] = ta.val.double()
    with pytest.raises(TypeError):
        texp.expand_chunks_compact(*bad_val, stride=0, stream_cap=256)
    bad_rp = list(args)
    bad_rp[4] = tb.row_ptr().int()
    with pytest.raises(TypeError):
        texp.expand_chunks_compact(*bad_rp, stride=0, stream_cap=256)
    strided = list(args)
    strided[1] = torch.stack([ta.col, ta.col], 1)[:, 0]
    with pytest.raises(ValueError):
        texp.expand_chunks_compact(*strided, stride=0, stream_cap=256)
    with pytest.raises(ValueError):
        texp.expand_chunks_compact(*args, stride=0, stream_cap=0)
