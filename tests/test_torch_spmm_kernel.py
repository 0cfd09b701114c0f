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
from combblas_tpu_torch.ops.spmm_kernel import (  # noqa: E402
    _spmm_coo,
    spmm_coo_plain,
    spmm_pallas,
)


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


def _split_emulated(row_ptr, col, val, x, piece_len):
    """``csrc/spmm_coo.cu``'s two passes on the host, indexed as the kernel
    indexes them: range t = entries [t*L, (t+1)*L) starts at the row that
    holds its first entry; a row of at most L entries is summed whole by
    the range of its first entry, a longer row cut at the range bounds
    into partial slot 2t (the range's first row) or 2t+1 (a long row that
    starts inside it); pass 2 sums a long row's slots in range order and
    writes 0 to an empty row.  Every slot is written and read once."""
    m, d, big = len(row_ptr) - 1, x.shape[1], piece_len
    nnz = int(row_ptr[-1])
    prod = (val[:, None] * x[col]).astype(np.float64)   # float32 products
    ranges = -(-nnz // big)
    part = np.full((2 * ranges, d), np.nan)
    y = np.full((m, d), np.nan, np.float32)
    for t in range(ranges):
        a, b = t * big, min(t * big + big, nnz)
        r = int(np.searchsorted(row_ptr, a, side="right")) - 1
        s = row_ptr[r]
        while s < b:
            e = row_ptr[r + 1]
            cut = e - s > big
            if cut or (a <= s < e):
                i0, i1 = (max(s, a), min(e, b)) if cut else (s, e)
                acc = prod[i0:i1].sum(0)
                if cut:
                    slot = 2 * t + (s > a)
                    assert np.isnan(part[slot]).all()
                    part[slot] = acc
                else:
                    assert np.isnan(y[r]).all()
                    y[r] = acc
            s, r = e, r + 1
    read = np.zeros(2 * ranges, bool)
    for r in range(m):
        s, e = row_ptr[r], row_ptr[r + 1]
        if s < e <= s + big:
            continue
        assert np.isnan(y[r]).all()
        t0 = s // big
        t1 = (e - 1) // big if e > s else t0 - 1
        acc = np.zeros(d)
        for t in range(t0, t1 + 1):
            slot = 2 * t + (t == t0 and s > t0 * big)
            assert not read[slot]
            read[slot] = True
            acc += part[slot]
        y[r] = acc
    assert (read == ~np.isnan(part[:, 0])).all()
    return y


@pytest.mark.parametrize("kind", ["small", "hub", "rmat9"])
@pytest.mark.parametrize("piece_len", [1, 7, 1 << 20])
def test_spmm_coo_row_pieces_match_plain(kind, piece_len):
    """K8's split on the plain side: rows cut into pieces at the range
    bounds, each piece summed alone, the pieces combined in range order,
    equal one ``spmm_coo_plain`` call (rtol 1e-5), empty rows 0."""
    ta = _port(_case(kind))
    rp = ta.row_ptr()
    nnz = int(ta.nnz)
    col, val = ta.col[:nnz].numpy(), ta.val[:nnz].numpy()
    x = np.random.default_rng(piece_len).random((ta.shape[1], 8)).astype(
        np.float32)
    deg = np.diff(rp.numpy())
    if kind == "hub" and piece_len < 1 << 20:
        assert deg.max() > piece_len and (deg == 0).any()
    got = _split_emulated(rp.numpy(), col, val, x, piece_len)
    want = spmm_coo_plain(rp, ta.col[:nnz], ta.val[:nnz],
                          torch.from_numpy(x)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not got[deg == 0].any()
    # the CPU route takes the plain version whatever the piece length
    np.testing.assert_array_equal(
        _spmm_coo(rp, ta.col[:nnz], ta.val[:nnz], torch.from_numpy(x),
                  plain=False, piece_len=piece_len).numpy(), want)
