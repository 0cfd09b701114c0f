"""The port's ``ops/coo.py`` container helpers and ESC back-ends vs the JAX
package's on shared numpy inputs: whole arrays, pads included.  Integer
arrays and nnz are exact; values exact where no sum is folded and within
rtol 1e-6 where two runs fold sums in other orders."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops import coo as jcoo  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops import coo as tcoo  # noqa: E402

SEMIRINGS = ["plus_times", "min_plus", "max_second"]


def _port(a):
    return tcoo.SpCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                                 np.asarray(a.val), int(a.nnz), a.shape,
                                 device="cpu")


def _same(t, j, exact=True):
    """Port SpCOO ``t`` equals JAX SpCOO ``j`` slot for slot."""
    assert t.shape == tuple(j.shape)
    assert t.capacity == j.capacity
    assert int(t.nnz) == int(j.nnz)
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    if exact:
        np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
    else:
        np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val),
                                   rtol=1e-6)


def _random(seed, m, n, e, cap):
    """A canonical (m, n) matrix of <= e entries in a ``cap`` buffer."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, m, e)
    c = rng.integers(0, n, e)
    v = (rng.random(e) + 0.25).astype(np.float32)
    return jcoo.SpCOO.from_arrays(r, c, v, (m, n), capacity=cap)


def _stream(seed, m, n, e, cap):
    """An unsorted triple stream with duplicates: ``e`` live entries, then
    (m, n, 0) pads up to ``cap``."""
    rng = np.random.default_rng(seed)
    i = np.full(cap, m, np.int32)
    j = np.full(cap, n, np.int32)
    v = np.zeros(cap, np.float32)
    i[:e] = rng.integers(0, m, e)
    j[:e] = rng.integers(0, n, e)
    v[:e] = rng.random(e) + 0.25
    return i, j, v


def test_sort_coo_matches_jax():
    i, j, v = _stream(0, 30, 20, 90, 128)
    shuffled = np.random.default_rng(1).permutation(128)
    i, j, v = i[shuffled], j[shuffled], v[shuffled]
    ja = jcoo.SpCOO(row=jnp.asarray(i), col=jnp.asarray(j),
                    val=jnp.asarray(v), nnz=jnp.asarray(90, jnp.int32),
                    shape=(30, 20))
    _same(tcoo.sort_coo(_port(ja)), jcoo.sort_coo(ja))


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("out_cap", [None, 64])
def test_sort_compress_packed_matches_jax(sr_name, out_cap):
    """The packed route, with an output capacity that saturates: nnz stops
    at 64 and the pads past it come from the key (m+1)*(n+1) - 1."""
    m, n = 30, 20
    i, j, v = _stream(2, m, n, 150, 256)
    key = i * (n + 1) + j
    jr = jcoo.sort_compress_packed(jnp.asarray(key), jnp.asarray(v), 150,
                                   (m, n), sr=jsr.get_semiring(sr_name),
                                   out_capacity=out_cap)
    tr = tcoo.sort_compress_packed(torch.from_numpy(key), torch.from_numpy(v),
                                   150, (m, n), sr=tsr.get_semiring(sr_name),
                                   out_capacity=out_cap)
    assert int(jr.nnz) == (64 if out_cap else int(jr.nnz)) > 0
    _same(tr, jr, exact=sr_name != "plus_times")


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("shape", [(30, 20), (50000, 60000)])
def test_sort_compress_matches_jax(sr_name, shape):
    """Packed keys for the small shape, the (row, col) two-key sort once
    (m+1)*(n+1) reaches 2^31."""
    m, n = shape
    i, j, v = _stream(3, m, n, 120, 256)
    i[:40] = i[40:80]                    # duplicate coordinates
    j[:40] = j[40:80]
    jr = jcoo.sort_compress(jnp.asarray(i), jnp.asarray(j), jnp.asarray(v),
                            120, shape, sr=jsr.get_semiring(sr_name),
                            out_capacity=128)
    tr = tcoo.sort_compress(torch.from_numpy(i), torch.from_numpy(j),
                            torch.from_numpy(v), 120, shape,
                            sr=tsr.get_semiring(sr_name), out_capacity=128)
    assert int(jr.nnz) < 120
    _same(tr, jr, exact=sr_name != "plus_times")


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_merge_matches_jax(sr_name):
    ja = _random(4, 25, 18, 60, 64)
    jb = _random(5, 25, 18, 70, 128)
    for out_cap in (None, 40):
        jr = jcoo.merge(ja, jb, jsr.get_semiring(sr_name),
                        out_capacity=out_cap)
        tr = tcoo.merge(_port(ja), _port(jb), tsr.get_semiring(sr_name),
                        out_capacity=out_cap)
        _same(tr, jr, exact=sr_name != "plus_times")


@pytest.mark.parametrize("nsplits", [1, 3, 4, 7])
def test_row_split_and_concat_match_jax(nsplits):
    """Bands of ceil(m/nsplits) rows; with m = 10 and 4 or 7 splits the last
    bands are short or empty (shape (1, n), pads on row 0)."""
    ja = _random(6, 10, 12, 40, 64)
    jparts = jcoo.row_split(ja, nsplits)
    tparts = tcoo.row_split(_port(ja), nsplits)
    assert len(tparts) == len(jparts) == nsplits
    for t, j in zip(tparts, jparts):
        _same(t, j)
    _same(tcoo.row_concat(tparts), jcoo.row_concat(jparts))


def test_transpose_astype_find_match_jax():
    ja = _random(7, 23, 31, 80, 128)
    ta = _port(ja)
    _same(ta.transpose(), ja.transpose())
    _same(ta.transpose().transpose(), ja)
    t64 = ta.astype(torch.float64)
    assert t64.val.dtype == torch.float64
    np.testing.assert_array_equal(t64.val.numpy(),
                                  np.asarray(ja.val).astype(np.float64))
    for tx, jx in zip(tcoo.find(ta), jcoo.find(ja)):
        np.testing.assert_array_equal(tx, jx)
    r, c, v = tcoo.find(ta)
    back = tcoo.SpCOO.from_arrays(r, c, v, ta.shape, capacity=ta.capacity,
                                  device="cpu")
    _same(back, ja)


@pytest.mark.parametrize("cap", [32, 64, 200])
def test_with_capacity_matches_jax(cap):
    """Shrinking below nnz saturates nnz; growing pads with (m, n, 0)."""
    ja = _random(8, 20, 15, 60, 64)
    _same(_port(ja).with_capacity(cap), ja.with_capacity(cap))


def test_eye_and_empty_match_jax():
    _same(tcoo.SpCOO.eye(9, value=2.5, capacity=16, device="cpu"),
          jcoo.SpCOO.eye(9, value=2.5, capacity=16))
    _same(tcoo.SpCOO.eye(5, device="cpu"), jcoo.SpCOO.eye(5))
    e = tcoo.SpCOO.empty((7, 4), capacity=12, device="cpu")
    _same(e, jcoo.SpCOO.empty((7, 4), capacity=12))
    assert e.nnz.dtype == torch.int64
