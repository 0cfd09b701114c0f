"""Port compress (``ops/kernels/compress.py``) vs the JAX Pallas kernels K2
``compress_sorted_packed_pallas`` and K4 ``compress_sorted_wide_pallas``,
interpret mode, shared numpy inputs.  Keys and nnz exact; values exact for
min/max and within rtol 1e-6 for sum (the fold order differs: the JAX kernel
scans in a log-step tree, the port folds each run left to right)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu.ops.pallas.compress_kernel import (  # noqa: E402
    compress_sorted_packed_pallas,
    compress_sorted_wide_pallas,
)
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops.kernels import compress as tcmp  # noqa: E402

SENT32 = np.iinfo(np.int32).max
SENT64 = np.iinfo(np.int64).max
TILE = 32768
SEMIRINGS = ["plus_times", "min_plus", "max_second"]


def _windowed_stream(seed, w=384, nwin=256):
    """seg2-style stream: (nwin, w) windows, each sorted with >= 1 trailing
    sentinel; lengths up to w-1 so runs end right at window (and, for the
    window straddling 32768, tile) edges; a few all-sentinel windows."""
    rng = np.random.default_rng(seed)
    K = np.full((nwin, w), SENT32, np.int32)
    V = np.zeros((nwin, w), np.float32)
    for i in range(nwin):
        ln = 0 if i % 37 == 5 else int(rng.integers(1, w))
        if i == (TILE // w):  # the window that straddles the tile edge
            ln = w - 1
        keys = np.sort(rng.integers(0, 60, ln)).astype(np.int32)
        K[i, :ln] = keys
        V[i, :ln] = rng.random(ln).astype(np.float32) + 0.25
    return K.reshape(-1), V.reshape(-1)


def _flat_pairs(seed, n=3 * TILE, nreal=70000):
    """Globally sorted (row, col) pairs with a run forced across the first
    tile edge, sentinel-padded to n."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 300, nreal)
    c = rng.integers(0, 200, nreal)
    r[TILE - 5: TILE + 5] = r[TILE - 5]
    c[TILE - 5: TILE + 5] = c[TILE - 5]
    order = np.lexsort((c, r))
    H = np.full(n, SENT32, np.int32)
    L = np.full(n, SENT32, np.int32)
    V = np.zeros(n, np.float32)
    H[:nreal], L[:nreal] = r[order], c[order]
    V[:nreal] = rng.random(nreal).astype(np.float32) + 0.25
    return H, L, V


def _check_vals(sr_name, got, want):
    if sr_name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("out_cap", [1 << 15, 2048])
def test_compress_i32_matches_k2(sr_name, out_cap):
    K, V = _windowed_stream(0)
    jk, jv, jn = compress_sorted_packed_pallas(
        jnp.asarray(K), jnp.asarray(V), jsr.get_semiring(sr_name),
        out_capacity=out_cap, interpret=True)
    tk, tv, tn = tcmp.compress_sorted_packed(
        torch.from_numpy(K), torch.from_numpy(V), tsr.get_semiring(sr_name),
        out_capacity=out_cap)
    assert int(tn) == int(jn)
    if out_cap == 2048:
        assert int(tn) == out_cap  # saturated: the truncation signal
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    _check_vals(sr_name, tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("out_cap", [1 << 15, 2048])
def test_compress_i64_matches_k4(sr_name, out_cap):
    H, L, V = _flat_pairs(1)
    stride = 201
    jh, jl, jv, jn = compress_sorted_wide_pallas(
        jnp.asarray(H), jnp.asarray(L), jnp.asarray(V),
        jsr.get_semiring(sr_name), out_capacity=out_cap, interpret=True)
    key = np.where(H == SENT32, SENT64,
                   H.astype(np.int64) * stride + L.astype(np.int64))
    th, tl, tv, tn = tcmp.compress_sorted_wide(
        torch.from_numpy(key), torch.from_numpy(V),
        tsr.get_semiring(sr_name), out_capacity=out_cap, stride=stride)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _check_vals(sr_name, tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_compress_plain_against_numpy(sr_name):
    """Independent reference: np.unique + ufunc.reduceat over non-sentinel
    runs (runs are separated by sentinels, never merged across them)."""
    K = np.array([3, 3, 5, SENT32, 5, 5, 7, SENT32, SENT32, 7, 9, 9],
                 np.int32)
    V = np.arange(1, 13, dtype=np.float32)
    tk, tv, tn = tcmp.compress_sorted_packed(
        torch.from_numpy(K), torch.from_numpy(V), tsr.get_semiring(sr_name),
        out_capacity=8)
    heads = np.flatnonzero(np.r_[True, K[1:] != K[:-1]])
    ufunc = {"plus_times": np.add, "min_plus": np.minimum,
             "max_second": np.maximum}[sr_name]
    red = ufunc.reduceat(V, heads)
    keep = K[heads] != SENT32
    want_k, want_v = K[heads][keep], red[keep]
    assert int(tn) == len(want_k) == 6
    np.testing.assert_array_equal(tk.numpy()[:6], want_k)
    np.testing.assert_array_equal(tv.numpy()[:6], want_v)
    assert np.all(tk.numpy()[6:] == SENT32) and np.all(tv.numpy()[6:] == 0)


def test_compress_wrapper_rejects_bad_inputs():
    K = torch.zeros(8, dtype=torch.int32)
    V = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(TypeError):
        tcmp.compress_sorted_packed(K.long(), V, tsr.PLUS_TIMES,
                                    out_capacity=4)
    with pytest.raises(TypeError):
        tcmp.compress_sorted_packed(K, V.double(), tsr.PLUS_TIMES,
                                    out_capacity=4)
    with pytest.raises(TypeError):
        tcmp.compress_sorted_wide(K, V, tsr.PLUS_TIMES, out_capacity=4,
                                  stride=3)
    with pytest.raises(ValueError):
        tcmp.compress_sorted_packed(K[::2], V[::2], tsr.PLUS_TIMES,
                                    out_capacity=4)
    with pytest.raises(ValueError):
        tcmp.compress_sorted_packed(K, V, tsr.PLUS_TIMES, out_capacity=0)
