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

import _torch_kernel_cases as cases  # noqa: E402
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


def _jax_compress(keys64, vals, sr_name, wide):
    """JAX's K2 (or K4) on an edge case, the stream sentinel-padded to its
    32768-element tiles (sentinels are dropped wherever they stand), at the
    smallest capacity it takes: (int64 keys, values, nnz)."""
    pad = -(-keys64.shape[0] // TILE) * TILE - keys64.shape[0]
    keys64 = np.r_[keys64, np.full(pad, SENT64)]
    vals = np.r_[vals, np.zeros(pad, np.float32)]
    cap = max(2048, -(-cases.compress_nnz(keys64) // 128) * 128)
    sr = jsr.get_semiring(sr_name)
    if wide:
        stride = 1 << 20
        live = keys64 != SENT64
        hi = np.where(live, keys64 // stride, SENT32).astype(np.int32)
        lo = np.where(live, keys64 % stride, SENT32).astype(np.int32)
        jh, jl, jv, jn = compress_sorted_wide_pallas(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals), sr,
            out_capacity=cap, interpret=True)
        jh, jl = np.asarray(jh), np.asarray(jl)
        key = np.where(jh == SENT32, SENT64,
                       jh.astype(np.int64) * stride + jl)
    else:
        jk, jv, jn = compress_sorted_packed_pallas(
            jnp.asarray(cases.as_int32(keys64)), jnp.asarray(vals), sr,
            out_capacity=cap, interpret=True)
        key = np.where(np.asarray(jk) == SENT32, SENT64,
                       np.asarray(jk).astype(np.int64))
    return key, np.asarray(jv), int(jn)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name, sr_name", [
    ("run_lengths", "plus_times"), ("run_lengths", "min_plus"),
    ("run_lengths", "max_second"), ("one_run", "plus_times"),
    ("one_run", "max_second"), ("single", "plus_times"),
    ("single_sentinel", "plus_times"), ("all_sentinel", "plus_times"),
])
def test_compress_edge_cases_match_jax(name, sr_name, wide):
    """The tiled kernel's edge cases (runs of 1, T-1, T, T+1, 5T around the
    tile edges, sentinels between runs, one run over the whole stream, n = 1,
    n not a multiple of T) through the port's plain version at capacities
    with room, exactly nnz and cutting, against JAX's compress: keys and nnz
    exact, values within this file's tolerance, the slots past nnz sentinel
    / 0."""
    keys64, vals = cases.compress_case(name, tcmp.COMPRESS_TILE)
    jkey, jval, jnnz = _jax_compress(keys64, vals, sr_name, wide)
    nnz = cases.compress_nnz(keys64)
    assert jnnz == nnz
    key = keys64 if wide else cases.as_int32(keys64)
    fn = (tcmp.compress_sorted_wide_keys if wide
          else tcmp.compress_sorted_packed)
    sent = SENT64 if wide else SENT32
    for cap in cases.compress_caps(nnz):
        tk, tv, tn = fn(torch.from_numpy(key), torch.from_numpy(vals),
                        tsr.get_semiring(sr_name), out_capacity=cap)
        keep = min(cap, nnz)
        assert int(tn) == keep
        np.testing.assert_array_equal(tk.numpy()[:keep].astype(np.int64),
                                      jkey[:keep])
        _check_vals(sr_name, tv.numpy()[:keep], jval[:keep])
        assert np.all(tk.numpy()[keep:] == sent)
        assert np.all(tv.numpy()[keep:] == 0)
