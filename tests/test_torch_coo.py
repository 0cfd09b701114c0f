"""Port SpCOO, compress_sorted and the R-MAT generator vs the JAX package,
on shared numpy inputs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.gen import rmat as jrmat  # noqa: E402
from combblas_tpu.ops import coo as jcoo  # noqa: E402
from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu_torch.gen import rmat as trmat  # noqa: E402
from combblas_tpu_torch.ops import coo as tcoo  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402


def _port(a):
    """JAX SpCOO -> port SpCOO through the numpy bridge."""
    return tcoo.SpCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                                 np.asarray(a.val), int(a.nnz), a.shape,
                                 device="cpu")


def _assert_same(t, j):
    row, col, val, nnz, shape = t.to_numpy()
    assert shape == tuple(j.shape)
    assert nnz == int(j.nnz)
    np.testing.assert_array_equal(row, np.asarray(j.row))
    np.testing.assert_array_equal(col, np.asarray(j.col))
    np.testing.assert_array_equal(val, np.asarray(j.val))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_arrays_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m, n, e = 37, 29, 150
    r = rng.integers(0, m, e)
    c = rng.integers(0, n, e)
    v = rng.random(e).astype(np.float32)
    j = jcoo.SpCOO.from_arrays(r, c, v, (m, n))
    t = tcoo.SpCOO.from_arrays(r, c, v, (m, n), device="cpu")
    _assert_same(t, j)
    np.testing.assert_array_equal(t.mask().numpy(), np.asarray(j.mask()))
    np.testing.assert_array_equal(t.row_ptr().numpy(),
                                  np.asarray(j.row_ptr()))
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               rtol=0, atol=0)


def test_from_dense_and_empty_rows():
    d = np.zeros((6, 5), np.float32)
    d[0, 4] = 1.5
    d[3, [0, 2]] = [2.0, -1.0]
    j = jcoo.SpCOO.from_dense(d)
    t = tcoo.SpCOO.from_dense(d, device="cpu")
    _assert_same(t, j)
    np.testing.assert_array_equal(t.row_ptr().numpy(), [0, 1, 1, 1, 3, 3, 3])
    np.testing.assert_array_equal(t.to_dense().numpy(), d)


def test_numpy_bridge_round_trip():
    rng = np.random.default_rng(5)
    d = ((rng.random((20, 30)) < 0.2) * rng.random((20, 30))).astype(
        np.float32)
    j = jcoo.SpCOO.from_dense(d, capacity=256)
    t = _port(j)
    assert t.capacity == 256
    _assert_same(t, j)
    back = tcoo.SpCOO.from_numpy(*t.to_numpy(), device="cpu")
    _assert_same(back, j)
    assert back.nnz.dtype == torch.int64


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_second"])
@pytest.mark.parametrize("out_cap", [None, 16])
def test_compress_sorted_matches_jax(sr_name, out_cap):
    rng = np.random.default_rng(11)
    m, n, e = 12, 9, 80
    r = np.sort(rng.integers(0, m, e)).astype(np.int32)
    c = rng.integers(0, n, e).astype(np.int32)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = rng.random(e).astype(np.float32)
    cap = 96
    R = np.full(cap, m, np.int32)
    C = np.full(cap, n, np.int32)
    V = np.zeros(cap, np.float32)
    R[:e], C[:e], V[:e] = r, c, v
    j = jcoo.compress_sorted(jnp.asarray(R), jnp.asarray(C), jnp.asarray(V),
                             jnp.asarray(e), (m, n),
                             sr=jsr.get_semiring(sr_name),
                             out_capacity=out_cap)
    t = tcoo.compress_sorted(torch.from_numpy(R), torch.from_numpy(C),
                             torch.from_numpy(V), e, (m, n),
                             sr=tsr.get_semiring(sr_name),
                             out_capacity=out_cap)
    row, col, val, nnz, _ = t.to_numpy()
    assert nnz == int(j.nnz)
    np.testing.assert_array_equal(row, np.asarray(j.row))
    np.testing.assert_array_equal(col, np.asarray(j.col))
    np.testing.assert_allclose(val, np.asarray(j.val), rtol=1e-6)


@pytest.mark.parametrize("sr_name", ["plus_times", "max_second"])
@pytest.mark.parametrize("nvalid", [0, 1, 50, 96, 500])
def test_compress_sorted_folds_only_nvalid(sr_name, nvalid):
    """Entries past ``nvalid`` never fold, even where they are not pads
    (nvalid 50 of 80 real entries), and an ``nvalid`` past the capacity
    counts the whole stream: as the JAX package's."""
    rng = np.random.default_rng(12)
    m, n, cap = 12, 9, 96
    r = np.sort(rng.integers(0, m, 80)).astype(np.int32)
    c = rng.integers(0, n, 80).astype(np.int32)
    order = np.lexsort((c, r))
    R = np.full(cap, m, np.int32)
    C = np.full(cap, n, np.int32)
    V = np.zeros(cap, np.float32)
    R[:80], C[:80] = r[order], c[order]
    V[:80] = rng.random(80).astype(np.float32) + 0.5
    j = jcoo.compress_sorted(jnp.asarray(R), jnp.asarray(C), jnp.asarray(V),
                             jnp.asarray(nvalid), (m, n),
                             sr=jsr.get_semiring(sr_name), out_capacity=40)
    t = tcoo.compress_sorted(torch.from_numpy(R), torch.from_numpy(C),
                             torch.from_numpy(V), torch.tensor(nvalid),
                             (m, n), sr=tsr.get_semiring(sr_name),
                             out_capacity=40)
    row, col, val, nnz, _ = t.to_numpy()
    assert nnz == int(j.nnz)
    np.testing.assert_array_equal(row, np.asarray(j.row))
    np.testing.assert_array_equal(col, np.asarray(j.col))
    np.testing.assert_allclose(val, np.asarray(j.val), rtol=1e-6)


@pytest.mark.parametrize("self_loops,symmetrize",
                         [(False, False), (True, False), (True, True)])
def test_edges_to_coo_matches_jax(self_loops, symmetrize):
    rng = np.random.default_rng(2)
    scale, e = 6, 700
    rows = rng.integers(0, 1 << scale, e).astype(np.int32)
    cols = rng.integers(0, 1 << scale, e).astype(np.int32)
    n = 1 << scale
    cap = 2048
    j = jrmat.edges_to_coo(jnp.asarray(rows), jnp.asarray(cols), (n, n), cap,
                           remove_self_loops=self_loops, symmetrize=symmetrize)
    t = trmat.edges_to_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                           (n, n), cap, remove_self_loops=self_loops,
                           symmetrize=symmetrize)
    _assert_same(t, j)


def test_rmat_edges_range_count_determinism(monkeypatch):
    monkeypatch.setattr(trmat, "_EDGE_CHUNK", 1024)  # several batches
    scale, e = 9, 5000
    g = torch.Generator().manual_seed(7)
    r1, c1 = trmat.rmat_edges(g, scale, e, trmat.SSCA_PROBS)
    assert r1.shape == (e,) and c1.shape == (e,)
    assert r1.dtype == torch.int32
    for x in (r1, c1):
        assert int(x.min()) >= 0 and int(x.max()) < (1 << scale)
    r2, c2 = trmat.rmat_edges(torch.Generator().manual_seed(7), scale, e,
                              trmat.SSCA_PROBS)
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    r3, _ = trmat.rmat_edges(torch.Generator().manual_seed(8), scale, e,
                             trmat.SSCA_PROBS)
    assert not torch.equal(r1, r3)


def test_rmat_unscrambled_skew():
    """Without the scramble, quadrant a (.6) makes low ids dominate: the
    top half of the id range gets ~(1-.6-.4/3) of rows per level."""
    g = torch.Generator().manual_seed(0)
    r, c = trmat.rmat_edges(g, 8, 20000, trmat.SSCA_PROBS, scramble=False)
    top_rows = float((r >= 128).float().mean())
    assert abs(top_rows - (0.4 / 3) * 2) < 0.02
    top_cols = float((c >= 128).float().mean())
    assert abs(top_cols - (0.4 / 3) * 2) < 0.02


def test_rmat_matrix_sorted_dedup():
    g = torch.Generator().manual_seed(3)
    a = trmat.rmat_matrix(g, 8, 8, probs=trmat.SSCA_PROBS)
    row, col, val, nnz, shape = a.to_numpy()
    assert shape == (256, 256)
    assert 0 < nnz <= 8 * 256
    key = row[:nnz].astype(np.int64) * 257 + col[:nnz]
    assert np.all(np.diff(key) > 0)
    assert float(val[:nnz].sum()) == 8 * 256
    assert np.all(row[nnz:] == 256) and np.all(col[nnz:] == 256)


@pytest.mark.parametrize("make", [
    lambda: tcoo.SpCOO.from_arrays([0, 1], [1, 0], [1.0, 2.0], (2, 2)),
    lambda: tcoo.SpCOO.from_dense(np.eye(3, dtype=np.float32)),
    lambda: tcoo.SpCOO.eye(4),
    lambda: tcoo.SpCOO.empty((3, 5)),
    lambda: tcoo.SpCOO.from_numpy(np.zeros(8, np.int32),
                                  np.zeros(8, np.int32),
                                  np.zeros(8, np.float32), 0, (1, 1)),
    lambda: __import__("combblas_tpu_torch.ops.spgemm_seg", fromlist=["_"])
    .seg_zero_state()[0],
], ids=["from_arrays", "from_dense", "eye", "empty", "from_numpy",
        "seg_zero_state"])
def test_constructors_default_to_the_card(make):
    """Without a device the constructors put their tensors on the card;
    with no card they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        out = make()
        dev = out.device if isinstance(out, torch.Tensor) else out.row.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
