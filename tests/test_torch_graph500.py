"""The inputs of the card runs (``card_inputs.py``) at a small scale on
the CPU: the same seed gives the same graphs, frontier and roots; the BFS
graph is symmetric and loop-free; every root has an edge; every grid
product of A² equals the single-device product."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from card_inputs import (  # noqa: E402
    a2_matrix,
    bfs_frontier,
    bfs_roots,
    grid_cells,
    spmm_bfs_graphs,
)
from combblas_tpu_torch.ops.spgemm import spgemm_auto  # noqa: E402

CPU = torch.device("cpu")
SCALE = 8


def _dense(a):
    nnz = int(a.nnz)
    d = np.zeros(a.shape, np.float32)
    np.add.at(d, (a.row[:nnz].numpy(), a.col[:nnz].numpy()),
              a.val[:nnz].numpy())
    return d


@pytest.mark.parametrize("seed", [0, 42])
def test_spmm_bfs_graphs(seed):
    g = spmm_bfs_graphs(seed, CPU, SCALE)
    again = spmm_bfs_graphs(seed, CPU, SCALE)
    n = 1 << SCALE
    assert g["a"].shape == g["s"].shape == (n, n)
    for k in ("x", "x8"):
        assert torch.equal(g[k], again[k])
        assert g[k].dtype == torch.float32
        assert bool(((g[k] >= 0) & (g[k] < 1)).all())
    assert g["x"].shape == (n, 128) and g["x8"].shape == (n, 8)
    a, s = _dense(g["a"]), _dense(g["s"])
    np.testing.assert_array_equal(a, _dense(again["a"]))
    np.testing.assert_array_equal(s, _dense(again["s"]))
    # Graph500 edge factor 16 before duplicates are summed
    assert a.sum() == 16 * n
    np.testing.assert_array_equal(s, s.T)
    assert not np.diag(s).any()
    assert not np.array_equal(a != 0, s != 0)   # the next draw, not A's


@pytest.mark.parametrize("d", [8, 128])
def test_bfs_frontier(d):
    n, n_pad = 1000, 1152
    f = bfs_frontier(n_pad, n, CPU, d)
    assert f.shape == (n_pad, d) and f.dtype == torch.float32
    assert torch.equal(f, bfs_frontier(n_pad, n, CPU, d))
    hit = f != 0
    assert torch.equal(f[hit], f[hit].round())
    assert float(f.min()) == 0 and float(f.max()) <= n
    assert bool((f[hit] >= 1).all())
    assert 0.08 < float(hit.float().mean()) < 0.12


@pytest.mark.parametrize("k", [1, 64, 1 << 20])
def test_bfs_roots(k):
    s = spmm_bfs_graphs(3, CPU, SCALE)["s"]
    deg = _dense(s).astype(bool).sum(1)
    roots = bfs_roots(s, 3, k)
    assert len(roots) == min(k, int((deg > 0).sum()))
    assert len(set(roots.tolist())) == len(roots)
    assert (deg[roots] > 0).all()
    np.testing.assert_array_equal(roots, bfs_roots(s, 3, k))


def test_a2_matrix():
    """The A² runs' matrix: G500 ef 16 from its own seed, summed duplicate
    counts as values, the same draw as the SpMM graph of that seed."""
    a = a2_matrix(42, CPU, SCALE)
    d = _dense(a)
    np.testing.assert_array_equal(d, _dense(a2_matrix(42, CPU, SCALE)))
    assert d.sum() == 16 * (1 << SCALE)
    assert np.array_equal(d, d.round()) and d.max() > 1
    np.testing.assert_array_equal(d, _dense(spmm_bfs_graphs(42, CPU,
                                                            SCALE)["a"]))


def test_grid_cells_equal_the_single_device_product():
    """The grid products that ``chip_smoke.py`` phases 13-14 time, on a
    small A² on the CPU: each equals the single-device ``spgemm_auto``
    product."""
    a = a2_matrix(3, CPU, SCALE)
    want = spgemm_auto(a, a)
    nnz = int(want.nnz)
    cells = grid_cells(a, CPU)
    assert [label for label, _call, _info in cells] == [
        "summa_spgemm_auto 2x2", "summa_spgemm_auto 4x4",
        "summa_spgemm_staged 4x4", "summa_spgemm_rma 4x4",
        "summa3d_spgemm 2x2x2"]
    for label, call, info in cells:
        got = call().to_local()
        assert int(got.nnz) == nnz, label
        assert torch.equal(got.row[:nnz], want.row[:nnz]), label
        assert torch.equal(got.col[:nnz], want.col[:nnz]), label
        assert torch.equal(got.val[:nnz], want.val[:nnz]), label
        assert info["impl"] in ("xla", "pallas", "wide")
