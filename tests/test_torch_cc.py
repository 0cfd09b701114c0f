"""The port's FastSV (``models/cc.py``, the local half) vs the JAX
package's on shared numpy graphs: labels exact."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.models import cc as jcc  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch.models import cc as tcc  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _ring(n):
    """``tests/test_apps.py``'s ring."""
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        d[i, (i + 1) % n] = 1.0
        d[(i + 1) % n, i] = 1.0
    return d


def _two_cliques(n):
    """``tests/test_apps.py``'s two cliques, no bridge."""
    d = np.zeros((n, n), np.float32)
    h = n // 2
    d[:h, :h] = 1.0
    d[h:, h:] = 1.0
    np.fill_diagonal(d, 0.0)
    return d


def _random_forest(seed, n=300, comps=40):
    """Many components: vertices shuffled into ``comps`` groups, each a
    random tree plus a few extra edges, some isolated vertices."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    groups = np.array_split(perm, comps)
    d = np.zeros((n, n), np.float32)
    for g in groups[:-1]:                # the last group stays isolated
        for i in range(1, len(g)):
            j = g[rng.integers(0, i)]
            d[g[i], j] = d[j, g[i]] = 1.0
        for _ in range(len(g) // 3):
            u, v = rng.choice(g, 2)
            if u != v:
                d[u, v] = d[v, u] = 1.0
    return d


GRAPHS = {
    "two_cliques_16": lambda: _two_cliques(16),
    "two_cliques_20": lambda: _two_cliques(20),
    "ring_17": lambda: _ring(17),
    "ring_12": lambda: _ring(12),
    "forest_0": lambda: _random_forest(0),
    "forest_1": lambda: _random_forest(1),
    "forest_long_paths": lambda: _random_forest(2, n=400, comps=5),
}


def _labels(d):
    r, c = np.nonzero(d)
    ja = JCOO.from_arrays(r, c, d[r, c], d.shape)
    ta = TCOO.from_numpy(np.asarray(ja.row), np.asarray(ja.col),
                         np.asarray(ja.val), int(ja.nnz), ja.shape,
                         device="cpu")
    return tcc.fastsv_local(ta), np.asarray(jcc.fastsv_local(ja))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fastsv_local_matches_jax(name):
    d = GRAPHS[name]()
    got, want = _labels(d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tcc.count_components(got) == jcc.count_components(want)


def test_fastsv_labels_are_component_minima():
    """Against scipy: each vertex's label is its component's least id."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    d = _random_forest(3)
    got, _ = _labels(d)
    _, comp = connected_components(csr_matrix(d), directed=False)
    least = np.full(comp.max() + 1, d.shape[0])
    np.minimum.at(least, comp, np.arange(d.shape[0]))
    np.testing.assert_array_equal(got.numpy(), least[comp])
    assert tcc.count_components(got, n=10) == len(np.unique(least[comp][:10]))
