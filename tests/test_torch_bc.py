"""The port's betweenness centrality (``models/bc.py``, local and on the
block grid) vs the JAX package's, on shared numpy inputs: a path, a star
and a seeded scale-7 R-MAT, every vertex or a sample of sources.

Tolerance: rtol 1e-5, atol 1e-6 (float32 path counts and dependencies
summed in other orders; the scores are float64 sums of them); against a
float64 run of the port itself, rtol 1e-5 and atol 0, so that the least
scores count.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.models import bc as jbc  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix  # noqa: E402
from combblas_tpu_torch.models import bc as tbc  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def path(n=9):
    d = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        d[i, i + 1] = d[i + 1, i] = 1.0
    return d


def star(n=11):
    d = np.zeros((n, n), np.float32)
    d[0, 1:] = d[1:, 0] = 1.0
    return d


def rmat7():
    """The seeded scale-7 SSCA R-MAT, symmetrized, no self loops, 0/1."""
    a = rmat_matrix(torch.Generator().manual_seed(7), 7, 8, symmetrize=True,
                    remove_self_loops=True, probs=SSCA_PROBS)
    return (a.to_dense().numpy() != 0).astype(np.float32)


GRAPHS = {"path": path, "star": star, "rmat7": rmat7}


def sources_for(name, n):
    """Every vertex, or for the R-MAT also a seeded sample of 40."""
    if name == "rmat7_sampled":
        return np.random.default_rng(3).choice(n, 40, replace=False)
    return None


CASES = ["path", "star", "rmat7", "rmat7_sampled"]


def _graph(case):
    return GRAPHS[case.replace("_sampled", "")]()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("normalize", [False, True])
def test_betweenness_centrality_matches_jax(case, normalize):
    d = _graph(case)
    src = sources_for(case, d.shape[0])
    want = jbc.betweenness_centrality(JCOO.from_dense(d), batch_size=32,
                                      sources=src, normalize=normalize)
    got = tbc.betweenness_centrality(TCOO.from_dense(d, device="cpu"),
                                     batch_size=32, sources=src,
                                     normalize=normalize)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if case == "path" and not normalize:
        n = d.shape[0]
        np.testing.assert_allclose(
            got, [2 * v * (n - 1 - v) for v in range(n)], rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_betweenness_centrality_dist_matches_jax(case, grid):
    """The distributed run against JAX's on the same grid and against the
    port's local run."""
    d = _graph(case)
    src = sources_for(case, d.shape[0])
    jm = jdist.DistSpMat.from_local(JCOO.from_dense(d), jgrid(*grid))
    tm = tdist.DistSpMat.from_local(TCOO.from_dense(d, device="cpu"),
                                    tgrid(*grid))
    want = jbc.betweenness_centrality_dist(jm, batch_size=32, sources=src)
    got = tbc.betweenness_centrality_dist(tm, batch_size=32, sources=src)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    local = tbc.betweenness_centrality(TCOO.from_dense(d, device="cpu"),
                                       batch_size=32, sources=src)
    np.testing.assert_allclose(got, local, rtol=RTOL, atol=ATOL)


def _bc64(run, monkeypatch):
    """``run`` with the fringes in float64 (the matrix's values are cast
    by the caller): the reference for the float32 scores."""
    first = tbc._first_fringe
    monkeypatch.setattr(tbc, "_first_fringe",
                        lambda *args: first(*args).double())
    return run()


@pytest.mark.parametrize("where", ["local", "dist"])
def test_betweenness_centrality_small_scores_keep_precision(where,
                                                            monkeypatch):
    """Float32 scores within rtol 1e-5 of a float64 run down to the least
    score (atol 0), on a scale-12 G500 R-MAT from 64 roots whose least
    score is about 4e-4: the dependencies are kept as delta, not 1 +
    delta, so a delta far below 1 keeps its own precision."""
    from card_inputs import bfs_roots, spmm_bfs_graphs

    s = spmm_bfs_graphs(1, "cpu", 12)["s"]
    s64 = TCOO(**{**{f: getattr(s, f) for f in s.__dataclass_fields__},
                  "val": s.val.double()})
    roots = bfs_roots(s, 1)[:64]

    def run(m):
        if where == "local":
            return tbc.betweenness_centrality(m, 32, roots)
        return tbc.betweenness_centrality_dist(
            tdist.DistSpMat.from_local(m, tgrid(2, 2)), 32, roots)

    got = run(s)
    want = _bc64(lambda: run(s64), monkeypatch)
    assert want[want > 0].min() < 1e-3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
