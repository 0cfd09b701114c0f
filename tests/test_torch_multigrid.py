"""The port's MIS-2, restriction and Galerkin products
(``models/multigrid.py``) vs the JAX package's, on shared numpy graphs,
locally and on 1x1, 2x2, 2x4 and 4x2 grids.

JAX draws its priorities from a key, which torch cannot reproduce (trait
6): the exact comparisons replace the port's draw (``_priorities``) with
JAX's own draws, split from the key as JAX splits it.  Then the MIS-2 sets
and R are exact, entry for entry (R's host attachment walks the edges in
stored order, as JAX's does).  Galerkin keys are exact and values within
rtol 1e-6 (on the grid JAX takes its "xla" route on the CPU, the port its
kernel route's plain version: trait 3).  With the port's own generator the
sets are held on their invariants: independent and maximal at distance 2,
every fine vertex in one aggregate within two hops of it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.models import multigrid as jmg  # noqa: E402
from combblas_tpu.parallel.dist import DistSpMat as JDist  # noqa: E402
from combblas_tpu_torch.models import multigrid as tmg  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel.dist import DistSpMat as TDist  # noqa: E402
from tests.test_torch_dist import assert_same_blocks, dist_pair  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2)]


def sym_graph(n, edges, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for _ in range(edges):
        i, j = rng.integers(0, n, 2)
        if i != j:
            d[i, j] = d[j, i] = 1.0
    return d


def stencil2d(k):
    """The k x k 5-point stencil: 4 on the diagonal, -1 off it."""
    n = k * k
    d = np.zeros((n, n), np.float32)
    for v in range(n):
        d[v, v] = 4.0
        i, j = divmod(v, k)
        for di, dj in ((0, 1), (1, 0), (0, -1), (-1, 0)):
            if 0 <= i + di < k and 0 <= j + dj < k:
                d[v, (i + di) * k + j + dj] = -1.0
    return d


GRAPHS = [("sparse", sym_graph(40, 45, 1)), ("dense", sym_graph(30, 90, 2)),
          ("stencil", stencil2d(6))]
IDS = [g[0] for g in GRAPHS]


def jax_draws(seed: int):
    """The port's priority draw replaced by JAX's: each call splits the
    key as JAX's MIS-2 round does and draws uniform + 1 on the live
    vertices (``live`` covering [lo, lo + len(live)) of the ``n``)."""
    key = jax.random.PRNGKey(seed)

    def draw(n, live, _generator, lo=0):
        nonlocal key
        key, sub = jax.random.split(key)
        pri = torch.from_numpy(np.array(
            jax.random.uniform(sub, (n,)) + 1.0))[lo:lo + live.shape[0]]
        return torch.where(live, pri.to(live.device), 0.0)

    return draw


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def r_triples(r):
    """R's live (row, col, val), host."""
    if isinstance(r, TCOO):
        row, col, val, nnz, _ = r.to_numpy()
    else:
        row, col, val, nnz = (np.asarray(r.row), np.asarray(r.col),
                              np.asarray(r.val), int(r.nnz))
    return row[:nnz], col[:nnz], val[:nnz]


def check_mis2(d, s):
    """Independent and maximal at distance 2 (the pattern off the
    diagonal)."""
    adj = (d != 0) & ~np.eye(d.shape[0], dtype=bool)
    reach2 = adj | ((adj.astype(np.int32) @ adj.astype(np.int32)) > 0)
    np.fill_diagonal(reach2, False)
    sel = np.nonzero(s)[0]
    assert not reach2[np.ix_(sel, sel)].any()
    assert (s | reach2[:, sel].any(axis=1)).all()


def check_r(d, r_dense, hops=2):
    """One aggregate per fine vertex; each coarse vertex in its own; every
    fine vertex within ``hops`` of its aggregate's coarse vertex."""
    np.testing.assert_array_equal(r_dense.sum(axis=0), np.ones(d.shape[0]))
    adj = ((d != 0) | np.eye(d.shape[0], dtype=bool)).astype(np.int32)
    reach = np.linalg.matrix_power(adj, hops) > 0
    agg = r_dense.argmax(axis=0)
    for c in range(r_dense.shape[0]):
        members = np.nonzero(agg == c)[0]
        assert any(reach[v, members].all() for v in members), c


@pytest.mark.parametrize("name,d", GRAPHS, ids=IDS)
def test_mis2_matches_jax_draws(monkeypatch, name, d):
    monkeypatch.setattr(tmg, "_priorities", jax_draws(3))
    got = tmg.mis2(TCOO.from_dense(d, device="cpu"), None)
    want = np.asarray(jmg.mis2(JCOO.from_dense(d), jax.random.PRNGKey(3)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,d", GRAPHS, ids=IDS)
def test_restriction_op_matches_jax_draws(monkeypatch, name, d):
    monkeypatch.setattr(tmg, "_priorities", jax_draws(5))
    got = tmg.restriction_op(TCOO.from_dense(d, device="cpu"), None)
    want = jmg.restriction_op(JCOO.from_dense(d), jax.random.PRNGKey(5))
    assert got.shape == want.shape
    for x, y in zip(r_triples(got), r_triples(want)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,d", GRAPHS, ids=IDS)
def test_galerkin_matches_jax(name, d):
    """R·A·Rᵀ of one shared R (the port's own draw)."""
    a = TCOO.from_dense(d, device="cpu")
    r = tmg.restriction_op(a, gen(1))
    row, col, val = r_triples(r)
    jr = JCOO.from_arrays(row, col, val, r.shape)
    got = tmg.galerkin(r, a)
    want = jmg.galerkin(jr, JCOO.from_dense(d))
    g_r, g_c, g_v = r_triples(got)
    w_r, w_c, w_v = r_triples(want)
    np.testing.assert_array_equal(g_r, w_r)
    np.testing.assert_array_equal(g_c, w_c)
    np.testing.assert_allclose(g_v, w_v, rtol=1e-6, atol=0)
    rd = r.to_dense().numpy()
    np.testing.assert_allclose(got.to_dense().numpy(), rd @ d @ rd.T,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,d", GRAPHS, ids=IDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mis2_and_r_invariants(name, d, seed):
    a = TCOO.from_dense(d, device="cpu")
    check_mis2(d, tmg.mis2(a, gen(seed)).numpy())
    r = tmg.restriction_op(a, gen(seed))
    # a sweep of the host walk can carry an attachment past two hops
    # (JAX's rule); three bounds it on these graphs
    check_r(d, r.to_dense().numpy(), hops=3)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name,d", GRAPHS[:2], ids=IDS[:2])
def test_mis2_dist_matches_jax_draws(monkeypatch, grid, name, d):
    monkeypatch.setattr(tmg, "_priorities", jax_draws(7))
    j, t = dist_pair(d, *grid)
    got = tmg.mis2_dist(t, None)
    want = jmg.mis2_dist(j, jax.random.PRNGKey(7))
    np.testing.assert_array_equal(got, want)
    assert tmg.mis2_verify_dist(t, got) and jmg.mis2_verify_dist(j, want)


@pytest.mark.parametrize("grid", GRIDS)
def test_mis2_verify_dist_matches_jax(grid):
    """The check on a valid set, one with two set vertices two hops apart,
    and one missing a vertex's whole neighbourhood."""
    d = sym_graph(40, 45, 1)
    j, t = dist_pair(d, *grid)
    s = tmg.mis2_dist(t, gen(4))
    bad_near = s.copy()
    path2 = (d @ d > 0) & ~s[:, None] & ~s[None, :]
    np.fill_diagonal(path2, False)
    u, v = np.argwhere(path2)[0]
    bad_near[[u, v]] = True
    bad_far = np.zeros_like(s)
    for x in (s, bad_near, bad_far):
        assert tmg.mis2_verify_dist(t, x) == jmg.mis2_verify_dist(j, x)
    assert tmg.mis2_verify_dist(t, s)
    assert not tmg.mis2_verify_dist(t, bad_far)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name,d", GRAPHS, ids=IDS)
def test_restriction_op_dist_matches_jax_draws(monkeypatch, grid, name, d):
    monkeypatch.setattr(tmg, "_priorities", jax_draws(9))
    j, t = dist_pair(d, *grid)
    got = tmg.restriction_op_dist(t, None)
    want = jmg.restriction_op_dist(j, jax.random.PRNGKey(9))
    assert got.gshape == want.gshape
    assert_same_blocks(got, want, exact=True)
    check_r(d, got.to_dense(), hops=2)


@pytest.mark.parametrize("pr", [1, 2])
@pytest.mark.parametrize("name,d", GRAPHS, ids=IDS)
def test_galerkin_dist_matches_jax(pr, name, d):
    """R·A·Rᵀ on the grid, of one shared R, against JAX's (live entries:
    the two routes size their blocks apart) and the local product."""
    j, t = dist_pair(d, pr, pr)
    r = tmg.restriction_op_dist(t, gen(2))
    rl = r.to_local()
    row, col, val = r_triples(rl)
    jr = JDist.from_local(JCOO.from_arrays(row, col, val, r.gshape),
                          jgrid(pr, pr))
    got = tmg.galerkin_dist(r, t).to_local()
    want = jmg.galerkin_dist(jr, j).to_local()
    g_r, g_c, g_v = r_triples(got)
    w_r, w_c, w_v = r_triples(want)
    np.testing.assert_array_equal(g_r, w_r)
    np.testing.assert_array_equal(g_c, w_c)
    np.testing.assert_allclose(g_v, w_v, rtol=1e-6, atol=0)
    loc = tmg.galerkin(rl, TCOO.from_dense(d, device="cpu"))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  loc.to_dense().numpy())


def test_restriction_op_dist_on_grid_of_r():
    """R lies on A's grid with the (ncoarse, n) shape."""
    d = stencil2d(5)
    t = TDist.from_local(TCOO.from_dense(d, device="cpu"), tgrid(2, 2))
    r = tmg.restriction_op_dist(t, gen(0))
    assert r.grid == t.grid and r.gshape[1] == 25
    assert int(r.total_nnz()) == 25
