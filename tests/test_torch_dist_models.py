"""The port's graph algorithms on the block grid (``models/bfs.py``
``bfs_dist`` / ``bfs_dir_opt_dist``, ``models/cc.py`` ``fastsv_dist``,
``models/lacc.py``, ``models/mis.py``) vs the JAX package's, on shared numpy
graphs, on 1x1, 2x2 and 4x2 grids.

Tolerances: BFS parents and levels, FastSV and LACC labels exact, padded
lengths included.  Luby's MIS draws its priorities from a
``torch.Generator`` (JAX from a key, which torch cannot reproduce), so
``luby_mis`` and ``luby_mis_dist`` are held on invariants against the edge
list: no edge inside the set, every vertex outside it has a neighbour in
it, and an edge predicate drops exactly the edges it fails.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.models import bfs as jbfs  # noqa: E402
from combblas_tpu.models import cc as jcc  # noqa: E402
from combblas_tpu.models import lacc as jlacc  # noqa: E402
from combblas_tpu_torch.models import bfs as tbfs  # noqa: E402
from combblas_tpu_torch.models import cc as tcc  # noqa: E402
from combblas_tpu_torch.models import lacc as tlacc  # noqa: E402
from combblas_tpu_torch.models import mis as tmis  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from tests.test_torch_dist import dist_pair  # noqa: E402

GRIDS = [(1, 1), (2, 2), (4, 2)]


def sym_graph(n, deg, seed, comps=1):
    """A symmetric loop-free graph of ``comps`` disjoint random parts (and
    a few isolated vertices), values in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    parts = np.array_split(rng.permutation(n - 3), comps)
    for part in parts:
        for _ in range(deg * len(part) // 2):
            u, v = rng.choice(part, 2, replace=False)
            d[u, v] = d[v, u] = rng.uniform(0.5, 1.5)
    return d


def _same(t, j):
    jx, tx = np.asarray(j), t.cpu().numpy()
    assert tx.shape == jx.shape and tx.dtype == jx.dtype, (tx.shape,
                                                            jx.shape)
    np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("root", [0, 17, 44])
def test_bfs_dist_matches_jax(grid, root):
    d = sym_graph(47, 3, seed=30, comps=2)
    j, t = dist_pair(d, *grid)
    pj, lj = jbfs.bfs_dist(j, root)
    pt, lt = tbfs.bfs_dist(t, root)
    _same(pt, pj)
    _same(lt, lj)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("root", [0, 5])
@pytest.mark.parametrize("deg", [2, 12])
def test_bfs_dir_opt_dist_matches_jax(grid, root, deg):
    """Degree 12 makes a level's frontier pass n_pad / 8, so the pull step
    runs; parents and levels equal JAX's and ``bfs_dist``'s."""
    d = sym_graph(61, deg, seed=31)
    j, t = dist_pair(d, *grid)
    pj, lj = jbfs.bfs_dir_opt_dist(j, root)
    pt, lt = tbfs.bfs_dir_opt_dist(t, root)
    _same(pt, pj)
    _same(lt, lj)
    p2, l2 = tbfs.bfs_dist(t, root)
    assert torch.equal(l2, lt) and torch.equal(p2, pt)


def test_bfs_dist_needs_square_matrix():
    _, t = dist_pair(np.ones((6, 8), np.float32), 2, 2)
    with pytest.raises(ValueError, match="square"):
        tbfs.bfs_dist(t, 0)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("comps", [1, 4])
def test_fastsv_dist_matches_jax(grid, comps):
    d = sym_graph(53, 2, seed=32, comps=comps)
    j, t = dist_pair(d, *grid)
    got = tcc.fastsv_dist(t)
    _same(got, jcc.fastsv_dist(j))
    assert torch.equal(got[:53], tcc.fastsv_local(
        TCOO.from_dense(d, device="cpu")))


@pytest.mark.parametrize("comps", [1, 3, 6])
def test_lacc_local_matches_jax(comps):
    d = sym_graph(58, 2, seed=33, comps=comps)
    got = tlacc.lacc_local(TCOO.from_dense(d, device="cpu"))
    _same(got, jlacc.lacc_local(JCOO.from_dense(d)))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("comps", [1, 5])
def test_lacc_dist_matches_jax(grid, comps):
    d = sym_graph(49, 2, seed=34, comps=comps)
    j, t = dist_pair(d, *grid)
    got = tlacc.lacc_dist(t)
    _same(got, jlacc.lacc_dist(j))
    assert torch.equal(got[:49], tcc.fastsv_local(
        TCOO.from_dense(d, device="cpu")))


def _check_mis(d, in_set, pred=None):
    """No edge inside the set; every vertex outside it has a neighbour in
    it, over the edges that pass ``pred``."""
    adj = d != 0
    if pred is not None:
        adj &= pred(d)
    s = np.asarray(in_set, bool)
    assert not (adj & s[:, None] & s[None, :]).any(), "not independent"
    covered = s | (adj & s[None, :]).any(1)
    assert covered.all(), "not maximal"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_luby_mis_invariants(seed):
    d = sym_graph(70, 4, seed=35 + seed, comps=3)
    a = TCOO.from_dense(d, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    _check_mis(d, tmis.luby_mis(a, gen).numpy())


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("pred", [False, True])
def test_luby_mis_dist_invariants(grid, pred):
    """An independent, maximal set on the real vertices (padding never
    joins); with an edge predicate, over the edges that pass it."""
    d = sym_graph(45, 5, seed=38, comps=2)
    _, t = dist_pair(d, *grid)
    edge_pred = (lambda v: v > 1.0) if pred else None
    got = tmis.luby_mis_dist(t, torch.Generator().manual_seed(3),
                             edge_pred=edge_pred)
    assert got.shape == (tcc.col_vec_len(t.gshape, t.grid),)
    assert not got[45:].any()
    _check_mis(d, got[:45].numpy(),
               (lambda x: x > 1.0) if pred else None)
