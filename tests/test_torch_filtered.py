"""The port's filtered traversals (``models/filtered.py``) and semantic
graphs (``models/semantic.py``) vs the JAX package's, on shared numpy
graphs, locally and on 1x1, 2x2, 2x4 and 4x2 grids.

Tolerances: the materialized subgraphs (pads included) and block stacks,
filtered BFS parents and levels (padded lengths on the grid), the packed
codes, their decoding (absent codes too) and every predicate exact.  The
filtered MIS draws from a ``torch.Generator`` (trait 6) and is held on its
invariants against the filtered edge list: no passing edge inside the set,
every other vertex with a passing edge into it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.models import filtered as jf  # noqa: E402
from combblas_tpu.models import semantic as js  # noqa: E402
from combblas_tpu_torch.models import bfs as tbfs  # noqa: E402
from combblas_tpu_torch.models import filtered as tf  # noqa: E402
from combblas_tpu_torch.models import semantic as ts  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from tests.test_torch_dist import assert_same_blocks, dist_pair  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 2)]


def weighted_graph(n, edges, seed):
    """A symmetric loop-free graph, weights 1 or 2."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for _ in range(edges):
        i, j = rng.integers(0, n, 2)
        if i != j:
            d[i, j] = d[j, i] = rng.choice([1.0, 2.0])
    return d


def heavy(v):
    return v > 1.5


def same(t, j):
    jx, tx = np.asarray(j), t.cpu().numpy()
    assert tx.dtype == jx.dtype and tx.shape == jx.shape
    np.testing.assert_array_equal(tx, jx)


def same_coo(t, j):
    """Slot for slot, pads included; the port's nnz is int64."""
    for f in ("row", "col", "val"):
        same(getattr(t, f), getattr(j, f))
    assert int(t.nnz) == int(j.nnz) and t.shape == j.shape


def check_filtered_mis(d, keep, s):
    adj = (d != 0) & keep(d)
    sel = np.asarray(s, bool)[: d.shape[0]]
    assert not adj[np.ix_(sel, sel)].any()
    assert (sel | adj[:, sel].any(axis=1)).all()


D = weighted_graph(45, 70, 3)


def test_materialize_filtered_matches_jax():
    same_coo(tf.materialize_filtered(TCOO.from_dense(D, device="cpu"),
                                     heavy),
             jf.materialize_filtered(JCOO.from_dense(D), heavy))


@pytest.mark.parametrize("root", [0, 7, 30])
def test_bfs_filtered_matches_jax(root):
    ta = TCOO.from_dense(D, device="cpu")
    p, lv = tf.bfs_filtered(ta, root, heavy)
    jp, jl = jf.bfs_filtered(JCOO.from_dense(D), root, heavy)
    same(p, jp)
    same(lv, jl)
    p2, l2 = tbfs.bfs_local(tf.materialize_filtered(ta, heavy), root)
    assert torch.equal(l2, lv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mis_filtered_invariants(seed):
    ta = TCOO.from_dense(D, device="cpu")
    s = tf.mis_filtered(ta, torch.Generator().manual_seed(seed), heavy)
    check_filtered_mis(D, heavy, s.numpy())


@pytest.mark.parametrize("grid", GRIDS)
def test_materialize_filtered_dist_matches_jax(grid):
    j, t = dist_pair(D, *grid)
    assert_same_blocks(tf.materialize_filtered_dist(t, heavy),
                       jf.materialize_filtered_dist(j, heavy), exact=True)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("root", [0, 30])
def test_bfs_filtered_dist_matches_jax(grid, root):
    j, t = dist_pair(D, *grid)
    p, lv = tf.bfs_filtered_dist(t, root, heavy)
    jp, jl = jf.bfs_filtered_dist(j, root, heavy)
    same(p, jp)
    same(lv, jl)
    _, l_loc = tf.bfs_filtered(TCOO.from_dense(D, device="cpu"), root, heavy)
    assert torch.equal(lv[:45], l_loc)


@pytest.mark.parametrize("grid", GRIDS)
def test_mis_filtered_dist_invariants(grid):
    _, t = dist_pair(D, *grid)
    s = tf.mis_filtered_dist(t, torch.Generator().manual_seed(5), heavy)
    check_filtered_mis(D, heavy, s.numpy())


# -- semantic graphs -------------------------------------------------------

def twitter_edges(n, m, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return (src, dst, rng.random(m) < 0.5, rng.integers(0, 200, m),
            rng.integers(0, 1000, m))


def test_pack_unpack_twitter_match_jax():
    _, _, fol, cnt, lat = twitter_edges(50, 400, 1)
    codes = ts.pack_twitter(fol, cnt, lat)
    np.testing.assert_array_equal(codes, js.pack_twitter(fol, cnt, lat))
    codes = np.concatenate([codes, np.zeros(5, np.float32)])   # absent
    got = ts.unpack_twitter(torch.from_numpy(codes))
    want = js.unpack_twitter(jnp.asarray(codes))
    for g, w in zip(got, want):
        same(g, w)
    same(got[0][:-5], np.asarray(fol, bool))
    same(got[1][:-5], np.minimum(cnt, 127).astype(np.int32))
    same(got[2][:-5], lat.astype(np.int32))
    same(ts.is_follower(torch.from_numpy(codes)),
         js.is_follower(jnp.asarray(codes)))
    for tp, jp in ((ts.tweet_since(300), js.tweet_since(300)),
                   (ts.tweet_within_interval(200, 600),
                    js.tweet_within_interval(200, 600))):
        same(tp(torch.from_numpy(codes)), jp(jnp.asarray(codes)))
    with pytest.raises(ValueError):
        ts.pack_twitter([1], [1], [ts._TIME_LIM])


@pytest.mark.parametrize("root", [0, 3, 11])
def test_twitter_graph_matches_jax(root):
    e = twitter_edges(60, 500, 2)
    tg = ts.TwitterGraph.build(*e, 60, device="cpu")
    jg = js.TwitterGraph.build(*e, 60)
    same_coo(tg.mat, jg.mat)
    same_coo(tg.subgraph_within(200, 700), jg.subgraph_within(200, 700))
    for g, w in zip(tg.bfs_within(root, 200, 700),
                    jg.bfs_within(root, 200, 700)):
        same(g, w)


@pytest.mark.parametrize("grid", GRIDS)
def test_twitter_graph_dist_matches_jax(grid):
    e = twitter_edges(60, 500, 4)
    tg = ts.TwitterGraph.build(*e, 60, device="cpu")
    jg = js.TwitterGraph.build(*e, 60)
    got = tg.bfs_within_dist(tgrid(*grid), 5, 100, 800)
    want = jg.bfs_within_dist(jgrid(*grid), 5, 100, 800)
    for g, w in zip(got, want):
        same(g, w)
    tm = tg.distribute(tgrid(*grid))
    for g, w in zip(tg.bfs_within_dist(tm, 5, 100, 800), got):
        assert torch.equal(g, w)
