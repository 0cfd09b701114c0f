"""The port's bipartite matchings (``models/matching.py``) vs the JAX
package's, on shared numpy bipartite graphs.

Tolerances: every mate vector exact (maximal, maximum with and without
``init=``, AWPM with and without completion: the functions use only
integer minima and float maxima and compares), and so are the helpers'
outputs (one propose/accept round, one alternating BFS, one dominant
round) and the host checks.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.models import matching as jm  # noqa: E402
from combblas_tpu_torch.models import matching as tm  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402

#: (m, n, density, seed): square, wide, tall, sparse with empty rows.
GRAPHS = [(24, 24, 0.12, 1), (20, 31, 0.15, 2), (37, 14, 0.2, 3),
          (40, 40, 0.04, 4)]


def bipartite(m, n, density, seed, ties=False):
    """A random (m, n) weight matrix; ``ties`` draws weights from four
    values so that dominant rounds break ties."""
    rng = np.random.default_rng(seed)
    w = (rng.integers(1, 5, (m, n)).astype(np.float32) if ties
         else rng.uniform(0.05, 1.0, (m, n)).astype(np.float32))
    w[rng.random((m, n)) > density] = 0.0
    return w


def pair(d):
    return JCOO.from_dense(d), TCOO.from_dense(d, device="cpu")


def same(t, j):
    jx, tx = np.asarray(j), t.cpu().numpy()
    assert tx.dtype == jx.dtype and tx.shape == jx.shape
    np.testing.assert_array_equal(tx, jx)


def same_mates(t, j):
    same(t[0], j[0])
    same(t[1], j[1])


@pytest.mark.parametrize("g", GRAPHS)
def test_bp_maximal_matching_matches_jax(g):
    d = bipartite(*g)
    ja, ta = pair(d)
    got = tm.bp_maximal_matching(ta)
    same_mates(got, jm.bp_maximal_matching(ja))
    mr, mc = (x.numpy() for x in got)
    assert tm.is_valid_matching(d, mr, mc)
    for r, c in zip(*np.nonzero(d)):     # maximal
        assert mr[r] >= 0 or mc[c] >= 0


@pytest.mark.parametrize("g", GRAPHS)
def test_bp_maximum_matching_matches_jax(g):
    d = bipartite(*g)
    ja, ta = pair(d)
    got = tm.bp_maximum_matching(ta)
    same_mates(got, jm.bp_maximum_matching(ja))
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    want = maximum_bipartite_matching(csr_matrix(d), perm_type="column")
    assert int((got[0] >= 0).sum()) == int((want >= 0).sum())


@pytest.mark.parametrize("g", GRAPHS[:3])
def test_bp_maximum_matching_init_matches_jax(g):
    """A caller's init: the rows of one half matched greedily by hand."""
    d = bipartite(*g)
    m, n = d.shape
    mr = np.full(m, -1, np.int32)
    mc = np.full(n, -1, np.int32)
    for r in range(m // 2):
        for c in np.nonzero(d[r])[0]:
            if mc[c] < 0:
                mr[r], mc[c] = c, r
                break
    ja, ta = pair(d)
    got = tm.bp_maximum_matching(ta, init=(torch.from_numpy(mr),
                                           torch.from_numpy(mc)))
    same_mates(got, jm.bp_maximum_matching(
        ja, init=(jnp.asarray(mr), jnp.asarray(mc))))


@pytest.mark.parametrize("g", GRAPHS)
@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_awpm_matches_jax(g, complete, ties):
    d = bipartite(*g, ties=ties)
    ja, ta = pair(d)
    got = tm.awpm(ta, complete=complete)
    same_mates(got, jm.awpm(ja, complete=complete))
    assert tm.matching_weight(d, got[0]) == jm.matching_weight(
        d, np.asarray(got[0].numpy()))


@pytest.mark.parametrize("g", GRAPHS[:2])
def test_round_helpers_match_jax(g):
    """One propose/accept round, one dominant round and one alternating
    BFS from a half-built matching, each equal to JAX's."""
    d = bipartite(*g)
    m, n = d.shape
    ja, ta = pair(d)
    live = tm._live(ta)
    mr = -torch.ones(m, dtype=torch.int32)
    mc = -torch.ones(n, dtype=torch.int32)
    jr, jc = -jnp.ones(m, jnp.int32), -jnp.ones(n, jnp.int32)
    for step in range(2):
        t = tm._propose_accept(ta, live, mr, mc)
        j = jm._propose_accept(ja, jr, jc)
        same_mates(t[:2], j[:2])
        assert t[2] == bool(j[2])
        tw = tm._dominant_round(ta, live, mr, mc)
        jw = jm._dominant_round(ja, jr, jc)
        same_mates(tw[:2], jw[:2])
        mr, mc = t[0], t[1]
        jr, jc = j[0], j[1]
    tp, tf = tm._alt_bfs(ta, live, mr, mc)
    jp, jf = jm._alt_bfs(ja, jr, jc)
    same(tp, jp)
    same(tf, jf)


def test_host_checks_match_jax():
    d = bipartite(12, 12, 0.3, 9)
    ja, ta = pair(d)
    mr, mc = tm.bp_maximum_matching(ta)
    assert tm.is_valid_matching(d, mr, mc) == jm.is_valid_matching(
        d, mr.numpy(), mc.numpy())
    bad = mr.clone()
    r = int(torch.nonzero(bad >= 0)[0])
    bad[r] = int(torch.nonzero(torch.from_numpy(d[r]) == 0)[0])
    assert not tm.is_valid_matching(d, bad, mc)
    assert not jm.is_valid_matching(d, bad.numpy(), mc.numpy())
    assert tm.matching_weight(torch.from_numpy(d), mr) == \
        jm.matching_weight(d, mr.numpy())


def test_empty_graph():
    d = np.zeros((5, 7), np.float32)
    ja, ta = pair(d)
    for t, j in ((tm.bp_maximal_matching(ta), jm.bp_maximal_matching(ja)),
                 (tm.bp_maximum_matching(ta), jm.bp_maximum_matching(ja)),
                 (tm.awpm(ta), jm.awpm(ja))):
        same_mates(t, j)
