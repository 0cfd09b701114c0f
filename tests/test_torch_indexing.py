"""The port's ``ops/indexing.py`` vs the JAX package's on shared numpy
inputs.  The selector products (``spref``) take the port's kernel routes
(plain versions on the CPU) and JAX's sort route, so their capacities may
differ: they are compared on live entries, keys and values exact (unit
selectors, each output a single product).  The index-translation functions
are compared slot for slot."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.ops import indexing as jix  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch.ops import indexing as tix  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _live(a):
    nnz = int(a.nnz)
    return (np.asarray(a.row)[:nnz], np.asarray(a.col)[:nnz],
            np.asarray(a.val)[:nnz])


def _same_live(t, j):
    assert t.shape == tuple(j.shape) and int(t.nnz) == int(j.nnz)
    for x, y in zip(_live(t), _live(j)):
        np.testing.assert_array_equal(x, y)


def _same(t, j):
    assert t.capacity == j.capacity
    _same_live(t, j)
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
    np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))


def _matrix(seed, m=30, n=26, density=0.2, loops=True):
    rng = np.random.default_rng(seed)
    d = (rng.random((m, n)) < density) * (rng.random((m, n)) + 0.5)
    if loops:
        d[np.arange(0, min(m, n), 3), np.arange(0, min(m, n), 3)] = 2.0
    r, c = np.nonzero(d)
    return JCOO.from_arrays(r, c, d[r, c].astype(np.float32), (m, n),
                            capacity=r.size + 19), d


@pytest.mark.parametrize("transpose", [False, True])
def test_make_selector(transpose):
    ix = np.array([4, 0, 4, 9, 2])
    _same(tix.make_selector(ix, 12, transpose, device="cpu"),
          jix.make_selector(ix, 12, transpose))


@pytest.mark.parametrize("ri, ci", [
    ([2, 5, 7], [0, 3, 4, 11]),
    ([5, 2, 2, 9, 5], [3, 3, 0, 20, 7]),          # repeated indices
    (list(range(30)), list(range(25, -1, -1))),   # all rows, cols reversed
])
def test_spref(ri, ci):
    ja, d = _matrix(0)
    got = tix.spref(_port(ja), np.array(ri), np.array(ci))
    _same_live(got, jix.spref(ja, np.array(ri), np.array(ci)))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  d[np.ix_(ri, ci)].astype(np.float32))


@pytest.mark.parametrize("out_cap", [None, 12])
def test_spref_gather(out_cap):
    ja, _ = _matrix(1)
    ri = np.array([3, 1, 17, 8, 22, 0])
    ci = np.array([25, 2, 9, 4])
    kw = dict(out_rows=len(ri), out_cols=len(ci), out_capacity=out_cap)
    _same(tix.spref_gather(_port(ja), torch.from_numpy(ri),
                           torch.from_numpy(ci), **kw),
          jix.spref_gather(ja, jax.numpy.asarray(ri), jax.numpy.asarray(ci),
                           **kw))


@pytest.mark.parametrize("out_cap", [None, 40])
def test_prune_block(out_cap):
    ja, _ = _matrix(2)
    ri, ci = np.array([0, 4, 5, 11, 29]), np.array([1, 2, 3, 24])
    _same(tix.prune_block(_port(ja), ri, ci, out_capacity=out_cap),
          jix.prune_block(ja, ri, ci, out_capacity=out_cap))


def test_induced_subgraph():
    ja, _ = _matrix(3, m=40, n=40)
    v = np.random.default_rng(4).choice(40, 17, replace=False)
    _same(tix.induced_subgraph(_port(ja), v), jix.induced_subgraph(ja, v))


def test_remove_and_add_loops():
    ja, _ = _matrix(5, m=20, n=20)
    _same(tix.remove_loops(_port(ja)), jix.remove_loops(ja))
    _same(tix.add_loops(_port(ja), 7.0), jix.add_loops(ja, 7.0))
    _same(tix.add_loops(_port(ja), out_capacity=100),
          jix.add_loops(ja, out_capacity=100))


@pytest.mark.parametrize("k, rounds", [(2, None), (4, None), (4, 1),
                                       (6, None)])
def test_prune_ktips(k, rounds):
    """To the fixpoint (``rounds`` None) or one round.  A vertex's degree
    here counts its row and its column, so a leaf of this symmetric graph
    has degree 2."""
    rng = np.random.default_rng(6)
    n = 60
    d = np.triu((rng.random((n, n)) < 0.05) * 1.0, 1)
    d[np.arange(20), np.arange(1, 21)] = 1.0    # a path: tips peel off
    d = (d + d.T).astype(np.float32)
    r, c = np.nonzero(d)
    ja = JCOO.from_arrays(r, c, d[r, c], d.shape)
    got = tix.prune_ktips(_port(ja), k, rounds)
    _same(got, jix.prune_ktips(ja, k, rounds))
    assert int(got.nnz) < int(ja.nnz)


@pytest.mark.parametrize("out_cap", [None, 200])
def test_spasgn(out_cap):
    ja, _ = _matrix(7, m=15, n=15)
    jb, _ = _matrix(8, m=3, n=4, density=0.7, loops=False)
    ri, ci = np.array([1, 4, 6]), np.array([0, 2, 8, 14])
    _same(tix.spasgn(_port(ja), ri, ci, _port(jb), out_capacity=out_cap),
          jix.spasgn(ja, ri, ci, jb, out_capacity=out_cap))
