"""The port's orderings (``models/ordering.py``: RCM and minimum degree,
local and distributed) vs the JAX package's, on shared numpy inputs.

Orders are integers: every comparison is exact.  ``rcm_order_dist`` runs
on 1x1, 2x2 and 4x2 grids (JAX's on the virtual CPU devices), and the
port's also against its own 1x1 run.  ``rcm_order`` and
``rcm_order_dist`` follow different parent rules (the BFS parent against
the earliest-labelled previous-level neighbour, ``RCM.cpp:361``), so each
is held against its own JAX twin, and both against the bandwidth they
should reach.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu import SpCOO as JCOO  # noqa: E402
from combblas_tpu.models import ordering as jord  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu_torch.models import ordering as tord  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402


def sym_banded(n, seed, extra=0.06):
    """A path plus random symmetric extras, vertex ids shuffled."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        d[i, i + 1] = d[i + 1, i] = 1.0
    mask = rng.random((n, n)) < extra
    d = np.maximum(d, np.maximum(mask, mask.T).astype(np.float32))
    np.fill_diagonal(d, 0.0)
    p = rng.permutation(n)
    return d[np.ix_(p, p)]


def disconnected(n=40):
    """A ring of 11, a path over the rest but one, an isolated vertex,
    ids shuffled."""
    d = np.zeros((n, n), np.float32)
    for i in range(10):
        d[i, (i + 1) % 11] = d[(i + 1) % 11, i] = 1.0
    for i in range(12, n - 2):
        d[i, i + 1] = d[i + 1, i] = 1.0
    p = np.random.default_rng(1).permutation(n)
    return d[np.ix_(p, p)]


def grid3d(k):
    """The 7-point stencil of a k^3 grid, with its diagonal."""
    idx = np.arange(k ** 3).reshape(k, k, k)
    r, c = [idx.ravel()], [idx.ravel()]
    for ax in range(3):
        lo = np.take(idx, np.arange(k - 1), axis=ax).ravel()
        hi = np.take(idx, np.arange(1, k), axis=ax).ravel()
        r += [lo, hi]
        c += [hi, lo]
    d = np.zeros((k ** 3, k ** 3), np.float32)
    d[np.concatenate(r), np.concatenate(c)] = 1.0
    p = np.random.default_rng(k).permutation(k ** 3)
    return d[np.ix_(p, p)]


GRAPHS = {"banded": lambda: sym_banded(40, 3),
          "disconnected": disconnected,
          "grid3d": lambda: grid3d(3)}


def bandwidth(d, order):
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    r, c = np.nonzero(d)
    return int(np.abs(pos[r] - pos[c]).max())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pseudo_peripheral_vertex_matches_jax(name):
    d = GRAPHS[name]()
    for start in (0, 7):
        got = tord.pseudo_peripheral_vertex(TCOO.from_dense(d, device="cpu"),
                                            start)
        assert got == jord.pseudo_peripheral_vertex(JCOO.from_dense(d),
                                                    start)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("start", [None, 5])
def test_rcm_order_matches_jax(name, start):
    d = GRAPHS[name]()
    got = tord.rcm_order(TCOO.from_dense(d, device="cpu"), start).numpy()
    want = np.asarray(jord.rcm_order(JCOO.from_dense(d), start))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(d.shape[0]))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (4, 2)])
def test_rcm_order_dist_matches_jax(name, grid):
    d = GRAPHS[name]()
    r, c = np.nonzero(d)
    jm = jdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape,
                                         jgrid(*grid))
    tm = tdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape,
                                         tgrid(*grid))
    got = tord.rcm_order_dist(tm)
    np.testing.assert_array_equal(got, jord.rcm_order_dist(jm))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
def test_rcm_order_dist_on_grids_equals_one_block(name, grid):
    """The port's distributed order does not depend on the grid; it is a
    permutation no wider than the input's bandwidth."""
    d = GRAPHS[name]()
    r, c = np.nonzero(d)
    one = tord.rcm_order_dist(tdist.DistSpMat.from_coo_arrays(
        r, c, d[r, c], d.shape, tgrid(1, 1)))
    got = tord.rcm_order_dist(tdist.DistSpMat.from_coo_arrays(
        r, c, d[r, c], d.shape, tgrid(*grid)))
    np.testing.assert_array_equal(got, one)
    np.testing.assert_array_equal(np.sort(got), np.arange(d.shape[0]))
    assert bandwidth(d, got) <= bandwidth(d, np.arange(d.shape[0]))


def md_graph(n=18, seed=9):
    d = rand_sparse(n, n, 0.18, seed=seed)
    d = ((d + d.T) > 0).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def test_md_order_matches_jax():
    for d in (md_graph(), md_graph(24, 4), disconnected()):
        got = tord.md_order(TCOO.from_dense(d, device="cpu")).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jord.md_order(JCOO.from_dense(d))))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("loops", [False, True])
def test_md_order_dist_matches_jax_and_md_order(grid, loops):
    """The distributed loop gives JAX's order and the local one; self
    loops do not count towards a degree."""
    d = md_graph()
    if loops:
        np.fill_diagonal(d, 1.0)
    jm = jdist.DistSpMat.from_local(JCOO.from_dense(d), jgrid(*grid))
    tm = tdist.DistSpMat.from_local(TCOO.from_dense(d, device="cpu"),
                                    tgrid(*grid))
    got = tord.md_order_dist(tm).numpy()
    np.testing.assert_array_equal(got, np.asarray(jord.md_order_dist(jm)))
    np.fill_diagonal(d, 0.0)
    np.testing.assert_array_equal(
        got, tord.md_order(TCOO.from_dense(d, device="cpu")).numpy())
