"""Port BFS (``models/bfs.py``) vs ``combblas_tpu/models/bfs.py`` on the same
symmetrized R-MAT graph and roots (JAX kernels in interpret mode).

Levels are exact everywhere, and so are parents: every route picks its
parent by the JAX rule (the max frontier id, order-free; or the first CSR
edge one level up).  Every tree also validates Graph500-style with the
port's ``validate_bfs``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.gen.rmat import rmat_matrix  # noqa: E402
from combblas_tpu.models import bfs as jbfs  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.pallas.spmm_ell_blocked import (  # noqa: E402
    ell_blocked_prepare as jell_blocked_prepare,
)
from combblas_tpu_torch.models import bfs as tbfs  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.spmm_ell_blocked import (  # noqa: E402
    ell_blocked_prepare,
)

ROOTS = [3, 17, 101, 250]


@pytest.fixture(scope="module")
def graph():
    ja = rmat_matrix(jax.random.PRNGKey(9), scale=9, edgefactor=8,
                     symmetrize=True, remove_self_loops=True)
    ta = TCOO.from_numpy(np.asarray(ja.row), np.asarray(ja.col),
                         np.asarray(ja.val), int(ja.nnz), ja.shape,
                         device="cpu")
    return ja, ta


def _levels_hold(ta, root, p, lv, jl):
    np.testing.assert_array_equal(np.asarray(lv), np.asarray(jl))
    assert tbfs.validate_bfs(ta, root, p, lv)


@pytest.mark.parametrize("root", ROOTS)
def test_bfs_local_matches_jax(graph, root):
    ja, ta = graph
    jp, jl = jbfs.bfs_local(ja, root)
    p, lv = tbfs.bfs_local(ta, root)
    assert p.dtype == lv.dtype == torch.int32
    _levels_hold(ta, root, p, lv, jl)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("root", ROOTS)
def test_bfs_dir_opt_local_matches_jax(graph, root):
    ja, ta = graph
    jp, jl = jbfs.bfs_dir_opt_local(ja, root)
    p, lv = tbfs.bfs_dir_opt_local(ta, root)
    _levels_hold(ta, root, p, lv, jl)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("root", ROOTS[:2])
def test_bfs_push_local_matches_jax(graph, root):
    ja, ta = graph
    jp, jl = jbfs.bfs_push_local(ja, root, interpret=True)
    before = dict(LAUNCHES)
    p, lv = tbfs.bfs_push_local(ta, root)
    assert LAUNCHES == before  # CPU tensors never count as kernel launches
    _levels_hold(ta, root, p, lv, jl)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_bfs_push_local_path_graph():
    """A path graph smaller than any TPU-era frontier cap."""
    n = 12
    d = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        d[i, i + 1] = d[i + 1, i] = 1.0
    ja = JCOO.from_dense(d)
    ta = TCOO.from_numpy(np.asarray(ja.row), np.asarray(ja.col),
                         np.asarray(ja.val), int(ja.nnz), ja.shape,
                         device="cpu")
    p, lv = tbfs.bfs_push_local(ta, 0)
    np.testing.assert_array_equal(lv.numpy(), np.arange(n))
    np.testing.assert_array_equal(p.numpy(), np.maximum(np.arange(n) - 1, 0))
    assert tbfs.validate_bfs(ta, 0, p, lv)


def test_bfs_batch_pull_matches_jax(graph):
    ja, ta = graph
    jp, jl = jbfs.bfs_batch_pull(ja, ROOTS)
    p, lv = tbfs.bfs_batch_pull(ta, ROOTS)
    assert p.shape == lv.shape == (len(ROOTS), ta.shape[0])
    for i, r in enumerate(ROOTS):
        _levels_hold(ta, r, p[i], lv[i], np.asarray(jl)[i])
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("nb", [1, 3])
def test_bfs_batch_pull_big_matches_jax(graph, nb):
    ja, ta = graph
    jp, jl = jbfs.bfs_batch_pull_big(ja, ROOTS, nb=nb, interpret=True)
    prep = ell_blocked_prepare(ta, nb, relabel_cols=True, binary=True)
    p, lv = tbfs.bfs_batch_pull_big(ta, ROOTS, prep=prep)
    assert p.dtype == lv.dtype == torch.int32
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    for i, r in enumerate(ROOTS):
        assert tbfs.validate_bfs(ta, r, p[i], lv[i])
    # the plan it swept is JAX's
    jprep = jell_blocked_prepare(ja, nb, relabel_cols=True, binary=True)
    np.testing.assert_array_equal(prep["cols"].numpy(),
                                  np.asarray(jprep["cols"]))


def test_bfs_batch_pull_big_default_plan_matches_bfs_local(graph):
    ja, ta = graph
    p, lv = tbfs.bfs_batch_pull_big(ta, ROOTS[1:3])
    for i, r in enumerate(ROOTS[1:3]):
        _, jl = jbfs.bfs_local(ja, r)
        _levels_hold(ta, r, p[i], lv[i], jl)


def test_validate_bfs_rejects_bad_trees(graph):
    _, ta = graph
    p, lv = tbfs.bfs_local(ta, 3)
    assert tbfs.validate_bfs(ta, 3, p.numpy(), lv.numpy())
    v = int(torch.nonzero(lv == 2)[0])
    bad = p.clone()
    bad[v] = int(torch.nonzero(lv == 0)[0])  # the root: no edge at level 2
    assert not tbfs.validate_bfs(ta, 3, bad, lv)
    bad_lv = lv.clone()
    bad_lv[v] = 3
    assert not tbfs.validate_bfs(ta, 3, p, bad_lv)
    bad_root = p.clone()
    bad_root[3] = v
    assert not tbfs.validate_bfs(ta, 3, bad_root, lv)


def test_bfs_rejects_large_n_and_too_many_roots(graph):
    big = TCOO.from_numpy(np.full(8, 1 << 24, np.int32),
                          np.full(8, 1 << 24, np.int32),
                          np.zeros(8, np.float32), 0, (1 << 24, 1 << 24),
                          device="cpu")
    with pytest.raises(ValueError):
        tbfs.bfs_push_prepare(big)
    with pytest.raises(ValueError):
        tbfs.bfs_batch_pull_big(big, [0])
    with pytest.raises(ValueError):
        tbfs.bfs_batch_pull_big(graph[1], np.arange(129))
