"""The port's distributed HipMCL (``models/mcl.py`` ``dist_mcl_prune`` /
``mcl_dist``) and phased SpGEMM (``parallel/memefficient.py``) vs the JAX
package's, on shared numpy inputs.

On CPU tensors the port's ``summa_impl_auto`` takes the kernel routes
(their plain versions) where JAX takes ``"xla"``, and their output
capacities differ, so ``mem_efficient_spgemm`` is compared with
``impl="xla"`` on both sides, and ``mcl_dist`` itself on its labels, its
iteration count and its final iterate compacted (``to_local``, pads
dropped).  Tolerances: block stacks, thresholds, labels, iteration counts
and the compacted iterate's keys exact; values exact where no sum is
involved, else rtol 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.models import mcl as jmcl  # noqa: E402
from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu.parallel import elementwise as jel  # noqa: E402
from combblas_tpu.parallel import memefficient as jme  # noqa: E402
from combblas_tpu.parallel import vector as jvec  # noqa: E402
from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix  # noqa: E402
from combblas_tpu_torch.models import mcl as tmcl  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from combblas_tpu_torch.parallel import memefficient as tme  # noqa: E402
from tests.test_apps import two_components  # noqa: E402
from tests.test_coo import rand_sparse  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    assert_same_blocks,
    dist_pair,
    jgrid,
    tgrid,
)

PRUNE_PARAMS = {
    "select": dict(select=6, recover_num=0, cutoff=0.01),
    "recover": dict(select=30, recover_num=12, cutoff=0.05,
                    recover_pct=0.9),
    "select_recover": dict(select=6, recover_num=9, cutoff=0.01,
                           recover_pct=0.9),
    "defaults": dict(),
}


def expansion(n=64, seed=40):
    """An expansion-like matrix: about half of each column filled,
    columns summing to about 1, values spread over two decades."""
    d = rand_sparse(n, n, 0.5, seed=seed)
    d = d ** 4
    return (d / np.maximum(d.sum(0), 1e-9)[None, :]).astype(np.float32)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("name", sorted(PRUNE_PARAMS))
@pytest.mark.parametrize("use_kselect2", [False, True])
def test_dist_mcl_prune_matches_jax(grid, name, use_kselect2):
    """The threshold prune on the same expansion: every block stack equal
    to JAX's slot for slot (it keeps the expansion's capacity)."""
    j, t = dist_pair(expansion(), *grid)
    jp = jmcl.MCLParams(**PRUNE_PARAMS[name])
    tp = tmcl.MCLParams(**PRUNE_PARAMS[name])
    got = tmcl.dist_mcl_prune(t, tp, use_kselect2=use_kselect2)
    want = jmcl.dist_mcl_prune(j, jp, use_kselect2=use_kselect2)
    assert got.capacity == t.capacity
    assert_same_blocks(got, want, exact=True)


def _hooks():
    p = dict(select=5, recover_num=7, cutoff=0.02)
    return (lambda c: jmcl.dist_mcl_prune(c, jmcl.MCLParams(**p)),
            lambda c: tmcl.dist_mcl_prune(c, tmcl.MCLParams(**p)))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("phases", [1, 2, 3])
@pytest.mark.parametrize("hook", [False, True])
def test_mem_efficient_spgemm_matches_jax(grid, phases, hook):
    """Phased SUMMA over B's column slabs, each slab's product through
    the hook (MCL's prune) before it is summed in: the same blocks as
    JAX's, both on the ``"xla"`` route."""
    d = expansion(48, seed=41)
    j, t = dist_pair(d, *grid)
    jh, th = _hooks() if hook else (None, None)
    want = jme.mem_efficient_spgemm(j, j, phases=phases, phase_hook=jh,
                                    impl="xla")
    got = tme.mem_efficient_spgemm(t, t, phases=phases, phase_hook=th,
                                   impl="xla")
    assert_same_blocks(got, want)
    if not hook:
        np.testing.assert_allclose(got.to_dense(), d @ d, rtol=1e-5,
                                   atol=1e-7)


def test_mem_efficient_spgemm_sized_by_sampling():
    """Without ``phases`` the count comes from the sampling estimate and
    the memory model; with a budget this large that is one phase, equal
    to ``phases=1``."""
    _, t = dist_pair(expansion(40, seed=42), 2, 2)
    got = tme.mem_efficient_spgemm(t, t, impl="xla")
    assert_same_blocks(got, tme.mem_efficient_spgemm(t, t, phases=1,
                                                     impl="xla"), )


@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
@pytest.mark.parametrize("bounds", [(0, 5, 10), (0, 3, 3, 9, 10)])
def test_slabs_match_jax(grid, bounds):
    """Slab counts per (phase, block) and the repacked column and row
    slabs, against JAX's, slot for slot."""
    j, t = dist_pair(rand_sparse(37, 39, 0.3, seed=43), *grid)
    jb = np.asarray(bounds, np.int32)
    np.testing.assert_array_equal(tme._col_slab_counts(t, bounds),
                                  np.asarray(jme._col_slab_counts(j, jb)))
    np.testing.assert_array_equal(tme._row_slab_counts(t, bounds),
                                  np.asarray(jme._row_slab_counts(j, jb)))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for cap in (None, 16):
            assert_same_blocks(tme._col_slab(t, lo, hi, cap),
                               jme._col_slab(j, lo, hi, cap), exact=True)
            assert_same_blocks(tme._row_slab(t, lo, hi, cap),
                               jme._row_slab(j, lo, hi, cap), exact=True)


def test_block_spgemm_matches_jax():
    """C block by block: each C_ij's live entries equal JAX's (their
    capacities differ: JAX takes ``"xla"`` on the CPU), and the blocks sum
    to A B."""
    d = rand_sparse(30, 30, 0.2, seed=44)
    j, t = dist_pair(d, 2, 2)
    total = np.zeros_like(d)
    pairs = zip(jme.block_spgemm(j, j, 2, 3), tme.block_spgemm(t, t, 2, 3))
    for (jij, jc), (tij, tc) in pairs:
        assert jij == tij
        jl, tl = jc.to_local(), tc.to_local()
        k = int(jl.nnz)
        assert int(tl.nnz) == k
        np.testing.assert_array_equal(tl.row[:k].numpy(),
                                      np.asarray(jl.row)[:k])
        np.testing.assert_array_equal(tl.col[:k].numpy(),
                                      np.asarray(jl.col)[:k])
        np.testing.assert_allclose(tl.val[:k].numpy(),
                                   np.asarray(jl.val)[:k], rtol=1e-5)
        total += tc.to_dense()
    np.testing.assert_allclose(total, d @ d, rtol=1e-5, atol=1e-7)


def _capture(monkeypatch, mod, name, store, key):
    """Wrap ``mod.name`` so that its first argument is kept in ``store``."""
    orig = getattr(mod, name)

    def run(x, *args, **kw):
        store[key] = x
        return orig(x, *args, **kw)

    monkeypatch.setattr(mod, name, run)


def rmat7(seed=1):
    """A seeded scale-7 SSCA R-MAT, symmetrized, uniform(0.5, 1.5)
    weights, with the self loops ``mcl_local`` would add."""
    g = torch.Generator().manual_seed(seed)
    a = rmat_matrix(g, 7, 8, symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    row, col, _val, nnz, shape = a.to_numpy()
    n = shape[0]
    w = np.random.default_rng(seed).uniform(0.5, 1.5, nnz).astype(np.float32)
    r = np.concatenate([row[:nnz], np.arange(n)])
    c = np.concatenate([col[:nnz], np.arange(n)])
    return r, c, np.concatenate([w, np.ones(n, np.float32)]), shape


def _run_both(monkeypatch, r, c, w, shape, grid, params, layers=1, **kw):
    """mcl_dist on both packages; (labels, iterations, final iterate)
    each.  ``layers > 1`` takes the 3D expansion on a (pr, pc, layers)
    grid of each package."""
    jm = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(*grid))
    tm = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(*grid))
    jkw, tkw = dict(kw), dict(kw)
    if layers > 1:
        jkw.update(layers=layers, grid3=jgrid(*grid, layers))
        tkw.update(layers=layers, grid3=tgrid(*grid, layers))
    seen = {}
    _capture(monkeypatch, jel, "dist_transpose", seen, "jax")
    _capture(monkeypatch, tmcl, "dist_transpose", seen, "port")
    lj, ij = jmcl.mcl_dist(jm, jmcl.MCLParams(**params), **jkw)
    lt, it = tmcl.mcl_dist(tm, tmcl.MCLParams(**params), **tkw)
    return (np.asarray(lj), ij, seen["jax"]), (lt, it, seen["port"])


def _same_iterate(t, j):
    jl, tl = j.to_local(), t.to_local()
    k = int(jl.nnz)
    assert int(tl.nnz) == k
    np.testing.assert_array_equal(tl.row[:k].numpy(), np.asarray(jl.row)[:k])
    np.testing.assert_array_equal(tl.col[:k].numpy(), np.asarray(jl.col)[:k])
    np.testing.assert_allclose(tl.val[:k].numpy(), np.asarray(jl.val)[:k],
                               rtol=1e-5, atol=0)


def test_mcl_dist_two_cliques_matches_jax(monkeypatch):
    d = two_components(12) + np.eye(12, dtype=np.float32)
    r, c = np.nonzero(d)
    (lj, ij, aj), (lt, it, at) = _run_both(
        monkeypatch, r, c, d[r, c], d.shape, (2, 2),
        dict(max_iters=30, add_self_loops=False))
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert it == ij
    _same_iterate(at, aj)
    assert len(np.unique(lt[:12].numpy())) == 2


@pytest.mark.parametrize("params", [dict(select=8, recover_num=10),
                                    dict()])
def test_mcl_dist_rmat_matches_jax(monkeypatch, params):
    """A seeded scale-7 R-MAT with uniform weights on a 2x2 grid: the same
    labels, iteration count and final iterate."""
    r, c, w, shape = rmat7()
    (lj, ij, aj), (lt, it, at) = _run_both(
        monkeypatch, r, c, w, shape, (2, 2), dict(max_iters=30, **params))
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert it == ij
    _same_iterate(at, aj)


def test_mcl_dist_phases_equal_one_phase(monkeypatch):
    """Columns prune independently and the phases' column slabs are
    disjoint, so 2 phases give the 1-phase iterate (3 iterations)."""
    r, c, w, shape = rmat7(2)
    tm = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(2, 2))
    seen = {}
    p = tmcl.MCLParams(max_iters=3, select=8, recover_num=10)
    _capture(monkeypatch, tmcl, "dist_transpose", seen, 1)
    tmcl.mcl_dist(tm, p, phases=1)
    _capture(monkeypatch, tmcl, "dist_transpose", seen, 2)
    tmcl.mcl_dist(tm, p, phases=2)
    a1, a2 = seen[1].to_local(), seen[2].to_local()
    k = int(a1.nnz)
    assert int(a2.nnz) == k
    assert torch.equal(a1.row[:k], a2.row[:k])
    assert torch.equal(a1.col[:k], a2.col[:k])
    torch.testing.assert_close(a2.val[:k], a1.val[:k], rtol=1e-6, atol=0)


def _two_cliques():
    d = two_components(12) + np.eye(12, dtype=np.float32)
    r, c = np.nonzero(d)
    return r, c, d[r, c], d.shape


@pytest.mark.parametrize("graph, params", [
    ("two_cliques", dict(max_iters=20, add_self_loops=False)),
    ("rmat7", dict(max_iters=30, select=8, recover_num=10)),
])
def test_mcl_dist_3d_matches_jax(monkeypatch, graph, params):
    """The ``layers=2`` route (per-phase 3D SUMMA on a (2, 2, 2) grid,
    each slab back on the 2D grid through the prune hook, the slabs
    summed by ``dist_add``) against JAX's on its 8 virtual devices: the
    same labels, iteration count and final iterate."""
    r, c, w, shape = _two_cliques() if graph == "two_cliques" else rmat7(3)
    (lj, ij, aj), (lt, it, at) = _run_both(
        monkeypatch, r, c, w, shape, (2, 2), params, layers=2, phases=2)
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert it == ij
    _same_iterate(at, aj)


def _partition(labels):
    """The partition as a canonical label array (first-seen order)."""
    _, first = np.unique(labels, return_inverse=True)
    remap = {}
    return np.array([remap.setdefault(x, len(remap)) for x in first])


def test_mcl_dist_3d_partition_equals_2d():
    """``layers=2`` (the 3D SUMMA expansion on a (2, 2, 2) grid) gives the
    2D run's partition of the vertices."""
    r, c, w, shape = rmat7(3)
    tm = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(2, 2))
    p = tmcl.MCLParams(max_iters=30, select=8, recover_num=10)
    l2, i2 = tmcl.mcl_dist(tm, p)
    l3, i3 = tmcl.mcl_dist(tm, p, phases=2, layers=2, grid3=tgrid(2, 2, 2))
    n = shape[0]
    np.testing.assert_array_equal(_partition(l3[:n].numpy()),
                                  _partition(l2[:n].numpy()))
    with pytest.raises(ValueError, match="3D ProcGrid"):
        tmcl.mcl_dist(tm, p, layers=2)


def _jax_perm(key, grid):
    """A stand-in for the port's ``dist_rand_perm`` that returns JAX's
    permutation from ``key`` on the JAX twin of ``grid`` (JAX's threefry
    draws cannot be made by a torch generator)."""
    def perm(generator, n, tg):
        assert isinstance(generator, torch.Generator)
        jg = jgrid(tg.pr, tg.pc)
        return torch.from_numpy(np.array(
            jvec.dist_rand_perm(key, n, jg))).to(tg.device)
    return perm


def two_cliques_isolated():
    """Two 6-cliques with self loops on vertices 0-11, vertices 12-15
    isolated (``tests/test_mcl_fidelity.py``'s graph)."""
    d = np.zeros((16, 16), np.float32)
    d[:12, :12] = two_components(12) + np.eye(12, dtype=np.float32)
    r, c = np.nonzero(d)
    return r, c, d[r, c], d.shape


def rmat7_isolated(seed=4):
    """The seeded scale-7 SSCA R-MAT, symmetrized, uniform weights, with
    self loops only on the vertices of degree >= 1 (HipMCL's order): its
    isolated vertices stay empty columns."""
    g = torch.Generator().manual_seed(seed)
    a = rmat_matrix(g, 7, 4, symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    row, col, _val, nnz, shape = a.to_numpy()
    w = np.random.default_rng(seed).uniform(0.5, 1.5, nnz).astype(np.float32)
    live = np.unique(row[:nnz])
    assert live.size < shape[0]     # some vertices are isolated
    return (np.concatenate([row[:nnz], live]),
            np.concatenate([col[:nnz], live]),
            np.concatenate([w, np.ones(live.size, np.float32)]), shape)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (4, 2)])
def test_dist_remove_isolated_matches_jax(grid):
    """The keep map, the kept count and the compacted matrix (stacks slot
    for slot) equal JAX's."""
    r, c, w, shape = rmat7_isolated()
    jm = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(*grid))
    tm = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(*grid))
    jb, jmap, jk = jmcl.dist_remove_isolated(jm)
    tb, tmap, tk = tmcl.dist_remove_isolated(tm)
    np.testing.assert_array_equal(tmap, jmap)
    assert tk == jk == int((tmap >= 0).sum()) < shape[0]
    assert_same_blocks(tb, jb, exact=True)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (4, 2)])
def test_dist_rand_permute_given_jax_perm(monkeypatch, grid):
    """Given JAX's permutation (``dist_rand_perm`` patched on the port's
    side), ``dist_rand_permute`` returns it and JAX's matrix, slot for
    slot."""
    r, c, w, shape = rmat7_isolated()
    jm = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(*grid))
    tm = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(*grid))
    key = jax.random.PRNGKey(5)
    monkeypatch.setattr(tmcl, "dist_rand_perm", _jax_perm(key, grid))
    jb, jperm = jmcl.dist_rand_permute(jm, key)
    tb, tperm = tmcl.dist_rand_permute(tm, torch.Generator())
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    assert_same_blocks(tb, jb, exact=True)


@pytest.mark.parametrize("graph, params", [
    ("two_cliques", dict(max_iters=30, add_self_loops=False)),
    ("rmat7", dict(max_iters=30, select=8, recover_num=10)),
])
def test_mcl_dist_preprocess_matches_jax(monkeypatch, graph, params):
    """``preprocess=True`` (RemoveIsolated, RandPermute, labels translated
    back) against JAX's with its default key, the port's permutation
    patched to JAX's: labels and iterations exact; every isolated vertex
    a singleton labelled n + its index."""
    r, c, w, shape = (two_cliques_isolated() if graph == "two_cliques"
                      else rmat7_isolated())
    grid = (2, 2)
    jm = jdist.DistSpMat.from_coo_arrays(r, c, w, shape, jgrid(*grid))
    tm = tdist.DistSpMat.from_coo_arrays(r, c, w, shape, tgrid(*grid))
    monkeypatch.setattr(tmcl, "dist_rand_perm",
                        _jax_perm(jax.random.PRNGKey(17), grid))
    lj, ij = jmcl.mcl_dist(jm, jmcl.MCLParams(**params), preprocess=True)
    lt, it = tmcl.mcl_dist(tm, tmcl.MCLParams(**params), preprocess=True)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert it == ij
    n = shape[0]
    iso = np.setdiff1d(np.arange(n), r)
    assert iso.size and lt.shape == (n,)
    np.testing.assert_array_equal(lt[iso].numpy(), n + iso)
    assert not np.isin(lt[iso].numpy(), np.delete(lt.numpy(), iso)).any()
