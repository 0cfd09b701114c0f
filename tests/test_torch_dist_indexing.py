"""The port's distributed indexing (``parallel/indexing.py``: selectors,
SpRef, block prune, SpAsgn, permutation) vs the JAX package's, on shared
numpy inputs.

JAX runs on the virtual CPU devices, the port on CPU tensors.  On the CPU
JAX's ``summa_spgemm_auto`` takes its ``"xla"`` route and the port its
kernels' plain versions, whose output capacities differ, so SpRef and
SpAsgn are compared on their compacted entries (``to_local``): keys
exact, values exact (each output is one product of selector ones, or a
sum of integer-valued floats).  Selectors, the block prune and
``dist_permute`` run no product and are compared slot for slot: rows,
columns, values, nnz, pads and capacity exact (``dist_permute`` folds a
non-injective map's duplicates in JAX's order on the CPU).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu.parallel import indexing as jix  # noqa: E402
from combblas_tpu.parallel import vector as jvec  # noqa: E402
from combblas_tpu.semiring import MAX_TIMES as J_MAX_TIMES  # noqa: E402
from combblas_tpu_torch.parallel import dist as tdist  # noqa: E402
from combblas_tpu_torch.parallel import indexing as tix  # noqa: E402
from combblas_tpu_torch.parallel import vector as tvec  # noqa: E402
from combblas_tpu_torch.semiring import MAX_TIMES  # noqa: E402
from tests.test_torch_dist import (  # noqa: E402
    assert_same_blocks,
    jgrid,
    tgrid,
)

#: SUMMA needs a square grid: SpRef and SpAsgn run on these.
SQUARE = [(1, 1), (2, 2)]
GRIDS = SQUARE + [(4, 2)]


@pytest.fixture(scope="module")
def grids():
    """One JAX grid a shape for the whole file (and its port twin)."""
    return {g: (jgrid(*g), tgrid(*g)) for g in GRIDS}


def rand_int_sparse(m, n, density, seed):
    """Integer-valued float32 entries in 1..8 at a seeded density."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((m, n)) < density, rng.integers(1, 9, (m, n)),
                 0).astype(np.float32)
    return d


def pair(d, jg, tg, capacity=None):
    r, c = np.nonzero(d)
    j = jdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, jg,
                                        capacity=capacity)
    t = tdist.DistSpMat.from_coo_arrays(r, c, d[r, c], d.shape, tg,
                                        capacity=capacity)
    return j, t


def same_entries(t, j):
    """Compacted entries equal: keys and values exact."""
    jl, tl = j.to_local(), t.to_local()
    k = int(jl.nnz)
    assert int(tl.nnz) == k
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(tl, f)[:k].numpy(),
                                      np.asarray(getattr(jl, f))[:k],
                                      err_msg=f)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("transpose", [False, True])
def test_dist_selector_matches_jax(grids, grid, transpose):
    jg, tg = grids[grid]
    idx = np.array([5, 0, 17, 5, 9, 30, 2])
    assert_same_blocks(tix.dist_selector(idx, 31, tg, transpose=transpose),
                       jix.dist_selector(idx, 31, jg, transpose=transpose),
                       exact=True)


@pytest.mark.parametrize("grid", SQUARE)
@pytest.mark.parametrize("repeat", [False, True])
def test_dist_spref_matches_jax(grids, grid, repeat):
    """A(ri, ci) through two SUMMA products; ``repeat`` repeats indices
    (matlab SpRef)."""
    jg, tg = grids[grid]
    d = rand_int_sparse(24, 30, 0.15, 0)
    j, t = pair(d, jg, tg)
    rng = np.random.default_rng(1)
    ri = rng.integers(0, 24, 10) if repeat else rng.permutation(24)[:10]
    ci = rng.integers(0, 30, 14) if repeat else rng.permutation(30)[:14]
    got = tix.dist_spref(t, ri, ci)
    same_entries(got, jix.dist_spref(j, ri, ci))
    np.testing.assert_array_equal(got.to_dense(), d[np.ix_(ri, ci)])


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_prune_block_matches_jax(grids, grid):
    jg, tg = grids[grid]
    d = rand_int_sparse(24, 30, 0.3, 2)
    j, t = pair(d, jg, tg)
    ri, ci = np.arange(3, 17), np.arange(0, 30, 3)
    got = tix.dist_prune_block(t, ri, ci)
    assert_same_blocks(got, jix.dist_prune_block(j, ri, ci), exact=True)
    ref = d.copy()
    ref[np.ix_(ri, ci)] = 0
    np.testing.assert_array_equal(got.to_dense(), ref)


@pytest.mark.parametrize("grid", SQUARE)
def test_dist_spasgn_matches_jax(grids, grid):
    """A(ri, ci) = B: the ri×ci block replaced (entries of A there gone,
    B's added)."""
    jg, tg = grids[grid]
    d = rand_int_sparse(24, 24, 0.2, 3)
    bd = rand_int_sparse(6, 8, 0.5, 4)
    j, t = pair(d, jg, tg)
    jb, tb = pair(bd, jg, tg)
    rng = np.random.default_rng(5)
    ri, ci = rng.permutation(24)[:6], rng.permutation(24)[:8]
    got = tix.dist_spasgn(t, ri, ci, tb)
    same_entries(got, jix.dist_spasgn(j, ri, ci, jb))
    ref = d.copy()
    ref[np.ix_(ri, ci)] = bd
    np.testing.assert_array_equal(got.to_dense(), ref)
    with pytest.raises(ValueError, match="DIMMISMATCH"):
        tix.dist_spasgn(t, ri[:5], ci, tb)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_permute_symmetric_matches_jax(grids, grid):
    jg, tg = grids[grid]
    n = 48
    d = rand_int_sparse(n, n, 0.15, 6)
    j, t = pair(d, jg, tg)
    perm = np.random.default_rng(7).permutation(n).astype(np.int32)
    got = tix.dist_permute(t, perm)
    assert_same_blocks(got, jix.dist_permute(j, perm), exact=True)
    ref = np.zeros_like(d)
    ref[np.ix_(perm, perm)] = d
    np.testing.assert_array_equal(got.to_dense(), ref)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_permute_rectangular_with_drops_matches_jax(grids, grid):
    """Row and column maps of their own; columns mapped past the padded
    length or negative are dropped; the column map is shorter than the
    padded length (padded with drops)."""
    jg, tg = grids[grid]
    d = rand_int_sparse(20, 30, 0.3, 8)
    j, t = pair(d, jg, tg)
    rng = np.random.default_rng(9)
    rmap = rng.permutation(20).astype(np.int32)
    cmap = np.full(25, 1 << 20, np.int32)
    cmap[::2] = np.arange(13)
    cmap[3] = -4
    got = tix.dist_permute(t, rmap, cmap)
    assert_same_blocks(got, jix.dist_permute(j, rmap, cmap), exact=True)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("semiring", ["plus", "max"])
def test_dist_permute_folds_duplicates_and_retries(grids, grid, semiring):
    """A map that sends pairs of rows and columns onto one (the semiring
    adds the duplicates), into blocks given a tiny ``out_capacity``, so
    that the exchange retries with doubled capacity: stacks and capacity
    equal JAX's."""
    jg, tg = grids[grid]
    n = 32
    d = rand_int_sparse(n, n, 0.3, 10)
    d[d > 0] += np.random.default_rng(11).random(int((d > 0).sum())).astype(
        np.float32)
    j, t = pair(d, jg, tg)
    fold = np.arange(n, dtype=np.int32) // 2
    jsr, tsr = ((J_MAX_TIMES, MAX_TIMES) if semiring == "max" else
                (jix.PLUS_TIMES, tix.PLUS_TIMES))
    got = tix.dist_permute(t, fold, sr=tsr, out_capacity=8)
    want = jix.dist_permute(j, fold, sr=jsr, out_capacity=8)
    assert got.capacity == want.capacity > 8
    assert_same_blocks(got, want, exact=True)


@pytest.mark.parametrize("grid", GRIDS)
def test_dist_rand_perm_permute_round_trip(grids, grid):
    """HipMCL's RandPermute: JAX's ``dist_rand_perm`` (its keys through the
    port's ``perm_from_keys``), ``dist_permute``, then the inverse from
    ``dist_invert`` gives the matrix back, stacks exact."""
    jg, tg = grids[grid]
    n = 40
    d = rand_int_sparse(n, n, 0.2, 12)
    j, t = pair(d, jg, tg)
    key = jax.random.PRNGKey(0)
    jperm = np.asarray(jvec.dist_rand_perm(key, n, jg))
    p = tg.nprocs
    chunk = -(-n // p)
    keys = np.concatenate([np.asarray(jax.random.bits(
        jax.random.fold_in(key, me), (chunk,), np.uint32))
        for me in range(p)]).astype(np.int64)
    tperm = tvec.perm_from_keys(torch.from_numpy(keys), n, tg)
    np.testing.assert_array_equal(tperm.numpy(), jperm)
    ph = jperm[:n]
    b = tix.dist_permute(t, ph)
    assert_same_blocks(b, jix.dist_permute(j, ph), exact=True)
    inv, hit = tvec.dist_invert(tperm, tperm < n, tg)
    assert bool(hit[:n].all())
    back = tix.dist_permute(b, inv[:n])
    assert_same_blocks(back, t, exact=True)
