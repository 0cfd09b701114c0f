"""The port's distributed vector layer (``parallel/vector.py``) vs the JAX
package's, on shared numpy inputs.

JAX runs on 1x1, 2x2 and 4x2 grids of the 8 virtual CPU devices, the
port on the same grids on the CPU.  Every output here is integral or a
carried value, so sorted values (bit for bit), payloads, permutations,
routes, gathers, inverts and uniqs are compared exactly; the one float
sum (``dist_route(combine="sum")`` on floats) folds in the same order on
the CPU and is compared exactly too.  One vector length serves every test
of a grid, so that JAX compiles each function once a grid.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.parallel import dist as jdist  # noqa: E402
from combblas_tpu.parallel import vector as jvec  # noqa: E402
from combblas_tpu_torch.parallel import vector as tvec  # noqa: E402
from tests.test_torch_dist import jgrid, tgrid  # noqa: E402

GRIDS = [(1, 1), (2, 2), (4, 2)]
#: The padded length of every vector (a multiple of 8 devices).
N_PAD = 200


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grids(request):
    return jgrid(*request.param), tgrid(*request.param)


def _j(x, jg):
    return jdist.dist_vec(np.asarray(x), jg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def special_floats(seed=0, n=N_PAD):
    """Normal floats, about 1/16 of them repeated, with -0.0, +0.0, both
    infinities and NaNs of either sign and several payloads among them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    rep = rng.integers(0, n, n // 16)
    x[rep] = x[rng.integers(0, n, rep.size)]
    specials = np.array([0x80000000, 0x00000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF,
                         0x7F800001], np.uint32).view(np.float32)
    x[rng.choice(n, 3 * specials.size, replace=False)] = np.tile(specials, 3)
    return x


def test_sortable_u32_matches_jax():
    """The key of every float class and of ints, uint32 included."""
    f = special_floats()
    i = np.array([-2**31, -5, -1, 0, 1, 7, 2**31 - 1], np.int32)
    u = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)
    for x in (f, i, u):
        want = np.asarray(jvec._sortable_u32(jnp.asarray(x))).astype(np.int64)
        got = tvec._sortable_u32(_t(x)).numpy()
        np.testing.assert_array_equal(got, want)


SORT_CASES = {
    "floats": lambda: (special_floats(1), dict()),
    "floats_length": lambda: (special_floats(2), dict(length=157)),
    "descending": lambda: (special_floats(3), dict(descending=True,
                                                    length=190)),
    "ints": lambda: (np.random.default_rng(4).integers(
        -1000, 1000, N_PAD).astype(np.int32), dict()),
    "skewed": lambda: (np.where(np.random.default_rng(5).random(N_PAD) < .9,
                                7, np.arange(N_PAD)).astype(np.int32),
                       dict(length=180)),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
@pytest.mark.parametrize("auto", [False, True])
def test_dist_sort_matches_jax(grids, case, auto):
    """Sorted values bit for bit and the carried int32 payload exact;
    ``dist_sort_auto`` (JAX's planned buffers) gives the same."""
    jg, tg = grids
    x, kw = SORT_CASES[case]()
    pay = np.random.default_rng(9).permutation(N_PAD).astype(np.int32)
    jf = jvec.dist_sort_auto if auto else jvec.dist_sort
    tf = tvec.dist_sort_auto if auto else tvec.dist_sort
    jx, jp = jf(_j(x, jg), jg, _j(pay, jg), **kw)
    tx, tp = tf(_t(x), tg, _t(pay), **kw)
    np.testing.assert_array_equal(_bits(tx.numpy()), _bits(jx))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_dist_sort_equals_host_lexsort(grids):
    """The port's sort is numpy's lexsort on (key, index): -0.0 before
    +0.0, NaNs by their bits, the tail past ``length`` in index order."""
    _, tg = grids
    x = special_floats(6)
    tx, ti = tvec.dist_sort(_t(x), tg, torch.arange(N_PAD), length=150)
    key = tvec._sortable_u32(_t(x)).numpy()
    key[150:] = 0xFFFFFFFF
    order = np.lexsort((np.arange(N_PAD), key))
    np.testing.assert_array_equal(ti.numpy(), order)
    np.testing.assert_array_equal(_bits(tx.numpy()), _bits(x[order]))
    assert tvec.dist_sort(_t(x), tg).shape == (N_PAD,)


def _jax_keys(key, n, jg):
    """JAX's per-shard RandPerm keys: ``bits(fold_in(key, me), (chunk,))``
    on each device ``me``, concatenated."""
    p = jg.nprocs
    chunk = -(-n // p) * p // p
    return np.concatenate([np.asarray(jax.random.bits(
        jax.random.fold_in(key, me), (chunk,), jnp.uint32))
        for me in range(p)])


@pytest.mark.parametrize("n", [N_PAD, 193])
def test_perm_from_jax_keys_equals_jax_rand_perm(grids, n):
    """Given JAX's own keys, ``perm_from_keys`` is JAX's permutation,
    padding slots ``n`` included."""
    jg, tg = grids
    key = jax.random.PRNGKey(11)
    want = np.asarray(jvec.dist_rand_perm(key, n, jg))
    keys = _jax_keys(key, n, jg)
    got = tvec.perm_from_keys(_t(keys.astype(np.int64)), n, tg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dist_rand_perm_is_a_permutation(grids):
    _, tg = grids
    g = torch.Generator().manual_seed(3)
    p = tvec.dist_rand_perm(g, 193, tg).numpy()
    assert p.shape == (-(-193 // tg.nprocs) * tg.nprocs,)
    assert p.dtype == np.int32
    np.testing.assert_array_equal(np.sort(p[:193]), np.arange(193))
    assert (p[193:] == 193).all()
    again = tvec.dist_rand_perm(torch.Generator().manual_seed(3), 193, tg)
    np.testing.assert_array_equal(again.numpy(), p)


def route_inputs(seed, dtype):
    """Pairs with duplicate indices (every slot hit about twice), some
    masked out, some past the vector, and a few negative ones."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_PAD // 2, N_PAD).astype(np.int32)
    idx[rng.choice(N_PAD, 10, replace=False)] = N_PAD + 3
    idx[rng.choice(N_PAD, 4, replace=False)] = -rng.integers(1, 20, 4)
    if dtype == np.float32:
        val = rng.standard_normal(N_PAD).astype(np.float32)
        init = rng.standard_normal(N_PAD).astype(np.float32)
    else:
        val = rng.integers(-50, 50, N_PAD).astype(np.int32)
        init = rng.integers(-50, 50, N_PAD).astype(np.int32)
    mask = rng.random(N_PAD) < 0.8
    return idx, val, mask, init


@pytest.mark.parametrize("combine", ["set", "sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dist_route_matches_jax(grids, combine, dtype):
    """Every combine, with duplicate, masked, out-of-range and negative
    indices: out and the hit mask exact (the float sum folds in JAX's
    order on the CPU)."""
    jg, tg = grids
    idx, val, mask, init = route_inputs(12, dtype)
    jo, jm = jvec.dist_route(_j(idx, jg), _j(val, jg), _j(mask, jg),
                             _j(init, jg), jg, combine=combine)
    to, tm = tvec.dist_route(_t(idx), _t(val), _t(mask), _t(init), tg,
                             combine=combine)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    with pytest.raises(ValueError, match="combine"):
        tvec.dist_route(_t(idx), _t(val), _t(mask), _t(init), tg,
                        combine="mean")


def test_dist_route_set_keeps_the_last_writer():
    """Of several pairs on one slot, the last in flat order wins."""
    tg = tgrid(2, 2)
    idx = torch.tensor([3, 3, 1, 3, 0, 1, 2, 3], dtype=torch.int32)
    val = torch.arange(8, dtype=torch.float32) + 10
    out, hit = tvec.dist_route(idx, val, torch.ones(8, dtype=torch.bool),
                               torch.zeros(8), tg)
    assert out.tolist() == [14, 15, 16, 17, 0, 0, 0, 0]
    assert hit.tolist() == [True] * 4 + [False] * 4


def test_dist_gather_matches_jax(grids):
    """out[i] = x[idx[i]], 0 for an index outside the vector."""
    jg, tg = grids
    rng = np.random.default_rng(13)
    x = rng.standard_normal(N_PAD).astype(np.float32)
    idx = rng.integers(-5, N_PAD + 5, N_PAD).astype(np.int32)
    want = jvec.dist_gather(_j(x, jg), _j(idx, jg), jg)
    got = tvec.dist_gather(_t(x), _t(idx), tg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dist_apply_perm_matches_jax(grids):
    """y[perm[i]] = x[i] through a RandPerm with its padding slots."""
    jg, tg = grids
    perm = np.asarray(jvec.dist_rand_perm(jax.random.PRNGKey(2), 195, jg))
    x = np.random.default_rng(14).standard_normal(perm.size).astype(
        np.float32)
    want = jvec.dist_apply_perm(_j(x, jg), _j(perm, jg), jg)
    got = tvec.dist_apply_perm(_t(x), _t(perm), tg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dist_invert_matches_jax(grids):
    """out[val[i]] = i over the live entries, duplicates keeping the
    largest index, -1 elsewhere."""
    jg, tg = grids
    rng = np.random.default_rng(15)
    val = rng.integers(0, N_PAD // 3, N_PAD).astype(np.int32)
    mask = rng.random(N_PAD) < 0.7
    jo, jm = jvec.dist_invert(_j(val, jg), _j(mask, jg), jg)
    to, tm = tvec.dist_invert(_t(val), _t(mask), tg)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kind", ["floats", "ints"])
def test_dist_uniq_matches_jax(grids, kind):
    """One entry per distinct key (the smallest index): -0.0 and +0.0 are
    two values; NaNs of one bit pattern are one."""
    jg, tg = grids
    rng = np.random.default_rng(16)
    if kind == "floats":
        val = special_floats(17)
        val[rng.integers(0, N_PAD, 60)] = val[rng.integers(0, N_PAD, 60)]
    else:
        val = rng.integers(0, 30, N_PAD).astype(np.int32)
    mask = rng.random(N_PAD) < 0.75
    jo, jm = jvec.dist_uniq(_j(val, jg), _j(mask, jg), jg)
    to, tm = tvec.dist_uniq(_t(val), _t(mask), tg)
    np.testing.assert_array_equal(_bits(to.numpy()), _bits(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_dist_uniq_pad_key_value_matches_jax(grids):
    """A live NaN of bits 0x7FFFFFFF has the pad key 0xFFFFFFFF of a dead
    slot: its run's head is the first slot of that key, live or dead, so
    the value survives only where no dead slot comes before it (JAX's
    rule, kept)."""
    jg, tg = grids
    val = np.full(N_PAD, 0x7FFFFFFF, np.uint32).view(np.float32)
    val[::3] = np.arange(0, N_PAD, 3, dtype=np.float32)
    for first_dead in (True, False):
        mask = np.ones(N_PAD, bool)
        mask[1 if first_dead else N_PAD - 1] = False
        jo, jm = jvec.dist_uniq(_j(val, jg), _j(mask, jg), jg)
        to, tm = tvec.dist_uniq(_t(val), _t(mask), tg)
        np.testing.assert_array_equal(_bits(to.numpy()), _bits(jo))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert (tm.numpy() & np.isnan(val)).any() != first_dead
