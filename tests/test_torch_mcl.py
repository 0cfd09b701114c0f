"""The port's single-device MCL (``models/mcl.py``) vs the JAX package's on
shared numpy inputs: each stage on identical inputs (structure exact,
values rtol 1e-6), and whole ``mcl_local`` runs (labels and iteration
count exact, the chaos of every iteration rtol 1e-5).

JAX's ``spgemm_auto`` takes its sort route on the CPU, the port its kernel
routes with their plain versions, so the iterates' capacities may differ:
whole runs are compared on labels, iteration counts and chaos.  Whole runs
use inflation 2 (the default, and ``bench.py``'s): with a non-integer power
XLA's and PyTorch's ``pow`` may differ in the last bit of some values, and
near convergence chaos (a column max less a column sum of squares)
amplifies that past 1e-5; ``_inflate`` itself is held at power 1.5 within
1e-6.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from combblas_tpu.models import mcl as jmcl  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu_torch.models import mcl as tmcl  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


def _params(**kw):
    """The same parameters for both packages, field for field."""
    jp = jmcl.MCLParams(**kw)
    return jp, tmcl.MCLParams(**dataclasses.asdict(jp))


def _live(a):
    """(keys, values) of the live entries, for either package."""
    nnz = int(a.nnz)
    row = np.asarray(a.row)[:nnz].astype(np.int64)
    col = np.asarray(a.col)[:nnz].astype(np.int64)
    return row * (a.shape[1] + 1) + col, np.asarray(a.val)[:nnz]


def _same(t, j, rtol=1e-6, slots=True):
    """Port ``t`` equals JAX ``j``: nnz and keys exact, values within
    ``rtol``; with ``slots`` also capacity and pads."""
    assert t.shape == tuple(j.shape)
    assert int(t.nnz) == int(j.nnz)
    if slots:
        assert t.capacity == j.capacity
        np.testing.assert_array_equal(t.row.numpy(), np.asarray(j.row))
        np.testing.assert_array_equal(t.col.numpy(), np.asarray(j.col))
        np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val),
                                   rtol=rtol, atol=0)
    else:
        tk, tv = _live(t)
        jk, jv = _live(j)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=0)


def _two_cliques(n):
    """``tests/test_apps.py``'s two cliques, no bridge."""
    d = np.zeros((n, n), np.float32)
    h = n // 2
    d[:h, :h] = 1.0
    d[h:, h:] = 1.0
    np.fill_diagonal(d, 0.0)
    return d


def _planted(seed, blocks=4, size=64, p_in=0.3, p_out=0.01):
    """A symmetric planted-partition graph with uniform(0.5, 1.5) weights:
    ``blocks`` blocks of ``size`` vertices."""
    rng = np.random.default_rng(seed)
    n = blocks * size
    blk = np.arange(n) // size
    p = np.where(blk[:, None] == blk[None, :], p_in, p_out)
    hit = np.triu(rng.random((n, n)) < p, 1)
    w = np.triu(rng.uniform(0.5, 1.5, (n, n)), 1)
    d = np.where(hit, w, 0.0).astype(np.float32)
    return d + d.T


def _stochastic_pair(seed, n=48, density=0.15, cap_extra=37):
    """A column-stochastic matrix with empty columns, as MCL holds it."""
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density) * rng.uniform(0.1, 1.0, (n, n))
    d[:, 5] = 0.0
    d[:, 17] = 0.0
    r, c = np.nonzero(d)
    ja = JCOO.from_arrays(r, c, d[r, c].astype(np.float32), (n, n),
                          capacity=r.size + cap_extra)
    ja = jmcl.make_col_stochastic(ja)
    return ja, _port(ja)


def _expanded(seed, n=96, density=0.2):
    """A² of a random stochastic matrix: columns long enough for the
    select and recovery rules, with many small values."""
    ja, _ = _stochastic_pair(seed, n=n, density=density)
    from combblas_tpu.ops.spgemm import spgemm_auto
    j2 = spgemm_auto(ja, ja)
    return j2, _port(j2)


@pytest.mark.parametrize("seed", [0, 1])
def test_make_col_stochastic(seed):
    rng = np.random.default_rng(seed)
    n = 40
    d = (rng.random((n, n)) < 0.2) * rng.uniform(0.1, 3.0, (n, n))
    d[:, 3] = 0.0
    r, c = np.nonzero(d)
    ja = JCOO.from_arrays(r, c, d[r, c].astype(np.float32), (n, n),
                          capacity=r.size + 11)
    _same(tmcl.make_col_stochastic(_port(ja)), jmcl.make_col_stochastic(ja))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos(seed):
    ja, ta = _stochastic_pair(seed)
    np.testing.assert_allclose(float(tmcl.chaos(ta)), float(jmcl.chaos(ja)),
                               rtol=1e-6)


@pytest.mark.parametrize("power", [2.0, 1.5])
def test_inflate(power):
    ja, ta = _stochastic_pair(3)
    _same(tmcl._inflate(ta, power), jmcl._inflate(ja, power))


PRUNE_RULES = {
    "select": dict(cutoff=1e-3, select=6, recover_num=9, recover_pct=0.9),
    "recover": dict(cutoff=2e-2, select=5, recover_num=7, recover_pct=0.9),
    "tight": dict(cutoff=2e-3, select=3, recover_num=4, recover_pct=1.0),
    "floor_below_select": dict(cutoff=1.5e-2, select=10, recover_num=2,
                               recover_pct=0.5),
}

#: The expansion's pad share in the benchmark's MCL: its buffer holds
#: about 40 slots for each live entry.
PAD_RATIO = 40


def _prune_input(name):
    """(JAX, port) input of ``test_mcl_prune``: ``expanded`` is A² as
    ``spgemm_auto`` leaves it; ``pad40`` the same in ``PAD_RATIO`` times
    its nnz; ``nopads`` with capacity == nnz; ``empty`` no live entry;
    ``ties`` ``pad40`` with values rounded to multiples of 1/256, so
    that equal values straddle the select and recovery ranks."""
    j2, _ = _expanded(4)
    nnz = int(j2.nnz)
    if name == "pad40":
        j2 = j2.with_capacity(PAD_RATIO * nnz)
    elif name == "nopads":
        j2 = j2.with_capacity(nnz)
    elif name == "empty":
        j2 = JCOO.empty(j2.shape, PAD_RATIO * 64)
    elif name == "ties":
        j2 = j2.with_capacity(PAD_RATIO * nnz)
        j2 = dataclasses.replace(
            j2, val=jax.numpy.round(j2.val * 256) / 256)
    return j2, _port(j2)


def _straddles(a, k):
    """Some column's k-th and (k+1)-th largest live values are equal."""
    nnz = int(a.nnz)
    col = np.asarray(a.col)[:nnz]
    val = np.abs(np.asarray(a.val)[:nnz])
    for c in np.unique(col):
        v = np.sort(val[col == c])[::-1]
        if v.size > k and v[k - 1] == v[k]:
            return True
    return False


# (out_cap, rules, input): None is the input's capacity
PRUNE_CASES = [(o, r, "expanded") for o in (None, 300) for r in PRUNE_RULES]
PRUNE_CASES += [(None, "select", "pad40"), (None, "recover", "pad40"),
                (300, "select", "pad40"), (None, "select", "nopads"),
                (None, "recover", "nopads"), (None, "select", "empty"),
                (None, "select", "ties"), (None, "recover", "ties"),
                (None, "tight", "ties")]


@pytest.mark.parametrize(
    "out_cap, rules, inp", PRUNE_CASES,
    ids=[f"{o}-{r}" if i == "expanded" else f"{o}-{r}-{i}"
         for o, r, i in PRUNE_CASES])
def test_mcl_prune(out_cap, rules, inp):
    kw = PRUNE_RULES[rules]
    j2, t2 = _prune_input(inp)
    jp, tp = _params(**kw)
    cap = j2.capacity if out_cap is None else out_cap
    jo = jmcl._mcl_prune(j2, jp, cap)
    to = tmcl._mcl_prune(t2, tp, cap)
    _same(to, jo, rtol=0)
    np.testing.assert_array_equal(to.val.numpy().view(np.int32),
                                  np.asarray(jo.val).view(np.int32))
    live = np.asarray(j2.val)[:int(j2.nnz)]
    if inp == "empty":
        assert int(to.nnz) == 0
        return
    # the cases exercise all three rules: some entries under the cutoff
    # drop, some columns are cut to `select`, some recover
    assert (live < kw["cutoff"]).any() and (live >= kw["cutoff"]).any()
    if inp == "pad40":
        assert j2.capacity == PAD_RATIO * int(j2.nnz)
    if inp == "nopads":
        assert j2.capacity == int(j2.nnz)
    if out_cap is not None and inp == "pad40":
        # nnz counts the kept entries past the output's capacity
        assert int(to.nnz) > out_cap == to.capacity
    if inp == "ties":
        assert _straddles(j2, kw["select"])
        if rules == "recover":
            assert _straddles(j2, kw["recover_num"])


def test_mcl_prune_reads_only_the_live_prefix():
    """Slots past nnz are pads by ``SpCOO``'s contract: poisoned with
    in-range coordinates, large values and NaNs there, the prune's output
    equals that of the same input with ``(m, n, 0)`` pads."""
    _, t2 = _prune_input("pad40")
    m, n = t2.shape
    nnz, cap = int(t2.nnz), t2.capacity
    g = torch.Generator().manual_seed(3)
    row, col, val = t2.row.clone(), t2.col.clone(), t2.val.clone()
    row[nnz:] = torch.randint(0, m, (cap - nnz,), generator=g,
                              dtype=torch.int32)
    col[nnz:] = torch.randint(0, n, (cap - nnz,), generator=g,
                              dtype=torch.int32)
    val[nnz:] = torch.where(torch.rand(cap - nnz, generator=g) < 0.5,
                            float("nan"), 1e30)
    poisoned = dataclasses.replace(t2, row=row, col=col, val=val)
    assert (t2.row[nnz:] == m).all() and (t2.val[nnz:] == 0).all()
    for kw in PRUNE_RULES.values():
        p = tmcl.MCLParams(**kw)
        want = tmcl._mcl_prune(t2, p, 1000)
        got = tmcl._mcl_prune(poisoned, p, 1000)
        assert int(got.nnz) == int(want.nnz) > 0
        assert torch.equal(got.row, want.row)
        assert torch.equal(got.col, want.col)
        assert torch.equal(got.val.view(torch.int32),
                          want.val.view(torch.int32))


def test_mcl_prune_rules_fire():
    """The 'recover' case: recovery fires in some columns and select cuts
    others, so the one-sort prune is held on all of its branches."""
    j2, _ = _expanded(4)
    nnz = int(j2.nnz)
    col = np.asarray(j2.col)[:nnz]
    val = np.asarray(j2.val)[:nnz]
    cut = np.bincount(col[val >= 2e-2], minlength=j2.shape[1])
    kept = np.minimum(cut, 5)
    assert (kept < int(0.9 * 5)).any()        # recovery
    assert (cut > 5).any()                     # select


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_cols(seed):
    ja, ta = _stochastic_pair(seed)
    cm = np.random.default_rng(seed).random(ja.shape[1]) < 0.5
    _same(tmcl._mask_cols(ta, torch.from_numpy(cm)),
          jmcl._mask_cols(ja, jax.numpy.asarray(cm)))


def test_iterate_bridge_round_trip():
    """An MCL iterate through the numpy bridge, bit for bit both ways."""
    ja, ta = _stochastic_pair(5)
    row, col, val, nnz, shape = ta.to_numpy()
    back = JCOO(row=jax.numpy.asarray(row), col=jax.numpy.asarray(col),
                val=jax.numpy.asarray(val),
                nnz=jax.numpy.asarray(nnz, jax.numpy.int32), shape=shape)
    _same(_port(back), ja, rtol=0)
    assert val.dtype == np.float32 and row.dtype == np.int32


def _rules_fired(a, p):
    """Which prune rules act on the expanded matrix ``a`` (numpy, from the
    rule itself): select cuts a column, recovery takes one over."""
    nnz = int(a.nnz)
    col = a.col.numpy()[:nnz]
    val = np.abs(a.val.numpy()[:nnz])
    cut = np.bincount(col[val >= p.cutoff], minlength=a.shape[1])
    floor = int(p.recover_pct * min(p.recover_num, p.select))
    return dict(select=bool((cut > p.select).any()),
                recover=bool((np.minimum(cut, p.select) < floor)
                             [np.bincount(col, minlength=a.shape[1]) > 0]
                             .any()))


def _run(pkg, a, params):
    chaos, secs = [], []
    mod = jmcl if pkg == "jax" else tmcl
    labels, iters = mod.mcl_local(
        a, params, on_iter=lambda it, ch, s: (chaos.append(ch),
                                              secs.append(s)))
    assert len(chaos) == iters
    return np.asarray(labels), iters, chaos


@pytest.mark.parametrize("graph, kw", [
    ("cliques", dict(inflation=2.0, max_iters=30)),
    ("planted", dict(select=8, recover_num=12, cutoff=1e-3)),
    ("planted_recover", dict(select=6, recover_num=10, recover_pct=0.9,
                             cutoff=2e-2)),
])
def test_mcl_local_matches_jax(graph, kw, monkeypatch):
    d = _two_cliques(12) if graph == "cliques" else _planted(11)
    r, c = np.nonzero(d)
    ja = JCOO.from_arrays(r, c, d[r, c], d.shape)
    jp, tp = _params(**kw)
    fired = dict(select=False, recover=False)
    prune = tmcl._mcl_prune

    def watched(a, p, out_capacity):
        for rule, hit in _rules_fired(a, p).items():
            fired[rule] |= hit
        return prune(a, p, out_capacity)

    monkeypatch.setattr(tmcl, "_mcl_prune", watched)
    jl, ji, jch = _run("jax", ja, jp)
    tl, ti, tch = _run("port", _port(ja), tp)
    assert ti == ji
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tch, jch, rtol=1e-5)
    assert jch[-1] < jp.eps                 # converged, not cut
    if graph == "cliques":
        assert len(np.unique(tl)) == 2
    else:
        assert len(np.unique(tl)) >= 4
        assert fired["select"]
    if graph == "planted_recover":
        assert fired["recover"]


def test_iterate_capacity_holds_recovered_columns(monkeypatch):
    """Whether the iterate's capacity holds the recovered columns: it does
    not, in either package.  Recovery keeps up to ``recover_num`` >
    ``select`` entries a column, the iterate is sized for ``select`` a
    column, and ``_compact`` drops the excess while its ``nnz`` counts it.
    The port reproduces the JAX package here: the same capacity, the same
    prune counts past it, the same labels."""
    d = _planted(13, blocks=2, size=128, p_in=0.03, p_out=0.002)
    r, c = np.nonzero(d)
    ja = JCOO.from_arrays(r, c, d[r, c], d.shape)
    jp, tp = _params(select=4, recover_num=12, cutoff=0.5, max_iters=2)
    kept = {"jax": [], "port": []}

    def watch(mod, pkg):
        prune = mod._mcl_prune

        def watched(a, p, out_capacity):
            out = prune(a, p, out_capacity)
            kept[pkg].append((int(out.nnz), out_capacity))
            return out
        monkeypatch.setattr(mod, "_mcl_prune", watched)

    watch(jmcl, "jax")
    watch(tmcl, "port")
    jl, ji, _ = _run("jax", ja, jp)
    tl, ti, _ = _run("port", _port(ja), tp)
    assert kept["port"] == kept["jax"]
    assert (ti, ji) == (2, 2)
    np.testing.assert_array_equal(tl, jl)
    n = d.shape[0]
    merged_cap = ja.capacity + JCOO.eye(n).capacity
    jax_cap = max(merged_cap, 1 << int(np.ceil(np.log2(tp.select * n))))
    start = tmcl.make_col_stochastic(tmcl.merge(
        _port(ja), TCOO.eye(n, device="cpu"), tmcl.PLUS_TIMES))
    assert tmcl.iterate_capacity(start, tp) == jax_cap
    assert max(cap for _, cap in kept["port"]) == jax_cap
    assert max(nnz for nnz, _ in kept["port"]) > jax_cap