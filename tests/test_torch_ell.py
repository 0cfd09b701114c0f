"""Port ELL-8 plans and fold (``ops/spmm_ell.py``, ``ops/spmm_ell_blocked.py``,
``ops/kernels/ell.py``) vs the JAX package's ``spmm_ell`` (K6) and
``spmm_ell_blocked`` (K7), run in interpret mode on shared numpy inputs.

Plans must be equal array for array.  The max fold is exact (order-free);
the sum fold adds in another order than the TPU kernel (which sums per run
and then into Y), so it is held to rtol 1e-5."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu.gen.rmat import rmat_matrix  # noqa: E402
from combblas_tpu.ops.coo import SpCOO as JCOO  # noqa: E402
from combblas_tpu.ops.pallas import spmm_ell as jell  # noqa: E402
from combblas_tpu.ops.pallas import spmm_ell_blocked as jblk  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO as TCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.kernels.ell import (  # noqa: E402
    PIECE_LEN,
    ell_fold,
    ell_fold_plain,
    ell_pieces,
    piece_len_for,
)
from combblas_tpu_torch.ops.spmm_ell import (  # noqa: E402
    spmm_ell,
    spmm_ell_prepare,
)
from combblas_tpu_torch.ops.spmm_ell_blocked import (  # noqa: E402
    ell_blocked_prepare,
    spmm_ell_blocked,
)

PLAN_ARRAYS = ("cols", "vals", "flush", "base", "inv", "order", "live")
PLAN_STATICS = ("P", "t_seg", "nb", "bs_r", "bs_c", "m_pad", "n_pad")


def _graph(kind):
    """R-MAT graphs of scale 7, 9 (symmetrized, no self loops) and 10, and
    a rectangular matrix with a hub row and empty rows."""
    if kind == "rect":
        rng = np.random.default_rng(3)
        m, n = 90, 64
        ad = ((rng.random((m, n)) < 0.15) * rng.random((m, n)))
        ad[7] = (rng.random(n) < 0.8) * 1.0
        ad[8:12] = 0.0
        return JCOO.from_dense(ad.astype(np.float32))
    scale = {"s7": 7, "s9sym": 9, "s10": 10}[kind]
    sym = kind.endswith("sym")
    return rmat_matrix(jax.random.PRNGKey(scale), scale=scale, edgefactor=8,
                       symmetrize=sym, remove_self_loops=sym)


def _port(a):
    return TCOO.from_numpy(np.asarray(a.row), np.asarray(a.col),
                           np.asarray(a.val), int(a.nnz), a.shape,
                           device="cpu")


@pytest.mark.parametrize("kind", ["s7", "s9sym", "s10", "rect"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("relabel,binary", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_blocked_plan_matches_jax(kind, nb, relabel, binary):
    ja = _graph(kind)
    if relabel and ja.shape[0] != ja.shape[1]:
        with pytest.raises(ValueError):
            ell_blocked_prepare(_port(ja), nb, relabel_cols=True)
        return
    jp = jblk.ell_blocked_prepare(ja, nb, relabel_cols=relabel,
                                  binary=binary)
    tp = ell_blocked_prepare(_port(ja), nb, relabel_cols=relabel,
                             binary=binary)
    for k in PLAN_ARRAYS:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    for k in PLAN_STATICS:
        assert tp[k] == jp[k], k
    assert tp["relabel_cols"] == relabel
    # the run table lists every live run: its last position flushes
    start, length = tp["run_start"].long(), tp["run_len"].long()
    last = (start + length - 1)[length > 0]
    assert int(tp["flush"].sum()) == last.numel()
    assert bool((tp["flush"][last] == 1).all())


@pytest.mark.parametrize("kind", ["s7", "s9sym", "s10", "rect"])
def test_ell_plan_matches_jax_and_blocked_nb1(kind):
    ja = _graph(kind)
    jp = jell.spmm_ell_prepare(ja)
    jb = jblk.ell_blocked_prepare(ja, nb=1)
    tp = spmm_ell_prepare(_port(ja))
    for k in ("cols", "vals", "flush", "base", "inv", "live"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
        # K6's plan is K7's with one block
        np.testing.assert_array_equal(np.asarray(jb[k]), np.asarray(jp[k]),
                                      err_msg=k)
    assert tp["P"] == jp["P"] == jb["P"]
    assert tp["groups"] == jp["groups"] == jb["m_pad"] // 8
    # and in the port: spmm_ell_prepare(a) is ell_blocked_prepare(a, nb=1)
    tb = ell_blocked_prepare(_port(ja), nb=1)
    for k in ("cols", "vals", "flush", "base", "inv", "live", "run_start",
              "run_len"):
        assert torch.equal(tp[k], tb[k]), k


@pytest.mark.parametrize("kind", ["s10", "rect"])
@pytest.mark.parametrize("d", [8, 128])
def test_ell_fold_matches_k6(kind, d):
    ja = _graph(kind)
    jp = jell.spmm_ell_prepare(ja)
    tp = spmm_ell_prepare(_port(ja))
    x = np.random.default_rng(d + 1).random((ja.shape[1], d)).astype(
        np.float32)
    want = np.asarray(jell._spmm_ell_call(
        jp["cols"], jp["vals"], jp["flush"], jp["base"], jnp.asarray(x),
        P=jp["P"], groups=jp["groups"], interpret=True))
    got = ell_fold(tp["cols"].t(), tp["vals"].t(), tp["run_start"],
                   tp["run_len"], torch.from_numpy(x), bs_c=tp["bs_c"])
    assert got.shape == want.shape
    # K6 never writes the rows of groups with no entries (spmm_ell masks
    # them with `live`); the port writes them as 0
    written = np.repeat(tp["run_len"].sum(1).numpy() > 0, 8)
    assert not written.all()
    np.testing.assert_allclose(got.numpy()[written], want[written], rtol=1e-5)
    assert not got.numpy()[~written].any()


@pytest.mark.parametrize("kind,nb", [("s9sym", 1), ("s9sym", 3),
                                     ("rect", 3)])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_ell_fold_matches_k7(kind, nb, d, op):
    ja = _graph(kind)
    relabel = ja.shape[0] == ja.shape[1]
    jp = jblk.ell_blocked_prepare(ja, nb, relabel_cols=relabel,
                                  binary=relabel)
    tp = ell_blocked_prepare(_port(ja), nb, relabel_cols=relabel,
                             binary=relabel)
    rng = np.random.default_rng(d)
    x = rng.random((jp["n_pad"], d)).astype(np.float32)
    want = np.asarray(jblk._ell_blocked_call(
        jp["cols"], jp["vals"], jp["flush"], jp["base"], jnp.asarray(x),
        t_seg=jp["t_seg"], nb=nb, bs_r=jp["bs_r"], bs_c=jp["bs_c"],
        m_pad=jp["m_pad"], n_pad=jp["n_pad"], op=op, interpret=True))
    before = dict(LAUNCHES)
    got = ell_fold(tp["cols"].t(), tp["vals"].t(), tp["run_start"],
                   tp["run_len"], torch.from_numpy(x), bs_c=tp["bs_c"],
                   op=op).numpy()
    assert LAUNCHES == before  # CPU tensors never count as kernel launches
    assert got.shape == want.shape
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["s10", "rect"])
@pytest.mark.parametrize("d", [8, 128])
def test_spmm_ell_matches_k6(kind, d):
    ja = _graph(kind)
    rng = np.random.default_rng(7)
    x = rng.random((ja.shape[1], d)).astype(np.float32)
    want = np.asarray(jell.spmm_ell(ja, jnp.asarray(x), interpret=True))
    ta = _port(ja)
    got = spmm_ell(ta, torch.from_numpy(x), prep=spmm_ell_prepare(ta))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    dense = np.asarray(ja.to_dense())
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,nb", [("s10", 3), ("rect", 1), ("rect", 3)])
@pytest.mark.parametrize("d", [8, 128])
def test_spmm_ell_blocked_matches_k7(kind, nb, d):
    ja = _graph(kind)
    rng = np.random.default_rng(11)
    x = rng.random((ja.shape[1], d)).astype(np.float32)
    want = np.asarray(jblk.spmm_ell_blocked(ja, jnp.asarray(x), nb=nb,
                                            interpret=True))
    got = spmm_ell_blocked(_port(ja), torch.from_numpy(x), nb=nb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_spmm_ell_blocked_max_relabeled_matches_k7():
    """The BFS sweep's configuration: relabeled columns, binary values, max
    fold, X and Y in the relabeled space."""
    ja = _graph("s9sym")
    jp = jblk.ell_blocked_prepare(ja, 3, relabel_cols=True, binary=True)
    tp = ell_blocked_prepare(_port(ja), 3, relabel_cols=True, binary=True)
    x = np.zeros((jp["n_pad"], 128), np.float32)
    x[:, :5] = np.random.default_rng(5).random((jp["n_pad"], 5))
    want = np.asarray(jblk.spmm_ell_blocked(ja, jnp.asarray(x), prep=jp,
                                            op="max", interpret=True))
    got = spmm_ell_blocked(_port(ja), torch.from_numpy(x), prep=tp, op="max")
    np.testing.assert_array_equal(got.numpy(), want)


def test_ell_fold_rejects_bad_inputs():
    tp = ell_blocked_prepare(_port(_graph("s7")), 1)
    args = [tp["cols"].t(), tp["vals"].t(), tp["run_start"], tp["run_len"],
            torch.zeros((tp["n_pad"], 4))]
    with pytest.raises(ValueError):
        ell_fold(*args, bs_c=tp["bs_c"], op="min")
    bad = list(args)
    bad[0] = tp["cols"]                     # (8, P) view, not (P, 8)
    with pytest.raises(ValueError):
        ell_fold(*bad, bs_c=tp["bs_c"])
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(TypeError):
        ell_fold(*bad, bs_c=tp["bs_c"])
    bad = list(args)
    bad[2] = tp["run_start"].long()
    with pytest.raises(TypeError):
        ell_fold(*bad, bs_c=tp["bs_c"])


def _ragged():
    """A sparse (600, 500) with power-law row degrees, one hub row of 400
    entries and a third of the rows empty, on the CPU."""
    rng = np.random.default_rng(0)
    m, n = 600, 500
    deg = np.minimum(rng.zipf(1.6, m), n // 4)
    deg[rng.random(m) < 0.33] = 0
    deg[m // 2] = int(n * 0.8)
    rows = np.repeat(np.arange(m), deg)
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in deg])
    return TCOO.from_arrays(rows, cols, rng.random(rows.size) + 0.25, (m, n),
                            device="cpu")


def _piece_plan(kind, nb):
    ta = _ragged() if kind == "ragged" else _port(_graph(kind))
    sq = ta.shape[0] == ta.shape[1]
    return ell_blocked_prepare(ta, nb, relabel_cols=sq, binary=sq)


def _piece_positions(plan, pieces):
    """(piece, group, cb, position) of every position of every piece, each
    piece walking on from its first position into its group's later runs."""
    rs, rl = plan["run_start"].numpy(), plan["run_len"].numpy()
    nb = rs.shape[1]
    out = []
    for i, (run, p, left, _out) in enumerate(pieces.table.numpy().tolist()):
        g, cb = divmod(run, nb)
        while True:
            stop = min(rs[g, cb] + rl[g, cb], p + left)
            out += [(i, g, cb, q) for q in range(p, stop)]
            left -= stop - p
            if left <= 0:
                break
            cb += 1
            p = rs[g, cb]
    return np.array(out, dtype=np.int64).reshape(-1, 4)


@pytest.mark.parametrize("kind,nb", [("s9sym", 3), ("rect", 1), ("rect", 3),
                                     ("ragged", 1), ("ragged", 3)])
@pytest.mark.parametrize("piece_len", [1, 7, 1 << 20])
def test_ell_pieces_cover_every_run_once(kind, nb, piece_len):
    """Every run's positions lie in exactly one piece, a group's pieces
    (in tile order) walk its runs in order, no piece is longer than L or
    empty, the longest come first, and ``folds`` lists exactly the groups
    of other than one piece with their consecutive tiles."""
    plan = _piece_plan(kind, nb)
    rs, rl = plan["run_start"].numpy(), plan["run_len"].numpy()
    groups = rs.shape[0]
    pieces = ell_pieces(plan["run_start"], plan["run_len"], piece_len)
    t = pieces.table.numpy()
    assert pieces.piece_len == piece_len
    assert ((t[:, 2] >= 1) & (t[:, 2] <= piece_len)).all()
    assert (np.diff(t[:, 2]) <= 0).all()
    pos = _piece_positions(plan, pieces)
    assert len(pos) == t[:, 2].sum() == rl.sum()
    # by group, then a group's pieces in tile order (a lone piece: -1)
    by_piece = pos[np.lexsort((np.arange(len(pos)), t[pos[:, 0], 3],
                               pos[:, 1]))]
    want = [(g, cb, q) for g in range(groups) for cb in range(nb)
            for q in range(rs[g, cb], rs[g, cb] + rl[g, cb])]
    np.testing.assert_array_equal(by_piece[:, 1:], np.array(want).reshape(
        -1, 3))
    count = np.bincount(t[:, 0] // nb, minlength=groups)
    if piece_len < 1 << 20:
        assert count.max() > 1      # the hub group is split
    folds = pieces.folds.numpy()
    np.testing.assert_array_equal(folds[:, 0], np.nonzero(count != 1)[0])
    np.testing.assert_array_equal(folds[:, 2],
                                  np.where(count > 1, count, 0)[folds[:, 0]])
    assert pieces.tiles == folds[:, 2].sum()
    assert ((t[:, 3] < 0) == (count[t[:, 0] // nb] == 1)).all()
    for g, first, k in folds:
        outs = np.sort(t[t[:, 0] // nb == g, 3])
        np.testing.assert_array_equal(outs, np.arange(first, first + k))
    if piece_len == 1 << 20:     # nothing split: every live group one piece
        assert pieces.tiles == 0
        assert (folds[:, 2] == 0).all()
    # the plan carries the table at the default length
    dflt = ell_pieces(plan["run_start"], plan["run_len"])
    assert torch.equal(plan["pieces"].table, dflt.table)
    assert torch.equal(plan["pieces"].folds, dflt.folds)


@pytest.mark.parametrize("kind,nb", [("s9sym", 3), ("rect", 3),
                                     ("ragged", 1), ("ragged", 3)])
@pytest.mark.parametrize("piece_len", [1, 7, 1 << 20])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_ell_fold_by_pieces_matches_plain(kind, nb, piece_len, op):
    """The kernel's two passes on the plain side: each piece folded alone
    (float32 products, a float64 sum or a float32 max from 0), written to
    Y or to its tile, then each split group's tiles folded in piece order,
    equal one ``ell_fold_plain`` call: max exact, sum rtol 1e-5."""
    plan = _piece_plan(kind, nb)
    pieces = ell_pieces(plan["run_start"], plan["run_len"], piece_len)
    d, bs_c = 8, plan["bs_c"]
    x = np.random.default_rng(piece_len).random((plan["n_pad"], d)).astype(
        np.float32)
    cols, vals = plan["cols"].t().numpy(), plan["vals"].t().numpy()
    pos = _piece_positions(plan, pieces)
    prod = vals[pos[:, 3]][..., None] * x[pos[:, 2][:, None] * bs_c
                                          + cols[pos[:, 3]]]
    n = pieces.table.shape[0]
    if op == "sum":
        acc = np.zeros((n, 8, d))
        np.add.at(acc, pos[:, 0], prod.astype(np.float64))
    else:
        acc = np.zeros((n, 8, d), np.float32)
        np.maximum.at(acc, pos[:, 0], prod)
    groups = plan["run_start"].shape[0]
    y = np.full((groups, 8, d), np.nan, np.float32)
    tiles = np.full((pieces.tiles, 8, d), np.nan, acc.dtype)
    for i, (run, _p, _len, out) in enumerate(pieces.table.numpy().tolist()):
        if out < 0:
            y[run // nb] = acc[i]
        else:
            tiles[out] = acc[i]
    for g, first, k in pieces.folds.numpy().tolist():
        comb = np.zeros((8, d), acc.dtype)
        for j in range(first, first + k):
            comb = comb + tiles[j] if op == "sum" else np.maximum(comb,
                                                                  tiles[j])
        y[g] = comb
    want = ell_fold_plain(plan["cols"].t(), plan["vals"].t(),
                          plan["run_start"], plan["run_len"],
                          torch.from_numpy(x), bs_c=bs_c, op=op).numpy()
    got = y.reshape(-1, d)
    assert not np.isnan(got).any()
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # and the CPU route ignores the table
    np.testing.assert_array_equal(
        ell_fold(plan["cols"].t(), plan["vals"].t(), plan["run_start"],
                 plan["run_len"], torch.from_numpy(x), bs_c=bs_c, op=op,
                 pieces=pieces).numpy(), want)


def test_default_piece_len():
    """A plan's positions over the 1584 pieces the card folds at once
    (132 SMs x 24 warps / 2 warps a piece), from 64 to 1024; a plan's
    table is cut at it."""
    assert piece_len_for(0) == piece_len_for(65 * 1584 - 1) == 64
    assert piece_len_for(300 * 1584 + 5) == 300
    assert piece_len_for(1024 * 1584) == piece_len_for(1 << 40) == 1024
    assert PIECE_LEN == 1024
    plan = _piece_plan("ragged", 1)
    assert plan["pieces"].piece_len == 64
    assert int(plan["pieces"].table[:, 2].max()) == 64


def test_ell_pieces_rejects_bad_length():
    plan = _piece_plan("rect", 1)
    with pytest.raises(ValueError):
        ell_pieces(plan["run_start"], plan["run_len"], 0)


def test_ell_fold_rejects_pieces_of_other_runs():
    """A piece table is taken only with the run table it was cut from: the
    plan's table beside a run table with its longest group emptied (the
    profiler's bulk), or beside an equal copy, is refused on either
    device; beside the plan's own tensors it is taken."""
    plan = _piece_plan("ragged", 3)
    rs, rl = plan["run_start"], plan["run_len"]
    glen = rl.sum(1, keepdim=True)
    bulk = torch.where(glen == glen.max(), 0, rl).contiguous()
    x = torch.rand((plan["n_pad"], 8), generator=torch.Generator()
                   .manual_seed(0))
    fold = functools.partial(ell_fold, plan["cols"].t(), plan["vals"].t(),
                             x=x, bs_c=plan["bs_c"], op="sum")
    for runs in ((rs, bulk), (rs.clone(), rl), (rs, rl.clone())):
        with pytest.raises(ValueError, match="another run table"):
            fold(*runs, pieces=plan["pieces"])
    torch.testing.assert_close(fold(rs, rl, pieces=plan["pieces"]),
                               fold(rs, rl), rtol=0, atol=0)
