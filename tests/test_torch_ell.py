"""Port ELL-8 plans and fold (``ops/spmm_ell.py``, ``ops/spmm_ell_blocked.py``,
``ops/kernels/ell.py``) vs the JAX package's ``spmm_ell`` (K6) and
``spmm_ell_blocked`` (K7), run in interpret mode on shared numpy inputs.

Plans must be equal array for array.  The max fold is exact (order-free);
the sum fold adds in another order than the TPU kernel (which sums per run
and then into Y), so it is held to rtol 1e-5."""

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
from combblas_tpu_torch.ops.kernels.ell import ell_fold  # noqa: E402
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
