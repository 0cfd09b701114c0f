"""The port's classed streamed digest (``ops/spgemm_seg.py``) against a
plain float64 A² (``tests/ref_a2_digest.py``) on symmetrized SSCA R-MATs,
the kernels through their plain versions on the CPU.  No JAX here.

nnz is exact.  The checksum is held within a relative 1e-6: every value,
product and entry of these C is an integer, but the program adds each
slab's C in float32 and the slabs' sums in float32 in slab order, which
rounds once a running sum passes 2^24; the reference sums in float64.
A product dropped or changed by 1 moves a scale-9 checksum by more than
that (its total is below 10^6).  The signed sum (odd columns negated) is
held within 1e-6 of C's Frobenius norm: it rounds as the checksum does,
and a value put under another column of its row moves it by an integer,
more than that at these sizes."""

import pytest
import torch

from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
from combblas_tpu_torch.ops import spgemm_seg as tseg
from combblas_tpu_torch.ops.kernels.expand import KEY_SENTINEL
from combblas_tpu_torch.ops.spgemm import SpGEMMSortLimitError
from ref_a2_digest import a2_digest

RTOL = 1e-6


def _ssca(scale: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return rmat_matrix(gen, scale, edgefactor=8, symmetrize=True,
                       remove_self_loops=True, probs=SSCA_PROBS)


def _ref(a):
    nnz = int(a.nnz)
    return a2_digest(a.row[:nnz], a.col[:nnz], a.val[:nnz], a.shape[0])


def _holds(got, ref) -> bool:
    nnz, checksum, truncated, signed = got
    return (not truncated and nnz == ref[0]
            and abs(checksum - ref[1]) <= RTOL * abs(ref[1])
            and abs(signed - ref[2]) <= RTOL * ref[3] ** 0.5)


@pytest.mark.parametrize("scale,num_slabs,seed",
                         [(9, 4, 1), (10, 7, 2), (11, 16, 3)])
def test_digest_equals_the_plain_product(scale, num_slabs, seed):
    a = _ssca(scale, seed)
    prep = tseg.seg_prepare(a, a, num_slabs)
    assert len(prep[0]["bounds"]) - 1 >= 4
    assert len(prep[0]["classes"]) >= 6
    got = tseg.spgemm_streamed_seg(a, a, prep=prep)
    ref = _ref(a)
    assert got[0] == ref[0] and got[2] is False
    assert abs(got[1] - ref[1]) <= RTOL * abs(ref[1]), (got, ref)
    assert abs(got[3] - ref[2]) <= RTOL * ref[3] ** 0.5, (got, ref)


def test_held_plan_equals_a_fresh_one_bit_for_bit():
    a = _ssca(10, 4)
    fresh = tseg.spgemm_streamed_seg(a, a, num_slabs=6)
    prep = tseg.seg_prepare(a, a, 6)
    held = [tseg.spgemm_streamed_seg(a, a, prep=prep) for _ in range(2)]
    assert held[0] == held[1] == fresh


@pytest.mark.parametrize("kw", [{"num_slabs": 5}, {"num_slabs": 6},
                                {"slab_out_cap": 1 << 20},
                                {"slab_out_cap": "the plan's"}, {}])
def test_disagreeing_arguments_are_refused(kw):
    """A held plan takes no slab count or output capacity, even one equal
    to its own; without a plan the slab count is needed."""
    a = _ssca(9, 5)
    prep = None if not kw else tseg.seg_prepare(a, a, 6)
    if kw.get("slab_out_cap") == "the plan's":
        kw = {"slab_out_cap": prep[4]}
    match = "pass neither" if kw else "needs num_slabs or prep"
    with pytest.raises(ValueError, match=match):
        tseg.spgemm_streamed_seg(a, a, prep=prep, **kw)


def _planted(fault):
    """K1's wrapper with one fault in the first slab's stream: its first
    product dropped (key to the sentinel, value 0) or its value raised
    by 1."""
    real = tseg.expand_chunks_compact
    done = []

    def expand(*args, **kwargs):
        col, val, total = real(*args, **kwargs)
        if not done and int(total) > 0:
            done.append(True)
            col, val = col.clone(), val.clone()
            if fault == "dropped":
                col[0], val[0] = KEY_SENTINEL[col.dtype], 0.0
            else:
                val[0] += 1.0
        return col, val, total
    return expand


def _ungathered(val2d, dim, perm, *, out):
    """``torch.gather`` that skips the window sort's permutation: every
    row keeps its values, each under another column of the row."""
    return out.copy_(val2d)


@pytest.mark.parametrize("fault", ["dropped", "changed", "ungathered"])
def test_planted_faults_are_caught(fault, monkeypatch):
    a = _ssca(9, 6)
    ref = _ref(a)
    assert abs(ref[1]) < 1e6            # a product is > 1e-6 of the sum
    prep = tseg.seg_prepare(a, a, 4)
    good = tseg.spgemm_streamed_seg(a, a, prep=prep)
    assert _holds(good, ref)
    if fault == "ungathered":
        monkeypatch.setattr(torch, "gather", _ungathered)
    else:
        monkeypatch.setattr(tseg, "expand_chunks_compact", _planted(fault))
    bad = tseg.spgemm_streamed_seg(a, a, prep=prep)
    assert not _holds(bad, ref)
    if fault == "ungathered":           # only the signed sum sees it
        assert bad[:3] == good[:3] and bad[3] != good[3]


@pytest.mark.parametrize("longest", ["class sort", "slab stream"])
def test_plan_past_the_sort_limit_is_refused(longest, monkeypatch):
    """A class sort or slab stream longer than ``SORT_ELEM_LIMIT`` is
    refused when the plan is made, as on the other slab routes."""
    a = _ssca(9, 7)
    if longest == "slab stream":   # a stream longer than every class sort
        monkeypatch.setattr(tseg, "stream_capacity",
                            lambda flops, tile=tseg.TILE: 1 << 20)
    plan = tseg.seg_prepare(a, a, 4)[0]
    sorts = [sc * w for sc, w in zip(plan["s_caps"], plan["classes"])]
    n = max(sorts + [plan["stream_cap"]])
    assert (n == plan["stream_cap"]) == (longest == "slab stream")
    monkeypatch.setattr(tseg, "SORT_ELEM_LIMIT", n)
    tseg.seg_prepare(a, a, 4)
    monkeypatch.setattr(tseg, "SORT_ELEM_LIMIT", n - 1)
    with pytest.raises(SpGEMMSortLimitError,
                       match=f"seg {longest}.* of {n} elements"):
        tseg.seg_prepare(a, a, 4)
