"""CUDA kernels vs their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc (the kernels are built from
``combblas_tpu_torch/csrc`` at first use); without a card they skip.  Run
them on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_kernel_cases as cases  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops.kernels import (  # noqa: E402
    LAUNCHES,
    poison_allocator,
)
from combblas_tpu_torch.ops.kernels import compress as tcmp  # noqa: E402
from combblas_tpu_torch.ops.kernels import expand as texp  # noqa: E402

pytestmark = pytest.mark.gpu
SEMIRINGS = ["plus_times", "min_plus", "max_second", "or_and"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _csr(gen, rows, n, max_deg, dev):
    deg = torch.randint(0, max_deg + 1, (rows,), generator=gen)
    rp = torch.zeros(rows + 1, dtype=torch.int64)
    rp[1:] = torch.cumsum(deg, 0)
    nnz = int(rp[-1])
    col = torch.randint(0, n, (nnz,), generator=gen, dtype=torch.int32)
    val = torch.rand(nnz, generator=gen) + 0.5
    return rp.to(dev), col.to(dev), val.to(dev)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("wide", [False, True])
def test_expand_kernel_matches_plain(cuda, sr_name, wide):
    gen = torch.Generator().manual_seed(0)
    k, n, na = 5000, 7000, 20000
    b_rp, b_col, b_val = _csr(gen, k, n, 40, cuda)
    a_row = torch.sort(torch.randint(0, 3000, (na,), generator=gen,
                                     dtype=torch.int32))[0].to(cuda)
    a_col = torch.randint(0, k, (na,), generator=gen,
                          dtype=torch.int32).to(cuda)
    a_val = (torch.rand(na, generator=gen) - 0.5).to(cuda)
    valid = torch.arange(na, device=cuda) < na - 100
    fn = (texp.expand_chunks_compact_wide if wide
          else texp.expand_chunks_compact)
    stride = n + 1 if wide else 0
    sr = tsr.get_semiring(sr_name)
    args = (a_row, a_col, a_val, valid, b_rp, b_col, b_val, sr)
    tag = "expand_i64" if wide else "expand_i32"
    before = LAUNCHES[tag]
    key, val, total = fn(*args, stride=stride, stream_cap=1 << 20)
    torch.cuda.synchronize()
    assert LAUNCHES[tag] == before + 1
    pk, pv, ptotal = fn(*args, stride=stride, stream_cap=1 << 20, plain=True)
    assert LAUNCHES[tag] == before + 1
    assert int(total) == int(ptotal) > 0
    assert torch.equal(key, pk)
    assert torch.equal(val.view(torch.int32), pv.view(torch.int32))
    # saturating capacity: the prefix is kept, the rest dropped
    small = fn(*args, stride=stride, stream_cap=1000)
    assert torch.equal(small[0], pk[:1000]) and int(small[2]) == int(total)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_second"])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("out_cap", [1 << 20, 5000])
def test_compress_kernel_matches_plain(cuda, sr_name, wide, out_cap):
    gen = torch.Generator().manual_seed(1)
    s, w = 600, 1000
    lens = torch.randint(0, w, (s,), generator=gen)
    keys = torch.randint(0, 300, (s, w), generator=gen, dtype=torch.int32)
    j = torch.arange(w)[None, :]
    sent32 = torch.iinfo(torch.int32).max
    keys = torch.where(j < lens[:, None], keys, sent32)
    keys = torch.sort(keys, dim=1)[0].reshape(-1)
    vals = torch.rand(s * w, generator=gen) + 0.25
    if wide:
        row = torch.arange(s).repeat_interleave(w)
        keys = torch.where(keys == sent32, torch.iinfo(torch.int64).max,
                           row * 301 + keys.long())
        order = torch.sort(keys, stable=True)[1]
        keys, vals = keys[order], vals[order]
    keys, vals = keys.to(cuda), vals.to(cuda)
    sr = tsr.get_semiring(sr_name)
    fn = tcmp.compress_sorted_packed
    kw = dict(out_capacity=out_cap)
    if wide:
        fn = tcmp.compress_sorted_wide
        kw["stride"] = 301
    got = fn(keys, vals, sr, **kw)
    torch.cuda.synchronize()
    want = fn(keys, vals, sr, plain=True, **kw)
    nnz = int(got[-1])
    assert nnz == int(want[-1]) == min(nnz, out_cap)
    if out_cap == 5000:
        assert nnz == out_cap
    for g, p in zip(got[:-2], want[:-2]):
        assert torch.equal(g, p)
    if sr.add_kind == "sum":
        torch.testing.assert_close(got[-2], want[-2], rtol=1e-6, atol=0)
    else:
        assert torch.equal(got[-2], want[-2])


@pytest.mark.parametrize("cap", [123457, 300 * texp.CH])
@pytest.mark.parametrize("wide", [False, True])
def test_poisoned_blocks_come_back_to_the_outputs(cuda, wide, cap):
    """The allocator poisoning the edge-case tests rely on: after it, the
    outputs a wrapper allocates first read back the 0xA5 pattern, at a
    compacted stream's size and at a chunk-padded one's (K5: two outputs of
    one size)."""
    ksize = 8 if wide else 4
    kdt = torch.int64 if wide else torch.int32
    poison_allocator([cap * ksize, cap * 4], cuda)
    key = torch.empty(cap, dtype=kdt, device=cuda)
    val = torch.empty(cap, dtype=torch.float32, device=cuda)
    assert bool((key.view(torch.uint8) == 0xA5).all())
    assert bool((val.view(torch.uint8) == 0xA5).all())


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", cases.EXPAND_CASES)
def test_expand_edge_cases_on_card(cuda, name, wide):
    """K1/K3 against the plain version on the tiled design's edge cases (a
    B row of several tiles, 10^4 dead entries, B rows of 0, no products) at
    capacities that cut inside an entry, exceed the total or hold one slot:
    every slot, pads included, bit for bit, and the unclamped total."""
    case = cases.expand_case(name, texp.EXPAND_TILE)
    t = [torch.from_numpy(case[k]).to(cuda) for k in (
        "a_row", "a_col", "a_val", "a_valid", "b_rp", "b_col", "b_val")]
    fn = (texp.expand_chunks_compact_wide if wide
          else texp.expand_chunks_compact)
    ksize = 8 if wide else 4
    for sr_name in ("plus_times", "max_second"):
        sr = tsr.get_semiring(sr_name)
        for cap in cases.expand_caps(case):
            poison_allocator([cap * ksize, cap * 4], cuda)
            key, val, total = fn(*t, sr, stride=case["n"] + 1,
                                 stream_cap=cap)
            torch.cuda.synchronize()
            pk, pv, ptotal = fn(*t, sr, stride=case["n"] + 1,
                                stream_cap=cap, plain=True)
            assert int(total) == int(ptotal) == cases.expand_total(case)
            assert torch.equal(key, pk), (sr_name, cap)
            assert torch.equal(val.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", cases.COMPRESS_CASES)
def test_compress_edge_cases_on_card(cuda, name, wide):
    """K2/K4 against the plain version on the tiled design's edge cases
    (runs of 1, T-1, T, T+1, 5T around the tile edges, sentinels between
    runs, one run over the stream, n = 1, n not a multiple of T) at
    capacities with room, exactly nnz and cutting: every slot, pads
    included; keys and nnz exact, min and max bit for bit, sums within
    rtol 1e-6; and the same bits on a second run."""
    keys64, vals = cases.compress_case(name, tcmp.COMPRESS_TILE)
    nnz = cases.compress_nnz(keys64)
    key = torch.from_numpy(keys64 if wide else cases.as_int32(keys64))
    key, val = key.to(cuda), torch.from_numpy(vals).to(cuda)
    fn = (tcmp.compress_sorted_wide_keys if wide
          else tcmp.compress_sorted_packed)
    for sr_name in ("plus_times", "min_plus", "max_second"):
        sr = tsr.get_semiring(sr_name)
        for cap in cases.compress_caps(nnz):
            poison_allocator([cap * key.element_size(), cap * 4], cuda)
            gk, gv, gn = fn(key, val, sr, out_capacity=cap)
            torch.cuda.synchronize()
            pk, pv, pn = fn(key, val, sr, out_capacity=cap, plain=True)
            assert int(gn) == int(pn) == min(nnz, cap)
            assert torch.equal(gk, pk), (sr_name, cap)
            if sr.add_kind == "sum":
                torch.testing.assert_close(gv, pv, rtol=1e-6, atol=0)
            else:
                assert torch.equal(gv, pv)
            again = fn(key, val, sr, out_capacity=cap)
            assert torch.equal(again[1].view(torch.int32),
                               gv.view(torch.int32))


def test_compress_kernel_is_deterministic(cuda):
    """A long stream with long runs, folded twice: the same bits."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 2000, 1 << 20)).astype(np.int32)
    key = torch.from_numpy(keys).to(cuda)
    val = (torch.rand(1 << 20, generator=torch.Generator().manual_seed(3))
           .to(cuda))
    first = tcmp.compress_sorted_packed(key, val, tsr.PLUS_TIMES,
                                        out_capacity=4096)
    for _ in range(3):
        again = tcmp.compress_sorted_packed(key, val, tsr.PLUS_TIMES,
                                            out_capacity=4096)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1].view(torch.int32),
                           first[1].view(torch.int32))
        assert int(again[2]) == int(first[2]) == 2000


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
@pytest.mark.parametrize("shape", [(1000, 700), (70000, 40000)])
@pytest.mark.parametrize("out_cap", [1 << 16, 3000])
def test_sort_fold_matches_sort_compress(cuda, sr_name, shape, out_cap):
    """The 3D SUMMA's fold (``summa3d._sort_fold``) on the card: an
    unsorted stream with repeated keys and (m, n) pads between them, on
    packed keys (K2) and wide ones (K4), one launch each, against
    ``sort_compress`` on the CPU: rows, columns and nnz exact (saturated
    where ``out_cap`` is short), values within 1e-6 relative, and a second
    call the same bits."""
    from combblas_tpu_torch.ops.coo import sort_compress
    from combblas_tpu_torch.parallel.summa3d import _sort_fold

    m, n = shape
    rng = np.random.default_rng(11)
    base = rng.integers(0, [m, n], (5000, 2))
    pick = base[rng.integers(0, 5000, 1 << 16)]
    pad = rng.random(1 << 16) < 0.2
    i = torch.from_numpy(np.where(pad, m, pick[:, 0]).astype(np.int32))
    j = torch.from_numpy(np.where(pad, n, pick[:, 1]).astype(np.int32))
    v = torch.from_numpy(rng.random(1 << 16).astype(np.float32) + 0.5)
    sr = tsr.get_semiring(sr_name)
    want = sort_compress(i, j, v, int((~pad).sum()), shape, sr=sr,
                         out_capacity=out_cap)
    tag = "i32" if (m + 1) * (n + 1) < 1 << 31 else "i64"
    before = LAUNCHES[f"compress_{tag}"]
    got = _sort_fold(i.to(cuda), j.to(cuda), v.to(cuda),
                     int((~pad).sum()), shape, sr, out_cap)
    assert LAUNCHES[f"compress_{tag}"] == before + 1
    assert int(got.nnz) == int(want.nnz)
    assert torch.equal(got.row.cpu(), want.row)
    assert torch.equal(got.col.cpu(), want.col)
    np.testing.assert_allclose(got.val.cpu().numpy(), want.val.numpy(),
                               rtol=1e-6)
    again = _sort_fold(i.to(cuda), j.to(cuda), v.to(cuda),
                       int((~pad).sum()), shape, sr, out_cap)
    assert torch.equal(again.val.view(torch.int32),
                       got.val.view(torch.int32))


def test_seg2_slice_kernels_match_plain(cuda):
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.ops.spgemm_seg import (
        seg2_prepare,
        seg2_step,
        seg_zero_state,
    )

    gen = torch.Generator(device=cuda).manual_seed(5)
    a = rmat_matrix(gen, 12, 8, probs=SSCA_PROBS)
    prep = seg2_prepare(a, a, flops_cap=1 << 18, pad_cap=1 << 20)
    got = want = seg_zero_state(cuda)
    for s in range(len(prep[1]["slabs"])):
        got = seg2_step(a, prep, s, got)
        want = seg2_step(a, prep, s, want, plain=True)
    assert int(got[0]) == int(want[0]) and not got[2] and not want[2]
    assert abs(float(got[1]) - float(want[1])) <= 1e-5 * abs(float(want[1]))


def test_seg_slice_kernels_match_plain(cuda):
    """The classed seg digest of a scale-12 A² on the card, every slab from
    a zero state: K1 and K2 launched once a slab, nnz equal to the plain
    versions', checksums within 1e-5."""
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.ops.spgemm_seg import (
        seg_prepare,
        seg_step,
        seg_zero_state,
    )

    gen = torch.Generator(device=cuda).manual_seed(5)
    a = rmat_matrix(gen, 12, 8, probs=SSCA_PROBS)
    prep = seg_prepare(a, a, num_slabs=4)
    S = len(prep[0]["bounds"]) - 1
    before = dict(LAUNCHES)
    got = [seg_step(a, a, prep, s, seg_zero_state(cuda)) for s in range(S)]
    assert LAUNCHES["expand_i32"] - before["expand_i32"] == S
    assert LAUNCHES["compress_i32"] - before["compress_i32"] == S
    for s, g in enumerate(got):
        w = seg_step(a, a, prep, s, seg_zero_state(cuda), plain=True)
        assert int(g[0]) == int(w[0]) > 0 and not g[2] and not w[2], s
        assert abs(float(g[1]) - float(w[1])) <= 1e-5 * abs(float(w[1])), s


# K10, the window sort of the classed digest: poisoned outputs and scratch,
# compared slot for slot with its plain version (the value bits included)


def _poison_winsort(padded, stream_len, dev, wide=True):
    """Poisoned blocks for the window sort's class buffer and, with
    ``wide``, the stream-sized scratch of its passes."""
    sizes = [4 * padded, 4 * padded]
    poison_allocator(sizes + ([4 * stream_len] * 2 if wide else []), dev)


def _same_buffers(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def _winsort_slab_inputs(a, prep, s, dev):
    """Slab ``s`` of ``a``'s classed A²: its K1 stream and window table."""
    from combblas_tpu_torch.ops import spgemm_seg as tseg
    from combblas_tpu_torch.ops.spgemm import _slab_extract

    plan, b_rp, class_table, bounds, _cap = prep
    sub, _ = _slab_extract(a, a.shape[1], bounds, s,
                           span_cap=plan["span_cap"],
                           slab_nnz_cap=plan["slab_nnz_cap"])
    col, val, _total = texp.expand_chunks_compact(
        sub.row, sub.col, sub.val, sub.mask(), b_rp, a.col, a.val,
        tsr.PLUS_TIMES, stride=0, stream_cap=plan["stream_cap"])
    rowfl, row_start = tseg._row_flops_exact(sub, b_rp, plan["span_cap"])
    table = tseg._window_table(rowfl, row_start, class_table,
                               windows=sum(plan["s_caps"]),
                               span_cap=plan["span_cap"])
    return col, val, rowfl, row_start, table


@pytest.mark.parametrize("graph", ["ssca10", "ssca12", "ssca14", "ragged"])
def test_winsort_matches_plain_on_slabs(cuda, graph):
    """K10 on every slab of a classed A² (SSCA R-MATs at scales 10-14, and
    a power-law matrix with a hub row): the class buffer equals the plain
    version's and the seg step's own class sorts, slot for slot."""
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.ops import spgemm_seg as tseg
    from combblas_tpu_torch.ops.kernels import winsort as twin

    if graph == "ragged":
        a = _ragged_coo(3, 4096, 4096, cuda)
    else:
        gen = torch.Generator(device=cuda).manual_seed(11)
        a = rmat_matrix(gen, int(graph[4:]), 8, symmetrize=True,
                        remove_self_loops=True, probs=SSCA_PROBS)
    prep = tseg.seg_prepare(a, a, num_slabs=4)
    plan = prep[0]
    kw = dict(classes=plan["classes"], s_caps=plan["s_caps"])
    bits = twin.key_bits(a.shape[1])
    for s in range(len(plan["bounds"]) - 1):
        col, val, rowfl, row_start, table = _winsort_slab_inputs(a, prep, s,
                                                                 cuda)
        want = twin.window_sort_plain(col, val, table, **kw)
        wins = tseg._class_windows(col, val, rowfl, row_start,
                                   span_cap=plan["span_cap"], **kw)
        steps = [torch.sort(w[0], dim=1, stable=True) for w in wins]
        _same_buffers(want, (
            torch.cat([k.reshape(-1) for k, _p in steps]),
            torch.cat([torch.gather(w[1], 1, p).reshape(-1)
                       for w, (_k, p) in zip(wins, steps)])))
        col, val = col.clone(), val.clone()  # K10 overwrites the stream
        _poison_winsort(plan["padded"], col.shape[0], cuda)
        got = twin.window_sort(col, val, table, key_bits=bits, **kw)
        torch.cuda.synchronize()
        _same_buffers(got, want)


def _synthetic_windows(dev, windows, key_hi, seed):
    """A stream holding each window's products (row order shuffled, gaps
    between rows) and its table: ``windows`` is [(width, live), ...] with
    the widths ascending; keys below ``key_hi`` (a few values when it is
    small, so runs of equal keys cross tiles), values distinct."""
    rng = np.random.default_rng(seed)
    classes = sorted({w for w, _n in windows})
    s_caps = tuple(sum(1 for w, _n in windows if w == L) for L in classes)
    lens = np.array([n for _w, n in windows], np.int64)
    width = np.array([w for w, _n in windows], np.int64)
    start = np.zeros(len(windows), np.int64)
    pos = 0
    for i in rng.permutation(len(windows)):
        pos += int(rng.integers(0, 5))
        start[i] = pos if lens[i] else 0
        pos += int(lens[i])
    col = rng.integers(0, key_hi, pos + 7).astype(np.int32)
    val = (np.arange(pos + 7) + 0.5).astype(np.float32)
    dest = np.concatenate([[0], np.cumsum(width)[:-1]])
    table = tuple(torch.as_tensor(x, device=dev)
                  for x in (start, lens, dest, width))
    return (torch.as_tensor(col, device=dev), torch.as_tensor(val, device=dev),
            table, tuple(classes), s_caps)


_WINSORT_CASES = {
    # live counts on both sides of the narrow limit and at it
    "narrow_limit": [(12288, 12287), (16384, 16383), (16384, 9000),
                     (24576, 16384), (24576, 16385), (24576, 24575)],
    # dead windows in narrow and wide classes, and a dead wide class
    "dead": [(128, 0), (128, 5), (128, 0), (4096, 0), (4096, 3000),
             (32768, 0), (32768, 20000), (49152, 0)],
    # a class of one window, among others
    "one_window": [(192, 100), (192, 7), (1536, 1200), (2097152, 2000000),
                   (3145728, 0)],
    # many equal keys from different A entries, a run crossing the tiles
    "equal_keys": [(256, 200), (16384, 16000), (262144, 250000)],
    # live counts that are whole tiles (WINSORT_TILE = 16384) and not
    "tile_multiple": [(512, 1), (24576, 16384), (24576, 20000),
                      (49152, 32768), (65536, 49152), (65536, 49153)],
}


@pytest.mark.parametrize("key_bits", [7, 12, 22, 31])
@pytest.mark.parametrize("case", sorted(_WINSORT_CASES))
def test_winsort_cases_match_plain(cuda, case, key_bits):
    """K10 on hand-made windows, at 1, 2, 3 and 4 passes of the wide
    sort: the class buffer equals the plain version's slot for slot (the
    equal keys keep their stream order: the values tell them apart)."""
    from combblas_tpu_torch.ops.kernels import winsort as twin

    key_hi = 3 if case == "equal_keys" else (1 << key_bits) - 1
    col, val, table, classes, s_caps = _synthetic_windows(
        cuda, _WINSORT_CASES[case], key_hi, seed=key_bits)
    kw = dict(classes=classes, s_caps=s_caps)
    before = dict(LAUNCHES)  # the plain run launches nothing
    want = twin.window_sort(col, val, table, key_bits=key_bits, plain=True,
                            **kw)
    _same_buffers(want, twin.window_sort_plain(col, val, table, **kw))
    padded = sum(S * L for S, L in zip(s_caps, classes))
    col, val = col.clone(), val.clone()  # K10 overwrites the stream
    _poison_winsort(padded, col.shape[0], cuda)
    got = twin.window_sort(col, val, table, key_bits=key_bits, **kw)
    torch.cuda.synchronize()
    _same_buffers(got, want)
    groups = twin.regimes(classes, s_caps)
    assert LAUNCHES["winsort_wide"] - before["winsort_wide"] == sum(
        cap is None for cap, _w0, _w1 in groups)
    # one narrow launch per width range of NARROW_CAPS that holds windows
    assert LAUNCHES["winsort_narrow"] - before["winsort_narrow"] == sum(
        cap is not None for cap, _w0, _w1 in groups)


def test_winsort_refuses_what_it_cannot_sort(cuda):
    """8-byte values and key widths outside [1, 31] are refused on the
    card."""
    from combblas_tpu_torch.ops.kernels import winsort as twin

    col, val, table, classes, s_caps = _synthetic_windows(
        cuda, [(128, 10)], 100, seed=1)
    kw = dict(classes=classes, s_caps=s_caps)
    with pytest.raises(TypeError, match="4 bytes"):
        twin.window_sort(col, val.double(), table, key_bits=7, **kw)
    for bits in (0, 32):
        with pytest.raises(ValueError, match="key_bits"):
            twin.window_sort(col, val, table, key_bits=bits, **kw)


def test_seg_step_takes_the_window_sort_kernel(cuda, monkeypatch):
    """A scale-12 classed digest on the card (its hub rows take windows
    past the narrow limit): each slab launches K10's narrow kernel once per
    width range and its wide sort once, calls no ``torch.sort(dim=1)``, and
    gives the digest of the same step with the window sort's plain version
    in K10's place, bit for bit."""
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.ops import spgemm_seg as tseg
    from combblas_tpu_torch.ops.kernels import winsort as twin

    gen = torch.Generator(device=cuda).manual_seed(5)
    a = rmat_matrix(gen, 12, 8, symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    prep = tseg.seg_prepare(a, a, num_slabs=4)
    plan = prep[0]
    S = len(plan["bounds"]) - 1
    assert plan["classes"][0] <= twin.NARROW_MAX < plan["classes"][-1]
    real_sort = torch.sort
    row_sorts = []

    def sort(x, *args, **kwargs):
        if x.dim() > 1:  # a sort along dim 1
            row_sorts.append(tuple(x.shape))
        return real_sort(x, *args, **kwargs)

    monkeypatch.setattr(torch, "sort", sort)
    before = dict(LAUNCHES)
    got = [tseg.seg_step(a, a, prep, s, tseg.seg_zero_state(cuda))
           for s in range(S)]
    torch.cuda.synchronize()
    assert row_sorts == []
    narrow = sum(cap is not None for cap, _w0, _w1 in twin.regimes(
        plan["classes"], plan["s_caps"]))
    assert narrow >= 1
    assert LAUNCHES["winsort_narrow"] - before["winsort_narrow"] == S * narrow
    assert LAUNCHES["winsort_wide"] - before["winsort_wide"] == S
    monkeypatch.setattr(torch, "sort", real_sort)
    monkeypatch.setattr(
        tseg, "window_sort",
        lambda col, val, table, *, key_bits, plain, **kw:
            twin.window_sort_plain(col, val, table, **kw))
    for s, g in enumerate(got):
        want = tseg.seg_step(a, a, prep, s, tseg.seg_zero_state(cuda))
        assert int(g[0]) == int(want[0]) > 0, s
        for i in (1, 3):
            assert torch.equal(g[i].view(torch.int32),
                               want[i].view(torch.int32)), (s, i)
        assert bool(g[2]) == bool(want[2]) is False


@pytest.mark.parametrize("key_bits", [17, 20])
@pytest.mark.parametrize("key64", [False, True])
@pytest.mark.parametrize("case", sorted(cases.ROW_SORT_CASES))
def test_row_window_sort_cases_match_library_sort(cuda, case, key64,
                                                  key_bits):
    """K10 keyed by row on hand-made K1 (int32) and K3 (int64) streams:
    rows in every narrow width range and past it, empty rows, rows of one
    product, repeated columns (stability across wide tiles) and the
    sentinel tail.  The stream, sorted in place, equals ``torch.sort``
    and the value gather slot for slot, in one call of the wrapper."""
    from combblas_tpu_torch.ops.kernels import winsort as twin

    d = cases.row_sort_case(case, key64, key_bits)
    key = torch.from_numpy(d["key"]).to(cuda)
    val = torch.from_numpy(d["val"]).to(cuda)
    skey, order = torch.sort(key, stable=True)
    want = (skey, val[order])
    before = dict(LAUNCHES)
    got = twin.row_window_sort(key, val, rows=d["rows"], stride=d["stride"],
                               key_bits=key_bits)
    torch.cuda.synchronize()
    assert got[0] is key and got[1] is val
    _same_buffers(got, want)
    assert LAUNCHES["winsort_rows"] == before["winsort_rows"] + 1


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("graph", ["ssca12", "ssca14", "ragged"])
def test_row_window_sort_matches_library_sort_on_slabs(cuda, graph, wide):
    """K10 keyed by row on every slab's K1 / K3 stream of an A² slab plan
    (SSCA R-MATs, and a power-law matrix with a hub row past the narrow
    limit): equal to ``torch.sort`` and the value gather slot for slot."""
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.ops import spgemm as tsp
    from combblas_tpu_torch.ops.kernels import winsort as twin

    if graph == "ragged":
        a = _ragged_coo(3, 4096, 4096, cuda)
    else:
        gen = torch.Generator(device=cuda).manual_seed(11)
        a = rmat_matrix(gen, int(graph[4:]), 8, symmetrize=True,
                        remove_self_loops=True, probs=SSCA_PROBS)
    bounds, span_cap, slab_nnz_cap, _ch, worst_fl = tsp._pallas_slab_plan(
        a, a, 4, wide=wide)
    bounds = torch.as_tensor(bounds.astype(np.int64), device=cuda)
    b_rp = a.row_ptr()
    n = a.shape[1]
    fn = (texp.expand_chunks_compact_wide if wide
          else texp.expand_chunks_compact)
    for s in range(bounds.shape[0] - 1):
        sub, _lo = tsp._slab_extract(a, n, bounds, s, span_cap=span_cap,
                                     slab_nnz_cap=slab_nnz_cap)
        key, val, _total = fn(sub.row, sub.col, sub.val, sub.mask(), b_rp,
                              a.col, a.val, tsr.PLUS_TIMES, stride=n + 1,
                              stream_cap=tsp.stream_capacity(worst_fl))
        skey, order = torch.sort(key, stable=True)
        want = (skey, val[order])
        got = twin.row_window_sort(key, val, rows=span_cap, stride=n + 1,
                                   key_bits=twin.key_bits(n))
        torch.cuda.synchronize()
        _same_buffers(got, want)


@pytest.mark.parametrize("max_flops_cap", [1 << 22, 1 << 27])
def test_spgemm_auto_slabs_take_the_row_window_sort(cuda, max_flops_cap):
    """A scale-16 SSCA R-MAT's A² through ``spgemm_auto`` under a slab
    plan, packed keys (K1) at the small cap and wide keys (K3) at the
    large one: C equals the plain run's entry for entry, and every slab's
    expansion sort launched the row-window sort; the plain run launches
    none (it keeps ``torch.sort``)."""
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.ops import spgemm as tsp

    gen = torch.Generator(device=cuda).manual_seed(16)
    a = rmat_matrix(gen, 16, 8, symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    plan = {}
    before = dict(LAUNCHES)
    c = tsp.spgemm_auto(a, a, max_flops_cap=max_flops_cap, plan=plan)
    torch.cuda.synchronize()
    assert plan["kind"] == "pallas_slabs"
    assert plan["wide"] == (max_flops_cap > 1 << 22)
    slabs = len(tsp._pallas_slab_plan(a, a, plan["num_slabs"],
                                      wide=plan["wide"])[0]) - 1
    tag = "i64" if plan["wide"] else "i32"
    sorts = LAUNCHES["winsort_rows"] - before["winsort_rows"]
    assert sorts > 0 and sorts % slabs == 0
    assert sorts == LAUNCHES[f"expand_{tag}"] - before[f"expand_{tag}"]
    rows_before = LAUNCHES["winsort_rows"]
    want = tsp.spgemm_pallas_rowchunked(a, a, num_slabs=plan["num_slabs"],
                                        out_capacity=plan["out_cap"],
                                        wide=plan["wide"], plain=True)
    assert LAUNCHES["winsort_rows"] == rows_before
    assert int(c.nnz) == int(want.nnz) > 0
    for g, w in ((c.row, want.row), (c.col, want.col), (c.val, want.val)):
        assert torch.equal(g, w)


def _ragged_coo(seed, m, n, dev):
    """A sparse (m, n) with power-law row degrees, one hub row, and a third
    of the rows empty (so degree-sorted groups at the tail are empty)."""
    import numpy as np

    from combblas_tpu_torch.ops.coo import SpCOO

    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, m), n // 4)
    deg[rng.random(m) < 0.33] = 0
    deg[m // 2] = int(n * 0.8)                     # the hub row
    rows = np.repeat(np.arange(m), deg)
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in deg])
    vals = rng.random(rows.size) + 0.25
    return SpCOO.from_arrays(rows, cols, vals, (m, n), device=dev)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("d", [5, 8, 100, 128, 260])
@pytest.mark.parametrize("piece_len", [None, 16, 1 << 30])
def test_ell_kernel_matches_plain(cuda, op, nb, d, piece_len):
    """The ELL kernel on the default piece table (built by the wrapper),
    on pieces of 16 positions (the hub group, 0.8 n positions, in many),
    and on pieces longer than any group (nothing split)."""
    from combblas_tpu_torch.ops.kernels.ell import ell_fold, ell_pieces
    from combblas_tpu_torch.ops.spmm_ell_blocked import ell_blocked_prepare

    relabel = op == "max"        # the BFS sweep's plan; sum: SpMM's
    a = _ragged_coo(nb * 1000 + d, 3000, 3000 if relabel else 2200, cuda)
    prep = ell_blocked_prepare(a, nb, relabel_cols=relabel, binary=relabel)
    assert int(prep["run_len"].sum(1).eq(0).sum()) > 0   # empty groups
    pieces = None
    if piece_len is not None:
        pieces = ell_pieces(prep["run_start"], prep["run_len"], piece_len)
        assert (pieces.tiles > 0) == (piece_len == 16)
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.rand((prep["n_pad"], d), generator=gen, device=cuda)
    args = (prep["cols"].t(), prep["vals"].t(), prep["run_start"],
            prep["run_len"], x)
    tag = f"ell_{op}"
    before = LAUNCHES[tag]
    got = ell_fold(*args, bs_c=prep["bs_c"], op=op, pieces=pieces)
    torch.cuda.synchronize()
    assert LAUNCHES[tag] == before + 1
    want = ell_fold(*args, bs_c=prep["bs_c"], op=op, plain=True)
    assert LAUNCHES[tag] == before + 1
    assert got.shape == want.shape == (prep["m_pad"], d)
    if op == "max":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("d", [8, 128])
def test_ell_kernel_every_group_split(cuda, op, d):
    """Pieces of one position on a plan whose every group holds at least
    two: no group is written directly, every one through pass 2."""
    import numpy as np

    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.ops.kernels.ell import ell_fold, ell_pieces
    from combblas_tpu_torch.ops.spmm_ell_blocked import ell_blocked_prepare

    rng = np.random.default_rng(d)
    n = 1992                     # m_pad = n at nb = 3: no padding group
    deg = rng.integers(2, 40, n)
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in deg])
    a = SpCOO.from_arrays(rows, cols, rng.random(rows.size) + 0.25, (n, n),
                          device=cuda)
    relabel = op == "max"
    prep = ell_blocked_prepare(a, 3, relabel_cols=relabel, binary=relabel)
    pieces = ell_pieces(prep["run_start"], prep["run_len"], 1)
    assert bool((pieces.table[:, 3] >= 0).all())
    assert pieces.folds.shape[0] == prep["m_pad"] // 8
    assert bool((pieces.folds[:, 2] >= 2).all())
    x = torch.rand((prep["n_pad"], d), device=cuda)
    args = (prep["cols"].t(), prep["vals"].t(), prep["run_start"],
            prep["run_len"], x)
    got = ell_fold(*args, bs_c=prep["bs_c"], op=op, pieces=pieces)
    want = ell_fold(*args, bs_c=prep["bs_c"], op=op, plain=True)
    if op == "max":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [5, 8, 128, 260])
@pytest.mark.parametrize("piece_len", [None, 16, 1 << 30])
def test_spmm_coo_kernel_matches_plain(cuda, d, piece_len):
    """K8 at the default range length, at 16 entries (the hub row, 0.8 n
    entries, cut into many ranges; most other rows cross a range bound),
    and with every row whole."""
    from combblas_tpu_torch.ops.spmm_kernel import (
        _spmm_coo,
        spmm_pallas,
    )

    a = _ragged_coo(d, 3000, 2500, cuda)
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.rand((2500, d), generator=gen, device=cuda)
    before = LAUNCHES["spmm_coo"]
    if piece_len is None:
        got = spmm_pallas(a, x)
    else:
        got = _spmm_coo(a.row_ptr(), a.col, a.val.float().contiguous(), x,
                        plain=False, piece_len=piece_len)
    torch.cuda.synchronize()
    assert LAUNCHES["spmm_coo"] == before + 1
    want = spmm_pallas(a, x, plain=True)
    assert LAUNCHES["spmm_coo"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not bool(got[a.row_ptr()[1:] == a.row_ptr()[:-1]].any())


def test_spmm_bfs_slice_on_card(cuda):
    """The slice's entry points on the card: spmm's kernel route against
    its gather route, and the ELL max-sweep BFS against the push BFS
    (K1) on a symmetrized R-MAT graph."""
    from combblas_tpu_torch.gen.rmat import rmat_matrix
    from combblas_tpu_torch.models.bfs import (
        bfs_batch_pull_big,
        bfs_push_local,
        validate_bfs,
    )
    from combblas_tpu_torch.ops.spmm_ell_blocked import spmm_ell_blocked
    from combblas_tpu_torch.ops.spmv import spmm

    gen = torch.Generator(device=cuda).manual_seed(3)
    a = rmat_matrix(gen, 12, 16)
    x = torch.rand((a.shape[1], 64), generator=gen, device=cuda)
    ref = spmm(a, x)
    torch.testing.assert_close(spmm(a, x, use_kernel=True), ref, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(spmm_ell_blocked(a, x, nb=3), ref, rtol=1e-5,
                               atol=1e-5)
    g = rmat_matrix(gen, 12, 16, symmetrize=True, remove_self_loops=True)
    rp = g.row_ptr()
    roots = torch.nonzero(rp[1:] > rp[:-1])[:3, 0].tolist()
    before = LAUNCHES["ell_max"]
    p, lv = bfs_batch_pull_big(g, roots, nb=3)
    assert LAUNCHES["ell_max"] - before == int(lv.max()) + 1
    for i, r in enumerate(roots):
        pp, pl = bfs_push_local(g, r)
        assert torch.equal(lv[i], pl)
        assert torch.equal(p[i], pp)
        assert validate_bfs(g, r, p[i], lv[i])


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "max_second"])
@pytest.mark.parametrize("chunk_cap", [None, 64])
def test_expand_chunks_kernel_matches_plain(cuda, sr_name, chunk_cap):
    """K5 on ragged B rows (0, 1, 127, 128, 129 entries and a hub row of
    5000), dead A entries, and dummy chunks past the last live one (or, at
    chunk_cap 64, chunks past the capacity dropped): exact."""
    gen = torch.Generator().manual_seed(7)
    lengths = torch.tensor([0, 1, 127, 128, 129, 5000])
    deg = torch.cat([lengths, torch.randint(0, 300, (400,), generator=gen)])
    k, n = deg.shape[0], 6000
    b_rp = torch.zeros(k + 1, dtype=torch.int64)
    b_rp[1:] = torch.cumsum(deg, 0)
    b_col = torch.randint(0, n, (int(b_rp[-1]),), generator=gen,
                          dtype=torch.int32)
    b_val = torch.rand(b_col.shape[0], generator=gen) + 0.5
    na = 3000
    a_row = torch.sort(torch.randint(0, 300, (na,), generator=gen,
                                     dtype=torch.int32))[0]
    a_col = torch.randint(0, k, (na,), generator=gen, dtype=torch.int32)
    a_col[:len(lengths)] = torch.arange(len(lengths), dtype=torch.int32)
    a_val = torch.rand(na, generator=gen) - 0.5
    valid = torch.arange(na) < na - 50
    args = [t.to(cuda) for t in (a_row, a_col, a_val, valid, b_rp, b_col,
                                 b_val)]
    cnt = (b_rp[a_col.long() + 1] - b_rp[a_col.long()])[valid]
    chunks = int((-(-cnt // 128)).sum())
    cap = chunks + 100 if chunk_cap is None else chunk_cap
    sr = tsr.get_semiring(sr_name)
    before = LAUNCHES["expand_chunks_i32"]
    key, val = texp.expand_chunks(*args, sr, stride=n + 1, chunk_cap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES["expand_chunks_i32"] == before + 1
    pk, pv = texp.expand_chunks(*args, sr, stride=n + 1, chunk_cap=cap,
                                plain=True)
    assert LAUNCHES["expand_chunks_i32"] == before + 1
    assert key.shape == (cap * 128,)
    assert torch.equal(key, pk)
    assert torch.equal(val.view(torch.int32), pv.view(torch.int32))
    if chunk_cap is None:         # the 100 dummy chunks are all pads
        assert bool((key[chunks * 128:] == torch.iinfo(torch.int32).max)
                    .all())


@pytest.mark.parametrize("name", cases.EXPAND_CASES)
def test_expand_chunks_edge_cases_on_card(cuda, name):
    """K5 against the plain version on the edge cases cut at its own tile
    (a hub B row of 5 tiles' worth of chunks taken by several A entries,
    10^4 dead entries and 3000 on empty B rows, no products) at chunk
    capacities past the last live chunk, of 16 and of 1, and one that cuts
    inside a hub entry: every slot after poisoning, pads and dummy chunks
    included, bit for bit."""
    case = cases.expand_case(name, texp.EXPAND_CHUNKS_TILE * texp.CH)
    t = [torch.from_numpy(case[k]).to(cuda) for k in (
        "a_row", "a_col", "a_val", "a_valid", "b_rp", "b_col", "b_val")]
    for sr_name in ("plus_times", "max_second"):
        sr = tsr.get_semiring(sr_name)
        for cap in cases.expand_chunk_caps(case) + [1]:
            poison_allocator([cap * texp.CH * 4] * 2, cuda)
            before = LAUNCHES["expand_chunks_i32"]
            key, val = texp.expand_chunks(*t, sr, stride=case["n"] + 1,
                                          chunk_cap=cap)
            torch.cuda.synchronize()
            assert LAUNCHES["expand_chunks_i32"] == before + 1
            pk, pv = texp.expand_chunks(*t, sr, stride=case["n"] + 1,
                                        chunk_cap=cap, plain=True)
            assert torch.equal(key, pk), (sr_name, cap)
            assert torch.equal(val.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("route", ["k5", "k1"])
def test_spgemm_pallas_on_card_matches_plain(cuda, route):
    """Both narrow routes of spgemm_pallas on the card against the plain
    run, slot for slot (integer values: exact sums)."""
    from combblas_tpu_torch.gen.rmat import rmat_matrix
    from combblas_tpu_torch.ops.spgemm import (
        spgemm_flops,
        spgemm_pallas,
        spgemm_pallas_bounds,
        stream_capacity,
    )

    gen = torch.Generator(device=cuda).manual_seed(11)
    a = rmat_matrix(gen, 11, 16)
    chunk_cap, out_cap = spgemm_pallas_bounds(a, a)
    kw = dict(chunk_cap=chunk_cap, out_capacity=out_cap)
    if route == "k1":
        kw["stream_cap"] = stream_capacity(spgemm_flops(a, a))
    tag = "expand_chunks_i32" if route == "k5" else "expand_i32"
    before = dict(LAUNCHES)
    got = spgemm_pallas(a, a, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[tag] == before[tag] + 1
    assert LAUNCHES["compress_i32"] == before["compress_i32"] + 1
    want = spgemm_pallas(a, a, plain=True, **kw)
    assert int(got.nnz) == int(want.nnz) > 0
    for g, w in ((got.row, want.row), (got.col, want.col),
                 (got.val, want.val)):
        assert torch.equal(g, w)


def test_spgemm_auto_takes_the_kernel_route(cuda):
    """A product too wide for packed keys in one pass: spgemm_auto runs
    slabs on the expansion and compress kernels, once a slab, and agrees
    with the plain run of the same slabs."""
    from combblas_tpu_torch.gen.rmat import rmat_matrix
    from combblas_tpu_torch.ops.spgemm import (
        _pallas_slab_plan,
        spgemm_auto,
        spgemm_pallas_rowchunked,
    )

    gen = torch.Generator(device=cuda).manual_seed(13)
    a = rmat_matrix(gen, 16, 2)      # (m+1)*(n+1) >= 2^31: no single pass
    plan = {}
    before = dict(LAUNCHES)
    c = spgemm_auto(a, a, max_flops_cap=1 << 20, plan=plan)
    torch.cuda.synchronize()
    assert plan["kind"] == "pallas_slabs"
    tag = "i64" if plan["wide"] else "i32"
    slabs = len(_pallas_slab_plan(a, a, plan["num_slabs"],
                                  wide=plan["wide"])[0]) - 1
    launched = LAUNCHES[f"expand_{tag}"] - before[f"expand_{tag}"]
    assert launched > 0 and launched % slabs == 0
    assert (LAUNCHES[f"compress_{tag}"] - before[f"compress_{tag}"]
            == launched)
    want = spgemm_pallas_rowchunked(a, a, num_slabs=plan["num_slabs"],
                                    out_capacity=plan["out_cap"],
                                    wide=plan["wide"], plain=True)
    assert int(c.nnz) == int(want.nnz) > 0
    for g, w in ((c.row, want.row), (c.col, want.col), (c.val, want.val)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("axis", ["r", "c"])
@pytest.mark.parametrize("grid", [(1, 1), (1, 8), (4, 4), (2, 3)])
@pytest.mark.parametrize("payload", [(13,), (8,), (1000,), (4096,), ()])
def test_ring_shift_kernel_matches_plain(cuda, axis, grid, payload):
    """K9 on int32, float32 and int64 stacks at once (one launch), ragged
    and 16-byte block lengths, both axes: bit for bit its plain version."""
    from combblas_tpu_torch.ops.kernels.ring import ring_shift

    gen = torch.Generator().manual_seed(5)
    shape = grid + payload
    srcs = [torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                          dtype=torch.int32).to(cuda),
            torch.randn(shape, generator=gen).to(cuda),
            torch.randint(-2**62, 2**62, shape, generator=gen,
                          dtype=torch.int64).to(cuda)]
    before = LAUNCHES["ring_shift"]
    got = ring_shift(srcs, [axis] * 3)
    torch.cuda.synchronize()
    assert LAUNCHES["ring_shift"] == before + 1
    want = ring_shift(srcs, [axis] * 3, plain=True)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    if grid == (1, 8) and axis == "c":   # device d receives from d - 1
        assert torch.equal(got[0][0, 3], srcs[0][0, 2])


def _grid_operands(cuda, grid_side, scale=10):
    from combblas_tpu_torch.gen.rmat import rmat_matrix
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import ProcGrid

    gen = torch.Generator(device=cuda).manual_seed(17)
    a = rmat_matrix(gen, scale, 16)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        g = ProcGrid.make(grid_side, grid_side, device=dev)
        out[dev.type] = DistSpMat.from_local(a, g)
    return out


def _same_blocks(got, want):
    assert int(got.total_nnz()) == int(want.total_nnz()) > 0
    for f in ("row", "col", "val", "nnz"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f))


@pytest.mark.parametrize("side", [2, 4])
def test_summa_rma_on_card_matches_plain(cuda, side):
    """The ring SUMMA on the card launches K9 p - 1 times and equals the
    CPU run (the plain ring push) block for block (integer values)."""
    from combblas_tpu_torch.parallel.rma import summa_spgemm_rma
    from combblas_tpu_torch.parallel.summa import summa_bounds

    ops = _grid_operands(cuda, side)
    fc, oc = summa_bounds(ops["cuda"], ops["cuda"])
    before = LAUNCHES["ring_shift"]
    got = summa_spgemm_rma(ops["cuda"], ops["cuda"], stage_flops_cap=fc,
                           out_capacity=oc)
    torch.cuda.synchronize()
    assert LAUNCHES["ring_shift"] == before + side - 1
    want = summa_spgemm_rma(ops["cpu"], ops["cpu"], stage_flops_cap=fc,
                            out_capacity=oc)
    _same_blocks(got, want)


@pytest.mark.parametrize("impl", ["pallas", "wide"])
def test_summa_kernel_routes_on_card_match_plain(cuda, impl):
    """summa_spgemm's kernel routes launch the expansion and compress once
    a block and equal the CPU run (the plain versions) block for block."""
    from combblas_tpu_torch.parallel.summa import (
        summa_bounds,
        summa_chunk_bound,
        summa_spgemm,
    )

    ops = _grid_operands(cuda, 2)
    fc, oc = summa_bounds(ops["cuda"], ops["cuda"])
    kw = dict(flops_cap=fc, out_capacity=oc, impl=impl,
              chunk_cap=summa_chunk_bound(ops["cuda"], ops["cuda"], fc))
    tag = "i64" if impl == "wide" else "i32"
    before = dict(LAUNCHES)
    got = summa_spgemm(ops["cuda"], ops["cuda"], **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[f"expand_{tag}"] == before[f"expand_{tag}"] + 4
    assert LAUNCHES[f"compress_{tag}"] == before[f"compress_{tag}"] + 4
    _same_blocks(got, summa_spgemm(ops["cpu"], ops["cpu"], **kw))


def _local_op_cases():
    """The local ops of the MCL slice, each a function of a SpCOO on some
    device, returning tensors or a SpCOO."""
    import torch as t

    from combblas_tpu_torch.models import cc, mcl
    from combblas_tpu_torch.ops import ewise, indexing, kselect, reduce
    from combblas_tpu_torch.semiring import MAX_FIRST, MIN_PLUS

    def other(a):
        return ewise.apply_values(indexing.remove_loops(a), lambda v: v * 2)

    return {
        "reduce_sum": lambda a: reduce.reduce_dim(a, "col"),
        "reduce_min": lambda a: reduce.reduce_dim(a, "row", MIN_PLUS),
        "reduce_max": lambda a: reduce.reduce_dim(a, "col", MAX_FIRST),
        "nnz_per": lambda a: reduce.nnz_per(a, "row"),
        "prune": lambda a: ewise.prune(a, lambda v: v < 1.5),
        "ewise_union": lambda a: ewise.add(a, other(a)),
        "ewise_intersect": lambda a: ewise.ewise_mult(a, other(a)),
        "set_difference": lambda a: ewise.set_difference(a, other(a)),
        "col_rank": kselect.col_rank,
        "kselect_col": lambda a: kselect.kselect_col(a, 3),
        "select_top_k": lambda a: kselect.select_top_k_per_col(a, 2),
        "fastsv": cc.fastsv_local,
        "stochastic": mcl.make_col_stochastic,
        "chaos": lambda a: mcl.chaos(mcl.make_col_stochastic(a)),
        "mcl_prune": lambda a: mcl._mcl_prune(
            mcl.make_col_stochastic(a),
            mcl.MCLParams(select=3, recover_num=5, cutoff=0.2), a.capacity),
        "spref": lambda a: indexing.spref(a, [5, 1, 1, 40], [0, 7, 7, 63]),
        "induced_subgraph": lambda a: indexing.induced_subgraph(
            a, t.arange(0, 64, 3)),
        "add_loops": indexing.add_loops,
        "prune_ktips": lambda a: indexing.prune_ktips(a, 4),
    }


@pytest.mark.parametrize("name", sorted(_local_op_cases()))
def test_local_ops_on_card_match_cpu(cuda, name):
    """Each local op on CUDA tensors equals the same call on CPU tensors:
    structure exact, values within 1e-6 (sums fold in other orders)."""
    from combblas_tpu_torch.ops.coo import SpCOO

    rng = np.random.default_rng(21)
    d = (rng.random((64, 64)) < 0.1) * rng.integers(1, 4, (64, 64))
    d = np.maximum(d, d.T).astype(np.float32)
    r, c = np.nonzero(d)
    fn = _local_op_cases()[name]
    got, want = (fn(SpCOO.from_arrays(r, c, d[r, c], d.shape, device=dev))
                 for dev in (cuda, "cpu"))
    if isinstance(want, SpCOO):
        assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
        assert torch.equal(got.row.cpu(), want.row)
        assert torch.equal(got.col.cpu(), want.col)
        got, want = got.val, want.val
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_mcl_card_matches_cpu(cuda):
    """chip_smoke's phase-15 card-against-CPU MCL run at scale 10: the same
    iterations, nnz per iteration and labels, and each step redone on the
    CPU from the card's iterate within 1e-5; the card run goes through the
    expansion and compress kernels (single pass, K1 and K2) at least once
    an iteration, which the call itself holds and returns.  Select 72, not
    64: at this scale a select-64 iterate passes its capacity (select a
    column, as the JAX package sizes it) and the runs part."""
    import chip_smoke

    out = chip_smoke.mcl_card_vs_cpu(
        5, cuda, scale=10, params=dict(select=72, recover_num=80))
    assert out["iters"] >= 3
    for name in ("expand_i32", "compress_i32"):
        assert out["launches"][name] >= out["iters"]


def test_mcl_prune_pad_heavy_on_card_matches_cpu(cuda):
    """``_mcl_prune`` on a CUDA input whose buffer holds 40 slots a live
    entry (the expansion's share in the benchmark's MCL), values in steps
    of 1/256 so that ties straddle the select and recovery ranks, equals
    the same call on CPU tensors: keys and values exact, nnz counted past
    the output's capacity."""
    from combblas_tpu_torch.models import mcl
    from combblas_tpu_torch.ops.coo import SpCOO

    rng = np.random.default_rng(23)
    n = 3000
    d = rng.random((n, n)) < 0.02
    r, c = np.nonzero(d)
    v = np.round(rng.random(r.size) * 256) / 256
    p = mcl.MCLParams(select=12, recover_num=16, cutoff=0.85)
    for out_cap in (1 << 16, 20000):
        got, want = (mcl._mcl_prune(SpCOO.from_arrays(
            r, c, v.astype(np.float32), (n, n), capacity=40 * r.size,
            device=dev), p, out_cap) for dev in (cuda, "cpu"))
        assert got.device.type == "cuda"
        assert int(got.nnz) == int(want.nnz) > 0
        assert torch.equal(got.row.cpu(), want.row)
        assert torch.equal(got.col.cpu(), want.col)
        assert torch.equal(got.val.cpu().view(torch.int32),
                           want.val.view(torch.int32))
    assert int(want.nnz) > 20000


def test_dist_graph_phase_on_card(cuda):
    """chip_smoke's phase 17 at scale 12: on a 4x4 block grid of the card,
    ``dist_spmv`` against ``torch.sparse.mm`` and ``spmv``, both
    distributed BFS variants validated with ``bfs_local``'s levels,
    ``fastsv_dist`` and ``lacc_dist`` against ``fastsv_local`` and scipy,
    and a valid ``luby_mis_dist`` (the call holds each)."""
    import chip_smoke
    from card_inputs import bfs_roots, spmm_bfs_graphs
    from combblas_tpu_torch.models.bfs import bfs_local

    s = spmm_bfs_graphs(3, cuda, 12)["s"]
    roots = bfs_roots(s, 3)[:chip_smoke.DIST_BFS_ROOTS]
    levels = torch.stack([bfs_local(s, int(r))[1] for r in roots])
    out = chip_smoke.dist_graph_full(s, roots, levels, 3)
    assert len(out["bfs"]) == 2 * len(roots)
    assert any(r["pull_levels"] for r in out["bfs"])


def test_mcl_dist_phase_on_card(cuda):
    """chip_smoke's phase 18 main runs at scale 12 on the 4x4 grid: K1 and
    K2 each iteration, every iterate, the first expansion and prune and
    the labels checked; a 2-phase run whose every step equals the 1-phase
    step from the same iterate but for tie flips at a column's threshold,
    and whose third iterate differs from the 1-phase run's in at most 1 %
    of the columns (the call holds each)."""
    import chip_smoke

    a = chip_smoke.mcl_graph(4, cuda, 12)
    local = dict(iters=0, clusters=0, steady_secs_per_iter=0.0,
                 peak_mem_gb=0.0)
    out = chip_smoke.mcl_dist_full(a, 4, local)
    assert out["iters"] >= 3 and out["checked_run"]["same_as_timed"]
    assert len(out["phases2"]["steps"]) == chip_smoke.MCL_PHASES_ITERS
    for name in ("expand_i32", "compress_i32"):
        assert out["launches"][name] >= out["iters"]


def test_mcl_dist_card_matches_cpu(cuda):
    """chip_smoke's phase-18 card-against-CPU run at scale 10: iterations,
    nnz per iteration and labels equal, each step redone on the CPU within
    1e-5, the 3D route's partition equal (the call holds each)."""
    import chip_smoke

    out = chip_smoke.mcl_dist_card_vs_cpu(5, cuda, scale=10)
    assert out["iters"] >= 3
    for name in ("expand_i32", "compress_i32"):
        assert out["launches"][name] >= out["iters"]


def test_vector_layer_on_card_matches_numpy(cuda):
    """chip_smoke's phase-19 vector checks at 2^16 elements on a 4x4 grid
    of the card: both sorts equal the host order on (key, index) with
    -0.0, +0.0 and NaNs among the values; RandPerm, invert, uniq, gather
    and every route combine equal numpy, and every call repeats bit for
    bit (a float ``sum`` and duplicate ``set`` slots included)."""
    import chip_smoke
    from combblas_tpu_torch.parallel.grid import ProcGrid

    grid = ProcGrid.make(4, 4, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    out = chip_smoke.check_sorts(grid, gen, log2=16)
    assert out["n"] == 1 << 16
    out = chip_smoke.check_vectors(grid, gen, n=(1 << 16) - 5)
    assert out["n_pad"] == 1 << 16


@pytest.mark.parametrize("fold", [False, True])
def test_dist_permute_is_deterministic_on_card(cuda, fold):
    """``dist_permute`` on the card: a random permutation of a scale-12
    graph equals the host relabelling, repeats bit for bit and inverts
    (chip_smoke's phase-19 check); a map folding pairs of vertices (the
    sums of duplicates) repeats bit for bit and equals the CPU's stacks,
    values within 1e-6."""
    import chip_smoke
    from card_inputs import spmm_bfs_graphs
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import ProcGrid
    from combblas_tpu_torch.parallel.indexing import dist_permute

    s = spmm_bfs_graphs(8, cuda, 12)["s"]
    if not fold:
        out = chip_smoke.permute_full(s, 8)
        assert out["nnz"] == int(s.nnz)
        return
    n = s.shape[0]
    fmap = torch.arange(n, device=cuda) // 2
    dm = DistSpMat.from_local(s, ProcGrid.make(4, 4, device=cuda))
    vals = torch.rand(dm.val.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1))
    dm = DistSpMat(row=dm.row, col=dm.col, val=vals, nnz=dm.nnz,
                   gshape=dm.gshape, grid=dm.grid)
    a, b = dist_permute(dm, fmap), dist_permute(dm, fmap)
    assert torch.equal(a.val.view(torch.int32), b.val.view(torch.int32))
    host = chip_smoke._dist_host_copy(dm)
    c = dist_permute(host, fmap.cpu())
    for f in ("row", "col", "nnz"):
        assert torch.equal(getattr(a, f).cpu(), getattr(c, f))
    torch.testing.assert_close(a.val.cpu(), c.val, rtol=1e-6, atol=0)


def test_dist_indexing_phase_on_card(cuda):
    """chip_smoke's phase 19 indexing at scale 12 on the 4x4 grid:
    ``dist_spref`` equal to ``spref``, the block prune and ``dist_spasgn``
    to the host's, both products on the expansion and compress kernels
    (the call holds each)."""
    import chip_smoke

    out = chip_smoke.dist_indexing_full(chip_smoke.mcl_graph(4, cuda, 12), 4)
    assert out["launches"].get("expand_i32", 0) >= 2


def test_mcl_preprocess_phase_on_card(cuda):
    """chip_smoke's phase 20 at scale 12 on the 4x4 grid: labels checked,
    equal to the hand-composed preprocessing and to a second run; then
    the card against the CPU at scale 10 with one CPU generator."""
    import chip_smoke

    out = chip_smoke.mcl_preprocess_full(chip_smoke.mcl_graph(4, cuda, 12),
                                         4)
    assert out["isolated"] > 0 and out["iters"] >= 3
    out = chip_smoke.mcl_preprocess_card_vs_cpu(5, cuda, scale=10)
    assert out["iters"] >= 3


def test_orderings_and_bc_phase_on_card(cuda):
    """chip_smoke's phase 21 at small sizes: both RCM orders of a 16^3
    stencil equal the host Cuthill-McKee of their rules, within 3 k^2;
    ``md_order_dist`` equals ``md_order`` on a 10x10 stencil; BC local
    and distributed agree on a scale-12 graph, and the card the CPU."""
    import chip_smoke
    from card_inputs import spmm_bfs_graphs

    out = chip_smoke.rcm_full(3, cuda, k=16)
    assert out["bandwidth"]["rcm_order_dist"] <= 3 * 16 ** 2
    chip_smoke.md_full(cuda, k=10)
    chip_smoke.bc_full(spmm_bfs_graphs(3, cuda, 12)["s"], 3)
    chip_smoke.bc_card_vs_cpu(3, cuda, scale=10)


def test_galerkin_card_matches_cpu(cuda):
    """``restriction_op`` of a 10^3 stencil (6 / -1) with one CPU generator
    gives the same R on the card and on the CPU, and ``galerkin`` on the
    card (K1 and K2, launches read around it) equals the CPU's R·A·Rᵀ
    exactly (integer sums)."""
    import chip_smoke
    from combblas_tpu_torch.models.multigrid import galerkin, restriction_op
    from combblas_tpu_torch.ops.coo import SpCOO
    from combblas_tpu_torch.ops.kernels import reset_launches

    k = 10
    host = [x.cpu().numpy() for x in chip_smoke.mg_stencil(k, "cpu")]
    a_card, a_cpu = (SpCOO.from_arrays(*host, (k ** 3, k ** 3), device=dev)
                     for dev in (cuda, "cpu"))
    r_card, r_cpu = (restriction_op(a, torch.Generator().manual_seed(7))
                     for a in (a_card, a_cpu))
    for f in ("row", "col", "val", "nnz"):
        assert torch.equal(getattr(r_card, f).cpu(), getattr(r_cpu, f))
    reset_launches()
    got = galerkin(r_card, a_card)
    torch.cuda.synchronize()
    assert LAUNCHES["expand_i32"] >= 1 and LAUNCHES["compress_i32"] >= 1
    want = galerkin(r_cpu, a_cpu)
    n = int(want.nnz)
    assert int(got.nnz) == n
    for f in ("row", "col", "val"):
        assert torch.equal(getattr(got, f)[:n].cpu(), getattr(want, f)[:n])


def test_matching_phase_on_card(cuda):
    """chip_smoke's phase 22 at scale 12 on a 4x4 grid: every matching
    checked on the host, the maximum ones against scipy, the grid results
    equal to the local ones; AWPM's weight against linear_sum_assignment
    at scale 9 (the call holds each)."""
    import chip_smoke

    out = chip_smoke.matching_full(3, cuda, scale=12, weight_scale=9)
    assert out["bp_maximum_matching"]["cardinality"] == out["scipy_maximum"]
    assert out["dist_bp_maximum"]["levels"] >= 1


def test_multigrid_phase_on_card(cuda):
    """chip_smoke's phase 23 at 16^3 on a 4x4 grid and 12^3 locally:
    MIS-2 checked on the host, R's aggregates, both Galerkin products
    equal to scipy's, the local R card against CPU (the call holds
    each)."""
    import chip_smoke

    out = chip_smoke.multigrid_full(3, cuda, k=16, local_k=12)
    assert out["restriction_op_dist"]["ncoarse"] > 0
    assert out["launches"].get("expand_i32", 0) >= 1


def test_semantic_io_cli_phase_on_card(cuda, monkeypatch, tmp_path):
    """chip_smoke's phase 24 on a scale-12 graph: the filtered subgraphs,
    BFS (local and 4x4, validated) and MIS, the block-streamed I/O at
    scale 12 and every CLI line against its library call (the call holds
    each; files under ``tmp_path``)."""
    import chip_smoke
    from card_inputs import bfs_roots, spmm_bfs_graphs

    monkeypatch.setattr(chip_smoke, "IO_SCALE", 12)
    monkeypatch.setattr(chip_smoke, "CLI_MCL_SCALE", 9)
    monkeypatch.chdir(tmp_path)
    s = spmm_bfs_graphs(3, cuda, 12)["s"]
    out = chip_smoke.semantic_io_cli_full(s, bfs_roots(s, 3)[:4], 3)
    assert 0.15 < out["passing_share"] < 0.35
    assert set(out["cli"]["lines"]) >= {"gen", "spgemm", "mcl", "galerkin"}


_POD_WORKER = r"""
import sys
import torch
from combblas_tpu_torch.ops.kernels import LAUNCHES
from combblas_tpu_torch.ops.kernels.ring import ring_shift
from combblas_tpu_torch.parallel import exchange
from combblas_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   pod_grid)

addr, rank, what = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_multihost(addr, 2, rank)
dev = torch.device("cuda", 0)
g = pod_grid(pr=2, pc=2, device=dev)          # one block row a process
if what == "ring":
    gen = torch.Generator().manual_seed(5 + rank)
    for payload in [(13,), (4096,), ()]:
        shape = (1, 2) + payload
        srcs = [torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                              dtype=torch.int32).to(dev),
                torch.randn(shape, generator=gen).to(dev),
                torch.randint(-2**62, 2**62, shape, generator=gen,
                              dtype=torch.int64).to(dev)]
        for axes in (["r"] * 3, ["c"] * 3, ["r", "c", "r"]):
            before = dict(LAUNCHES)
            got = ring_shift(srcs, axes, grid=g)
            assert LAUNCHES["ring_shift"] == before["ring_shift"] + 1
            assert LAUNCHES["ring_shift_pod"] == before["ring_shift_pod"] + (
                "r" in axes)
            want = ring_shift(srcs, axes, grid=g, plain=True)
            # fresh tensors: the next hops' pushes into both ring slots
            # leave them as they were
            ring_shift(srcs[::-1], axes[::-1], grid=g)
            ring_shift(srcs[::-1], axes[::-1], grid=g)
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
elif what == "mcl":
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.models.mcl import MCLParams, mcl_dist
    from combblas_tpu_torch.ops.coo import SpCOO, merge
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import ProcGrid
    from combblas_tpu_torch.semiring import PLUS_TIMES
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(11), 10, 8,
                    symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    a = merge(a, SpCOO.eye(a.shape[0], device=dev), PLUS_TIMES)
    p = MCLParams(select=64, recover_num=80)
    l1, i1 = mcl_dist(DistSpMat.from_local(
        a, ProcGrid.make(2, 2, device=dev)), p)
    l2, i2 = mcl_dist(DistSpMat.from_local(a, g), p)
    l2, = exchange.allgather_var([l2])
    assert i1 == i2 and torch.equal(l1, l2), (i1, i2)
elif what == "preprocess":
    import numpy as np
    from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix
    from combblas_tpu_torch.models.mcl import MCLParams, mcl_dist
    from combblas_tpu_torch.ops.coo import SpCOO, merge
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import ProcGrid
    from combblas_tpu_torch.parallel.indexing import dist_permute
    from combblas_tpu_torch.parallel.vector import dist_rand_perm, dist_uniq
    from combblas_tpu_torch.semiring import PLUS_TIMES
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(13), 10, 4,
                    symmetrize=True, remove_self_loops=True,
                    probs=SSCA_PROBS)
    rp = a.row_ptr()
    live = torch.nonzero(rp[1:] > rp[:-1]).squeeze(1).cpu().numpy()
    assert live.size < a.shape[0]          # isolated vertices stay empty
    a = merge(a, SpCOO.from_arrays(live, live, np.ones(live.size,
                                                       np.float32),
                                   a.shape, sum_duplicates=False,
                                   device=dev), PLUS_TIMES)
    n = a.shape[0]
    g1 = ProcGrid.make(2, 2, device=dev)
    one, pod = DistSpMat.from_local(a, g1), DistSpMat.from_local(a, g)

    def gen():
        return torch.Generator(device=dev).manual_seed(21)

    perm = dist_rand_perm(gen(), n, g1)
    got, = exchange.allgather_var([dist_rand_perm(gen(), n, g)])
    assert torch.equal(perm, got)
    # a permutation, and a map that folds duplicates (float sums)
    for rmap in (perm[:n], perm[:n] // 3):
        want, got = dist_permute(one, rmap), dist_permute(pod, rmap)
        assert torch.equal(got.nnz, want.nnz)
        for f in ("row", "col", "val"):
            assert torch.equal(getattr(got, f).view(torch.uint8),
                               getattr(want, f)[rank:rank + 1]
                               .view(torch.uint8)), f
    x = torch.randn(1 << 14, device=dev, generator=gen())
    x[::7] = x[3]                          # a run across the slices
    x[5::11] = -0.0
    mask = torch.rand(1 << 14, device=dev, generator=gen()) < 0.8
    lo, hi = g.vec_range(x.shape[0])
    u1, h1 = dist_uniq(x, mask, g1)
    u2, h2 = exchange.allgather_var(list(dist_uniq(x[lo:hi], mask[lo:hi],
                                                   g)))
    assert torch.equal(u1.view(torch.int32), u2.view(torch.int32))
    assert torch.equal(h1, h2)
    p = MCLParams(select=64, recover_num=80)
    l1, i1 = mcl_dist(one, p, preprocess=True, generator=gen())
    l2, i2 = mcl_dist(pod, p, preprocess=True, generator=gen())
    l2, = exchange.allgather_var([l2])
    assert i1 == i2 and torch.equal(l1, l2[:n]), (i1, i2)
    assert (l1 >= n).sum() == n - live.size
else:
    from combblas_tpu_torch.gen.rmat import rmat_matrix
    from combblas_tpu_torch.models.bfs import bfs_dist
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import ProcGrid
    from combblas_tpu_torch.parallel.rma import summa_spgemm_rma
    from combblas_tpu_torch.parallel.summa import (summa_bounds,
                                                   summa_spgemm_auto)
    from combblas_tpu_torch.parallel.vector import (_sortable_u32,
                                                    dist_sort_auto)
    a = rmat_matrix(torch.Generator(device=dev).manual_seed(17), 10, 16)
    one = DistSpMat.from_local(a, ProcGrid.make(2, 2, device=dev))
    pod = DistSpMat.from_local(a, g)
    fc, oc = summa_bounds(pod, pod)
    assert (fc, oc) == summa_bounds(one, one)
    for got, want in ((summa_spgemm_auto(pod, pod),
                       summa_spgemm_auto(one, one)),
                      (summa_spgemm_rma(pod, pod, stage_flops_cap=fc,
                                        out_capacity=oc),
                       summa_spgemm_rma(one, one, stage_flops_cap=fc,
                                        out_capacity=oc))):
        assert torch.equal(got.nnz, want.nnz)
        for f in ("row", "col", "val"):
            assert torch.equal(getattr(got, f),
                               getattr(want, f)[rank:rank + 1])
    s = rmat_matrix(torch.Generator(device=dev).manual_seed(3), 10, 16,
                    symmetrize=True, remove_self_loops=True)
    ps = DistSpMat.from_local(s, g)
    p1, l1 = bfs_dist(DistSpMat.from_local(
        s, ProcGrid.make(2, 2, device=dev)), 3)
    p2, l2 = exchange.allgather_var(list(bfs_dist(ps, 3)))
    assert torch.equal(p1, p2) and torch.equal(l1, l2)
    x = torch.randn(1 << 16, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    lo, hi = g.vec_range(x.shape[0])
    sx, sp = dist_sort_auto(x[lo:hi], g, torch.arange(lo, hi, device=dev))
    order = torch.sort(_sortable_u32(x), stable=True)[1][lo:hi]
    assert torch.equal(sp, order) and torch.equal(sx, x[order])
exchange.close()
torch.distributed.destroy_process_group()
print("POD_OK", rank, flush=True)
"""


def _run_pod_on_card(what: str) -> None:
    """Two processes on the one card, joined by ``gloo``, run
    ``_POD_WORKER``'s ``what``; the kernels are built here first, so that
    the workers only load them."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from combblas_tpu_torch.ops.kernels import _build

    _build.library()
    repo = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(repo)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _POD_WORKER, f"127.0.0.1:{port}", str(r),
         what], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "POD_OK" in out, out[-3000:]


def test_ring_shift_pod_matches_plain(cuda):
    """K9's cross-process form, 2 processes on the card (a 2x2 grid, one
    block row each: 'r' crosses, 'c' stays local), int32 / float32 /
    int64 stacks in one launch: bit for bit its ``gloo`` plain version,
    counted under ``ring_shift`` and, when it crossed, ``ring_shift_pod``."""
    _run_pod_on_card("ring")


def test_pod_mcl_on_card(cuda):
    """HipMCL's pod path on the card over 2 processes: ``mcl_dist`` of a
    scale-10 SSCA R-MAT with self loops gives one process's iterations
    and labels bit for bit."""
    _run_pod_on_card("mcl")


def test_pod_preprocess_on_card(cuda):
    """HipMCL's preprocessing on the card over 2 processes, on a scale-10
    SSCA R-MAT with isolated vertices: ``dist_rand_perm`` and
    ``dist_permute`` (by the permutation, and by a map that folds
    duplicates) equal one process's blocks bit for bit, ``dist_uniq`` with
    a run across the slices one process's vector, and
    ``mcl_dist(preprocess=True)`` one process's iterations and labels."""
    _run_pod_on_card("preprocess")


def test_pod_slice_on_card(cuda):
    """The pod slice on the card over 2 processes (CUDA IPC exchanges):
    ``summa_spgemm_auto`` and the ring SUMMA equal one process's blocks,
    ``bfs_dist`` one process's vectors, ``dist_sort_auto`` ``torch.sort``'s
    stable order, payload included."""
    _run_pod_on_card("slice")
