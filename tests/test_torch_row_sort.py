"""The row-window sort's precondition on the CPU.

On the card, the kernel routes of ``ops/spgemm.py`` sort a compacted
expansion stream (K1's packed int32 keys, K3's int64 keys) one row's
window at a time (``winsort.row_window_sort``, K10 keyed by row) instead
of with one ``torch.sort`` of the whole stream.  That gives the same
stream only because each row's products lie together, rows ascending,
each key in ``[row * stride, row * stride + n)``.  These tests hold the
plain K1/K3 streams of ``_pallas_slab_step``'s slabs, of a whole-matrix
pass and of SUMMA's row panel to that, with the windows that
``_row_flops_exact`` counts from A and B; the windows the sort finds in
the stream (``row_bounds``) to those; the launch shapes the wrapper takes
from the host's sizes to a count made from the streams; and every
internal caller of the kernel routes to A's live entries in row order.
The card tests (``test_torch_kernels_cuda.py``) hold the kernel to the
library sort slot for slot."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_kernel_cases as cases  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.gen.rmat import SSCA_PROBS, rmat_matrix  # noqa: E402
from combblas_tpu_torch.ops import spgemm as tsp  # noqa: E402
from combblas_tpu_torch.ops.coo import SpCOO  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
from combblas_tpu_torch.ops.kernels import expand as texp  # noqa: E402
from combblas_tpu_torch.ops.kernels import winsort as twin  # noqa: E402
from combblas_tpu_torch.ops.spgemm_seg import _row_flops_exact  # noqa: E402


def _ragged(seed, m, n):
    """Power-law row degrees, a third of the rows empty, one hub row."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, m), n // 4)
    deg[rng.random(m) < 0.33] = 0
    deg[m // 2] = int(n * 0.8)
    rows = np.repeat(np.arange(m), deg)
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in deg])
    return SpCOO.from_arrays(rows, cols, rng.random(rows.size) + 0.25,
                             (m, n), device="cpu")


def _graph(name):
    if name == "ragged":
        return _ragged(3, 2048, 2048)
    gen = torch.Generator().manual_seed(11)
    return rmat_matrix(gen, int(name[4:]), 8, symmetrize=True,
                       remove_self_loops=True, probs=SSCA_PROBS)


def _stream(a, b, b_rp, *, wide, stream_cap):
    """The plain K3 (``wide``) or K1 stream of A·B, keys row*(n+1)+col."""
    fn = (texp.expand_chunks_compact_wide if wide
          else texp.expand_chunks_compact)
    key, val, total = fn(a.row, a.col, a.val, a.mask(), b_rp, b.col, b.val,
                         tsr.PLUS_TIMES, stride=b.shape[1] + 1,
                         stream_cap=stream_cap)
    return key, val, int(total)


def _check_windows(key, total, a, b_rp, rows, n):
    """``_row_flops_exact``'s (row_start, rowfl) partition the live stream
    [0, total) in row order, every window's keys lie in [row * stride,
    row * stride + n), the slots past the products hold the key sentinel,
    and the sort's own windows, found in the stream, are these."""
    stride = n + 1
    rowfl, row_start = _row_flops_exact(a, b_rp, rows)
    assert int(rowfl.sum()) == total and int(rowfl[rows]) == 0
    assert int(row_start[0]) == 0
    assert torch.equal(row_start[1:], (row_start + rowfl)[:-1])
    row = torch.repeat_interleave(torch.arange(rows + 1), rowfl)
    col = key[:total].long() - row * stride
    assert bool(((col >= 0) & (col < n)).all())
    assert bool((key[total:] == texp.KEY_SENTINEL[key.dtype]).all())
    assert torch.equal(twin.row_bounds(key, rows, stride), row_start)
    return rowfl


def _check_shapes(rowfl, stream_len):
    """The wrapper's launch shapes bound the windows and tiles counted from
    the stream's rows."""
    shapes = twin.row_sort_shapes(rowfl.shape[0], stream_len)
    lo = (1,) + twin.NARROW_CAPS
    for g in range(3):
        got = int(((rowfl > lo[g]) & (rowfl <= lo[g + 1])).sum())
        assert got <= shapes["narrow"][g], (g, got, shapes)
    wide = rowfl[rowfl > twin.NARROW_MAX]
    assert wide.numel() <= shapes["wide"]
    assert int((-(-wide // twin.WINSORT_TILE)).sum()) <= shapes["tiles"]
    return shapes


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("graph", ["ssca10", "ssca12", "ragged"])
def test_slab_streams_hold_each_row_together(graph, wide):
    """Every slab of ``_pallas_slab_step``'s plan: the plain K1 / K3
    stream of the slab is partitioned by ``_row_flops_exact``'s windows,
    keys inside each row's range, and the sort finds those windows; the
    launch shapes bound its windows."""
    a = _graph(graph)
    bounds, span_cap, slab_nnz_cap, _ch, worst_fl = tsp._pallas_slab_plan(
        a, a, 4, wide=wide)
    stream_cap = tsp.stream_capacity(worst_fl)
    b_rp = a.row_ptr()
    bounds_dev = torch.as_tensor(bounds.astype(np.int64))
    n = a.shape[1]
    live = 0
    for s in range(len(bounds) - 1):
        sub, _lo = tsp._slab_extract(a, a.shape[1], bounds_dev, s,
                                     span_cap=span_cap,
                                     slab_nnz_cap=slab_nnz_cap)
        key, _val, total = _stream(sub, a, b_rp, wide=wide,
                                   stream_cap=stream_cap)
        rowfl = _check_windows(key, total, sub, b_rp, span_cap, n)
        _check_shapes(rowfl[:-1], key.shape[0])
        live += total
    assert live == tsp.spgemm_flops(a, a)


@pytest.mark.parametrize("wide", [False, True])
def test_whole_matrix_stream_holds_each_row_together(wide):
    """``spgemm_pallas`` / ``spgemm_wide`` of a whole matrix (the
    ``pallas`` route): the same partition over A's own rows."""
    a = _graph("ssca10")
    m, n = a.shape
    key, _val, total = _stream(a, a, a.row_ptr(), wide=wide,
                               stream_cap=tsp.stream_capacity(
                                   tsp.spgemm_flops(a, a)))
    rowfl = _check_windows(key, total, a, a.row_ptr(), m, n)
    _check_shapes(rowfl[:-1], key.shape[0])


def test_summa_panel_is_in_row_order():
    """SUMMA's A row panel: its live entries are the blocks' laid end to
    end, stably sorted by row (block order inside a row), columns shifted
    by block, pads after them; its K1 / K3 stream holds each row together,
    and C through both kernel routes is the dense product."""
    from combblas_tpu_torch.parallel import summa as tsum

    g, kb, mb, nb, cap = 3, 40, 50, 30, 512
    rng = np.random.default_rng(5)
    blocks = [SpCOO.from_dense(
        ((rng.random((mb, kb)) < 0.2) * (rng.random((mb, kb)) + 0.25))
        .astype(np.float32), capacity=cap, device="cpu") for _s in range(g)]
    pa = tsum._panel_a(*(torch.stack([getattr(x, f) for x in blocks])
                         for f in ("row", "col", "val", "nnz")), kb, mb)
    pb = SpCOO.from_dense(
        ((rng.random((g * kb, nb)) < 0.2)
         * (rng.random((g * kb, nb)) + 0.25)).astype(np.float32),
        device="cpu")
    nnz = int(pa.nnz)
    ends = [(x.row[:int(x.nnz)], x.col[:int(x.nnz)] + s * kb,
             x.val[:int(x.nnz)]) for s, x in enumerate(blocks)]
    row, col, val = (torch.cat([e[i] for e in ends]) for i in range(3))
    order = torch.sort(row, stable=True).indices
    assert torch.equal(pa.row[:nnz], row[order])
    assert torch.equal(pa.col[:nnz], col[order])
    assert torch.equal(pa.val[:nnz], val[order])
    assert bool((pa.row[nnz:] == mb).all() and (pa.col[nnz:] == g * kb).all())
    flops = int(tsp._entry_counts(pa, pb.row_ptr()).sum())
    want = (pa.to_dense().double() @ pb.to_dense().double()).float()
    for wide in (False, True):
        key, _val, total = _stream(pa, pb, pb.row_ptr(), wide=wide,
                                   stream_cap=tsp.stream_capacity(flops))
        _check_windows(key, total, pa, pb.row_ptr(), mb, nb)
        c = tsum._panel_multiply_pallas(pa, pb, tsr.PLUS_TIMES,
                                        flops_cap=flops, out_capacity=flops,
                                        chunk_cap=256, wide=wide)
        assert torch.allclose(c.to_dense(), want, rtol=1e-6)


@pytest.mark.parametrize("key_bits", [17, 20])
@pytest.mark.parametrize("key64", [False, True])
@pytest.mark.parametrize("case", sorted(cases.ROW_SORT_CASES))
def test_row_bounds_find_the_cases_rows(case, key64, key_bits):
    """The hand-made streams of the card tests (every width range, empty
    rows, repeated columns, the sentinel tail): the windows the sort finds
    are the cases' rows, ``key_bits`` covers their columns, and the launch
    shapes bound them."""
    d = cases.row_sort_case(case, key64, key_bits)
    key = torch.from_numpy(d["key"])
    assert twin.key_bits(d["n"]) == key_bits
    assert torch.equal(twin.row_bounds(key, d["rows"], d["stride"]),
                       torch.from_numpy(d["row_start"]))
    _check_shapes(torch.from_numpy(d["rowfl"][:-1]), key.shape[0])


def test_row_bounds_need_rows_in_order():
    """The windows rest on the precondition: in a stream whose rows 3 and
    4 trade places, the windows found are not the rows'."""
    d = cases.row_sort_case("ranges", False, 17)
    key = torch.from_numpy(d["key"])
    lo, mid, hi = (int(d["row_start"][r]) for r in (3, 4, 5))
    key = torch.cat([key[:lo], key[mid:hi], key[lo:mid], key[hi:]])
    bounds = twin.row_bounds(key, d["rows"], d["stride"])
    assert not torch.equal(bounds, torch.from_numpy(d["row_start"]))


def test_expand_sort_keeps_the_library_sort_on_the_cpu():
    """CPU tensors, ``plain=True`` and K5's stream keep ``torch.sort``:
    the sorted keys ascend and the row-window kernel is not launched."""
    a = _graph("ssca10")
    before = LAUNCHES["winsort_rows"]
    flops = tsp.spgemm_flops(a, a)
    scap = tsp.stream_capacity(flops)
    for kw in (dict(stream_cap=scap),
               dict(stream_cap=None,
                    chunk_cap=tsp.spgemm_pallas_bounds(a, a)[0]),
               dict(stream_cap=scap, wide=True, plain=True)):
        key, _val, _stride = tsp._expand_sort(a, a, tsr.PLUS_TIMES, **kw)
        assert bool((key[1:] >= key[:-1]).all())
    assert LAUNCHES["winsort_rows"] == before


def test_row_window_sort_refuses_what_it_cannot_sort():
    """Keys that are not int32 / int64, streams of two lengths, rows whose
    bases overflow the keys, key widths outside [1, 31] and CPU tensors
    (the library sort is the plain route) are refused."""
    d = cases.row_sort_case("ranges", False, 17)
    key, val = torch.from_numpy(d["key"]), torch.from_numpy(d["val"])
    kw = dict(rows=d["rows"], stride=d["stride"])
    with pytest.raises(TypeError, match="int32 or int64"):
        twin.row_window_sort(key.short(), val, key_bits=17, **kw)
    with pytest.raises(ValueError, match="one length"):
        twin.row_window_sort(key, val[:-1], key_bits=17, **kw)
    with pytest.raises(ValueError, match="overflow"):
        twin.row_window_sort(key, val, rows=1 << 16, stride=1 << 16,
                             key_bits=17)
    for bits in (0, 32):
        with pytest.raises(ValueError, match="key_bits"):
            twin.row_window_sort(key, val, key_bits=bits, **kw)
    with pytest.raises(ValueError, match="device cpu"):
        twin.row_window_sort(key, val, key_bits=17, **kw)


# -- every internal caller of the kernel routes --------------------------

def _witness_expand_sort(monkeypatch):
    """Wrap ``_expand_sort`` so that every compacted stream it sorts is
    checked as the card's row-window sort needs it: A's live rows ascend,
    and A·B's plain stream is partitioned by ``_row_flops_exact``'s
    windows (``_check_windows``).  Returns the list of checked A shapes."""
    seen = []
    real = tsp._expand_sort

    def checked(a, b, sr, *, stream_cap, wide=False, b_rp=None, **kw):
        if stream_cap is not None:
            rp = b.row_ptr() if b_rp is None else b_rp
            r = a.row[:int(a.nnz)]
            assert bool((r[1:] >= r[:-1]).all())
            key, _val, total = _stream(a, b, rp, wide=wide,
                                       stream_cap=stream_cap)
            _check_windows(key, total, a, rp, a.shape[0], b.shape[1])
            seen.append(a.shape)
        return real(a, b, sr, stream_cap=stream_cap, wide=wide, b_rp=b_rp,
                    **kw)

    monkeypatch.setattr(tsp, "_expand_sort", checked)
    return seen


def _key_wide():
    """50,000 x 50,000, 40,000 entries: packed keys overflow int32, so
    ``spgemm_auto`` takes row slabs."""
    rng = np.random.default_rng(9)
    m = 50_000
    return SpCOO.from_arrays(rng.integers(0, m, 40_000),
                             rng.integers(0, m, 40_000),
                             rng.random(40_000) + 0.25, (m, m),
                             dtype=np.float32, device="cpu")


def _auto_slabs(wide):
    a = _key_wide()
    plan = {}
    tsp.spgemm_auto(a, a, max_flops_cap=1 << 24 if wide else 1 << 10,
                    plan=plan)
    assert plan["kind"] == "pallas_slabs" and plan["wide"] == wide


def _dist(a):
    from combblas_tpu_torch.parallel.dist import DistSpMat
    from combblas_tpu_torch.parallel.grid import ProcGrid

    return DistSpMat.from_local(a, ProcGrid.make(2, 2, device="cpu"))


def _summa(a, impl):
    from combblas_tpu_torch.parallel import summa as tsum

    d = _dist(a)
    fc, oc = tsum.summa_bounds(d, d)
    tsum.summa_spgemm(d, d, flops_cap=fc, out_capacity=oc, impl=impl,
                      chunk_cap=tsum.summa_chunk_bound(d, d, fc))


def _staged(a):
    from combblas_tpu_torch.parallel import memefficient as tme
    from combblas_tpu_torch.parallel import summa as tsum

    d = _dist(a)
    fc, oc = tsum.summa_bounds(d, d)
    tme.summa_spgemm_staged(d, d, stage_flops_cap=fc, out_capacity=oc,
                            impl="pallas",
                            chunk_cap=tsum.summa_chunk_bound(d, d, fc))


def _mcl(a, dist):
    from combblas_tpu_torch.models import mcl as tmcl

    p = tmcl.MCLParams(max_iters=3)
    if dist:
        tmcl.mcl_dist(_dist(a), p, phases=2)
    else:
        tmcl.mcl_local(a, p)


def _galerkin(a, dist):
    from combblas_tpu_torch.models import multigrid as tmg

    gen = torch.Generator().manual_seed(1)
    if dist:
        d = _dist(a)
        tmg.galerkin_dist(tmg.restriction_op_dist(d, gen), d)
    else:
        tmg.galerkin(tmg.restriction_op(a, gen), a)


def _spref(a, dist):
    """Unsorted index vectors with repeats: Q's rows are ``ci``."""
    rng = np.random.default_rng(4)
    ri = rng.integers(0, a.shape[0], 60)
    ci = rng.integers(0, a.shape[1], 70)
    if dist:
        from combblas_tpu_torch.parallel.indexing import dist_spref

        dist_spref(_dist(a), ri, ci)
    else:
        from combblas_tpu_torch.ops.indexing import spref

        spref(a, ri, ci)


CALLERS = {
    "spgemm_auto.pallas": lambda a: tsp.spgemm_auto(a, a),
    "spgemm_auto.slabs": lambda a: _auto_slabs(False),
    "spgemm_auto.slabs_wide": lambda a: _auto_slabs(True),
    "spgemm_pallas_streamed": lambda a: tsp.spgemm_pallas_streamed(
        a, a, num_slabs=4),
    "spgemm_pallas_streamed.wide": lambda a: tsp.spgemm_pallas_streamed(
        a, a, num_slabs=4, wide=True),
    "summa_spgemm.pallas": lambda a: _summa(a, "pallas"),
    "summa_spgemm.wide": lambda a: _summa(a, "wide"),
    "summa_spgemm_staged": _staged,
    "mcl_local": lambda a: _mcl(a, False),
    "mcl_dist": lambda a: _mcl(a, True),
    "galerkin": lambda a: _galerkin(a, False),
    "galerkin_dist": lambda a: _galerkin(a, True),
    "spref": lambda a: _spref(a, False),
    "dist_spref": lambda a: _spref(a, True),
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_callers_expand_a_in_row_order(monkeypatch, caller):
    """Every program path that reaches the kernel routes' compacted
    expansion (here on the CPU, the same A as on the card) hands it an A
    whose live entries are in row order, so its stream holds each row
    together: the precondition of the card's row-window sort."""
    seen = _witness_expand_sort(monkeypatch)
    CALLERS[caller](_graph("ssca8"))
    assert seen, f"{caller} reached no compacted expansion"
