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


@pytest.mark.parametrize("wide", [False, True])
def test_poisoned_blocks_come_back_to_the_outputs(cuda, wide):
    """The allocator poisoning the edge-case tests rely on: after it, the
    outputs a wrapper allocates first read back the 0xA5 pattern."""
    cap = 123457
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
