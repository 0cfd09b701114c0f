"""CUDA kernels vs their plain PyTorch versions on the card.

These need an NVIDIA GPU and nvcc (the kernels are built from
``combblas_tpu_torch/csrc`` at first use); without a card they skip.  Run
them on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch import semiring as tsr  # noqa: E402
from combblas_tpu_torch.ops.kernels import LAUNCHES  # noqa: E402
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
