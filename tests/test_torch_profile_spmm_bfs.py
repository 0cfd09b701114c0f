"""The SpMM/BFS profiler's tail splits: the longest groups' runs (rows)
move whole from the bulk table (stream) to the tail, and the two add up to
the plan's run table (the matrix)."""

import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch import profile_spmm_bfs as prof  # noqa: E402


@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_split_runs(k):
    run_len = torch.tensor([[3, 0], [1, 1], [0, 9], [2, 2], [0, 0]],
                           dtype=torch.int32)
    bulk, tail = prof.split_runs(run_len, k)
    assert bulk.dtype == tail.dtype == torch.int32
    assert torch.equal(bulk + tail, run_len)
    longest = {0: [], 1: [2], 2: [2, 3], 5: [0, 1, 2, 3, 4]}[k]
    for g in range(run_len.shape[0]):
        if g in longest:
            assert torch.equal(tail[g], run_len[g])
            assert not bool(bulk[g].any())
        else:
            assert not bool(tail[g].any())


@pytest.mark.parametrize("k", [0, 1, 3, 6])
def test_split_rows(k):
    deg = torch.tensor([2, 0, 5, 1, 3, 0])
    rp = torch.zeros(7, dtype=torch.int64)
    rp[1:] = torch.cumsum(deg, 0)
    col = torch.arange(11, dtype=torch.int32) * 3
    val = torch.arange(11, dtype=torch.float32) + 0.5
    (brp, bcol, bval), (trp, tcol, tval) = prof.split_rows(rp, col, val, k)
    longest = {0: [], 1: [2], 3: [0, 2, 4], 6: list(range(6))}[k]
    for r in range(6):
        keep = (trp if r in longest else brp)
        gone = (brp if r in longest else trp)
        assert int(keep[r + 1] - keep[r]) == int(deg[r])
        assert int(gone[r + 1] - gone[r]) == 0
    both = torch.cat([bcol, tcol]).sort()[0]
    assert torch.equal(both, col) and bcol.numel() == int(brp[-1])
    assert torch.equal(torch.cat([bval, tval]).sort()[0], val)
    for r in longest:     # the tail keeps the row's own entries, in order
        assert torch.equal(tcol[trp[r]:trp[r + 1]], col[rp[r]:rp[r + 1]])
