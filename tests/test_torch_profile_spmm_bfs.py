"""The SpMM/BFS profiler's tail split: the longest groups' runs move
whole from the bulk table to the tail table, and the two add up to the
plan's run table."""

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
