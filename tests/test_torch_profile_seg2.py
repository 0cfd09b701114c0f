"""The slab profiler's bookkeeping: device busy time is the union of the
device intervals, never their sum, and the profiled slabs are the ones its
docstring names."""

import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch import profile_seg2 as prof  # noqa: E402


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),           # overlap counts once
    ([(5.0, 6.0), (0.0, 1.0)], 2.0),           # unsorted, disjoint
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 5.0)], 5.0),  # nested, then chained
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),           # touching
])
def test_interval_union(spans, want):
    assert prof.interval_union_us(spans) == want


def test_pick_slabs():
    slabs = [dict(flat=False, flops=f) for f in (50, 90, 70, 60)]
    slabs += [dict(flat=True, flops=f) for f in (30, 40)]
    assert prof.pick_slabs(slabs) == {
        "heaviest_windowed": 1, "mid_windowed": 2, "last_windowed": 3,
        "largest_flat": 5}
