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


@pytest.mark.parametrize("name, base", [
    ("void (anonymous namespace)::expand_kernel<int>(int const*, float "
     "const*, long const*, long)", "expand_kernel"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<cub::"
     "DeviceRadixSortPolicy<int>::Policy900>(int*)",
     "DeviceRadixSortOnesweepKernel"),
    ("(anonymous namespace)::split_kernel(long const*, long, long, long, "
     "long*)", "split_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<int> >(int, at::native::FillFunctor<int>)",
     "vectorized_elementwise_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
])
def test_kernel_base(name, base):
    assert prof.kernel_base(name) == base


def test_pass_aggregation_by_name_and_stage():
    """The whole-pass summary adds every launch of a name (never the union)
    and sums each stage's kernels."""
    ev = [("void (anonymous namespace)::expand_kernel<int>(int)", 0.0, 2000.0),
          ("void (anonymous namespace)::expand_kernel<int>(int)", 500.0,
           1500.0),
          ("(anonymous namespace)::split_kernel(long)", 0.0, 100.0),
          ("void (anonymous namespace)::count_kernel(int)", 0.0, 50.0),
          ("void (anonymous namespace)::compress_kernel<int>(int)", 0.0,
           700.0),
          ("void (anonymous namespace)::pad_kernel<int>(int)", 0.0, 300.0),
          ("void at::native::vectorized_elementwise_kernel<4>(int)", 0.0,
           100.0),
          ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>(y)",
           0.0, 4000.0)]
    names = prof.by_name_ms(ev)
    assert list(names)[0].startswith("void at_cuda_detail::cub::")
    assert names["void (anonymous namespace)::expand_kernel<int>(int)"] == 3.0
    stages = {k: v["ms"] for k, v in prof.split_by_stage(ev).items()}
    assert stages == pytest.approx({"expand": 3.15, "compress": 1.0,
                                    "sort": 4.0, "other": 0.1})
    assert sum(names.values()) == pytest.approx(8.25)
