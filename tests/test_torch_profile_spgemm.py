"""The profilers' stage split (``profile_seg2.STAGES``, which
``profile_spgemm`` and ``profile_summa`` use): every device event lands in
exactly one stage, the port's kernels by their whole base name."""

import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch import profile_seg2 as prof  # noqa: E402


@pytest.mark.parametrize("name, stage", [
    ("void (anonymous namespace)::expand_kernel<int>(int const*, float "
     "const*, long const*, long)", "expand"),
    ("void (anonymous namespace)::count_kernel(int const*, bool const*, "
     "long, long const*, long*, long*)", "expand"),
    ("(anonymous namespace)::split_kernel(long const*, long, long, long, "
     "long*)", "expand"),
    ("void (anonymous namespace)::expand_chunks_kernel(int const*, int "
     "const*)", "expand"),
    ("void (anonymous namespace)::compress_kernel<int>(int const*, float "
     "const*, long, int)", "compress"),
    ("void (anonymous namespace)::pad_kernel<long>(unsigned long long "
     "const*, long*, float*, long)", "compress"),
    # whole base names: a longer name ending in one of the port's is not it
    ("void at::native::histogram_count_kernel<int>(int const*)", "other"),
    ("void cub::CUB_200_NS::DeviceRadixSortOnesweepKernel<...>", "sort"),
    ("Memcpy DtoD (Device -> Device)", "assembly"),
    ("void at::native::index_elementwise_kernel<128, 4, "
     "at::native::gpu_index_kernel<at::native::index_kernel_impl<...>",
     "other"),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>",
     "other"),
])
def test_stage_of(name, stage):
    assert prof.stage_of(name) == stage


def test_split_by_stage_sums_per_stage_and_kernel():
    events = [("expand_kernel<int>", 0.0, 1000.0),
              ("expand_kernel<int>", 2000.0, 2500.0),
              ("DeviceRadixSortHistogramKernel", 3000.0, 5000.0),
              ("fill", 5000.0, 5100.0)]
    out = prof.split_by_stage(events)
    assert out["expand"]["ms"] == 1.5
    assert out["expand"]["kernels"] == {"expand_kernel<int>": 1.5}
    assert out["sort"]["ms"] == 2.0
    assert out["other"]["ms"] == pytest.approx(0.1)
    assert set(out) == {"expand", "sort", "other"}
