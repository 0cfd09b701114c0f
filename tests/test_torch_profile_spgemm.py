"""The SpGEMM profiler's bookkeeping: every device kernel lands in exactly
one stage, by the name parts its docstring lists."""

import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch import profile_spgemm as prof  # noqa: E402


@pytest.mark.parametrize("name, stage", [
    ("void (anonymous namespace)::expand_kernel<int, false>(int const*)",
     "expand"),
    ("void (anonymous namespace)::head_count_kernel<int>(int const*, long)",
     "compress"),
    ("void (anonymous namespace)::emit_kernel<int>(int const*, float const*)",
     "compress"),
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
    events = [("expand_kernel<int, false>", 0.0, 1000.0),
              ("expand_kernel<int, false>", 2000.0, 2500.0),
              ("DeviceRadixSortHistogramKernel", 3000.0, 5000.0),
              ("fill", 5000.0, 5100.0)]
    out = prof.split_by_stage(events)
    assert out["expand"]["ms"] == 1.5
    assert out["expand"]["kernels"] == {"expand_kernel<int, false>": 1.5}
    assert out["sort"]["ms"] == 2.0
    assert out["other"]["ms"] == pytest.approx(0.1)
    assert set(out) == {"expand", "sort", "other"}
