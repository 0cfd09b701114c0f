"""The grid profiler's bookkeeping, and its grid products (which
``chip_smoke.py`` phases 13-14 run) on a small matrix on the CPU: each
equals the single-device ``spgemm_auto`` product."""

import pytest

torch = pytest.importorskip("torch")

from combblas_tpu_torch import profile_summa as prof  # noqa: E402
from combblas_tpu_torch.gen.graph500 import a2_matrix  # noqa: E402
from combblas_tpu_torch.ops.spgemm import spgemm_auto  # noqa: E402
from combblas_tpu_torch.profile_seg2 import stage_of  # noqa: E402


@pytest.mark.parametrize("name, stage", [
    ("void (anonymous namespace)::ring_shift_kernel(RingArgs)", "ring"),
    ("void (anonymous namespace)::expand_kernel<long>(int const*)",
     "expand"),
    ("void at::native::indexFuncLargeIndex<float, long, unsigned int>",
     "scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>", "scatter"),
    ("void cub::CUB_200_NS::DeviceRadixSortOnesweepKernel<...>", "sort"),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>",
     "other"),
])
def test_stage_of(name, stage):
    assert stage_of(name, prof.STAGES) == stage


def test_grid_cells_equal_the_single_device_product():
    cpu = torch.device("cpu")
    a = a2_matrix(3, cpu, 8)
    want = spgemm_auto(a, a)
    nnz = int(want.nnz)
    cells = prof.grid_cells(a, cpu)
    assert [label for label, _call, _info in cells] == [
        "summa_spgemm_auto 2x2", "summa_spgemm_auto 4x4",
        "summa_spgemm_staged 4x4", "summa_spgemm_rma 4x4",
        "summa3d_spgemm 2x2x2"]
    for label, call, info in cells:
        got = call().to_local()
        assert int(got.nnz) == nnz, label
        assert torch.equal(got.row[:nnz], want.row[:nnz]), label
        assert torch.equal(got.col[:nnz], want.col[:nnz]), label
        assert torch.equal(got.val[:nnz], want.val[:nnz]), label
        assert info["impl"] in ("xla", "pallas", "wide")
