"""The port never imports JAX, and importing it builds nothing."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import combblas_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "combblas_tpu" or m.startswith("combblas_tpu."))
assert not bad, bad
assert "triton" not in sys.modules
from combblas_tpu_torch.ops.kernels import _build
assert _build._lib is None
print(" ".join(names))
print(len(names))
"""

#: The modules of the distributed SpMV, graph-algorithm and HipMCL slice,
#: of the distributed vector, indexing, dense, ordering and BC slice, and
#: of the matching, multigrid, filtered / semantic, I/O and CLI slice.
DIST_SLICE = ("parallel.spmv", "parallel.elementwise", "parallel.memefficient",
              "models.bfs", "models.cc", "models.lacc", "models.mis",
              "models.mcl", "parallel.vector", "parallel.indexing",
              "parallel.dense", "models.ordering", "models.bc",
              "models.matching", "parallel.matching", "models.multigrid",
              "models.filtered", "models.semantic", "io.mtx", "io.binary",
              "io.labels", "io.parallel", "utils.timers", "cli",
              "parallel.exchange")

#: Names each slice added to a module that existed before it: the classed
#: seg pipeline and the single-process join; the pod's exchange (with the
#: element requests, owner routing and reduced decisions of HipMCL's pod
#: path, and the whole-vector gather of its preprocessing's host maps), its
#: grid and K9's plain hop across processes.
SLICE_NAMES = {
    "parallel.exchange": ("pull", "gather_blocks", "gather_range",
                          "reduce_to_owners", "alltoallv", "allgather_var",
                          "allgather_host", "gather_table", "barrier",
                          "route_to_owners", "gather_at", "any_proc",
                          "max_proc", "gather_whole"),
    "parallel.grid": ("ProcGrid", "default_grid"),
    "ops.kernels.ring": ("ring_shift", "ring_shift_plain",
                         "ring_shift_pod_plain"),
    "ops.spgemm_seg": ("seg_plan", "seg_prepare", "seg_step",
                       "spgemm_streamed_seg", "seg2_plan", "seg2_prepare",
                       "seg2_step", "spgemm_streamed_seg2", "seg_zero_state"),
    "parallel.multihost": ("initialize_multihost", "is_coordinator",
                           "pod_grid", "global_put"),
}


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every module of the seg2, SpMM/BFS, materialized SpGEMM, distributed
    # SpGEMM, local-ops/MCL, distributed SpMV/MCL and distributed
    # vector/indexing/ordering/BC and matching/multigrid/I/O/CLI slices was
    # imported
    lines = out.stdout.strip().splitlines()
    assert int(lines[-1]) >= 59
    names = set(lines[-2].split())
    for mod in DIST_SLICE:
        assert f"combblas_tpu_torch.{mod}" in names, mod


@pytest.mark.parametrize("mod", sorted(SLICE_NAMES))
def test_slice_names_exported(mod):
    m = importlib.import_module(f"combblas_tpu_torch.{mod}")
    for name in SLICE_NAMES[mod]:
        assert name in m.__all__, name
        assert callable(getattr(m, name)), name
