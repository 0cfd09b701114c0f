"""combblas_tpu_torch — the PyTorch + CUDA port of combblas_tpu.

The JAX package ``combblas_tpu`` is the reference; this package mirrors its
module paths and function names (``combblas_tpu/ops/spgemm_seg.py:seg2_step``
<-> ``combblas_tpu_torch/ops/spgemm_seg.py:seg2_step``) and is held against
it by the ``tests/test_torch_*.py`` suite.  Every Pallas kernel on the ported
path is a hand-written CUDA kernel for Hopper under ``csrc/``, built with
``nvcc`` at first use (``ops/kernels/_build.py``); each has a plain PyTorch
version beside it, which is what runs for tensors on the CPU.

The package-level names are the JAX package's: the semirings, ``SpCOO``
and its helpers, ``spgemm_auto``, the SpMV family and :func:`square`.
``python -m combblas_tpu_torch.cli`` runs the applications.

This package imports ``torch`` and never ``jax``.
"""

from combblas_tpu_torch.semiring import (
    MAX_FIRST,
    MAX_PLUS,
    MAX_SECOND,
    MAX_TIMES,
    MIN_PLUS,
    MIN_SECOND,
    OR_AND,
    PLUS_TIMES,
    Semiring,
    get_semiring,
)
from combblas_tpu_torch.ops.coo import SpCOO, find, merge, sort_coo
from combblas_tpu_torch.ops.spgemm import spgemm_auto
from combblas_tpu_torch.ops.spmv import spmm, spmsv_masked, spmv, spmv_transpose

__version__ = "0.1.0"


def square(a: SpCOO, sr=PLUS_TIMES, **kw) -> SpCOO:
    """A² (``SpParMat::Square``, ``SpParMat.cpp:3456``) through
    :func:`spgemm_auto`."""
    return spgemm_auto(a, a, sr, **kw)
