"""combblas_tpu_torch — the PyTorch + CUDA port of combblas_tpu.

The JAX package ``combblas_tpu`` is the reference; this package mirrors its
module paths and function names (``combblas_tpu/ops/spgemm_seg.py:seg2_step``
<-> ``combblas_tpu_torch/ops/spgemm_seg.py:seg2_step``) and is held against
it by the ``tests/test_torch_*.py`` suite.  Every Pallas kernel on the ported
path is a hand-written CUDA kernel for Hopper under ``csrc/``, built with
``nvcc`` at first use (``ops/kernels/_build.py``); each has a plain PyTorch
version beside it, which is what runs for tensors on the CPU.

This package imports ``torch`` and never ``jax``.
"""
