"""Degree-sorted ELL-8 SpMM: y = A @ X (port of
``combblas_tpu/ops/pallas/spmm_ell.py``).

Rows are sorted by descending degree and packed 8 per group, each group
ELL-padded to its longest row.  That plan is the blocked plan of
``ops/spmm_ell_blocked.py`` with one block (same P padding, the same
columns, ``base = g*8``), so both names here are that module's with
``nb = 1``, and both run the one ELL kernel (``ops/kernels/ell.py``, K6
and K7).  X may have any width and stays in device memory: the TPU's VMEM
limit and its lane padding of d to 128 do not carry over.
"""

from __future__ import annotations

import torch

from combblas_tpu_torch.ops.coo import SpCOO
from combblas_tpu_torch.ops.spmm_ell_blocked import (
    ell_blocked_prepare,
    spmm_ell_blocked,
)

__all__ = ["spmm_ell", "spmm_ell_prepare"]


def spmm_ell_prepare(a: SpCOO) -> dict:
    """ELL-8 plan of ``a`` on its device: ``ell_blocked_prepare(a, nb=1)``
    (the JAX plan's ``cols``, ``vals``, ``flush``, ``base``, ``inv``,
    ``live`` and ``P``, plus the kernel's run table) and ``groups``."""
    prep = ell_blocked_prepare(a, nb=1)
    prep["groups"] = prep["m_pad"] // 8
    return prep


def spmm_ell(a: SpCOO, x: torch.Tensor, prep: dict | None = None
             ) -> torch.Tensor:
    """y = A @ X (plus-times) through the ELL-8 fold; the result has X's
    dtype, computed in float32.  Pass ``prep`` (:func:`spmm_ell_prepare`)
    to amortize planning across calls."""
    return spmm_ell_blocked(a, x, prep=prep or spmm_ell_prepare(a))
