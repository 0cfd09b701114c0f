"""Host arrays onto the grid (the single-process part of
``combblas_tpu/parallel/multihost.py``).

``global_put`` is the JAX package's single-process ``device_put``: a host
numpy array becomes a tensor on the grid's device.  ``initialize_multihost``
and ``pod_grid`` join processes into one mesh; they wait for a machine with
two or more GPUs.
"""

from __future__ import annotations

import numpy as np
import torch

from combblas_tpu_torch.parallel.grid import ProcGrid

__all__ = ["global_put"]


def global_put(x, grid: ProcGrid) -> torch.Tensor:
    """A copy of the host array ``x`` on the grid's device, bit for bit (the
    source may be a read-only buffer view)."""
    return torch.from_numpy(np.array(x, copy=True)).to(grid.device)
