"""Joining processes, and host arrays onto the grid (port of
``combblas_tpu/parallel/multihost.py``).

The JAX package joins one process per host with
``jax.distributed.initialize``; the port joins them with
``torch.distributed.init_process_group`` over TCP (``gloo`` for CPU
tensors, ``nccl`` where there is a card).  A single process is the case the
port runs: :func:`initialize_multihost` is a no-op, :func:`is_coordinator`
is true and :func:`pod_grid` is ``default_grid``.  A grid over the cards of
several processes needs blocks that live on other processes' cards, which
the port does not have yet (ROADMAP item 1.8): :func:`pod_grid` refuses it.

``global_put`` is the JAX package's single-process ``device_put``: a host
numpy array becomes a tensor on the grid's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from combblas_tpu_torch.parallel.grid import ProcGrid

__all__ = ["initialize_multihost", "is_coordinator", "pod_grid",
           "global_put"]


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> int:
    """Join the process group; returns the process count.

    A no-op returning 1 when nothing is configured: no argument and no
    ``MASTER_ADDR`` in the environment (torchrun's counterpart of
    ``JAX_COORDINATOR_ADDRESS``).  When a group exists already, its size.
    Otherwise ``init_process_group`` at ``tcp://coordinator_address``
    (``host:port``; default ``MASTER_ADDR:MASTER_PORT``) with
    ``num_processes`` and ``process_id`` (default ``WORLD_SIZE`` and
    ``RANK``), so library code can call it unconditionally."""
    if _joined():
        return dist.get_world_size()
    if coordinator_address is None and num_processes is None \
            and not os.environ.get("MASTER_ADDR"):
        return 1
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def is_coordinator() -> bool:
    """Rank 0 (every process of a single-process run) — the
    ``SpParHelper::Print`` gate."""
    return not _joined() or dist.get_rank() == 0


def pod_grid(layers: int = 1, pr: int | None = None, pc: int | None = None,
             device=None) -> ProcGrid:
    """The grid over every process's devices.  In one process this is
    ``ProcGrid.make(pr, pc, layers, device)``: the grid of ``default_grid``
    when ``pr`` and ``pc`` are not given."""
    if _joined() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"pod_grid across {dist.get_world_size()} processes: a block "
            "grid over other processes' cards is not ported yet (ROADMAP "
            "item 1.8)")
    return ProcGrid.make(pr, pc, layers, device)


def global_put(x, grid: ProcGrid) -> torch.Tensor:
    """A copy of the host array ``x`` on the grid's device, bit for bit (the
    source may be a read-only buffer view)."""
    return torch.from_numpy(np.array(x, copy=True)).to(grid.device)
