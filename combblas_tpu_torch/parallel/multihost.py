"""Joining processes, and host arrays onto the grid (port of
``combblas_tpu/parallel/multihost.py``).

The JAX package joins one process per host with
``jax.distributed.initialize``; the port joins its processes with
``torch.distributed.init_process_group("gloo")`` over TCP.  The ``gloo``
group carries only host data: counts, capacities, IPC handles, barriers,
and the CPU tensors of the CPU route.  Card tensors move between processes
through CUDA IPC (:mod:`parallel.exchange`), never NCCL: NCCL refuses two
ranks on one card, and a pod of processes that share one card is the case
the port runs.

A single process is the degenerate case: :func:`initialize_multihost` is a
no-op, :func:`is_coordinator` is true and :func:`pod_grid` is
``ProcGrid.make``.  Across processes :func:`pod_grid` spreads the blocks
over every process, process-major as ``jax.devices()`` is, and
:func:`global_put` places only this process's share of a host array, as
JAX's ``make_array_from_callback`` does.
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
    Otherwise ``init_process_group("gloo")`` at
    ``tcp://coordinator_address`` (``host:port``; default
    ``MASTER_ADDR:MASTER_PORT``) with ``num_processes`` and ``process_id``
    (default ``WORLD_SIZE`` and ``RANK``), so library code can call it
    unconditionally.  A process with a card binds it first
    (``LOCAL_RANK`` modulo the cards, else card 0), so that every process
    of one card, or of one host, agrees on its device."""
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
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def is_coordinator() -> bool:
    """Rank 0 (every process of a single-process run) — the
    ``SpParHelper::Print`` gate."""
    return not _joined() or dist.get_rank() == 0


def pod_grid(layers: int = 1, pr: int | None = None, pc: int | None = None,
             device=None) -> ProcGrid:
    """The grid over every process's blocks.  In one process this is
    ``ProcGrid.make(pr, pc, layers, device)``: the grid of ``default_grid``
    when ``pr`` and ``pc`` are not given.  Across P processes process p
    holds the raster blocks [p·B/P, (p+1)·B/P) of the (layers, pr, pc)
    raster (B = layers·pr·pc, a multiple of P, as JAX's uniform-job
    assertion asks): whole block rows or a run of one, and on a layered
    grid whole layers or such a box inside one layer
    (:meth:`ProcGrid.local_shape3`)."""
    n, rank = ((dist.get_world_size(), dist.get_rank()) if _joined()
               else (1, 0))
    return ProcGrid.make(pr, pc, layers, device, nproc=n, rank=rank)


def global_put(x, grid: ProcGrid, spec: str | None = None) -> torch.Tensor:
    """This process's share of the host array ``x`` (every process passes
    the same) on the grid's device, bit for bit (the source may be a
    read-only buffer view).  ``spec``: None replicates the whole array;
    ``"blocks"`` takes a (pr, pc, ...) block stack's (lr, lc, ...) blocks;
    ``"vector"`` a FullyDist vector's slice.  In one process every spec is
    the whole array."""
    x = np.asarray(x)
    if grid.is_pod and spec == "blocks":
        (r0, c0), (lr, lc) = grid.origin(), grid.local_shape()
        x = x[r0:r0 + lr, c0:c0 + lc]
    elif grid.is_pod and spec == "vector":
        lo, hi = grid.vec_range(x.shape[0])
        x = x[lo:hi]
    elif spec not in (None, "blocks", "vector"):
        raise ValueError(f"spec must be None, 'blocks' or 'vector', got "
                         f"{spec!r}")
    return torch.from_numpy(np.array(x, copy=True)).to(grid.device)
