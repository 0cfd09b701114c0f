"""Phase timers and profiling helpers (port of
``combblas_tpu/utils/timers.py``).

The counterpart of the reference's global phase timers
(``cblas_alltoalltime`` / ``cblas_localspmvtime`` / ..., ``CombBLAS.h:76-102``)
and its per-run breakdowns (``3DSpGEMM/Multiplier.h:50-58``).
:class:`PhaseTimers` times host-driven loops on the wall clock, a phase
ending once the card has finished its work; :func:`trace` names a region
for ``torch.profiler`` (and NVTX under ``torch.autograd.profiler.emit_nvtx``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["PhaseTimers", "trace", "device_memory_report"]


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, a dataclass
    such as SpCOO or DistSpMat, or a list / tuple / dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name.

    with timers.phase("expand", sync=c):   # waits for c's card work
        c = spgemm(...)
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with ``sync`` (tensors, or objects holding
        them), first wait for the cards they lie on."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                for d in _cuda_devices(sync, set()):
                    torch.cuda.synchronize(d)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        return "\n".join(
            f"{name:24s} {self.totals[name]:10.4f}s  ({self.counts[name]}x)"
            for name in sorted(self.totals, key=self.totals.get,
                               reverse=True))

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(name: str):
    """A named region for ``torch.profiler`` (an NVTX range under
    ``emit_nvtx``)."""
    with torch.profiler.record_function(name):
        yield


def device_memory_report() -> str:
    """Memory of every visible card, from ``torch.cuda.memory_stats`` (the
    reference's SHOW_MEMORY_USAGE prints, ``ParFriends.h:643-717``); empty
    without a card."""
    if not torch.cuda.is_available():
        return ""
    lines = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        used = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", 0)
        limit = torch.cuda.get_device_properties(i).total_memory
        lines.append(f"cuda:{i}: in_use={used/1e9:.2f}GB "
                     f"peak={peak/1e9:.2f}GB limit={limit/1e9:.2f}GB")
    return "\n".join(lines)
