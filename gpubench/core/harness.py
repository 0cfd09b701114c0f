"""One run of one cell: set-up, the measured window, the check, the line.

The loop is closed: one caller, and each operation starts after the
previous one has completed on the device.  An operation starts only while
the window has time left; the window's time runs from its start to the
end of its last operation.  With ``trace`` the window runs under
``torch.profiler`` and the cell's per-layer metrics are read from it;
without, its end-to-end metrics are reported.
"""

from __future__ import annotations

import sys
import time
import traceback
import types

import torch

from gpubench.core import manifest
from gpubench.core.trace import WINDOW_SPAN, collect

__all__ = ["FORBIDDEN", "forbidden_modules", "run_cell"]

#: Top-level module names that may not be loaded in a run: JAX and the
#: JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "combblas_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _refuse_forbidden() -> None:
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, dev,
             t0: float, *, bench: dict | None = None,
             scale: int | None = None) -> tuple:
    """Run the cell once on ``dev``; ``t0`` is the process's start on the
    host clock.  ``scale`` replaces the configuration's graph scale (a CPU
    rehearsal only).  Returns (result line as a dict, compared numbers as
    {name: (value, limit)}, the window's operation records, each with its
    seconds ``t``).  Raises RuntimeError if a forbidden module was loaded
    by the end of the window, or by the check and the readers after it."""
    bench = bench if bench is not None else manifest.load_benchmark()
    cell = manifest.cell(bench, cell_name)
    cfg = manifest.config(bench, cell["config"])
    mix = manifest.traffic(cell["traffic"])
    if scale is not None:
        cfg = dict(cfg, graph=dict(cfg["graph"], scale=scale))
    drv_mod = manifest.driver(mix["driver"])

    from combblas_tpu_torch.ops.kernels import _build
    if dev.type == "cuda":
        _build.library()          # built once per checkout, then loaded
    drv = drv_mod.Driver(cfg, mix, seed, dev)
    drv.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t0

    ops, failed, peak = [], 0, 0
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(WINDOW_SPAN):
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            if trace and dev.type == "cuda":
                peak = max(peak, _peak(dev))
                torch.cuda.reset_peak_memory_stats(dev)
            try:
                t_op = time.perf_counter()
                rec = drv.op(len(ops), trace)
                _sync(dev)
                rec["t"] = time.perf_counter() - t_op
            except Exception:  # an operation that fails ends the window
                traceback.print_exc()
                failed += 1
                break
            if trace:
                rec["peak_bytes"] = _peak(dev)
            ops.append(rec)
        end = time.perf_counter()
    if prof is not None:
        prof.stop()
    _refuse_forbidden()
    peak = max(peak, _peak(dev))

    drv.release()
    compared = drv.compare() if ops else {}
    correct = (failed == 0 and bool(compared)
               and all(v <= lim for v, lim in compared.values()))
    ctx = types.SimpleNamespace(
        cell=cell, config=cfg, traffic=mix, seed=seed, setup_s=setup_s,
        window_s=end - start, ops=ops, counts=drv.counts,
        trace=collect(prof) if prof is not None else None)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, cell_name, kind):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(ops) + failed,
            "failed": failed, "metrics": metrics, "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_ns() / 1e9
        device["window_s"] = ctx.trace.window_ns / 1e9
        line["breakdown"] = {"device_ops": ctx.trace.by_name()[:10],
                             "idle_gaps": ctx.trace.idle_gaps(10)}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    _refuse_forbidden()
    return line, compared, ops
