"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; everything else is found by the names it gives:

- ``gpubench/configs/<config>.json``: a deployment (graph and settings);
- ``gpubench/traffic/<traffic>.json``: a traffic mix, data only, whose
  ``driver`` names the code that calls the program;
- ``gpubench/drivers/<driver>.py``: that code;
- ``gpubench/metrics/<metric>.py``: one reader per metric, or, where
  that file is not there, the reader that metrics of several cells share,
  ``gpubench/metrics/<part after the first dot>.py`` (``a2.idle_pct`` and
  ``bfs.idle_pct`` both read with ``idle_pct.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "BENCH_DIR", "load_benchmark", "cell", "config",
           "traffic", "driver", "metrics_of", "reader"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"gpubench.drivers.{name}")


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it under ``workloads``, or list no workloads."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``gpubench/metrics/<name>.py``, or
    of the shared ``gpubench/metrics/<part after the first dot>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    if not path.is_file() and "." in metric_name:
        path = BENCH_DIR / "metrics" / f"{metric_name.split('.', 1)[1]}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench.metrics.{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
