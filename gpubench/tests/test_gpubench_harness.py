"""Each cell's operation at a tiny scale on the CPU against the plain
reference, and whole runs of the harness there (window, check, readers,
the line)."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from gpubench.core import manifest
from gpubench.core.harness import FORBIDDEN, run_cell
from gpubench.tests._tiny import CELLS, CPU, compared

ROOT = str(manifest.ROOT)
#: The program's MCL sizes its iterate for ``select`` entries a column,
#: while recovery keeps up to ``recover_num``; at tiny n the columns recover
#: so often that the iterate outgrows its capacity (PERF.md, Open
#: questions).  The CPU runs of the MCL cell therefore take recover_num =
#: select; the card runs the configuration as it stands.
MCL_TINY = {"recover_num": 64}


def _run(cell, trace, monkeypatch, scale=9, seed=5):
    if cell.startswith("mcl"):
        real = manifest.config

        def config(bench, name):
            cfg = real(bench, name)
            mcl = dict(cfg["settings"]["mcl"], **MCL_TINY)
            return dict(cfg, settings=dict(cfg["settings"], mcl=mcl))

        monkeypatch.setattr(manifest, "config", config)
    return run_cell(cell, seed, 0.3, trace, CPU, 0.0, scale=scale)[:2]


@pytest.mark.parametrize("cell", [c for c in CELLS if not c.startswith("mcl")])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_operation_against_reference(cell, seed):
    for name, (value, limit) in compared(cell, 10, seed).items():
        assert value <= limit, (cell, name, value)


def test_mcl_operation_against_reference():
    out = compared("mcl.ssca17", 9, 3, **MCL_TINY)
    assert out == {"labels_moved": (0, out["labels_moved"][1]),
                   "iter_gap": (0, out["iter_gap"][1])}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_cell(cell, trace, monkeypatch):
    line, comp = _run(cell, trace, monkeypatch)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(comp)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in manifest.metrics_of(
        manifest.load_benchmark(), cell, kind)}
    assert set(line["metrics"]) <= names
    if not trace:   # host-clock metrics are there; device ones are not
        assert set(line["metrics"]) == names
    else:
        assert "breakdown" in line and line["device"]["window_s"] > 0
    json.dumps(line)


def test_run_py_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "a2_keep.ssca20", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_run_py_needs_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "a2_keep.ssca20", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "combblas_tpu_torch" in p.stderr


_PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(body: str) -> set:
    p = subprocess.run([sys.executable, "-c",
                        _PROBE.format(root=ROOT, body=body)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level_modules(
        "import torch\n"
        "from gpubench.core.harness import run_cell\n"
        "run_cell('bfs64.g500', 1, 0.2, True, torch.device('cpu'), "
        "time.perf_counter(), scale=8)\n"
        "import gpubench.run, gpubench.controls")
    assert "combblas_tpu_torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


@pytest.mark.parametrize("where", ["reader", "compare", "after the harness"])
def test_a_late_jax_import_gives_no_result(where, monkeypatch, capsys):
    """A module named ``jax`` loaded by a metric reader, by the check, or
    after the harness has returned: run.py exits 1 and prints no line."""
    import gpubench.core.harness as harness
    import gpubench.run as run_py
    from gpubench.drivers import bfs_batch

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if where == "reader":
        real_reader = manifest.reader

        def reader(name):
            read = real_reader(name)

            def loading(ctx):
                load_jax()
                return read(ctx)
            return loading
        monkeypatch.setattr(manifest, "reader", reader)
    elif where == "compare":
        real_compare = bfs_batch.Driver.compare

        def compare(self):
            load_jax()
            return real_compare(self)
        monkeypatch.setattr(bfs_batch.Driver, "compare", compare)
    real_run = harness.run_cell

    def on_the_cpu(cell, seed, seconds, trace, dev, t0, **kw):
        out = real_run(cell, seed, seconds, trace, CPU, t0, scale=8, **kw)
        if where == "after the harness":
            load_jax()
        return out
    monkeypatch.setattr(harness, "run_cell", on_the_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run_py.main(["--workload", "bfs64.g500", "--seed", "3",
                      "--seconds", "0.2"])
    out = capsys.readouterr()
    assert rc == 1 and out.out == ""
    assert "forbidden modules loaded: ['jax']" in out.err


def test_references_import_nothing_of_the_program():
    mods = _top_level_modules(
        "import gpubench.ref.spgemm, gpubench.ref.bfs, gpubench.ref.spmm\n"
        "import gpubench.ref.mcl, gpubench.count.work, gpubench.gen.rmat")
    assert "combblas_tpu_torch" not in mods
    assert not mods & set(FORBIDDEN)


@pytest.mark.gpu
def test_run_py_on_the_card(card):
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "a2_keep.ssca20", "--seed", "2", "--seconds", "1",
                        "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "a2.kernels_roofline" in line["metrics"]
