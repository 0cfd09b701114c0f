"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""

import json
import re

import pytest

from gpubench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
BENCH = manifest.load_benchmark()
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
            assert (manifest.ROOT / w).is_file()


def test_names_units_and_lines():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_pairs_chips_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(BENCH, w["name"],
                                                      "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.metrics_of(BENCH, w["name"], "per_layer"), w["name"]


def test_per_layer_moves_and_workloads():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        listed = m.get("workloads", sorted(cells))
        assert set(listed) <= cells
        for c in listed:   # every listed cell reports the moved metric
            assert c in e2e[m["moves"]].get("workloads", [c])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in BENCH[kind]:
        assert callable(manifest.reader(m["name"])), m["name"]


def test_every_cell_finds_its_parts():
    for w in BENCH["workloads"]:
        cfg = manifest.config(BENCH, w["config"])
        mix = manifest.traffic(w["traffic"])
        drv = manifest.driver(mix["driver"])
        assert hasattr(drv, "Driver")
        assert cfg["name"] == w["config"]
        assert set(mix["limits"])


def test_config_files():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith("gpubench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert c["source"].startswith("https://")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size"))
        assert cfg["assumed"] and all(cfg["assumed"].values())
        for key in ("scale", "edgefactor", "initiator", "graph_seed"):
            assert key in cfg["graph"]
