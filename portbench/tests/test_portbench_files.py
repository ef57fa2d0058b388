"""Every cell, configuration, traffic mix, driver, limit file and metric
reader of ``BENCHMARK.json`` loads by its name, and the file keeps to the
benchmark's contract where a CPU test can tell."""

from __future__ import annotations

import re

import pytest

from portbench import bench
from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def declared() -> dict:
    """``BENCHMARK.json`` as it stands."""
    return bench.load_json(ROOT / "BENCHMARK.json")


def test_top_level_keys(declared):
    assert set(declared) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert declared["command"] == ["python3", "portbench/run.py"]
    assert declared["paths"] == ["portbench"]
    assert 1 <= declared["run_seconds"] <= 51
    cells = len(declared["workloads"])
    assert sum(w["chips"] == 4 for w in declared["workloads"]) <= max(1, cells // 4)


def test_names_and_units(declared):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in declared[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in declared["end_to_end"] + declared["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in declared["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("key", ["configs", "workloads"])
def test_every_entry_has_its_files(benchmark, key):
    for e in benchmark[key]:
        if key == "configs":
            config = bench.load_json(ROOT / e["file"])
            assert config["name"] == e["name"] and config["reduced"] == e["reduced"] == []
            assert config["source"] == e["source"]
        else:
            bench.entry(benchmark["configs"], e["config"], "config")
            traffic = bench.load_json(bench.HERE / "traffic" / f"{e['traffic']}.json")
            assert (bench.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
            assert hasattr(bench.load_module(bench.HERE / "drivers" / f"{traffic['driver']}.py"), "Cell")
            limits = bench.load_json(bench.HERE / "limits" / f"{e['name']}.json")
            assert limits and all(v > 0 for v in limits.values())


def test_every_metric_is_reported_where_it_moves(declared):
    cells = [w["name"] for w in declared["workloads"]]
    e2e = {m["name"]: m for m in declared["end_to_end"]}
    for cell in cells:
        reported = [m for m in declared["end_to_end"] if bench.applies(m, cell)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(bench.applies(m, cell) for m in declared["per_layer"])
    layers = {}
    for m in declared["per_layer"]:
        reader = bench.load_module(bench.HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells and bench.applies(moved, cell), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) <= {"forward", "fine-tuning", "device", "kernels",
                           "estimator and host preprocessing"}
