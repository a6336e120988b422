"""Every file the harness finds by name loads, and BENCHMARK.json keeps to its
format: names, units, keys, cells and metrics that point at what exists."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    entry, config, traffic = harness.load_cell(cell, SPEC)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    assert config["name"] == entry["config"]
    assert importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver
    metrics = {m["name"] for m in harness.end_to_end_metrics(SPEC, entry)}
    assert "setup_s" in metrics and traffic["metric"] in metrics
    assert harness.per_layer_metrics(SPEC, entry)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"]
    assert config["file"].startswith("benchmark/")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert set(metric["workloads"]) <= set(CELLS)


def test_names_units_and_keys():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
    four = sum(c["chips"] == 4 for c in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
