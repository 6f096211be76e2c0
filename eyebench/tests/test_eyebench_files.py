"""Every file BENCHMARK.json names is found by name, and the file keeps to
the benchmark's contract."""

import importlib
import importlib.util
import json
import os
import re

import pytest

from eyebench.tests.conftest import ROOT
from eyebench.tests.tiny import bench, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["eyebench"] and b["command"] == ["python3", "eyebench/run.py"]
    assert all(_text(w) for w in b["command"])


@pytest.mark.parametrize("entry", bench()["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _text(entry["source"]) and _text(entry["why"])
    assert entry["file"].startswith("eyebench/")
    config = load(entry["file"])
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"] == []
    assert config["dtype"] in ("bf16", "mixed") and config["weights"] in ("bf16", "f32")
    assert config["control"].get("policy", config["dtype"]) != config["dtype"] or "precision" in config["control"]


@pytest.mark.parametrize("cell", bench()["workloads"], ids=lambda e: e["name"])
def test_cell_files(cell):
    b = bench()
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _text(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in b["configs"]}
    mix = load("eyebench", "traffic", cell["traffic"] + ".json")
    gen = importlib.import_module("eyebench.traffic." + mix["generator"])
    assert callable(gen.Cell)
    held = load("eyebench", "limits", cell["name"] + ".json")
    limits = held["limits"]
    assert set(held) <= {"limits", "optional"} and set(held.get("optional", ())) <= set(limits)
    assert limits and all(isinstance(v, (int, float)) and v > 0 for v in limits.values())
    reported = [m for m in b["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in b["per_layer"])


def test_cells_unique():
    b = bench()
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("metric", bench()["end_to_end"] + bench()["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    b = bench()
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    cells = {w["name"] for w in b["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in b["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _text(metric["layer"])
        moves = next(m for m in b["end_to_end"] if m["name"] == metric["moves"])
        for w in metric["workloads"]:
            assert "workloads" not in moves or w in moves["workloads"]
    path = os.path.join(ROOT, "eyebench", "metrics", metric["name"] + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_json_is_plain():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        json.loads(f.read())
