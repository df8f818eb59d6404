"""BENCHMARK.json against the contract's form, and every file that a cell
names found by its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def all_names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            yield kind, entry["name"]


@pytest.mark.parametrize("kind,name", list(all_names()))
def test_names(kind, name):
    assert NAME.match(name), name
    names = [e["name"] for k in ("end_to_end", "per_layer")
             for e in BENCH[k]] if kind in ("end_to_end", "per_layer") \
        else [e["name"] for e in BENCH[kind]]
    assert names.count(name) == 1


@pytest.mark.parametrize("cell", BENCH["workloads"],
                         ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    spec = json.loads((ROOT / "portbench" / "workloads"
                       / f"{cell['name']}.json").read_text())
    assert spec["config"] == cell["config"]
    assert (ROOT / "portbench" / "drivers" / f"{spec['driver']}.py").exists()
    assert (ROOT / "portbench" / "configs"
            / f"{cell['config']}.json").exists()
    reported = {m["name"] for k in ("end_to_end", "per_layer")
                for m in BENCH[k]
                if cell["name"] in m.get("workloads", [cell["name"]])}
    for m in reported:
        assert (ROOT / "portbench" / "metrics" / f"{m}.py").exists(), m
    assert "setup_s" in reported
    assert any(m["name"] != "setup_s" and m["name"] in reported
               for m in BENCH["end_to_end"])
    assert any(m["name"] in reported for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / config["file"]
    assert path.exists() and config["file"].startswith("portbench/")
    data = json.loads(path.read_text())
    assert data["reduced"] == config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    e2e = metric in BENCH["end_to_end"]
    if e2e:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer",
                                                             "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_layers_named_alike():
    by_metric = {m["name"].split(".")[0]: m["layer"]
                 for m in BENCH["per_layer"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) <= len(by_metric)


def test_size():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
