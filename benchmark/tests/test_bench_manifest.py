"""BENCHMARK.json and the files it names, found by name."""

import importlib
import json
import re

import pytest

from benchmark.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def manifest():
    return Manifest()


def test_every_cell_finds_its_files(manifest):
    for w in manifest.data["workloads"]:
        cfg = manifest.config(w["config"])
        traffic = manifest.traffic(w["traffic"])
        limits = manifest.limits(w["name"])
        assert cfg["name"] == w["config"] and len(traffic["frame_hw"]) == 2
        assert limits["csv_rows"] == 0
        for name in manifest.per_layer_for(w["name"]):
            assert callable(importlib.import_module(f"benchmark.metrics.{name}").read)


def test_manifest_keeps_to_the_contract(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {m["name"] for m in d["end_to_end"]} >= {"setup_s"}
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] == 1
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((manifest.root / c["file"]).read_text())["reduced"] == c["reduced"]
    assert 1 <= d["run_seconds"] <= 51


def test_per_layer_for_reads_the_workloads_key(manifest):
    data = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    manifest.data = data
    assert manifest.per_layer_for("x") == ["a", "b"] and manifest.per_layer_for("y") == ["a"]
