"""BENCHMARK.json and the files it names, found by name: a configuration
by its `file`, a traffic mix as traffic/<traffic>.json, a cell's limits as
limits/<workload>.json, a per-layer metric's reader as metrics/<name>.py.
A cell, a configuration or a metric is added by adding files."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, path: Path | None = None):
        self.path = Path(path) if path else HERE.parent / "BENCHMARK.json"
        self.root = self.path.parent
        self.data = json.loads(self.path.read_text())

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{self.path.name} has no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "benchmark" / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.root / "benchmark" / "limits" / f"{workload}.json").read_text())

    def per_layer_for(self, workload: str) -> list[str]:
        """The per-layer metrics a workload reports."""
        return [m["name"] for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload])]

    def units(self) -> dict:
        return {m["name"]: m["unit"] for m in self.data["end_to_end"] + self.data["per_layer"]}
