"""The benchmark's description, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics; each configuration is ``bench/configs/<name>.json``,
each traffic mix ``bench/traffic/<traffic>.json`` and each per-layer
metric ``bench/metrics/<name>.py``. Adding one is a new file plus a new
entry: nothing here names a cell.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cells(self) -> list[str]:
        return [w["name"] for w in self.bench["workloads"]]

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r}; cells: {', '.join(self.cells())}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.root / "bench" / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])]

    def metric_reader(self, name: str):
        """The module ``bench/metrics/<name>.py`` (its ``read(records)``)."""
        path = self.root / "bench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{name.replace('-', '_').replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


__all__ = ["Spec"]
