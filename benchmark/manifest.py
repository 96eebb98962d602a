"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry, its
``file`` under ``benchmark/configs/``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); its correctness limits are in
``benchmark/limits/<cell>.json``; each metric is read by
``benchmark/metrics/<metric>.py``'s ``read(record)``.  A later cell, mix,
configuration or metric is added by adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import os

__all__ = ["ROOT", "BENCH_DIR", "load", "Cell", "metric_reader"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    limits and metrics."""

    def __init__(self, manifest: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; the manifest has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = _read_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.traffic = _read_json(os.path.join(BENCH_DIR, "traffic",
                                               self.entry["traffic"] + ".json"))
        self.limits = _read_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
        self.end_to_end = [m for m in manifest["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
