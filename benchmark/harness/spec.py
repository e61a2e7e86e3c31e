"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the configuration names the entry that
drives the program (``entries/<entry>.py``) and its plain reference
(``reference/<reference>.py``); each per-layer metric is a reader of its
own (``metrics/<name>.py``), and a kernel's operation and byte count
lives in ``roofline/<kernel>.py``. Adding any of them is a new file and
new entries in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark as a module (names may hold
    dots, so the file is loaded by its path)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"benchmark_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its entry in BENCHMARK.json, configuration, traffic,
    and the metrics it reports."""

    def __init__(self, bench: dict, name: str):
        self.bench = bench
        self.spec = find(bench["workloads"], name, "workload")
        self.name = name
        self.config = config(bench, self.spec["config"])
        self.traffic = traffic(self.spec["traffic"])
        self.chips = int(self.spec["chips"])

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    @property
    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    @property
    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self._reports(m)]
