import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Cells that wait under PERF.md's Open questions for a fix in the
# program (name, configuration, traffic): not in BENCHMARK.json, their
# files kept and held to the comparison on the CPU.
OPEN_CELLS = [("hex7_vec_band8", "hex7_vectorial_fast", "band8"),
              ("hex7_scalar_band", "hex7_scalar_lp", "band1"),
              ("hex7_vec_single", "hex7_vectorial_fast", "band1")]


def with_open_cells(bench: dict) -> dict:
    """``bench`` with the open cells and their configurations added."""
    known = {c["name"] for c in bench["configs"]}
    for name, config, traffic in OPEN_CELLS:
        if config not in known:
            known.add(config)
            bench["configs"].append({
                "name": config, "source": "PERF.md", "reduced": [],
                "file": f"benchmark/configs/{config}.json", "why": "open"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "open"})
    return bench


@pytest.fixture
def open_cells(monkeypatch):
    """The harness reads a BENCHMARK.json that also holds the open
    cells."""
    from benchmark.harness import spec

    bench = with_open_cells(spec.load_benchmark())
    monkeypatch.setattr(spec, "load_benchmark", lambda: bench)
    return bench
