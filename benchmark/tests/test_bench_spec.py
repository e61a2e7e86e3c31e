"""BENCHMARK.json keeps to the contract's characters and shapes, and the
harness finds every configuration, mix, reader and roofline file by
name; a new one is a new file plus new entries."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec
from conftest import OPEN_CELLS, with_open_cells

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[key]:
            yield item["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]]
                         + [name for name, _, _ in OPEN_CELLS])
def test_cell_parts_found_by_name(cell):
    import importlib

    c = spec.Cell(with_open_cells(json.loads(json.dumps(BENCH))), cell)
    assert c.config["n_modes"] > 0 and c.traffic["designs_per_request"] > 0
    importlib.import_module(f"benchmark.entries.{c.config['entry']}")
    importlib.import_module(f"benchmark.reference.{c.config['reference']}")
    for m in c.per_layer:
        reader = spec.load_module("metrics", m["name"])
        assert callable(reader.read)
        if hasattr(reader, "ROOFLINE"):
            rl = spec.load_module("roofline", reader.ROOFLINE)
            assert rl.KERNEL and rl.WRAPS and callable(rl.work)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "designs_per_s"} <= names


def test_solver_seed_is_the_runs():
    """The program's start is drawn from the run's seed, whatever the
    configuration holds."""
    from benchmark.entries.common import Program

    cfg = spec.config(BENCH, BENCH["workloads"][0]["config"])
    cfg["solver"]["seed"] = 11
    cfg["mesh"].update(mesh_min_points=600, mesh_target_points=600,
                       refinement=0.2, bucket_rounding=256, n_dofs=None)
    assert Program(cfg, 2 ** 31 + 3, "cpu").sim.solver.seed == 2 ** 31 + 3


NEW_FILES = {
    "configs/toy_cfg.json": {"n_modes": 3, "entry": "scalar_solve",
                             "reference": "scalar"},
    "traffic/toy_mix.json": {"designs_per_request": 2,
                             "wavelength_um": [1.5, 1.6]},
}
NEW_READER = "def read(win):\n    return 1.0\n"
NEW_ROOFLINE = ("KERNEL = 'toy_kernel'\nWRAPS = 'toy.wrapper'\n\n"
                "def work(*a, **k):\n    return (1, 0)\n")


def test_additions_need_no_edit(tmp_path):
    """A throw-away configuration, mix, reader and roofline count, added
    as new files and entries in a copy, are found by name."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    for rel, body in NEW_FILES.items():
        (tmp_path / "benchmark" / rel).write_text(json.dumps(body))
    (tmp_path / "benchmark/metrics/toy.reader.py").write_text(NEW_READER)
    (tmp_path / "benchmark/roofline/toy_kernel.py").write_text(NEW_ROOFLINE)
    bench["configs"].append({"name": "toy_cfg", "source": "x",
                             "file": "benchmark/configs/toy_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy_cfg",
                               "traffic": "toy_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "toy.reader", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "designs_per_s",
                               "workloads": ["toy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from benchmark.harness import spec\n"
            "c = spec.Cell(spec.load_benchmark(), 'toy_cell')\n"
            "assert c.config['n_modes'] == 3 and c.traffic['designs_per_request'] == 2\n"
            "assert [m['name'] for m in c.per_layer][-1] == 'toy.reader'\n"
            "assert spec.load_module('metrics', 'toy.reader').read(None) == 1.0\n"
            "assert spec.load_module('roofline', 'toy_kernel').work() == (1, 0)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
