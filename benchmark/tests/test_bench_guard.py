"""What a run refuses: JAX or the JAX package in the process (by whole
top-level name), a host without a CUDA device, a directory without the
program; and the reference's independence from the program."""
import ast
import json
import shutil
import subprocess
import sys
import types

import pytest

from benchmark.harness import cell, spec

REF_DIR = spec.BENCH_DIR / "reference"


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("pl_fem_tpu", True), ("pl_fem_tpu.ops.kernels", True),
    ("pl_fem_tpu_torch", False), ("pl_fem_tpu_torch.ops", False),
    ("jaxtyping", False), ("pl_fem_tpu2", False)])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, bad):
    for m in [m for m in sys.modules if m.split(".")[0] in cell.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(cell.forbidden_modules()) is bad


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]] if not node.level \
                else []
        else:
            continue
        for top in tops:
            assert top in ("numpy", "scipy", "torch", "__future__",
                           "dataclasses"), (path.name, top)


def test_reference_loads_no_program_module():
    code = ("import sys\n"
            "import benchmark.reference.vectorial, benchmark.reference.scalar\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('pl_fem_tpu_torch', 'pl_fem_tpu', 'jax', 'jaxlib')]\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr


def _run(cwd, args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", "hex7_scalar_deg600_band", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def test_fails_without_a_cuda_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(spec.ROOT, ARGS)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_fails_without_the_program(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    r = _run(tmp_path, ARGS)
    assert r.returncode != 0 and r.stdout == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(r.stdout or "x")
