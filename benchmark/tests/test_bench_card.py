"""A short run of a cell on the card, the result line as the driver
reads it (``-m cuda``; skipped without a CUDA device)."""
import json
import subprocess
import sys

import pytest

from benchmark.harness import spec


@pytest.mark.cuda
def test_scalar_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "hex7_scalar_deg600_band", "--seed", "3000000001",
                        "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"designs_per_s", "request_s_p90",
                                   "peak_mem_gib", "setup_s"}
    assert list(out)[-1] == "checks"
