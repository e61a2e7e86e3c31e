"""Run one cell of the pl_fem_tpu_torch benchmark on the CUDA device.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. The last line of
standard output is the result (JSON); the numbers compared with the
plain reference are the last lines of standard error. The exit code is
not 0, and no result is printed, without enough CUDA devices, without
the program, or when JAX or the JAX package was loaded.
"""
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed paths inside the checkout: only a checkout's
# first run compiles (the program's nvcc library lives in its own
# pl_fem_tpu_torch/_build/)
CACHE = ROOT / "benchmark" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TRITON_HOME"] = str(CACHE)

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.cell import main

    sys.exit(main(t_start=T_START))
