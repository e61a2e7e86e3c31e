"""Compile the native host-runtime kernels: g++ -O3 -shared -fPIC."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).parent
BUILD_DIR = HERE.parent / "_build"


def build(verbose: bool = False) -> Path:
    src = HERE / "pattern.cpp"
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / "_native.so"
    # build to a private name, then rename: concurrent test workers may
    # build at once, and none may load a half-written library
    tmp = BUILD_DIR / f"_native.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", str(src), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=not verbose)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    path = build(verbose=True)
    print(f"built {path}")
    sys.exit(0)
