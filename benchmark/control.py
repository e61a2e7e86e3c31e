"""The control of a cell's comparison: the plain reference, computed in
float32 (the precision below the float64 polish the configuration
states), put in the program's place, and judged as a run judges the
program. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--designs 1]

For each seed it takes the designs of the seed's first window request
(the stream a run draws, after its warm-up request), ``--designs`` of
them, and prints the compared numbers beside their limits. Runs on the
host; the card is not used.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, designs: int, dtype=np.float32,
             overrides=None) -> dict:
    """Worst compared numbers of the control over ``designs`` designs of
    the seed's first window request."""
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, spec
    from benchmark.reference import judge

    c = spec.Cell(spec.load_benchmark(), workload)
    if overrides:
        cell._deep_update(c.config, overrides)
    ref = importlib.import_module(
        f"benchmark.reference.{c.config['reference']}")
    checker = ref.Checker(c.config)
    stream = cell.requests(c.traffic, seed)
    next(stream)                                   # the warm-up request
    wls = next(stream)
    limits = c.config["correct"]["limits"]
    n = int(c.config["n_modes"])
    rows = []
    for wl in wls[:designs]:
        modes = checker.exact(wl, dtype=dtype)
        rows.append(checker.numbers(wl, modes))
        if "neff_gap" in limits:
            rows[-1]["neff_gap"] = judge.neff_gap(modes, checker.exact(wl), n)
    return {k: {"value": max(r[k] for r in rows), "limit": v}
            for k, v in limits.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--designs", type=int, default=1)
    a = ap.parse_args(argv)
    failed_all = True
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        nums = readings(a.workload, seed, a.designs)
        fails = [k for k, v in nums.items() if v["value"] > v["limit"]]
        failed_all &= bool(fails)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "numbers": nums, "fails": fails}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
