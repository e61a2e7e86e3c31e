"""One run of one cell: set-up and warm-up, the measured window, the
metrics, the comparison with the plain reference, the result line.

The window is a closed loop with one client: requests are issued while
less than ``seconds`` have passed since the first one, the next when the
previous returns, and the window ends when the last one returns. A
request's time runs from its call to its return, after the device has
synchronised. With ``trace`` the first ``traced_requests`` of the window
(the traffic file says how many) run under the profiler, and the
per-layer metrics are reported instead of the end-to-end ones.
"""
from __future__ import annotations

import gc
import importlib
import json
import sys
import time

import numpy as np

from . import spec, stats
from .trace import REQUEST_SPAN, Trace, WorkRecorder, start_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "pl_fem_tpu")
GIB = float(1 << 30)


class Window:
    """What the per-layer readers read from the measured window."""

    def __init__(self):
        self.requests = []        # dicts: start, end, designs, phases
        self.counters = {}        # dotted counter path -> delta
        self.trace = None         # Trace of the traced requests, or None
        self.device_kind = None   # torch.cuda.get_device_name(0)

    @property
    def designs(self) -> int:
        return sum(r["designs"] for r in self.requests)

    def phase_sum(self, names) -> float:
        return sum(v for r in self.requests for k, v in r["phases"].items()
                   if k in names)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _resolve(path: str):
    mod, attr = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), attr)


def _counters(paths) -> dict:
    return {p: int(_resolve(p).launches) for p in paths}


def requests(traffic: dict, seed: int):
    """The request stream of a seed: each request is the wavelengths
    (um) of its designs, drawn uniformly from the traffic's band and
    sorted."""
    rng = np.random.default_rng(seed)
    lo, hi = traffic["wavelength_um"]
    n = int(traffic["designs_per_request"])
    while True:
        yield [float(w) for w in np.sort(rng.uniform(lo, hi, n))]


def _deep_update(d: dict, new: dict) -> dict:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _deep_update(d[k], v)
        else:
            d[k] = v
    return d


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", overrides: dict = None,
        traffic_overrides: dict = None, log=None):
    """Run the cell; return ``(exit code, result dict or None)``.

    ``device`` other than "cuda" and the overrides (merged into the
    configuration and the traffic) exist for the CPU tests, which drive
    a run without a card at a small size."""
    log = log or sys.stderr
    bench = spec.load_benchmark()
    cell = spec.Cell(bench, workload)
    _deep_update(cell.config, overrides or {})
    _deep_update(cell.traffic, traffic_overrides or {})
    cfg, traffic = cell.config, cell.traffic

    import torch

    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        print(f"benchmark: cell {workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=log)
        return 2, None

    entry = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    reference = importlib.import_module(
        f"benchmark.reference.{cfg['reference']}")
    readers = {m["name"]: spec.load_module("metrics", m["name"])
               for m in cell.per_layer} if trace else {}
    counter_paths = sorted({p for r in readers.values()
                            for p in getattr(r, "COUNTERS", ())})
    rooflines = {r.ROOFLINE: spec.load_module("roofline", r.ROOFLINE)
                 for r in readers.values() if hasattr(r, "ROOFLINE")}

    # -- set-up: the program, its mesh and device grid, one warm request
    stream = requests(traffic, seed)
    t_imports = time.perf_counter()
    system = entry.System(cfg, seed, device)
    t_grid = time.perf_counter()
    system.request(next(stream))
    if on_card:
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"benchmark: set-up {setup_s:.3f} s: start and imports "
          f"{t_imports - t_start:.3f} s, program import, mesh and device "
          f"grid {t_grid - t_imports:.3f} s, warm-up request "
          f"{t_warm - t_grid:.3f} s", file=log)

    # -- the window
    win = Window()
    win.device_kind = torch.cuda.get_device_name(0) if on_card else device
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = _counters(counter_paths)
    n_traced = int(traffic.get("traced_requests", 1)) if trace else 0
    recorder = WorkRecorder(rooflines) if n_traced else None
    prof = None
    results, failed = [], 0
    t0 = time.perf_counter()
    while (len(win.requests) < max(1, n_traced)
           or time.perf_counter() - t0 < seconds):
        wls = next(stream)
        traced = len(win.requests) < n_traced
        if traced and prof is None:
            recorder.install()
            prof = start_profiler()
        ts = time.perf_counter()
        try:
            if traced:
                from torch.profiler import record_function

                with record_function(REQUEST_SPAN):
                    out = system.request(wls)
            else:
                out = system.request(wls)
        except Exception as e:    # a failed request is counted, not fatal
            print(f"benchmark: request failed: {e!r}", file=log)
            failed += 1
            out = None
        te = time.perf_counter()
        win.requests.append({"start": ts - t0, "end": te - t0,
                             "designs": 0 if out is None else len(wls),
                             "phases": system.phases()})
        if out is not None:
            results.extend(zip(wls, system.keep(out)))
        if prof is not None and len(win.requests) == n_traced:
            prof.__exit__(None, None, None)
            recorder.remove()
            win.trace = Trace(prof, recorder.work)
            prof = None
    elapsed = win.requests[-1]["end"]
    print("benchmark: request seconds " + " ".join(
        f"{r['end'] - r['start']:.3f}" for r in win.requests), file=log)
    win.counters = {p: v - before[p] for p, v in _counters(
        counter_paths).items()}
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=log)
        return 3, None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = len(win.requests)

    # -- metrics
    metrics = {}
    if not trace:
        values = {"designs_per_s": stats.rate(win.designs, elapsed),
                  "request_s_p90": stats.p90(
                      r["end"] - r["start"] for r in win.requests),
                  "peak_mem_gib": peak / GIB,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = readers[m["name"]].read(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = _device(on_card, max(peak, setup_peak), cell.chips)
    if win.trace is not None:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s

    # -- the comparison, once the program's state is freed
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = judge(reference, cfg, results, seed, log)
    correct = (failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=log)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if win.trace is not None:
        out["breakdown"] = win.trace.breakdown()
    out["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=log)
        return 3, None
    return 0, out


def judge(reference, cfg: dict, results, seed: int, log) -> dict:
    """The reference's numbers over every design of the window, and
    ``neff_gap`` against its exact modes on the configuration's
    ``exact_designs`` designs drawn from the seed; each compared number
    beside its limit."""
    from benchmark.reference import judge as rj

    corr = cfg["correct"]
    t = time.perf_counter()
    checker = reference.Checker(cfg)
    rows = [checker.numbers(wl, modes) for wl, modes in results]
    n = int(cfg["n_modes"])
    picks = np.random.default_rng([seed, 1]).permutation(len(results))
    for i in picks[:int(corr.get("exact_designs", 1))]:
        wl, modes = results[i]
        ref = checker.exact(wl)
        if len(ref) < n:
            print(f"benchmark: the reference finds {len(ref)} guided modes "
                  f"at {wl!r} um, fewer than {n}", file=log)
        rows[i]["neff_gap"] = rj.neff_gap(modes, ref, n)
        print(f"benchmark: design at {wl!r} um: n_eff "
              f"{[round(float(m['n_eff']), 7) for m in modes[:n]]}, "
              f"reference {[round(float(m['n_eff']), 7) for m in ref[:n]]}, "
              f"neff_gap {rows[i]['neff_gap']!r}", file=log)
    print(f"benchmark: reference held {len(rows)} designs in "
          f"{time.perf_counter() - t:.1f} s", file=log)
    limits = corr["limits"]
    if not rows:
        return {k: {"value": float("inf"), "limit": v}
                for k, v in limits.items()}
    return {k: {"value": float(max(r[k] for r in rows if k in r)),
                "limit": v} for k, v in limits.items()}


def _device(on_card: bool, peak: int, chips: int) -> dict:
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    rc, out = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    if out is not None:
        sys.stdout.flush()
        print(json.dumps(out), flush=True)
    return rc
