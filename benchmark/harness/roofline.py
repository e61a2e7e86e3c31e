"""A kernel's share of its roofline: the least time its launches could
take on the card (the larger of bytes over peak bandwidth and f32
operations over the peak f32 rate, launch by launch, summed) over the
device time the profiler read for them."""
from __future__ import annotations

import json

from . import spec


def peaks(kind: str) -> dict:
    table = json.loads((spec.BENCH_DIR / "peaks.json").read_text())
    return table.get(kind)


def least_seconds(work, peak: dict) -> float:
    return sum(max(b / peak["hbm_bytes_per_s"], f / peak["f32_flops_per_s"])
               for b, f in work)


def share(win, kernel: str):
    """Percent of the roofline, or None where the traced window holds no
    launch of the kernel, the recorded calls and the traced launches
    disagree, or the card has no entry in the table of peaks."""
    t = win.trace
    if t is None:
        return None
    rl = spec.load_module("roofline", kernel)
    times = t.kernel_times(rl.KERNEL)
    work = t.work.get(kernel, [])
    peak = peaks(win.device_kind)
    if not times or len(times) != len(work) or peak is None:
        return None
    return 100.0 * least_seconds(work, peak) / sum(times)
