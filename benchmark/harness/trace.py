"""The traced part of a run: ``torch.profiler`` over the first requests
of the window, and the per-launch work of the kernels that a roofline
file counts.

Device intervals (kernels, copies, sets) and host events come from the
profiler's events, all in microseconds on one clock. A roofline file
names the program's wrapper of its kernel (``WRAPS``); while the traced
requests run, the wrapper is replaced, in every module of the program
that imported it by name, by one that records the work of each call
from its arguments (``work``) and then calls it.
"""
from __future__ import annotations

import functools
import importlib
import sys

from . import stats

REQUEST_SPAN = "benchmark.request"


class WorkRecorder:
    """Per-call (bytes, flops) of each roofline kernel's wrapper."""

    def __init__(self, rooflines: dict):
        self.rooflines = rooflines            # kernel name -> module
        self.work = {name: [] for name in rooflines}
        self._patched = []

    def install(self):
        for name, rl in self.rooflines.items():
            mod_name, attr = rl.WRAPS.rsplit(".", 1)
            home = importlib.import_module(mod_name)
            orig = getattr(home, attr)
            log = self.work[name]

            @functools.wraps(orig)
            def wrapper(*args, __orig=orig, __work=rl.work, __log=log, **kw):
                __log.append(__work(*args, **kw))
                return __orig(*args, **kw)

            top = mod_name.split(".")[0]
            for mname, mod in list(sys.modules.items()):
                if mod is None or mod is home:
                    continue
                if mname.split(".")[0] != top:
                    continue
                for key, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, key, wrapper)
                        self._patched.append((mod, key, orig))

    def remove(self):
        for mod, key, orig in reversed(self._patched):
            setattr(mod, key, orig)
        self._patched.clear()


def start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


class Trace:
    """What the per-layer readers read from a traced window."""

    def __init__(self, prof, work: dict):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.device_events = []       # (name, start_us, end_us)
        self.host_events = []
        requests = []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if e.device_type == cuda:
                # the device-side copy of a host annotation spans idle
                # time: only kernels, copies and sets count as busy
                if e.name != REQUEST_SPAN:
                    self.device_events.append((e.name, *rng))
            else:
                self.host_events.append((e.name, *rng))
                if e.name == REQUEST_SPAN:
                    requests.append(rng)
        if not requests:
            raise RuntimeError("the traced window holds no request span")
        self.lo = min(a for a, _ in requests)
        self.hi = max(b for _, b in requests)
        self.window_s = (self.hi - self.lo) / 1e6
        self.busy_s = stats.union_length(
            [(a, b) for _, a, b in self.device_events], self.lo, self.hi) / 1e6
        self.work = work

    def kernel_times(self, symbol: str):
        """Device seconds of each launch whose kernel name holds
        ``symbol``, in launch order."""
        return [(b - a) / 1e6 for name, a, b in sorted(
            self.device_events, key=lambda ev: ev[1]) if symbol in name]

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for name, a, b in self.device_events:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = stats.gaps([(a, b) for _, a, b in self.device_events],
                          self.lo, self.hi)
        idle.sort(key=lambda g: g[0] - g[1])
        labelled = {}
        for a, b in idle[:top]:
            key = self._host_label((a + b) / 2)
            labelled[key] = labelled.get(key, 0.0) + (b - a) / 1e6
        gaps = sorted(labelled.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}

    def _host_label(self, t: float) -> str:
        """The innermost host event in flight at ``t``."""
        best = None
        for name, a, b in self.host_events:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        if best is None:
            return "no host event"
        if best[0] == REQUEST_SPAN:
            return "request: host code outside torch ops"
        return best[0]
