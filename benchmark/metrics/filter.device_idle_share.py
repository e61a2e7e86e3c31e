"""Share of the program's ``filter`` phase (the ``pl_fem.filter`` host
spans of the traced requests) in which no kernel, copy or set ran on
the device: 1 - (union of the device intervals clipped to each span) /
(the spans' total length), in percent. Nothing without such spans."""
from benchmark.harness import stats
from benchmark.harness.trace import REQUEST_SPAN

SPAN = "pl_fem.filter"


def read(win):
    t = win.trace
    if t is None:
        return None
    spans = [(a, b) for name, a, b in t.host_events if name == SPAN]
    total = sum(b - a for a, b in spans)
    if total <= 0:
        return None
    # a device-side copy of a host range spans idle time: never busy
    busy = [(a, b) for name, a, b in t.device_events
            if name != REQUEST_SPAN and not name.startswith("pl_fem.")]
    inside = sum(stats.union_length(busy, a, b) for a, b in spans)
    return 100.0 * (1.0 - inside / total)
