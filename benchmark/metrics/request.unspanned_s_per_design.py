"""Seconds of the traced requests (``benchmark.request`` host spans)
that no ``pl_fem.`` host span of the program covers (the solver's
construction and geometry, the random start block, the code between
phases, the entry's synchronise), over the designs of the traced
requests. Nothing without such spans."""
from benchmark.harness import stats
from benchmark.harness.trace import REQUEST_SPAN


def read(win):
    t = win.trace
    if t is None:
        return None
    requests = [(a, b) for name, a, b in t.host_events
                if name == REQUEST_SPAN]
    spans = [(a, b) for name, a, b in t.host_events
             if name.startswith("pl_fem.")]
    designs = sum(r["designs"] for r in win.requests[:len(requests)])
    if not spans or not designs:
        return None
    bare = sum((b - a) - stats.union_length(spans, a, b)
               for a, b in requests)
    return bare / 1e6 / designs
