"""Rayleigh-Ritz passes per design: the program's ``pl_fem.rr_pass``
host spans (one a filter and Rayleigh-Ritz pass, its read of the gate
included) over the designs of the traced requests. Nothing without
such spans.

A pass of a sweep serves all its B designs at once, so this counts the
passes of each design only in cells of single-design requests (B = 1,
as the scalar solve); a cell of B-design sweeps wants passes per
sweep."""
from benchmark.harness.trace import REQUEST_SPAN


def read(win):
    t = win.trace
    if t is None:
        return None
    names = [name for name, _, _ in t.host_events]
    passes = names.count("pl_fem.rr_pass")
    designs = sum(r["designs"]
                  for r in win.requests[:names.count(REQUEST_SPAN)])
    if not passes or not designs:
        return None
    return passes / designs
