"""Outer (beta) rounds of the vectorial sweep per design: the program's
``pl_fem.beta_round`` host spans (one a round: its filter, transfer,
polish and post-processing) that lie inside no ``pl_fem.bootstrap``
span, the fine grid's rounds, over the designs of the traced requests.
The bootstrap's coarse sweeps run rounds of their own, inside its span,
and are left out. Nothing without such spans.

A round of a sweep serves all its B designs at once, so this counts the
rounds of each design only in cells of single-design requests (B = 1);
a cell of B-design sweeps wants rounds per sweep."""
from benchmark.harness.trace import REQUEST_SPAN

SPAN = "pl_fem.beta_round"
BOOTSTRAP = "pl_fem.bootstrap"


def read(win):
    t = win.trace
    if t is None:
        return None
    boots = [(a, b) for name, a, b in t.host_events if name == BOOTSTRAP]
    rounds = [(a, b) for name, a, b in t.host_events if name == SPAN
              and not any(a0 <= a and b <= b0 for a0, b0 in boots)]
    n_req = sum(1 for name, _, _ in t.host_events if name == REQUEST_SPAN)
    designs = sum(r["designs"] for r in win.requests[:n_req])
    if not rounds or not designs:
        return None
    return len(rounds) / designs
