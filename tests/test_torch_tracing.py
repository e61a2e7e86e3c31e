"""The port's profiler spans (``utils.span``): a host range
``pl_fem.<name>`` over every ``PhaseTimer`` phase and every filter and
Rayleigh-Ritz pass (``rr_pass``), on the profiler's clock while
``torch.profiler`` runs, and no range at all otherwise.

On CPU tensors (the kernel wrappers run their plain twins): a small
scalar solve and a two-design vectorial sweep, each under
``torch.profiler`` with CPU activity, with the filters cut to degree
10: reading the profiler's events takes longer than the solve. The card's side (no device-side
copy of a span) is ``test_spans_leave_no_device_event`` in
tests/test_torch_cuda.py.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig, SolverConfig
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.solvers import (ScalarHelmholtzSolver,
                                      TrueVectorialMaxwellSolver)
from pl_fem_tpu_torch.utils import PhaseTimer, profiling, span

torch.set_num_threads(1)

SCALAR_PHASES = {"host_build", "assemble", "filter", "xfer", "polish",
                 "postproc", "cascade"}
OUTER = "test.solve"


def _spans(prof):
    """(name without the prefix, start, end, event) of every pl_fem.
    host event, and the (start, end) of the test's outer range."""
    spans, outer = [], None
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.name == OUTER:
            outer = rng
        elif e.name.startswith(profiling.SPAN_PREFIX):
            spans.append((e.name[len(profiling.SPAN_PREFIX):], *rng, e))
    return spans, outer


def _count_gate_calls(monkeypatch):
    """Count the pass loop's calls of ``ritz_residual_gate`` (one a
    pass, in both loops)."""
    calls = []
    gate = tk.ritz_residual_gate

    def counted(*a, **kw):
        calls.append(1)
        return gate(*a, **kw)

    monkeypatch.setattr(tk, "ritz_residual_gate", counted)
    return calls


@pytest.fixture(scope="module")
def fiber():
    geom = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55,
                       use_complex_pml=False)
    mesh = dict(mesh_min_points=600, mesh_target_points=2500,
                mesh=MeshConfig(bucket_rounding=256))
    dg = export_device_grid(MeshGenerator.generate(
        geom, 0.4, SimulationConfig(**mesh)), 256)
    cfg = SimulationConfig(**mesh, solver=SolverConfig(
        device="cpu", cheb_degree=10, cheb_passes=2, scalar_tol=1e-2))
    return geom, dg, cfg


@pytest.fixture(scope="module")
def traced_scalar(fiber):
    """One scalar solve (cascade selection) under the profiler: its
    spans, the outer range, the solver's phase times and the number of
    passes its loop ran."""
    geom, dg, cfg = fiber
    mp = pytest.MonkeyPatch()
    calls = _count_gate_calls(mp)
    try:
        solver = ScalarHelmholtzSolver(geom, cfg)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(OUTER):
                modes = solver.solve(dg, 4, mode_filter="cascade")
    finally:
        mp.undo()
    assert modes
    spans, outer = _spans(prof)
    return dict(spans=spans, outer=outer, times=solver.last_solve_times,
                passes=len(calls))


def test_one_span_per_scalar_phase(traced_scalar):
    """Exactly one pl_fem.<phase> host event per key of
    ``last_solve_times``, each inside the solve's wall time and no
    longer than the phase's timed seconds."""
    times = traced_scalar["times"]
    lo, hi = traced_scalar["outer"]
    phases = [s for s in traced_scalar["spans"] if s[0] != "rr_pass"]
    assert sorted(name for name, *_ in phases) == sorted(times)
    for name, a, b, _ in phases:
        assert lo <= a <= b <= hi
        assert (b - a) / 1e6 <= times[name] + 1e-3


def test_phases_cover_the_solve(traced_scalar):
    """The phases' spans, which do not overlap, cover all but a small
    share of the solve's wall time: what runs under no span (the
    geometry, the grid checks, the mode records) stays small: 0.3% of
    this solve, 0.2-0.4% of the benchmark's requests on the card."""
    lo, hi = traced_scalar["outer"]
    phases = sorted((a, b) for name, a, b, _ in traced_scalar["spans"]
                    if name != "rr_pass")
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(phases, phases[1:]))
    bare = (hi - lo) - sum(b - a for a, b in phases)
    assert bare <= 0.05 * (hi - lo)


def test_one_span_per_pass(traced_scalar):
    """As many pl_fem.rr_pass events as the pass loop ran, all inside
    the filter phase."""
    passes = [s for s in traced_scalar["spans"] if s[0] == "rr_pass"]
    (fa, fb), = [(a, b) for name, a, b, _ in traced_scalar["spans"]
                 if name == "filter"]
    assert traced_scalar["passes"] >= 2
    assert len(passes) == traced_scalar["passes"]
    assert all(fa <= a <= b <= fb for _, a, b, _ in passes)


def test_spans_are_no_user_annotations(traced_scalar):
    """No pl_fem. event is a user annotation: kineto mirrors those onto
    the device, where they would count as busy."""
    events = [e for *_, e in traced_scalar["spans"]]
    assert events and not any(e.is_user_annotation for e in events)


def test_phase_timer_keeps_its_sums(traced_scalar):
    """``PhaseTimer.times`` keeps its keys (the scalar device path's
    phases) and sums repeated phases; ``total`` and ``summary`` read
    them as before."""
    assert set(traced_scalar["times"]) == SCALAR_PHASES
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("a"):
            pass
    with t.phase("b"):
        pass
    assert list(t.times) == ["a", "b"]
    assert t.total == pytest.approx(t.times["a"] + t.times["b"])
    assert t.summary().startswith("a=") and " | b=" in t.summary()


def test_no_range_without_profiler(monkeypatch):
    """With no profiler running the helper enters no profiler range
    (it hands back one shared null context); under a profiler it opens
    the host range; where torch lacks that range there is no span, not
    a user annotation."""
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_HostRange", Range)
    with span("off"):
        pass
    with PhaseTimer().phase("off"):
        pass
    assert opened == [] and span("off") is span("other")
    with profile(activities=[ProfilerActivity.CPU]):
        with span("on"):
            pass
    assert opened == ["pl_fem.on"]

    monkeypatch.setattr(profiling, "_HostRange", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("missing"):
            torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name.startswith("pl_fem.")]


def test_sweep_spans(monkeypatch):
    """A two-design vectorial sweep: every key of ``last_sweep_times``
    has its spans (a phase entered once per design has one per entry),
    one pl_fem.rr_pass per pass of ``solve_lowest_sweep``, and one
    pl_fem.beta_round for its one outer round."""
    cfg = SimulationConfig(
        mesh_min_points=200, mesh_target_points=900,
        mesh=MeshConfig(bucket_rounding=128),
        solver=SolverConfig(device="cpu", cheb_degree=10, cheb_passes=2,
                            beta_passes=1, bootstrap=False, binv_degree=1,
                            extra_vectors=4))
    gs = [MCFGeometry(3, 8.0, 1.3, 1.53, 1.0, wavelength_um=w)
          for w in (1.50, 1.60)]
    dg = export_device_grid(MeshGenerator.generate(gs[0], 0.35, cfg), 128)
    calls = _count_gate_calls(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            out = TrueVectorialMaxwellSolver.solve_sweep(gs, dg, 4, cfg)
    assert len(out) == 2
    spans, (lo, hi) = _spans(prof)
    times = TrueVectorialMaxwellSolver.last_sweep_times
    names = [name for name, *_ in spans]
    assert set(names) == set(times) | {"rr_pass", "beta_round"}
    assert names.count("rr_pass") == len(calls) >= 2
    assert names.count("beta_round") == 1
    assert names.count("filter") == 1 and names.count("polish") == 2
    for name in times:
        dur = sum(b - a for n, a, b, _ in spans if n == name) / 1e6
        assert dur <= times[name] + 1e-3
    assert all(lo <= a <= b <= hi for _, a, b, _ in spans)

