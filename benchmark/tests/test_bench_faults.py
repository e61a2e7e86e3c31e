"""The comparison fails what it must: the control (the reference in
float32 in the program's place) and runs with the timed path broken
underneath, driven on the CPU at a tiny mesh without the harness's look
for a card. The cells have one chip, so there is no exchange between
chips to leave out. The vectorial cell waits under PERF.md's Open
questions; its faults are held here all the same."""
import pytest
import torch

from benchmark import control
from benchmark.harness import cell

TINY = {"mesh": {"mesh_min_points": 600, "mesh_target_points": 600,
                 "refinement": 0.2, "bucket_rounding": 256, "n_dofs": None},
        "solver": {"cheb_degree": 100}}


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(1)


def _run(workload, designs=None, seed=11):
    rc, out = cell.run(workload, seed, 0.0, False, 0.0, device="cpu",
                       overrides=TINY, traffic_overrides=(
                           {"designs_per_request": designs} if designs
                           else None))
    assert rc == 0
    return out


def _failed(out):
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


CELL = "hex7_scalar_deg600_band"


@pytest.mark.parametrize("workload", ["hex7_vec_band8", CELL])
def test_control_is_not_correct(workload, open_cells):
    nums = control.readings(workload, 5, 1, overrides=TINY)
    failed = [k for k, v in nums.items() if v["value"] > v["limit"]]
    assert {"rq_gap", "conf_gap"} <= set(failed)


def test_sound_run_is_correct():
    out = _run(CELL)
    assert out["correct"] and not _failed(out)


def test_answer_altered_where_produced(monkeypatch):
    """The f64 polish's eigenvalues moved by 2e-6 relative."""
    from pl_fem_tpu_torch.ops import host_assembly

    rr = host_assembly.HostScalarPencil.rr

    def altered(self, X):
        theta, V, res = rr(self, X)
        return theta * (1.0 + 2e-6), V, res

    monkeypatch.setattr(host_assembly.HostScalarPencil, "rr", altered)
    out = _run(CELL)
    assert not out["correct"] and "rq_gap" in _failed(out)


def test_step_returns_its_state_unchanged(monkeypatch):
    """Every Chebyshev step of the filter returns its input."""
    from pl_fem_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "cheb_step",
                        lambda W, V, T0, c, h, **kw: (V.clone(), None))
    out = _run(CELL)
    assert not out["correct"]


def test_filter_stopped_early(monkeypatch):
    """The filter stops after one pass, as a stall rule that gives up
    too soon does: the modes come back consistent and off."""
    from pl_fem_tpu_torch.solvers import scalar

    lowest = scalar.solve_lowest_kernel

    def early(*a, **kw):
        return lowest(*a, **{**kw, "passes": 1, "max_passes": 1})

    monkeypatch.setattr(scalar, "solve_lowest_kernel", early)
    out = _run(CELL)
    assert not out["correct"] and "neff_gap" in _failed(out)


def test_half_of_the_batch_left_out(monkeypatch, open_cells):
    """The sweep solves the first half of its designs and returns their
    modes for the other half too."""
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver as TV

    sweep = TV.solve_sweep.__func__

    def half(cls, geoms, *a, **kw):
        h = max(1, len(geoms) // 2)
        out = sweep(cls, geoms[:h], *a, **kw)
        return out + out[:len(geoms) - h]

    monkeypatch.setattr(TV, "solve_sweep", classmethod(half))
    out = _run("hex7_vec_band8", designs=2)
    assert not out["correct"] and "rq_gap" in _failed(out)
