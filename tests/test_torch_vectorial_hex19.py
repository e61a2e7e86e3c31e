"""The port's vectorial sweep on the 19-core lantern (BASELINE config 3:
hex 1+6+12, r 1.5 um, pitch 8 um, n_core 1.535 in air) on CPU tensors
(the kernels' plain twins), at the smallest 19-core mesh (refinement
0.2, 15184 DOFs): its n_eff against the benchmark's plain reference
(``benchmark/reference/hex19.py``), and one ``pl_fem.beta_round`` span
per outer round of the sweep.

The spans are recorded without a profiler: ``utils.profiling``'s host
range is replaced by a recorder that keeps each range's name and the
ranges open around it."""
import threading

import pytest
import torch

from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig, solver_preset
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver
from pl_fem_tpu_torch.solvers import vectorial
from pl_fem_tpu_torch.utils import profiling

WL = 1.57
N_MODES = 4
ROUND = "pl_fem.beta_round"


class _Recorder:
    """Stands in for the profiler's host range: each range entered is
    kept as (name, names of the ranges open around it)."""

    def __init__(self):
        self.stack, self.ranges = [], []

    def __call__(self, name):
        rec = self

        class Range:
            def __enter__(self):
                rec.ranges.append((name, tuple(rec.stack)))
                rec.stack.append(name)
                return self

            def __exit__(self, *exc):
                assert rec.stack.pop() == name
                return False

        return Range()


@pytest.fixture(scope="module")
def sweep():
    """One balanced-preset sweep of the 19-core lantern at 1.57 um with
    its spans recorded and the filter's calls counted by the nesting
    depth of the sweep that made them (1: this call, 2: a bootstrap's)."""
    torch.set_num_threads(4)
    mp = pytest.MonkeyPatch()
    rec, depths = _Recorder(), []
    lowest = vectorial.solve_lowest_sweep

    def counted(*a, **kw):
        depths.append(vectorial._SWEEP_THREADS[threading.get_ident()])
        return lowest(*a, **kw)

    try:
        mp.setattr(profiling, "_HostRange", rec)
        mp.setattr(profiling, "_profiler_enabled", lambda: True)
        mp.setattr(vectorial, "solve_lowest_sweep", counted)
        cfg = SimulationConfig(
            mesh_min_points=600, mesh_target_points=600,
            mesh=MeshConfig(bucket_rounding=256),
            solver=solver_preset("balanced", device="cpu", cheb_degree=60,
                                 cheb_passes=2))
        g = MCFGeometry(19, 8.0, 1.5, 1.535, 1.0, wavelength_um=WL)
        dg = export_device_grid(MeshGenerator.generate(g, 0.2, cfg), 256)
        out = TrueVectorialMaxwellSolver.solve_sweep([g], dg, N_MODES,
                                                     cfg)[0]
    finally:
        mp.undo()
        torch.set_num_threads(1)
    return dict(out=out, ranges=rec.ranges, depths=depths, cfg=cfg)


def test_hex19_sweep_matches_the_reference(sweep):
    """The returned modes hold on the reference's operators (Rayleigh
    roots and confinement to 1e-12) and their n_eff lie within 5e-4 of
    the exact modes of the same mesh. The subspace (k = 16) is narrower
    than the 38-fold HE11 cluster it cuts into, and the filter's degree
    is 60, so the top roots sit 2.6e-4 low here; the card's cell runs
    k = 76 at degree 200, which holds the cluster."""
    from benchmark.reference import fem, geometry, hex19, judge, mesh

    g = {"layout": hex19.LAYOUT, "pitch_um": 8.0, "core_radius_um": 1.5,
         "n_core": 1.535, "n_clad": 1.0, "pml_thickness_um": 10.0}
    lan = geometry.lantern(g, WL)
    m = mesh.build(lan, {"refinement": 0.2, "mesh_min_points": 600,
                         "mesh_target_points": 600})
    ops = fem.vectorial(m, lan, 1.0)
    out = sweep["out"]
    nums = judge.vectorial(out, N_MODES, lan.k0, ops, fem.in_core(m, lan))
    assert nums["missing"] == 0.0
    assert nums["rq_gap"] < 1e-12 and nums["conf_gap"] < 1e-12
    ref = hex19.vectorial_modes(m, lan, 1.0, N_MODES + 12, ops=ops)
    assert len(ref) >= N_MODES
    assert judge.neff_gap(out, ref, N_MODES) < 5e-4


def test_one_span_per_round(sweep):
    """As many pl_fem.beta_round ranges as the sweep ran rounds (one
    filter call each; no bootstrap on this mesh), at least one and at
    most ``_max_rounds``; none inside another round, and the round's
    filter, transfer, polish and post-processing inside one."""
    ranges, cfg = sweep["ranges"], sweep["cfg"].solver
    rounds = [outer for name, outer in ranges if name == ROUND]
    assert sweep["depths"] == [1] * len(sweep["depths"])
    assert 1 <= len(rounds) == len(sweep["depths"]) <= \
        vectorial._max_rounds(cfg.beta_passes, cfg.qres_max_rounds)
    assert not any(ROUND in outer for outer in rounds)
    inner = [outer for name, outer in ranges if name in (
        "pl_fem.filter", "pl_fem.xfer", "pl_fem.polish", "pl_fem.postproc")]
    assert len(inner) >= 3 * len(rounds)
    assert all(ROUND in outer for outer in inner)
