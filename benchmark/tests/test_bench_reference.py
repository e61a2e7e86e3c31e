"""The plain reference against the program on the CPU (the kernels'
plain twins) at a tiny mesh: the same mesh DOF for DOF, the same
operators, the same modes."""
import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import fem, geometry, judge, mesh, solve

TINY = {"wavelength_um": 1.55, "refinement": 0.4, "mesh_min_points": 1500,
        "mesh_target_points": 1500, "bucket_rounding": 256}
CFG = spec.config(spec.load_benchmark(), "hex7_scalar_lp_deg600")


def _program_grid():
    from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid

    sim = SimulationConfig(mesh_min_points=1500, mesh_target_points=1500,
                           mesh=MeshConfig(bucket_rounding=256))
    g = MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    MeshGenerator.clear_cache()
    return export_device_grid(MeshGenerator.generate(g, 0.4, sim), 256)


@pytest.fixture(scope="module")
def pair():
    lan = geometry.lantern(CFG["geometry"], 1.55)
    return _program_grid(), mesh.build(lan, TINY), lan


def test_mesh_is_the_programs(pair):
    dg, m, _ = pair
    T, n = dg.n_elems, dg.n_dofs
    assert (T, n) == m.elem_dofs.shape[:1] + (m.n_dofs,)
    assert np.array_equal(dg.elem_dofs[:T], m.elem_dofs)
    assert np.array_equal(dg.dof_coords[:n], m.dof_coords)
    assert np.array_equal(dg.interior_mask[:n], m.interior)
    assert np.array_equal(dg.qp_w[:T], m.qp_w)
    assert np.array_equal(dg.grad_phys[:T], m.grad)


def test_operators_are_the_programs(pair):
    from pl_fem_tpu_torch.ops.host_assembly import (build_host_scalar,
                                                    build_host_vector3)
    from pl_fem_tpu_torch.models import MCFGeometry

    dg, m, lan = pair
    g = MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    hv = build_host_vector3(dg, g.eps_params(), 1.0)
    ops = fem.vectorial(m, lan, 1.0)
    for mine, theirs in zip((ops["A0"], ops["A1"], ops["A2"]), hv.Ai()):
        assert abs(mine - theirs).max() <= 1e-12 * abs(theirs).max()
    hs = build_host_scalar(dg, g.eps_params(), g.k0)
    sc = fem.scalar(m, lan)
    assert abs(sc["A"] - hs.A).max() <= 1e-12 * abs(hs.A).max()
    assert abs(sc["B"] - hs.B).max() <= 1e-12 * abs(hs.B).max()


def test_scalar_modes_agree(pair):
    """The program's device path (plain twins) and its ARPACK backend
    against the reference: n_eff, Rayleigh values, confinement."""
    from pl_fem_tpu_torch.config import SimulationConfig, SolverConfig
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.solvers import ScalarHelmholtzSolver

    dg, m, _ = pair
    lan = geometry.lantern(CFG["geometry"], 1.57)
    g = MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.57)
    ref = solve.scalar_modes(m, lan, 10, 22)
    parts = fem.scalar_parts(m, lan)
    Ml = fem.core_mass(m, lan, 1.10)
    for backend in ("hybrid", "device"):
        sim = SimulationConfig(solver=SolverConfig(
            backend=backend, device="cpu", cheb_degree=200, cheb_passes=2))
        out = ScalarHelmholtzSolver(g, sim).solve(dg, 10,
                                                  mode_filter="cascade")
        nums = judge.scalar(out, 10, lan.k0, parts, Ml)
        assert nums == {"missing": 0.0, "rq_gap": pytest.approx(0, abs=1e-12),
                        "conf_gap": pytest.approx(0, abs=1e-12)}
        assert judge.neff_gap(out, ref, 10) < 1e-6


def test_vectorial_modes_agree(pair):
    """The program's sweep (plain twins, B = 1) held to the reference's
    operators, and its n_eff within the fast preset's class of the exact
    modes."""
    from pl_fem_tpu_torch.config import (MeshConfig, SimulationConfig,
                                         SolverConfig)
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver

    dg, m, _ = pair
    torch.set_num_threads(4)
    lan = geometry.lantern(CFG["geometry"], 1.57)
    g = MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.57)
    sim = SimulationConfig(mesh_min_points=1500, mesh_target_points=1500,
                           mesh=MeshConfig(bucket_rounding=256),
                           solver=SolverConfig(device="cpu", cheb_degree=200,
                                               cheb_passes=2, beta_passes=1))
    out = TrueVectorialMaxwellSolver.solve_sweep([g], dg, 10, sim)[0]
    ops = fem.vectorial(m, lan, 1.0)
    nums = judge.vectorial(out, 10, lan.k0, ops, fem.in_core(m, lan))
    assert nums["missing"] == 0.0
    assert nums["rq_gap"] < 1e-12 and nums["conf_gap"] < 1e-12
    ref = solve.vectorial_modes(m, lan, 1.0, 16, ops=ops)
    assert len(ref) >= 10
    assert judge.neff_gap(out, ref, 10) < 3e-3
