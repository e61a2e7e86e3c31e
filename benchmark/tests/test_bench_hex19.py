"""The 19-core configuration's plain reference (``reference/hex19.py``)
on the CPU at the smallest 19-core mesh (refinement 0.2, 15184 DOFs):
the program's mesh DOF for DOF, the standing exact solve's roots, the
comparison failing what it must, and the reader of the sweep's beta
rounds on a synthetic traced window."""
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import cell, spec
from benchmark.harness.cell import Window
from benchmark.harness.trace import REQUEST_SPAN, Trace
from benchmark.reference import fem, geometry, hex19, mesh, solve

CELL = "hex19_vec_pml_band1"
CFG = spec.config(spec.load_benchmark(), "hex19_vectorial_pml")
TINY = {"wavelength_um": 1.55, "refinement": 0.2, "mesh_min_points": 600,
        "mesh_target_points": 600, "bucket_rounding": 256}
WL = 1.57


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    lan = geometry.lantern(CFG["geometry"], WL)
    m = mesh.build(lan, TINY)
    return m, lan, fem.vectorial(m, lan, 1.0)


@pytest.fixture(scope="module")
def exact(tiny):
    """The reference's 52 exact roots of the tiny design, by this
    module's solve and by ``solve.vectorial_modes``."""
    m, lan, ops = tiny
    return (hex19.vectorial_modes(m, lan, 1.0, 52, ops=ops),
            solve.vectorial_modes(m, lan, 1.0, 52, ops=ops))


def test_mesh_is_the_programs(tiny):
    from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.ops.femgrid import (MeshGenerator,
                                              export_device_grid)

    m, _, _ = tiny
    g = CFG["geometry"]
    sim = SimulationConfig(mesh_min_points=600, mesh_target_points=600,
                           mesh=MeshConfig(bucket_rounding=256))
    geom = MCFGeometry(g["n_cores"], g["pitch_um"], g["core_radius_um"],
                       g["n_core"], g["n_clad"], wavelength_um=1.55,
                       pml_thickness=g["pml_thickness_um"])
    MeshGenerator.clear_cache()
    dg = export_device_grid(MeshGenerator.generate(geom, 0.2, sim), 256)
    assert np.array_equal(geom.positions, hex19._hex19(g["pitch_um"]))
    T, n = dg.n_elems, dg.n_dofs
    assert (T, n) == m.elem_dofs.shape[:1] + (m.n_dofs,)
    assert np.array_equal(dg.elem_dofs[:T], m.elem_dofs)
    assert np.array_equal(dg.dof_coords[:n], m.dof_coords)
    assert np.array_equal(dg.interior_mask[:n], m.interior)
    assert np.array_equal(dg.qp_w[:T], m.qp_w)
    assert np.array_equal(dg.grad_phys[:T], m.grad)


def test_exact_is_the_standing_solve(exact):
    """The same roots as ARPACK shift-invert about the top scalar mode:
    the 38 HE11 supermodes and 14 of the 19 TE01 ones, n_eff to 1e-12."""
    fast, standing = exact
    assert len(fast) == len(standing) == 52
    a = np.array([x["n_eff"] for x in fast])
    b = np.array([x["n_eff"] for x in standing])
    assert np.abs(a - b).max() <= 1e-12 * b.max()
    assert a[37] - a[38] > 0.05                # HE11 | TE01


def test_shift_lies_above_the_roots(tiny, exact):
    """The isolated core's LP01 index sits above the top vector mode and
    within 1e-4 of the top scalar supermode of the mesh."""
    m, lan, _ = tiny
    n_s = hex19.lp01_index(lan)
    assert n_s > exact[0][0]["n_eff"]
    assert abs(n_s - solve.top_scalar_index(m, lan)) < 1e-4


def _correct(checks):
    return all(c["value"] <= c["limit"] for c in checks.values())


@pytest.fixture(scope="module")
def cfg_tiny():
    c = spec.config(spec.load_benchmark(), "hex19_vectorial_pml")
    cell._deep_update(c, {"mesh": {**TINY, "n_dofs": None}})
    return c


def _judge(cfg, modes):
    return cell.judge(hex19, cfg, [(WL, modes)], 7, io.StringIO())


def test_exact_modes_pass(cfg_tiny, exact):
    """The reference's own modes in the program's place pass every
    check: the judge holds them to the same operators."""
    checks = _judge(cfg_tiny, exact[0])
    assert _correct(checks), checks
    assert checks["rq_gap"]["value"] < 1e-11


def test_modes_moved_are_not_correct(cfg_tiny, exact):
    """Every returned beta and n_eff moved by 2e-6 relative: the fields'
    Rayleigh roots no longer match (``rq_gap``)."""
    moved = [{**x, "beta": x["beta"] * (1 + 2e-6),
              "n_eff": x["n_eff"] * (1 + 2e-6)} for x in exact[0]]
    checks = _judge(cfg_tiny, moved)
    assert not _correct(checks) and checks["rq_gap"]["value"] > 1e-10


def test_half_the_modes_missing_is_not_correct(cfg_tiny, exact):
    checks = _judge(cfg_tiny, exact[0][:20])
    assert not _correct(checks) and checks["missing"]["value"] == 20


def test_control_is_not_correct():
    nums = control.readings(CELL, 5, 1, overrides={
        "mesh": {**TINY, "n_dofs": None}})
    failed = [k for k, v in nums.items() if v["value"] > v["limit"]]
    assert {"rq_gap", "conf_gap"} <= set(failed)


# -- sweep.beta_rounds_per_design on a synthetic traced window -----------

CPU = torch.autograd.DeviceType.CPU
READER = "sweep.beta_rounds_per_design"
# (name, start us, end us): request 1 bootstraps (two coarse rounds
# inside pl_fem.bootstrap) and runs two fine rounds, request 2 one; one
# design each; the third request is not traced
HOST = [
    (REQUEST_SPAN, 0, 1000),
    ("pl_fem.bootstrap", 10, 300),
    ("pl_fem.beta_round", 20, 150),
    ("pl_fem.beta_round", 150, 290),
    ("pl_fem.beta_round", 350, 600),
    ("pl_fem.filter", 360, 500),
    ("pl_fem.beta_round", 600, 990),
    (REQUEST_SPAN, 2000, 3000),
    ("pl_fem.beta_round", 2100, 2900),
]


def _window(host=HOST):
    prof = SimpleNamespace(events=lambda: [SimpleNamespace(
        name=n, device_type=CPU, time_range=SimpleNamespace(start=a, end=b))
        for n, a, b in host])
    win = Window()
    win.requests = [{"designs": d, "phases": {}} for d in (1, 1, 4)]
    win.trace = Trace(prof, {})
    return win


def _read(win):
    return spec.load_module("metrics", READER).read(win)


def test_rounds_per_design_by_hand():
    """Three fine rounds (the two bootstrap rounds left out) over the
    two designs of the traced requests."""
    assert _read(_window()) == pytest.approx(3 / 2)


def test_rounds_silent_without_spans():
    """A program without the round span (the parent of this reader) and
    an untraced window read nothing, and raise nothing."""
    plain = [h for h in HOST if h[0] != "pl_fem.beta_round"]
    assert _read(_window(plain)) is None
    assert _read(Window()) is None


def test_rounds_reported_in_the_hex19_cell_only():
    bench = spec.load_benchmark()
    m = spec.find(bench["per_layer"], READER, "metric")
    assert m["source"] == "program_span" and m["moves"] == "designs_per_s"
    assert m["workloads"] == [CELL]
    assert READER in {p["name"] for p in spec.Cell(bench, CELL).per_layer}
