"""Port parity, the slice end to end: ``solve_sweep`` of the PyTorch
package against the JAX package on the same config-1 mesh, the
bootstrap seed, and the single-core fiber against the exact vector
dispersion.

The JAX package draws its random start from ``jax.random.PRNGKey(11)``
(pl_fem_tpu/solvers/vectorial.py:686) and its bootstrap noise from the
same key split in two (:146-148); the tests draw those numbers with jax
and hand them to the port as numpy arrays, so both packages start from
identical subspaces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.config import SolverConfig as JSolverConfig
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.solvers import TrueVectorialMaxwellSolver as JSolver
from pl_fem_tpu.solvers import vectorial as jv
from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig, SolverConfig
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops.analytic import vector_modes
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver
from pl_fem_tpu_torch.solvers import vectorial as tv

torch.set_num_threads(1)
N_MODES = 6


def test_slice_sweep_matches_jax():
    """B = 2 config-1 designs (7-core hex, 1.50 / 1.64 um) on the same
    ~6.5k-DOF mesh from the same start subspace: equal mode counts and
    n_eff within 1e-5 relative. The two packages differ only in f32
    rounding order inside the filter and in the JAX package's f16
    device->host slab in fast mode (vectorial.py:633-634; ~1e-6 n_eff
    by its own note), which the port does not copy — 1e-5 covers both
    (measured ~7e-7)."""
    args = (7, 8.0, 1.5, 1.535, 1.0)
    wls = (1.50, 1.64)
    mk = dict(mesh_min_points=400, mesh_target_points=1600)
    sk = dict(cheb_degree=50, cheb_passes=2, beta_passes=1, bootstrap=False)
    jcfg = JSimulationConfig(**mk, mesh=JMeshConfig(bucket_rounding=256),
                             solver=JSolverConfig(backend="tpu", **sk))
    cfg = SimulationConfig(**mk, mesh=MeshConfig(bucket_rounding=256),
                           solver=SolverConfig(device="cpu", **sk))
    jgs = [JMCFGeometry(*args, wavelength_um=w) for w in wls]
    gs = [MCFGeometry(*args, wavelength_um=w) for w in wls]
    jdg = j_export(JMeshGenerator.generate(jgs[0], 0.2, jcfg), 256)
    dg = export_device_grid(MeshGenerator.generate(gs[0], 0.2, cfg), 256)
    assert np.array_equal(jdg.elem_dofs, dg.elem_dofs)
    k = N_MODES + cfg.solver.extra_vectors
    X0 = np.asarray(jax.random.normal(jax.random.PRNGKey(11),
                                      (3 * dg.n_dofs_padded, len(wls), k),
                                      dtype=jnp.float32))
    ref = JSolver.solve_sweep(jgs, jdg, N_MODES, jcfg)
    out = TrueVectorialMaxwellSolver.solve_sweep(gs, dg, N_MODES, cfg,
                                                 X0=X0)
    times = TrueVectorialMaxwellSolver.last_sweep_times
    assert {"assemble", "bounds", "filter", "polish"} <= set(times)
    for mr, mo, g in zip(ref, out, gs):
        assert len(mo) == len(mr) > 0
        ne_r = np.array([m["n_eff"] for m in mr])
        ne_o = np.array([m["n_eff"] for m in mo])
        assert np.abs(ne_o - ne_r).max() / ne_r.max() <= 1e-5
        assert all(g.n_clad < n < g.n_core for n in ne_o)
        for m in mo:
            assert m["method"] == TrueVectorialMaxwellSolver.METHOD_TAG
            assert m["Ex_dofs"].shape == (dg.n_dofs,)
            assert np.isfinite(m["Ex_dofs"]).all()


def test_seed_from_coarse_matches_jax():
    """The bootstrap seed (prolong + 5% blend + normalize) from the same
    coarse vectors and the same noise blocks: f32 agreement."""
    rng = np.random.default_rng(5)
    B, nc, k, Dp, W = 2, 40, 6, 64, 6
    Hc = rng.standard_normal((B, 3, nc, k)).astype(np.float16)
    colmask = np.zeros((B, k), np.float32)
    colmask[0, :3] = 1.0
    colmask[1, :5] = 1.0
    Pcols = rng.integers(0, nc, (Dp, W)).astype(np.int32)
    Pwts = rng.random((Dp, W)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jv._seed_from_coarse(jnp.asarray(Hc),
                                          jnp.asarray(colmask),
                                          jnp.asarray(Pcols),
                                          jnp.asarray(Pwts), key))
    k1, k2 = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(kk, (3 * Dp, B, k), jnp.float32))
             for kk in (k1, k2)]
    out = tv._seed_from_coarse(Hc.astype(np.float32), colmask, Pcols, Pwts,
                               "cpu", noise=noise)
    assert out.shape == (3 * Dp, B, k)
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    gen = torch.Generator().manual_seed(11)
    drawn = tv._seed_from_coarse(Hc.astype(np.float32), colmask, Pcols,
                                 Pwts, "cpu", generator=gen)
    norms = torch.linalg.vector_norm(drawn, dim=0)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


@pytest.fixture(scope="module")
def fiber():
    """Single-core step-index fiber (V~7) on a small calibration mesh
    (the mesh of tests/test_solvers.py)."""
    geom = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55,
                       use_complex_pml=False)
    cfg = SimulationConfig(mesh_min_points=600, mesh_target_points=2500,
                           mesh=MeshConfig(bucket_rounding=256))
    MeshGenerator.clear_cache()
    grid = MeshGenerator.generate(geom, 0.4, cfg)
    return geom, export_device_grid(grid, 256)


def test_fiber_vs_analytic(fiber):
    """Fast mode (the main path's solver settings) through
    solve_vectorial_modes (B = 1): HE11 within the fast-mode class,
    1e-3 relative, of the exact vector dispersion; the next group
    (TE01 / TM01 / HE21) within the mesh accuracy of
    tests/test_solvers.py."""
    geom, dg = fiber
    cfg = SimulationConfig(solver=SolverConfig(
        device="cpu", cheb_degree=150, cheb_passes=2, beta_passes=1))
    modes = TrueVectorialMaxwellSolver(geom, config=cfg) \
        .solve_vectorial_modes(dg, n_modes_target=8)
    assert len(modes) >= 10
    exact = vector_modes(1.55, 1.5, 1.53, 1.0)
    he11 = dict(exact)["HY1,1"]
    exact_deg = sorted((ne for lbl, ne in exact
                        for _ in range(2 if lbl.startswith("HY") else 1)),
                       reverse=True)
    ne = [m["n_eff"] for m in modes]
    assert abs(ne[0] - ne[1]) < 2e-3            # HE11 doublet
    assert abs(ne[0] - he11) / he11 < 1e-3
    for i in range(2, 6):
        assert abs(ne[i] - exact_deg[i]) / exact_deg[i] < 8e-3
    m0 = modes[0]
    for key in ("n_eff", "beta", "Ex_dofs", "Ey_dofs", "Hz_dofs", "P_x",
                "P_y", "PDL_dB", "polarization", "confinement",
                "core_overlap", "div_ratio", "is_vectorial"):
        assert key in m0, key
    assert m0["div_ratio"] < 1e-2 and m0["confinement"] > 0.6


def test_debug_checks_screens_non_finite_designs(fiber):
    geom, dg = fiber
    bad = MCFGeometry(1, 8.0, 1.5, float("nan"), 1.0, wavelength_um=1.55,
                      use_complex_pml=False)
    cfg = SimulationConfig(solver=SolverConfig(device="cpu",
                                               debug_checks=True))
    diags = {}
    out = TrueVectorialMaxwellSolver.solve_sweep([bad, bad], dg, 4, cfg,
                                                 diag_out=diags)
    assert out == [[], []]
    assert set(diags) == {0, 1}
    assert "non-finite" in diags[0]


def test_outer_round_cap_keeps_reference_quirk():
    """``qres_max_rounds or 6`` (pl_fem_tpu/solvers/vectorial.py:736-737)
    treats an explicit 0 as unset; the port keeps that as written."""
    assert tv._max_rounds(1, 3) == 1
    assert tv._max_rounds(2, None) == 6
    assert tv._max_rounds(2, 0) == 6
    assert tv._max_rounds(2, 2) == 2
    assert tv._max_rounds(3, 2) == 3


def test_device_is_explicit():
    cfg = SimulationConfig(solver=SolverConfig(device="cuda"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    geom = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrueVectorialMaxwellSolver.solve_sweep([geom], None, 4, cfg)
