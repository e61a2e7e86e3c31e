"""Port parity, the slice end to end: ``solve_sweep`` of the PyTorch
package against the JAX package on the same config-1 mesh (fast mode,
the bootstrapped fast path, the balanced and accuracy presets), the
bootstrap seed, and the single-core fiber against the exact vector
dispersion.

The JAX package draws its random start from ``jax.random.PRNGKey(11)``
(pl_fem_tpu/solvers/vectorial.py:686; inside the bootstrap's nested
coarse sweep too) and its bootstrap noise from the same key split in two
(:146-148); the tests draw those numbers with jax and hand them to the
port as numpy arrays (``X0``, ``coarse_X0``, ``noise``), so both
packages start from identical subspaces.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.config import SolverConfig as JSolverConfig
from pl_fem_tpu.config import solver_preset as j_solver_preset
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.solvers import TrueVectorialMaxwellSolver as JSolver
from pl_fem_tpu.solvers import vectorial as jv
from pl_fem_tpu_torch.config import (MeshConfig, SimulationConfig,
                                     SolverConfig, solver_preset)
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops.analytic import vector_modes
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.ops.kernels import _stacked_from_fused
from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver
from pl_fem_tpu_torch.solvers import vectorial as tv

torch.set_num_threads(1)
N_MODES = 6


def _config1_pair(jsolver, solver, mesh_min: int = 400):
    """B = 2 config-1 designs (7-core hex, 1.50 / 1.64 um) on one mesh
    (refinement 0.2, ``mesh_min`` points at least) in both packages:
    (JAX config, port config, JAX designs, port designs, JAX grid, port
    grid), the grids checked equal."""
    args = (7, 8.0, 1.5, 1.535, 1.0)
    wls = (1.50, 1.64)
    mk = dict(mesh_min_points=mesh_min, mesh_target_points=4 * mesh_min)
    jcfg = JSimulationConfig(**mk, mesh=JMeshConfig(bucket_rounding=256),
                             solver=jsolver)
    cfg = SimulationConfig(**mk, mesh=MeshConfig(bucket_rounding=256),
                           solver=solver)
    jgs = [JMCFGeometry(*args, wavelength_um=w) for w in wls]
    gs = [MCFGeometry(*args, wavelength_um=w) for w in wls]
    jdg = j_export(JMeshGenerator.generate(jgs[0], 0.2, jcfg), 256)
    dg = export_device_grid(MeshGenerator.generate(gs[0], 0.2, cfg), 256)
    assert np.array_equal(jdg.elem_dofs, dg.elem_dofs)
    return jcfg, cfg, jgs, gs, jdg, dg


@pytest.fixture
def torch_threads():
    """Four intra-op threads for the long solves (the port's plain twins
    take most of these tests' time on one thread), one again after."""
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(1)


def _jax_normal(shape, key=11):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape,
                                        dtype=jnp.float32))


def _assert_same_modes(ref, out, rtol: float = 1e-5):
    for mr, mo in zip(ref, out, strict=True):
        assert len(mo) == len(mr) > 0
        ne_r = np.array([m["n_eff"] for m in mr])
        ne_o = np.array([m["n_eff"] for m in mo])
        assert np.abs(ne_o - ne_r).max() / ne_r.max() <= rtol


def test_slice_sweep_matches_jax():
    """B = 2 config-1 designs (7-core hex, 1.50 / 1.64 um) on the same
    ~6.5k-DOF mesh from the same start subspace: equal mode counts and
    n_eff within 1e-5 relative. The two packages differ only in f32
    rounding order inside the filter and in the JAX package's f16
    device->host slab in fast mode (vectorial.py:633-634; ~1e-6 n_eff
    by its own note), which the port does not copy — 1e-5 covers both
    (measured ~7e-7)."""
    sk = dict(cheb_degree=50, cheb_passes=2, beta_passes=1, bootstrap=False)
    jcfg, cfg, jgs, gs, jdg, dg = _config1_pair(
        JSolverConfig(backend="tpu", **sk), SolverConfig(device="cpu", **sk))
    k = N_MODES + cfg.solver.extra_vectors
    X0 = _jax_normal((3 * dg.n_dofs_padded, len(gs), k))
    ref = JSolver.solve_sweep(jgs, jdg, N_MODES, jcfg)
    out = TrueVectorialMaxwellSolver.solve_sweep(gs, dg, N_MODES, cfg,
                                                 X0=X0)
    times = TrueVectorialMaxwellSolver.last_sweep_times
    assert {"assemble", "bounds", "filter", "polish"} <= set(times)
    _assert_same_modes(ref, out)
    for mo, g in zip(out, gs):
        assert all(g.n_clad < m["n_eff"] < g.n_core for m in mo)
        for m in mo:
            assert m["method"] == TrueVectorialMaxwellSolver.METHOD_TAG
            assert m["Ex_dofs"].shape == (dg.n_dofs,)
            assert np.isfinite(m["Ex_dofs"]).all()


def test_bootstrap_sweep_matches_jax(monkeypatch, torch_threads):
    """The bootstrapped fast path (what bench.py times): B = 2 config-1
    designs on a ~25.8k-DOF mesh, ``bootstrap_min_dofs`` lowered to 2000.
    The mesh must be this large: the fast-mode coarse grid (~6.6k DOFs)
    has to come to at most a third of the fine DOFs, so on the slice
    test's 6.5k-DOF mesh neither package bootstraps.

    Both get the same random numbers: the nested coarse sweep's start
    block (the port's ``coarse_X0``, a function of the coarse shape) and
    the seed's noise pair. Two things still differ. The coarse modes'
    signs are arbitrary (each package's eigensolvers pick their own), and
    a flipped mode meets the seed's 5% noise blend with the other sign,
    which moves the single fine pass's n_eff by a few 1e-6. The JAX
    package's f16 device->host slabs (``xfer_dtype``,
    vectorial.py:633-634) also rotate the coarse modes inside
    near-degenerate supermode clusters. So here the port's coarse modes
    are given JAX's signs before the seed, and JAX ships its slabs in
    f32, as the port does. JAX still rounds the coarse block to f16
    before the seed (vectorial.py:421); the port keeps f32. Then: equal
    ``used`` masks, coarse beta within 1e-5 relative (measured 9e-10),
    seeds within 5e-3 of max|X0| (the f16 rounding; measured 1.2e-3),
    equal mode counts and n_eff within 1e-5 relative (measured 9e-8 to
    1.2e-7)."""
    _bootstrap_pair(monkeypatch, aligned=True)


def test_bootstrap_sweep_matches_jax_defaults(monkeypatch, torch_threads):
    """The same bootstrapped fast path, with JAX's own settings (f16
    slabs) against the port's and the coarse modes' signs as each package
    finds them, the same random numbers: how far the port sits from the
    reference's default path. Equal ``used`` masks, coarse beta within
    1e-5 relative (measured 1.3e-7), equal mode counts and n_eff within
    2e-5 relative (measured 2.7e-6 to 4.5e-6)."""
    _bootstrap_pair(monkeypatch, aligned=False)


def _bootstrap_pair(monkeypatch, aligned: bool):
    """Both packages' bootstrapped fast path on the 25.8k-DOF mesh from
    the same random numbers (see the two tests above), compared."""
    sk = dict(cheb_degree=50, cheb_passes=2, beta_passes=1, bootstrap=True,
              bootstrap_min_dofs=2000)
    jkw = dict(xfer_dtype="float32") if aligned else {}
    jcfg, cfg, jgs, gs, jdg, dg = _config1_pair(
        JSolverConfig(backend="tpu", **jkw, **sk),
        SolverConfig(device="cpu", **sk), mesh_min=3000)
    boots, coarse = {}, {}

    def record(cls, tag):
        solve = cls._bootstrap_sweep.__func__

        def recorded(c, *args, **kw):
            boots[tag] = solve(c, *args, **kw)
            return boots[tag]
        monkeypatch.setattr(cls, "_bootstrap_sweep", classmethod(recorded))

    record(JSolver, "jax")
    record(TrueVectorialMaxwellSolver, "port")
    j_seed, t_seed = jv._seed_from_coarse, tv._seed_from_coarse

    def j_recorded(Hc16, *args):
        coarse["jax"] = np.asarray(Hc16, np.float32)
        return j_seed(Hc16, *args)

    def t_signed(Hc, *args, **kw):
        flip = np.einsum("bcnk,bcnk->bk", Hc, coarse["jax"]) < 0
        return t_seed(np.where(flip[:, None, None, :], -Hc, Hc), *args,
                      **kw)

    if aligned:
        monkeypatch.setattr(jv, "_seed_from_coarse", j_recorded)
        monkeypatch.setattr(tv, "_seed_from_coarse", t_signed)
    k = N_MODES + cfg.solver.extra_vectors
    shape = (3 * dg.n_dofs_padded, len(gs), k)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    noise = [np.asarray(jax.random.normal(kk, shape, jnp.float32))
             for kk in (k1, k2)]
    coarse_shapes = []

    def coarse_start(shape):
        coarse_shapes.append(shape)
        return _jax_normal(shape)

    ref = JSolver.solve_sweep(jgs, jdg, N_MODES, jcfg)
    out = TrueVectorialMaxwellSolver.solve_sweep(
        gs, dg, N_MODES, cfg, noise=noise, coarse_X0=coarse_start)
    assert "bootstrap" in TrueVectorialMaxwellSolver.last_sweep_times
    assert len(coarse_shapes) == 1 and coarse_shapes[0][1:] == shape[1:]
    assert boots["jax"] is not None and boots["port"] is not None
    jX0, jbeta, jused = boots["jax"]
    X0, beta, used = boots["port"]
    X0 = _stacked_from_fused(X0)      # the port's seed is the fused block
    assert np.array_equal(used, jused) and used.all()
    assert np.all(np.abs(beta - jbeta) <= 1e-5 * np.abs(jbeta))
    jX0 = np.asarray(jX0)
    assert X0.shape == jX0.shape == shape
    if aligned:
        assert np.abs(X0.numpy() - jX0).max() <= 5e-3 * np.abs(jX0).max()
    _assert_same_modes(ref, out, 1e-5 if aligned else 2e-5)


@pytest.mark.parametrize("preset", ["balanced", "accuracy"])
def test_preset_sweep_matches_jax(preset, torch_threads):
    """The beta-round path (the active set, the beta jitter, the pooled
    polish, the qres gate): ``solver_preset(preset)`` in both packages,
    bootstrap off, the slice test's designs and mesh from the same start
    block, cheb_degree 50 and cheb_passes 2 to keep the test short. Equal
    mode counts and n_eff within 1e-5 relative (measured 3e-8 to 9e-8
    balanced, 3e-7 accuracy). Neither package exposes its per-design
    round counts, so they are not compared."""
    sk = dict(cheb_degree=50, cheb_passes=2, bootstrap=False)
    jcfg, cfg, jgs, gs, jdg, dg = _config1_pair(
        j_solver_preset(preset, backend="tpu", **sk),
        solver_preset(preset, device="cpu", **sk))
    assert cfg.solver.beta_passes == 2
    k = N_MODES + cfg.solver.extra_vectors
    X0 = _jax_normal((3 * dg.n_dofs_padded, len(gs), k))
    ref = JSolver.solve_sweep(jgs, jdg, N_MODES, jcfg)
    out = TrueVectorialMaxwellSolver.solve_sweep(gs, dg, N_MODES, cfg,
                                                 X0=X0)
    _assert_same_modes(ref, out)


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
    assert out.shape == (Dp, B, 3, k)         # the filter's fused layout
    out = _stacked_from_fused(out)
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    gen = torch.Generator().manual_seed(11)
    drawn = tv._seed_from_coarse(Hc.astype(np.float32), colmask, Pcols,
                                 Pwts, "cpu", generator=gen)
    norms = torch.linalg.vector_norm(drawn, dim=(0, 2))
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
