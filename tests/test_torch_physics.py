"""Port parity, physics: the PyTorch package's loss model and CMT against
the JAX package on the same inputs.

The JAX functions run under the test conftest's x64, the precision the
port always uses (float64 / complex128 on the host). Mode populations
are the synthetic vectorial fixtures of scratch/loss_parity_ref.py in
the three confinement regimes of docs/LOSS_PARITY_r5.txt.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.physics import cmt as jc
from pl_fem_tpu.physics import losses as jl
from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.physics import cmt as tc
from pl_fem_tpu_torch.physics import losses as tl

torch.set_num_threads(1)

LOSS_TOL = 1e-10       # f64 both sides; sums in another order
CMT_TOL = 1e-12        # f64 both sides; expm by Pade (jax) vs Taylor (torch)
GEOM_ARGS = (7, 8.0, 1.5, 1.535, 1.0)

# (n modes, confinement window, seed): docs/LOSS_PARITY_r5.txt regimes
REGIMES = {"high": (18, 0.97, 0.999, 0), "mid": (10, 0.80, 0.95, 1),
           "low": (4, 0.55, 0.75, 2)}


def synth_modes(n_modes, conf_lo, conf_hi, seed, n_dofs=400,
                vectorial=True):
    rng = np.random.default_rng(seed)
    k0 = 2 * np.pi / 1.55
    modes = []
    for _ in range(n_modes):
        conf = float(conf_lo + (conf_hi - conf_lo) * rng.random())
        ne = float(1.30 + 0.2 * rng.random())
        px = float(0.4 + 0.4 * rng.random())
        py = float(0.4 + 0.4 * rng.random())
        ex = rng.standard_normal(n_dofs)
        ey = rng.standard_normal(n_dofs)
        modes.append({
            "n_eff": ne, "beta": ne * k0,
            "beta_im": float(1e-9 * rng.random()),
            "P_x": px, "P_y": py,
            "PDL_dB": float(10 * np.log10(max(px, py) / min(px, py))),
            "confinement": conf, "core_overlap": conf,
            "field_vector": ex / np.linalg.norm(ex),
            "Ex_dofs": ex / np.linalg.norm(ex),
            "Ey_dofs": ey / np.linalg.norm(ey),
            "is_vectorial": vectorial,
        })
    modes.sort(key=lambda m: -m["n_eff"])
    return modes


@pytest.fixture(scope="module")
def geoms():
    kw = dict(wavelength_um=1.55, taper_length_um=375.0)
    return JMCFGeometry(*GEOM_ARGS, **kw), MCFGeometry(*GEOM_ARGS, **kw)


def _close(a, b, tol, what):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(1.0, np.abs(a).max() if a.size else 0.0), \
        (what, err)


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("vectorial", [True, False])
def test_loss_facades_match_jax(geoms, regime, vectorial):
    """Every output of LossCalculator (mux and demux) and of the two
    sectional facades, within 1e-10."""
    jg, tg = geoms
    modes = synth_modes(*REGIMES[regime], vectorial=vectorial)
    dp_j = jl.build_design_params(modes, jg, 1550.0)
    dp_t = tl.build_design_params(modes, tg, 1550.0)
    assert dataclasses.asdict(dp_j) == dataclasses.asdict(dp_t)
    pairs = [(jl.LossCalculator.calculate_physical_losses(modes, jg, d),
              tl.LossCalculator.calculate_physical_losses(modes, tg, d))
             for d in ("mux", "demux")]
    pairs.append((jl.EnhancedLossCalculator.calculate_sectional_losses(
        modes, jg, dp_j), tl.EnhancedLossCalculator
        .calculate_sectional_losses(modes, tg, dp_t)))
    pairs.append((jl.VectorialLossCalculator.calculate_vectorial_losses(
        modes, jg, dp_j), tl.VectorialLossCalculator
        .calculate_vectorial_losses(modes, tg, dp_t)))
    for ref, out in pairs:
        assert ref.keys() == out.keys()
        for key, r in ref.items():
            if isinstance(r, float):
                assert abs(out[key] - r) <= LOSS_TOL, (key, r, out[key])
            else:
                assert out[key] == r, key


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_loss_cores_match_jax(geoms, regime):
    """The ModeBatch-level functions, including crosstalk_scalar and
    pdl_realistic, on the padded batch (float64 on the CPU)."""
    jg, tg = geoms
    modes = synth_modes(*REGIMES[regime])
    jb = jl.modes_to_batch(modes)
    tb = tl.modes_to_batch(modes)
    assert all(t.dtype == torch.float64 and t.device.type == "cpu"
               for t in tb)
    for a, b in zip(jb, tb):
        assert np.array_equal(np.asarray(a), b.numpy())
    dp = jl.build_design_params(modes, jg, 1550.0)
    jda = jl.design_to_arrays(dp, 1550.0)
    tda = tl.design_to_arrays(dp, 1550.0)
    jpos, n_pos, dn = jl._geo_arrays(modes, jg)
    tpos, _, _ = tl._geo_arrays(modes, tg)
    jF = jl._fields_matrix(modes, 64)
    tF = tl._fields_matrix(modes, 64)
    assert isinstance(tF, torch.Tensor)
    wl = 1550.0
    checks = [
        (jl.crosstalk_vectorial(jb), tl.crosstalk_vectorial(tb)),
        (jl.crosstalk_scalar(jb, jF), tl.crosstalk_scalar(tb, tF)),
        (jl.pdl_vectorial(jb), tl.pdl_vectorial(tb)),
        (jl.pdl_realistic(jb, jpos, n_pos, jnp.asarray(wl)),
         tl.pdl_realistic(tb, tpos, n_pos, torch.tensor(wl,
                                                        dtype=torch.float64))),
        (jl.radiation_loss(jb, jnp.asarray(wl)),
         tl.radiation_loss(tb, torch.tensor(wl, dtype=torch.float64))),
        (jl.demux_pdl_asymmetry(jb), tl.demux_pdl_asymmetry(tb)),
    ]
    for a, b in checks:
        _close(a, b.numpy(), LOSS_TOL, "core")
    for vec in (True, False):
        ref = jl.sectional_losses(jb, jda, jpos, n_pos, dn, vectorial=vec)
        out = tl.sectional_losses(tb, tda, tpos, n_pos, dn, vectorial=vec)
        for key in ref:
            _close(ref[key], out[key].numpy(), LOSS_TOL, key)
    ref = jl.vectorial_losses_core(jb, jda)
    out = tl.vectorial_losses_core(tb, tda)
    for key in ref:
        _close(ref[key], out[key].numpy(), LOSS_TOL, key)


def test_propagate_scan_matches_jax():
    """A random Hermitian (S, M, M) stack with one disabled (dz = 0)
    segment: final amplitudes, the path and the per-segment losses
    within 1e-12."""
    rng = np.random.default_rng(7)
    S, M = 6, 9
    Hr = rng.standard_normal((S, M, M)) + 1j * rng.standard_normal((S, M, M))
    H = (Hr + Hr.conj().transpose(0, 2, 1)) / 2
    dz = rng.random(S) * 2.0
    dz[2] = 0.0
    A0 = rng.standard_normal(M) + 1j * rng.standard_normal(M)
    ref = jc.propagate_scan(jnp.asarray(H), jnp.asarray(dz), jnp.asarray(A0))
    out = tc.propagate_scan(torch.as_tensor(H), torch.as_tensor(dz),
                            torch.as_tensor(A0))
    for a, b in zip(ref, out):
        _close(a, b.numpy(), CMT_TOL, "scan")
    assert torch.equal(out[1][3], out[1][2])      # the dz = 0 segment


def test_coupling_offdiag_matches_jax():
    """|F^T F| * 1e-3 with a zero diagonal. Not bit-equal: the two GEMMs
    sum in different orders (measured 2e-17 absolute); 1e-15 relative."""
    F = np.random.default_rng(3).standard_normal((300, 7))
    ref = np.asarray(jc.coupling_offdiag(jnp.asarray(F)))
    out = tc.coupling_offdiag(torch.as_tensor(F)).numpy()
    assert np.all(np.diag(out) == 0.0)
    assert np.abs(out - ref).max() <= 1e-15 * np.abs(ref).max()


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("direction", ["mux", "demux"])
def test_propagate_cmt_matches_jax(adaptive, direction):
    """CoupledModeTheory end to end on 4 z-slices of synthetic modes
    (approximate coupling). The segment phases beta * dz reach ~750 rad,
    which scales the last-bit differences of the two coupling GEMMs and
    expm algorithms: piecewise within 1e-11 (measured 1.1e-12). The
    adaptive path is the same scipy RK45 (rtol 1e-6) on both sides, but
    last-bit differences in H move its step choices, so the two agree
    to the integrator's tolerance: within 1e-5 (measured 1.4e-6)."""
    tol = 1e-5 if adaptive else 1e-11
    zs = np.linspace(0.0, 375.0, 4)
    modes_list = [synth_modes(6, 0.8, 0.95, s) for s in range(4)]
    A0 = np.zeros(6, complex)
    A0[0] = 1.0
    omega = 2 * np.pi * 299_792_458.0 / 1.55e-6
    ref = jc.CoupledModeTheory(omega).propagate_cmt(
        zs, modes_list, A0, direction, use_adaptive=adaptive)
    out = tc.CoupledModeTheory(omega).propagate_cmt(
        zs, modes_list, A0, direction, use_adaptive=adaptive)
    assert ref.keys() == out.keys()
    for key, r in ref.items():
        if isinstance(r, str):
            assert out[key] == r
        else:
            _close(r, out[key], tol, key)
    assert (jc.CoupledModeTheory(omega).estimate_adiabaticity(zs, modes_list)
            == tc.CoupledModeTheory(omega).estimate_adiabaticity(
                zs, modes_list))


def test_rigorous_coupling_bit_equal():
    """delta_eps_mass_csr on a small config-1 mesh, and the rigorous
    coupling matrix built from it (host numpy on both sides): bit-equal."""
    jcfg = JSimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                             mesh=JMeshConfig(bucket_rounding=256))
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    jg = JMCFGeometry(*GEOM_ARGS, wavelength_um=1.55)
    g = MCFGeometry(*GEOM_ARGS, wavelength_um=1.55)
    jdg = j_export(JMeshGenerator.generate(jg, 0.3, jcfg), 256)
    dg = export_device_grid(MeshGenerator.generate(g, 0.3, cfg), 256)
    jm = jc.delta_eps_mass_csr(jdg, jg.eps_params())
    tm = tc.delta_eps_mass_csr(dg, g.eps_params())
    for name in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(jm, name), getattr(tm, name)), name
    rng = np.random.default_rng(11)
    modes = [{"beta": 6.0 - 0.01 * i,
              "field_vector": rng.standard_normal(2 * dg.n_dofs)}
             for i in range(5)]
    omega = 2 * np.pi * 299_792_458.0 / 1.55e-6
    ref = jc.CoupledModeTheory(omega, "rigorous")._compute_coupling_matrix(
        modes, modes, delta_eps_mass=jm)
    out = tc.CoupledModeTheory(omega, "rigorous")._compute_coupling_matrix(
        modes, modes, delta_eps_mass=tm)
    assert np.array_equal(ref, out)
