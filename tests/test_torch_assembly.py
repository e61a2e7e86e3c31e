"""Port parity, device assembly: permittivity at the quadrature points,
the quadrature factors and mass diagonal (through the K2 accumulate),
the stacked (E, 18, 18) operator A(beta) and the per-element spectrum
bound agree with the JAX package on the same mesh.

Tolerance: <= 1e-5 relative, the f32 noise of two independent orderings
of the same f32 sums (both packages assemble in float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig, SimulationConfig
from pl_fem_tpu.models import MCFGeometry
from pl_fem_tpu.ops import assembly as ja
from pl_fem_tpu.ops import kernels as jk
from pl_fem_tpu.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.ops import assembly as ta
from pl_fem_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)
RTOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-300)


@pytest.fixture(scope="module")
def setup():
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    # a PML design and one without, at two wavelengths
    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55),
             MCFGeometry(3, 8.0, 1.5, 1.50, 1.44, wavelength_um=1.60,
                         use_complex_pml=False)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 0.5, cfg), 256)
    jga = ja.grid_to_device(dg, dtype=jnp.float32)
    tga = ta.grid_from_numpy(dg, "cpu")
    return geoms, dg, jga, tga


def test_grid_from_numpy_matches(setup):
    _, dg, jga, tga = setup
    for name in tga._fields:
        a = np.asarray(getattr(jga, name))
        b = getattr(tga, name).numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a.astype(b.dtype), b), name


@pytest.mark.parametrize("gi", [0, 1])
def test_eps_at_quadrature(setup, gi):
    geoms, _, jga, tga = setup
    ep = geoms[gi].eps_params()
    jre, jim = ja.eps_at_quadrature(jga, ja.eps_arrays(ep, jnp.float32))
    tre, tim = ta.eps_at_quadrature(tga, ta.eps_arrays(ep, "cpu"))
    assert _rel(jre, tre.numpy()) <= RTOL
    if np.abs(np.asarray(jim)).max() > 0:
        assert _rel(jim, tim.numpy()) <= RTOL
    else:
        assert not tim.abs().max() > 0


@pytest.mark.parametrize("gi", [0, 1])
def test_assemble_vector3_qf(setup, gi):
    geoms, _, jga, tga = setup
    ep = geoms[gi].eps_params()
    jqf, jdiag = ja.assemble_vector3_qf(jga, ja.eps_arrays(ep, jnp.float32))
    tqf, tdiag = ta.assemble_vector3_qf(tga, ta.eps_arrays(ep, "cpu"))
    for name in ("invJT", "w", "inv_eps"):
        assert _rel(getattr(jqf, name), getattr(tqf, name).numpy()) <= RTOL
    assert _rel(jdiag, tdiag.numpy()) <= RTOL


@pytest.mark.parametrize("gi", [0, 1])
def test_stacked_A_and_pencil_bound(setup, gi):
    geoms, _, jga, tga = setup
    g = geoms[gi]
    ep = g.eps_params()
    beta = np.float32(g.k0 * 1.45)
    jprim, jdiag, _ = ja.assemble_vector3_system(
        jga, ja.eps_arrays(ep, jnp.float32))
    tprim, tdiag, _ = ta.assemble_vector3_system(tga,
                                                 ta.eps_arrays(ep, "cpu"))
    for name in jprim:
        assert _rel(jprim[name], tprim[name].numpy()) <= RTOL, name
    assert _rel(jdiag, tdiag.numpy()) <= RTOL
    jA = ja.vector3_stacked_A(jprim, jnp.float32(beta), jnp.float32(1.0))
    tA = ta.vector3_stacked_A(tprim, beta, np.float32(1.0))
    assert tA.shape == (tga.elem_dofs.shape[0], 18, 18)
    assert _rel(jA, tA.numpy()) <= RTOL
    jlo, jhi, jb = jk.pencil_bounds_elem(jA, jprim["u_nn"], jga.elem_valid,
                                         C=3)
    tlo, thi, tb = tk.pencil_bounds_elem(tA, tprim["u_nn"], tga.elem_valid,
                                         C=3)
    assert (float(jlo), float(jhi)) == (float(tlo), float(thi))
    assert abs(float(jb) - float(tb)) / float(jb) <= RTOL


def test_mass_constants_match():
    assert tk.MASS_LO == jk.MASS_LO and tk.MASS_HI == jk.MASS_HI
    assert np.array_equal(tk._LINV_REF, jk._LINV_REF)
    assert tk._HRZ_SCALE == jk._HRZ_SCALE
    assert tk._LUMP_BOUND == jk._LUMP_BOUND
    assert np.array_equal(tk._B_REF, jk._B_REF)


# ---------------------------------------------------------------------------
# the vectorial sweep's assembly and bounds: 1/eps of every design in one
# batched K6, the one mass diagonal, and K8 from the quadrature data
# ---------------------------------------------------------------------------

def _sweep_designs():
    """Three designs on the module's mesh: a PML design and two without,
    two wavelengths, two n_core values, and a 2-core design among 3-core
    ones (the batch pads its cores with r2 = -1)."""
    return [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55),
            MCFGeometry(3, 8.0, 1.5, 1.50, 1.44, wavelength_um=1.60,
                        use_complex_pml=False),
            MCFGeometry(2, 8.0, 1.5, 1.52, 1.0, wavelength_um=1.55,
                        use_complex_pml=False)]


def test_batched_inv_eps_matches_jax(setup):
    _, _, jga, tga = setup
    geoms = _sweep_designs()
    eas = [ta.eps_arrays(g.eps_params(), "cpu") for g in geoms]
    batch = ta.eps_batch(eas)
    assert batch.r2.shape == (3, 3) and float(batch.r2[2, 2]) == -1.0
    qs, _ = ta.assemble_vector3_sweep(tga, ta.gather_scatter(tga), eas)
    assert qs.inv_eps.shape == (3,) + tuple(tga.qp_w.shape)
    for b, g in enumerate(geoms):
        jqf, _ = ja.assemble_vector3_qf(
            jga, ja.eps_arrays(g.eps_params(), jnp.float32))
        assert _rel(jqf.inv_eps, qs.inv_eps[b].numpy()) <= RTOL, b
        # the padded 2-core design reads no third core
        tqf, _ = ta.assemble_vector3_qf(tga, eas[b])
        assert torch.equal(qs.inv_eps[b], tqf.inv_eps), b
    assert len(set(np.unique(qs.inv_eps[2].numpy()))) == 2


def test_sweep_mass_diagonal_matches_jax(setup):
    geoms, _, jga, tga = setup
    _, jdiag = ja.assemble_vector3_qf(
        jga, ja.eps_arrays(geoms[0].eps_params(), jnp.float32))
    eas = [ta.eps_arrays(g.eps_params(), "cpu") for g in _sweep_designs()]
    _, diag = ta.assemble_vector3_sweep(tga, ta.gather_scatter(tga), eas)
    assert diag.shape == (tga.dof_valid.shape[0],)
    assert _rel(jdiag, diag.numpy()) <= RTOL


def test_sweep_bounds_match_jax_loop(setup):
    """K8 from the quadrature data (its twin here) against the JAX
    package's per-design loop: assemble_vector3_system, vector3_stacked_A
    and pencil_bounds_elem at C = 3."""
    _, _, jga, tga = setup
    geoms = _sweep_designs()
    betas = np.array([g.k0 * n for g, n in zip(geoms, (1.45, 1.47, 1.46))])
    alpha = 1.0
    eas = [ta.eps_arrays(g.eps_params(), "cpu") for g in geoms]
    qs, _ = ta.assemble_vector3_sweep(tga, ta.gather_scatter(tga), eas)
    got = tk.pencil_bounds_sweep(qs, tga.shape_vals, tga.elem_valid, betas,
                                 alpha)
    assert got.shape == (3,)
    for b, g in enumerate(geoms):
        jprim, _, _ = ja.assemble_vector3_system(
            jga, ja.eps_arrays(g.eps_params(), jnp.float32))
        jA = ja.vector3_stacked_A(jprim, jnp.float32(np.float32(betas[b])),
                                  jnp.float32(alpha))
        jb = float(jk.pencil_bounds_elem(jA, jprim["u_nn"], jga.elem_valid,
                                         C=3)[2])
        assert abs(float(got[b]) - jb) / jb <= RTOL, b
