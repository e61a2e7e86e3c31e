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
