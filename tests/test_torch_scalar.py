"""Port parity, the scalar Helmholtz path and the ARPACK backend: the
scalar assembly, the stacked-block applies, the spectrum bound, one
filter / Rayleigh-Ritz pass, ``ScalarHelmholtzSolver.solve`` (device and
hybrid backends, the cascade filter), the vectorial hybrid backend and a
2-sample ``--scalar`` dataset run with CMT, each against the JAX package
on the same mesh and the same numpy inputs. On CPU tensors the port's
wrappers run the plain twins of K2-K8; the kernels themselves are held
against these twins on the card in tests/test_torch_cuda.py.

The JAX package draws the scalar start subspace from
``jax.random.PRNGKey(42)`` (pl_fem_tpu/solvers/scalar.py:186); the tests
draw the same numbers with jax and hand them to the port as ``X0``.

Tolerances:
- assembled blocks and diagonal: <= 1e-6 of max|y| (the same f32 sums);
- single applies, the bound: <= 1e-5 (f32, two orderings of the sums);
- one filter pass (120 steps): theta and res of the converged columns
  (res < 1e-3) to 1e-4 relative / absolute, the f32 step rounding
  amplified through the recurrence;
- n_eff after the host f64 polish: <= 1e-5 relative (device backend),
  <= 1e-10 (hybrid: the same ARPACK run on bit-equal CSR matrices).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.config import SolverConfig as JSolverConfig
from pl_fem_tpu.dataset import generator as jgen
from pl_fem_tpu.dataset import record as jrec
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops import assembly as ja
from pl_fem_tpu.ops import kernels as jk
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.solvers import ScalarHelmholtzSolver as JScalar
from pl_fem_tpu.solvers import TrueVectorialMaxwellSolver as JVector
from pl_fem_tpu_torch import cli
from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig, SolverConfig
from pl_fem_tpu_torch.dataset import generator as tgen
from pl_fem_tpu_torch.dataset import record as trec
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops import assembly as ta
from pl_fem_tpu_torch.ops import cuda_kernels as ck
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops import triton_kernels as trk
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid
from pl_fem_tpu_torch.solvers import (ScalarHelmholtzSolver,
                                      TrueVectorialMaxwellSolver)
from pl_fem_tpu_torch.solvers import scalar as tsc

torch.set_num_threads(1)
K = 12
FIBER = (1, 8.0, 1.5, 1.53, 1.0)
MESH = dict(mesh_min_points=600, mesh_target_points=2500)


def _rel(ref, y):
    ref = np.asarray(ref, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return np.abs(ref - y).max() / (np.abs(ref).max() + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_start(D, k):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(42), (D, k),
                                        dtype=jnp.float32))


@pytest.fixture(scope="module")
def fiber():
    """Single-core step-index fiber (V~7) on the calibration mesh of
    tests/test_solvers.py, from each package's own mesher."""
    jg = JMCFGeometry(*FIBER, wavelength_um=1.55, use_complex_pml=False)
    g = MCFGeometry(*FIBER, wavelength_um=1.55, use_complex_pml=False)
    jcfg = JSimulationConfig(**MESH, mesh=JMeshConfig(bucket_rounding=256))
    cfg = SimulationConfig(**MESH, mesh=MeshConfig(bucket_rounding=256))
    JMeshGenerator.clear_cache()
    MeshGenerator.clear_cache()
    jdg = j_export(JMeshGenerator.generate(jg, 0.4, jcfg), 256)
    dg = export_device_grid(MeshGenerator.generate(g, 0.4, cfg), 256)
    assert np.array_equal(jdg.elem_dofs, dg.elem_dofs)
    return jg, jdg, g, dg


@pytest.fixture(scope="module")
def pencils():
    """A 3-core PML design and one without PML on one mesh: the scalar
    pencil and the stacked vectorial blocks in both packages."""
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55),
             MCFGeometry(3, 8.0, 1.5, 1.50, 1.44, wavelength_um=1.60,
                         use_complex_pml=False)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 0.5, cfg), 256)
    jga = ja.grid_to_device(dg, dtype=jnp.float32)
    tga = ta.grid_from_numpy(dg, "cpu")
    out = []
    for g in geoms:
        ep = g.eps_params()
        jA, jB, jdiag = ja.assemble_scalar_system(
            jga, ja.eps_arrays(ep, dtype=jnp.float32), jnp.float32(g.k0))
        tA, tB, tdiag, tbound = ta.assemble_scalar_system(
            tga, ta.eps_arrays(ep, "cpu"), g.k0)
        out.append(dict(g=g, jA=jA, jB=jB, jdiag=jdiag, tA=tA, tB=tB,
                        tdiag=tdiag, tbound=tbound))
    rng = np.random.default_rng(7)
    return dict(dg=dg, jga=jga, tga=tga, jgs=ja.gather_scatter(jga),
                tgs=ta.gather_scatter(tga), designs=out, rng=rng,
                D=dg.n_dofs_padded)


# ---------------------------------------------------------------------------
# assembly (K11's twin, K2 at L = 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gi", [0, 1])
def test_assemble_scalar_system_matches_jax(pencils, gi):
    d = pencils["designs"][gi]
    assert d["tA"].shape == d["tB"].shape == (
        pencils["dg"].elem_dofs.shape[0], 6, 6)
    assert _rel(d["jA"], d["tA"].numpy()) <= 1e-6
    assert _rel(d["jB"], d["tB"].numpy()) <= 1e-6
    assert _rel(d["jdiag"], d["tdiag"].numpy()) <= 1e-6
    # padded DOF rows carry 1.0 (the fill mask is dof_valid)
    pad = pencils["dg"].dof_valid == 0
    assert pad.any() and np.all(d["tdiag"].numpy()[pad] == 1.0)


def test_eps_twin_decides_every_point_as_jax(pencils):
    """eps_re is equal at every quadrature point, PML on and off."""
    for d in pencils["designs"]:
        ep = d["g"].eps_params()
        jre, jim = ja.eps_at_quadrature(pencils["jga"],
                                        ja.eps_arrays(ep, jnp.float32))
        tre, tim = trk.eps_at_quadrature(pencils["tga"].qp_xy,
                                         ta.eps_arrays(ep, "cpu"))
        assert np.array_equal(np.asarray(jre), tre.numpy())
        assert np.abs(np.asarray(jim) - tim.numpy()).max() <= 1e-6


# ---------------------------------------------------------------------------
# K11's twin: the scalar pencil's set-up in one call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gi", [0, 1])
def test_scalar_pencil_twin_matches_jax(pencils, gi):
    """K11's twin against the JAX package's assemble_scalar_system and
    pencil_bounds_elem, PML on (design 0) and off (design 1): A, B and
    B's diagonal terms within 1e-6, eps_re equal at every point, the
    bound within 1e-5; the wrapper runs the twin on CPU tensors (no
    launch counted), and the assembly carries the same bound."""
    d = pencils["designs"][gi]
    ga, jga = pencils["tga"], pencils["jga"]
    ep = d["g"].eps_params()
    k0 = np.float32(d["g"].k0)
    n0 = ck.scalar_pencil.launches
    A, B, diag, bound, eps_re = ck.scalar_pencil(
        ga.grad_phys, ga.qp_w, ga.qp_xy, ga.shape_vals,
        ta.eps_arrays(ep, "cpu"), float(k0 * k0), ga.elem_valid,
        tk._linv_ref_on("cpu"), tk._TRACE_REF, return_eps=True)
    assert ck.scalar_pencil.launches == n0
    E = pencils["dg"].elem_dofs.shape[0]
    assert A.shape == B.shape == (E, 6, 6) and diag.shape == (E, 6)
    assert _rel(d["jA"], A.numpy()) <= 1e-6
    assert _rel(d["jB"], B.numpy()) <= 1e-6
    jdiag_e = np.diagonal(np.asarray(d["jB"]), axis1=1, axis2=2)
    assert _rel(jdiag_e, diag.numpy()) <= 1e-6
    jre, _ = ja.eps_at_quadrature(jga, ja.eps_arrays(ep, jnp.float32))
    assert np.array_equal(np.asarray(jre), eps_re.numpy())
    _, _, jb = jk.pencil_bounds_elem(d["jA"], d["jB"], jga.elem_valid, C=1)
    assert bound.shape == ()
    assert abs(float(jb) - float(bound)) <= 1e-5 * float(jb)
    assert torch.equal(d["tbound"], bound)


def test_carried_bound_solves_as_the_blocks_bound(pencils):
    """``solve_pencil_lowest`` on the pencil ``build_scalar_pencil``
    assembles, with the bound the assembly carries (K11's twin), gives
    the bits of the same solve that bounds the blocks itself
    (``pencil_bounds_elem``, K8's twin)."""
    d = pencils["designs"][0]
    g, dg = d["g"], pencils["dg"]
    pen = tsc.build_scalar_pencil(dg, g.eps_params(), g.k0, "cpu")
    _, _, b = tk.pencil_bounds_elem(pen.A_blocks, pen.B_blocks,
                                    pen.ga.elem_valid, C=1)
    assert torch.equal(pen.bound, b)
    window = g.k0**2 * (g.n_core**2 - g.n_clad**2)
    cut = -(g.k0 * g.n_clad) ** 2 + 0.02 * window
    X0 = np.random.default_rng(13).standard_normal(
        (dg.n_dofs_padded, K)).astype(np.float32)
    kw = dict(degree=30, passes=2, max_passes=2, tol=1e-8, park=1.0,
              n_wanted=K)
    carried = tsc.solve_pencil_lowest(pen, X0, cut, **kw)
    own = tsc.solve_pencil_lowest(dataclasses.replace(pen, bound=None), X0,
                                  cut, **kw)
    for x, y in zip(carried, own):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the stacked applies (K5 twin, K3 twin) and the bound (K8 twin)
# ---------------------------------------------------------------------------

def _stacked_c3(pencils):
    g = pencils["designs"][0]["g"]
    ep = g.eps_params()
    beta = np.float32(g.k0 * 1.45)
    jprim, _, _ = ja.assemble_vector3_system(
        pencils["jga"], ja.eps_arrays(ep, jnp.float32))
    tprim, _, _ = ta.assemble_vector3_system(pencils["tga"],
                                             ta.eps_arrays(ep, "cpu"))
    jA = ja.vector3_stacked_A(jprim, jnp.float32(beta), jnp.float32(1.0))
    tA = ta.vector3_stacked_A(tprim, beta, np.float32(1.0))
    return g, beta, jprim, tprim, jA, tA


@pytest.mark.parametrize("C", [1, 3])
def test_apply_stacked_matches_jax(pencils, C):
    """_apply_stacked (K5's twin: the element product, then K2's twin
    with its epilogue per component) on the scalar blocks with the
    valid-DOF mask (C = 1) and on the (E, 18, 18) vectorial blocks with
    the interior mask (C = 3)."""
    D = pencils["D"]
    X = pencils["rng"].standard_normal((C * D, K)).astype(np.float32)
    if C == 1:
        d = pencils["designs"][0]
        jA, tA = d["jA"], d["tA"]
        jmask, tmask, park = (pencils["jga"].dof_valid,
                              pencils["tga"].dof_valid, 1.0)
    else:
        _, _, _, _, jA, tA = _stacked_c3(pencils)
        jmask, tmask, park = (pencils["jga"].interior_mask,
                              pencils["tga"].interior_mask, 50.0)
    ref = jk._apply_stacked(jA, pencils["jgs"], jmask, jnp.float32(park),
                            jnp.asarray(X), C)
    y = tk._apply_stacked(tA, pencils["tgs"], tmask, park, _t(X), C)
    assert y.shape == (C * D, K)
    assert _rel(ref, y.numpy()) <= 1e-5


def test_apply_stacked_c3_matches_fused_apply(pencils):
    """The assembled-block apply at C = 3 == the port's matrix-free
    A(beta) apply (K1 + K2 twins) on the same block, B = 1."""
    g, beta, _, _, _, tA = _stacked_c3(pencils)
    tga, tgs, D = pencils["tga"], pencils["tgs"], pencils["D"]
    qf, _ = ta.assemble_vector3_qf(tga, ta.eps_arrays(g.eps_params(), "cpu"))
    qs = tk.QFactorSweep(invJT=qf.invJT, w=qf.w, inv_eps=qf.inv_eps[None],
                         gp=tga.grad_phys)
    X = _t(pencils["rng"].standard_normal((3 * D, 1, K)).astype(np.float32))
    y = tk._apply_stacked(tA, tgs, tga.interior_mask, 50.0,
                          X[:, 0].contiguous(), 3)
    ref = tk._stacked_from_fused(tk._apply_vector3_fused(
        qs, tgs, tga.interior_mask, torch.tensor([50.0]),
        torch.tensor([beta]), 1.0, tk._fused_from_stacked(X)))[:, 0]
    assert _rel(ref.numpy(), y.numpy()) <= 1e-5


@pytest.mark.parametrize("C", [1, 3])
def test_apply_plan_reproduces_the_stacked_apply(pencils, C):
    """K5's sum, emulated in f64 on the grid's apply plan: every element
    slot of a block writes the results of its own entries (``dst``),
    each entry exactly once, and each owned row sums its entries in the
    plan's order, one sum per component (rows c D + d), then the mask
    and park; this reproduces the twin within 1e-6."""
    tga, tgs, D = pencils["tga"], pencils["tgs"], pencils["D"]
    plan = tgs.apply_plan
    R, NB = plan.rows, plan.elems.shape[0]
    if C == 1:
        A, mask, park = pencils["designs"][0]["tA"], tga.dof_valid, 1.0
    else:
        A, mask, park = _stacked_c3(pencils)[5], tga.interior_mask, 50.0
    X = _t(pencils["rng"].standard_normal((C * D, K)).astype(np.float32))
    dt = torch.float64
    b, s, i = (plan.dst >= 0).nonzero(as_tuple=True)
    e = plan.elems.long()[b, s]
    g = plan.row_ptr.long()[b * R] + plan.dst.long()[b, s, i]
    n_ent = int(plan.row_ptr[-1])
    assert torch.equal(torch.bincount(g, minlength=n_ent),
                       torch.ones(n_ent, dtype=torch.int64))
    pos = torch.repeat_interleave(
        torch.arange(NB * R), (plan.row_ptr[1:] - plan.row_ptr[:-1]).long())
    m, Xd = mask.to(dt), X.to(dt)
    Ye = ck.apply_stacked_elem_plain(Xd, m, tga.elem_dofs, A.to(dt), C)
    out = []
    for c in range(C):
        Y = torch.zeros((NB * R, K), dtype=dt)
        Y.index_add_(0, pos[g], Ye[c, e, i])
        Yd = torch.zeros((D, K), dtype=dt)
        Yd[plan.order.long()] = Y[:D]
        Xc = Xd[c * D:(c + 1) * D]
        out.append(Yd * m[:, None] + park * (Xc - Xc * m[:, None]))
    ref = tk._apply_stacked(A, tgs, mask, park, X, C)
    assert _rel(ref.numpy(), torch.cat(out).numpy()) <= 1e-6


def test_mass_applies_match_jax_blocks(pencils):
    """K3's twin (the mass built from the quadrature weights) == the JAX
    package's _apply_mass on the assembled B blocks, and the degree-8
    B^{-1} built on it == _apply_binv, with the valid-DOF mask."""
    d = pencils["designs"][0]
    D = pencils["D"]
    X = pencils["rng"].standard_normal((D, K)).astype(np.float32)
    ref = jk._apply_mass(d["jB"], pencils["jgs"], pencils["jga"].dof_valid,
                         jnp.asarray(X), 1)
    y = tk._apply_mass(pencils["tga"].qp_w, pencils["tgs"],
                       pencils["tga"].dof_valid, _t(X), 1)
    assert _rel(ref, y.numpy()) <= 1e-6
    dinv = (1.0 / np.sqrt(np.maximum(np.asarray(d["jdiag"]), 1e-30))
            ).astype(np.float32)
    lo, hi = np.float32(jk.MASS_LO), np.float32(jk.MASS_HI)
    ref = jk._apply_binv(d["jB"], pencils["jgs"], pencils["jga"].dof_valid,
                         jnp.asarray(dinv), jnp.float32(lo), jnp.float32(hi),
                         jnp.asarray(X), 1, 8)
    y = tk._apply_binv(pencils["tga"].qp_w, pencils["tgs"],
                       pencils["tga"].dof_valid, _t(dinv), lo, hi, _t(X), 1,
                       8)
    assert _rel(ref, y.numpy()) <= 1e-5


@pytest.mark.parametrize("C", [1, 3])
def test_pencil_bounds_match_jax(pencils, C):
    if C == 1:
        d = pencils["designs"][1]
        jA, jB, tA, tB = d["jA"], d["jB"], d["tA"], d["tB"]
    else:
        _, _, jprim, tprim, jA, tA = _stacked_c3(pencils)
        jB, tB = jprim["u_nn"], tprim["u_nn"]
    jlo, jhi, jb = jk.pencil_bounds_elem(jA, jB, pencils["jga"].elem_valid,
                                         C=C)
    tlo, thi, tb = tk.pencil_bounds_elem(tA, tB, pencils["tga"].elem_valid,
                                         C=C)
    assert (float(jlo), float(jhi)) == (float(tlo), float(thi))
    assert tb.shape == () and float(tb) > 0
    assert abs(float(jb) - float(tb)) / float(jb) <= 1e-5


def test_cheb_step_twin_single_component():
    """K4's twin on a (D, 1, 1, k) block: the scalar recurrence step and
    its renorm scale over all rows (pl_fem_tpu/ops/kernels.py:1199-1205),
    which the step after it applies as it reads its inputs."""
    rng = np.random.default_rng(2)
    W, V, T0, W3 = (rng.standard_normal((300, 1, 1, K)).astype(np.float32)
                    for _ in range(4))
    c, h = np.float32(3.0), np.float32(40.0)
    T2 = 2.0 * (W - c * V) / h - T0
    s = 1.0 / (np.linalg.norm(T2.reshape(300, K), axis=0) + 1e-30)
    Vt = _t(V)
    ct, ht = torch.tensor([c]), torch.tensor([h])
    y, st = trk.cheb_step(_t(W), Vt, _t(T0), ct, ht, renorm=True)
    assert _rel(T2, y.numpy()) <= 1e-6             # written unscaled
    assert _rel(s, st.numpy()[0]) <= 1e-6
    assert np.array_equal(V, Vt.numpy())           # not rescaled in place
    # the next step on the rescaled pair (s V, s T2), with W3 = W(T2)
    T3 = 2.0 * (s * W3 - c * s * T2) / h - s * V
    y3, _ = trk.cheb_step(_t(W3), y, Vt, ct, ht, scale=st, scale_t0=st)
    assert _rel(T3, y3.numpy()) <= 1e-6
    y, _ = trk.cheb_step(_t(W), _t(V), None, ct, ht)
    assert _rel((W - c * V) / h, y.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# one filter / Rayleigh-Ritz pass and the pass loop
# ---------------------------------------------------------------------------

def _fiber_pencil(fiber):
    jg, jdg, g, dg = fiber
    jga = ja.grid_to_device(jdg, dtype=jnp.float32)
    jA, jB, jdiag = ja.assemble_scalar_system(
        jga, ja.eps_arrays(jg.eps_params(), dtype=jnp.float32),
        jnp.float32(jg.k0))
    window = g.k0**2 * (g.n_core**2 - g.n_clad**2)
    cut = -(g.k0 * g.n_clad) ** 2 + 0.02 * window
    return jga, jA, jB, jdiag, cut


def test_cheb_rr_pass_matches_jax(fiber):
    """One 120-step pass from the same start block: theta and res of the
    converged columns (res < 1e-3) within 1e-4."""
    jg, jdg, g, dg = fiber
    jga, jA, jB, jdiag, cut = _fiber_pencil(fiber)
    D = dg.n_dofs_padded
    X0 = np.random.default_rng(11).standard_normal((D, K)).astype(np.float32)
    lo, hi, bound = jk.pencil_bounds_elem(jA, jB, jga.elem_valid, C=1)
    bound = max(float(bound), 1.05, cut * 1.5 + 1.0)
    dinv = (1.0 / np.sqrt(np.maximum(np.asarray(jdiag), 1e-30))
            ).astype(np.float32)
    jth, jX, jres = jk.cheb_rr_pass(
        jA, jB, ja.gather_scatter(jga), jga.dof_valid, jnp.asarray(dinv),
        jnp.float32(lo), jnp.float32(hi), jnp.float32(1.0), jnp.asarray(X0),
        jnp.float32(cut), jnp.float32(bound), C=1, degree=120, binv_degree=8)
    pen = tsc.scalar_pencil_from_numpy(dg, jA, jB, jdiag, g.k0, "cpu")
    tth, tX, tres, _ = tk.cheb_rr_pass_impl(
        pen.A_blocks, pen.ga.qp_w, ta.gather_scatter(pen.ga),
        pen.ga.dof_valid, _t(dinv), np.float32(lo), np.float32(hi), 1.0,
        _t(X0), torch.tensor(np.float32(cut)),
        torch.tensor(np.float32(bound)), C=1, degree=120, binv_degree=8)
    assert tX.shape == (D, K)
    jth, jres = np.asarray(jth), np.asarray(jres)
    conv = jres < 1e-3
    assert conv.sum() >= 3
    assert np.abs(tth.numpy()[conv] - jth[conv]).max() \
        <= 1e-4 * np.abs(jth).max()
    assert np.abs(tres.numpy()[conv] - jres[conv]).max() <= 1e-4


def test_solve_lowest_kernel_on_jax_blocks(fiber):
    """The JAX package's assembled blocks, handed over as numpy
    (scalar_pencil_from_numpy), through the port's pass loop: the
    wanted Ritz values within 1e-4 relative of the JAX package's from the
    same start block."""
    jg, jdg, g, dg = fiber
    jga, jA, jB, jdiag, cut = _fiber_pencil(fiber)
    X0 = _jax_start(dg.n_dofs_padded, K)
    kw = dict(degree=60, passes=2, tol=1e-8, park=1.0, n_wanted=K)
    jth, _, jres = jk.solve_lowest_kernel(
        jA, jB, ja.gather_scatter(jga), jga.dof_valid, jdiag,
        jnp.asarray(X0), cut, jga.elem_valid, C=1, **kw)
    pen = tsc.scalar_pencil_from_numpy(dg, jA, jB, jdiag, g.k0, "cpu")
    n2, n3 = ck.accumulate.launches, ck.mass_apply.launches
    tth, tX, tres = tsc.solve_pencil_lowest(pen, X0, cut, **kw)
    # CPU tensors run the twins: no kernel launch is counted
    assert (ck.accumulate.launches, ck.mass_apply.launches) == (n2, n3)
    jth = np.asarray(jth)
    wanted = jth < cut
    assert wanted.sum() >= 4
    assert np.abs(tth.numpy()[wanted] - jth[wanted]).max() \
        <= 1e-4 * np.abs(jth[wanted]).max()
    assert float(tres[torch.from_numpy(wanted)].max()) < 1e-3


# ---------------------------------------------------------------------------
# ScalarHelmholtzSolver.solve
# ---------------------------------------------------------------------------

SOLVE_KW = dict(cheb_degree=150, cheb_passes=2)


@pytest.fixture(scope="module")
def hybrid_modes(fiber):
    jg, jdg, g, dg = fiber
    jm = JScalar(jg, JSimulationConfig(solver=JSolverConfig(
        backend="hybrid"))).solve(jdg, n_modes_target=8)
    # the hybrid backend is host only: it runs with the default device
    # ('cuda') and no card
    tm = ScalarHelmholtzSolver(g, SimulationConfig(solver=SolverConfig(
        backend="hybrid"))).solve(dg, n_modes_target=8)
    return jm, tm


def test_scalar_hybrid_matches_jax(hybrid_modes):
    jm, tm = hybrid_modes
    assert len(tm) == len(jm) >= 10
    for a, b in zip(jm, tm):
        assert abs(a["n_eff"] - b["n_eff"]) <= 1e-10 * a["n_eff"]
        assert a.keys() == b.keys()
        assert abs(a["confinement"] - b["confinement"]) <= 1e-9
        assert b["polarization"] == "scalar" and b["is_vectorial"] is False
        assert b["field_vector"].shape == a["field_vector"].shape


def test_scalar_device_matches_jax(fiber, hybrid_modes):
    """Device backend (CPU tensors) from the JAX package's start block:
    n_eff within 1e-5 relative after the host polish, and within the JAX
    package's own parity limit (5e-5 absolute) of the ARPACK backend."""
    jg, jdg, g, dg = fiber
    jm = JScalar(jg, JSimulationConfig(solver=JSolverConfig(
        backend="tpu", **SOLVE_KW))).solve(jdg, n_modes_target=8)
    cfg = SimulationConfig(solver=SolverConfig(device="cpu", **SOLVE_KW))
    k = 8 + cfg.solver.extra_vectors
    tm = ScalarHelmholtzSolver(g, cfg).solve(
        dg, n_modes_target=8, X0=_jax_start(dg.n_dofs_padded, k))
    assert len(tm) >= 8 and len(jm) >= 8
    for a, b in zip(jm[:8], tm[:8]):
        assert abs(a["n_eff"] - b["n_eff"]) <= 1e-5 * a["n_eff"]
    for b, h in zip(tm[:8], hybrid_modes[1][:8]):
        assert abs(b["n_eff"] - h["n_eff"]) < 5e-5
    for b, h in zip(tm[:4], hybrid_modes[1][:4]):
        assert abs(b["confinement"] - h["confinement"]) < 1e-3


def test_scalar_default_start_is_seeded(fiber):
    """Without X0 the start block comes from a torch.Generator seeded
    with SolverConfig.seed: two solves agree bit for bit, and another
    seed gives another subspace."""
    _, _, g, dg = fiber
    kw = dict(device="cpu", cheb_degree=80, cheb_passes=2, scalar_tol=1e-2)
    cfg = SimulationConfig(solver=SolverConfig(**kw))
    a = ScalarHelmholtzSolver(g, cfg).solve(dg, n_modes_target=4)
    b = ScalarHelmholtzSolver(g, cfg).solve(dg, n_modes_target=4)
    c = ScalarHelmholtzSolver(g, SimulationConfig(solver=SolverConfig(
        seed=5, **kw))).solve(dg, n_modes_target=4)
    assert len(a) >= 4
    assert [m["n_eff"] for m in a] == [m["n_eff"] for m in b]
    assert [m["n_eff"] for m in a] != [m["n_eff"] for m in c]
    assert abs(a[0]["n_eff"] - c[0]["n_eff"]) < 1e-4


def test_cascade_filter_keeps_same_modes(fiber):
    jg, jdg, g, dg = fiber
    jm = JScalar(jg, JSimulationConfig(solver=JSolverConfig(
        backend="hybrid"))).solve(jdg, 8, mode_filter="cascade")
    tm = ScalarHelmholtzSolver(g, SimulationConfig(solver=SolverConfig(
        backend="hybrid"))).solve(dg, 8, mode_filter="cascade")
    assert 1 <= len(tm) == len(jm) <= 3 * g.n_cores
    for a, b in zip(jm, tm):
        assert abs(a["n_eff"] - b["n_eff"]) <= 1e-10 * a["n_eff"]
        assert abs(a["confinement"] - b["confinement"]) <= 1e-9
        assert abs(a["core_overlap"] - b["core_overlap"]) <= 1e-9


def test_scalar_backend_and_device_are_explicit(fiber):
    _, _, g, dg = fiber
    with pytest.raises(ValueError, match="backend"):
        ScalarHelmholtzSolver(g, SimulationConfig(solver=SolverConfig(
            backend="tpu", device="cpu"))).solve(dg, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ScalarHelmholtzSolver(g, SimulationConfig()).solve(dg, 4)


def test_vectorial_hybrid_matches_jax(fiber):
    """The transverse-pencil ARPACK backend of the vectorial solver:
    the same modes, n_eff within 1e-8 relative."""
    jg, jdg, g, dg = fiber
    jm = JVector(jg, config=JSimulationConfig(solver=JSolverConfig(
        backend="hybrid"))).solve_vectorial_modes(jdg, n_modes_target=6)
    tm = TrueVectorialMaxwellSolver(g, config=SimulationConfig(
        solver=SolverConfig(backend="hybrid"))) \
        .solve_vectorial_modes(dg, n_modes_target=6)
    assert len(tm) == len(jm) > 0
    for a, b in zip(jm, tm):
        assert abs(a["n_eff"] - b["n_eff"]) <= 1e-8 * a["n_eff"]
        assert a["polarization"] == b["polarization"]
        assert b["Hz_dofs"].shape == b["Ex_dofs"].shape == (dg.n_dofs,)
        assert abs(a["div_ratio"] - b["div_ratio"]) \
            <= 1e-6 * max(abs(a["div_ratio"]), 1e-12)


# ---------------------------------------------------------------------------
# the dataset engine's scalar branches
# ---------------------------------------------------------------------------

def test_scalar_and_hybrid_provenance_match_jax():
    for use_vectorial, jb, tb in ((False, "tpu", "device"),
                                  (False, "hybrid", "hybrid"),
                                  (True, "hybrid", "hybrid")):
        jgn = jgen.DatasetGenerator(
            config=JSimulationConfig(solver=JSolverConfig(backend=jb)),
            use_vectorial=use_vectorial)
        tgn = tgen.DatasetGenerator(
            config=SimulationConfig(solver=SolverConfig(backend=tb)),
            use_vectorial=use_vectorial)
        ra = jrec.DatasetRecord(sample_id="p")
        rb = trec.DatasetRecord(sample_id="p", timestamp=ra.timestamp)
        jgn._provenance(ra, None, False)
        tgn._provenance(rb, None, False)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert rb.solver_mode == ("hybrid_arpack" if use_vectorial
                                  else "scalar_cascade")


N_SAMPLES = 2
SEED = 42
# scalar_tol 3e-2 ends most solves at the first gate check (2 passes);
# extra_vectors 10 keeps every block at >= 12 columns (torch's CPU bmm
# is ~5x slower on 6 x 6 blocks times fewer columns)
DS_SOLVER = dict(cheb_degree=100, cheb_passes=2, extra_vectors=10,
                 scalar_tol=3e-2)
DS_SIM = dict(mesh_min_points=500, mesh_target_points=2000,
              n_modes_target=4, cmt_min_scale=0.7)
# one bucket size for a design's slice meshes: the JAX package compiles
# once per design
DS_MESH = dict(bucket_rounding=1024, refinement=0.35)


def _port_scalar_with_jax_start(orig):
    def solve(self, grid=None, n_modes_target=20, mode_filter="none",
              X0=None):
        s = self.config.solver
        k = min(n_modes_target + s.extra_vectors, max(grid.n_dofs - 4, 1))
        return orig(self, grid, n_modes_target, mode_filter,
                    X0=_jax_start(grid.n_dofs_padded, k))
    return solve


@pytest.fixture(scope="module")
def scalar_runs(tmp_path_factory):
    """records.jsonl of the JAX package (DatasetGenerator.generate,
    use_vectorial=False) and of the port (cli.main --scalar with a YAML
    config, CPU device): 2 samples, 3 CMT slices, engine 'sweep' (scalar
    runs fall back to the serial loop in both)."""
    root = tmp_path_factory.mktemp("scalar_slice")
    jdir, tdir = root / "jax", root / "port"
    jcfg = JSimulationConfig(**DS_SIM, mesh=JMeshConfig(**DS_MESH),
                             solver=JSolverConfig(backend="tpu", **DS_SOLVER))
    (root / "run.yaml").write_text(
        f"n: {N_SAMPLES}\nseed: {SEED}\nengine: sweep\ncmt_slices: 3\n"
        "scalar: true\nsimulation:\n"
        + "".join(f"  {k}: {v}\n" for k, v in DS_SIM.items())
        + "  mesh:\n" + "".join(f"    {k}: {v}\n" for k, v in DS_MESH.items())
        + "  solver:\n    device: cpu\n"
        + "".join(f"    {k}: {v}\n" for k, v in DS_SOLVER.items()))
    jgen.DatasetGenerator(config=jcfg, use_vectorial=False, n_taper_slices=3,
                          base_seed=SEED, out_dir=jdir).generate(
                              N_SAMPLES, engine="sweep")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ScalarHelmholtzSolver, "solve",
                   _port_scalar_with_jax_start(ScalarHelmholtzSolver.solve))
        assert cli.main(["--config", str(root / "run.yaml"),
                         "--out", str(tdir)]) == 0
    return jdir, tdir


def _load(d):
    return {r["sample_id"]: r for r in map(
        json.loads, (d / "records.jsonl").read_text().splitlines())}


def test_scalar_dataset_records_match_jax(scalar_runs):
    """Every record field but the timings: n_eff within 1e-5 relative,
    loss metrics within 5e-4 dB, CMT IL and power conservation within
    1e-6 (the scalar slices are solved by the f32 filter on their own
    meshes, so the overlaps carry its rounding), the crosstalk within
    0.05 dB (at -50 dB it is a ~1e-5 overlap of near-orthogonal fields,
    which magnifies that rounding; measured 0.02 dB); everything else
    equal."""
    jdir, tdir = scalar_runs
    ref, out = _load(jdir), _load(tdir)
    assert len(ref) == N_SAMPLES and ref.keys() == out.keys()
    ok = [r for r in out.values() if r["success"]]
    assert ok and all(r["IL_CMT_mux_dB"] is not None for r in ok)
    assert all(r["solver_mode"] == "scalar_cascade" for r in ok)
    for sid, r in ref.items():
        o = out[sid]
        assert r.keys() == o.keys()
        for key, a in r.items():
            b = o[key]
            if key in ("timestamp", "solver_time_s"):
                continue
            if isinstance(a, float) and isinstance(b, float):
                if key.startswith(("n_eff", "beta")):
                    tol = 1e-5 * abs(a)
                elif "CMT" in key or key.startswith("power_conservation"):
                    tol = 1e-6
                elif key.startswith("crosstalk"):
                    tol = 0.05
                else:
                    tol = 5e-4
                assert abs(a - b) <= tol, (sid, key, a, b)
            else:
                assert a == b, (sid, key, a, b)
    assert (tdir / "dataset_raw.csv").exists()


def test_scalar_dataset_resumes(scalar_runs, monkeypatch):
    """A second --scalar run on the port's directory solves nothing."""
    _, tdir = scalar_runs
    before = (tdir / "records.jsonl").read_text()

    def no_solve(*a, **k):
        raise AssertionError("a resumed run re-simulated a sample")

    monkeypatch.setattr(ScalarHelmholtzSolver, "solve", no_solve)
    gen = tgen.DatasetGenerator(use_vectorial=False, n_taper_slices=3,
                                base_seed=SEED, out_dir=tdir)
    records = gen.generate(N_SAMPLES, engine="sweep")
    assert len(records) == N_SAMPLES
    assert (tdir / "records.jsonl").read_text() == before

