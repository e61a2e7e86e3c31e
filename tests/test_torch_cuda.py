"""The hand-written kernels on the card against their plain twins.

Every test here needs a CUDA device and skips without one; they import
neither jax nor the JAX package, so they also run where only the port
is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: <= 1e-5 of max|y| (f32 kernel vs f32 twin, two orderings of
the same sums); K6 and K11 decide eps_re exactly as their twins, and
K6 holds eps_im to 1e-6 of max(1, max|eps_im|) (the kernel's exp / log
against powf).
"""
import threading
import time

import numpy as np
import pytest
import torch

from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops import assembly as ta
from pl_fem_tpu_torch.ops import cuda_kernels as ck
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops import triton_kernels as trk
from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid

pytestmark = pytest.mark.cuda
B, K = 3, 7


def _rel(ref, y):
    ref = ref.double().cpu()
    y = y.double().cpu()
    return float((ref - y).abs().max() / (ref.abs().max() + 1e-300))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA and Triton kernels have "
                    "no CPU mode; their plain twins are tested against the "
                    "JAX package in test_torch_kernels.py)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(dev):
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.50, 1.60, B)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 0.5, cfg), 256)
    ga = ta.grid_to_device(dg, dev)
    invs = [ta.assemble_vector3_qf(ga, ta.eps_arrays(g.eps_params(), dev))[0]
            for g in geoms]
    qs = tk.QFactorSweep(invJT=invs[0].invJT, w=invs[0].w,
                         inv_eps=torch.stack([q.inv_eps for q in invs]),
                         gp=ga.grad_phys)
    gen = torch.Generator(device=dev).manual_seed(3)
    D = dg.n_dofs_padded
    X = torch.randn((D, B * 3 * K), generator=gen, device=dev)
    return dict(ga=ga, gs=ta.gather_scatter(ga), qs=qs, X=X, gen=gen,
                betas=torch.tensor([g.k0 * 1.49 for g in geoms], device=dev))


def _check_apply(qs, gs, mask, betas, X, parks):
    """K1 against its twin: within 1e-5 of max|y|, one launch, and the
    same bits from a second launch."""
    args = (gs, qs.gp, qs.w, qs.inv_eps, betas, 1.0,
            tk.shape_table(X.device), mask, parks)
    n0 = ck.apply_vector3.launches
    y = ck.apply_vector3(X, *args)
    assert ck.apply_vector3.launches == n0 + 1
    assert _rel(ck.apply_vector3_plain(X, *args), y) <= 1e-5
    assert torch.equal(y, ck.apply_vector3(X, *args))


@pytest.mark.parametrize("rows", [ta.APPLY_ROWS, ta.APPLY_ROWS // 2])
@pytest.mark.parametrize("b,k", [(1, K), (B, K), (B, 22)])
def test_apply_vector3(setup, dev, b, k, rows):
    """The fused A(beta) apply at L = 1*3*7, 3*3*7 and 3*3*22, on the
    grid's plan and on one of half its rows per block (the kernel takes
    256 threads instead of 512 there)."""
    s = setup
    qs = s["qs"]._replace(inv_eps=s["qs"].inv_eps[:b].contiguous())
    gs = s["gs"]
    if rows != gs.apply_plan.rows:
        gs = gs._replace(apply_plan=ta._apply_plan(s["ga"], rows))
    X = torch.randn((s["X"].shape[0], b * 3 * k), generator=s["gen"],
                    device=dev)
    _check_apply(qs, gs, s["ga"].interior_mask, s["betas"][:b], X,
                 torch.linspace(10.0, 50.0, b, device=dev))


# L = 1 and 3 take the row-per-thread path, 21 / 22 / 24 the lane path
# with scalar / float2 / float4 loads, 63 the filter's B * 3 * K
@pytest.mark.parametrize("L", [1, 3, 21, 22, 24, B * 3 * K])
@pytest.mark.parametrize("epilogue", [False, True])
def test_accumulate(setup, dev, epilogue, L):
    s = setup
    gs = s["gs"]
    E = gs.elem_dofs.shape[0]
    D = s["X"].shape[0]
    Ye = torch.randn((E, 6, L), generator=s["gen"], device=dev)
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    extra = ()
    if epilogue:
        park = torch.linspace(1.0, 7.0, L, device=dev)
        extra = (torch.randn((D, L), generator=s["gen"], device=dev),
                 s["ga"].interior_mask, park)
    y = ck.accumulate(Ye, *tables, *extra)
    assert _rel(ck.accumulate_plain(Ye, *tables, *extra), y) <= 1e-5
    # deterministic: a second launch gives the same bits
    assert torch.equal(y, ck.accumulate(Ye, *tables, *extra))


def test_mass_diagonal_single_lane(setup, dev):
    """K2 at L = 1, the mass diagonal of assemble_vector3_qf."""
    s = setup
    _, diag = ta.assemble_vector3_qf(
        s["ga"], ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                               .eps_params(), dev))
    ga_cpu = ta.GridArrays(*(t.cpu() for t in s["ga"]))
    _, ref = ta.assemble_vector3_qf(
        ga_cpu, ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                              .eps_params(), "cpu"))
    assert _rel(ref, diag) <= 1e-5


def _k3_chain(*args):
    """The B^{-1} semi-iteration as ``degree`` K3 launches in step mode,
    R and Z in device buffers: the chain K12 replaces."""
    return ck.mass_step_chain(ck.mass_apply, *args)


def _check_mass(ga, gs, qs, X, dinv):
    """K3 against its twins on the card: plain mode, and B^{-1} at degree
    1 through the step mode (one K3 launch) and at degree 4 as
    ``_binv_steps`` routes it: four K3 launches on rows of more than
    BINV_LANES lanes, else one K12 launch with the K3 step chain's bits;
    each within 1e-5 of max|y| and bitwise repeatable."""
    mask = ga.interior_mask
    lo, hi = np.float32(tk.MASS_LO), np.float32(tk.MASS_HI)
    y = tk._apply_mass_fused(qs, gs, mask, X, 50.0)
    assert _rel(tk._apply_mass_fused_plain(qs, gs, mask, X, 50.0), y) <= 1e-5
    assert torch.equal(y, tk._apply_mass_fused(qs, gs, mask, X, 50.0))
    for degree in (1, 4):
        n0, n12 = ck.mass_apply.launches, ck.binv_chain.launches
        y = tk._apply_binv_fused(qs, gs, mask, dinv, lo, hi, X, degree)
        chain = degree > 1 and X.shape[1] <= ck.BINV_LANES
        assert ck.mass_apply.launches == n0 + (0 if chain else degree)
        assert ck.binv_chain.launches == n12 + chain
        ref = tk._apply_binv_fused_plain(qs, gs, mask, dinv, lo, hi, X,
                                         degree)
        assert _rel(ref, y) <= 1e-5
        assert torch.equal(y, tk._apply_binv_fused(qs, gs, mask, dinv, lo,
                                                   hi, X, degree))
        theta, a, b = tk._binv_coefs(lo, hi, degree)
        assert torch.equal(y, _k3_chain(X, gs, qs.w, tk.shape_table(X.device),
                                        mask, dinv, a, b, theta, degree))
    torch.cuda.synchronize()


def _dinv(ga, dev):
    _, diag = ta.assemble_vector3_qf(
        ga, ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0).eps_params(),
                          dev))
    return 1.0 / torch.sqrt(diag)


def test_mass_apply(setup, dev):
    s = setup
    _check_mass(s["ga"], s["gs"], s["qs"], s["X"], _dinv(s["ga"], dev))


@pytest.mark.parametrize("first,renorm,scaled", [
    (True, False, False), (False, False, False), (False, True, False),
    (False, False, True)])
def test_cheb_step(dev, first, renorm, scaled):
    g = torch.Generator(device=dev).manual_seed(1)
    W, V, T0 = (torch.randn((300, B, 3, K), generator=g, device=dev)
                for _ in range(3))
    T0 = None if first else T0
    c = torch.tensor([1.0, 2.0, 3.0], device=dev)
    h = torch.tensor([4.0, 5.0, 6.0], device=dev)
    kw = {}
    if scaled:
        kw = {n: torch.rand((B, K), generator=g, device=dev) + 0.5
              for n in ("scale", "scale_t0")}
    V1 = V.clone()
    y, s = trk.cheb_step(W, V1, T0, c, h, renorm=renorm, **kw)
    ref, rs = trk.cheb_step_plain(W, V, T0, c, h, renorm=renorm, **kw)
    assert _rel(ref, y) <= 1e-5
    assert torch.equal(V1, V)
    assert (s is None) == (not renorm)
    if renorm:
        assert s.shape == (B, K) and _rel(rs, s) <= 1e-5
        assert torch.equal(s, trk.cheb_step(W, V1, T0, c, h, renorm=True)[1])


@pytest.mark.parametrize("renorm", [False, True])
def test_cheb_step_single_component(dev, renorm):
    """K4 on the scalar solver's (D, 1, 1, k) block: one design, one
    component, the column norm over all rows; one launch counted."""
    g = torch.Generator(device=dev).manual_seed(4)
    W, V, T0 = (torch.randn((5000, 1, 1, 22), generator=g, device=dev)
                for _ in range(3))
    c = torch.tensor([3.0], device=dev)
    h = torch.tensor([40.0], device=dev)
    n0 = trk.cheb_step.launches
    y, s = trk.cheb_step(W, V, T0, c, h, renorm=renorm)
    assert trk.cheb_step.launches == n0 + 1
    ref, rs = trk.cheb_step_plain(W, V, T0, c, h, renorm=renorm)
    assert _rel(ref, y) <= 1e-5
    if renorm:
        assert _rel(rs, s) <= 1e-5


@pytest.mark.parametrize("C,shape", [(3, (700, 2, 3, 13)),
                                     (1, (5000, 1, 1, 22))])
def test_cheb_step_sequence(dev, C, shape):
    """T1 = T(T0), then 17 recurrence steps with the deferred renorm (two
    renorms, the last step right after one) on the card == the same
    steps through the twin on the CPU, for a fixed linear W(V) = A * V."""
    g = torch.Generator(device=dev).manual_seed(5 + C)
    A, T0 = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    A = A + 3.0
    Bd = shape[1]
    c = torch.linspace(0.5, 1.0, Bd, device=dev)
    h = torch.linspace(4.0, 5.0, Bd, device=dev)

    def run(d):
        a = A.to(d)
        T = T0.to(d)
        cd, hd = c.to(d), h.to(d)
        T1, _ = trk.cheb_step(a * T, T, None, cd, hd)
        return tk._sweep_iterate(lambda V: a * V, cd, hd, T, T1, 17, 8)

    n0 = trk.cheb_step.launches
    y = run(dev)
    assert trk.cheb_step.launches == n0 + 18
    assert _rel(run("cpu"), y) <= 1e-5


# ---------------------------------------------------------------------------
# the scalar path's kernels: K5 (stacked apply), K6 (permittivity), K7
# (scalar blocks), K8 (spectrum bound)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scalar_setup(setup, dev):
    """The scalar pencil (PML on) and the (E, 18, 18) vectorial blocks on
    the small 3-core mesh."""
    ga = setup["ga"]
    g = MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    ea = ta.eps_arrays(g.eps_params(), dev)
    A, Bm, diag, bound = ta.assemble_scalar_system(ga, ea, g.k0)
    prim, _, _ = ta.assemble_vector3_system(ga, ea)
    A3 = ta.vector3_stacked_A(prim, np.float32(g.k0 * 1.45), np.float32(1.0))
    return dict(g=g, ea=ea, A=A, B=Bm, diag=diag, bound=bound, A3=A3,
                M3=prim["u_nn"])


def _check_stacked(gs, Abig, mask, X, C):
    """K5 against its twin: within 1e-5 of max|y|, one launch, and the
    same bits from a second launch."""
    park = torch.linspace(1.0, 50.0, X.shape[1], device=X.device)
    n0 = ck.apply_stacked.launches
    y = ck.apply_stacked(X, gs, Abig, mask, park, C)
    assert ck.apply_stacked.launches == n0 + 1
    assert y.shape == X.shape
    assert _rel(ck.apply_stacked_plain(X, gs, Abig, mask, park, C), y) <= 1e-5
    assert torch.equal(y, ck.apply_stacked(X, gs, Abig, mask, park, C))


@pytest.mark.parametrize("rows", [ta.APPLY_ROWS, ta.APPLY_ROWS // 2])
@pytest.mark.parametrize("C,k", [(1, 1), (1, 7), (1, 22), (1, 27), (1, 300),
                                 (3, 7), (3, 22), (3, 27), (3, 60)])
def test_apply_stacked(setup, scalar_setup, dev, C, k, rows):
    """K5, the whole stacked apply, at C = 1 on the scalar pencil's
    blocks (valid-DOF mask) and at C = 3 on the (E, 18, 18) vectorial
    blocks (interior mask): rows written whole by one lane chunk up to
    k = 48 / C, lane chunks above; on the grid's plan and on one of half
    its rows per block (256 threads); and through ``_apply_stacked``
    against the CPU twin."""
    ga, gs = setup["ga"], setup["gs"]
    if rows != gs.apply_plan.rows:
        gs = gs._replace(apply_plan=ta._apply_plan(ga, rows))
    D = ga.dof_valid.shape[0]
    Abig = scalar_setup["A"] if C == 1 else scalar_setup["A3"]
    mask = ga.dof_valid if C == 1 else ga.interior_mask
    X = torch.randn((C * D, k), generator=setup["gen"], device=dev)
    _check_stacked(gs, Abig, mask, X, C)
    y = tk._apply_stacked(Abig, gs, mask, 50.0, X, C)
    ga_c = ta.GridArrays(*(t.cpu() for t in ga))
    ref = tk._apply_stacked(Abig.cpu(), ta.gather_scatter(ga_c),
                            mask.cpu(), 50.0, X.cpu(), C)
    assert _rel(ref, y) <= 1e-5


def test_apply_stacked_matches_fused_apply(setup, scalar_setup, dev):
    """K5 on the assembled (E, 18, 18) blocks == K1, the matrix-free
    A(beta) apply, on the same block (B = 1)."""
    ga, gs = setup["ga"], setup["gs"]
    g = scalar_setup["g"]
    D = ga.dof_valid.shape[0]
    qf, _ = ta.assemble_vector3_qf(ga, scalar_setup["ea"])
    qs = tk.QFactorSweep(invJT=qf.invJT, w=qf.w, inv_eps=qf.inv_eps[None],
                         gp=ga.grad_phys)
    X = torch.randn((3 * D, 1, K), generator=setup["gen"], device=dev)
    y = tk._apply_stacked(scalar_setup["A3"], gs, ga.interior_mask, 50.0,
                          X[:, 0].contiguous(), 3)
    ref = tk._stacked_from_fused(tk._apply_vector3_fused(
        qs, gs, ga.interior_mask, torch.tensor([50.0], device=dev),
        torch.tensor([g.k0 * 1.45], dtype=torch.float32, device=dev), 1.0,
        tk._fused_from_stacked(X)))[:, 0]
    assert _rel(ref, y) <= 1e-5


@pytest.mark.parametrize("pml", [True, False])
def test_eps_at_quadrature(setup, dev, pml):
    ga = setup["ga"]
    g = MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55,
                    use_complex_pml=pml)
    ea = ta.eps_arrays(g.eps_params(), dev)
    n0 = trk.eps_at_quadrature.launches
    re, im = trk.eps_at_quadrature(ga.qp_xy, ea)
    assert trk.eps_at_quadrature.launches == n0 + 1
    rre, rim = trk.eps_at_quadrature_plain(ga.qp_xy, ea)
    assert torch.equal(re, rre)
    assert float((im - rim).abs().max()) <= 1e-6 * max(1.0, float(rim.max()))
    assert bool(im.max() > 0) == pml
    # the CPU twin decides every point the same way
    ga_c = ta.GridArrays(*(t.cpu() for t in ga))
    cre, _ = trk.eps_at_quadrature(ga_c.qp_xy,
                                   ta.eps_arrays(g.eps_params(), "cpu"))
    assert torch.equal(re.cpu(), cre)


def test_scalar_blocks(setup, scalar_setup, dev):
    ga, g = setup["ga"], scalar_setup["g"]
    eps_re, _ = ta.eps_at_quadrature(ga, scalar_setup["ea"])
    k2 = float(np.float32(g.k0) ** 2)
    n0 = ck.scalar_blocks.launches
    A, Bm = ck.scalar_blocks(ga.grad_phys, ga.qp_w, ga.shape_vals, eps_re, k2)
    assert ck.scalar_blocks.launches == n0 + 1
    rA, rB = ck.scalar_blocks_plain(ga.grad_phys, ga.qp_w, ga.shape_vals,
                                    eps_re, k2)
    assert _rel(rA, A) <= 1e-5 and _rel(rB, Bm) <= 1e-5
    assert torch.equal(A, ck.scalar_blocks(ga.grad_phys, ga.qp_w,
                                           ga.shape_vals, eps_re, k2)[0])


@pytest.mark.parametrize("C", [1, 3])
def test_pencil_bounds(setup, scalar_setup, dev, C):
    """K8 against its twin (1e-5 relative) and against the same bound in
    f64 (a bound must not fall below it: 1e-4 relative slack for f32)."""
    ga = setup["ga"]
    Abig = scalar_setup["A"] if C == 1 else scalar_setup["A3"]
    Bm = scalar_setup["B"] if C == 1 else scalar_setup["M3"]
    Linv = torch.as_tensor(tk._LINV_REF, dtype=torch.float32, device=dev)
    tr = float(np.trace(tk._B_REF))
    n0 = ck.pencil_bounds.launches
    b = ck.pencil_bounds(Abig, Bm, ga.elem_valid, Linv, tr, C)
    assert ck.pencil_bounds.launches == n0 + 1
    assert b.shape == () and b.device.type == "cuda"
    ref = ck.pencil_bounds_plain(Abig, Bm, ga.elem_valid, Linv, tr, C)
    assert abs(float(b) - float(ref)) <= 1e-5 * float(ref)
    ref64 = ck.pencil_bounds_plain(Abig.double(), Bm.double(), ga.elem_valid,
                                   Linv.double(), tr, C)
    assert float(b) >= float(ref64) * (1.0 - 1e-4)
    assert float(tk.pencil_bounds_elem(Abig, Bm, ga.elem_valid, C=C)[2]) \
        == float(b)


def _k11_args(ga, g, dev):
    Linv = torch.as_tensor(tk._LINV_REF, dtype=torch.float32, device=dev)
    k0 = np.float32(g.k0)
    return (ga.grad_phys, ga.qp_w, ga.qp_xy, ga.shape_vals,
            ta.eps_arrays(g.eps_params(), dev), float(k0 * k0),
            ga.elem_valid, Linv, tk._TRACE_REF)


@pytest.mark.parametrize("case", ["pml", "no_pml", "r5"])
def test_scalar_pencil(request, setup, dev, case):
    """K11 against its twin on the small 3-core mesh (PML on and off) and
    on the r5 mesh (7 cores): eps_re equal at every point, A and B within
    1e-5 of their own scales, the diagonal terms B's own, the bound within
    1e-5 relative and no further under the f64 twin than 1e-4; one
    launch a call, bitwise repeatable, and the bound K8's on K11's own
    blocks, bit for bit."""
    if case == "r5":
        ga = request.getfixturevalue("r5")["ga"]
        g = MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    else:
        ga = setup["ga"]
        g = MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55,
                        use_complex_pml=case == "pml")
    args = _k11_args(ga, g, dev)
    n0 = ck.scalar_pencil.launches
    A, Bm, diag, bound, eps_re = ck.scalar_pencil(*args, return_eps=True)
    assert ck.scalar_pencil.launches == n0 + 1
    rA, rB, rdiag, rbound, reps = ck.scalar_pencil_plain(*args,
                                                         return_eps=True)
    assert torch.equal(eps_re, reps)
    assert bool((eps_re == args[4].eps_core).any())     # core points
    assert _rel(rA, A) <= 1e-5 and _rel(rB, Bm) <= 1e-5
    assert torch.equal(diag, torch.diagonal(Bm, dim1=1, dim2=2))
    assert _rel(rdiag, diag) <= 1e-5
    assert bound.shape == () and bound.device.type == "cuda"
    assert abs(float(bound) - float(rbound)) <= 1e-5 * float(rbound)
    ref64 = ck.pencil_bounds_plain(rA.double(), rB.double(), ga.elem_valid,
                                   args[7].double(), args[8], 1)
    assert float(bound) >= float(ref64) * (1.0 - 1e-4)
    again = ck.scalar_pencil(*args)
    for x, y in zip((A, Bm, diag, bound), again):
        assert torch.equal(x, y)
    assert torch.equal(bound, ck.pencil_bounds(A, Bm, ga.elem_valid,
                                               args[7], args[8], 1))


def test_scalar_wrappers_refuse_bad_input(setup, scalar_setup, dev):
    ga, gs = setup["ga"], setup["gs"]
    D = ga.dof_valid.shape[0]
    X = torch.zeros((D, 4), device=dev)
    park = torch.ones(4, device=dev)
    with pytest.raises(TypeError):
        ck.apply_stacked(X.double(), gs, scalar_setup["A"], ga.dof_valid,
                         park, 1)
    with pytest.raises(ValueError):             # C = 2 has no kernel
        ck.apply_stacked(X, gs, scalar_setup["A"], ga.dof_valid, park, 2)
    with pytest.raises(ValueError):             # (E, 18, 18) given as C = 1
        ck.apply_stacked(X, gs, scalar_setup["A3"], ga.dof_valid, park, 1)
    with pytest.raises(ValueError):             # park is one per column
        ck.apply_stacked(X, gs, scalar_setup["A"], ga.dof_valid,
                         torch.ones(5, device=dev), 1)
    with pytest.raises(ValueError):             # X (D, k) given as C = 3
        ck.apply_stacked(X, gs, scalar_setup["A3"], ga.interior_mask,
                         park, 3)
    with pytest.raises(ValueError):             # a plan of another grid
        ck.apply_stacked(X, gs._replace(apply_plan=gs.apply_plan._replace(
            n_elems=gs.apply_plan.n_elems[:-1].contiguous())),
            scalar_setup["A"], ga.dof_valid, park, 1)
    with pytest.raises(ValueError):
        ck.pencil_bounds(scalar_setup["A"], scalar_setup["B"],
                         ga.elem_valid[:-1].contiguous(),
                         torch.eye(6, device=dev), 1.0, 1)
    with pytest.raises(ValueError):             # f64 permittivity scalars
        trk.eps_at_quadrature(ga.qp_xy, ta.eps_arrays(
            scalar_setup["g"].eps_params(), dev, torch.float64))
    k11 = _k11_args(ga, scalar_setup["g"], dev)
    with pytest.raises(TypeError):              # f64 permittivity
        ck.scalar_pencil(*k11[:4], ta.eps_arrays(
            scalar_setup["g"].eps_params(), dev, torch.float64), *k11[5:])
    with pytest.raises(ValueError):             # flags of another grid
        ck.scalar_pencil(*k11[:6], ga.elem_valid[:-1].contiguous(),
                         *k11[7:])
    with pytest.raises(ValueError):             # points on the host
        ck.scalar_pencil(*k11[:2], ga.qp_xy.cpu(), *k11[3:])
    with pytest.raises(ValueError):             # points not (E, Q, 2)
        ck.scalar_pencil(*k11[:2], ga.qp_xy[:, :, :1].contiguous(),
                         *k11[3:])
    E = ga.qp_w.shape[0]                        # Q = 17: more than it takes
    with pytest.raises(RuntimeError):
        ck.scalar_pencil(torch.zeros((E, 17, 6, 2), device=dev),
                         torch.zeros((E, 17), device=dev),
                         torch.zeros((E, 17, 2), device=dev),
                         torch.zeros((17, 6), device=dev), *k11[4:])


def test_scalar_solve_on_card_matches_cpu(dev):
    """ScalarHelmholtzSolver.solve on the card (K2-K5, K10-K12) against
    the same solve through the twins on the CPU from the same start
    block: n_eff within 1e-6 after the host polish; every kernel of the
    path launches, K5 once per A apply, K12 once per filter step, K3
    once per pass, K11 once and the standalone K6, K7 and K8 not at
    all."""
    from pl_fem_tpu_torch.config import SolverConfig
    from pl_fem_tpu_torch.solvers import ScalarHelmholtzSolver

    geom = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55,
                       use_complex_pml=False)
    mesh = dict(mesh_min_points=600, mesh_target_points=2500,
                mesh=MeshConfig(bucket_rounding=256))
    dg = export_device_grid(MeshGenerator.generate(
        geom, 0.4, SimulationConfig(**mesh)), 256)
    skw = dict(cheb_degree=150, cheb_passes=2)
    k = 8 + SolverConfig().extra_vectors
    X0 = np.random.default_rng(42).standard_normal(
        (dg.n_dofs_padded, k)).astype(np.float32)
    wrappers = (ck.accumulate, ck.mass_apply, trk.cheb_step,
                ck.apply_stacked, ck.ritz_residual, ck.binv_chain)
    standalone = (trk.eps_at_quadrature, ck.scalar_blocks, ck.pencil_bounds)
    before = [f.launches for f in wrappers]
    before_sa = [f.launches for f in standalone]
    n11 = ck.scalar_pencil.launches
    on_card = ScalarHelmholtzSolver(geom, SimulationConfig(
        **mesh, solver=SolverConfig(device="cuda", **skw))).solve(dg, 8,
                                                                  X0=X0)
    assert all(f.launches > n for f, n in zip(wrappers, before))
    assert ck.scalar_pencil.launches == n11 + 1
    assert [f.launches for f in standalone] == before_sa
    # K5 once per A apply: per K4 step, and per pass (degree steps each)
    # in its Rayleigh-Ritz
    n4 = trk.cheb_step.launches - before[2]
    n5 = ck.apply_stacked.launches - before[3]
    assert n4 % skw["cheb_degree"] == 0
    assert n5 == n4 + n4 // skw["cheb_degree"]
    # B^{-1} once per filter step, all its degree steps in one K12 launch
    # (R and Z on chip at this size); K3 only in the Rayleigh-Ritz
    assert ck.binv_chain.launches - before[5] == n4
    assert ck.mass_apply.launches - before[1] == n4 // skw["cheb_degree"]
    on_cpu = ScalarHelmholtzSolver(geom, SimulationConfig(
        **mesh, solver=SolverConfig(device="cpu", **skw))).solve(dg, 8,
                                                                 X0=X0)
    assert len(on_card) >= 8 and len(on_cpu) >= 8
    for a, b in zip(on_card[:8], on_cpu[:8]):
        assert abs(a["n_eff"] - b["n_eff"]) <= 1e-6 * b["n_eff"]


def test_spans_leave_no_device_event(dev):
    """A scalar solve under ``torch.profiler`` with CUDA activity: the
    program's spans are host events (the phases, one pl_fem.rr_pass a
    pass), none a user annotation, and no device-side event carries a
    pl_fem. name; the kernels are there."""
    from torch.profiler import ProfilerActivity, profile

    from pl_fem_tpu_torch.config import SolverConfig
    from pl_fem_tpu_torch.solvers import ScalarHelmholtzSolver

    geom = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55,
                       use_complex_pml=False)
    mesh = dict(mesh_min_points=600, mesh_target_points=2500,
                mesh=MeshConfig(bucket_rounding=256))
    dg = export_device_grid(MeshGenerator.generate(
        geom, 0.4, SimulationConfig(**mesh)), 256)
    solver = ScalarHelmholtzSolver(geom, SimulationConfig(
        **mesh, solver=SolverConfig(device="cuda", cheb_degree=60,
                                    cheb_passes=2)))
    solver.solve(dg, 8, mode_filter="cascade")            # builds, warms
    n3 = ck.mass_apply.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.solve(dg, 8, mode_filter="cascade")
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in prof.events() if e.device_type != cuda
            and e.name.startswith("pl_fem.")]
    device = [e.name for e in prof.events() if e.device_type == cuda]
    names = [e.name[len("pl_fem."):] for e in host]
    assert sorted(set(names) - {"rr_pass"}) == sorted(
        solver.last_solve_times)
    assert names.count("rr_pass") >= 2
    assert not any(e.is_user_annotation for e in host)
    assert sum("mass_apply" in n for n in device) == \
        ck.mass_apply.launches - n3
    assert not [n for n in device if n.startswith("pl_fem.")]


def test_filter_on_card_matches_cpu(setup, dev):
    """Twelve filter steps through K1, K3 and K4 (no K2: the fused apply
    sums its own rows) == the same steps through the twins on the CPU
    (1e-4: rounding amplified by the Chebyshev growth between renorms)."""
    s = setup
    ga, gs, qs = s["ga"], s["gs"], s["qs"]
    D = ga.interior_mask.shape[0]
    _, diag = ta.assemble_vector3_qf(
        ga, ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                          .eps_params(), dev))
    dinv = 1.0 / torch.sqrt(diag)
    lo, hi = np.float32(tk.MASS_LO), np.float32(tk.MASS_HI)
    vec = {"parks": [400.0] * B, "cuts": [40.0] * B, "bounds": [4e3] * B}
    X = s["X"].reshape(D, B, 3, K)

    def run(d, mv):
        t = {n: torch.tensor(v, device=d) for n, v in mv.items()}
        cast = lambda a: a.to(d)                               # noqa: E731
        ga_d = ta.GridArrays(*map(cast, ga))
        return tk.cheb_sweep_filter(
            tk.QFactorSweep(*map(cast, qs)),
            ta.gather_scatter(ga_d), ga_d.interior_mask,
            cast(dinv), lo, hi, t["parks"], cast(s["betas"]), 1.0,
            cast(X), t["cuts"], t["bounds"], degree=12, binv_degree=1)

    kernels = (ck.apply_vector3, ck.mass_apply, trk.cheb_step)
    counts = [f.launches for f in kernels]
    n_acc = ck.accumulate.launches
    y = run(dev, vec)
    assert all(f.launches > n for f, n in zip(kernels, counts))
    assert ck.accumulate.launches == n_acc        # K1 sums its own rows
    assert _rel(run("cpu", vec), y) <= 1e-4


def test_wrappers_refuse_bad_input(setup, dev):
    """A CUDA tensor never reaches a twin: input the kernel does not
    take raises."""
    s = setup
    gs, w, mask = s["gs"], s["qs"].w, s["ga"].interior_mask
    N = tk.shape_table(dev)
    D = mask.shape[0]
    X = torch.zeros((D, 12), device=dev)
    with pytest.raises(TypeError):
        ck.mass_apply(X.double(), gs, w, N, mask)
    with pytest.raises(ValueError):
        ck.mass_apply(torch.zeros((12, D), device=dev).t(), gs, w, N, mask)
    with pytest.raises(ValueError):             # not on a 16-byte boundary
        ck.mass_apply(torch.zeros((D * 12 + 1,), device=dev)[1:]
                      .view(D, 12), gs, w, N, mask)
    with pytest.raises(ValueError):             # wrong mask length
        ck.mass_apply(X, gs, w, N, mask[:-1].contiguous())
    with pytest.raises(ValueError):             # a middle step needs R, Z
        ck.mass_apply(X, gs, w, N, mask, step=ck.BinvStep(
            torch.ones(D, device=dev), None, None, 1.0, 1.0, 1.0, True,
            False))
    with pytest.raises(TypeError):
        ck.accumulate(torch.zeros((2, 6, 3), device=dev, dtype=torch.float64),
                      gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    qs, betas = s["qs"], s["betas"]
    parks = torch.ones(B, device=dev)
    apply_args = (gs, qs.gp, qs.w, qs.inv_eps, betas, 1.0, N, mask)
    Xa = torch.zeros((D, B * 3 * K), device=dev)
    with pytest.raises(TypeError):
        ck.apply_vector3(Xa.double(), *apply_args, parks)
    with pytest.raises(ValueError):             # not B * 3 * k lanes
        ck.apply_vector3(Xa[:, :-1].contiguous(), *apply_args, parks)
    with pytest.raises(ValueError):             # parks per lane, not design
        ck.apply_vector3(Xa, *apply_args, torch.ones(B * 3 * K, device=dev))
    with pytest.raises(ValueError):             # a plan for another grid
        ck.apply_vector3(Xa[:-1].contiguous(), *apply_args[:-1],
                         mask[:-1].contiguous(), parks)
    gp_off = torch.cat([qs.gp.new_zeros(1), qs.gp.reshape(-1)])[1:]
    with pytest.raises(ValueError):             # gradients not on 16 bytes
        ck.apply_vector3(Xa, gs, gp_off.view(qs.gp.shape), *apply_args[2:],
                         parks)


def test_wrappers_take_scalar_operands_at_any_offset(setup, dev):
    """Only the lane blocks that K2 and K3 load as vectors (and K1's
    gradients, loaded as float4) must start on 4 * gcd(L, 4) (16) bytes:
    a mask, K1's other operands or an L = 1 block that starts 4 bytes
    into its storage runs and matches the twins."""
    s = setup
    gs, ga, qs = s["gs"], s["ga"], s["qs"]
    E = gs.elem_dofs.shape[0]
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)

    def offset(t):
        return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)

    mask = offset(ga.interior_mask)
    assert mask.data_ptr() % 16
    X = s["X"]
    L = X.shape[1]
    park = torch.full((L,), 3.0, device=dev)
    Ye = torch.randn((E, 6, L), generator=s["gen"], device=dev)
    y = ck.accumulate(Ye, *tables, X, mask, park)
    assert _rel(ck.accumulate_plain(Ye, *tables, X, mask, park), y) <= 1e-5
    Y1 = offset(torch.randn((E, 6, 1), generator=s["gen"], device=dev))
    assert _rel(ck.accumulate_plain(Y1, *tables), ck.accumulate(Y1, *tables)
                ) <= 1e-5
    N = tk.shape_table(dev)
    y = tk._apply_mass_fused(qs, gs, mask, X, 50.0)
    assert _rel(tk._apply_mass_fused_plain(qs, gs, mask, X, 50.0), y) <= 1e-5
    _check_apply(qs._replace(w=offset(qs.w), inv_eps=offset(qs.inv_eps)),
                 gs, mask, offset(s["betas"]), offset(X),
                 offset(torch.full((B,), 3.0, device=dev)))


# ---------------------------------------------------------------------------
# the dataset engine's shapes: r5 production mesh, B = 1 or 5 designs per
# bucket, k = 20 (3-core) or 66 (19-core) columns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r5(dev):
    """A bucket mesh at configs/r5_dataset.yaml's settings (9000-18000
    points, bucket_rounding 4096) and five designs on it."""
    cfg = SimulationConfig(mesh_min_points=9000, mesh_target_points=18000)
    geoms = [MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.53, 1.61, 5)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 1.0, cfg),
                            cfg.mesh.bucket_rounding)
    ga = ta.grid_to_device(dg, dev)
    invs = [ta.assemble_vector3_qf(ga, ta.eps_arrays(g.eps_params(), dev))[0]
            for g in geoms]
    _, diag = ta.assemble_vector3_qf(ga, ta.eps_arrays(geoms[0].eps_params(),
                                                       dev))
    return dict(ga=ga, gs=ta.gather_scatter(ga), invs=invs, diag=diag,
                betas=[g.k0 * 1.49 for g in geoms])


@pytest.fixture(scope="module")
def config1(dev):
    """The config-1 production mesh (7-core hex, 15000 points, refinement
    2.2, bucket_rounding 1024; ~60k DOFs) and its mass diagonal."""
    cfg = SimulationConfig(mesh_min_points=15000, mesh_target_points=15000,
                           mesh=MeshConfig(bucket_rounding=1024))
    geom = MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    dg = export_device_grid(MeshGenerator.generate(geom, 2.2, cfg), 1024)
    ga = ta.grid_to_device(dg, dev)
    qf, diag = ta.assemble_vector3_qf(ga, ta.eps_arrays(geom.eps_params(),
                                                        dev))
    return dict(ga=ga, gs=ta.gather_scatter(ga), qf=qf, diag=diag)


@pytest.mark.parametrize("mesh", ["r5", "config1"])
@pytest.mark.parametrize("b,k", [(1, 20), (1, 66), (5, 20), (5, 66)])
def test_mass_apply_at_main_path_shapes(request, dev, mesh, b, k):
    """K3 in both modes on the dataset engine's r5 mesh and on the
    config-1 mesh, at the engine's (B, k)."""
    m = request.getfixturevalue(mesh)
    ga, gs = m["ga"], m["gs"]
    w = m["invs"][0].w if mesh == "r5" else m["qf"].w
    qs = tk.QFactorSweep(invJT=None, w=w, inv_eps=None, gp=None)
    D = ga.interior_mask.shape[0]
    g = torch.Generator(device=dev).manual_seed(b * 1000 + k)
    X = torch.randn((D, b * 3 * k), generator=g, device=dev)
    _check_mass(ga, gs, qs, X, 1.0 / torch.sqrt(m["diag"]))


@pytest.mark.parametrize("b,k", [(1, 20), (1, 66), (5, 20), (5, 66)])
def test_kernels_at_dataset_shapes(r5, dev, b, k):
    """K1, K2 and K4 against their twins at the shapes the dataset engine
    gives them (1e-5 of max|y|; K3 in test_mass_apply_at_main_path_shapes);
    K1 one launch and bitwise repeatable."""
    ga, gs, invs = r5["ga"], r5["gs"], r5["invs"][:b]
    qs = tk.QFactorSweep(invJT=invs[0].invJT, w=invs[0].w,
                         inv_eps=torch.stack([q.inv_eps for q in invs]),
                         gp=ga.grad_phys)
    betas = torch.tensor(r5["betas"][:b], device=dev)
    D = ga.interior_mask.shape[0]
    E = gs.elem_dofs.shape[0]
    L = b * 3 * k
    g = torch.Generator(device=dev).manual_seed(b * 100 + k)
    X = torch.randn((D, L), generator=g, device=dev)
    _check_apply(qs, gs, ga.interior_mask, betas, X,
                 torch.full((b,), 50.0, device=dev))
    Ye = torch.randn((E, 6, L), generator=g, device=dev)
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    park = torch.full((L,), 50.0, device=dev)
    extra = (X, ga.interior_mask, park)
    assert _rel(ck.accumulate_plain(Ye, *tables, *extra),
                ck.accumulate(Ye, *tables, *extra)) <= 1e-5
    W, T1, T0 = (torch.randn((D, b, 3, k), generator=g, device=dev)
                 for _ in range(3))
    c = torch.linspace(100.0, 120.0, b, device=dev)
    h = torch.linspace(900.0, 1000.0, b, device=dev)
    sv = torch.rand((b, k), generator=g, device=dev) + 0.5
    for kw in ({"renorm": False}, {"renorm": True},
               {"scale": sv, "scale_t0": sv}, {"scale_t0": sv}):
        y, s = trk.cheb_step(W, T1, T0, c, h, **kw)
        ref, rs = trk.cheb_step_plain(W, T1, T0, c, h, **kw)
        assert _rel(ref, y) <= 1e-5
        if s is not None:
            assert _rel(rs, s) <= 1e-5
    torch.cuda.synchronize()


def test_library_built_once_by_two_threads(setup, dev, monkeypatch):
    """Two threads calling lib() at once on a machine with no library
    yet: nvcc runs once, both threads get the same handle, and it
    launches."""
    builds = []
    real_build = ck.build

    def counting_build(verbose=False):
        builds.append(1)
        return real_build(verbose)

    lib_path = ck.BUILD_DIR / ck._LIB_NAME
    if lib_path.exists():
        lib_path.unlink()
    monkeypatch.setattr(ck, "_LIB", None)
    monkeypatch.setattr(ck, "build", counting_build)
    got = []
    start = threading.Barrier(2)

    def worker():
        start.wait(60)
        got.append(ck.lib())

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert builds == [1] and len(got) == 2 and got[0] is got[1]
    s = setup
    args = (s["gs"], s["qs"].w, tk.shape_table(dev), s["ga"].interior_mask)
    assert _rel(ck.mass_apply_plain(s["X"], *args),
                ck.mass_apply(s["X"], *args)) <= 1e-5


def test_triton_first_launch_from_two_threads(dev, monkeypatch):
    """K4's first launch (its Triton compile) from two threads at once:
    both results equal the twin's."""
    monkeypatch.setattr(trk, "_KERNELS", {})
    g = torch.Generator(device=dev).manual_seed(9)
    W, V, T0 = (torch.randn((500, 2, 3, 13), generator=g, device=dev)
                for _ in range(3))
    c = torch.tensor([1.0, 2.0], device=dev)
    h = torch.tensor([4.0, 5.0], device=dev)
    ref, rs = trk.cheb_step_plain(W, V, T0, c, h, renorm=True)
    out = [None, None]
    start = threading.Barrier(2)

    def worker(i):
        start.wait(60)
        out[i] = trk.cheb_step(W, V, T0, c, h, renorm=True)
        torch.cuda.synchronize()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert all(_rel(ref, y) <= 1e-5 and _rel(rs, s) <= 1e-5
               for y, s in out)


def test_row_owned_kernels_from_two_threads(setup, scalar_setup, dev):
    """K1, K3 and K5 launched by two threads at once, 2000 times each, on
    plans that ask one kernel instance for different dynamic shared
    memory: the 128- and the 32-row apply plans (both take 256 threads),
    and the mass plan beside one with 256 padding slots more per halo.
    A spin kernel before each round keeps the stream full, so launches
    wait inside the driver. No launch fails, and every result equals,
    bit for bit, the one a single thread got on the same plan.

    A launcher that sets the limit to each launch's own size races
    here: one thread can lower it between the other's set and launch,
    which then fails. The race does not show every time (on an H100 a
    copy with such launchers failed this test in two runs of three), so
    test_launchers_set_one_shared_limit in test_torch_host.py also holds
    the sources to the fix."""
    s, ss = setup, scalar_setup
    ga, gs, qs = s["ga"], s["gs"], s["qs"]
    pl = gs.plan
    pad = torch.full((pl.halo.shape[0], 256), -1, dtype=torch.int32,
                     device=dev)
    padded = pl._replace(halo=torch.cat([pl.halo, pad], 1).contiguous())
    gss = [gs._replace(apply_plan=ta._apply_plan(ga, 128)),
           gs._replace(apply_plan=ta._apply_plan(ga, 32), plan=padded)]
    sizes = [ta.apply_shared_bytes(p.rows, p.elems.shape[1], p.max_entries)
             for p in (g.apply_plan for g in gss)]
    assert sizes[0] > 2 * sizes[1]
    N = tk.shape_table(dev)
    D = ga.dof_valid.shape[0]
    X1 = torch.randn((D, 22), generator=s["gen"], device=dev)
    park = torch.linspace(1.0, 50.0, 22, device=dev)
    parks = torch.linspace(10.0, 50.0, B, device=dev)

    def launch_all(g):
        return (ck.apply_vector3(s["X"], g, qs.gp, qs.w, qs.inv_eps,
                                 s["betas"], 1.0, N, ga.interior_mask,
                                 parks),
                ck.mass_apply(s["X"], g, qs.w, N, ga.interior_mask),
                ck.apply_stacked(X1, g, ss["A"], ga.dof_valid, park, 1))

    refs = [launch_all(g) for g in gss]
    assert torch.equal(refs[0][1], refs[1][1])
    differ = [torch.zeros((), dtype=torch.int64, device=dev)
              for _ in range(2)]
    rounds = [0, 0]
    errors = []
    start = threading.Barrier(2)

    def worker(i):
        try:
            start.wait(60)
            for _ in range(2000):
                torch.cuda._sleep(200000)
                for y, r in zip(launch_all(gss[i]), refs[i]):
                    differ[i] += (y != r).sum()
                rounds[i] += 1
            torch.cuda.synchronize()
        except Exception as exc:      # reported below, with its thread
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert rounds == [2000, 2000]
    assert [int(d) for d in differ] == [0, 0]


# ---------------------------------------------------------------------------
# K12: the B^{-1} semi-iteration's step chain in one cooperative launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,L,degree,on_chip", [
    ("config1", 22, 8, True),        # the scalar filter's chain
    ("config1", 22, 2, True),
    ("config1", 528, 4, False),      # the config-1 sweep, B = 8, k = 22
    ("r5", 27, 8, False),            # the r5 scalar mesh at k = 27
    ("r5", 630, 4, False),           # the r5 sweep, B = 5, k = 42
    ("setup", 63, 4, True),          # the small mesh, odd lanes
    ("setup", 60, 4, True),          # a chunk of 15 summing threads a row
    ("setup", 64, 3, True),
])
def test_binv_chain(request, dev, mesh, L, degree, on_chip):
    """K12 against the K3 step chain on the card, bit for bit, where R
    and Z stay on chip and where they live in device memory (as
    ``binv_on_chip`` decides, counted in ``binv_chain.on_chip``): one
    launch, no K3 launch, bitwise repeatable, the input left as it was,
    and within 1e-5 of max|y| of the unfused plain twin."""
    m = request.getfixturevalue(mesh)
    ga, gs = m["ga"], m["gs"]
    w = {"r5": lambda: m["invs"][0].w, "config1": lambda: m["qf"].w,
         "setup": lambda: m["qs"].w}[mesh]()
    diag = m["diag"] if mesh != "setup" else None
    dinv = 1.0 / torch.sqrt(diag) if diag is not None else _dinv(ga, dev)
    mask = ga.interior_mask
    D = mask.shape[0]
    N = tk.shape_table(dev)
    g = torch.Generator(device=dev).manual_seed(L * 10 + degree)
    X = torch.randn((D, L), generator=g, device=dev)
    X0 = X.clone()
    lo, hi = np.float32(tk.MASS_LO), np.float32(tk.MASS_HI)
    theta, a, b = tk._binv_coefs(lo, hi, degree)
    n_sm, shared = ck._card_limits(dev.index or 0, gs.plan.halo.shape[1],
                                   int(gs.plan.max_entries), L)
    assert ck.binv_on_chip(D, L, n_sm, shared) is on_chip
    n3, n12, nc = (ck.mass_apply.launches, ck.binv_chain.launches,
                   ck.binv_chain.on_chip)
    y = ck.binv_chain(X, gs, w, N, mask, dinv, a, b, theta, degree)
    assert (ck.mass_apply.launches, ck.binv_chain.launches,
            ck.binv_chain.on_chip) == (n3, n12 + 1, nc + on_chip)
    ref = _k3_chain(X, gs, w, N, mask, dinv, a, b, theta, degree)
    assert torch.equal(y, ref)
    assert torch.equal(y, ck.binv_chain(X, gs, w, N, mask, dinv, a, b,
                                        theta, degree))
    assert torch.equal(X, X0)
    qs = tk.QFactorSweep(invJT=None, w=w, inv_eps=None, gp=None)
    plain = tk._apply_binv_fused_plain(qs, gs, mask, dinv, lo, hi, X, degree)
    assert _rel(plain, y) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.parametrize("mesh", ["setup", "config1"])
def test_binv_on_chip_agrees_with_the_launcher(request, dev, mesh):
    """``binv_on_chip``, on what ``pl_binv_chain_limits`` reports, and
    the launcher's own layout search agree: at the most lanes the rule
    keeps on chip the launch finds a layout with R and Z in shared
    memory, one lane more goes to device memory, and both give the K3
    step chain's bits."""
    m = request.getfixturevalue(mesh)
    ga, gs = m["ga"], m["gs"]
    w = m["qs"].w if mesh == "setup" else m["qf"].w
    dinv = _dinv(ga, dev) if mesh == "setup" else 1.0 / torch.sqrt(m["diag"])
    mask = ga.interior_mask
    D = mask.shape[0]
    H, ent = gs.plan.halo.shape[1], int(gs.plan.max_entries)

    def on_chip(L):
        return ck.binv_on_chip(D, L, *ck._card_limits(dev.index or 0, H, ent,
                                                       L))

    top = max((L for L in range(1, 4097) if on_chip(L)), default=0)
    assert 22 <= top < 4096 and not on_chip(top + 1)
    N = tk.shape_table(dev)
    theta, a, b = tk._binv_coefs(np.float32(tk.MASS_LO),
                                 np.float32(tk.MASS_HI), 2)
    g = torch.Generator(device=dev).manual_seed(top)
    for L, kept in ((top, 1), (top + 1, 0)):
        X = torch.randn((D, L), generator=g, device=dev)
        nc = ck.binv_chain.on_chip
        y = ck.binv_chain(X, gs, w, N, mask, dinv, a, b, theta, 2)
        assert ck.binv_chain.on_chip == nc + kept
        assert torch.equal(y, _k3_chain(X, gs, w, N, mask, dinv, a, b,
                                        theta, 2))
    torch.cuda.synchronize()


def test_binv_chain_refuses_bad_input(setup, dev):
    """K12 takes f32 CUDA tensors on one device, contiguous, the lanes
    on their boundary, a plan and mask of X's rows, degree >= 2 with one
    (a, b) a step; anything else raises before a launch."""
    s = setup
    gs, w, mask = s["gs"], s["qs"].w, s["ga"].interior_mask
    N = tk.shape_table(dev)
    D = mask.shape[0]
    ds = _dinv(s["ga"], dev)
    X = torch.randn((D, 12), generator=s["gen"], device=dev)
    theta, a, b = tk._binv_coefs(np.float32(tk.MASS_LO),
                                 np.float32(tk.MASS_HI), 4)
    n12 = ck.binv_chain.launches

    def call(X=X, w=w, mask=mask, ds=ds, a=a, b=b, degree=4):
        return ck.binv_chain(X, gs, w, N, mask, ds, a, b, theta, degree)

    with pytest.raises(TypeError):
        call(X=X.double())
    with pytest.raises(ValueError):             # not contiguous
        call(X=torch.zeros((12, D), device=dev).t())
    with pytest.raises(ValueError):             # not on a 16-byte boundary
        call(X=torch.zeros((D * 12 + 1,), device=dev)[1:].view(D, 12))
    with pytest.raises(ValueError):             # a mask of other rows
        call(mask=mask[:-1].contiguous())
    with pytest.raises(ValueError):             # rows the plan does not own
        call(X=X[:-1].contiguous(), mask=mask[:-1].contiguous(),
             ds=ds[:-1].contiguous())
    with pytest.raises(ValueError):             # the scale on the host
        call(ds=ds.cpu())
    with pytest.raises(ValueError):             # weights on the host
        call(w=w.cpu())
    with pytest.raises(TypeError):
        call(ds=ds.double())
    with pytest.raises(ValueError):             # degree 1 is one K3 step
        call(a=a[:1], b=b[:1], degree=1)
    with pytest.raises(ValueError):             # one (a, b) a step
        call(b=b[:3])
    assert ck.binv_chain.launches == n12


def test_binv_chain_from_two_threads(setup, config1, dev):
    """K12 launched by two threads at once, 300 times each, one on the
    config-1 mesh (R and Z on chip) and one on the small mesh's plan
    with 256 padding slots more per halo (another shared-memory size and
    grid), each behind a spin kernel: no launch fails, and every result
    equals, bit for bit, the one a single thread got."""
    s, c1 = setup, config1
    lo, hi = np.float32(tk.MASS_LO), np.float32(tk.MASS_HI)
    theta, a, b = tk._binv_coefs(lo, hi, 8)
    N = tk.shape_table(dev)
    pl = s["gs"].plan
    pad = torch.full((pl.halo.shape[0], 256), -1, dtype=torch.int32,
                     device=dev)
    gs_pad = s["gs"]._replace(plan=pl._replace(
        halo=torch.cat([pl.halo, pad], 1).contiguous()))
    D1 = c1["ga"].interior_mask.shape[0]
    cases = [
        (torch.randn((D1, 22), generator=s["gen"], device=dev), c1["gs"],
         c1["qf"].w, c1["ga"].interior_mask, 1.0 / torch.sqrt(c1["diag"])),
        (s["X"], gs_pad, s["qs"].w, s["ga"].interior_mask,
         _dinv(s["ga"], dev)),
    ]

    def launch(i):
        X, gs, w, mask, ds = cases[i]
        return ck.binv_chain(X, gs, w, N, mask, ds, a, b, theta, 8)

    refs = [launch(i) for i in range(2)]
    assert torch.equal(refs[1], launch(1))
    differ = [torch.zeros((), dtype=torch.int64, device=dev)
              for _ in range(2)]
    rounds = [0, 0]
    errors = []
    start = threading.Barrier(2)

    def worker(i):
        try:
            start.wait(60)
            for _ in range(300):
                torch.cuda._sleep(200000)
                differ[i] += (launch(i) != refs[i]).sum()
                rounds[i] += 1
            torch.cuda.synchronize()
        except Exception as exc:      # reported below, with its thread
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert rounds == [300, 300]
    assert [int(d) for d in differ] == [0, 0]


# ---------------------------------------------------------------------------
# the vectorial sweep's assembly and bounds: the batched K6 (1/eps of every
# design) and K8 from the quadrature data of every design
# ---------------------------------------------------------------------------

def _sweep_geoms(B):
    """B designs on the small mesh: wavelengths 1.50-1.60 um, n_core
    alternating, PML on every other design, and every third design with
    2 cores (the batch pads its cores)."""
    return [MCFGeometry(2 if b % 3 == 2 else 3, 8.0, 1.5,
                        (1.535, 1.52)[b % 2], 1.0,
                        wavelength_um=1.50 + 0.1 * b / max(B - 1, 1),
                        use_complex_pml=b % 2 == 0) for b in range(B)]


@pytest.mark.parametrize("B", [1, 3, 8])
def test_inv_eps_at_quadrature(setup, dev, B):
    """The batched K6 == its twin bit for bit, in one launch, and equal
    to the CPU twin and to 1 / the single-design K6's eps_re."""
    ga = setup["ga"]
    geoms = _sweep_geoms(B)
    eas = [ta.eps_arrays(g.eps_params(), dev) for g in geoms]
    batch = ta.eps_batch(eas)
    n0 = trk.inv_eps_at_quadrature.launches
    y = trk.inv_eps_at_quadrature(ga.qp_xy, batch)
    assert trk.inv_eps_at_quadrature.launches == n0 + 1
    assert y.shape == (B,) + tuple(ga.qp_w.shape)
    assert torch.equal(y, trk.inv_eps_at_quadrature_plain(ga.qp_xy, batch))
    assert torch.equal(y, trk.inv_eps_at_quadrature(ga.qp_xy, batch))
    cpu = trk.inv_eps_at_quadrature(ga.qp_xy.cpu(), ta.EpsBatch(
        *(t.cpu() for t in batch)))
    assert torch.equal(y.cpu(), cpu)
    for b, ea in enumerate(eas):
        re, _ = trk.eps_at_quadrature(ga.qp_xy, ea)
        assert torch.equal(y[b], 1.0 / re), b


@pytest.mark.parametrize("B", [1, 5])
def test_pencil_bounds_vector3(setup, dev, B):
    """K8 from the quadrature data against its twin (1e-5 relative),
    against the f64 twin (not below it by more than 1e-4 relative, the
    f32 slack of test_pencil_bounds) and against K8 on each design's
    assembled (E, 18, 18) stack (1e-5); one launch, bitwise repeatable."""
    ga = setup["ga"]
    geoms = _sweep_geoms(B)
    qs, _ = ta.assemble_vector3_sweep(
        ga, setup["gs"], [ta.eps_arrays(g.eps_params(), dev) for g in geoms])
    betas = torch.tensor([g.k0 * 1.49 for g in geoms], device=dev)
    Linv = torch.as_tensor(tk._LINV_REF, dtype=torch.float32, device=dev)
    tr = float(np.trace(tk._B_REF))
    args = (qs.gp, qs.w, ga.shape_vals, qs.inv_eps, betas, 1.0,
            ga.elem_valid, Linv, tr)
    n0 = ck.pencil_bounds_vector3.launches
    b = ck.pencil_bounds_vector3(*args)
    assert ck.pencil_bounds_vector3.launches == n0 + 1
    assert b.shape == (B,) and b.device.type == "cuda"
    assert torch.equal(b, ck.pencil_bounds_vector3(*args))
    ref = tk.pencil_bounds_vector3_plain(*args)
    assert float(((b - ref).abs() / ref).max()) <= 1e-5
    ref64 = tk.pencil_bounds_vector3_plain(
        qs.gp.double(), qs.w.double(), ga.shape_vals.double(),
        qs.inv_eps.double(), betas.double(), 1.0, ga.elem_valid,
        Linv.double(), tr)
    assert bool((b.double() >= ref64 * (1.0 - 1e-4)).all())
    for i in range(B):
        prim = ta.quadrature_primitives(qs.gp, qs.w, ga.shape_vals,
                                        qs.inv_eps[i])
        A3 = ta.vector3_stacked_A(prim, np.float32(float(betas[i])),
                                  np.float32(1.0))
        old = ck.pencil_bounds(A3, prim["u_nn"], ga.elem_valid, Linv, tr, 3)
        assert abs(float(b[i]) - float(old)) <= 1e-5 * float(old), i
    assert torch.equal(tk.pencil_bounds_sweep(
        qs, ga.shape_vals, ga.elem_valid, betas.cpu().numpy(), 1.0), b)


def test_sweep_wrappers_refuse_bad_input(setup, dev):
    """The batched K6 and the sweep's K8 raise on what their kernels do
    not take: dtype, shape, device, betas of the wrong length; K8 also on
    CPU tensors, which ``kernels.pencil_bounds_sweep`` gives its twin."""
    ga = setup["ga"]
    geoms = _sweep_geoms(3)
    batch = ta.eps_batch([ta.eps_arrays(g.eps_params(), dev)
                          for g in geoms])
    with pytest.raises(ValueError):             # f64 points
        trk.inv_eps_at_quadrature(ga.qp_xy.double(), batch)
    with pytest.raises(ValueError):             # r2 of another batch size
        trk.inv_eps_at_quadrature(ga.qp_xy, batch._replace(
            r2=batch.r2[:2].contiguous()))
    with pytest.raises(ValueError):             # permittivities on the CPU
        trk.inv_eps_at_quadrature(ga.qp_xy, batch._replace(
            eps_core=batch.eps_core.cpu()))
    qs, _ = ta.assemble_vector3_sweep(ga, setup["gs"], [
        ta.eps_arrays(g.eps_params(), dev) for g in geoms])
    betas = torch.tensor([g.k0 * 1.49 for g in geoms], device=dev)
    Linv = torch.as_tensor(tk._LINV_REF, dtype=torch.float32, device=dev)

    def call(**kw):
        a = dict(gp=qs.gp, w=qs.w, N=ga.shape_vals, inv_eps=qs.inv_eps,
                 betas=betas, alpha=1.0, elem_valid=ga.elem_valid,
                 Linv=Linv, trace_ref=1.0)
        a.update(kw)
        return ck.pencil_bounds_vector3(**a)

    with pytest.raises(TypeError):
        call(inv_eps=qs.inv_eps.double())
    with pytest.raises(ValueError):             # betas of the wrong length
        call(betas=betas[:2].contiguous())
    with pytest.raises(ValueError):             # 1/eps of another grid
        call(inv_eps=qs.inv_eps[:, :-1].contiguous())
    with pytest.raises(ValueError):             # flags on the CPU
        call(elem_valid=ga.elem_valid.cpu())
    with pytest.raises(ValueError):             # a shape table of Q - 1 rows
        call(N=ga.shape_vals[:-1].contiguous())
    with pytest.raises(ValueError):             # CPU tensors: the twin's
        call(gp=qs.gp.cpu(), w=qs.w.cpu(), N=ga.shape_vals.cpu(),
             inv_eps=qs.inv_eps.cpu(), betas=betas.cpu(),
             elem_valid=ga.elem_valid.cpu(), Linv=Linv.cpu())


def test_vector_sweep_on_card_matches_cpu(setup, dev):
    """TrueVectorialMaxwellSolver.solve_sweep of B = 3 designs on the card
    (bootstrap off) launches the batched K6 and the sweep's K8 once each,
    neither the single-design K6 nor the stacked K8, and matches the same
    sweep on the CPU from the same start block: the n_modes wanted in
    n_eff within 1e-5."""
    from pl_fem_tpu_torch.config import SolverConfig
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver as S

    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.50, 1.60, 3)]
    mesh = dict(mesh_min_points=400, mesh_target_points=1600,
                mesh=MeshConfig(bucket_rounding=256))
    dg = export_device_grid(MeshGenerator.generate(
        geoms[0], 0.5, SimulationConfig(**mesh)), 256)
    sk = dict(cheb_degree=50, cheb_passes=2, beta_passes=1, bootstrap=False)
    n_modes = 6
    k = n_modes + SolverConfig().extra_vectors
    X0 = np.random.default_rng(7).standard_normal(
        (3 * dg.n_dofs_padded, 3, k)).astype(np.float32)
    counted = (trk.inv_eps_at_quadrature, ck.pencil_bounds_vector3,
               trk.eps_at_quadrature, ck.pencil_bounds)
    before = [f.launches for f in counted]
    on_card = S.solve_sweep(geoms, dg, n_modes, SimulationConfig(
        **mesh, solver=SolverConfig(device="cuda", **sk)), X0=X0)
    assert [f.launches - n for f, n in zip(counted, before)] == [1, 1, 0, 0]
    on_cpu = S.solve_sweep(geoms, dg, n_modes, SimulationConfig(
        **mesh, solver=SolverConfig(device="cpu", **sk)), X0=X0)
    for mc, mp in zip(on_card, on_cpu, strict=True):
        assert len(mc) >= n_modes and len(mp) >= n_modes
        ne_c = np.array([m["n_eff"] for m in mc[:n_modes]])
        ne_p = np.array([m["n_eff"] for m in mp[:n_modes]])
        assert np.abs(ne_c - ne_p).max() / ne_p.max() <= 1e-5


# ---------------------------------------------------------------------------
# the vectorial sweep's bootstrap seed (K9) and the Rayleigh-Ritz residuals
# with the pass gate (K10)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seed_setup(dev):
    """The prolongation tables of a coarse / fine pair of the small mesh's
    geometry on the card, and coarse vectors for B = 3 designs at k = 22:
    design 2 unseeded (colmask 0)."""
    from pl_fem_tpu_torch.solvers import vectorial as tv

    geom = MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    fine = export_device_grid(MeshGenerator.generate(geom, 0.5, SimulationConfig(
        mesh_min_points=400, mesh_target_points=1600,
        mesh=MeshConfig(bucket_rounding=256))), 256)
    coarse = MeshGenerator.generate(geom, 0.25, SimulationConfig(
        mesh_min_points=100, mesh_target_points=400))
    _, (cols, wts) = tv._prolongation_cached(coarse, fine, dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    k, Bs = 22, 3
    Dp = fine.n_dofs_padded
    Hc = torch.randn((Bs, 3, coarse.n_dofs, k), generator=gen, device=dev)
    colmask = torch.zeros((Bs, k), device=dev)
    colmask[0, :11] = 1.0
    colmask[1, :15] = 1.0
    Hc[:, :, :, 15:] = 0.0
    Hc[2] = 0.0
    R1, R2 = (torch.randn((Dp, Bs, 3, k), generator=gen, device=dev)
              for _ in range(2))
    scale = float(np.float32(0.05 / np.sqrt(np.float32(3 * Dp))))
    return dict(args=(Hc, colmask, cols, wts, R1, R2, scale), Dp=Dp, k=k,
                B=Bs)


def test_seed_prolong(seed_setup, dev):
    """K9 against its twin on real prolongation tables: within 1e-5 of
    max|X|, one launch, the same bits from a second launch, unit columns
    (the unseeded design's too, which is R1 / |R1| blended)."""
    args = seed_setup["args"]
    n0 = ck.seed_prolong.launches
    X = ck.seed_prolong(*args)
    assert ck.seed_prolong.launches == n0 + 1
    assert X.shape == (seed_setup["Dp"], seed_setup["B"], 3, seed_setup["k"])
    assert _rel(tk.seed_prolong_plain(*args), X) <= 1e-5
    assert torch.equal(X, ck.seed_prolong(*args))
    norms = torch.linalg.vector_norm(X, dim=(0, 2))
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    from pl_fem_tpu_torch.solvers import vectorial as tv

    # the solver's helper: numpy coarse vectors, noise given (3Dp, B, k)
    Hc, colmask, cols, wts, R1, R2, _ = args
    Y = tv._seed_from_coarse(
        Hc.cpu().numpy(), colmask.cpu().numpy(), cols, wts, dev,
        noise=[tk._stacked_from_fused(r).cpu().numpy() for r in (R1, R2)])
    assert torch.equal(Y, X)


def _ritz_inputs(dev, D, B_, C, k, seed):
    """Random fused AQ, BQ (D, B, C, k) with BQ ~ AQ / 2, G-orthonormal-ish
    Ys, theta from 2 up (residuals 1e-3 .. 0.5), cuts in between."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    AQ = torch.randn((D, B_, C, k), generator=gen, device=dev)
    BQ = (0.5 * AQ + 1e-3 * torch.randn((D, B_, C, k), generator=gen,
                                        device=dev)).contiguous()
    Ys = torch.randn((B_, k, k), generator=gen, device=dev) / k ** 0.5
    theta = (2.0 + torch.linspace(0.0, 1.0, k, device=dev)[None]
             .expand(B_, k)).contiguous()
    cuts = torch.linspace(2.3, 2.7, B_, device=dev)
    return AQ, BQ, Ys, theta, cuts


def _check_ritz(AQ, BQ, Ys, theta, cuts, n_wanted=0):
    """K10 against its twin: res within 1e-6 + 1e-3 res_twin, the gate
    within the same of the twin's and equal to the max (or min) of K10's
    own res over the twin's wanted set, one launch, the same bits from a
    second launch."""
    n0 = ck.ritz_residual.launches
    res, gate = ck.ritz_residual(AQ, BQ, Ys, theta, cuts, n_wanted)
    assert ck.ritz_residual.launches == n0 + 1
    ref, rgate = tk.ritz_residual_plain(AQ, BQ, Ys, theta, cuts, n_wanted)
    assert bool(((res - ref).abs() <= 1e-6 + 1e-3 * ref).all())
    assert abs(float(gate) - float(rgate)) <= 1e-6 + 1e-3 * float(rgate)
    assert float(gate) == float(tk._sweep_gate_maxres(theta, res, cuts,
                                                      n_wanted))
    again = ck.ritz_residual(AQ, BQ, Ys, theta, cuts, n_wanted)
    assert torch.equal(res, again[0]) and torch.equal(gate, again[1])


@pytest.mark.parametrize("D,B_,C,k", [(700, 3, 3, 7), (1000, 8, 3, 22),
                                      (613, 5, 3, 42), (2000, 1, 1, 22),
                                      (300, 2, 3, 96), (64, 1, 1, 1),
                                      (613, 1, 1, 27), (155648, 5, 3, 42),
                                      (500, 3, 3, 93), (257, 40, 3, 42)])
@pytest.mark.parametrize("n_wanted", [0, 3])
def test_ritz_residual(dev, D, B_, C, k, n_wanted):
    """K10 against its twin on random fused blocks, the sweep's (C = 3)
    and the stacked solver's (B = 1, C = 1) shapes, k from 1 to 96: a
    tail tile (D not a multiple of the tile) with node rows that do not
    start on 16 bytes (B C k = 27), the r5 shape, and designs split into
    groups whose rows are copied in 16-byte chunks (k = 96) or element by
    element (k = 93, and B = 40 at k = 42)."""
    _check_ritz(*_ritz_inputs(dev, D, B_, C, k, D + k), n_wanted)


def test_seed_and_ritz_refuse_misaligned_blocks(seed_setup, dev):
    """K10 streams AQ and BQ, K9 R1 and R2, in 16-byte copies: a view
    that does not start on 16 bytes is refused, not read."""
    AQ, BQ, Ys, theta, cuts = _ritz_inputs(dev, 100, 2, 3, 8, 3)
    n = AQ.numel()
    buf = torch.empty(n + 1, device=dev)
    shifted = buf[1:].view(AQ.shape)
    shifted.copy_(AQ)
    with pytest.raises(ValueError, match="16-byte"):
        ck.ritz_residual(shifted, BQ, Ys, theta, cuts)
    with pytest.raises(ValueError, match="16-byte"):
        ck.ritz_residual(AQ, shifted, Ys, theta, cuts)
    Hc, colmask, cols, wts, R1, R2, scale = seed_setup["args"]
    buf = torch.empty(R1.numel() + 1, device=dev)
    R1s = buf[1:].view(R1.shape)
    R1s.copy_(R1)
    with pytest.raises(ValueError, match="16-byte"):
        ck.seed_prolong(Hc, colmask, cols, wts, R1s, R2, scale)
    with pytest.raises(ValueError, match="16-byte"):
        ck.seed_prolong(Hc, colmask, cols, wts, R1, R1s, scale)


@pytest.mark.parametrize("kind", ["ones", "zeros", "prefix", "between"])
def test_seed_prolong_colmask_kinds(seed_setup, dev, kind):
    """K9 against its twin (1e-5 of max|X|), one launch, the same bits
    from a second launch, for every kind of colmask its skips meet: all
    seeded (R1 never read), none seeded (F never gathered), seeded
    prefixes as the bootstrap makes them, and values between 0 and 1
    (both read)."""
    Hc, colmask, cols, wts, R1, R2, scale = seed_setup["args"]
    Bs, k = colmask.shape
    if kind == "ones":
        m = torch.ones_like(colmask)
    elif kind == "zeros":
        m = torch.zeros_like(colmask)
    elif kind == "prefix":
        m = (torch.arange(k, device=dev)[None]
             < torch.tensor([[14], [3], [k]], device=dev)).float()
    else:
        m = colmask.clone()
        m[0, 2] = 0.5
        m[2, 5] = 0.25
        m[1, 20] = 0.75
    args = (Hc, m.contiguous(), cols, wts, R1, R2, scale)
    n0 = ck.seed_prolong.launches
    X = ck.seed_prolong(*args)
    assert ck.seed_prolong.launches == n0 + 1
    assert _rel(tk.seed_prolong_plain(*args), X) <= 1e-5
    assert torch.equal(X, ck.seed_prolong(*args))


@pytest.mark.parametrize("noise", [0.0, 1e-6, 1e-4])
def test_ritz_residual_near_the_f32_floor(dev, noise):
    """K10 where the Ritz pairs are exact up to ``noise``: AQ = BQ Ys
    diag(theta) Ys^-1 + noise N, so the residuals sit at the f32
    rounding floor (~1e-7) or at ``noise``. There the kernel and its
    twin sum in other orders, and they still agree to 1e-6 + 1e-3 res,
    the gate too (at config-1's k = 22, B = 2)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    D, B_, k = 3000, 2, 22
    BQ = torch.randn((D, B_, 3, k), generator=gen, device=dev)
    Ys = (torch.eye(k, device=dev)
          + 0.1 * torch.randn((B_, k, k), generator=gen, device=dev))
    theta = (1.0 + torch.rand((B_, k), generator=gen, device=dev)).sort(
        dim=1).values.contiguous()
    M = Ys @ torch.diag_embed(theta) @ torch.linalg.inv(Ys)
    AQ = (torch.einsum("dbck,bkl->dbcl", BQ.double(), M.double()).float()
          + noise * torch.randn((D, B_, 3, k), generator=gen, device=dev))
    cuts = torch.full((B_,), 1.5, device=dev)
    res, _ = ck.ritz_residual(AQ.contiguous(), BQ, Ys.contiguous(), theta,
                              cuts, 0)
    assert float(res.max()) < max(30 * noise, 1e-5)
    _check_ritz(AQ.contiguous(), BQ, Ys.contiguous(), theta, cuts, 0)


def test_ritz_residual_on_a_filtered_subspace(setup, dev):
    """K10 on the Rayleigh-Ritz of a filtered subspace of the small mesh
    (60 filter steps on the card): the residuals K10 and its twin give
    agree, wanted and near-converged ones included, and the gate of the
    fused Rayleigh-Ritz is K10's."""
    s = setup
    ga, gs, qs = s["ga"], s["gs"], s["qs"]
    D = ga.interior_mask.shape[0]
    _, diag = ta.assemble_vector3_qf(
        ga, ta.eps_arrays(MCFGeometry(3, 8.0, 1.5, 1.535, 1.0)
                          .eps_params(), dev))
    parks = torch.full((B,), 400.0, device=dev)
    cuts = (s["betas"] ** 2).contiguous()
    Xff = tk.cheb_sweep_filter(
        qs, gs, ga.interior_mask, 1.0 / torch.sqrt(diag),
        np.float32(tk.MASS_LO), np.float32(tk.MASS_HI), parks, s["betas"],
        1.0, s["X"].reshape(D, B, 3, K), cuts,
        torch.full((B,), 4e3, device=dev), degree=60, binv_degree=1)
    _, AQ, BQ, theta, Ys = tk._sweep_ritz(qs, gs, ga.interior_mask, parks,
                                          s["betas"], 1.0, Xff)
    _check_ritz(AQ, BQ, Ys.contiguous(), theta.contiguous(), cuts, 4)
    n0 = ck.ritz_residual.launches
    _, _, res, gate = tk.cheb_sweep_rr_impl(qs, gs, ga.interior_mask, parks,
                                            s["betas"], 1.0, Xff, cuts, 4)
    assert ck.ritz_residual.launches == n0 + 1
    assert float(gate) == float(tk._sweep_gate_maxres(theta, res, cuts, 4))


def test_ritz_residual_in_the_scalar_pass(setup, scalar_setup, dev,
                                          monkeypatch):
    """The stacked solver's pass (C = 1) launches K10 once on its block
    viewed as one design (B = 1, C = 1), and gives the residuals and gate
    of the same pass with the twin in K10's place (1e-6 + 1e-3 res)."""
    ga, gs = setup["ga"], setup["gs"]
    ss = scalar_setup
    lo, hi, bound = tk.pencil_bounds_elem(ss["A"], ss["B"], ga.elem_valid)
    dinv = 1.0 / torch.sqrt(torch.clamp(ss["diag"], min=1e-30))
    D = ga.dof_valid.shape[0]
    X = torch.randn((D, 22), generator=setup["gen"], device=dev)
    g = ss["g"]
    cut = torch.tensor(-(g.k0 * g.n_clad) ** 2 * 0.99, device=dev)
    bound = torch.clamp(bound, min=1.05)

    def run():
        return tk.cheb_rr_pass_impl(ss["A"], ga.qp_w, gs, ga.dof_valid,
                                    dinv, lo, hi, 1.0, X, cut, bound, C=1,
                                    degree=40, n_wanted=6)

    n0 = ck.ritz_residual.launches
    theta, _, res, gate = run()
    assert ck.ritz_residual.launches == n0 + 1
    monkeypatch.setattr(tk, "ritz_residual", tk.ritz_residual_plain)
    theta2, _, ref, rgate = run()
    assert torch.equal(theta, theta2)
    assert bool(((res - ref).abs() <= 1e-6 + 1e-3 * ref).all())
    assert abs(float(gate) - float(rgate)) <= 1e-6 + 1e-3 * float(rgate)


def test_seed_and_ritz_wrappers_refuse_bad_input(seed_setup, dev):
    """K9 and K10 raise on what their kernels do not take: f64 blocks,
    CPU tensors (the twins' inputs), shapes that do not match, more than
    96 columns (K10) or 8 entries a prolongation row (K9)."""
    Hc, colmask, cols, wts, R1, R2, scale = seed_setup["args"]
    with pytest.raises(TypeError):
        ck.seed_prolong(Hc.double(), colmask, cols, wts, R1, R2, scale)
    with pytest.raises(TypeError):                 # int64 columns
        ck.seed_prolong(Hc, colmask, cols.long(), wts, R1, R2, scale)
    with pytest.raises(ValueError):                # CPU tensors
        ck.seed_prolong(Hc.cpu(), colmask.cpu(), cols.cpu(), wts.cpu(),
                        R1.cpu(), R2.cpu(), scale)
    with pytest.raises(ValueError):                # noise of another layout
        ck.seed_prolong(Hc, colmask, cols, wts,
                        tk._stacked_from_fused(R1).contiguous(), R2, scale)
    wide = torch.zeros((cols.shape[0], 9), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                # 9 entries a row
        ck.seed_prolong(Hc, colmask, wide, wide.float(), R1, R2, scale)
    AQ, BQ, Ys, theta, cuts = _ritz_inputs(dev, 100, 2, 3, 9, 1)
    with pytest.raises(TypeError):
        ck.ritz_residual(AQ.double(), BQ, Ys, theta, cuts)
    with pytest.raises(ValueError):                # CPU tensors
        ck.ritz_residual(AQ.cpu(), BQ.cpu(), Ys.cpu(), theta.cpu(),
                         cuts.cpu())
    with pytest.raises(ValueError):                # the stacked layout
        ck.ritz_residual(tk._stacked_from_fused(AQ), BQ, Ys, theta, cuts)
    with pytest.raises(ValueError):                # cuts of another B
        ck.ritz_residual(AQ, BQ, Ys, theta, cuts[:1].contiguous())
    with pytest.raises(ValueError):                # not contiguous
        ck.ritz_residual(AQ, BQ, Ys.transpose(1, 2), theta, cuts)
    big = _ritz_inputs(dev, 40, 1, 1, 97, 2)
    with pytest.raises(ValueError):
        ck.ritz_residual(*big)


def test_seed_and_ritz_from_two_threads(seed_setup, dev):
    """K9 and K10 launched by two threads at once, 500 rounds each (a
    spin kernel first keeps the stream full): no launch fails, and every
    result equals, bit for bit, what one thread got. Each launch takes
    its scratch from ``torch.empty``, never a shared buffer. The second
    thread's K9 has colmask values between 0 and 1 and its K10 a tail
    tile of rows that do not start on 16 bytes (B C k = 27)."""
    Hc, colmask, cols, wts, R1, R2, scale = seed_setup["args"]
    between = colmask.clone()
    between[0, 2] = 0.5
    between[2, 5] = 0.25
    seeds = [seed_setup["args"],
             (Hc, between, cols, wts, R1, R2, scale * 2.0)]
    ritz = [_ritz_inputs(dev, 900, 3, 3, 22, 5),
            _ritz_inputs(dev, 613, 1, 1, 27, 6)]

    def launch_all(i):
        return (ck.seed_prolong(*seeds[i]),) + ck.ritz_residual(*ritz[i], 2)

    refs = [launch_all(i) for i in range(2)]
    differ = [torch.zeros((), dtype=torch.int64, device=dev)
              for _ in range(2)]
    rounds = [0, 0]
    errors = []
    start = threading.Barrier(2)

    def worker(i):
        try:
            start.wait(60)
            for _ in range(500):
                torch.cuda._sleep(100000)
                for y, r in zip(launch_all(i), refs[i]):
                    differ[i] += (y != r).sum()
                rounds[i] += 1
            torch.cuda.synchronize()
        except Exception as exc:      # reported below, with its thread
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert rounds == [500, 500]
    assert [int(d) for d in differ] == [0, 0]


def test_rayleigh_ritz_linalg_from_two_threads(dev):
    """The Rayleigh-Ritz's QR (``kernels._fused_qr``) and small
    eigenproblems (``kernels._ritz_pairs``), with K10 between them, from
    two threads at once for 15 s each at the r5 bucket shapes (3D =
    552960, B = 1, k = 38, and 3D = 466944, B = 5, k = 42), as the
    dataset engine's bucket pipeline runs them: no call fails. Without
    ``kernels._LINALG_LOCK`` two threads' QRs failed with
    CUSOLVER_STATUS_INTERNAL_ERROR on an H100 in each of four 60 s runs."""
    errors, rounds = [], [0, 0]
    start = threading.Barrier(2)

    def worker(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        D, B_, k = (184320, 1, 38) if i == 0 else (155648, 5, 42)
        X = torch.randn((D, B_, 3, k), generator=gen, device=dev)
        cuts = torch.full((B_,), 1.5, device=dev)
        eye = torch.eye(k, device=dev)
        try:
            start.wait(60)
            t_end = time.time() + 15.0
            while time.time() < t_end:
                Qf = tk._fused_qr(X)
                H = tk._fused_gram(Qf, Qf) + eye
                theta, Ys = tk._ritz_pairs(H, H + eye)
                _, gate = ck.ritz_residual(Qf, Qf, Ys.contiguous(),
                                           theta.contiguous(), cuts, 4)
                float(gate)
                rounds[i] += 1
        except Exception as exc:      # reported below, with its thread
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert min(rounds) > 0


# ---------------------------------------------------------------------------
# the design split of a sweep (solve_sweep(mesh=))
# ---------------------------------------------------------------------------

def _neff_rel(ref, out):
    worst = 0.0
    for mr, mo in zip(ref, out, strict=True):
        assert len(mo) == len(mr) > 0
        ne_r = np.array([m["n_eff"] for m in mr])
        ne_o = np.array([m["n_eff"] for m in mo])
        worst = max(worst, float(np.abs(ne_o - ne_r).max() / ne_r.max()))
    return worst


@pytest.fixture
def slices_seen(dev, monkeypatch):
    """Each Rayleigh-Ritz a split sweep runs (one per slice and pass): the
    device its input lies on, the current CUDA device at the call, and
    the devices of its outputs; the current device is checked restored
    after the test."""
    seen = []
    rr = tk.cheb_sweep_rr_impl

    def rr_seen(qs, gs, mask, parks, betas, alpha, Xff, *a, **kw):
        cur = torch.cuda.current_device()
        out = rr(qs, gs, mask, parks, betas, alpha, Xff, *a, **kw)
        seen.append((Xff.device, cur, Xff.shape[1],
                     {t.device for t in out}))
        return out

    before = torch.cuda.current_device()
    monkeypatch.setattr(tk, "cheb_sweep_rr_impl", rr_seen)
    yield seen
    assert torch.cuda.current_device() == before


def _slices_on_their_devices(seen, mesh, width):
    """Every slice's Rayleigh-Ritz ran with its device current, on
    ``width`` designs, and left its outputs there; the slices cycle
    through the mesh's devices in order."""
    assert seen and len(seen) % mesh.size == 0
    for i, (xdev, cur, w, outs) in enumerate(seen):
        assert xdev == mesh.devices[i % mesh.size]
        assert cur == xdev.index and w == width and outs == {xdev}


def test_split_config1_sweep_on_card(dev, slices_seen):
    """The config-1 fast sweep (B = 8, bootstrap on, ~60k DOFs) split into
    two slices of the card equals the unsplit sweep: n_eff within 1e-6
    relative; each slice's filter and Rayleigh-Ritz run with its device
    current and leave their outputs there."""
    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.parallel import design_mesh
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver as S

    cfg, _, dg, geoms = wl.config1_sweep()
    ref = S.solve_sweep(geoms, dg, wl.N_MODES, cfg)
    slices_seen.clear()
    mesh = design_mesh(["cuda:0"] * 2)
    out = S.solve_sweep(geoms, dg, wl.N_MODES, cfg, mesh=mesh)
    _slices_on_their_devices(slices_seen, mesh, len(geoms) // 2)
    assert _neff_rel(ref, out) <= 1e-6


def _small_sweep(n_designs):
    from pl_fem_tpu_torch.config import SolverConfig

    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.50, 1.60, n_designs)]
    mesh = dict(mesh_min_points=400, mesh_target_points=1600,
                mesh=MeshConfig(bucket_rounding=256))
    dg = export_device_grid(MeshGenerator.generate(
        geoms[0], 0.5, SimulationConfig(**mesh)), 256)
    cfg = SimulationConfig(**mesh, solver=SolverConfig(
        device="cuda", cheb_degree=50, cheb_passes=2, beta_passes=1,
        bootstrap=False))
    k = 6 + cfg.solver.extra_vectors
    X0 = np.random.default_rng(5).standard_normal(
        (3 * dg.n_dofs_padded, n_designs, k)).astype(np.float32)
    return geoms, dg, cfg, X0


def test_split_sweep_pads_on_card(dev, slices_seen):
    """B = 5 over two slices of the card: padded to 6 with the last
    design, 3 designs a slice, 5 results equal to the unsplit B = 5 sweep
    from the same start within 1e-6 relative in n_eff."""
    from pl_fem_tpu_torch.parallel import design_mesh
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver as S

    geoms, dg, cfg, X0 = _small_sweep(5)
    ref = S.solve_sweep(geoms, dg, 6, cfg, X0=X0)
    slices_seen.clear()
    mesh = design_mesh(["cuda:0"] * 2)
    out = S.solve_sweep(geoms, dg, 6, cfg, X0=X0, mesh=mesh)
    assert len(out) == 5
    _slices_on_their_devices(slices_seen, mesh, 3)
    assert _neff_rel(ref, out) <= 1e-6


def test_split_sweep_over_cards(dev, slices_seen):
    """Where more than one card is visible: B = 8 over every card
    (``design_mesh()``), each slice on its own card with that card
    current, equal to the unsplit sweep within 1e-6 relative in n_eff."""
    from pl_fem_tpu_torch.parallel import design_mesh
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver as S

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    geoms, dg, cfg, X0 = _small_sweep(8)
    ref = S.solve_sweep(geoms, dg, 6, cfg, X0=X0)
    slices_seen.clear()
    mesh = design_mesh()
    out = S.solve_sweep(geoms, dg, 6, cfg, X0=X0, mesh=mesh)
    assert len({d.index for d in mesh.devices}) == mesh.size > 1
    _slices_on_their_devices(slices_seen, mesh, -(-8 // mesh.size))
    assert _neff_rel(ref, out) <= 1e-6


@pytest.mark.parametrize("B_,k,D", [(8, 22, 60416), (6, 7, 3000)])
def test_cheb_step_scale_independent_of_design_count(dev, B_, k, D):
    """K4's renorm scale of a design is the same bits whether the block
    holds all B designs or half of them (a split sweep's slice): the lane
    count L = B * 3 * k takes another divisibility at B / 2, and with L
    specialized the per-column sums ran in another order (~1e-7 apart at
    config-1's B = 8, k = 22)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    W, V, T0 = (torch.randn((D, B_, 3, k), generator=gen, device=dev)
                for _ in range(3))
    c = torch.linspace(100, 200, B_, device=dev)
    h = torch.linspace(900, 1000, B_, device=dev)
    T2, s = trk.cheb_step(W, V, T0, c, h, renorm=True)
    b = B_ // 2
    for lo in (0, b):
        part = [t[:, lo:lo + b].contiguous() for t in (W, V, T0)]
        T2h, sh = trk.cheb_step(*part, c[lo:lo + b].contiguous(),
                                h[lo:lo + b].contiguous(), renorm=True)
        assert torch.equal(T2h, T2[:, lo:lo + b])
        assert torch.equal(sh, s[lo:lo + b])
