"""Port parity, filter kernels: the plain PyTorch twins of K1-K4 (the
versions the wrappers run on CPU tensors) against the JAX package's
sweep functions on the same mesh and the same numpy inputs. The
CUDA/Triton kernels are held against these twins on the card in
tests/test_torch_cuda.py.

Tolerances:
- single applies: <= 1e-5 of max|y| (f32, two orderings of the same
  sums);
- the filter (11 to 17 recurrence steps, one or two renorms): <= 1e-4 of
  max|y|, the step rounding amplified by the Chebyshev growth between
  renorms;
- ``solve_lowest_sweep``: the wanted Ritz values theta (below the cut)
  to <= 1e-4 relative, from the same numpy start block.
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
from pl_fem_tpu.solvers.vectorial import lp01_neff_estimate
from pl_fem_tpu_torch.ops import assembly as ta
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops import triton_kernels as trk

torch.set_num_threads(1)
B, K = 3, 7


def _rel(ref, y):
    ref = np.asarray(ref, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return np.abs(ref - y).max() / (np.abs(ref).max() + 1e-300)


@pytest.fixture(scope="module")
def sw():
    """One 3-core mesh and B = 3 designs, in both packages' containers."""
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    geoms = [MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.50, 1.60, B)]
    dg = export_device_grid(MeshGenerator.generate(geoms[0], 0.5, cfg), 256)
    jga = ja.grid_to_device(dg, dtype=jnp.float32)
    jgs = ja.gather_scatter(jga)
    invs, bounds = [], []
    betas = np.array([g.k0 * lp01_neff_estimate(g.k0, 1.5, g.n_core,
                                                g.n_clad) for g in geoms],
                     np.float32)
    for g, b in zip(geoms, betas):
        ea = ja.eps_arrays(g.eps_params(), dtype=jnp.float32)
        qf, diag = ja.assemble_vector3_qf(jga, ea)
        invs.append(qf.inv_eps)
        prim, _, _ = ja.assemble_vector3_system(jga, ea)
        A = ja.vector3_stacked_A(prim, jnp.float32(b), jnp.float32(1.0))
        bounds.append(float(jk.pencil_bounds_elem(A, prim["u_nn"],
                                                  jga.elem_valid, C=3)[2]))
    jqs = jk.QFactorSweep(invJT=qf.invJT, w=qf.w, inv_eps=jnp.stack(invs),
                          gp=jga.grad_phys)
    tga = ta.grid_from_numpy(dg, "cpu")
    tqs = ta.qfactor_sweep_from_numpy(*(np.asarray(a) for a in jqs), "cpu")
    D = dg.n_dofs_padded
    rng = np.random.default_rng(3)
    cuts = (betas.astype(np.float64) ** 2).astype(np.float32)
    return dict(
        dg=dg, jga=jga, jgs=jgs, jqs=jqs, tga=tga,
        tgs=ta.gather_scatter(tga), tqs=tqs, D=D,
        diag=np.asarray(diag, np.float32), betas=betas, cuts=cuts,
        bounds=np.asarray(bounds, np.float32) * np.float32(1.1),
        parks=(10.0 * cuts).astype(np.float32),
        mask=np.asarray(dg.interior_mask, np.float32),
        X=rng.standard_normal((D, B, 3, K)).astype(np.float32),
        Ye=rng.standard_normal((dg.elem_dofs.shape[0], 6, B * 3 * K))
        .astype(np.float32),
        rng=rng)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_apply_vector3_twin_matches_jax(sw):
    """K1 twin + K2 twin (with the mask/park epilogue) ==
    _apply_vector3_fused."""
    ref = jk._apply_vector3_fused(sw["jqs"], sw["jgs"], sw["jga"].interior_mask,
                                  jnp.asarray(sw["parks"]),
                                  jnp.asarray(sw["betas"]), jnp.float32(1.0),
                                  jnp.asarray(sw["X"]))
    y = tk._apply_vector3_fused(sw["tqs"], sw["tgs"], _t(sw["mask"]),
                                _t(sw["parks"]), _t(sw["betas"]), 1.0,
                                _t(sw["X"]))
    assert y.shape == (sw["D"], B, 3, K)
    assert _rel(ref, y.numpy()) <= 1e-5


def test_accumulate_twin_matches_jax(sw):
    ref = jk._accumulate_fused(jnp.asarray(sw["Ye"]), sw["jgs"])
    y = tk._accumulate_fused(_t(sw["Ye"]), sw["tgs"])
    assert _rel(ref, y.numpy()) <= 1e-5


def test_apply_mass_twin_matches_jax(sw):
    Xl = sw["X"].reshape(sw["D"], -1)
    ref = jk._apply_mass_fused(sw["jqs"], sw["jgs"], sw["jga"].interior_mask,
                               jnp.asarray(Xl))
    y = tk._apply_mass_fused(sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(Xl))
    assert _rel(ref, y.numpy()) <= 1e-5


@pytest.mark.parametrize("degree", [1, 4])
def test_apply_binv_twin_matches_jax(sw, degree):
    Xl = sw["X"].reshape(sw["D"], -1)
    dinv = (1.0 / np.sqrt(np.maximum(sw["diag"], 1e-30))).astype(np.float32)
    lo, hi = np.float32(jk.MASS_LO), np.float32(jk.MASS_HI)
    ref = jk._apply_binv_fused(sw["jqs"], sw["jgs"], sw["jga"].interior_mask,
                               jnp.asarray(dinv), jnp.float32(lo),
                               jnp.float32(hi), jnp.asarray(Xl), degree)
    y = tk._apply_binv_fused(sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(dinv),
                             lo, hi, _t(Xl), degree)
    assert _rel(ref, y.numpy()) <= 1e-5


def test_apply_mass_plain_twin_matches_jax(sw):
    """The unfused mass twin K3 is held against on the card ==
    _apply_mass_fused of the JAX package."""
    Xl = sw["X"].reshape(sw["D"], -1)
    ref = jk._apply_mass_fused(sw["jqs"], sw["jgs"], sw["jga"].interior_mask,
                               jnp.asarray(Xl), 3.0)
    y = tk._apply_mass_fused_plain(sw["tqs"], sw["tgs"], _t(sw["mask"]),
                                   _t(Xl), 3.0)
    assert _rel(ref, y.numpy()) <= 1e-6


def _binv_inputs(sw):
    dinv = (1.0 / np.sqrt(np.maximum(sw["diag"], 1e-30))).astype(np.float32)
    return dinv, np.float32(jk.MASS_LO), np.float32(jk.MASS_HI)


@pytest.mark.parametrize("degree", [1, 2, 4])
def test_apply_binv_plain_twin_matches_jax(sw, degree):
    Xl = sw["X"].reshape(sw["D"], -1)
    dinv, lo, hi = _binv_inputs(sw)
    ref = jk._apply_binv_fused(sw["jqs"], sw["jgs"], sw["jga"].interior_mask,
                               jnp.asarray(dinv), jnp.float32(lo),
                               jnp.float32(hi), jnp.asarray(Xl), degree)
    y = tk._apply_binv_fused_plain(sw["tqs"], sw["tgs"], _t(sw["mask"]),
                                   _t(dinv), lo, hi, _t(Xl), degree)
    assert _rel(ref, y.numpy()) <= 1e-6


@pytest.mark.parametrize("degree", [1, 2, 4])
def test_binv_steps_equal_plain_twin(sw, degree):
    """``degree`` step-mode calls of the mass apply (what K3 launches on
    the card, here its CPU twin) give the unfused semi-iteration bit for
    bit; the step keeps R and Z in the caller's buffers."""
    Xl = _t(sw["X"].reshape(sw["D"], -1))
    dinv, lo, hi = _binv_inputs(sw)
    args = (sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(dinv), lo, hi, Xl,
            degree)
    y = tk._apply_binv_fused(*args)
    assert torch.equal(y, tk._apply_binv_fused_plain(*args))
    assert torch.equal(Xl, _t(sw["X"].reshape(sw["D"], -1)))


def test_mass_step_updates_r_and_z_in_place(sw):
    """One middle step: R' = R - s M~(s Dd), Z' = Z + Dd in the given
    buffers, Dd' = a Dd + b R' returned."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(11)
    D, L = sw["D"], B * 3 * K
    Dd, R, Z = (_t(rng.standard_normal((D, L)).astype(np.float32))
                for _ in range(3))
    ds = _t(rng.uniform(0.5, 2.0, D).astype(np.float32))
    mask = _t(sw["mask"])
    N = tk.shape_table("cpu")
    R0, Z0 = R.clone(), Z.clone()
    out = ck.mass_apply(Dd, sw["tgs"], sw["tqs"].w, N, mask,
                        step=ck.BinvStep(ds, R, Z, 0.7, 0.3, 1.0, False,
                                         False))
    Rn = R0 - ds[:, None] * tk._apply_mass_fused_plain(
        sw["tqs"], sw["tgs"], mask, ds[:, None] * Dd)
    assert torch.equal(R, Rn)
    assert torch.equal(Z, Z0 + Dd)
    assert torch.equal(out, 0.7 * Dd + 0.3 * Rn)


@pytest.mark.parametrize("L", [22, 528])
@pytest.mark.parametrize("degree", [2, 4, 8])
def test_binv_chain_equals_plain_semi_iteration(sw, degree, L):
    """K12's wrapper (on the CPU its twin, the K3 step chain) gives the
    semi-iteration written in torch ops around the unfused mass apply
    (``_apply_binv_fused_plain``) bit for bit, at the scalar filter's 22
    lanes and the config-1 sweep's 528, and leaves its input as it was."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(degree * 1000 + L)
    X = _t(rng.standard_normal((sw["D"], L)).astype(np.float32))
    X0 = X.clone()
    dinv, lo, hi = _binv_inputs(sw)
    theta, a, b = tk._binv_coefs(lo, hi, degree)
    y = ck.binv_chain(X, sw["tgs"], sw["tqs"].w, tk.shape_table("cpu"),
                      _t(sw["mask"]), _t(dinv), a, b, theta, degree)
    assert torch.equal(y, tk._apply_binv_fused_plain(
        sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(dinv), lo, hi, X, degree))
    assert torch.equal(X, X0)


@pytest.mark.parametrize("degree,L,chain", [
    (1, 22, False),           # one K3 step
    (2, 22, True),
    (8, 22, True),            # the scalar filter
    (2, 32, True),            # rows one quarter warp sums
    (2, 33, False),           # past them: the K3 step chain
    (4, 528, False),          # the config-1 sweep's lanes
])
def test_binv_steps_route_short_rows_through_the_chain(
        sw, degree, L, chain, monkeypatch):
    """``_binv_steps`` hands degree >= 2 on rows of at most BINV_LANES
    lanes to K12 in one call and keeps the rest on K3 steps (degree 1,
    wider rows); either way the result is the plain semi-iteration's."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    calls, steps = [], []
    k12, k3 = tk.binv_chain, tk.mass_apply

    def counted_chain(*args):
        calls.append(args[-1])
        return k12(*args)

    def counted_step(*args, **kw):
        steps.append(kw["step"].first)
        return k3(*args, **kw)

    monkeypatch.setattr(tk, "binv_chain", counted_chain)
    monkeypatch.setattr(tk, "mass_apply", counted_step)
    assert ck.BINV_LANES == 32
    rng = np.random.default_rng(degree * 1000 + L)
    Xl = _t(rng.standard_normal((sw["D"], L)).astype(np.float32))
    dinv, lo, hi = _binv_inputs(sw)
    y = tk._binv_steps(sw["tqs"].w, sw["tgs"], _t(sw["mask"]), _t(dinv), lo,
                       hi, Xl, degree)
    assert calls == ([degree] if chain else [])
    assert len(steps) == (0 if chain else degree)
    assert torch.equal(y, tk._apply_binv_fused_plain(
        sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(dinv), lo, hi, Xl, degree))


# an H100: 132 SMs, 226 KB of shared memory a launcher gives a CTA; K12's
# halo staging and block record take some of it (what they take depends
# on the plan: none, and 64 KB, are tried)
H100_SM, H100_CTA = 132, 226 * 1024


@pytest.mark.parametrize("staged", [0, 64 * 1024])
@pytest.mark.parametrize("D,L,on_chip", [
    (59963, 22, True),        # config-1 scalar filter
    (60416, 22, True),        # the same mesh as the device grid pads it
    (59963, 528, False),      # config-1 vectorial sweep, B = 8, k = 22
    (155648, 27, False),      # r5 scalar mesh at its largest k
    (155648, 630, False),     # r5 vectorial sweep, B = 5, k = 42
])
def test_binv_on_chip_is_a_function_of_shape_and_card(D, L, on_chip,
                                                      staged):
    """Where K12 keeps R and Z follows from (D, L) and the card alone:
    on chip for the config-1 scalar filter, device memory for the
    sweep's lanes and for the r5 scalar mesh. The rule is R and Z of the
    rows one CTA an SM owns against what that CTA has left."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    shared = H100_CTA - staged
    assert ck.binv_on_chip(D, L, H100_SM, shared) is on_chip
    rows = -(-(-(-D // ck.MASS_ROWS)) // H100_SM) * ck.MASS_ROWS
    assert ck.binv_on_chip(D, L, H100_SM, 8 * rows * L) is True
    assert ck.binv_on_chip(D, L, H100_SM, 8 * rows * L - 1) is False


def test_binv_chain_refuses_degree_below_two(sw):
    """Degree 1 is one K3 step, not a chain; a coefficient list of the
    wrong length is refused too."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    X = _t(sw["X"].reshape(sw["D"], -1))
    dinv, lo, hi = _binv_inputs(sw)
    args = (sw["tgs"], sw["tqs"].w, tk.shape_table("cpu"), _t(sw["mask"]),
            _t(dinv))
    theta, a, b = tk._binv_coefs(lo, hi, 2)
    with pytest.raises(ValueError):
        ck.binv_chain(X, *args, a[:1], b[:1], theta, 1)
    with pytest.raises(ValueError):
        ck.binv_chain(X, *args, a, b[:1], theta, 2)


def test_dof_row_order_is_cached_permutation(sw):
    """The row walk of the mass kernel: a deterministic permutation of
    range(D), built once per device grid with the plan. Its blocks are
    blocks of the Morton walk, whose consecutive rows are mesh
    neighbours (mean step well under a storage-order walk's)."""
    ga = ta.grid_from_numpy(sw["dg"], "cpu")
    order = ta.mass_plan(ga).order
    assert order.dtype == torch.int32 and order.shape == (sw["D"],)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(sw["D"], dtype=torch.int32))
    assert ta.mass_plan(ga) is ta.gather_scatter(ga).plan
    morton = ta.dof_row_order(ga.dof_coords.clone())
    assert torch.equal(morton, ta.dof_row_order(ga.dof_coords))
    R = ta.MASS_ROWS
    for b in range(0, sw["D"], R):
        assert set(order[b:b + R].tolist()) == set(morton[b:b + R].tolist())
    xy = ga.dof_coords[: sw["dg"].n_dofs]
    real = morton[morton < sw["dg"].n_dofs].long()
    walk = (xy[real][1:] - xy[real][:-1]).norm(dim=1).mean()
    storage = (xy[1:] - xy[:-1]).norm(dim=1).mean()
    assert walk < 0.5 * storage


def test_mass_plan_reproduces_the_mass_apply(sw):
    """The kernel's sum through the plan, emulated in float64: for every
    row block, each entry's six gathered rows read through the block's
    halo slots == elem_dofs, and the per-row sums in table order give
    the plain twin's m M(m x) + park (x - m x)."""
    ga = ta.grid_from_numpy(sw["dg"], "cpu")
    plan = ta.mass_plan(ga)
    R = ta.MASS_ROWS
    NB, H = plan.halo.shape
    assert NB == -(-sw["D"] // R) and plan.row_ptr.shape == (NB * R + 1,)
    assert plan.loc.dtype == torch.int16 and int(plan.loc.max()) < H
    counts = (plan.row_ptr[1:] - plan.row_ptr[:-1]).long()
    pos = torch.repeat_interleave(torch.arange(NB * R), counts)
    assert int(torch.bincount(pos // R, minlength=NB).max()) \
        == plan.max_entries
    e = plan.ent.long() // 6
    i = plan.ent.long() % 6
    gathered = plan.halo.long()[(pos // R)[:, None], plan.loc.long()]
    assert torch.equal(gathered, ga.elem_dofs.long()[e])
    assert int((plan.halo >= 0).sum(1).sub(plan.n_halo).abs().max()) == 0
    X = torch.as_tensor(sw["X"].reshape(sw["D"], -1), dtype=torch.float64)
    m = torch.as_tensor(sw["mask"], dtype=torch.float64)[:, None]
    C = torch.einsum("eq,qi,qj->eij", sw["tqs"].w.double(),
                     *[tk.shape_table("cpu").double()] * 2)
    part = (C[e, i, :, None] * (X * m)[gathered]).sum(1)
    Y = torch.zeros((NB * R, X.shape[1]), dtype=torch.float64)
    Y.index_add_(0, pos, part)
    Yd = torch.zeros_like(X)
    Yd[plan.order.long()] = Y[: sw["D"]]
    y = Yd * m + 3.0 * (X - X * m)
    ref = tk._apply_mass_fused_plain(sw["tqs"], sw["tgs"], _t(sw["mask"]),
                                     X.float(), 3.0)
    assert _rel(ref.numpy(), y.numpy()) <= 1e-6


def test_apply_plan_reproduces_the_apply(sw):
    """The fused A(beta) kernel's sum through its plan, emulated in
    float64: node i of element slot s of block b lands on the block's
    entry dst[b, s, i]; every entry is written once, by an element node
    of its own row, in the rows' transpose-table order; and the rows'
    sums of the element results give the twin's m A(m X) + park (X - m X)
    within 1e-6."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    ga = ta.grid_from_numpy(sw["dg"], "cpu")
    plan = ta.apply_plan(ga)
    assert plan is ta.gather_scatter(ga).apply_plan
    R, D = plan.rows, sw["D"]
    NB, HE = plan.elems.shape
    assert NB == -(-D // R) and plan.row_ptr.shape == (NB * R + 1,)
    assert plan.dst.dtype == torch.int16 and plan.dst.shape == (NB, HE, 6)
    assert torch.equal(torch.sort(plan.order).values,
                       torch.arange(D, dtype=torch.int32))
    counts = (plan.row_ptr[1:] - plan.row_ptr[:-1]).long()
    per_block = counts.view(NB, R).sum(1)
    assert int(per_block.max()) == plan.max_entries
    assert ta.apply_shared_bytes(R, HE, plan.max_entries) \
        <= ta.APPLY_SHARED_LIMIT
    # the entries in plan order, straight from the transpose tables
    split, Wv = ga.dof_gather_v.shape
    tab = torch.full((D, max(Wv, 2)), -1, dtype=torch.int64)
    tab[:split, :Wv] = torch.where(ga.dof_gather_valid_v,
                                   ga.dof_gather_v.long(), -1)
    tab[split:, :2] = torch.where(ga.dof_gather_valid_e,
                                  ga.dof_gather_e.long(), -1)
    rows = tab[plan.order.long()]
    expected = rows[rows >= 0]
    assert torch.equal(counts[:D], (rows >= 0).sum(1))
    # what the element slots write, at their global entry numbers
    b, s, i = (plan.dst >= 0).nonzero(as_tuple=True)
    e = plan.elems.long()[b, s]
    assert bool((e >= 0).all()) and bool((s < plan.n_elems.long()[b]).all())
    g = plan.row_ptr.long()[b * R] + plan.dst.long()[b, s, i]
    assert torch.equal(torch.bincount(g, minlength=expected.numel()),
                       torch.ones_like(expected))
    written = torch.empty_like(expected)
    written[g] = e * 6 + i
    assert torch.equal(written, expected)
    assert plan.recompute >= 1.0
    # the sums in f64
    dt = torch.float64
    qs = sw["tqs"]
    X = torch.as_tensor(sw["X"].reshape(D, -1), dtype=dt)
    m = torch.as_tensor(sw["mask"], dtype=dt)
    parks = torch.as_tensor(sw["parks"], dtype=dt)
    Ye = ck.apply_vector3_elem_plain(
        X * m[:, None], ga.elem_dofs, qs.gp.to(dt), qs.w.to(dt),
        qs.inv_eps.to(dt), torch.as_tensor(sw["betas"], dtype=dt), 1.0,
        tk.shape_table("cpu").to(dt), K)
    pos = torch.repeat_interleave(torch.arange(NB * R), counts)
    Y = torch.zeros((NB * R, X.shape[1]), dtype=dt)
    Y.index_add_(0, pos[g], Ye[e, i])
    Yd = torch.zeros_like(X)
    Yd[plan.order.long()] = Y[:D]
    pk = parks.repeat_interleave(3 * K)
    y = Yd * m[:, None] + pk * (X - X * m[:, None])
    ref = tk._apply_vector3_fused(qs, sw["tgs"], _t(sw["mask"]),
                                  _t(sw["parks"]), _t(sw["betas"]), 1.0,
                                  _t(sw["X"]))
    assert _rel(ref.numpy().reshape(D, -1), y.numpy()) <= 1e-6


@pytest.mark.parametrize("binv", [0, 1])
def test_cheb_filter_matches_jax_chunk(sw, binv):
    """T1 = T(X), then 11 recurrence steps with the K4 twin (renorm at
    step 8) == cheb_sweep_chunk_impl(first=True, steps=12)."""
    steps = 12
    dinv = (1.0 / np.sqrt(np.maximum(sw["diag"], 1e-30))).astype(np.float32)
    lo, hi = np.float32(jk.MASS_LO), np.float32(jk.MASS_HI)
    X = jnp.asarray(sw["X"])
    _, ref = jk.cheb_sweep_chunk_impl(
        sw["jqs"], sw["jgs"], sw["jga"].interior_mask, jnp.asarray(dinv),
        jnp.float32(lo), jnp.float32(hi), jnp.asarray(sw["parks"]),
        jnp.asarray(sw["betas"]), jnp.float32(1.0), X, X,
        jnp.asarray(sw["cuts"]), jnp.asarray(sw["bounds"]),
        np.int32(steps), np.bool_(True), binv_degree=binv)
    y = tk.cheb_sweep_filter(
        sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(dinv), lo, hi,
        _t(sw["parks"]), _t(sw["betas"]), 1.0, _t(sw["X"]), _t(sw["cuts"]),
        _t(sw["bounds"]), degree=steps, binv_degree=binv)
    assert _rel(ref, y.numpy()) <= 1e-4


@pytest.mark.parametrize("steps", [17, 18])
def test_deferred_renorm_matches_jax_chunk(sw, steps):
    """T1 = T(X), then 16 or 17 recurrence steps with the K4 twin: renorms
    at recurrence steps 8 and 16 deferred into the steps after them,
    the last step a renorm (its scale applied at the end) or the step
    right after one == cheb_sweep_chunk_impl(first=True), whose renorm
    rescales in place."""
    dinv = (1.0 / np.sqrt(np.maximum(sw["diag"], 1e-30))).astype(np.float32)
    lo, hi = np.float32(jk.MASS_LO), np.float32(jk.MASS_HI)
    X = jnp.asarray(sw["X"])
    _, ref = jk.cheb_sweep_chunk_impl(
        sw["jqs"], sw["jgs"], sw["jga"].interior_mask, jnp.asarray(dinv),
        jnp.float32(lo), jnp.float32(hi), jnp.asarray(sw["parks"]),
        jnp.asarray(sw["betas"]), jnp.float32(1.0), X, X,
        jnp.asarray(sw["cuts"]), jnp.asarray(sw["bounds"]),
        np.int32(steps), np.bool_(True), binv_degree=0)
    y = tk.cheb_sweep_filter(
        sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(dinv), lo, hi,
        _t(sw["parks"]), _t(sw["betas"]), 1.0, _t(sw["X"]), _t(sw["cuts"]),
        _t(sw["bounds"]), degree=steps, binv_degree=0)
    assert _rel(ref, y.numpy()) <= 1e-4


def test_cheb_step_twin_formula():
    """K4 twin: T2 = 2 (W - c V) / h - T0, the opening step (W - c V) / h,
    the pending scales of V (on 2 T(V)) and of T0, and the renorm: T2
    returned unscaled with s = 1 / ||T2||_(D, 3) per (design, column),
    nothing updated in place."""
    rng = np.random.default_rng(7)
    W, V, T0 = (torch.as_tensor(rng.standard_normal((11, 2, 3, 4))
                                .astype(np.float32)) for _ in range(3))
    c = torch.tensor([1.5, -2.0])
    h = torch.tensor([3.0, 0.5])
    cb, hb = c[None, :, None, None], h[None, :, None, None]
    first, s = trk.cheb_step(W, V, None, c, h)
    assert s is None and torch.allclose(first, (W - cb * V) / hb)
    step, s = trk.cheb_step(W, V, T0, c, h)
    assert s is None
    assert torch.allclose(step, 2.0 * (W - cb * V) / hb - T0)
    sv, s0 = (torch.as_tensor(rng.uniform(0.5, 2.0, (2, 4))
                              .astype(np.float32)) for _ in range(2))
    scaled, _ = trk.cheb_step(W, V, T0, c, h, scale=sv, scale_t0=s0)
    assert torch.allclose(scaled, sv[None, :, None, :] * 2.0 * (W - cb * V)
                          / hb - s0[None, :, None, :] * T0)
    V2 = V.clone()
    ren, s = trk.cheb_step(W, V2, T0, c, h, renorm=True)
    assert torch.equal(ren, step) and torch.equal(V2, V)
    assert s.shape == (2, 4)
    n = (ren * s[None, :, None, :]).norm(dim=(0, 2))
    assert torch.allclose(n, torch.ones_like(n), atol=1e-6)
    with pytest.raises(ValueError):     # s would be pending on sv * V
        trk.cheb_step(W, V, T0, c, h, renorm=True, scale=sv)


def test_solve_lowest_sweep_matches_jax(sw):
    """Two filter + Rayleigh-Ritz passes from the same numpy X0: the
    wanted Ritz values (below the cut) agree."""
    D = sw["D"]
    X0 = sw["rng"].standard_normal((3 * D, B, K)).astype(np.float32)
    kw = dict(degree=40, passes=2, max_passes=2, binv_degree=4)
    jth, _, jres = jk.solve_lowest_sweep(
        sw["jqs"], sw["jgs"], sw["jga"].interior_mask, jnp.asarray(sw["diag"]),
        jnp.asarray(X0), sw["cuts"], sw["betas"], 1.0, sw["bounds"],
        parks=sw["parks"], **kw)
    tth, tXr, tres = tk.solve_lowest_sweep(
        sw["tqs"], sw["tgs"], _t(sw["mask"]), _t(sw["diag"]), X0,
        sw["cuts"], sw["betas"], 1.0, sw["bounds"], parks=sw["parks"], **kw)
    jth = np.asarray(jth)
    assert tth.shape == (B, K) and tXr.shape == (3 * D, B, K)
    wanted = jth < sw["cuts"][:, None]
    assert wanted.sum() >= B
    rel = np.abs(tth.numpy() - jth) / np.abs(jth)
    assert rel[wanted].max() <= 1e-4
    assert np.isfinite(tres.numpy()).all()
