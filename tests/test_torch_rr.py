"""Port parity, the sweep's Rayleigh-Ritz and bootstrap seed: the fused-
layout Rayleigh-Ritz (``kernels.cheb_sweep_rr_impl``), the plain twins
of K10 (``ritz_residual_plain``: residual norms and pass gate) and K9
(``seed_prolong_plain``: the bootstrap seed), and the prolongation's
gather tables, against the JAX package on the same mesh and numpy
inputs. The CUDA kernels are held against these twins on the card in
tests/test_torch_cuda.py.

Tolerances, each with its reason:
- Ritz values theta: 1e-5 relative. The port runs QR on the rows in
  (node, component) order, the reference in (component, node) order;
  the factors agree up to column signs, so only f32 rounding differs.
- residuals: 1e-4 relative, and 1e-6 absolute below 1e-2 (a residual
  of a converged column is a difference of two f32 products; its
  rounding floor is ~1e-7 of ||A Xr||).
- Ritz vectors: up to sign, 1e-4 of the column's largest entry, where
  the column's theta is 1e-3 relative away from its neighbours (within
  a near-degenerate cluster single vectors are not unique).
- the seed: 1e-5 of max|X|, as the existing seed test.
- the gate: equal (a maximum or minimum of the same f32 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_fem_tpu.config import MeshConfig as JMeshConfig
from pl_fem_tpu.config import SimulationConfig as JSimulationConfig
from pl_fem_tpu.models import MCFGeometry as JMCFGeometry
from pl_fem_tpu.ops import assembly as ja
from pl_fem_tpu.ops import kernels as jk
from pl_fem_tpu.ops.femgrid import MeshGenerator as JMeshGenerator
from pl_fem_tpu.ops.femgrid import export_device_grid as j_export
from pl_fem_tpu.solvers import vectorial as jv
from pl_fem_tpu.solvers.vectorial import lp01_neff_estimate
from pl_fem_tpu_torch.config import MeshConfig, SimulationConfig
from pl_fem_tpu_torch.models import MCFGeometry
from pl_fem_tpu_torch.ops import assembly as ta
from pl_fem_tpu_torch.ops import kernels as tk
from pl_fem_tpu_torch.ops.femgrid import (MeshGenerator, export_device_grid,
                                          p2_prolongation)
from pl_fem_tpu_torch.solvers import vectorial as tv

torch.set_num_threads(1)
B, K = 3, 7


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def sw():
    """The small mesh of test_torch_kernels.py (3 cores, B = 3 designs),
    in both packages' containers, and a filtered fused subspace on it:
    120 filter steps of the port's twins from a numpy start block."""
    cfg = JSimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                            mesh=JMeshConfig(bucket_rounding=256))
    geoms = [JMCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=float(w))
             for w in np.linspace(1.50, 1.60, B)]
    dg = j_export(JMeshGenerator.generate(geoms[0], 0.5, cfg), 256)
    jga = ja.grid_to_device(dg, dtype=jnp.float32)
    invs = []
    for g in geoms:
        qf, diag = ja.assemble_vector3_qf(
            jga, ja.eps_arrays(g.eps_params(), dtype=jnp.float32))
        invs.append(qf.inv_eps)
    jqs = jk.QFactorSweep(invJT=qf.invJT, w=qf.w, inv_eps=jnp.stack(invs),
                          gp=jga.grad_phys)
    betas = np.array([g.k0 * lp01_neff_estimate(g.k0, 1.5, g.n_core,
                                                g.n_clad) for g in geoms],
                     np.float32)
    cuts = (betas.astype(np.float64) ** 2
            / np.array([g.n_clad ** 2 for g in geoms])).astype(np.float32)
    parks = (10.0 * cuts).astype(np.float32)
    tga = ta.grid_from_numpy(dg, "cpu")
    tgs = ta.gather_scatter(tga)
    tqs = ta.qfactor_sweep_from_numpy(*(np.asarray(a) for a in jqs), "cpu")
    mask = _t(np.asarray(dg.interior_mask, np.float32))
    bounds = tk.pencil_bounds_sweep(tqs, tga.shape_vals, tga.elem_valid,
                                    betas, 1.0) * 1.1
    D = dg.n_dofs_padded
    rng = np.random.default_rng(8)
    X = _t(rng.standard_normal((D, B, 3, K)).astype(np.float32))
    dinv = 1.0 / torch.sqrt(_t(np.asarray(diag, np.float32)))
    Xff = tk.cheb_sweep_filter(
        tqs, tgs, mask, dinv, np.float32(tk.MASS_LO),
        np.float32(tk.MASS_HI), _t(parks), _t(betas), 1.0, X, _t(cuts),
        torch.maximum(bounds, _t(parks) * 1.05), degree=120, binv_degree=4)
    return dict(dg=dg, jga=jga, jgs=ja.gather_scatter(jga), jqs=jqs, tgs=tgs,
                tqs=tqs, mask=mask, betas=betas, cuts=cuts, parks=parks, D=D,
                Xff=Xff.numpy(), rng=rng)


def _rr_pair(sw, n_wanted=0):
    """The JAX package's cheb_sweep_rr_impl and the port's on the same
    filtered block: (JAX theta, Xr, res), (port theta, Xr, res, gate)."""
    jth, jXr, jres = jk.cheb_sweep_rr_impl(
        sw["jqs"], sw["jgs"], sw["jga"].interior_mask,
        jnp.asarray(sw["parks"]), jnp.asarray(sw["betas"]), jnp.float32(1.0),
        jnp.asarray(sw["Xff"]))
    out = tk.cheb_sweep_rr_impl(
        sw["tqs"], sw["tgs"], sw["mask"], _t(sw["parks"]), _t(sw["betas"]),
        1.0, _t(sw["Xff"]), _t(sw["cuts"]), n_wanted=n_wanted)
    return tuple(np.asarray(a) for a in (jth, jXr, jres)), out


def test_sweep_rr_fused_matches_jax(sw):
    """The fused-layout Rayleigh-Ritz against the reference's
    (3D, B, k) one: theta, res and the Ritz vectors of separated
    columns (see the module's tolerances)."""
    (jth, jXr, jres), (th, Xr, res, _) = _rr_pair(sw)
    D = sw["D"]
    assert th.shape == (B, K) and res.shape == (B, K)
    assert Xr.shape == (D, B, 3, K)               # fused, for the next pass
    th, res = th.numpy(), res.numpy()
    assert (np.abs(th - jth) / np.abs(jth)).max() <= 1e-5
    lim = np.maximum(1e-4 * jres, np.where(jres < 1e-2, 1e-6, 0.0))
    assert np.all(np.abs(res - jres) <= lim)
    Xs = tk._stacked_from_fused(Xr).numpy()       # (3D, B, k)
    n_sep = 0
    for b in range(B):
        gap = np.abs(np.diff(jth[b])) / np.abs(jth[b, 1:])
        sep = np.ones(K, bool)
        sep[1:] &= gap > 1e-3
        sep[:-1] &= gap > 1e-3
        for j in np.flatnonzero(sep):
            ref, got = jXr[:, b, j], Xs[:, b, j]
            sgn = np.sign(ref @ got)
            assert np.abs(sgn * got - ref).max() <= 1e-4 * np.abs(ref).max()
            n_sep += 1
    assert n_sep >= B


def test_ritz_residual_twin_matches_old_chain():
    """K10's twin on fused (D, B, 3, k) blocks against the chain it
    replaces, on the component-major (3D, B, k) blocks: the Ritz blocks
    AQ Ys, BQ Ys, R = AXr - BXr theta and their column norms. Random
    blocks with BQ ~ AQ / 2 and theta from 2 up, so the residuals span
    2e-3 .. 0.5: within 1e-5 relative (f32 norms in two orders)."""
    rng = np.random.default_rng(4)
    D, Bq, k = 300, 2, 9
    AQ = _t(rng.standard_normal((D, Bq, 3, k)).astype(np.float32))
    BQ = (AQ * 0.5 + 1e-3 * _t(rng.standard_normal((D, Bq, 3, k))
                               .astype(np.float32))).contiguous()
    Ys = _t(rng.standard_normal((Bq, k, k)).astype(np.float32))
    theta = _t((2.0 + np.linspace(0.0, 1.0, k)[None]
                + 1e-3 * rng.standard_normal((Bq, k))).astype(np.float32))
    cuts = _t(np.array([2.5, 3.5], np.float32))
    res, gate = tk.ritz_residual_plain(AQ, BQ, Ys, theta, cuts)
    AXr = torch.einsum("dbk,bkl->dbl", tk._stacked_from_fused(AQ), Ys)
    BXr = torch.einsum("dbk,bkl->dbl", tk._stacked_from_fused(BQ), Ys)
    ref = (torch.linalg.vector_norm(AXr - BXr * theta[None], dim=0)
           / (torch.linalg.vector_norm(AXr, dim=0) + 1e-30))
    assert float(ref.min()) < 1e-2 and float(ref.max()) > 0.1
    assert float(((res - ref).abs() / ref).max()) <= 1e-5
    assert float(gate) == float(res[theta < cuts[:, None]].max())


@pytest.mark.parametrize("case", ["none_wanted", "n_wanted_cap",
                                  "all_wanted"])
def test_sweep_gate_matches_jax(case):
    """The pass gate (``_sweep_gate_maxres``, K10's twin's gate) against
    the reference's ``_sweep_gate_maxres`` on the same (B, k) theta and
    res: nothing below the cuts (the minimum residual), the wanted set
    capped at n_wanted columns, and every column wanted."""
    rng = np.random.default_rng(2)
    theta = np.sort(rng.uniform(1.0, 10.0, (4, 12)), axis=1).astype(np.float32)
    res = rng.uniform(1e-7, 1e-2, (4, 12)).astype(np.float32)
    cuts, n_wanted = {
        "none_wanted": (np.full(4, 0.5), 0),
        "n_wanted_cap": (np.array([4.0, 6.0, 8.0, 11.0]), 3),
        "all_wanted": (np.full(4, 11.0), 0)}[case]
    cuts = cuts.astype(np.float32)
    ref = float(jk._sweep_gate_maxres(jnp.asarray(theta), jnp.asarray(res),
                                      jnp.asarray(cuts), n_wanted=n_wanted))
    got = tk._sweep_gate_maxres(_t(theta), _t(res), _t(cuts), n_wanted)
    assert got.dim() == 0
    assert float(got) == ref
    wanted = (theta < cuts[:, None]) & (
        (np.arange(12) < n_wanted) if n_wanted else True)
    assert ref == (res[wanted].max() if wanted.any() else res.min())


def test_sweep_rr_gate_is_the_reference_gate(sw):
    """The gate the port's Rayleigh-Ritz returns (from K10's twin)
    equals the reference's gate on the reference's own theta and res
    within the residual tolerance, with and without the n_wanted cap."""
    for n_wanted in (0, 4):
        (jth, _, jres), (_, _, _, gate) = _rr_pair(sw, n_wanted)
        ref = float(jk._sweep_gate_maxres(jnp.asarray(jth),
                                          jnp.asarray(jres),
                                          jnp.asarray(sw["cuts"]),
                                          n_wanted=n_wanted))
        assert abs(float(gate) - ref) <= max(1e-4 * ref, 1e-6)


def test_rayleigh_ritz_linalg_runs_under_the_lock(sw, monkeypatch):
    """The Rayleigh-Ritz's cuSOLVER calls (QR, Cholesky, triangular
    solves, eigh) run under ``kernels._LINALG_LOCK``: from two host
    threads at once (the dataset engine's bucket pipeline) they fail on
    the card (tests/test_torch_cuda.py::
    test_rayleigh_ritz_linalg_from_two_threads), and the CPU cannot show
    that race, so the code is held to the lock here."""
    seen = []

    def held(name, fn):
        def wrapped(*args, **kw):
            seen.append((name, tk._LINALG_LOCK.locked()))
            return fn(*args, **kw)
        return wrapped

    for name in ("qr", "cholesky", "solve_triangular", "eigh"):
        monkeypatch.setattr(torch.linalg, name,
                            held(name, getattr(torch.linalg, name)))
    tk.cheb_sweep_rr_impl(sw["tqs"], sw["tgs"], sw["mask"], _t(sw["parks"]),
                          _t(sw["betas"]), 1.0, _t(sw["Xff"]),
                          _t(sw["cuts"]))
    assert {n for n, _ in seen} == {"qr", "cholesky", "solve_triangular",
                                    "eigh"}
    assert all(locked for _, locked in seen)


def test_solve_lowest_sweep_takes_the_fused_seed(sw):
    """``solve_lowest_sweep`` from a fused (D, B, 3, k) start block (the
    bootstrap seed) gives what it gives from the same block in the
    (3D, B, k) layout, bit for bit: the fused block goes to the filter
    as it is, and the Rayleigh-Ritz carries it fused from pass to
    pass."""
    D = sw["D"]
    Xf = _t(sw["rng"].standard_normal((D, B, 3, K)).astype(np.float32))
    diag = torch.ones(D)
    args = (sw["tqs"], sw["tgs"], sw["mask"], diag)
    kw = dict(degree=12, passes=1, max_passes=2, binv_degree=1,
              parks=sw["parks"])
    rest = (sw["cuts"], sw["betas"], 1.0, sw["cuts"] * 20)
    fused = tk.solve_lowest_sweep(*args, Xf, *rest, **kw)
    stacked = tk.solve_lowest_sweep(*args, tk._stacked_from_fused(Xf),
                                    *rest, **kw)
    assert fused[1].shape == (3 * D, B, K)
    for a, b in zip(fused, stacked):
        assert torch.equal(a, b)


def test_prolongation_tables_match_row_loop():
    """The vectorized (Dp, W) gather tables equal the row loop's (the
    reference's ``_prolongation_cached`` body), on a coarse / fine pair
    of the small mesh's geometry; the device tables are cached per (grid
    pair, device) and reused."""
    geom = MCFGeometry(3, 8.0, 1.5, 1.535, 1.0, wavelength_um=1.55)
    cfg = SimulationConfig(mesh_min_points=400, mesh_target_points=1600,
                           mesh=MeshConfig(bucket_rounding=256))
    fine = export_device_grid(MeshGenerator.generate(geom, 0.5, cfg), 256)
    coarse = MeshGenerator.generate(geom, 0.25, SimulationConfig(
        mesh_min_points=100, mesh_target_points=400))
    assert coarse.n_dofs < fine.n_dofs
    Pc = p2_prolongation(coarse, fine.dof_coords[:fine.n_dofs]).tocsr()
    Dp = fine.n_dofs_padded
    W = int(np.diff(Pc.indptr).max())
    cols = np.zeros((Dp, W), np.int32)
    wts = np.zeros((Dp, W), np.float32)
    for r in range(Pc.shape[0]):
        s, e = Pc.indptr[r], Pc.indptr[r + 1]
        cols[r, :e - s] = Pc.indices[s:e]
        wts[r, :e - s] = Pc.data[s:e]
    got_c, got_w = tv._prolongation_tables(Pc, Dp)
    assert got_c.dtype == np.int32 and got_w.dtype == np.float32
    assert np.array_equal(got_c, cols) and np.array_equal(got_w, wts)
    P, (tc, tw) = tv._prolongation_cached(coarse, fine, "cpu")
    assert tc.dtype == torch.int32 and tw.dtype == torch.float32
    assert np.array_equal(tc.numpy(), cols)
    assert np.array_equal(tw.numpy(), wts)
    again = tv._prolongation_cached(coarse, fine, torch.device("cpu"))
    assert again[1][0] is tc and again[0] is P


def test_seed_twin_writes_fused_layout():
    """K9's twin (``seed_prolong_plain``) on the inputs of
    test_torch_solver.py::test_seed_from_coarse_matches_jax, with the
    noise blocks in the fused layout: the reference's seed transposed to
    (Dp, B, 3, k) within 1e-5 of max|X|, unit columns over (d, c)."""
    import jax

    rng = np.random.default_rng(5)
    Bs, nc, k, Dp, W = 2, 40, 6, 64, 6
    Hc = rng.standard_normal((Bs, 3, nc, k)).astype(np.float16)
    colmask = np.zeros((Bs, k), np.float32)
    colmask[0, :3] = 1.0
    colmask[1, :5] = 1.0
    Pcols = rng.integers(0, nc, (Dp, W)).astype(np.int32)
    Pwts = rng.random((Dp, W)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jv._seed_from_coarse(
        jnp.asarray(Hc), jnp.asarray(colmask), jnp.asarray(Pcols),
        jnp.asarray(Pwts), key))
    k1, k2 = jax.random.split(key)
    R1, R2 = (tk._fused_from_stacked(_t(jax.random.normal(
        kk, (3 * Dp, Bs, k), jnp.float32))) for kk in (k1, k2))
    scale = float(np.float32(0.05 / np.sqrt(np.float32(3 * Dp))))
    out = tk.seed_prolong_plain(_t(Hc.astype(np.float32)), _t(colmask),
                                _t(Pcols), _t(Pwts), R1, R2, scale)
    assert out.shape == (Dp, Bs, 3, k) and out.is_contiguous()
    ref_f = tk._fused_from_stacked(_t(ref)).numpy()
    assert np.abs(out.numpy() - ref_f).max() <= 1e-5 * np.abs(ref_f).max()
    norms = torch.linalg.vector_norm(out, dim=(0, 2))
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_seed_twin_ignores_masked_terms():
    """The spec K9's skips rest on: with a binary colmask, R1 on the
    seeded columns (colmask 1) and the coarse vectors, so F, on the
    unseeded ones (colmask 0) enter the seed multiplied by exact zeros,
    so other finite values there give the same X bit for bit. With a
    colmask between 0 and 1 both terms count and X changes."""
    rng = np.random.default_rng(7)
    Bs, nc, k, Dp, W = 3, 40, 8, 64, 6
    Hc = _t(rng.standard_normal((Bs, 3, nc, k)).astype(np.float32))
    colmask = np.zeros((Bs, k), np.float32)
    colmask[0, :5] = 1.0
    colmask[1, :] = 1.0                       # design 2 stays unseeded
    cols = _t(rng.integers(0, nc, (Dp, W)).astype(np.int32))
    wts = _t(rng.random((Dp, W)).astype(np.float32))
    R1, R2 = (_t(rng.standard_normal((Dp, Bs, 3, k)).astype(np.float32))
              for _ in range(2))
    scale = float(np.float32(0.05 / np.sqrt(np.float32(3 * Dp))))
    seeded = _t(colmask == 1.0)               # (B, k)
    R1x = torch.where(seeded[None, :, None, :], 1e3 * torch.flip(R1, (0,)),
                      R1)
    Hcx = torch.where(seeded[:, None, None, :], Hc,
                      -7.0 * torch.flip(Hc, (2,)) + 3.0)

    def seed(mask, H, A):
        return tk.seed_prolong_plain(H, _t(mask), cols, wts, A, R2, scale)

    assert torch.equal(seed(colmask, Hc, R1), seed(colmask, Hcx, R1x))
    half = colmask.copy()
    half[0, 1] = 0.5                          # seeded column, R1 changed
    half[2, 3] = 0.5                          # unseeded column, Hc changed
    a, b = seed(half, Hc, R1), seed(half, Hcx, R1x)
    assert not torch.equal(a[:, 0, :, 1], b[:, 0, :, 1])
    assert not torch.equal(a[:, 2, :, 3], b[:, 2, :, 3])


def _tf32(x):
    """TF32 rounding as the card's cvt.rna.tf32.f32 does it: round to
    nearest (ties away from zero) at the low 13 bits of an f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tensor_core_residuals(AQ, BQ, Ys, theta, split):
    """K10's arithmetic on the card, emulated: the products of each k
    step of 8 on the tensor cores (exact products of TF32 values, summed
    and rounded once into the f32 accumulator), with the 3xTF32 split (a
    = hi + lo, lo hi' + hi lo' + hi hi' per step) or plain TF32 (hi hi'
    alone); R = u - theta v in f32, the squares summed in f64. AQ, BQ
    (D, B, C, k), Ys (B, k, k), theta (B, k) as numpy f32."""
    D, Bq, C, k = AQ.shape
    kp = -(-k // 8) * 8
    pad = ((0, 0), (0, kp - k))

    def parts(x):
        hi = _tf32(x)
        return hi.astype(np.float64), _tf32(x - hi).astype(np.float64)

    res = np.empty((Bq, k), np.float32)
    for b in range(Bq):
        yh, yl = parts(np.pad(Ys[b], ((0, kp - k), (0, 0))))
        acc = []
        for Q in (AQ, BQ):
            ah, al = parts(np.pad(Q[:, b].reshape(D * C, k), pad))
            u = np.zeros((D * C, k), np.float32)
            for s in range(0, kp, 8):
                terms = ([(al, yh), (ah, yl)] if split else []) + [(ah, yh)]
                for a, y in terms:
                    u = (u + a[:, s:s + 8] @ y[s:s + 8]).astype(np.float32)
            acc.append(u)
        u, v = acc
        R = u - theta[b][None] * v
        nr = (R.astype(np.float64) ** 2).sum(0)
        nu = (u.astype(np.float64) ** 2).sum(0)
        res[b] = np.sqrt(nr) / (np.sqrt(nu) + 1e-30)
    return res


@pytest.mark.parametrize("route,noise", [("3xtf32", 0.0), ("3xtf32", 1e-6),
                                         ("3xtf32", 1e-4), ("tf32", 0.0)])
def test_tf32_split_products_hold_the_f32_floor(route, noise):
    """K10 forms its products on the tensor cores with the 3xTF32 split.
    On the exact-Ritz-pair inputs of the card test
    (test_torch_cuda.py::test_ritz_residual_near_the_f32_floor: AQ = BQ
    Ys diag(theta) Ys^-1 + noise N, so the residuals sit at the f32
    floor or at the noise), that arithmetic, emulated here, holds the
    residuals to the twin's within the card test's tolerance, 1e-6 +
    1e-3 res, and below max(30 noise, 1e-5). Plain TF32 misses it."""
    rng = np.random.default_rng(12)
    D, Bq, k = 3000, 2, 22
    BQ = rng.standard_normal((D, Bq, 3, k)).astype(np.float32)
    Ys = (np.eye(k) + 0.1 * rng.standard_normal((Bq, k, k))).astype(
        np.float32)
    theta = np.sort(1.0 + rng.random((Bq, k)), axis=1).astype(np.float32)
    M = (Ys.astype(np.float64) @ (theta[:, :, None] * np.linalg.inv(Ys)))
    AQ = (np.einsum("dbck,bkl->dbcl", BQ.astype(np.float64), M)
          + noise * rng.standard_normal((D, Bq, 3, k))).astype(np.float32)
    cuts = np.full(Bq, 1.5, np.float32)
    ref, _ = tk.ritz_residual_plain(_t(AQ), _t(BQ), _t(Ys), _t(theta),
                                    _t(cuts))
    ref = ref.numpy()
    got = _tensor_core_residuals(AQ, BQ, Ys, theta, route == "3xtf32")
    held = (np.all(np.abs(got - ref) <= 1e-6 + 1e-3 * ref)
            and got.max() < max(30 * noise, 1e-5))
    assert held == (route == "3xtf32")
