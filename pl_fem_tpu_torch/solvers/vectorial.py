"""Vectorial H-field Maxwell eigenmode solver.

Port of pl_fem_tpu/solvers/vectorial.py. The transverse pencil's guided
modes are *interior* eigenvalues (the reason the reference needs ARPACK
+ SuperLU). Instead the solver works on the full-vector curl-curl
problem at *fixed propagation constant* beta0,

    A(beta0) h = k0^2 M h,    h = (hx, hy, hz~),

where guided modes are the SMALLEST eigenvalues — reachable with a
float32 low-end Chebyshev filter over matrix-free element operators on
the device (ops/kernels.py). The filtered subspace V then turns "given
k0, find beta" into a small projected quadratic eigenproblem

    (A0 + beta A1 + beta^2 A2 - k0^2 M) y = 0,

solved on the host in float64 by companion linearization over shared-
pattern CSRs (ops/host_assembly.py).

The device is explicit: ``SolverConfig.device`` names it, and every
tensor of a solve is created there.

``SolverConfig.backend == "hybrid"`` makes ``solve_vectorial_modes``
run the reference-identical transverse pencil through scipy ARPACK
shift-invert on the host instead (``_solve_hybrid``): the cross-
formulation oracle. ``solve_sweep`` is the device filter under either
backend, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.spatial import QhullError

from ..config import SimulationConfig
from ..ops.assembly import (
    assemble_vector3_sweep,
    eps_arrays,
    gather_scatter,
    grid_to_device,
)
from ..ops.eig import scipy_eigsh_pencil
from ..ops.femgrid import DeviceGrid, FEMGrid, MeshGenerator, export_device_grid
from ..ops.host_assembly import (
    HostVector3,
    build_host_vector3,
    build_host_vector3_family,
    eps_at_quadrature_np,
    quadratic_subspace,
    scalar_pattern,
    spmm,
    vector3_prims_np,
)
from ..ops.cuda_kernels import seed_prolong
from ..ops.kernels import (_fused_from_stacked, _on_device,
                           pencil_bounds_sweep, seed_prolong_plain,
                           solve_lowest_sweep)
from ..parallel import design_mesh
from .postproc import polarization_from_powers, polarization_label

logger = logging.getLogger("pl_fem_tpu_torch.solvers.vectorial")


def lp01_neff_estimate(k0: float, r_mean: float, n_core: float,
                       n_clad: float) -> float:
    """LP01 effective-index estimate (solver_fem.py:187-193).

    The reference clips to [n_clad + 0.05, n_core - 0.005]; for low
    contrast (delta_n < 0.055) that window is empty and numpy's clip
    degenerates to the upper bound, ruining a perfectly good estimate —
    shrink the lower clip so the window stays valid (the reference never
    hits this regime: its claddings are air).
    """
    NA = np.sqrt(max(n_core**2 - n_clad**2, 1e-6))
    V_geom = k0 * r_mean * NA
    b_approx = max((1.0 - 2.405 / max(V_geom, 2.41)) ** 2, 0.05)
    n_eff_est = np.sqrt(n_clad**2 + b_approx * (n_core**2 - n_clad**2))
    hi = n_core - 0.005
    lo = n_clad + min(0.05, 0.5 * (n_core - n_clad))
    return float(np.clip(n_eff_est, min(lo, hi), hi))


_PROLONG_CACHE: dict = {}


def _prolongation_tables(Pc, Dp: int):
    """The padded (Dp, W) gather tables of a CSR prolongation ``Pc``: row
    r holds its entries' columns (int32) and weights (f32) in stored
    order, zero-padded to the widest row; rows past ``Pc``'s are zero."""
    counts = np.diff(Pc.indptr)
    W = int(counts.max()) if Pc.nnz else 1
    rows = np.repeat(np.arange(Pc.shape[0]), counts)
    pos = np.arange(Pc.nnz) - np.repeat(Pc.indptr[:-1], counts)
    cols = np.zeros((Dp, W), np.int32)
    wts = np.zeros((Dp, W), np.float32)
    cols[rows, pos] = Pc.indices[:Pc.nnz]
    wts[rows, pos] = Pc.data[:Pc.nnz]
    return cols, wts


def _prolongation_cached(grid_c: FEMGrid, dg: DeviceGrid, device):
    """Coarse->fine P2 prolongation, cached per (coarse grid, fine grid,
    device).

    Returns ``(P_csr, (cols, wts))``: the host CSR plus the padded
    (Dp, W) gather tables on ``device`` (int32 columns, f32 weights) —
    every P row is the 6 P2 shape values of the containing coarse
    element, so the prolongation runs on the device as W gather-FMAs
    (see ``_seed_from_coarse``)."""
    import zlib

    from ..ops.femgrid import p2_prolongation

    dev = torch.device(device)
    key = (zlib.crc32(grid_c.elem_dofs.tobytes()), grid_c.n_dofs,
           zlib.crc32(np.ascontiguousarray(
               dg.dof_coords[:dg.n_dofs]).tobytes()), dg.n_dofs, str(dev))
    hit = _PROLONG_CACHE.get(key)
    if hit is None:
        P = p2_prolongation(grid_c, dg.dof_coords[:dg.n_dofs])
        cols, wts = _prolongation_tables(P.tocsr(), dg.n_dofs_padded)
        hit = (P, (torch.as_tensor(cols, device=dev),
                   torch.as_tensor(wts, device=dev)))
        if len(_PROLONG_CACHE) > 8:
            _PROLONG_CACHE.clear()
        _PROLONG_CACHE[key] = hit
    return hit


def _seed_from_coarse(Hc, colmask, Pcols, Pwts, device,
                      generator: Optional[torch.Generator] = None,
                      noise=None):
    """Bootstrap seed on the device: prolong + blend + normalize (K9
    ``seed_prolong``, one launch, on the card; its twin on the CPU).

    Hc (B, 3, nc, k) coarse Ritz vectors (zero-padded columns) and
    colmask (B, k) 1.0 on seeded columns, numpy arrays; Pcols/Pwts the
    (Dp, W) gather tables (``_prolongation_cached``'s device tables, or
    arrays). Seeded columns normalize then blend 5% random (the prolonged
    span is error-correlated and a Chebyshev filter can only shrink a
    span — see _bootstrap_sweep); unseeded columns are unit random. The
    two standard-normal blocks come from ``noise`` = (R1, R2), each
    (3Dp, B, k) component-major, when given (the tests feed both
    packages the same numbers), else from ``generator``, drawn in the
    fused layout; R2 enters at 0.05 / sqrt(3 Dp). Returns X (Dp, B, 3, k)
    f32, the fused block the filter takes.
    """
    dev = torch.device(device)
    f32 = torch.float32
    Hc = torch.tensor(np.asarray(Hc, dtype=np.float32), device=dev)
    colmask = torch.tensor(np.asarray(colmask, dtype=np.float32),
                           device=dev)
    cols = torch.as_tensor(Pcols, dtype=torch.int32, device=dev)
    wts = torch.as_tensor(Pwts, dtype=f32, device=dev)
    B, _, _, k = Hc.shape
    shape = (cols.shape[0], B, 3, k)
    if noise is not None:
        R1, R2 = (_fused_from_stacked(torch.tensor(
            np.asarray(r, dtype=np.float32), device=dev)) for r in noise)
    else:
        R1 = torch.randn(shape, generator=generator, device=dev, dtype=f32)
        R2 = torch.randn(shape, generator=generator, device=dev, dtype=f32)
    scale = float(np.float32(0.05 / np.sqrt(np.float32(3 * shape[0]))))
    seed = seed_prolong_plain if dev.type == "cpu" else seed_prolong
    return seed(Hc, colmask, cols, wts, R1, R2, scale)


def _as_device_grid(grid, config: SimulationConfig) -> DeviceGrid:
    if isinstance(grid, DeviceGrid):
        return grid
    if isinstance(grid, FEMGrid):
        return export_device_grid(grid, config.mesh.bucket_rounding)
    raise TypeError(f"expected FEMGrid or DeviceGrid, got {type(grid)}")


def _check_backend(cfg: SimulationConfig) -> None:
    if cfg.solver.backend not in ("device", "hybrid"):
        raise ValueError(f"unknown solver backend {cfg.solver.backend!r}; "
                         f"use 'device' or 'hybrid'")


def _device_of(cfg: SimulationConfig) -> torch.device:
    _check_backend(cfg)
    dev = torch.device(cfg.solver.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"SolverConfig.device={cfg.solver.device!r} but "
                           f"no CUDA device is available")
    return dev


# threads inside solve_sweep -> nesting depth (the bootstrap and the
# sub-sweep split call solve_sweep again from the same thread)
_SWEEP_THREADS: Dict[int, int] = {}
_SWEEP_LOCK = threading.Lock()


@contextlib.contextmanager
def _sweep_running():
    """Mark this thread as running a sweep for the memory budget."""
    tid = threading.get_ident()
    with _SWEEP_LOCK:
        _SWEEP_THREADS[tid] = _SWEEP_THREADS.get(tid, 0) + 1
    try:
        yield
    finally:
        with _SWEEP_LOCK:
            _SWEEP_THREADS[tid] -= 1
            if not _SWEEP_THREADS[tid]:
                del _SWEEP_THREADS[tid]


def _designs_per_sweep(dev: torch.device, E_pad: int, Dp: int,
                       k: int, mesh=None) -> int:
    """Most designs one packed sweep may hold on ``dev``.

    Per design the filter holds the (E, 6, 3k) element block and about
    six (D, 3k) state arrays in f32. Half the free device memory is the
    budget, the rest is margin for the allocator and the Rayleigh-Ritz
    temporaries, and the half is shared equally by the threads running
    sweeps at the time (the dataset engine's bucket pipeline runs two):
    each thread sees the same free memory, so each taking half would
    leave no margin. No split on the CPU.

    With a ``mesh`` the budget is per device: each device's is shared by
    the slices it holds, every slice takes as many designs as the most
    loaded device allows, and the sweep holds that many times the slice
    count."""
    if mesh is not None:
        per_slice = min(
            max(1, _designs_per_sweep(d, E_pad, Dp, k)
                // mesh.devices.count(d))
            for d in set(mesh.devices))
        return per_slice * mesh.size
    if dev.type != "cuda":
        return 1 << 30
    free, _ = torch.cuda.mem_get_info(dev)
    with _SWEEP_LOCK:
        n_threads = max(1, len(_SWEEP_THREADS))
    per_design = 4 * 3 * k * (6 * E_pad + 6 * Dp)
    return max(1, int(0.5 * free) // (per_design * n_threads))


def _max_rounds(beta_passes: int, qres_max_rounds: Optional[int]) -> int:
    """Outer (beta) rounds of a sweep: exactly 1 in fast mode, else at
    least ``beta_passes`` and up to ``qres_max_rounds`` (default 6) while
    the qres gate is not met. ``qres_max_rounds or 6`` treats an explicit
    0 as unset; the JAX package does the same, and the port keeps it."""
    if beta_passes == 1:
        return 1
    return max(beta_passes, qres_max_rounds or 6)


def _pad_active(idx, B: int, mesh=None) -> list:
    """Pad an active-design index list to a power-of-two filter width
    that divides over the ``mesh`` (at least its size; at most B, which
    divides), repeating the last active design."""
    w = 1
    while w < len(idx):
        w *= 2
    if mesh is not None:
        w = max(w, mesh.size)
        w = -(-w // mesh.size) * mesh.size
    w = min(max(w, 1), B)
    return list(idx) + [idx[-1]] * (w - len(idx))


def _pad_designs(a, B: int, pad: int):
    """``a`` (an array or tensor (rows, B, k), or a function of such a
    shape returning one, as ``solve_sweep`` takes its start blocks) with
    the last design's columns repeated ``pad`` more times; None stays
    None."""
    if a is None:
        return None
    if callable(a):
        return lambda shape: _pad_designs(a((shape[0], B, shape[2])), B,
                                          pad)
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:, -1:].expand(-1, pad, -1)], dim=1)
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[:, -1:], pad, axis=1)], axis=1)


class TrueVectorialMaxwellSolver:
    """Vectorial H-field solver (reference seam: solver_fem.py:113-239)."""

    METHOD_TAG = "H-field_GPU_v1"
    #: wall-clock phase breakdown of the most recent solve_sweep call
    #: (bootstrap / assemble / bounds / host_family / filter / xfer /
    #: polish / postproc) — profiling hook, populated per call.
    last_sweep_times: Dict[str, float] = {}
    # debug_checks: per-design diagnosis of the LAST solve_sweep call
    # (design index -> message); empty when every design solved clean
    last_sweep_diagnostics: Dict[int, str] = {}

    def __init__(self, geometry, use_pml: bool = False,
                 config: Optional[SimulationConfig] = None):
        self.geometry = geometry
        self.k0 = float(geometry.k0)
        self.use_pml = use_pml
        self.config = config or SimulationConfig()

    # ------------------------------------------------------------------
    def solve_vectorial_modes(self, grid=None, n_modes_target: int = 20,
                              sigma: Optional[float] = None) -> List[Dict]:
        """Solve for guided vectorial modes of this geometry.

        Device backend: the packed sweep machinery with B = 1. Hybrid
        backend: ARPACK shift-invert on the host; ``sigma`` (hybrid
        only) overrides its shift-invert target beta^2. The reference's
        LP01-derived shift (solver_fem.py:187-193) lands inside the
        dense penalty-spurious branch on high-contrast geometries;
        seeding sigma from a device solve's beta_max^2 aims ARPACK at
        the physical cluster.
        """
        cfg = self.config
        _check_backend(cfg)
        hybrid = cfg.solver.backend == "hybrid"
        if not hybrid:
            _device_of(cfg)
        if grid is None:
            grid = MeshGenerator.generate(self.geometry,
                                          cfg.mesh.refinement, cfg)
        dg = _as_device_grid(grid, cfg)
        if hybrid:
            hv = build_host_vector3(dg, self.geometry.eps_params(),
                                    cfg.solver.alpha_penalty)
            betas, hx, hy, hz = self._solve_hybrid(dg, n_modes_target,
                                                   sigma=sigma)
            return self._postprocess(hv, dg, betas, hx, hy, hz,
                                     n_modes_target)
        return type(self).solve_sweep([self.geometry], dg, n_modes_target,
                                      cfg)[0]

    # -- hybrid backend: reference-identical transverse pencil ----------
    def _solve_hybrid(self, dg: DeviceGrid, n_modes_target: int,
                      sigma: Optional[float] = None):
        import scipy.sparse as sp

        g = self.geometry
        ap = self.config.solver.alpha_penalty
        eps_re, _ = eps_at_quadrature_np(dg, g.eps_params())
        prim = vector3_prims_np(dg, eps_re)
        spat = scalar_pattern(dg)
        T = dg.n_elems
        k2 = self.k0**2

        def csr(blocks):
            return spat.with_blocks(
                np.ascontiguousarray(blocks[:T]).ravel())

        # transverse pencil forms (solver_fem.py:131-167) from primitives
        Axx = csr(prim["i_gygy"] + ap * prim["u_gxgx"] - k2 * prim["u_nn"])
        Ayy = csr(prim["i_gxgx"] + ap * prim["u_gygy"] - k2 * prim["u_nn"])
        Axy = csr(-prim["i_gxgy"] + ap * np.swapaxes(prim["u_gxgy"], 1, 2))
        Binv = csr(prim["i_nn"])

        n = dg.n_dofs
        A = sp.bmat([[Axx, Axy], [Axy.T, Ayy]], format="csr")
        B = sp.bmat([[Binv, None], [None, Binv]], format="csr")

        interior = np.where(dg.interior_mask[:n])[0]
        idx = np.concatenate([interior, interior + n])
        A_int = A[idx, :][:, idx]
        B_int = B[idx, :][:, idx]

        if sigma is None:
            n_eff_est = lp01_neff_estimate(self.k0,
                                           float(np.mean(g.core_radii)),
                                           g.n_core, g.n_clad)
            sigma = (self.k0 * n_eff_est) ** 2
        k = min(n_modes_target + 12, A_int.shape[0] - 4)
        beta_sq, evecs = scipy_eigsh_pencil(A_int, B_int, k=k, sigma=sigma,
                                            tol=1e-7, maxiter=12000)
        keep = beta_sq > 0
        beta_sq, evecs = beta_sq[keep], evecs[:, keep]
        betas = np.sqrt(beta_sq)
        ni = len(interior)
        hx = np.zeros((n, len(betas)))
        hy = np.zeros((n, len(betas)))
        hx[interior] = evecs[:ni]
        hy[interior] = evecs[ni:]
        # Hz from the div-free condition div H = 0: with H = (hx, hy,
        # i hz~) e^{i beta z}, hz~ = (dx hx + dy hy) / beta, projected
        # back to the P2 basis via one mass solve. Keeps the mode-dict
        # schema backend-independent (the transverse pencil itself never
        # carries Hz; the reference simply omitted it).
        if len(betas):
            from scipy.sparse.linalg import factorized

            Ngx = csr(prim["u_ngx"])
            Ngy = csr(prim["u_ngy"])
            M = csr(prim["u_nn"])
            Msolve = factorized(M.tocsc())
            rhs = (Ngx @ hx + Ngy @ hy) / betas[None, :]
            hz = np.column_stack([Msolve(rhs[:, i])
                                  for i in range(rhs.shape[1])])
        else:
            hz = np.zeros((n, 0))
        return betas, hx, hy, hz

    # -- two-grid spectral bootstrap (no reference analog) ---------------
    @classmethod
    def _bootstrap_sweep(cls, geometries, dg: DeviceGrid,
                         n_modes_target: int, cfg: SimulationConfig,
                         generator: torch.Generator, noise=None,
                         coarse_X0=None, mesh=None):
        """Coarse-mesh solve -> prolonged Ritz vectors + per-design beta.

        Solves the same sweep on a ~6x-coarser mesh and P2-interpolates
        the polished coarse modes onto the fine DOFs. ``coarse_X0`` is
        the coarse sweep's ``X0`` (see ``solve_sweep``), ``noise`` the
        seed's blend; the coarse sweep splits over ``mesh`` as the fine
        one does. Returns (X0 (Dp, B, 3, k) f32 tensor in the
        filter's fused layout, betas (B,), used mask) or None if the
        bootstrap is not applicable.
        """
        import dataclasses as dc

        scfg = cfg.solver
        dev = torch.device(scfg.device)
        g0 = geometries[0]
        B = len(geometries)
        n = dg.n_dofs
        k = min(n_modes_target + scfg.extra_vectors, n)

        fine_pts = max(n // 4, 1)
        coarse_min = max(500, fine_pts // 6)
        # the coarse solve only seeds a subspace: in fast mode it runs
        # one beta round too
        coarse_bp = 2 if scfg.beta_passes >= 2 else 1
        # 3-level hierarchy in accuracy mode only (its coarse grid is
        # ~n/3, large enough to be worth bootstrapping itself)
        coarse_cfg = dc.replace(
            cfg, mesh_min_points=coarse_min,
            mesh_target_points=4 * coarse_min,
            mesh=dc.replace(cfg.mesh, bucket_rounding=256),
            solver=dc.replace(scfg, bootstrap=scfg.beta_passes >= 2,
                              cheb_degree=max(100, scfg.cheb_degree // 2),
                              cheb_passes=2, beta_passes=coarse_bp))
        try:
            # walk refinement DOWN until the mesh is genuinely coarser
            # than the fine grid (the config's min-points only refines
            # upward)
            grid_c = None
            fallback = None
            if scfg.beta_passes == 1:
                # fast mode: final accuracy is set by the single fine
                # pass, not the seed — take the cheapest coarse grid
                for ref_c in (0.4, 0.3):
                    ccfg = dc.replace(coarse_cfg, mesh_min_points=500,
                                      mesh_target_points=2000)
                    cand = MeshGenerator.generate(g0, ref_c, ccfg)
                    if cand.n_dofs <= n // 3:
                        grid_c = cand
                        break
            if grid_c is None:
                for ref_c in (0.5, 0.4, 0.3, 0.25):
                    cand = MeshGenerator.generate(g0, ref_c, coarse_cfg)
                    if cand.n_dofs <= n // 3:
                        grid_c = cand
                        break
                    if cand.n_dofs * 2.2 <= n and (
                            fallback is None
                            or cand.n_dofs < fallback.n_dofs):
                        fallback = cand
            if grid_c is None:
                grid_c = fallback
            if grid_c is None:
                return None
            results_c = cls.solve_sweep(geometries, grid_c,
                                        n_modes_target, coarse_cfg,
                                        _raw_modes=True, X0=coarse_X0,
                                        mesh=mesh)
        except (ValueError, QhullError, np.linalg.LinAlgError,
                torch.linalg.LinAlgError) as e:
            # the bootstrap only accelerates; a failed coarse solve
            # falls back to a random start
            logger.warning("bootstrap solve failed (%s); random init", e)
            return None
        if not any(results_c):
            return None

        _, (Pcols, Pwts) = _prolongation_cached(grid_c, dg, dev)
        nc = grid_c.n_dofs
        # Seed only HALF the columns from the coarse modes: the prolonged
        # columns share the prolongation's error directions, so the random
        # half carries independent directions for the pooled f64 polish;
        # seeded columns get a 5% random blend (a Chebyshev filter can
        # only SHRINK a span).
        Hc = np.zeros((B, 3, nc, k), dtype=np.float32)
        colmask = np.zeros((B, k), dtype=np.float32)
        betas0 = np.zeros(B)
        used = np.zeros(B, dtype=bool)
        for b, ms in enumerate(results_c):
            nm = min(len(ms), max(k // 2, k - 8))
            if nm == 0:
                continue                 # unseeded -> unit random cols
            for j, mode in enumerate(ms[:nm]):
                Hc[b, 0, :, j] = mode["Ex_dofs"]
                Hc[b, 1, :, j] = mode["Ey_dofs"]
                Hc[b, 2, :, j] = mode["Hz_dofs"]
            colmask[b, :nm] = 1.0
            betas0[b] = float(np.median([m["beta"] for m in ms]))
            used[b] = True
        X0 = _seed_from_coarse(Hc, colmask, Pcols, Pwts, dev,
                               generator=generator, noise=noise)
        return X0, betas0, used

    # -- same-grid sweep (no reference analog: BASELINE config 2) -------
    @classmethod
    def solve_sweep(cls, geometries, grid, n_modes_target: int = 20,
                    config: Optional[SimulationConfig] = None,
                    _raw_modes: bool = False,
                    diag_out: Optional[Dict[int, str]] = None,
                    X0=None, noise=None, coarse_X0=None, mesh=None):
        """Solve B same-grid designs in one packed device sweep.

        All geometries must share the mesh; they may differ in
        wavelength, n_core, n_clad and (within the mesh's interface-band
        resolution) core radii. The Chebyshev filter runs once with all
        designs packed along the lane axis; the host f64 polish
        instantiates each design's CSR data from a shared linear-
        coefficient family. Returns a list of mode lists, one per
        geometry.

        ``diag_out``: optional dict that receives the per-design
        diagnostics of THIS call (design index -> message).

        ``X0`` (3Dp, B, k): optional start subspace (numpy or tensor),
        or a function of that shape returning one; given, it replaces
        both the random start and the bootstrap.
        ``noise``: optional (R1, R2) standard-normal (3Dp, B, k) blocks
        for the bootstrap seed's blend. ``coarse_X0``: the bootstrap's
        coarse sweep's ``X0``, in the same forms on the coarse grid (a
        function, since the coarse grid is chosen inside). These exist so
        that tests can feed this package and the JAX package the same
        numbers; by default they come from a ``torch.Generator`` seeded
        with ``SolverConfig.seed``.

        ``mesh``: an optional ``parallel.DesignMesh`` of devices of
        ``SolverConfig.device``'s type; the filter's design axis splits
        over it (``kernels.solve_lowest_sweep``). A mesh larger than B
        shrinks to B slices (to none at B = 1), and a B that does not
        divide over it is padded with the last design, whose extra
        results are dropped. The set-up (assembly, bounds, start block,
        bootstrap seed) and the host polish stay on
        ``SolverConfig.device``.

        Safe to call from several threads at once (the dataset engine's
        bucket pipeline): the device-memory budget is shared among them.
        """
        dev = _device_of(config or SimulationConfig())
        with _sweep_running(), _on_device(dev):
            return cls._solve_sweep(geometries, grid, n_modes_target,
                                    config, _raw_modes, diag_out, X0, noise,
                                    coarse_X0, mesh)

    @classmethod
    def _solve_sweep(cls, geometries, grid, n_modes_target, config,
                     _raw_modes, diag_out, X0, noise, coarse_X0, mesh):
        from ..utils import PhaseTimer, span

        timer = PhaseTimer()
        cls.last_sweep_times = timer.times
        cfg = config or SimulationConfig()
        scfg = cfg.solver
        dev = _device_of(cfg)
        dg = _as_device_grid(grid, cfg)
        g0 = geometries[0]
        B = len(geometries)
        n = dg.n_dofs
        Dp = dg.n_dofs_padded

        # diagnostic mode (config.debug_checks): screen non-finite
        # geometry inputs up front. A NaN design packed into the sweep
        # poisons the shared convergence gate (max over designs), so bad
        # designs are excluded, diagnosed, and the healthy subset solves.
        diags: Dict[int, str] = diag_out if diag_out is not None else {}
        diags.clear()
        cls.last_sweep_diagnostics = diags
        if scfg.debug_checks:
            for bix, g in enumerate(geometries):
                ep = g.eps_params()
                bad = [f.name for f in dataclasses.fields(ep)
                       if not np.all(np.isfinite(np.asarray(
                           getattr(ep, f.name), dtype=np.float64)))]
                if not np.isfinite(g.k0):
                    bad.append("k0")
                if bad:
                    diags[bix] = ("non-finite geometry inputs: "
                                  + ", ".join(bad))
            if diags:
                logger.warning("debug_checks: %d/%d designs have "
                               "non-finite inputs: %s", len(diags), B,
                               diags)
                good = [i for i in range(B) if i not in diags]
                pre = dict(diags)
                results = [[] for _ in range(B)]
                if good:
                    sub_d: Dict[int, str] = {}
                    sub = cls.solve_sweep([geometries[i] for i in good],
                                          dg, n_modes_target, cfg,
                                          _raw_modes=_raw_modes,
                                          diag_out=sub_d, mesh=mesh)
                    for j, i in enumerate(good):
                        results[i] = sub[j]
                        if j in sub_d:
                            pre[i] = sub_d[j]
                diags.clear()
                diags.update(pre)
                cls.last_sweep_diagnostics = diags
                return results

        if mesh is not None and mesh.size > 1:
            if any(d.type != dev.type for d in mesh.devices):
                raise ValueError(f"design mesh {[str(d) for d in mesh.devices]}"
                                 f" does not match SolverConfig.device "
                                 f"{dev}")
            if B < mesh.size:
                # padding a narrow sweep up to the whole mesh multiplies
                # the work on each slice instead of dividing it
                mesh = design_mesh(mesh.devices[:B]) if B > 1 else None
        if mesh is not None and mesh.size > 1:
            if B % mesh.size:
                pad = mesh.size - B % mesh.size
                sub_d = {}
                out = cls.solve_sweep(
                    list(geometries) + [geometries[-1]] * pad, dg,
                    n_modes_target, cfg, _raw_modes=_raw_modes,
                    diag_out=sub_d, X0=_pad_designs(X0, B, pad),
                    noise=None if noise is None else tuple(
                        _pad_designs(r, B, pad) for r in noise),
                    coarse_X0=_pad_designs(coarse_X0, B, pad), mesh=mesh)
                diags.update({i: m for i, m in sub_d.items() if i < B})
                cls.last_sweep_diagnostics = diags
                return out[:B]
        else:
            mesh = None

        # device-memory guard: split a sweep whose packed filter state
        # would not fit into sub-sweeps
        k_est = min(n_modes_target + scfg.extra_vectors, n)
        b_max = _designs_per_sweep(dev, dg.elem_dofs.shape[0], Dp, k_est,
                                   mesh)
        if B > b_max:
            if any(a is not None for a in (X0, noise, coarse_X0)):
                raise ValueError("X0/noise/coarse_X0 cannot be split across "
                                 "sub-sweeps; pass fewer designs")
            out = []
            for s in range(0, B, b_max):
                sub_d = {}
                out.extend(cls.solve_sweep(geometries[s:s + b_max], dg,
                                           n_modes_target, cfg,
                                           _raw_modes=_raw_modes,
                                           diag_out=sub_d, mesh=mesh))
                for j, m in sub_d.items():
                    diags[s + j] = m
            cls.last_sweep_diagnostics = diags
            return out

        gen = torch.Generator(device=dev)
        gen.manual_seed(scfg.seed)

        # two-grid bootstrap: coarse solve -> X0 + per-design beta0
        boot = None
        if X0 is None and scfg.bootstrap and n >= scfg.bootstrap_min_dofs:
            with timer.phase("bootstrap"):
                boot = cls._bootstrap_sweep(geometries, dg, n_modes_target,
                                            cfg, gen, noise=noise,
                                            coarse_X0=coarse_X0, mesh=mesh)

        with timer.phase("assemble"):
            ga = grid_to_device(dg, dev)
            gs = gather_scatter(ga)
            # 1/eps of every design in one batched K6 launch, and the one
            # mass diagonal (it depends on the quadrature weights alone)
            qs, diag = assemble_vector3_sweep(
                ga, gs, [eps_arrays(g.eps_params(), dev)
                         for g in geometries])

        betas = np.array([
            g.k0 * lp01_neff_estimate(g.k0, float(np.mean(g.core_radii)),
                                      g.n_core, g.n_clad)
            for g in geometries])
        # bootstrapped solves still honor beta_passes: the second outer
        # round's refilter + pooled polish is what removes the prolonged
        # subspace's angle error.
        beta_passes_eff = max(1, scfg.beta_passes)
        # AUTO B^{-1} depth: 1 in bootstrapped fast mode (binv only
        # steers the warm prolonged subspace), 4 everywhere else (a cold
        # random start does not converge with binv=1).
        binv_eff = scfg.binv_degree
        if binv_eff is None:
            binv_eff = 1 if (beta_passes_eff == 1
                             and boot is not None) else 4
        if boot is not None:
            _, betas_c, used_c = boot
            betas = np.where(used_c, betas_c, betas)
        cuts = np.array([min(b**2 / g.n_clad**2, 1.35 * g.k0**2)
                         for b, g in zip(betas, geometries)])
        parks = 10.0 * np.maximum(cuts, 1.0)

        # Per-design spectrum bounds: sweep members may differ in
        # n_core/n_clad/wavelength, so one design's Gershgorin bound can
        # undershoot another's true spectral radius. One K8 launch bounds
        # A(beta_b) of every design from the quadrature factors.
        with timer.phase("bounds"):
            bounds = pencil_bounds_sweep(qs, ga.shape_vals, ga.elem_valid,
                                         betas, scfg.alpha_penalty)
            # 1.1x margin covers the beta drift across beta passes
            bounds = bounds.cpu().numpy() * 1.1

        with timer.phase("host_family"):
            if B == 1:
                # one-off single design: skip the 3x-cost family
                # precompute; conform matches the family path's 'deform'
                # correction on a foreign (bucket-class) grid
                hv_single = build_host_vector3(
                    dg, g0.eps_params(), scfg.alpha_penalty,
                    conform=(scfg.member_correction == "deform"))
                family = None
            else:
                family = build_host_vector3_family(dg, g0.eps_params(),
                                                   scfg.alpha_penalty)
        mask3 = np.tile(dg.interior_mask[:n], 3).astype(np.float64)
        k = min(n_modes_target + scfg.extra_vectors, n)
        if boot is not None:
            X = boot[0]
            cheb_passes_eff = max(1, scfg.bootstrap_fine_passes)
        else:
            if X0 is None:
                X = torch.randn((3 * Dp, B, k), generator=gen, device=dev,
                                dtype=torch.float32)
            else:
                if callable(X0):
                    X0 = X0((3 * Dp, B, k))
                X = torch.tensor(np.asarray(X0, dtype=np.float32),
                                 device=dev)
            cheb_passes_eff = scfg.cheb_passes
        pooled = [None] * B

        # per-design host pencils: lazy views over the shared family
        hv_cache: list = [None] * B

        def _hv(bix):
            if hv_cache[bix] is None:
                g = geometries[bix]
                hv_cache[bix] = hv_single if family is None else \
                    family.design_view(g.n_core**2, g.n_clad**2,
                                       eps_params=g.eps_params(),
                                       correction=scfg.member_correction)
            return hv_cache[bix]

        results = [[] for _ in range(B)]
        # beta_passes is the MINIMUM round count; when >= 2 (accuracy
        # mode) the qres gate may extend up to max_rounds until the
        # polished roots certify, with a stall detector. Convergence is
        # tracked PER DESIGN: later rounds re-filter only the still-
        # active subset.
        max_rounds = _max_rounds(beta_passes_eff, scfg.qres_max_rounds)
        prev_q = np.full(B, np.inf)
        active = list(range(B))
        Xact = X                      # (3Dp, |sel|, k) active subspace
        sel = list(range(B))          # design index of each Xact column
        for ip in range(max_rounds):
            # one span a round: its filter, transfer, polish and
            # post-processing (sweep.beta_rounds_per_design counts them)
            with span("beta_round"):
                # residual gate only on the modes the caller needs
                n_gate = min(k, n_modes_target + 4)
                # fast mode with a bootstrap seed hard-caps the in-round
                # passes at bootstrap_fine_passes
                mp = max(1, scfg.bootstrap_fine_passes) \
                    if (boot is not None and beta_passes_eff == 1) else 8
                # a small beta jitter between rounds decorrelates the f32
                # filter's subspace-error directions so the pooled polish
                # cancels them
                _jit = (0.0, 2e-3, -2e-3, 4e-3, -4e-3, 6e-3)[ip % 6]
                qs_act = qs if len(sel) == B else \
                    qs._replace(inv_eps=qs.inv_eps[torch.as_tensor(
                        sel, device=dev)].contiguous())
                with timer.phase("filter"):
                    theta, Xr, res = solve_lowest_sweep(
                        qs_act, gs, ga.interior_mask, diag, Xact, cuts[sel],
                        betas[sel] * (1.0 + _jit),
                        scfg.alpha_penalty, bounds[sel],
                        degree=scfg.cheb_degree,
                        passes=cheb_passes_eff, tol=scfg.scalar_tol,
                        parks=parks[sel], n_wanted=n_gate, max_passes=mp,
                        binv_degree=binv_eff, mesh=mesh)
                with timer.phase("xfer"):
                    Xr_host = Xr.cpu().numpy()
                beta_new = betas.copy()
                qnow = {}
                for j, bix in enumerate(active):
                    g = geometries[bix]
                    Xh = np.asarray(Xr_host[:, j, :], dtype=np.float64)
                    if scfg.debug_checks and not np.isfinite(Xh).all():
                        # diagnosed, not a garbage beta: the design leaves
                        # the sweep with an empty mode list and a message
                        diags[bix] = (f"non-finite filter subspace at round "
                                      f"{ip} (filter diverged or NaN inputs "
                                      f"reached assembly)")
                        logger.warning("debug_checks: design %d: %s", bix,
                                       diags[bix])
                        results[bix] = []
                        pooled[bix] = None
                        continue
                    Xh = np.concatenate(
                        [Xh[c * Dp:c * Dp + n] for c in range(3)],
                        axis=0) * mask3[:, None]
                    pooled[bix] = Xh if pooled[bix] is None else \
                        np.concatenate([pooled[bix], Xh], axis=1)
                    with timer.phase("host_family"):
                        hv = _hv(bix)
                    with timer.phase("polish"):
                        bts, H, _, qres = quadratic_subspace(
                            hv, pooled[bix], g.k0,
                            g.k0 * g.n_clad * (1 + 1e-9),
                            g.k0 * g.n_core * 1.01, mask=mask3)
                    if len(bts) > k:
                        # keep the k best-converged roots (ARPACK returns
                        # exactly k = n + 12, solver_fem.py:196)
                        keep = np.argsort(qres)[:k]
                        keep = keep[np.argsort(-bts[keep])]
                        bts, H, qres = bts[keep], H[:, keep], qres[keep]
                    if len(bts):
                        qnow[bix] = float(qres[:n_modes_target].max())
                        beta_new[bix] = float(np.median(bts))
                        hx, hy, hz = H[:n], H[n:2 * n], H[2 * n:]
                        if _raw_modes:
                            # subspace-seed consumers (two-grid bootstrap)
                            # need only fields + beta
                            order = np.argsort(-bts)
                            results[bix] = [
                                {"beta": float(bts[i]),
                                 "n_eff": float(bts[i]) / g.k0,
                                 "Ex_dofs": hx[:, i], "Ey_dofs": hy[:, i],
                                 "Hz_dofs": hz[:, i]}
                                for i in order]
                            continue
                        solver = cls(g, config=cfg)
                        with timer.phase("postproc"):
                            results[bix] = solver._postprocess(
                                hv, dg, bts, hx, hy, hz, n_modes_target)
                # Per-design continue/exit: a design keeps iterating while
                # EITHER its beta still moves OR its polished roots'
                # full-space quadratic residual is above tolerance, with a
                # per-design stall detector.
                still = []
                for bix in active:
                    if bix in diags:
                        continue
                    q_b = qnow.get(bix, np.inf)
                    beta_stable = abs(beta_new[bix] - betas[bix]) <= 1e-6
                    converged = beta_stable and q_b <= scfg.polish_qres_tol
                    stalled = beta_stable and q_b > 0.7 * prev_q[bix]
                    prev_q[bix] = q_b
                    if not converged and not stalled:
                        still.append(bix)
                logger.debug("sweep round %d: active %d -> %d, qworst=%.2e "
                             "dbeta=%.2e", ip, len(active), len(still),
                             max(qnow.values()) if qnow else np.inf,
                             np.abs(beta_new - betas).max())
                if ip + 1 >= max_rounds or not still:
                    break
                betas = beta_new
                cuts = np.array([min(b**2 / g.n_clad**2, 1.35 * g.k0**2)
                                 for b, g in zip(betas, geometries)])
                parks = 10.0 * np.maximum(cuts, 1.0)
                col_of = {bix: j for j, bix in enumerate(sel)}
                active = still
                sel = _pad_active(active, B, mesh)
                cols = torch.as_tensor([col_of[bix] for bix in sel],
                                       device=dev)
                Xact = Xr[:, cols, :]
        # the bootstrap's nested solve_sweep re-binds the hooks; restore
        # this (outermost) call's breakdown before returning
        cls.last_sweep_times = timer.times
        cls.last_sweep_diagnostics = diags
        logger.debug("sweep B=%d n=%d: %s", B, n, timer.summary())
        return results

    # -- shared post-processing (solver_fem.py:199-239), host f64 -------
    def _postprocess(self, hv: HostVector3, dg: DeviceGrid, betas,
                     hx, hy, hz, n_modes_target: int) -> List[Dict]:
        g = self.geometry
        if len(betas) == 0:
            return []

        # normalize transverse energy (solver_fem.py:213)
        nrm = np.sqrt(np.sum(hx**2, axis=0) + np.sum(hy**2, axis=0)) + 1e-300
        hx = hx / nrm
        hy = hy / nrm
        if hz is not None:
            hz = hz / nrm

        # divergence energy ratio (solver_fem.py:214-215)
        div_energy = (np.sum(hx * spmm(hv.Dxx, hx), axis=0)
                      + 2.0 * np.sum(hx * spmm(hv.Dxy, hy), axis=0)
                      + np.sum(hy * spmm(hv.Dyy, hy), axis=0))
        div_ratio = div_energy / np.maximum(betas**2, 1e-12)

        # PML radiation damping: first-order perturbation of the real-eps
        # eigenproblem by i*Im(eps), Im(beta^2) = k0^2 <h|Im eps|h> /
        # <h|M|h> on the transverse intensity; Im beta = Im(beta^2) /
        # (2 beta).
        if hv.Mim is not None:
            num = (np.sum(hx * spmm(hv.Mim, hx), axis=0)
                   + np.sum(hy * spmm(hv.Mim, hy), axis=0))
            Mh = hv.M3[:hx.shape[0], :hx.shape[0]]
            den = (np.sum(hx * spmm(Mh, hx), axis=0)
                   + np.sum(hy * spmm(Mh, hy), axis=0))
            beta_im = (self.k0**2 * num / np.maximum(den, 1e-300)
                       / np.maximum(2.0 * betas, 1e-300))
        else:
            beta_im = np.zeros_like(betas)

        n = dg.n_dofs
        xy = dg.dof_coords[:n]
        pos = np.asarray(g.positions)
        rad = np.asarray(g.core_radii)
        d2 = ((xy[:, 0:1] - pos[None, :, 0]) ** 2
              + (xy[:, 1:2] - pos[None, :, 1]) ** 2)
        core = np.any(d2 <= rad[None, :] ** 2, axis=1)
        interior = dg.interior_mask[:n]
        frac_core = (core & interior).sum() / max(interior.sum(), 1)

        energy = hx**2 + hy**2
        tot = energy.sum(axis=0) + 1e-300
        conf = np.clip(energy[core].sum(axis=0) / tot, 0.0, 1.0)

        # in-core powers with whole-domain fallback (solver_fem.py:88-97)
        core_m = core if core.any() else interior
        P_x = (hx**2)[core_m].sum(axis=0) + 1e-300
        P_y = (hy**2)[core_m].sum(axis=0) + 1e-300
        pdl, pidx = polarization_from_powers(P_x, P_y)

        ne = betas / self.k0
        modes_raw: List[Dict] = []
        for i in range(len(betas)):
            if ne[i] <= g.n_clad or ne[i] >= g.n_core * 1.01:
                continue
            m = {
                "n_eff": float(ne[i]),
                "beta": float(betas[i]),
                "beta_im": float(beta_im[i]),
                "Ex_dofs": hx[:, i].copy(),
                "Ey_dofs": hy[:, i].copy(),
                "P_x": float(P_x[i]),
                "P_y": float(P_y[i]),
                "PDL_dB": float(pdl[i]),
                "polarization": polarization_label(pidx[i]),
                "confinement": float(conf[i]),
                "core_overlap": float(conf[i]),
                "div_ratio": float(div_ratio[i]),
                "is_vectorial": True,
                "method": self.METHOD_TAG,
            }
            if hz is not None:
                m["Hz_dofs"] = hz[:, i].copy()
            modes_raw.append(m)
        if not modes_raw:
            return []

        # divergence filter (solver_fem.py:228-231)
        dr = np.array([m["div_ratio"] for m in modes_raw])
        dr_thresh = max(np.median(dr) * 10, dr.min() * 50, 1e-6)
        modes_phys = [m for m in modes_raw if m["div_ratio"] <= dr_thresh]

        # radiation filter (solver_fem.py:234-236)
        conf_thr = max(5.0 * frac_core, 0.05)
        modes_guided = [m for m in modes_phys if m["confinement"] >= conf_thr]
        if not modes_guided:
            modes_guided = modes_phys

        modes_guided.sort(key=lambda m: -m["n_eff"])
        return modes_guided
