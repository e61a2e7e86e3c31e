"""Scalar Helmholtz eigenmode solver.

Port of pl_fem_tpu/solvers/scalar.py. Pencil (K - k0^2 M_eps) psi =
lambda M psi with lambda = -beta^2 (the reference's
solver_fem.py:245-276). Guided modes are the *smallest* eigenvalues of
the pencil (lambda in [-k0^2 eps_core, -k0^2 eps_clad)), so the device
backend needs no shift-invert at all:

- device (float32): low-end Chebyshev subspace filter over matrix-free
  element-block operators (ops/kernels.py ``solve_lowest_kernel``) on
  ``SolverConfig.device``;
- host (float64): exact CSR Rayleigh-Ritz polish (ops/host_assembly.py)
  for final eigenvalue accuracy: a few SpMV, no factorization.

The hybrid backend runs the reference-identical scipy ``eigsh``
shift-invert on the host CSR (solver_fem.py:260-261): parity oracle
and CPU fallback.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import SimulationConfig
from ..ops.assembly import (
    GridArrays,
    assemble_scalar_system,
    eps_arrays,
    gather_scatter,
    grid_from_numpy,
    grid_to_device,
)
from ..ops.eig import scipy_eigsh_pencil
from ..ops.femgrid import DeviceGrid, MeshGenerator
from ..ops.host_assembly import HostScalarPencil, build_host_scalar
from ..ops.kernels import solve_lowest_kernel
from ..utils import PhaseTimer
from .postproc import confinement_from_dofs, in_core_mask
from .vectorial import _as_device_grid, _check_backend, _device_of

logger = logging.getLogger("pl_fem_tpu_torch.solvers.scalar")


@dataclasses.dataclass(frozen=True)
class ScalarPencil:
    """Assembled scalar pencil: f32 element blocks on the device."""

    ga: GridArrays
    A_blocks: torch.Tensor    # (E,6,6) K - k0^2 M_eps  (float32)
    B_blocks: torch.Tensor    # (E,6,6) mass
    diag_B: torch.Tensor      # (D,) float32 assembled mass diagonal
    n_dofs: int               # valid DOF count
    k0: float
    # () float32 spectrum bound of (A, B) from the assembly; None: the
    # solve bounds the blocks itself (pencil_bounds_elem)
    bound: Optional[torch.Tensor] = None


def build_scalar_pencil(dg: DeviceGrid, eps_params, k0: float,
                        device) -> ScalarPencil:
    """Assemble the scalar pencil's element blocks and spectrum bound on
    ``device`` (one K11 launch, and K2 for the mass diagonal)."""
    ga = grid_to_device(dg, device)
    A, B, diag, bound = assemble_scalar_system(
        ga, eps_arrays(eps_params, device), np.float32(k0))
    return ScalarPencil(ga=ga, A_blocks=A, B_blocks=B, diag_B=diag,
                        n_dofs=dg.n_dofs, k0=k0, bound=bound)


def scalar_pencil_from_numpy(dg_like, A_blocks, B_blocks, diag_B, k0: float,
                             device) -> ScalarPencil:
    """A ScalarPencil of f32 tensors on ``device`` from numpy arrays: the
    grid fields of ``dg_like`` (any object carrying the DeviceGrid
    arrays) and assembled blocks A (E,6,6), B (E,6,6), diag_B (D,). The
    tests hand the JAX package's assembled pencil to
    ``solve_lowest_kernel`` this way. It carries no bound: the solve
    bounds the blocks (K8)."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    return ScalarPencil(ga=grid_from_numpy(dg_like, device),
                        A_blocks=t(A_blocks), B_blocks=t(B_blocks),
                        diag_B=t(diag_B), n_dofs=int(dg_like.n_dofs),
                        k0=float(k0))


def solve_pencil_lowest(pencil: ScalarPencil, X0, cut: float, **kw):
    """``solve_lowest_kernel`` on an assembled scalar pencil (C = 1, the
    valid-DOF mask, the grid's quadrature weights for the mass applies,
    the pencil's own bound where it carries one). Returns theta (k,),
    Xr (D, k) and res (k,)."""
    ga = pencil.ga
    return solve_lowest_kernel(
        pencil.A_blocks, pencil.B_blocks, gather_scatter(ga), ga.dof_valid,
        pencil.diag_B, X0, cut, ga.elem_valid, ga.qp_w, C=1,
        bound=pencil.bound, **kw)


class ScalarHelmholtzSolver:
    """Scalar Helmholtz solver (reference seam: solver_fem.py:245-276).

    ``solve`` accepts a host FEMGrid or exported DeviceGrid (or None to
    mesh the geometry) and returns the reference mode-dict schema:
    n_eff, beta, field_vector, confinement, core_overlap, PDL_dB=0,
    polarization='scalar', is_vectorial=False.

    ``last_solve_times`` holds the wall-clock phases of this solver's
    most recent ``solve`` (host_build / assemble / filter / xfer / polish
    on the device backend, host_build / arpack on the hybrid one, then
    postproc and cascade).
    """

    def __init__(self, geometry, config: Optional[SimulationConfig] = None):
        self.geometry = geometry
        self.k0 = float(geometry.k0)
        self.config = config or SimulationConfig()
        self.last_solve_times: Dict[str, float] = {}

    # -- public API ----------------------------------------------------------
    def solve(self, grid=None, n_modes_target: int = 20,
              mode_filter: str = "none", X0=None) -> List[Dict]:
        """Solve for guided modes.

        ``mode_filter='cascade'`` applies the reference CLI's guided-mode
        selection (main.py:209-288): quadrature-exact loose/strict core
        masses give confinement and core_overlap, then the threshold
        cascade 0.85 -> 0.70 -> 0.50 -> 0.30 -> unfiltered with
        OVERLAP_MIN 0.80 and a top-3N cap. Default 'none' matches the
        library-path ScalarHelmholtzSolver (solver_fem.py:245-276).

        ``X0`` (D_padded, k): optional start subspace of the device
        backend (numpy or tensor), so that tests can feed this package
        and the JAX package the same numbers; by default it is drawn
        from a ``torch.Generator`` seeded with ``SolverConfig.seed``.
        """
        cfg = self.config
        _check_backend(cfg)
        hybrid = cfg.solver.backend == "hybrid"
        dev = None if hybrid else _device_of(cfg)   # hybrid: host only
        if grid is None:
            grid = MeshGenerator.generate(self.geometry,
                                          cfg.mesh.refinement, cfg)
        dg = _as_device_grid(grid, cfg)
        timer = PhaseTimer()
        self.last_solve_times = timer.times
        with timer.phase("host_build"):
            host = build_host_scalar(dg, self.geometry.eps_params(), self.k0)
        if hybrid:
            with timer.phase("arpack"):
                lam, V = self._solve_hybrid(host, dg, n_modes_target)
        else:
            lam, V = self._solve_device(host, dg, n_modes_target, dev, X0,
                                        timer)
        with timer.phase("postproc"):
            modes = self._modes_from_eigenpairs(host, dg, lam, V,
                                                n_modes_target)
        if mode_filter == "cascade":
            with timer.phase("cascade"):
                modes = self._cascade_filter(modes, dg, host)
        logger.debug("scalar solve n=%d: %s", dg.n_dofs, timer.summary())
        return modes

    # -- guided-mode cascade (main.py:205-288) -------------------------------
    def _cascade_filter(self, modes: List[Dict], dg: DeviceGrid,
                        host: HostScalarPencil) -> List[Dict]:
        from ..ops.host_assembly import _flat, _wsum_np, scalar_pattern

        if not modes:
            return modes
        g = self.geometry
        x = dg.qp_xy[..., 0]
        y = dg.qp_xy[..., 1]
        pos = np.asarray(g.positions)
        rad = np.asarray(g.core_radii)
        Nq = np.broadcast_to(dg.shape_vals[None], dg.qp_w.shape + (6,))
        spat = scalar_pattern(dg)

        def core_mass(factor):
            d2 = ((x[..., None] - pos[:, 0]) ** 2
                  + (y[..., None] - pos[:, 1]) ** 2)
            w = np.any(d2 <= (factor * rad) ** 2, axis=-1).astype(float)
            return spat.with_blocks(
                _flat(_wsum_np(dg.qp_w, w, Nq, Nq), dg.n_elems))

        Ml = core_mass(1.10)     # loose -> confinement (main.py:209-214)
        Ms = core_mass(1.00)     # strict -> core_overlap (main.py:217-222)
        for m in modes:
            v = m["field_vector"]
            denom = float(v @ (host.B @ v)) + 1e-20
            m["confinement"] = float(np.clip(v @ (Ml @ v) / denom, 0.0, 1.0))
            m["core_overlap"] = float(np.clip(v @ (Ms @ v) / denom, 0.0, 1.0))

        # threshold cascade (main.py:258-288)
        N = g.n_cores
        OVERLAP_MIN = 0.80

        def ok(m, thr):
            return (m["confinement"] >= thr
                    and m["core_overlap"] >= OVERLAP_MIN)

        kept = [m for m in modes if ok(m, 0.85)]
        if len(kept) < N:
            for thr in (0.70, 0.50, 0.30):
                alt = [m for m in modes if ok(m, thr)]
                if len(alt) >= N:
                    kept = alt
                    logger.warning("confinement threshold relaxed to %.2f "
                                   "(%d modes)", thr, len(alt))
                    break
            else:
                kept = sorted(modes, key=lambda m: m["confinement"],
                              reverse=True)
                logger.warning("overlap filter disabled (last resort)")
        kept.sort(key=lambda m: m["confinement"], reverse=True)
        kept = kept[: 3 * N]
        kept.sort(key=lambda m: m["n_eff"], reverse=True)
        return kept

    # -- backends ------------------------------------------------------------
    def _solve_device(self, host: HostScalarPencil, dg: DeviceGrid,
                      n_modes_target: int, dev: torch.device, X0,
                      timer: PhaseTimer):
        scfg = self.config.solver
        g = self.geometry
        with timer.phase("assemble"):
            pencil = build_scalar_pencil(dg, g.eps_params(), self.k0, dev)
        D = dg.n_dofs_padded
        n = dg.n_dofs
        k = min(n_modes_target + scfg.extra_vectors, max(n - 4, 1))
        window = self.k0**2 * max(g.n_core**2 - g.n_clad**2, 1e-6)
        cut = -(self.k0 * g.n_clad) ** 2 + 0.02 * window

        if X0 is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(scfg.seed)
            X0 = torch.randn((D, k), generator=gen, device=dev,
                             dtype=torch.float32)
        with timer.phase("filter"):
            theta, X, res = solve_pencil_lowest(
                pencil, X0, cut, degree=scfg.cheb_degree,
                passes=scfg.cheb_passes, tol=scfg.scalar_tol, park=1.0,
                n_wanted=k)
        with timer.phase("xfer"):
            Xh = X.cpu().numpy().astype(np.float64)[:n]
        # float64 host polish on the filtered subspace
        with timer.phase("polish"):
            lam, V, _ = host.rr(Xh)
        Vp = np.zeros((D, V.shape[1]))
        Vp[:n] = V
        return lam, Vp

    def _solve_hybrid(self, host: HostScalarPencil, dg: DeviceGrid,
                      n_modes_target: int):
        n = dg.n_dofs
        sigma = -(self.k0 * (self.geometry.n_core - 0.008)) ** 2
        k = min(n_modes_target + 8, n - 4)
        lam, V = scipy_eigsh_pencil(host.A, host.B, k=k, sigma=sigma,
                                    tol=1e-6, maxiter=6000)
        Vp = np.zeros((dg.n_dofs_padded, V.shape[1]))
        Vp[:n] = V
        return lam, Vp

    # -- post-processing -----------------------------------------------------
    def _modes_from_eigenpairs(self, host: HostScalarPencil, dg: DeviceGrid,
                               lam: np.ndarray, V: np.ndarray,
                               n_modes_target: int) -> List[Dict]:
        g = self.geometry
        n = dg.n_dofs
        order = np.argsort(lam)
        lam = lam[order]
        V = V[:, order]

        # guided window (solver_fem.py:266-268)
        neg = lam < 0
        ne = np.sqrt(np.maximum(-lam, 0.0)) / self.k0
        keep = neg & (ne > g.n_clad) & (ne < g.n_core * 1.005)
        if not np.any(keep):
            return []
        lam, ne, V = lam[keep], ne[keep], V[:, keep]

        # M-normalize (solver_fem.py:269)
        Vn = V[:n]
        MV = host.B @ Vn
        nrm = np.sqrt(np.maximum(np.sum(Vn * MV, axis=0), 1e-300))
        Vn = Vn / nrm

        core = in_core_mask(dg.dof_coords[:n], g.positions, g.core_radii)
        conf = confinement_from_dofs(Vn**2, core)

        modes: List[Dict] = []
        for i in range(Vn.shape[1]):
            modes.append({
                "n_eff": float(ne[i]),
                "beta": float(self.k0 * ne[i]),
                "field_vector": np.asarray(Vn[:, i]),
                "confinement": float(conf[i]),
                "core_overlap": float(conf[i]),
                "PDL_dB": 0.0,
                "polarization": "scalar",
                "is_vectorial": False,
            })
        modes.sort(key=lambda m: m["n_eff"], reverse=True)
        return modes[: max(3 * n_modes_target, n_modes_target)]
