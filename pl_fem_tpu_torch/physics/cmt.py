"""Coupled-mode-theory taper propagation.

Port of pl_fem_tpu/physics/cmt.py (capability parity with the
reference's config.py:34-393, its misnamed ``cmt.py``): dA/dz = -i H(z) A
with H = diag(beta) + C, piecewise matrix-exponential stepping, an
adaptive RK45 option, mux/demux direction handling, approximate
(|<Ei,Ej>| * 1e-3) and rigorous ((omega/4) int d_eps Em* En / sqrt(Pm
Pn)) coupling, the power-conservation check and the |d beta/dz| /
|delta beta|^2 adiabaticity criterion.

The piecewise path exponentiates every segment at once
(``torch.linalg.matrix_exp`` over the (S, M, M) complex128 stack) and
then steps the amplitudes through them. M is the guided-mode count of
one design (at most ~60), so the propagation runs in float64/complex128
on ``HOST`` (the CPU) by design; the local modes it consumes come from
the device sweep. The adaptive path, the adiabaticity scan and the
rigorous-coupling weight matrix are host numpy/scipy, as in the JAX
package.
"""
from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch

logger = logging.getLogger("pl_fem_tpu_torch.physics.cmt")

HOST = torch.device("cpu")


# ============================================================================
# cores
# ============================================================================

def coupling_offdiag(fields: torch.Tensor) -> torch.Tensor:
    """Approximate coupling magnitudes |<E_i, E_j>| * 1e-3 (config.py:243-256).

    fields: (D, M) stacked mode field vectors at one z position.
    Returns (M, M) with zero diagonal.
    """
    G = torch.abs(fields.conj().T @ fields) * 1e-3
    return G - torch.diag(torch.diagonal(G))


def propagate_scan(H_stack: torch.Tensor, dz: torch.Tensor,
                   A0: torch.Tensor):
    """A <- expm(-i H dz) A over the segment stack (config.py:124-161).

    Args:
        H_stack: (S, M, M) per-segment coupling matrices (complex).
        dz: (S,) segment lengths (<= 0 disables a segment).
        A0: (M,) initial complex amplitudes.

    Returns:
        (A_final, A_path (S+1, M), segment_losses (S,)).
    """
    U = torch.linalg.matrix_exp(-1j * H_stack * dz[:, None, None])
    A = A0
    path = [A0]
    losses = []
    for s in range(U.shape[0]):
        A_new = U[s] @ A if dz[s] > 0 else A
        p_before = torch.sum(torch.abs(A) ** 2)
        p_after = torch.sum(torch.abs(A_new) ** 2)
        losses.append(1.0 - p_after / (p_before + 1e-15))
        path.append(A_new)
        A = A_new
    losses = torch.stack(losses) if losses else \
        torch.zeros(0, dtype=dz.dtype, device=dz.device)
    return A, torch.stack(path), losses


# ============================================================================
# CoupledModeTheory (reference API)
# ============================================================================

class CoupledModeTheory:
    """CMT propagation along the taper (reference seam: config.py:34-122).

    MUX: MCF (N separated cores) -> MMF (N coupled supermodes);
    DEMUX: reversed z with uniformly re-normalized input amplitudes.
    """

    def __init__(self, omega: float, coupling_method: str = "approximate"):
        if coupling_method not in ("approximate", "rigorous"):
            raise ValueError(
                "coupling_method must be 'approximate' or 'rigorous'")
        self.omega = float(omega)
        self.coupling_method = coupling_method

    # ------------------------------------------------------------------
    def propagate_cmt(self, z_positions, local_modes_list: List[List[Dict]],
                      initial_amplitudes, direction: str = "mux",
                      use_adaptive: bool = False,
                      geometry=None, delta_eps_mass=None) -> Dict:
        z_pos = np.asarray(z_positions, dtype=float)
        modes_list = list(local_modes_list)
        A_init = np.asarray(initial_amplitudes, dtype=complex)

        if len(z_pos) != len(modes_list):
            raise ValueError(
                f"z_positions ({len(z_pos)}) and modes_list "
                f"({len(modes_list)}) must have the same length")

        if direction.lower() == "demux":
            z_pos = z_pos[::-1].copy()
            modes_list = modes_list[::-1]
            power_init = np.sum(np.abs(A_init) ** 2)
            if power_init > 1e-12:
                A_init = A_init / np.sqrt(power_init) * np.sqrt(len(A_init))

        n_modes = len(A_init)
        for i, modes in enumerate(modes_list):
            if len(modes) != n_modes:
                raise ValueError(
                    f"z[{i}]: {len(modes)} modes vs {n_modes} expected")

        if use_adaptive:
            result = self._propagate_adaptive(z_pos, modes_list, A_init,
                                              geometry, delta_eps_mass)
        else:
            result = self._propagate_piecewise(z_pos, modes_list, A_init,
                                               geometry, delta_eps_mass)

        A_final = result["amplitudes_final"]
        power_init = np.sum(np.abs(A_init) ** 2)
        power_final = np.sum(np.abs(A_final) ** 2)
        IL_dB = -10.0 * np.log10(power_final / (power_init + 1e-15))
        result.update({
            "IL_dB": float(IL_dB),
            "power_conservation": float(power_final / (power_init + 1e-15)),
            "direction": direction,
            "coupling_method": self.coupling_method,
        })
        return result

    # ------------------------------------------------------------------
    def _coupling_stack(self, modes_list, geometry, delta_eps_mass
                        ) -> np.ndarray:
        """(Z, M, M) complex coupling matrices for every z position."""
        H = np.stack([
            np.asarray(self._compute_coupling_matrix(
                modes, modes, geometry=geometry,
                delta_eps_mass=delta_eps_mass))
            for modes in modes_list])
        return H.astype(complex)

    def _propagate_piecewise(self, z_pos, modes_list, A_init,
                             geometry=None, delta_eps_mass=None) -> Dict:
        """Segment-wise exponential stepping (one batched matrix_exp)."""
        H = self._coupling_stack(modes_list[:-1], geometry, delta_eps_mass)
        dz = np.diff(z_pos)
        A_final, path, losses = propagate_scan(
            torch.as_tensor(H, device=HOST), torch.as_tensor(dz, device=HOST),
            torch.as_tensor(A_init, device=HOST))
        dz_ok = dz > 0
        return {
            "amplitudes_final": A_final.numpy(),
            "amplitudes_path": path.numpy(),
            "segment_losses": [float(l) for l, ok in
                               zip(losses.numpy(), dz_ok) if ok],
            "z_positions": z_pos,
        }

    def _propagate_adaptive(self, z_pos, modes_list, A_init,
                            geometry=None, delta_eps_mass=None) -> Dict:
        """Adaptive RK45 on host (config.py:163-206 semantics)."""
        from scipy.integrate import solve_ivp

        H_stack = self._coupling_stack(modes_list, geometry, delta_eps_mass)

        def ode(z, A_flat):
            idx = int(np.clip(np.searchsorted(z_pos, z, side="right") - 1,
                              0, len(modes_list) - 1))
            A = A_flat.view(complex)
            return (-1j * H_stack[idx] @ A).view(float)

        sol = solve_ivp(ode, t_span=(z_pos[0], z_pos[-1]),
                        y0=A_init.view(float), t_eval=z_pos,
                        method="RK45", rtol=1e-6, atol=1e-9)
        if not sol.success:
            logger.warning("solve_ivp: %s", sol.message)
        return {
            "amplitudes_final": sol.y[:, -1].copy().view(complex),
            "segment_losses": [],
            "z_positions": sol.t,
            "solver_status": sol.message,
        }

    # ------------------------------------------------------------------
    def _compute_coupling_matrix(self, modes_i: List[Dict],
                                 modes_j: List[Dict], geometry=None,
                                 delta_eps_mass=None) -> np.ndarray:
        """H = diag(beta) + C (config.py:208-272).

        'approximate': C_ij = |<E_i, E_j>| * 1e-3 — a conservative
        weak-coupling magnitude (the reference documents the 1e-3 as
        (omega/4c) * overlap * d_eps ~ 1e-3 beta at 1550 nm).
        'rigorous': FEM integral over ``delta_eps_mass`` (a CSR mass
        matrix weighted by eps - mean(eps); see
        :func:`delta_eps_mass_csr`); falls back to approximate when the
        matrix is unavailable.
        """
        n = len(modes_i)
        H = np.zeros((n, n), dtype=complex)
        for i in range(n):
            H[i, i] = modes_i[i]["beta"]
        if n < 2:
            return H

        fields = np.stack(
            [np.asarray(m["field_vector"]) for m in modes_i], axis=1)

        if self.coupling_method == "rigorous" and delta_eps_mass is not None:
            # fields may stack C components per mode ((C*D, M) with the
            # scalar (D, D) mass applied per component and summed) —
            # the full-transverse-field overlap of config.py:295-302.
            D = delta_eps_mass.shape[0]
            nc, rem = divmod(fields.shape[0], D)
            if rem or nc < 1:
                raise ValueError(
                    f"field length {fields.shape[0]} is not a multiple of "
                    f"the delta_eps_mass dimension {D}")
            P = np.real(np.einsum("dm,dm->m", fields.conj(), fields))
            C = np.zeros((n, n), dtype=complex)
            for c in range(nc):
                fc = fields[c * D:(c + 1) * D]
                C += fc.conj().T @ (delta_eps_mass @ fc)
            C = C * (self.omega / 4.0)
            C = C / np.sqrt(np.maximum(np.outer(P, P), 1e-15))
            C = C - np.diag(np.diag(C))
            H = H + C
        else:
            if self.coupling_method == "rigorous":
                logger.warning("rigorous coupling needs delta_eps_mass; "
                               "falling back to approximate")
            H = H + coupling_offdiag(torch.as_tensor(fields,
                                                     device=HOST)).numpy()
        return H

    # ------------------------------------------------------------------
    def verify_power_conservation(self, result: Dict,
                                  tolerance: float = 0.05) -> bool:
        conservation = result.get("power_conservation", 0.0)
        if abs(1.0 - conservation) > tolerance:
            logger.warning("power conservation weak: %.4f (tol %.2f)",
                           conservation, tolerance)
            return False
        return True

    def estimate_adiabaticity(self, z_positions,
                              modes_list: List[List[Dict]]) -> Dict:
        """|d beta/dz| / |delta beta|^2 > 0.1 violation scan
        (config.py:344-393)."""
        z_positions = np.asarray(z_positions, dtype=float)
        violations = []
        max_gradient = 0.0
        for i in range(len(z_positions) - 1):
            dz = z_positions[i + 1] - z_positions[i]
            if dz <= 0:
                continue
            modes_i = modes_list[i]
            modes_j = modes_list[i + 1]
            for m in range(len(modes_i)):
                d_beta_dz = abs((modes_j[m]["beta"] - modes_i[m]["beta"]) / dz)
                max_gradient = max(max_gradient, d_beta_dz)
                for n in range(m + 1, len(modes_i)):
                    delta_beta = abs(modes_i[m]["beta"] - modes_i[n]["beta"])
                    if delta_beta > 1e-6:
                        ratio = d_beta_dz / delta_beta**2
                        if ratio > 0.1:
                            violations.append({
                                "z": float(z_positions[i]),
                                "modes": (m, n),
                                "ratio": float(ratio),
                                "d_beta_dz": float(d_beta_dz),
                                "delta_beta": float(delta_beta),
                            })
        return {
            "n_violations": len(violations),
            "violations": violations[:10],
            "max_gradient": float(max_gradient),
            "is_adiabatic": len(violations) == 0,
        }


# ============================================================================
# rigorous-coupling weight matrix
# ============================================================================

def delta_eps_mass_csr(dg, eps_params):
    """CSR mass matrix weighted by (eps - mean eps) for rigorous coupling.

    Mirrors the reference's epsilon_product form (config.py:295-302) on
    the quadrature arrays; host f64 like the other polish operators.
    """
    from ..ops.host_assembly import (_flat, _wsum_np, eps_at_quadrature_np,
                                     scalar_pattern)

    eps_re, _ = eps_at_quadrature_np(dg, eps_params)
    delta = eps_re - float(np.mean(eps_re))
    Nq = np.broadcast_to(dg.shape_vals[None], dg.qp_w.shape + (6,))
    blocks = _wsum_np(dg.qp_w, delta, Nq, Nq)
    return scalar_pattern(dg).with_blocks(_flat(blocks, dg.n_elems))
