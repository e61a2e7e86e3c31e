"""The Chebyshev-filter eigensolvers (filter + Rayleigh-Ritz): the packed
same-grid sweep of the vectorial solver and the stacked-block solver of
the scalar Helmholtz pencil.

Port of pl_fem_tpu/ops/kernels.py. In the sweep, B designs that
share one mesh are packed along the lane axis: the filter state is the
fused-lane block (D, B, 3, k), viewed as (D, L) with L = B * 3 * k for
the operator applies, so every gather and accumulate serves all
components, designs and subspace columns at once. Only 1/eps, beta,
the filter interval and the park value vary per design.

Every filter step runs three hand-written kernels (``cuda_kernels`` K1
and K3, ``triton_kernels`` K4): the packed A(beta_b) apply with its
mask and park, element math and accumulate in one launch (K1), the
fused mass apply, one launch per degree step of B^{-1} (K3; one K12
launch of every step where the fused rows hold at most ``BINV_LANES``
lanes), and the recurrence step (K4).
The Rayleigh-Ritz keeps the fused layout: the
per-design QR, the Grams, the small dense eigenproblem and the Ritz
vectors are ``torch.linalg`` and batched GEMMs on the fused rows, and
the residual norms with the pass gate are K10 (``ritz_residual``), so a
pass reads one scalar on the host. Each pass, its read of the gate
included, is a profiler span ``pl_fem.rr_pass`` (``utils.span``). The
bootstrap seed is K9 (``seed_prolong``), written straight into the
fused layout.
``_apply_mass_fused_plain`` and ``_apply_binv_fused_plain`` keep the
unfused form of the mass path as the reference the kernel is held
against; ``seed_prolong_plain`` and ``ritz_residual_plain`` are K9's and
K10's twins.

The stacked form (``_apply_stacked`` .. ``solve_lowest_kernel``) applies
a C-component operator from its assembled (E, 6C, 6C) element blocks to
the component-major block (C D, k): K5 (``apply_stacked``) for the
whole apply with its mask and park in one launch, K12 once per
component for B^{-1} (all its degree steps in one launch; K3 once a
step where k exceeds ``BINV_LANES``), K4 for the recurrence on the block
viewed as (C D, 1, 1, k), K10 for its residuals and gate on the block
viewed as (C D, 1, 1, k). C = 1 is the scalar pencil. The spectrum bound the
scalar pencil starts from comes with its assembly (K11); otherwise it
is K8: ``pencil_bounds_elem`` on assembled blocks, and
``pencil_bounds_sweep`` from the quadrature factors of all designs of a
vectorial sweep in one launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import span
from .assembly import (ApplyPlan, MassPlan, quadrature_primitives,
                       vector3_stacked_A)
from .cuda_kernels import (BINV_LANES, accumulate, apply_stacked,
                           apply_vector3, binv_chain, mass_apply,
                           mass_apply_plain, mass_step_chain, pencil_bounds,
                           pencil_bounds_plain, pencil_bounds_vector3,
                           ritz_residual)
from .quadrature import RULES, p2_shape
from .triton_kernels import cheb_step

# The filter needs true f32 products: TF32 (about three decimal digits)
# stalls the Chebyshev recurrence's convergence.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_log = logging.getLogger("pl_fem_tpu_torch.kernels")

# torch.linalg's cuSOLVER calls are not safe from two host threads at
# once, and the dataset engine's bucket pipeline runs two sweeps: on an
# H100 two threads' QRs of (B, 3D, k) blocks failed with
# CUSOLVER_STATUS_INTERNAL_ERROR within seconds, and the first linalg
# call of a process (which loads torch's CUDA linalg library) fails in
# one of two threads that make it together. The Rayleigh-Ritz's QR and
# small eigenproblems take this lock.
_LINALG_LOCK = threading.Lock()


class GatherScatter(NamedTuple):
    """Grid topology for the matrix-free applies.

    The accumulate table is split by DOF class: the wide table covers
    rows [0, split) (mesh vertices, valence up to ~12), the width-2
    table rows [split, D) (P2 edge midpoints, valence exactly <= 2).
    ``plan`` is the mass kernel's per-grid plan (``assembly.mass_plan``:
    its Morton row blocks and their halos), ``apply_plan`` the A(beta)
    and stacked applies' (``assembly.apply_plan``: larger row blocks and
    their element halos); storage order is unchanged.
    """

    elem_dofs: torch.Tensor     # (E, 6) int32
    idx_v: torch.Tensor         # (split, Wv) int32 flat entries e*6+l
    valid_v: torch.Tensor       # (split, Wv) bool
    idx_e: torch.Tensor         # (D - split, 2) int32
    valid_e: torch.Tensor       # (D - split, 2) bool
    plan: MassPlan              # the mass kernel's row blocks and halos
    apply_plan: ApplyPlan       # K1's and K5's row blocks, elements


class QFactor(NamedTuple):
    """Per-element quadrature factors of one design's vectorial operator."""

    invJT: torch.Tensor       # (E, 2, 2) J^{-T}
    w: torch.Tensor           # (E, Q) |detJ|-scaled quadrature weights
    inv_eps: torch.Tensor     # (E, Q) 1/Re(eps) at quadrature points


class QFactorSweep(NamedTuple):
    invJT: torch.Tensor       # (E, 2, 2) shared
    w: torch.Tensor           # (E, Q) shared
    inv_eps: torch.Tensor     # (B, E, Q) per design
    gp: torch.Tensor          # (E, Q, 6, 2) physical shape gradients (shared)


def _reference_tensors():
    qp, qw = RULES[4]
    N, dN = p2_shape(qp)
    return N, dN, qw


_N_REF, _DN_REF, _QW_REF = _reference_tensors()


@functools.lru_cache(maxsize=None)
def _shape_table_on(device: str) -> torch.Tensor:
    return torch.as_tensor(_N_REF, dtype=torch.float32, device=device)


def shape_table(device) -> torch.Tensor:
    """The (Q, 6) P2 shape values at the Dunavant-4 points, f32 on
    ``device`` (the table the kernels take at launch)."""
    return _shape_table_on(str(torch.device(device)))


# ---------------------------------------------------------------------------
# layout conversion at pass boundaries
# ---------------------------------------------------------------------------

def _fused_from_stacked(X):
    """(3D, B, k) component-major -> (D, B, 3, k) fused-lane."""
    CD, B, k = X.shape
    D = CD // 3
    return X.reshape(3, D, B, k).permute(1, 2, 0, 3).contiguous()


def _stacked_from_fused(Xf):
    """(D, B, 3, k) fused-lane -> (3D, B, k) component-major."""
    D, B, C, k = Xf.shape
    return Xf.permute(2, 0, 1, 3).reshape(C * D, B, k)


# ---------------------------------------------------------------------------
# the bootstrap seed
# ---------------------------------------------------------------------------

def seed_prolong_plain(Hc, colmask, cols, wts, R1, R2, scale: float):
    """Plain twin of K9, the body of pl_fem_tpu/solvers/vectorial.py
    ``_seed_from_coarse`` in the fused layout: W gathers of the coarse
    vectors Hc (B, 3, nc, k) through the prolongation's (Dp, W) tables,
    then ``X = F / |F| m + R1 / |R1| (1 - m) + scale R2`` normalized,
    every norm per (design, column) over the 3 Dp rows (d, c). R1, R2
    and the result are (Dp, B, 3, k)."""
    F = None
    for j in range(cols.shape[1]):
        g = Hc[:, :, cols[:, j].long(), :] * wts[None, None, :, j, None]
        F = g if F is None else F + g                 # (B, 3, Dp, k)
    F = F.permute(2, 0, 1, 3)                         # (Dp, B, 3, k)

    def norm(V):
        return torch.linalg.vector_norm(V, dim=(0, 2), keepdim=True) + 1e-30

    m = colmask[None, :, None, :]
    X = F / norm(F) * m + R1 / norm(R1) * (1.0 - m)
    X = X + scale * R2
    return (X / norm(X)).contiguous()


# ---------------------------------------------------------------------------
# operator applies on fused lanes
# ---------------------------------------------------------------------------

def _accumulate_fused(Ye, gs: GatherScatter, X=None, mask=None, park=None):
    """(E, 6, L) element results -> (D, L) DOF sums (K2), with the
    optional ``Y * m + park * (X - X * m)`` epilogue."""
    return accumulate(Ye, gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e,
                      X, mask, park)


def _apply_vector3_fused(qs: QFactorSweep, gs: GatherScatter, mask, parks,
                         betas, alpha, Xf):
    """Packed A(beta_b) apply in fused-lane layout, one K1 launch.

    Xf: (D, B, 3, k) -> (D, B, 3, k); mask (D,) f32 interior mask,
    parks and betas (B,) f32: m * A(beta_b)(m X) + park_b * (X - m X).
    """
    D, B, C, k = Xf.shape
    return apply_vector3(Xf.reshape(D, B * C * k), gs, qs.gp, qs.w,
                         qs.inv_eps, betas, float(alpha),
                         shape_table(Xf.device), mask,
                         parks).reshape(D, B, C, k)


def _apply_mass_fused_plain(qs: QFactorSweep, gs: GatherScatter, mask, Xl,
                            park: float = 1.0):
    """Plain-mass apply on fused lanes, unfused: (D, L) -> (D, L) through
    the element pass and the accumulate twins (``mass_apply_plain``)."""
    return mass_apply_plain(Xl, gs, qs.w, shape_table(Xl.device), mask, park)


def _apply_mass_fused(qs: QFactorSweep, gs: GatherScatter, mask, Xl,
                      park: float = 1.0):
    """Plain-mass apply on fused lanes: (D, L) -> (D, L), one K3 launch."""
    return mass_apply(Xl, gs, qs.w, shape_table(Xl.device), mask, park)


def _binv_constants(lo, hi):
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    return theta, delta, theta / delta


def _apply_binv_fused_plain(qs: QFactorSweep, gs: GatherScatter, mask,
                            dinv_sqrt, lo, hi, Xl, degree: int):
    """Chebyshev B^{-1} semi-iteration on fused lanes (Jacobi-scaled mass
    with spectrum bounds [lo, hi]), in torch ops around the unfused mass
    apply: the reference K3's step mode is held against."""
    ds = dinv_sqrt[:, None]

    def scaled(V):
        return ds * _apply_mass_fused_plain(qs, gs, mask, ds * V)

    theta, delta, sigma1 = _binv_constants(lo, hi)
    Yh = ds * Xl
    Z = torch.zeros_like(Yh)
    R = Yh
    Dd = R / theta
    rho = 1.0 / sigma1
    for _ in range(degree):
        Z = Z + Dd
        R = R - scaled(Dd)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        Dd = rho_new * rho * Dd + (2.0 * rho_new / delta) * R
        rho = rho_new
    return ds * (Z + Dd)


def _apply_binv_fused(qs: QFactorSweep, gs: GatherScatter, mask, dinv_sqrt,
                      lo, hi, Xl, degree: int):
    """The same semi-iteration through the kernels (``_binv_steps`` on
    the sweep's quadrature weights)."""
    return _binv_steps(qs.w, gs, mask, dinv_sqrt, lo, hi, Xl, degree)


def _binv_coefs(lo, hi, degree: int):
    """theta and the per-step (a, b) of the semi-iteration: step i forms
    Dd' = a_i V + b_i R'."""
    theta, delta, sigma1 = _binv_constants(lo, hi)
    a, b = [], []
    rho = 1.0 / sigma1
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        a.append(rho_new * rho)
        b.append(2.0 * rho_new / delta)
        rho = rho_new
    return theta, a, b


def _binv_steps(w, gs: GatherScatter, mask, dinv_sqrt, lo, hi, Xl,
                degree: int):
    """Chebyshev B^{-1} semi-iteration on a (D, L) block. Each step fuses
    the mass apply (weights ``w`` (E, Q)) with its R, Z and Dd updates,
    so no torch elementwise op runs between them. Degree >= 2 on rows of
    at most ``BINV_LANES`` lanes (the scalar filter's k) is one K12
    launch (``binv_chain``); otherwise ``degree`` K3 launches in step
    mode, Dd ping-ponging between fresh outputs."""
    if degree < 1:
        raise ValueError(f"B^-1 degree {degree} < 1 (degree 0 is the "
                         "lumped inverse of _sweep_apply_t)")
    theta, a, b = _binv_coefs(lo, hi, degree)
    N = shape_table(Xl.device)
    if degree > 1 and Xl.shape[1] <= BINV_LANES:
        return binv_chain(Xl, gs, w, N, mask, dinv_sqrt, a, b, theta,
                          degree)
    return mass_step_chain(mass_apply, Xl, gs, w, N, mask, dinv_sqrt, a, b,
                           theta, degree)


# ---------------------------------------------------------------------------
# the Chebyshev filter
# ---------------------------------------------------------------------------

def _sweep_apply_t(qs, gs, mask, dinv_sqrt, lo, hi, parks, betas, alpha,
                   cuts, bounds, binv_degree: int):
    """Pieces of the shifted-scaled filter operator T = (B^{-1}A - c)/h.

    Returns ``(apply_w, c, h)``: ``apply_w(V) = B^{-1} A(beta_b) V`` on
    (D, B, 3, k) blocks and the per-design centre and half-width of the
    damped interval [cut, bound]; K4 (``cheb_step``) forms
    T V = (W - c V) / h and the recurrence from them.

    ``binv_degree == 0`` selects the HRZ-lumped mass inverse (one
    elementwise scale per step); callers widen ``bounds`` by
    _LUMP_BOUND then.
    """
    if binv_degree == 0:
        ilump = (dinv_sqrt * dinv_sqrt / _HRZ_SCALE)[:, None, None, None]

        def binv_f(Vf):
            return Vf * ilump
    else:
        def binv_f(Vf):
            D, B, C, k = Vf.shape
            return _apply_binv_fused(qs, gs, mask, dinv_sqrt, lo, hi,
                                     Vf.reshape(D, B * C * k),
                                     binv_degree).reshape(D, B, C, k)

    c = (0.5 * (bounds + cuts)).to(torch.float32).contiguous()
    h = (0.5 * (bounds - cuts)).to(torch.float32).contiguous()

    def apply_w(Vf):
        return binv_f(_apply_vector3_fused(qs, gs, mask, parks, betas,
                                           alpha, Vf))

    return apply_w, c, h


def _sweep_iterate(apply_w, c, h, T0, T1, steps: int, renorm_every: int,
                   start: int = 0):
    """``steps`` recurrence steps T2 = 2 T(T1) - T0 (K4) on (D, B, C, k)
    blocks, numbered from ``start``, with the per-(design, column) renorm
    on steps i with i % renorm_every == renorm_every - 1. The renorm is
    deferred (see ``triton_kernels``): its scale rides on the next two
    steps' inputs, and a scale still pending at the end is applied to
    the returned last iterate."""
    if renorm_every < 2:
        raise ValueError(f"renorm_every {renorm_every} < 2: a deferred "
                         "renorm needs a plain step after it")
    s0 = s1 = None                  # pending renorm scales of T0, T1
    for i in range(start, start + steps):
        do = (i % renorm_every) == (renorm_every - 1)
        T2, s = cheb_step(apply_w(T1), T1, T0, c, h, renorm=do, scale=s1,
                          scale_t0=s0)
        T0, T1 = T1, T2
        s0, s1 = (s, s) if do else (s1, None)
    return T1 if s1 is None else T1 * s1[None, :, None, :]


def cheb_sweep_filter(qs, gs, mask, dinv_sqrt, lo, hi, parks, betas, alpha,
                      Xf, cuts, bounds, degree: int, binv_degree: int = 4,
                      renorm_every: int = 8):
    """Degree-``degree`` Chebyshev filter of the fused block Xf
    (D, B, 3, k): T1 = T(Xf), then ``degree - 1`` recurrence steps.
    Returns the filtered block."""
    apply_w, c, h = _sweep_apply_t(qs, gs, mask, dinv_sqrt, lo, hi, parks,
                                   betas, alpha, cuts, bounds, binv_degree)
    T0 = Xf
    T1, _ = cheb_step(apply_w(T0), T0, None, c, h)
    return _sweep_iterate(apply_w, c, h, T0, T1, degree - 1, renorm_every)


def _fused_gram(U, V):
    """Per design b, the sum over the rows (d, c) of U_b^T V_b for fused
    (D, B, C, k) blocks: one batched GEMM over the (b, c) slices (each a
    (D, k) matrix of row stride B C k), summed over c. Returns (B, k,
    k)."""
    D, B, C, k = U.shape
    Uv = U.view(D, B * C, k)
    Vv = V.view(D, B * C, k)
    return torch.bmm(Uv.permute(1, 2, 0), Vv.transpose(0, 1)).view(
        B, C, k, k).sum(1)


def _fused_ritz_vectors(Qf, Ys):
    """Xr_b = Q_b Ys_b on the fused rows: one batched GEMM over the (b, c)
    slices, written straight into a fused (D, B, C, k) block."""
    D, B, C, k = Qf.shape
    Xr = torch.empty_like(Qf)
    torch.bmm(Qf.view(D, B * C, k).transpose(0, 1),
              Ys.repeat_interleave(C, dim=0),
              out=Xr.view(D, B * C, k).transpose(0, 1))
    return Xr


def _ritz_pairs(H, G):
    """The small generalized eigenproblems of the Rayleigh-Ritz, per
    design: H and G (B, k, k) symmetrized, G shifted by 1e-6 of its mean
    diagonal, the Cholesky congruence, eigh (under ``_LINALG_LOCK``).
    Returns theta (B, k) ascending and Ys (B, k, k), G-orthonormal."""
    k = H.shape[-1]
    H = 0.5 * (H + H.transpose(1, 2))
    G = 0.5 * (G + G.transpose(1, 2))
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    G = G + (1e-6 * torch.diagonal(G, dim1=1, dim2=2).sum(-1)[:, None, None]
             / k) * eye[None]
    with _LINALG_LOCK:
        Lc = torch.linalg.cholesky(G)
        Hw = torch.linalg.solve_triangular(Lc, H, upper=False)
        Hw = torch.linalg.solve_triangular(Lc, Hw.transpose(1, 2),
                                           upper=False)
        Hw = 0.5 * (Hw + Hw.transpose(1, 2))
        theta, Wv = torch.linalg.eigh(Hw)
        return theta, torch.linalg.solve_triangular(Lc.transpose(1, 2), Wv,
                                                    upper=True)


def _fused_qr(Xff):
    """Per-design Q of the fused block Xff (D, B, C, k), back in the fused
    layout: QR (under ``_LINALG_LOCK``) on the rows (d, c) of each design,
    one gather in and one out (QR wants each design's rows together; any
    fixed row order gives the same Rayleigh-Ritz)."""
    D, B, C, k = Xff.shape
    with _LINALG_LOCK:
        Q = torch.linalg.qr(Xff.permute(1, 0, 2, 3).reshape(B, C * D, k))[0]
    return Q.unflatten(1, (D, C)).permute(1, 0, 2, 3).contiguous()


def ritz_residual_plain(AQ, BQ, Ys, theta, cuts, n_wanted: int = 0):
    """Plain twin of K10: the tail of pl_fem_tpu/ops/kernels.py
    ``cheb_sweep_rr_impl`` on fused (D, B, C, k) blocks (the Ritz blocks
    AQ Ys and BQ Ys, the residual block and the column norms over all
    rows of a design) and the pass gate of ``_sweep_gate_maxres``.
    Returns res (B, k) and the gate, a 0-d tensor."""
    AXr = torch.einsum("dbck,bkl->dbcl", AQ, Ys)
    BXr = torch.einsum("dbck,bkl->dbcl", BQ, Ys)
    R = AXr - BXr * theta[None, :, None, :]
    res = (torch.linalg.vector_norm(R, dim=(0, 2))
           / (torch.linalg.vector_norm(AXr, dim=(0, 2)) + 1e-30))
    return res, _sweep_gate_maxres(theta, res, cuts, n_wanted)


def _sweep_gate_maxres(theta, res, cuts, n_wanted: int = 0):
    """Worst residual among the wanted sub-cut modes, or the minimum
    residual if nothing is wanted yet: the pass gate as a 0-d tensor on
    the device of ``res`` (pl_fem_tpu/ops/kernels.py
    ``_sweep_gate_maxres``)."""
    wanted = theta < cuts[:, None]
    if n_wanted > 0:
        cols = torch.arange(theta.shape[1], device=theta.device)
        wanted = wanted & (cols[None, :] < n_wanted)
    worst = torch.where(wanted, res, -torch.inf).max()
    return torch.where(wanted.any(), worst, res.min())


def ritz_residual_gate(AQ, BQ, Ys, theta, cuts, n_wanted: int = 0):
    """The Rayleigh-Ritz residuals res (B, k) of the fused (D, B, C, k)
    blocks AQ and BQ at the Ritz pairs (theta (B, k), Ys (B, k, k)), and
    the pass gate (0-d) from the per-design ``cuts`` (B,): K10
    (``ritz_residual``, one launch) on the card, its twin on the CPU."""
    fn = ritz_residual_plain if AQ.device.type == "cpu" else ritz_residual
    return fn(AQ, BQ, Ys.contiguous(), theta.contiguous(), cuts,
              n_wanted)


def _sweep_ritz(qs, gs, mask, parks, betas, alpha, Xff):
    """The Rayleigh-Ritz projection of a filtered fused-lane subspace Xff
    (D, B, 3, k): per-design QR (``_fused_qr``), one packed A apply (K1)
    and one mass apply (K3) on Q, the k x k Grams on the fused rows and
    the Ritz pairs. Returns (Qf, AQ, BQ, theta, Ys), the first three
    fused (D, B, 3, k)."""
    D, B, C, k = Xff.shape
    Qf = _fused_qr(Xff)
    AQ = _apply_vector3_fused(qs, gs, mask, parks, betas, alpha, Qf)
    BQ = _apply_mass_fused(qs, gs, mask,
                           Qf.view(D, B * C * k)).view(D, B, C, k)
    theta, Ys = _ritz_pairs(_fused_gram(Qf, AQ), _fused_gram(Qf, BQ))
    return Qf, AQ, BQ, theta, Ys


def cheb_sweep_rr_impl(qs, gs, mask, parks, betas, alpha, Xff, cuts,
                       n_wanted: int = 0):
    """Rayleigh-Ritz tail on a filtered fused-lane subspace Xff
    (D, B, 3, k), in the fused layout throughout.

    Per-design QR, one packed A and one mass apply, the k x k Gram
    matrices (symmetrized, with a 1e-6 trace shift on G), Cholesky, the
    generalized eigh, Ritz vectors, and K10 for the relative residuals
    and the pass gate (``cuts`` (B,) f32 on the device, ``n_wanted`` as
    in ``solve_lowest_sweep``). Returns theta (B, k), Xr (D, B, 3, k),
    res (B, k) and the gate (0-d).
    """
    Qf, AQ, BQ, theta, Ys = _sweep_ritz(qs, gs, mask, parks, betas, alpha,
                                        Xff)
    res, gate = ritz_residual_gate(AQ, BQ, Ys, theta, cuts, n_wanted)
    return theta, _fused_ritz_vectors(Qf, Ys), res, gate


def _on_device(dev: torch.device):
    """``dev`` as the CUDA runtime's current device inside the block (the
    ctypes and Triton launches run on the current device), restored
    after; nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _to(x, dev: torch.device):
    """The tensors of ``x`` (a tensor or a NamedTuple of them, nested) on
    ``dev``; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    return x


@dataclasses.dataclass
class _DesignSlice:
    """One slice of a split sweep: its device, the grid's topology,
    quadrature factors, mask and mass scaling on it, its designs'
    per-design values, and its part Xf (D, b, 3, k) of the fused state."""

    dev: torch.device
    qs: QFactorSweep
    gs: object
    mask: torch.Tensor
    dinv_sqrt: torch.Tensor
    cuts: torch.Tensor
    betas: torch.Tensor
    parks: torch.Tensor
    bounds: torch.Tensor
    Xf: torch.Tensor


def _design_slices(mesh, qs, gs, mask, dinv_sqrt, cuts, betas, parks,
                   bounds, Xf):
    """The slices of a sweep over ``mesh`` (or the one slice of the whole
    sweep, the given tensors as they are, where there is no mesh).

    A slice takes its designs' 1/eps, per-design values and columns of
    the fused state as fresh contiguous copies on its device (a view
    Xf[:, s:e] is not contiguous, and K9 / K10 want 16-byte starts). The
    grid's topology with the K1 and K3 plans, the shared quadrature
    factors, the mask and the mass scaling are copied once per device
    other than the sweep's and shared by the slices on it; on the
    sweep's device they are the caller's."""
    home = qs.w.device
    B = Xf.shape[1]
    if mesh is None or mesh.size == 1:
        return [_DesignSlice(home, qs, gs, mask, dinv_sqrt, cuts, betas,
                             parks, bounds, Xf)]
    shared = {home: (qs, gs, mask, dinv_sqrt)}
    out = []
    for dev, s, e in mesh.ranges(B):
        if dev not in shared:
            shared[dev] = tuple(_to(x, dev) for x in (
                qs._replace(inv_eps=qs.inv_eps[:0]), gs, mask, dinv_sqrt))
        qs_d, gs_d, mask_d, dinv_d = shared[dev]

        def part(t):
            return t[s:e].to(dev, copy=True).contiguous()

        out.append(_DesignSlice(
            dev, qs_d._replace(inv_eps=part(qs.inv_eps)), gs_d,
            mask_d, dinv_d, part(cuts), part(betas), part(parks),
            part(bounds), Xf[:, s:e].to(dev, copy=True).contiguous()))
    return out


def _split_gate(thetas, ress, cuts, n_wanted: int, dev: torch.device):
    """The pass gate of a split sweep: every slice's theta and res
    (B_i, k), in design order, gathered onto ``dev`` and reduced once by
    ``_sweep_gate_maxres`` over the whole (B, k), as the JAX package's
    global reduce does. The max of the slices' own gates would be wrong:
    a slice with no wanted column reports its smallest residual. Returns
    (theta, res, gate) on ``dev``."""
    theta = torch.cat([t.to(dev) for t in thetas])
    res = torch.cat([r.to(dev) for r in ress])
    return theta, res, _sweep_gate_maxres(theta, res, cuts, n_wanted)


def solve_lowest_sweep(qs: QFactorSweep, gs, mask, diag_B, X0, cuts, betas,
                       alpha, bounds, degree: int = 300, passes: int = 2,
                       tol: float = 1e-7, max_passes: int = 8, parks=None,
                       binv_degree: int = 4, n_wanted: int = 0, mesh=None):
    """Adaptive pass driver for the packed same-grid sweep.

    X0, a tensor or a numpy array, is moved to the device of ``qs``: the
    fused (D, B, 3, k) block the filter takes (the bootstrap seed), or
    the component-major (3D, B, k), converted once. cuts, betas, bounds
    and parks are (B,) per-design values. Each pass filters with
    ``degree`` steps and runs the Rayleigh-Ritz, the subspace staying
    fused from pass to pass; after ``passes`` passes the loop reads the
    pass gate (one scalar) and stops once the worst wanted residual is
    below max(tol, 5e-6) or improves by less than 30%.

    ``mesh``: an optional ``parallel.DesignMesh``; B must divide over it
    (the solver pads). Each slice filters and projects its contiguous
    range of the designs on its device (``_design_slices``), the filters
    of all slices issued before their Rayleigh-Ritz tails, every launch
    under its device; the gate is reduced over all designs
    (``_split_gate``) on the device of ``qs``, where the results are
    stitched back in design order.
    Returns theta (B, k), Xr (3D, B, k) and res (B, k).
    """
    dev = qs.w.device
    f32 = torch.float32

    def vec(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    eff_tol = max(tol, 5e-6)
    dinv_sqrt = (1.0 / torch.sqrt(torch.clamp(diag_B.to(f32), min=1e-30)))
    lo, hi = np.float32(MASS_LO), np.float32(MASS_HI)
    cuts = vec(cuts)
    betas = vec(betas)
    parks = vec(parks) if parks is not None else 10.0 * cuts
    bounds = vec(bounds)
    if binv_degree == 0:
        bounds = bounds * np.float32(_LUMP_BOUND)
    bounds = torch.maximum(bounds, parks * np.float32(1.05))
    X = torch.as_tensor(X0, device=dev).to(f32)
    Xf = X if X.dim() == 4 else _fused_from_stacked(X)
    parts = _design_slices(mesh, qs, gs, mask, dinv_sqrt, cuts, betas, parks,
                           bounds, Xf)
    del X, Xf
    theta = res = None
    prev = np.inf
    for ip in range(max_passes):
        with span("rr_pass"):
            t0 = time.perf_counter()
            filtered = []
            for p in parts:
                with _on_device(p.dev):
                    filtered.append(cheb_sweep_filter(
                        p.qs, p.gs, p.mask, p.dinv_sqrt, lo, hi, p.parks,
                        p.betas, float(alpha), p.Xf, p.cuts, p.bounds,
                        degree=degree, binv_degree=binv_degree))
            outs = []
            for p, Xff in zip(parts, filtered):
                with _on_device(p.dev):
                    outs.append(cheb_sweep_rr_impl(
                        p.qs, p.gs, p.mask, p.parks, p.betas, float(alpha),
                        Xff, p.cuts, n_wanted=n_wanted))
                p.Xf = outs[-1][1]
            del filtered
            if len(parts) == 1:
                theta, _, res, gate = outs[0]
            else:
                theta, res, gate = _split_gate([o[0] for o in outs],
                                               [o[2] for o in outs], cuts,
                                               n_wanted, dev)
            if ip + 1 >= passes:
                maxres = float(gate)
                _log.debug("sweep pass %d (deg %d, binv %d, %d slices): %.2fs "
                           "maxres=%.2e", ip, degree, binv_degree, len(parts),
                           time.perf_counter() - t0, maxres)
                if maxres < eff_tol or maxres > 0.7 * prev:
                    break
                prev = maxres
    Xf = parts[0].Xf if len(parts) == 1 else \
        torch.cat([p.Xf.to(dev) for p in parts], dim=1)
    return theta, _stacked_from_fused(Xf), res


# ---------------------------------------------------------------------------
# spectrum bounds (deterministic, per-element Rayleigh quotients)
# ---------------------------------------------------------------------------
#
# For affine P2 elements the local mass is EXACTLY |detJ| * B_ref with a
# constant 6x6 reference mass (Dunavant-4 integrates P2xP2 exactly), so
# every element-local mass quantity reduces to host-precomputed
# constants — no on-device factorizations anywhere.

def _reference_mass_constants():
    B_ref = np.einsum("q,qi,qj->ij", _QW_REF, _N_REF, _N_REF)
    d = np.diag(B_ref)
    S = B_ref / np.sqrt(np.outer(d, d))
    wS = np.linalg.eigvalsh(S)
    Linv = np.linalg.inv(np.linalg.cholesky(B_ref))
    return B_ref, float(wS[0]), float(wS[-1]), Linv


_B_REF, MASS_LO, MASS_HI, _LINV_REF = _reference_mass_constants()
_TRACE_REF = float(np.trace(_B_REF))

# HRZ mass lumping on the reference element: d_i = B_ref[i,i] * c_H with
# c_H = area / trace(B_ref) (total mass preserved). The eigenvalues of
# D_l^{-1} B_ref bound the lumped/consistent Rayleigh-quotient ratio per
# element: [0.2485, 1.3046] for P2/Dunavant-4; _LUMP_BOUND pads the
# upper edge for the (A, B_l) spectrum bound.
_HRZ_SCALE = float(np.float32(_QW_REF).sum() / np.trace(_B_REF))
_LUMP_BOUND = 1.40


@functools.lru_cache(maxsize=None)
def _linv_ref_on(device: str) -> torch.Tensor:
    return torch.as_tensor(_LINV_REF, dtype=torch.float32, device=device)


def pencil_bounds_elem(Abig, Bblk, elem_valid, C: int = 1):
    """Deterministic spectrum bounds from per-element quotients (K8).

        spec(D_B^{-1} B)  subset  [MASS_LO, MASS_HI]
        |spec(B^{-1} A)|  <=  max_e |L_ref^{-1} (A_e/|detJ|_e) L_ref^{-T}|

    with the last norm bounded by Gershgorin row sums of the constant-
    congruence-transformed blocks. Returns (lo_B, hi_B, bound_A), the
    last a 0-d tensor on the device of ``Abig``.
    """
    bound_A = pencil_bounds(Abig, Bblk, elem_valid,
                            _linv_ref_on(str(Abig.device)), _TRACE_REF, C)
    return np.float32(MASS_LO), np.float32(MASS_HI), bound_A


def pencil_bounds_vector3_plain(gp, w, N, inv_eps, betas, alpha,
                                elem_valid, Linv, trace_ref: float):
    """Plain twin of the vectorial sweep's K8: per design b, the
    primitives of ``inv_eps[b]`` (``assembly.quadrature_primitives``),
    the stacked A(beta_b) (``vector3_stacked_A``) and
    ``pencil_bounds_plain`` on it with u_nn as the mass blocks, as the
    reference's per-design loop does. Returns (B,) in the inputs'
    dtype."""
    ap = np.float32(alpha) if w.dtype == torch.float32 else float(alpha)
    out = []
    for b in range(inv_eps.shape[0]):
        prim = quadrature_primitives(gp, w, N, inv_eps[b])
        A = vector3_stacked_A(prim, betas[b], ap)
        out.append(pencil_bounds_plain(A, prim["u_nn"], elem_valid, Linv,
                                       trace_ref, 3))
        del prim, A
    return torch.stack(out)


def pencil_bounds_sweep(qs: QFactorSweep, N, elem_valid, betas, alpha):
    """``pencil_bounds_elem``'s bound_A of A(beta_b) for every design of
    a sweep, from its quadrature factors (K8 ``pencil_bounds_vector3``,
    one launch; its twin on CPU tensors): qs.gp, qs.w and qs.inv_eps
    (B, E, Q), N (Q, 6) the grid's shape table, betas (B,) host values
    taken as float32. Returns a (B,) tensor on the device of ``qs.w``."""
    dev = qs.w.device
    b32 = torch.as_tensor(np.asarray(betas, dtype=np.float32), device=dev)
    bound = (pencil_bounds_vector3_plain if dev.type == "cpu"
             else pencil_bounds_vector3)
    return bound(qs.gp, qs.w, N, qs.inv_eps, b32, float(np.float32(alpha)),
                 elem_valid, _linv_ref_on(str(dev)), _TRACE_REF)


# ---------------------------------------------------------------------------
# the stacked-block solver (scalar pencil: C = 1)
# ---------------------------------------------------------------------------

def _park_lanes(park, k: int, like: torch.Tensor) -> torch.Tensor:
    """``park`` as the (k,) per-lane vector K5 takes."""
    if isinstance(park, torch.Tensor) and park.dim() == 1:
        return park
    return torch.full((k,), float(park), dtype=like.dtype, device=like.device)


def _apply_stacked(Abig, gs: GatherScatter, mask, park, X, C: int):
    """P A P X + park (I - P) X for the stacked (E, 6C, 6C) operator on
    the component-major block X (C D, k), one K5 launch. ``park`` is a
    float or a (k,) tensor."""
    return apply_stacked(X, gs, Abig, mask,
                         _park_lanes(park, X.shape[1], X), C)


def _apply_mass(w, gs: GatherScatter, mask, X, C: int, park: float = 1.0):
    """Block-diagonal consistent-mass apply on X (C D, k), one K3 launch
    per component. The mass blocks are sum_q w N N, which K3 builds from
    the quadrature weights ``w`` (E, Q) and the shape table."""
    D = mask.shape[0]
    N = shape_table(X.device)
    parts = [mass_apply(X[c * D:(c + 1) * D], gs, w, N, mask, park)
             for c in range(C)]
    return parts[0] if C == 1 else torch.cat(parts, dim=0)


def _apply_binv(w, gs: GatherScatter, mask, dinv_sqrt, lo, hi, X, C: int,
                degree: int):
    """Chebyshev semi-iteration for B^{-1} on the Jacobi-scaled mass,
    per component of X (C D, k), each through ``_binv_steps``."""
    D = mask.shape[0]
    parts = [_binv_steps(w, gs, mask, dinv_sqrt, lo, hi,
                         X[c * D:(c + 1) * D], degree) for c in range(C)]
    return parts[0] if C == 1 else torch.cat(parts, dim=0)


def cheb_rr_pass_impl(Abig, w, gs, mask, dinv_sqrt, lo, hi, park, X, cut,
                      bound, C: int = 1, degree: int = 300,
                      binv_degree: int = 8, renorm_every: int = 8,
                      n_wanted: int = 0):
    """Low-end Chebyshev filter + QR-stabilized Rayleigh-Ritz, one pass.

    Pure float32 on the device; final eigenvalue accuracy comes from the
    host float64 polish (ops/host_assembly.py).

    Args:
        Abig: (E, 6C, 6C) stacked operator blocks, f32.
        w: (E, Q) quadrature weights (the mass blocks are sum_q w N N).
        X: (C D, k) f32 subspace from the previous pass (or random).
        cut / bound: wanted eigenvalues lie below ``cut``; unwanted
            within [cut, bound] (floats or 0-d tensors).

    Returns:
        theta (k,) ascending, X (C D, k) B-orthonormal Ritz vectors
        (f32), resnorm (k,), and the pass gate (0-d): the worst resnorm
        of the columns below ``cut`` (the first ``n_wanted`` of them when
        n_wanted > 0), or the smallest resnorm if none is.
    """
    f32 = torch.float32
    dev = X.device
    CD, k = X.shape
    c = (0.5 * (bound + cut)).to(f32).reshape(1).contiguous()
    h = (0.5 * (bound - cut)).to(f32).reshape(1).contiguous()
    pk = _park_lanes(park, k, X)

    shape = (CD, 1, 1, k)

    def apply_w(V):
        # K4 takes the block as (C D, 1, 1, k): one design, and the
        # column norm over all C D rows
        W = _apply_stacked(Abig, gs, mask, pk, V.view(CD, k), C)
        return _apply_binv(w, gs, mask, dinv_sqrt, lo, hi, W, C,
                           binv_degree).view(shape)

    T0 = X.to(f32).contiguous().view(shape)
    T1, _ = cheb_step(apply_w(T0), T0, None, c, h)
    Xf = _sweep_iterate(apply_w, c, h, T0, T1, degree - 1, renorm_every,
                        start=1).view(CD, k)

    # QR basis (stable for near-collinear filtered columns), then
    # Rayleigh-Ritz via a Cholesky congruence of the small (k, k) Gram;
    # K10 for the residuals and the gate, on the block as one design
    with _LINALG_LOCK:
        Q = torch.linalg.qr(Xf)[0].contiguous()
    AQ = _apply_stacked(Abig, gs, mask, pk, Q, C)
    BQ = _apply_mass(w, gs, mask, Q, C)
    theta, Y = _ritz_pairs((Q.T @ AQ)[None], (Q.T @ BQ)[None])
    res, gate = ritz_residual_gate(
        AQ.view(CD, 1, 1, k), BQ.view(CD, 1, 1, k), Y, theta,
        torch.as_tensor(cut, dtype=f32, device=dev).reshape(1), n_wanted)
    return theta[0], Q @ Y[0], res[0], gate


def solve_lowest_kernel(Abig, Bblk, gs, mask, diag_B, X0, cut, elem_valid,
                        w, C: int = 1, degree: int = 300, passes: int = 2,
                        tol: float = 1e-7, max_passes: int = 10,
                        park: float = 1.0, binv_degree: int = 8,
                        n_wanted: int = 0, bound=None):
    """Adaptive filter / Rayleigh-Ritz passes until the wanted residuals
    are below tol.

    Abig (E, 6C, 6C) and Bblk (E, 6, 6) are the element blocks of the
    pencil (Bblk enters only the spectrum bound; the mass applies build
    the same blocks from ``w`` (E, Q) inside K3 and K12). ``bound`` is the
    pencil's spectrum bound (0-d) where its assembly gave it (K11 on the
    scalar path); without it ``pencil_bounds_elem`` bounds the blocks
    (K8). X0 (C D, k), a tensor or a numpy array, is moved to the
    device of ``Abig``. After
    ``passes`` passes the loop reads the pass gate (one scalar) every
    pass and stops once the worst wanted residual is below
    max(tol, 5e-6) or improves by less than 30%.
    Returns theta (k,), Xr (C D, k) and res (k,).
    """
    dev = Abig.device
    f32 = torch.float32
    if bound is None:
        lo, hi, bound = pencil_bounds_elem(Abig, Bblk, elem_valid, C=C)
    else:
        lo, hi = np.float32(MASS_LO), np.float32(MASS_HI)
    dinv_sqrt = (1.0 / torch.sqrt(torch.clamp(diag_B.to(f32), min=1e-30)))
    cut = float(cut)
    bound = torch.clamp(bound, min=max(park * 1.05, cut * 1.5 + 1.0))
    cut_t = torch.tensor(cut, dtype=f32, device=dev)

    # f32 filtering floors around a few 1e-6 relative residual; the host
    # float64 polish recovers full accuracy from a subspace at that
    # level. Stall detection: stop when the wanted residual no longer
    # improves.
    eff_tol = max(tol, 5e-6)
    if not isinstance(X0, torch.Tensor):
        X0 = torch.tensor(np.asarray(X0, dtype=np.float32))
    X = X0.to(device=dev, dtype=f32)
    theta = Xr = res = None
    prev = np.inf
    for ip in range(max_passes):
        with span("rr_pass"):
            t0 = time.perf_counter()
            theta, Xr, res, gate = cheb_rr_pass_impl(
                Abig, w, gs, mask, dinv_sqrt, lo, hi, park, X, cut_t, bound,
                C=C, degree=degree, binv_degree=binv_degree, n_wanted=n_wanted)
            X = Xr
            if ip + 1 >= passes:
                maxres = float(gate)
                _log.debug("stacked pass %d (deg %d, binv %d): %.2fs "
                           "maxres=%.2e", ip, degree, binv_degree,
                           time.perf_counter() - t0, maxres)
                if maxres < eff_tol or maxres > 0.7 * prev:
                    break
                prev = maxres
    return theta, Xr, res
