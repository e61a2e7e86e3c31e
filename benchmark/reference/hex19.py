"""Plain reference of the 19-core configuration (BASELINE config 3): the
hex 1+6+12 lantern, its H-field operators on the reference's own mesh,
each returned design held to them (as ``vectorial.Checker`` does), and
the exact guided modes of a design by a solve that fits in a run.

The exact solve is the same linear pencil as ``solve.vectorial_modes``,

    P x = mu R x,    mu = -beta^2,

shift-inverted about sigma = -(k0 n_s)^2 and solved for the ``k`` roots
of largest |nu|, nu = 1 / (mu - sigma), to the same relative Ritz
residual (1e-10), then post-processed the same way. Three things make
it cheaper at 143807 DOFs:

- the shift: n_s is the index of one isolated core's LP01 mode from the
  step-index characteristic equation (U J1(U) / J0(U) = W K1(W) / K0(W)),
  not a sparse scalar solve; at this contrast (n_core 1.535 in air) the
  scalar LP01 lies ~4e-3 above the top vector (HE11) supermode, so the
  shift stays above every root (a root found above it raises);
- the factorization: P - sigma R is symmetric once its z rows are scaled
  by -sigma, so SuperLU runs in its symmetric mode (minimum degree on
  A^T + A, diagonal pivots preferred), less than half of COLAMD's fill;
- the eigensolver: a block Arnoldi (blocks of ``BLOCK`` columns, full
  reorthogonalization) instead of ARPACK's single-vector Arnoldi. The
  wanted roots are near-degenerate clusters (38 HE11 supermodes split by
  ~1e-7, then the 19 of the TE01 group), which a single vector resolves
  only through many restarts; a block carries a cluster's copies
  together. Its products run in torch on the card where there is one:
  the triangular solves with SuperLU's factors (cuSPARSE), the sparse
  product with R and the Gram-Schmidt, all in the configuration's
  float64 (on the host SuperLU solves with its own factors).

Torch has no sparse LU, so the factorization is SciPy's SuperLU on the
host, as the shift-invert of the other references is.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch
from scipy.optimize import brentq
from scipy.sparse.linalg import splu
from scipy.special import jv, kv

from . import fem, geometry, mesh, solve, vectorial

LAYOUT = "hex_1plus6plus12_19"
# a block of 96 costs the card about what one column does; on the host
# the cost grows with the columns, and blocks of 24 take the fewest
BLOCK = {"cuda": 96, "cpu": 24}
TOL = {np.float64: 1e-10, np.float32: 1e-5}
MAX_STEPS = 30      # blocks before the solve gives up


def _hex19(pitch: float) -> np.ndarray:
    """Centre, the ring of 6 at the pitch, and the 12 of the second ring
    (6 at twice the pitch, 6 at sqrt(3) times it, turned 30 degrees):
    frozen copy of the program's 19-core layout (Mizuno et al., Nat.
    Photon. 10, 591 (2016))."""
    r = geometry._ring
    return np.vstack([np.zeros((1, 2)), r(6, pitch, 0.0), r(6, 2 * pitch, 0.0),
                      r(6, pitch * np.sqrt(3), 30.0)])


geometry.LAYOUTS.setdefault(LAYOUT, _hex19)


def lp01_index(lan) -> float:
    """Effective index of the LP01 mode of one isolated step-index core
    of ``lan`` (radius, n_core, n_clad, wavelength)."""
    a = float(lan.core_radii[0])
    V = lan.k0 * a * np.sqrt(lan.n_core ** 2 - lan.n_clad ** 2)

    def f(U):
        W = np.sqrt(V * V - U * U)
        return U * jv(1, U) / jv(0, U) - W * kv(1, W) / kv(0, W)

    U = brentq(f, 1e-9, min(2.404825557695773, V) - 1e-12, xtol=1e-15)
    return float(np.sqrt(lan.n_core ** 2 - (U / (lan.k0 * a)) ** 2))


def block_arnoldi(apply, n: int, k: int, tol: float, dtype, device,
                  block: int):
    """The ``k`` eigenvalues of largest modulus of the operator ``apply``
    (an (n, b) tensor block on ``device`` to its image) and their Ritz
    vectors (numpy), by block Arnoldi with two passes of classical
    Gram-Schmidt. A Ritz pair (theta, y) has converged when
    ``|| H_{m+1,m} y_last || <= tol |theta|`` for unit y, ARPACK's
    estimate of || T x - theta x || with blocks; all ``k`` have to.
    Raises after ``MAX_STEPS`` blocks."""
    b = min(block, n)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rng = np.random.default_rng(0)
    V = torch.empty((n, (MAX_STEPS + 1) * b), dtype=tdt, device=device)
    V[:, :b] = torch.linalg.qr(torch.from_numpy(
        rng.standard_normal((n, b)).astype(dtype)).to(device))[0]
    H = torch.zeros(((MAX_STEPS + 1) * b, MAX_STEPS * b), dtype=tdt,
                    device=device)
    check = -(-(k + b) // b)
    for step in range(1, min(MAX_STEPS, n // b) + 1):
        m = step * b
        Z = apply(V[:, m - b:m])
        for _ in range(2):
            h = V[:, :m].T @ Z
            Z -= V[:, :m] @ h
            H[:m, m - b:m] += h
        V[:, m:m + b], H[m:m + b, m - b:m] = torch.linalg.qr(Z)
        if step < check:
            continue
        Hm = H[:m + b, :m].cpu().numpy()
        theta, Y = sla.eig(Hm[:m])
        top = np.argsort(-np.abs(theta))[:k]
        theta, Y = theta[top], Y[:, top]
        Y = Y / np.linalg.norm(Y, axis=0)
        est = np.linalg.norm(Hm[m:, m - b:] @ Y[m - b:], axis=0)
        worst = float(np.max(est / (tol * np.abs(theta))))
        # a block gains a factor of ten or more on the estimate: skip
        # the checks (an eigensolve of the m x m projection) that cannot
        # pass yet
        check = step + max(1, int(np.log10(max(worst, 1.0)) / 2))
        if worst <= 1.0:
            Vm = V[:, :m]
            X = [(Vm @ torch.from_numpy(np.ascontiguousarray(part)).to(
                device)).cpu().numpy() for part in (Y.real, Y.imag)]
            return theta, X[0] + 1j * X[1]
    raise RuntimeError(f"block Arnoldi: {k} roots not converged to {tol} "
                       f"in {MAX_STEPS} blocks of {b}")


def _shift_invert(A, R, device):
    """x -> A^-1 R x on (n, b) tensor blocks on ``device``: A factored by
    SuperLU on the host (symmetric mode, minimum degree on A^T + A), the
    two triangular solves in torch on a card. SuperLU's Pr A Pc = L U;
    its L and U are CSC, whose arrays read as CSR are L^T and U^T, solved
    transposed."""
    lu = splu(A, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.01,
              options={"SymmetricMode": True})
    if device == "cpu":     # SuperLU's own solve is the faster one there
        return lambda X: torch.from_numpy(lu.solve(np.asarray(R @ X)))

    def csr(M):
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr), torch.from_numpy(M.indices),
            torch.from_numpy(M.data), size=M.shape,
            check_invariants=False).to(device)

    Lt, Ut = csr(lu.L), csr(lu.U)
    Rt = csr(R.tocsr())
    pr = torch.from_numpy(lu.perm_r.astype(np.int64)).to(device)
    pc = torch.from_numpy(lu.perm_c.astype(np.int64)).to(device)
    del lu

    def apply(X):
        Y = torch.empty_like(X)
        Y[pr] = Rt @ X
        Y = torch.triangular_solve(Y, Lt, upper=True, transpose=True,
                                   unitriangular=True).solution
        return torch.triangular_solve(Y, Ut, upper=False,
                                      transpose=True).solution[pc]

    return apply


def vectorial_modes(mesh_, lan, alpha: float, k: int, dtype=np.float64,
                    ops=None) -> list:
    """The roots of ``solve.vectorial_modes`` (the ``k`` of largest
    |nu| on the same pencil, its window, divergence and radiation
    filters, sorted by n_eff), by the cheaper solve of this module."""
    ops = ops or fem.vectorial(mesh_, lan, alpha)
    n = mesh_.n_dofs
    I = np.nonzero(mesh_.interior)[0]
    idx = np.concatenate([I, I + n, I + 2 * n])
    sub = {key: ops[key][idx][:, idx].astype(dtype)
           for key in ("A0", "A1", "A2", "M")}
    nt = 2 * len(I)
    k02 = lan.k0 ** 2
    t, z = slice(0, nt), slice(nt, None)
    A0, A1, A2, M = sub["A0"], sub["A1"], sub["A2"], sub["M"]
    P = sp.bmat([[A0[t, t] - k02 * M[t, t], None],
                 [A1[z, t], A0[z, z] - k02 * M[z, z]]], format="csc")
    R = sp.bmat([[A2[t, t], A1[t, z]], [None, A2[z, z]]], format="csr")
    sigma = -(lan.k0 * lp01_index(lan)) ** 2
    device = "cuda" if torch.cuda.is_available() else "cpu"
    apply = _shift_invert((P - dtype(sigma) * R).tocsc(), R, device)
    nu, X = block_arnoldi(apply, P.shape[0], k, TOL[dtype], dtype, device,
                          BLOCK[device])
    if np.any(nu.real < 0):
        raise RuntimeError(f"roots above the shift n_eff "
                           f"{np.sqrt(-sigma) / lan.k0!r}: the LP01 index "
                           f"does not bound this design's modes")
    mu = sigma + 1.0 / nu
    ok = (np.abs(mu.imag) <= 1e-6 * np.abs(mu.real)) & (mu.real < 0)
    betas = np.sqrt(-mu.real[ok]).astype(dtype)
    Xr = solve._real_vectors(X[:, ok]).astype(dtype)
    ni = len(I)
    hx = np.zeros((n, len(betas)), dtype)
    hy = np.zeros((n, len(betas)), dtype)
    hz = np.zeros((n, len(betas)), dtype)
    hx[I], hy[I] = Xr[:ni], Xr[ni:2 * ni]
    hz[I] = Xr[2 * ni:] * betas[None, :]
    return solve._postprocess(mesh_, lan, ops, betas, hx, hy, hz, dtype)


class Checker(vectorial.Checker):
    """``vectorial.Checker`` on the 19-core lantern, with this module's
    exact solve (no scalar operators: the shift is analytic)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        lan = geometry.lantern(cfg["geometry"], cfg["mesh"]["wavelength_um"])
        self.mesh = mesh.build(lan, cfg["mesh"])
        self.alpha = float(cfg["solver"].get("alpha_penalty", 1.0))
        self.n_modes = int(cfg["n_modes"])
        self.k = int(cfg["correct"]["reference_k"])
        self.ops = fem.vectorial(self.mesh, lan, self.alpha)
        self.core = fem.in_core(self.mesh, lan)

    def exact(self, wavelength_um: float, dtype=np.float64) -> list:
        return vectorial_modes(self.mesh, self.lantern(wavelength_um),
                               self.alpha, self.k, dtype=dtype, ops=self.ops)
