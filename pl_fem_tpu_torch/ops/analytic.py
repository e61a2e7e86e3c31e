"""Exact step-index circular-fiber mode solutions (validation oracles).

Characteristic equations solved with Bessel functions:

- Scalar (LP) modes: the scalar Helmholtz equation with a step profile
  has exact eigenvalues given by
      u J_{l+1}(u) / J_l(u) = w K_{l+1}(w) / K_l(w),   u^2 + w^2 = V^2.

- Full vector modes (HE/EH/TE/TM): the exact dispersion relation
      (Jp/(u J) + Kp/(w K)) (Jp/(u J) + (n2/n1)^2 Kp/(w K))
          = nu^2 (1/u^2 + 1/w^2) (1/u^2 + (n2/n1)^2/w^2) (neff/n1)^2
  (Snyder & Love, Optical Waveguide Theory, ch. 12).

These give the <5e-5 relative-n_eff accuracy gate of the reference
(README.md:44) against truth rather than against another discretization.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.optimize import brentq
from scipy.special import jv, jvp, kv, kvp


def _lp_char(b: float, V: float, l: int) -> float:
    u = V * np.sqrt(max(1.0 - b, 1e-15))
    w = V * np.sqrt(max(b, 1e-15))
    return (u * jv(l + 1, u) / jv(l, u)) - (w * kv(l + 1, w) / kv(l, w))


def lp_modes(V: float, n_core: float, n_clad: float,
             l_max: int = 8, m_max: int = 6) -> List[Tuple[int, int, float]]:
    """All guided LP_{l,m} modes: returns [(l, m, n_eff)] sorted by n_eff desc.

    b = (n_eff^2 - n_clad^2) / (n_core^2 - n_clad^2).
    """
    out = []
    for l in range(l_max + 1):
        bs = np.linspace(1e-9, 1 - 1e-9, 8001)
        vals = np.array([_lp_char(b, V, l) for b in bs])
        u_of_b = V * np.sqrt(np.maximum(1.0 - bs, 1e-15))
        jl = jv(l, u_of_b)
        roots = []
        for i in range(len(bs) - 1):
            if np.sign(vals[i]) * np.sign(vals[i + 1]) < 0 \
                    and np.isfinite(vals[i]) and np.isfinite(vals[i + 1]):
                # reject pole crossings: J_l(u) changes sign inside bracket
                if np.sign(jl[i]) * np.sign(jl[i + 1]) <= 0:
                    continue
                b_root = brentq(_lp_char, bs[i], bs[i + 1], args=(V, l))
                if abs(_lp_char(b_root, V, l)) > 1e-3:
                    continue
                roots.append(b_root)
        # m counts from the largest b (fundamental LP_l1 has largest n_eff)
        roots.sort(reverse=True)
        for m, b_root in enumerate(roots[:m_max], start=1):
            n_eff = np.sqrt(n_clad**2 + b_root * (n_core**2 - n_clad**2))
            out.append((l, m, float(n_eff)))
    out.sort(key=lambda t: -t[2])
    return out


def _vector_char(neff: float, k0: float, a: float, n1: float, n2: float,
                 nu: int) -> float:
    """Exact hybrid-mode dispersion (HE/EH), symmetric form.

    Derived from the 4x4 interface-continuity system of the (Ez, Hz)
    potentials: with D(X) = X_core - X_clad and gamma^2 the signed
    transverse wavenumber squared per region,

        (beta nu / a)^2 [D(1/gamma^2)]^2
            = k0^2  D(f'/gamma^2)  D(n^2 f'/gamma^2)

    which reduces to the form below. NOTE: a commonly transcribed
    variant replaces the squared factor (1/u^2 + 1/w^2)^2 by
    (1/u^2 + 1/w^2)(1/u^2 + (n2/n1)^2/w^2); that root does NOT satisfy
    the interface conditions — verified numerically in this repo by
    constructing the full fields at both candidate roots and checking
    Maxwell + continuity (H fully continuous, E_r jumping by exactly
    (n1/n2)^2) to machine precision; only the symmetric form's root
    passes. At n2 -> n1 the two coincide (weak guidance), which is why
    the error is invisible in low-contrast checks.
    """
    u = a * np.sqrt(max(k0**2 * n1**2 - k0**2 * neff**2, 1e-300))
    w = a * np.sqrt(max(k0**2 * neff**2 - k0**2 * n2**2, 1e-300))
    J = jv(nu, u)
    Jp = jvp(nu, u)
    K = kv(nu, w)
    Kp = kvp(nu, w)
    A = Jp / (u * J) + Kp / (w * K)
    B = Jp / (u * J) + (n2 / n1) ** 2 * Kp / (w * K)
    rhs = (nu**2) * ((1 / u**2 + 1 / w**2) ** 2) * (neff / n1) ** 2
    return A * B - rhs


def _te_tm_char(neff: float, k0: float, a: float, n1: float, n2: float,
                which: str) -> float:
    u = a * k0 * np.sqrt(max(n1**2 - neff**2, 1e-300))
    w = a * k0 * np.sqrt(max(neff**2 - n2**2, 1e-300))
    t = jv(1, u) / (u * jv(0, u)) + kv(1, w) / (w * kv(0, w))
    if which == "te":
        return t
    return jv(1, u) / (u * jv(0, u)) + (n2 / n1) ** 2 * kv(1, w) / (w * kv(0, w))


def vector_modes(wavelength_um: float, a_um: float, n_core: float,
                 n_clad: float, nu_max: int = 6) -> List[Tuple[str, float]]:
    """Exact vector modes: [(label, n_eff)] sorted by n_eff descending."""
    k0 = 2 * np.pi / wavelength_um
    out = []
    grid = np.linspace(n_clad + 1e-7, n_core - 1e-7, 12001)
    u_of_n = a_um * k0 * np.sqrt(np.maximum(n_core**2 - grid**2, 1e-30))

    def scan(fn, label_fmt, nu: int):
        vals = np.array([fn(n) for n in grid])
        jnu = jv(nu, u_of_n)
        roots = []
        for i in range(len(grid) - 1):
            if np.sign(vals[i]) * np.sign(vals[i + 1]) < 0 \
                    and np.isfinite(vals[i]) and np.isfinite(vals[i + 1]):
                # reject pole crossings of J_nu(u) inside the bracket
                if np.sign(jnu[i]) * np.sign(jnu[i + 1]) <= 0:
                    continue
                root = brentq(fn, grid[i], grid[i + 1])
                if abs(fn(root)) > 1e-3:
                    continue
                roots.append(float(root))
        roots.sort(reverse=True)
        for idx, root in enumerate(roots, start=1):
            out.append((label_fmt.format(idx), root))

    scan(lambda n: _te_tm_char(n, k0, a_um, n_core, n_clad, "te"),
         "TE0{}", 0)
    scan(lambda n: _te_tm_char(n, k0, a_um, n_core, n_clad, "tm"),
         "TM0{}", 0)
    for nu in range(1, nu_max + 1):
        scan(lambda n, nu=nu: _vector_char(n, k0, a_um, n_core, n_clad, nu),
             f"HY{nu},{{}}", nu)
    out.sort(key=lambda t: -t[1])
    return out
