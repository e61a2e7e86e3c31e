"""The guided modes of the discrete problems, solved exactly (to the
precision of ``dtype``) by sparse LU and ARPACK on the host, and
selected as the program's post-processing selects them.

Vectorial: with hz~ = beta w the quadratic pencil of ``fem.vectorial``
on the interior DOFs becomes the linear pencil

    [[Ktt - k0^2 Mt, 0], [Czt, Kzz - k0^2 Mz]] x = mu [[Ntt, Ctz], [0, Nzz]] x

in mu = -beta^2 (x = (t, w)), solved by shift-invert about
mu = -(k0 n_s)^2, where n_s is the top scalar LP index of the same
design (just above the vector modes' top): the modes of largest beta
come first, and the near-degenerate top cluster converges in few ARPACK
steps. Scalar:
``A psi = lambda B psi`` with lambda = -beta^2, shift-invert about
-(k0 (n_core - 0.008))^2 (the program's hybrid backend's shift).

``dtype=np.float32`` computes the same in single precision: the control
that has to fail the comparison.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator, eigs, eigsh, splu

from . import fem


def _real_vectors(X):
    """Eigenvectors of real eigenvalues, rotated to real: each column
    divided by the phase of its largest entry."""
    j = np.argmax(np.abs(X), axis=0)
    ph = X[j, np.arange(X.shape[1])]
    return (X / (ph / np.abs(ph))[None, :]).real


def vectorial_modes(mesh, lan, alpha: float, k: int, dtype=np.float64,
                    ops=None, scalar_parts=None) -> list:
    """The program's mode dicts (n_eff, beta, Ex_dofs, Ey_dofs, Hz_dofs,
    confinement) of the ``k`` roots nearest the top of the guided
    window, after the program's window, divergence and radiation
    filters, sorted by n_eff (descending)."""
    ops = ops or fem.vectorial(mesh, lan, alpha)
    n = mesh.n_dofs
    I = np.nonzero(mesh.interior)[0]
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
    sigma = -(lan.k0 * top_scalar_index(mesh, lan, scalar_parts)) ** 2
    lu = splu((P - dtype(sigma) * R).tocsc())
    op = LinearOperator(P.shape, matvec=lambda x: lu.solve(R @ x),
                        dtype=dtype)
    nu, X = eigs(op, k=k, which="LM", ncv=max(2 * k + 1, 40),
                 tol=1e-10 if dtype == np.float64 else 0)
    mu = sigma + 1.0 / nu
    ok = (np.abs(mu.imag) <= 1e-6 * np.abs(mu.real)) & (mu.real < 0)
    betas = np.sqrt(-mu.real[ok]).astype(dtype)
    Xr = _real_vectors(X[:, ok]).astype(dtype)
    ni = len(I)
    hx = np.zeros((n, len(betas)), dtype)
    hy = np.zeros((n, len(betas)), dtype)
    hz = np.zeros((n, len(betas)), dtype)
    hx[I], hy[I] = Xr[:ni], Xr[ni:2 * ni]
    hz[I] = Xr[2 * ni:] * betas[None, :]
    return _postprocess(mesh, lan, ops, betas, hx, hy, hz, dtype)


def top_scalar_index(mesh, lan, parts=None) -> float:
    """Effective index of the top scalar LP mode (float64)."""
    ops = fem.scalar(mesh, lan, parts)
    lam = eigsh(ops["A"].tocsc(), k=1, M=ops["B"].tocsc(),
                sigma=-(lan.k0 * (lan.n_core - 0.008)) ** 2, which="LM",
                return_eigenvectors=False)
    return float(np.sqrt(-lam.min()) / lan.k0)


def _postprocess(mesh, lan, ops, betas, hx, hy, hz, dtype):
    """The program's vectorial post-processing (its
    ``TrueVectorialMaxwellSolver._postprocess``): transverse
    normalization, the guided window, the divergence filter, the
    radiation filter."""
    nrm = np.sqrt(np.sum(hx ** 2, axis=0) + np.sum(hy ** 2, axis=0)) + 1e-30
    hx, hy, hz = hx / nrm, hy / nrm, hz / nrm
    Dxx, Dyy, Dxy = (ops[key].astype(dtype) for key in ("Dxx", "Dyy", "Dxy"))
    div = (np.sum(hx * (Dxx @ hx), axis=0) + 2.0 * np.sum(hx * (Dxy @ hy), axis=0)
           + np.sum(hy * (Dyy @ hy), axis=0))
    div_ratio = div / np.maximum(betas ** 2, 1e-12)
    core = fem.in_core(mesh, lan)
    frac_core = (core & mesh.interior).sum() / max(mesh.interior.sum(), 1)
    energy = hx ** 2 + hy ** 2
    conf = np.clip(energy[core].sum(axis=0) / (energy.sum(axis=0) + 1e-30),
                   0.0, 1.0)
    ne = betas / dtype(lan.k0)
    keep = (ne > lan.n_clad) & (ne < lan.n_core * 1.01)
    modes = [{"n_eff": ne[i], "beta": betas[i], "Ex_dofs": hx[:, i],
              "Ey_dofs": hy[:, i], "Hz_dofs": hz[:, i],
              "confinement": conf[i], "div_ratio": div_ratio[i]}
             for i in np.nonzero(keep)[0]]
    if not modes:
        return []
    dr = np.array([m["div_ratio"] for m in modes])
    thr = max(np.median(dr) * 10, dr.min() * 50, 1e-6)
    phys = [m for m in modes if m["div_ratio"] <= thr]
    conf_thr = max(5.0 * frac_core, 0.05)
    guided = [m for m in phys if m["confinement"] >= conf_thr] or phys
    guided.sort(key=lambda m: -m["n_eff"])
    return guided


def scalar_modes(mesh, lan, n_modes: int, k: int, dtype=np.float64,
                 parts=None) -> list:
    """The program's scalar mode dicts (n_eff, beta, field_vector,
    confinement, core_overlap) of the ``k`` eigenpairs nearest the
    shift, after its guided window, M-normalization and the cascade
    selection of ``mode_filter="cascade"``, sorted by n_eff."""
    ops = fem.scalar(mesh, lan, parts)
    A, B = ops["A"].astype(dtype), ops["B"].astype(dtype)
    sigma = -(lan.k0 * (lan.n_core - 0.008)) ** 2
    lam, V = eigsh(A.tocsc(), k=k, M=B.tocsc(), sigma=dtype(sigma),
                   which="LM")
    order = np.argsort(lam)
    lam, V = lam[order], V[:, order]
    ne = np.sqrt(np.maximum(-lam, 0.0)) / dtype(lan.k0)
    keep = (lam < 0) & (ne > lan.n_clad) & (ne < lan.n_core * 1.005)
    lam, ne, V = lam[keep], ne[keep], V[:, keep]
    V = V / np.sqrt(np.maximum(np.sum(V * (B @ V), axis=0), 1e-30))
    modes = [{"n_eff": ne[i], "beta": dtype(lan.k0) * ne[i],
              "field_vector": V[:, i]} for i in range(V.shape[1])]
    modes.sort(key=lambda m: -m["n_eff"])
    modes = modes[: max(3 * n_modes, n_modes)]
    return cascade(mesh, lan, modes, B, dtype)


def cascade(mesh, lan, modes, B, dtype=np.float64):
    """The reference CLI's guided-mode selection (the program's
    ``ScalarHelmholtzSolver._cascade_filter``): loose (1.10 r) and
    strict core masses, the threshold cascade 0.85, 0.70, 0.50, 0.30
    with core overlap at least 0.80, the top 3 N by confinement."""
    if not modes:
        return modes
    Ml = fem.core_mass(mesh, lan, 1.10).astype(dtype)
    Ms = fem.core_mass(mesh, lan, 1.00).astype(dtype)
    for m in modes:
        v = m["field_vector"]
        d = v @ (B @ v) + dtype(1e-20)
        m["confinement"] = np.clip(v @ (Ml @ v) / d, 0.0, 1.0)
        m["core_overlap"] = np.clip(v @ (Ms @ v) / d, 0.0, 1.0)
    N = lan.n_cores

    def ok(m, thr):
        return m["confinement"] >= thr and m["core_overlap"] >= 0.80

    kept = [m for m in modes if ok(m, 0.85)]
    if len(kept) < N:
        for thr in (0.70, 0.50, 0.30):
            alt = [m for m in modes if ok(m, thr)]
            if len(alt) >= N:
                kept = alt
                break
        else:
            kept = sorted(modes, key=lambda m: m["confinement"], reverse=True)
    kept.sort(key=lambda m: m["confinement"], reverse=True)
    kept = kept[: 3 * N]
    kept.sort(key=lambda m: m["n_eff"], reverse=True)
    return kept
