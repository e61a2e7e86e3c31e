"""Host eigensolver oracle.

Copy of pl_fem_tpu/ops/eig.py. The factorization-free eigensolver that
runs on the device lives in ops/kernels.py (float32 Chebyshev subspace
filtering + host float64 polish in ops/host_assembly.py). This module
keeps the scipy ARPACK shift-invert entry point of the 'hybrid' solver
backends: numerically the reference's algorithm (its solver_fem.py:197,
:261) and the parity oracle of the tests.
"""
from __future__ import annotations


def scipy_eigsh_pencil(A_csr, B_csr, k: int, sigma: float,
                       tol: float = 1e-7, maxiter: int = 12000):
    """ARPACK shift-invert on host CSR matrices (reference-equivalent)."""
    from scipy.sparse.linalg import eigsh

    k = min(k, A_csr.shape[0] - 2)
    return eigsh(A_csr, k=k, M=B_csr, sigma=sigma, which="LM",
                 tol=tol, maxiter=maxiter)
