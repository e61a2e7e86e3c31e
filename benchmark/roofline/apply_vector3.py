"""K1, the packed A(beta_b) apply ``m * sum_e A_e(beta_b)(m X)_e + park_b
(X - m X)`` (``cuda_kernels.apply_vector3``): bytes and f32 operations
of one launch.

Bytes: X read and Y written once, (D, L) f32 each; the element tables
read once: DOFs (E, 6) int32, gradients (E, Q, 6, 2) and weights (E, Q)
f32, 1/eps (B, E, Q); betas, parks (B,), the shape table (Q, 6), the mask
(D,). Operations: 233 f32 operations per (element, quadrature point,
design, column): values and gradients 108, curl and divergence terms 17,
pull-back 108. At the config-1 sweep's shape it is bound by operations.
"""

KERNEL = "apply_vector3_kernel"
WRAPS = "pl_fem_tpu_torch.ops.cuda_kernels.apply_vector3"
FLOPS_PER_POINT = 233


def count(D: int, E: int, Q: int, B: int, k: int):
    """(bytes, f32 operations) of one launch."""
    L = B * 3 * k
    nbytes = 2 * 4 * D * L + 4 * (E * 6 + E * Q * 13 + B * E * Q + B
                                  + Q * 6 + D + B)
    return nbytes, FLOPS_PER_POINT * E * Q * B * k


def work(X, gs, gp, w, inv_eps, betas, *args, **kw):
    D, L = X.shape
    B = betas.shape[0]
    E, Q = w.shape
    return count(D, E, Q, B, L // (3 * B))
