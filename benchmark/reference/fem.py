"""The discrete operators of both formulations, assembled in float64 on
the host from the reference's own mesh.

Vectorial (H field h = (hx, hy, hz~), divergence penalty alpha): the
quadratic pencil ``Q(beta) = A0 + beta A1 + beta^2 A2 - k0^2 M`` of the
program's formulation (its ``ops/host_assembly.py``), with the weight
1/eps_re in the curl terms and 1 in the penalty and mass terms. Scalar
(LP): ``A = K - k0^2 M_eps`` and the mass ``B``, with ``A psi = -beta^2 B
psi``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _wsum(w, coeff, a, b):
    return np.einsum("eq,eqi,eqj->eij", w * coeff, a, b, optimize=True)


def _csr(mesh, blocks, rows_off=0, cols_off=0, shape=None):
    """Sum the (T, 6, 6) element blocks into a sparse matrix."""
    ed = mesh.elem_dofs
    r = np.repeat(ed[:, :, None], 6, axis=2).ravel() + rows_off
    c = np.repeat(ed[:, None, :], 6, axis=1).ravel() + cols_off
    n = mesh.n_dofs
    return sp.coo_matrix((np.asarray(blocks).ravel(), (r, c)),
                         shape=shape or (n, n)).tocsr()


def _prims(mesh, w):
    gx, gy = mesh.grad[..., 0], mesh.grad[..., 1]
    Nq = np.broadcast_to(mesh.N[None], mesh.qp_w.shape + (6,))
    return {"gxgx": _wsum(mesh.qp_w, w, gx, gx),
            "gygy": _wsum(mesh.qp_w, w, gy, gy),
            "gxgy": _wsum(mesh.qp_w, w, gx, gy),
            "nn": _wsum(mesh.qp_w, w, Nq, Nq),
            "ngx": _wsum(mesh.qp_w, w, Nq, gx),
            "ngy": _wsum(mesh.qp_w, w, Nq, gy)}


def vectorial(mesh, lan, alpha: float) -> dict:
    """A0, A1, A2, M (3n x 3n CSR) and the scalar divergence forms
    Dxx, Dyy, Dxy (n x n) of the H-field formulation."""
    eps = lan.eps_re(mesh.qp_xy[..., 0], mesh.qp_xy[..., 1])
    i = _prims(mesh, 1.0 / eps)
    u = _prims(mesh, np.ones_like(mesh.qp_w))
    T = lambda m: np.swapaxes(m, 1, 2)  # noqa: E731
    n = mesh.n_dofs
    shape = (3 * n, 3 * n)

    def assemble(blocks):
        mats = []
        for (a, b), blk in blocks.items():
            mats.append(_csr(mesh, blk, a * n, b * n, shape))
            if a != b:
                mats.append(_csr(mesh, T(blk), b * n, a * n, shape))
        return sum(mats[1:], mats[0]).tocsr()

    A0 = assemble({(0, 0): i["gygy"] + alpha * u["gxgx"],
                   (1, 1): i["gxgx"] + alpha * u["gygy"],
                   (2, 2): i["gxgx"] + i["gygy"],
                   (0, 1): -T(i["gxgy"]) + alpha * u["gxgy"]})
    A1 = assemble({(0, 2): -i["ngx"] - alpha * T(u["ngx"]),
                   (1, 2): -i["ngy"] - alpha * T(u["ngy"])})
    A2 = assemble({(0, 0): i["nn"], (1, 1): i["nn"], (2, 2): alpha * u["nn"]})
    Ms = _csr(mesh, u["nn"])
    return {"A0": A0, "A1": A1, "A2": A2,
            "M": sp.block_diag([Ms, Ms, Ms], format="csr"),
            "Dxx": _csr(mesh, u["gxgx"]), "Dyy": _csr(mesh, u["gygy"]),
            "Dxy": _csr(mesh, u["gxgy"])}


def scalar_parts(mesh, lan) -> dict:
    """K, M_eps and B = M (n x n CSR): A = K - k0^2 M_eps."""
    eps = lan.eps_re(mesh.qp_xy[..., 0], mesh.qp_xy[..., 1])
    gx, gy = mesh.grad[..., 0], mesh.grad[..., 1]
    Nq = np.broadcast_to(mesh.N[None], mesh.qp_w.shape + (6,))
    one = np.ones_like(mesh.qp_w)
    return {"K": _csr(mesh, _wsum(mesh.qp_w, one, gx, gx)
                      + _wsum(mesh.qp_w, one, gy, gy)),
            "Me": _csr(mesh, _wsum(mesh.qp_w, eps, Nq, Nq)),
            "B": _csr(mesh, _wsum(mesh.qp_w, one, Nq, Nq))}


def scalar(mesh, lan, parts=None) -> dict:
    """A = K - k0^2 M_eps and B = M (n x n CSR)."""
    p = parts or scalar_parts(mesh, lan)
    return {"A": (p["K"] - lan.k0 ** 2 * p["Me"]).tocsr(), "B": p["B"]}


def core_mass(mesh, lan, factor: float):
    """Mass matrix weighted by the indicator of the cores scaled by
    ``factor`` at the quadrature points."""
    x, y = mesh.qp_xy[..., 0], mesh.qp_xy[..., 1]
    pos, rad = lan.positions, lan.core_radii
    d2 = ((x[..., None] - pos[:, 0]) ** 2 + (y[..., None] - pos[:, 1]) ** 2)
    w = np.any(d2 <= (factor * rad) ** 2, axis=-1).astype(float)
    Nq = np.broadcast_to(mesh.N[None], mesh.qp_w.shape + (6,))
    return _csr(mesh, _wsum(mesh.qp_w, w, Nq, Nq))


def in_core(mesh, lan):
    """(n,) bool: DOFs inside a core disk."""
    xy = mesh.dof_coords
    d2 = ((xy[:, 0:1] - lan.positions[None, :, 0]) ** 2
          + (xy[:, 1:2] - lan.positions[None, :, 1]) ** 2)
    return np.any(d2 <= lan.core_radii ** 2, axis=-1)
