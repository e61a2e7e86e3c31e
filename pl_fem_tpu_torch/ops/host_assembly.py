"""Host-side float64 assembly + Rayleigh-Ritz polish.

Precision split: the device filters subspaces in float32
(ops/kernels.py — throughput side), while final eigenvalue accuracy
comes from exact float64 Rayleigh-Ritz against host-assembled CSR
operators (this module — precision side). The f64 work is O(nnz * k)
per solve — a few SpMV, negligible next to the device filtering — and
keeps the device path in float32.

The element-block math mirrors ops/assembly.py exactly (same quadrature
arrays from DeviceGrid, same forms as the reference's solver_fem.py:
131-150, 252-261); parity between the two paths is tested.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .femgrid import DeviceGrid


def spmm(A: sp.csr_matrix, X: np.ndarray) -> np.ndarray:
    """``A @ X`` for a CSR ``A`` and a dense block ``X``, in their float64
    on torch's CPU threads: scipy's sparse product runs on one core,
    torch's on all of them. The same sums, in another order."""
    At = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(A.indices.dtype, copy=False)),
        torch.from_numpy(A.indices), torch.from_numpy(A.data),
        size=A.shape, check_invariants=False)
    return (At @ torch.from_numpy(np.ascontiguousarray(X))).numpy()


# ---------------------------------------------------------------------------
# numpy element blocks (f64, vectorized)
# ---------------------------------------------------------------------------

def _wsum_np(qp_w, coeff, a, b):
    return np.einsum("eq,eqi,eqj->eij", qp_w * coeff, a, b, optimize=True)


def eps_at_quadrature_np(dg: DeviceGrid, eps) -> Tuple[np.ndarray, np.ndarray]:
    x = dg.qp_xy[..., 0]
    y = dg.qp_xy[..., 1]
    pos = np.asarray(eps.positions)
    rad = np.asarray(eps.core_radii)
    d2 = ((x[..., None] - pos[:, 0]) ** 2 + (y[..., None] - pos[:, 1]) ** 2)
    in_core = np.any(d2 <= rad**2, axis=-1)
    eps_re = np.where(in_core, eps.eps_core, eps.eps_clad)
    if eps.pml_thickness > 0.0 and eps.pml_start > 0.0:
        rho = np.clip((np.hypot(x, y) - eps.pml_start) / eps.pml_thickness,
                      0.0, 1.0)
        eps_im = eps_re * eps.pml_strength * rho ** eps.pml_order
    else:
        eps_im = np.zeros_like(eps_re)
    return eps_re, eps_im


def scalar_blocks_np(dg: DeviceGrid, eps_re) -> Dict[str, np.ndarray]:
    gx = dg.grad_phys[..., 0]
    gy = dg.grad_phys[..., 1]
    Nq = np.broadcast_to(dg.shape_vals[None], dg.qp_w.shape + (6,))
    one = np.ones_like(eps_re)
    return {
        "K": _wsum_np(dg.qp_w, one, gx, gx) + _wsum_np(dg.qp_w, one, gy, gy),
        "M": _wsum_np(dg.qp_w, one, Nq, Nq),
        "Me": _wsum_np(dg.qp_w, eps_re, Nq, Nq),
    }


def vector3_prims_np(dg: DeviceGrid, eps_re,
                     weights: Optional[Dict[str, np.ndarray]] = None
                     ) -> Dict[str, np.ndarray]:
    """Quadrature primitives; ``weights`` overrides the default
    (i -> 1/eps, u -> 1) per-quadrature-point weight functions (zeros
    allowed — used by the sweep family's linear decomposition)."""
    gx = dg.grad_phys[..., 0]
    gy = dg.grad_phys[..., 1]
    Nq = np.broadcast_to(dg.shape_vals[None], dg.qp_w.shape + (6,))
    if weights is None:
        weights = {"i": 1.0 / eps_re, "u": np.ones_like(dg.qp_w)}
    out = {}
    zero_block = None
    for wname in ("i", "u"):
        w = weights.get(wname)
        if w is None:
            if zero_block is None:
                zero_block = np.zeros((dg.qp_w.shape[0], 6, 6))
            for suffix in ("_gxgx", "_gygy", "_gxgy", "_nn", "_ngx", "_ngy"):
                out[wname + suffix] = zero_block
            continue
        out[wname + "_gxgx"] = _wsum_np(dg.qp_w, w, gx, gx)
        out[wname + "_gygy"] = _wsum_np(dg.qp_w, w, gy, gy)
        out[wname + "_gxgy"] = _wsum_np(dg.qp_w, w, gx, gy)
        out[wname + "_nn"] = _wsum_np(dg.qp_w, w, Nq, Nq)
        out[wname + "_ngx"] = _wsum_np(dg.qp_w, w, Nq, gx)
        out[wname + "_ngy"] = _wsum_np(dg.qp_w, w, Nq, gy)
    return out


def combine_vector3_np(prim: Dict[str, np.ndarray], beta: float,
                       alpha_p: float = 1.0,
                       derivative: bool = False) -> Dict:
    """Mirror of ops/assembly.py ``combine_vector3`` in numpy."""
    ap = alpha_p
    T = lambda M: np.swapaxes(M, 1, 2)  # noqa: E731
    if not derivative:
        c0, c1, c2 = 1.0, beta, beta * beta
    else:
        c0, c1, c2 = 0.0, 1.0, 2.0 * beta
    return {
        (0, 0): c0 * (prim["i_gygy"] + ap * prim["u_gxgx"]) + c2 * prim["i_nn"],
        (1, 1): c0 * (prim["i_gxgx"] + ap * prim["u_gygy"]) + c2 * prim["i_nn"],
        (2, 2): c0 * (prim["i_gxgx"] + prim["i_gygy"]) + c2 * ap * prim["u_nn"],
        (0, 1): c0 * (-T(prim["i_gxgy"]) + ap * prim["u_gxgy"]),
        (0, 2): c1 * (-prim["i_ngx"] - ap * T(prim["u_ngx"])),
        (1, 2): c1 * (-prim["i_ngy"] - ap * T(prim["u_ngy"])),
    }


# ---------------------------------------------------------------------------
# shared-pattern CSR
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SharedCSR:
    """CSR with a frozen sparsity pattern and pluggable data.

    ``perm`` scatters flat COO entries into CSR data slots (duplicates
    summed), so re-assembling with new element blocks (e.g. a new beta)
    is one bincount — no pattern rebuild.
    """

    indptr: np.ndarray
    indices: np.ndarray
    perm: np.ndarray        # (n_coo,) CSR slot of each COO entry
    shape: Tuple[int, int]

    def with_blocks(self, flat_values: np.ndarray) -> sp.csr_matrix:
        data = np.bincount(self.perm, weights=flat_values,
                           minlength=len(self.indices))
        return sp.csr_matrix((data, self.indices, self.indptr),
                             shape=self.shape)


_PATTERN_CACHE: dict = {}


def _grid_key(dg: DeviceGrid, C: int) -> tuple:
    import zlib

    return (zlib.crc32(dg.elem_dofs[: dg.n_elems].tobytes()),
            dg.n_elems, dg.n_dofs, C)


def build_pattern(rows: np.ndarray, cols: np.ndarray, n: int) -> SharedCSR:
    from ..native import build_pattern_native

    native = build_pattern_native(rows, cols, n)
    if native is not None:
        perm, indices, indptr = native
        return SharedCSR(indptr=indptr, indices=indices, perm=perm,
                         shape=(n, n))

    order = np.lexsort((cols, rows))
    r_s, c_s = rows[order], cols[order]
    new = np.ones(len(r_s), dtype=bool)
    new[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
    slot_of_sorted = np.cumsum(new) - 1
    perm = np.empty(len(rows), dtype=np.int64)
    perm[order] = slot_of_sorted
    indices = c_s[new]
    uniq_rows = r_s[new]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, uniq_rows + 1, 1)
    indptr = np.cumsum(indptr)
    return SharedCSR(indptr=indptr, indices=indices.astype(np.int32),
                     perm=perm, shape=(n, n))


def scalar_pattern(dg: DeviceGrid) -> SharedCSR:
    """Pattern for a single-component operator on the valid DOFs.

    Cached per grid connectivity — designs sharing a mesh (multi-band
    sweeps, beta passes) reuse one pattern; only data vectors change.
    """
    key = _grid_key(dg, 1)
    pat = _PATTERN_CACHE.get(key)
    if pat is None:
        ed = dg.elem_dofs[: dg.n_elems].astype(np.int64)
        rows = np.repeat(ed[:, :, None], 6, axis=2).ravel()
        cols = np.repeat(ed[:, None, :], 6, axis=1).ravel()
        pat = build_pattern(rows, cols, dg.n_dofs)
        _PATTERN_CACHE[key] = pat
    return pat


def blockc_pattern(dg: DeviceGrid, C: int) -> SharedCSR:
    """Pattern for a C-component stacked operator (cached, see above)."""
    key = _grid_key(dg, C)
    pat = _PATTERN_CACHE.get(key)
    if pat is None:
        ed = dg.elem_dofs[: dg.n_elems].astype(np.int64)
        n = dg.n_dofs
        edC = np.concatenate([ed + c * n for c in range(C)], axis=1)
        rows = np.repeat(edC[:, :, None], 6 * C, axis=2).ravel()
        cols = np.repeat(edC[:, None, :], 6 * C, axis=1).ravel()
        pat = build_pattern(rows, cols, C * n)
        _PATTERN_CACHE[key] = pat
    return pat


def stack_blocks_np(blocks: Dict, C: int) -> np.ndarray:
    some = next(iter(blocks.values()))
    zero = np.zeros_like(some)
    rows = []
    for ci in range(C):
        cols = []
        for cj in range(C):
            if (ci, cj) in blocks:
                b = blocks[(ci, cj)]
            elif (cj, ci) in blocks:
                b = np.swapaxes(blocks[(cj, ci)], 1, 2)
            else:
                b = zero
            cols.append(b)
        rows.append(np.concatenate(cols, axis=2))
    return np.concatenate(rows, axis=1)


def _flat(blocks: np.ndarray, n_elems: int) -> np.ndarray:
    return np.ascontiguousarray(blocks[:n_elems]).ravel()


# ---------------------------------------------------------------------------
# f64 pencils with polish operations
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostScalarPencil:
    A: sp.csr_matrix
    B: sp.csr_matrix

    def rr(self, X: np.ndarray):
        return rr_pencil(self.A, self.B, X)


def build_host_scalar(dg: DeviceGrid, eps_params, k0: float,
                      pattern: Optional[SharedCSR] = None) -> HostScalarPencil:
    eps_re, _ = eps_at_quadrature_np(dg, eps_params)
    blk = scalar_blocks_np(dg, eps_re)
    pat = pattern or scalar_pattern(dg)
    A = pat.with_blocks(_flat(blk["K"] - k0**2 * blk["Me"], dg.n_elems))
    B = pat.with_blocks(_flat(blk["M"], dg.n_elems))
    return HostScalarPencil(A=A, B=B)


@dataclasses.dataclass
class HostVector3:
    """A(beta) = A0 + beta A1 + beta^2 A2 over shared pattern; M3 mass."""

    pat: SharedCSR
    d0: np.ndarray
    d1: np.ndarray
    d2: np.ndarray
    M3: sp.csr_matrix
    # scalar-pattern data for divergence diagnostics
    spat: SharedCSR
    Dxx: sp.csr_matrix
    Dyy: sp.csr_matrix
    Dxy: sp.csr_matrix      # [i,j] = int dx phi_i dy phi_j
    # Im(eps)-weighted mass (PML absorption) for the first-order
    # radiation perturbation Im(beta^2) ~ k0^2 <h|Im eps|h> / <h|M|h>
    # (reference analog: complex-eps scalar path, main.py:108-122).
    # None when the PML is disabled.
    Mim: Optional[sp.csr_matrix] = None

    def A_of(self, beta: float) -> sp.csr_matrix:
        data = self.d0 + beta * self.d1 + beta * beta * self.d2
        return sp.csr_matrix((data, self.pat.indices, self.pat.indptr),
                             shape=self.pat.shape)

    def Ai(self) -> Tuple[sp.csr_matrix, sp.csr_matrix, sp.csr_matrix]:
        mk = lambda d: sp.csr_matrix(  # noqa: E731
            (d, self.pat.indices, self.pat.indptr), shape=self.pat.shape)
        return mk(self.d0), mk(self.d1), mk(self.d2)

    def Ai_matvec(self, V: np.ndarray):
        """(A0 V, A1 V, A2 V) — the only design-specific products the
        polish needs (see ``LazyVector3`` for the family fast path)."""
        return tuple(spmm(A, V) for A in self.Ai())


def build_host_vector3(dg: DeviceGrid, eps_params,
                       alpha_p: float = 1.0,
                       conform: bool = False) -> HostVector3:
    """f64 quadratic pencil A(beta) for one design on ``dg``.

    ``conform=True``: when the grid's conforming circles (dg.circles)
    do not match ``eps_params``' core radii (a bucket-class grid with
    an off-center member), re-derive the quadrature tables on the
    member-conforming radial deformation (member_deformed_coords) so
    the discretization conforms to the MEMBER interface — the same
    operator the sweep family's 'deform' correction produces. Falls
    back to the plain (non-conforming) assembly when inapplicable.
    """
    if conform:
        dg = _conforming_tables(dg, eps_params) or dg
    eps_re, eps_im = eps_at_quadrature_np(dg, eps_params)
    prim = vector3_prims_np(dg, eps_re)
    T = dg.n_elems

    pat = blockc_pattern(dg, 3)
    A0 = stack_blocks_np(combine_vector3_np(prim, 0.0, alpha_p), 3)
    A1 = stack_blocks_np(
        combine_vector3_np(prim, 0.0, alpha_p, derivative=True), 3)
    Afull = stack_blocks_np(combine_vector3_np(prim, 1.0, alpha_p), 3)
    A2 = Afull - A0 - A1

    def slots(flat):
        return np.bincount(pat.perm, weights=flat,
                           minlength=len(pat.indices))

    d0 = slots(_flat(A0, T))
    d1 = slots(_flat(A1, T))
    d2 = slots(_flat(A2, T))

    spat = scalar_pattern(dg)
    M = spat.with_blocks(_flat(prim["u_nn"], T))
    M3 = sp.block_diag([M, M, M], format="csr")
    Dxx = spat.with_blocks(_flat(prim["u_gxgx"], T))
    Dyy = spat.with_blocks(_flat(prim["u_gygy"], T))
    Dxy = spat.with_blocks(_flat(prim["u_gxgy"], T))
    Mim = None
    if np.any(eps_im > 0.0):
        Nq = np.broadcast_to(dg.shape_vals[None], dg.qp_w.shape + (6,))
        Mim = spat.with_blocks(
            _flat(_wsum_np(dg.qp_w, eps_im, Nq, Nq), T))
    return HostVector3(pat=pat, d0=d0, d1=d1, d2=d2, M3=M3,
                       spat=spat, Dxx=Dxx, Dyy=Dyy, Dxy=Dxy, Mim=Mim)


@dataclasses.dataclass
class HostVector3Family:
    """Per-grid precompute for same-grid sweeps.

    The permittivity is two-valued (core/cladding; the PML only touches
    Im eps and the host operators use Re eps), so every 1/eps-weighted
    data vector is LINEAR in (1/eps_core, 1/eps_clad):

        d_i(design) = (1/eps_core) d_i^core + (1/eps_clad) d_i^clad + d_i^u

    Instantiating a design is three axpys over the shared pattern —
    ~50 ms instead of a full numpy re-assembly per sweep member.

    Members whose core positions/radii differ from the family's base
    layout (canonical-grid bucket sweeps, dataset/bucketing.py) pass
    their ``eps_params``: the in-core indicator then differs from the
    base on a thin interface annulus only, and ``instantiate`` adds a
    correction assembled over just the elements whose quadrature mask
    changed — exact member operators at a few percent of a rebuild.
    """

    pat: SharedCSR
    spat: SharedCSR
    d_core: np.ndarray     # (3, nnz) float64 beta-powers 0..2
    d_clad: np.ndarray     # (3, nnz)
    d_u: np.ndarray        # (3, nnz)
    M3: sp.csr_matrix
    Dxx: sp.csr_matrix
    Dyy: sp.csr_matrix
    Dxy: sp.csr_matrix
    # sigma-weighted mass: Im(eps) = eps_clad * sigma in the PML annulus
    # (cores never reach the PML), so Mim is linear in eps_clad too
    Msig: Optional[sp.csr_matrix] = None
    # base-layout quadrature geometry for mask-correction instantiation
    dg: Optional[DeviceGrid] = None
    in_core_base: Optional[np.ndarray] = None   # (E, Q) bool
    alpha_p: float = 1.0
    # base core layout (for the member-conforming deformation)
    base_positions: Optional[np.ndarray] = None  # (C, 2)
    base_radii: Optional[np.ndarray] = None      # (C,)

    def _mask_correction(self, eps_params):
        """Sparse i-channel correction for weight (m_member - m_base).

        Returns ``(slots, vals)`` with ``slots`` the affected CSR data
        positions (int64, (s,)) and ``vals`` their (3, s) beta-power
        data — NOT a dense (3, nnz) vector: members touch only an
        interface annulus, and a dense correction per member (~150 MB
        at production mesh) made the <=16-entry cache a multi-GB
        resident set whose allocator churn dominated the polish
        (measured 4.2 s/instantiate vs 0.5 s without corrections)."""
        dg = self.dg
        x = dg.qp_xy[..., 0]
        y = dg.qp_xy[..., 1]
        pos = np.asarray(eps_params.positions)
        rad = np.asarray(eps_params.core_radii)
        d2 = ((x[..., None] - pos[:, 0]) ** 2
              + (y[..., None] - pos[:, 1]) ** 2)
        m_new = np.any(d2 <= rad**2, axis=-1)
        diff = m_new[: dg.n_elems] != self.in_core_base[: dg.n_elems]
        elems = np.where(diff.any(axis=1))[0]
        if len(elems) == 0:
            return None
        w = (m_new[: dg.n_elems].astype(np.float64)
             - self.in_core_base[: dg.n_elems].astype(np.float64))
        # assemble the i-channel primitives on the changed elements only
        sub = _SubGrid(dg, elems)
        prim = vector3_prims_np(sub, None,
                                weights={"i": w[elems], "u": None})
        A0 = stack_blocks_np(combine_vector3_np(prim, 0.0, self.alpha_p), 3)
        A1 = stack_blocks_np(
            combine_vector3_np(prim, 0.0, self.alpha_p, derivative=True), 3)
        Af = stack_blocks_np(combine_vector3_np(prim, 1.0, self.alpha_p), 3)
        A2 = Af - A0 - A1
        perm = self.pat.perm.reshape(dg.n_elems, -1)[elems].ravel()
        uniq, inv = np.unique(perm, return_inverse=True)
        vals = np.stack([
            np.bincount(inv, weights=blocks.ravel(), minlength=len(uniq))
            for blocks in (A0, A1, A2)])
        return uniq, vals

    def _geom_correction(self, eps_params):
        """Member-CONFORMING sparse correction (geometry + indicator).

        Re-assembles the elements inside each core's deformation
        annulus on a radially deformed geometry whose interface
        coincides with the MEMBER circles (``member_deformed_coords``),
        and subtracts the family's base contribution on the same
        elements. Unlike ``_mask_correction`` (indicator-only on the
        class geometry — O(h) interface error, the ~1e-4 bucket floor
        of docs/PARITY_r3.md §A) this yields the member's conforming
        discretization exactly.

        Returns ``("geom", slots, gvals, M3corr)``: ``gvals`` is
        (3 channels [core, clad, u], 3 beta-powers, s) so the combine
        stays linear in (1/eps_core, 1/eps_clad); ``M3corr`` the sparse
        3-block mass correction. None when the deformation is
        inapplicable (caller falls back to the mask correction).
        """
        dg = self.dg
        if dg.circles is None:
            return None            # mesh has no conforming-circle anchor
        centers = dg.circles[:, :2]
        mesh_rad = dg.circles[:, 2]
        mpos = np.asarray(eps_params.positions, dtype=np.float64)
        mrad = np.asarray(eps_params.core_radii, dtype=np.float64)
        if (self.base_positions is None or len(mpos) != len(centers)
                or len(self.base_positions) != len(centers)):
            return None
        tol = 1e-9 * max(float(mesh_rad.max()), 1e-12)
        if (np.max(np.abs(mpos - centers)) > tol
                or np.max(np.abs(self.base_positions - centers)) > tol):
            return None            # centers moved: radial map inapplicable
        if (np.max(np.abs(mrad - mesh_rad)) <= tol
                and np.max(np.abs(self.base_radii - mesh_rad)) <= tol):
            return ("geom", None, None, None)  # conforming, base-identical
        out = member_deformed_coords(dg.dof_coords, centers,
                                     mesh_rad, mrad)
        if out is None:
            return None
        coords_def, moved = out
        T = dg.n_elems
        ed = dg.elem_dofs[:T].astype(np.int64)
        elems_mask = moved[ed].any(axis=1)
        # also cover elements whose quadrature indicator changes even
        # though no node moved (belt and braces; should be empty)
        x = dg.qp_xy[:T, :, 0]
        y = dg.qp_xy[:T, :, 1]
        d2 = ((x[..., None] - mpos[:, 0]) ** 2
              + (y[..., None] - mpos[:, 1]) ** 2)
        chi_cls = np.any(d2 <= mrad**2, axis=-1)
        elems_mask |= (chi_cls != self.in_core_base[:T]).any(axis=1)
        elems = np.where(elems_mask)[0]
        if len(elems) == 0:
            return ("geom", None, None, None)
        tabs = _iso_tables_for_nodes(coords_def[ed[elems]])
        if tabs is None:
            return None            # tangled deformed element
        tg_def = _TableGrid(*tabs)
        tg_cls = _SubGrid(dg, elems)
        # member indicator at deformed qp (conforming: constant per
        # element up to roundoff) / base indicator at class qp
        dd2 = ((tg_def.qp_xy[..., 0][..., None] - mpos[:, 0]) ** 2
               + (tg_def.qp_xy[..., 1][..., None] - mpos[:, 1]) ** 2)
        chi_def = np.any(dd2 <= mrad**2, axis=-1)
        chi_base = self.in_core_base[:T][elems]

        def _triple(prim):
            A0 = stack_blocks_np(
                combine_vector3_np(prim, 0.0, self.alpha_p), 3)
            A1 = stack_blocks_np(
                combine_vector3_np(prim, 0.0, self.alpha_p,
                                   derivative=True), 3)
            Af = stack_blocks_np(
                combine_vector3_np(prim, 1.0, self.alpha_p), 3)
            return A0, A1, Af - A0 - A1

        ch_def = _channel_prims(tg_def, chi_def)
        ch_cls = _channel_prims(tg_cls, chi_base)
        perm = self.pat.perm.reshape(T, -1)[elems].ravel()
        uniq, inv = np.unique(perm, return_inverse=True)
        gvals = np.zeros((3, 3, len(uniq)))
        for c in range(3):
            blocks_d = _triple(ch_def[c])
            blocks_c = _triple(ch_cls[c])
            for i in range(3):
                gvals[c, i] = np.bincount(
                    inv, weights=(blocks_d[i] - blocks_c[i]).ravel(),
                    minlength=len(uniq))
        # scalar mass correction (B inner product of the polish)
        Nq = np.broadcast_to(tg_def.shape_vals[None],
                             tg_def.qp_w.shape + (6,))
        m_def = _wsum_np(tg_def.qp_w, np.ones_like(tg_def.qp_w), Nq, Nq)
        Nqc = np.broadcast_to(tg_cls.shape_vals[None],
                              tg_cls.qp_w.shape + (6,))
        m_cls = _wsum_np(tg_cls.qp_w, np.ones_like(tg_cls.qp_w), Nqc, Nqc)
        sperm = self.spat.perm.reshape(T, -1)[elems].ravel()
        mdata = np.zeros(len(self.spat.indices))
        np.add.at(mdata, sperm, (m_def - m_cls).ravel())
        # COPY the pattern arrays: eliminate_zeros() compacts indices/
        # indptr IN PLACE, and sharing them would corrupt the cached
        # SharedCSR pattern for every later assembly on this grid
        Mc = sp.csr_matrix((mdata, self.spat.indices.copy(),
                            self.spat.indptr.copy()),
                           shape=self.spat.shape)
        Mc.eliminate_zeros()
        M3corr = sp.block_diag([Mc, Mc, Mc], format="csr")
        return ("geom", uniq, gvals, M3corr)

    def _corr_for(self, eps_params, mode: str = "deform"):
        """Cached sparse member correction for one layout.

        ``mode``: 'deform' = member-conforming geometry re-assembly
        (falls back to the indicator mask when inapplicable); 'mask' =
        round-3 indicator-only correction.
        """
        if eps_params is None or self.dg is None:
            return None
        # raw bytes as the key: the cache holds <= 16 entries, and a
        # crc32 collision between two member layouts would silently
        # reuse the wrong interface correction in the f64 polish
        key = (np.ascontiguousarray(eps_params.positions).tobytes(),
               np.ascontiguousarray(eps_params.core_radii).tobytes(),
               mode)
        if key not in self._corr_cache:
            if len(self._corr_cache) > 16:
                self._corr_cache.clear()
            corr = self._geom_correction(eps_params) \
                if mode == "deform" else None
            if corr is None:
                corr = self._mask_correction(eps_params)
                if corr is not None:
                    corr = ("mask",) + corr
            elif corr[1] is None:
                corr = None        # layouts identical: nothing to add
            self._corr_cache[key] = corr
        return self._corr_cache[key]

    def _combine_into(self, out, ic: float, il: float,
                      corr=None):
        """out[i] = ic d_core[i] + il d_clad[i] + d_u[i] (+ corr), chunked.

        ``out`` is a sequence of three 1-D nnz buffers. Chunked
        in-place: the one-expression form allocates four ~150 MB
        temporaries per call at production nnz, which measured 10-40x
        slower than streaming through a preallocated buffer on this
        host (scratch/inst_probe.py)."""
        n = self.d_u.shape[1]
        step = 1 << 21
        for i in range(3):
            oi = out[i]
            for s in range(0, n, step):
                e = min(n, s + step)
                np.multiply(self.d_core[i, s:e], ic, out=oi[s:e])
                oi[s:e] += il * self.d_clad[i, s:e]
                oi[s:e] += self.d_u[i, s:e]
            if corr is not None:
                if corr[0] == "geom":
                    _, slots, gvals, _ = corr
                    oi[slots] += (ic * gvals[0, i] + il * gvals[1, i]
                                  + gvals[2, i])
                else:
                    _, slots, vals = corr
                    oi[slots] += (ic - il) * vals[i]
        return out

    def instantiate(self, eps_core: float, eps_clad: float,
                    eps_params=None,
                    correction: str = "deform") -> "HostVector3":
        ic, il = 1.0 / eps_core, 1.0 / eps_clad
        nnz = self.d_u.shape[1]
        corr = self._corr_for(eps_params, correction)
        d = self._combine_into([np.empty(nnz) for _ in range(3)], ic, il,
                               corr)
        Mim = None if self.Msig is None else eps_clad * self.Msig
        M3 = self.M3
        if corr is not None and corr[0] == "geom" and corr[3] is not None:
            M3 = (M3 + corr[3]).tocsr()
        return HostVector3(pat=self.pat, d0=d[0], d1=d[1], d2=d[2],
                           M3=M3, spat=self.spat, Dxx=self.Dxx,
                           Dyy=self.Dyy, Dxy=self.Dxy, Mim=Mim)

    def design_view(self, eps_core: float, eps_clad: float,
                    eps_params=None,
                    correction: str = "deform") -> "LazyVector3":
        """Zero-copy per-design view for the sweep polish.

        Unlike ``instantiate`` it materializes NO (3, nnz) data: the
        design-specific A_i enter the polish only through A_i @ V
        products (``Ai_matvec``), computed through one family-shared
        scratch buffer. A B=8 production sweep previously held
        8 x ~150 MB instantiated pencils live (measured: instantiate
        was 67 s of a 111 s steady solve_sweep, scratch/prof_sweep.py)."""
        return LazyVector3(fam=self, ic=1.0 / eps_core,
                           il=1.0 / eps_clad, eps_clad=eps_clad,
                           corr=self._corr_for(eps_params, correction))

    def _scratch_views(self):
        """(scratch (3, nnz) buffer, [K0, K1, K2] CSR views over it).

        Three STANDALONE 1-D buffers, not rows of one (3, nnz) array:
        scipy's constructor prunes view arrays (``.base is not None``)
        into copies, which would silently detach the CSR data from the
        buffer being refilled."""
        if self._scratch is None:
            nnz = self.d_u.shape[1]
            self._scratch = [np.empty(nnz) for _ in range(3)]
            self._views = [
                sp.csr_matrix((buf, self.pat.indices, self.pat.indptr),
                              shape=self.pat.shape)
                for buf in self._scratch]
            for buf, K in zip(self._scratch, self._views):
                assert K.data is buf or K.data.base is buf or \
                    np.shares_memory(K.data, buf), \
                    "scipy copied the scratch buffer"
        return self._scratch, self._views

    def __post_init__(self):
        self._corr_cache: dict = {}
        self._scratch = None
        self._views = None


@dataclasses.dataclass
class LazyVector3:
    """Design view of a :class:`HostVector3Family`.

    Quacks like :class:`HostVector3` for everything the sweep polish
    and postprocessing touch (M3/Dxx/Dyy/Dxy/Mim + ``Ai_matvec``)
    while keeping zero per-design operator storage."""

    fam: HostVector3Family
    ic: float
    il: float
    eps_clad: float
    corr: Optional[tuple] = None

    @property
    def M3(self) -> sp.csr_matrix:
        if (self.corr is not None and self.corr[0] == "geom"
                and self.corr[3] is not None):
            if self._m3 is None:
                self._m3 = (self.fam.M3 + self.corr[3]).tocsr()
            return self._m3
        return self.fam.M3

    @property
    def Dxx(self) -> sp.csr_matrix:
        return self.fam.Dxx

    @property
    def Dyy(self) -> sp.csr_matrix:
        return self.fam.Dyy

    @property
    def Dxy(self) -> sp.csr_matrix:
        return self.fam.Dxy

    @property
    def Mim(self) -> Optional[sp.csr_matrix]:
        if self.fam.Msig is None:
            return None
        if self._mim is None:
            self._mim = self.eps_clad * self.fam.Msig
        return self._mim

    def __post_init__(self):
        self._mim = None
        self._m3 = None

    def Ai_matvec(self, V: np.ndarray):
        _, views = self.fam._scratch_views()
        self.fam._combine_into(self.fam._scratch, self.ic, self.il,
                               self.corr)
        return tuple(spmm(A, V) for A in views[:3])


class _SubGrid:
    """Element-subset view of a DeviceGrid (quadrature arrays only)."""

    def __init__(self, dg: DeviceGrid, elems: np.ndarray):
        self.qp_w = dg.qp_w[elems]
        self.qp_xy = dg.qp_xy[elems]
        self.grad_phys = dg.grad_phys[elems]
        self.shape_vals = dg.shape_vals
        self.n_elems = len(elems)


# ---------------------------------------------------------------------------
# member-conforming geometry deformation (bucket sweeps)
# ---------------------------------------------------------------------------

def _iso_tables_for_nodes(nodes: np.ndarray, quad_degree: int = 4):
    """Isoparametric quadrature tables for explicit (T, 6, 2) nodes.

    Mirrors ops/femgrid.py export_device_grid's per-element math.
    Returns (qp_w, qp_xy, grad_phys, shape_vals) or None when any
    element's map is tangled (non-positive detJ at a quadrature point).
    """
    from .quadrature import RULES, p2_shape

    qp, qw = RULES[quad_degree]
    Nv, dN = p2_shape(qp)
    Jq = np.einsum("tia,qib->tqab", nodes, dN)
    detJq = Jq[..., 0, 0] * Jq[..., 1, 1] - Jq[..., 0, 1] * Jq[..., 1, 0]
    if detJq.min() <= 0.0:
        return None
    invJTq = np.empty_like(Jq)
    invJTq[..., 0, 0] = Jq[..., 1, 1]
    invJTq[..., 0, 1] = -Jq[..., 1, 0]
    invJTq[..., 1, 0] = -Jq[..., 0, 1]
    invJTq[..., 1, 1] = Jq[..., 0, 0]
    invJTq = invJTq / detJq[..., None, None]
    grad_phys = np.einsum("tqab,qib->tqia", invJTq, dN)
    qp_xy = np.einsum("qi,tia->tqa", Nv, nodes)
    qp_w = np.abs(detJq) * qw[None, :]
    return qp_w, qp_xy, grad_phys, Nv


def member_deformed_coords(dof_coords: np.ndarray, centers: np.ndarray,
                           mesh_rad: np.ndarray, member_rad: np.ndarray):
    """Radially deform node coords so the mesh conforms to member circles.

    The bucket class mesh conforms to the CLASS core circles
    ``(centers, mesh_rad)`` — vertices and curved P2 midpoints sit on
    them. Each core gets a piecewise-linear radial map — identity below
    0.55 r_mesh and beyond r_out, r_mesh -> r_member at the interface —
    that carries the on-circle nodes exactly onto the MEMBER circles.
    The deformed mesh is a conforming member discretization: this
    removes the O(h) interior eps-jump error of the non-conforming
    member interface (the ~1e-4 bucket accuracy floor of
    docs/PARITY_r3.md §A).

    Returns (coords_def, moved_mask) or None when the map is
    inapplicable (support radii would overlap neighbouring cores or
    the member interface falls outside the support).
    """
    if len(centers) > 1:
        diff = centers[:, None, :] - centers[None, :, :]
        d2 = (diff**2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        dmin = float(np.sqrt(d2.min()))
    else:
        dmin = np.inf
    r_out = np.minimum(0.45 * dmin, 1.7 * mesh_rad)
    r_in = 0.55 * mesh_rad
    if np.any(r_out < 1.12 * np.maximum(mesh_rad, member_rad)):
        return None
    d_all = np.linalg.norm(dof_coords[:, None, :] - centers[None, :, :],
                           axis=-1)
    ci = np.argmin(d_all, axis=1)                  # nearest core per node
    d = d_all[np.arange(len(dof_coords)), ci]
    rb, rm = mesh_rad[ci], member_rad[ci]
    ri, ro = r_in[ci], r_out[ci]
    inner = ri + (d - ri) * (rm - ri) / (rb - ri)
    outer = rm + (d - rb) * (ro - rm) / (ro - rb)
    d_new = np.where(d <= ri, d, np.where(d <= rb, inner,
                     np.where(d < ro, outer, d)))
    moved = np.abs(d_new - d) > 1e-14 * np.maximum(rb, 1.0)
    coords_def = dof_coords.copy()
    scale = np.where(d > 1e-300, d_new / np.maximum(d, 1e-300), 1.0)
    coords_def[moved] = (centers[ci[moved]]
                         + (dof_coords[moved] - centers[ci[moved]])
                         * scale[moved, None])
    return coords_def, moved


_V3_SUFFIXES = ("_gxgx", "_gygy", "_gxgy", "_nn", "_ngx", "_ngy")


def _channel_prims(tg, chi: np.ndarray):
    """(core, clad, u) channel primitive dicts on tables ``tg``.

    chi: (E, Q) member in-core indicator at tg's quadrature points.
    core = 1/eps weight restricted to chi, clad = restricted to 1-chi,
    u = unweighted — the linear decomposition the family stores.
    """
    ones = np.ones_like(tg.qp_w)
    pa = vector3_prims_np(tg, None, weights={"i": chi.astype(np.float64),
                                             "u": ones})
    pb = vector3_prims_np(tg, None, weights={"i": ones, "u": None})
    zero = np.zeros_like(pa["i_nn"])
    core = {"i" + s: pa["i" + s] for s in _V3_SUFFIXES}
    clad = {"i" + s: pb["i" + s] - pa["i" + s] for s in _V3_SUFFIXES}
    for d in (core, clad):
        for s in _V3_SUFFIXES:
            d["u" + s] = zero
    uch = {"u" + s: pa["u" + s] for s in _V3_SUFFIXES}
    for s in _V3_SUFFIXES:
        uch["i" + s] = zero
    return core, clad, uch


def _conforming_tables(dg: DeviceGrid, eps_params):
    """DeviceGrid copy whose quadrature tables conform to the member.

    Full-grid variant of the family's sparse 'deform' correction, for
    one-off single-design assemblies on a foreign (bucket-class) grid.
    Returns None when the deformation is inapplicable (no circles,
    moved centers, already conforming, tangled elements).
    """
    if dg.circles is None:
        return None
    centers = dg.circles[:, :2]
    mesh_rad = dg.circles[:, 2]
    mpos = np.asarray(eps_params.positions, dtype=np.float64)
    mrad = np.asarray(eps_params.core_radii, dtype=np.float64)
    if len(mpos) != len(centers):
        return None
    tol = 1e-9 * max(float(mesh_rad.max()), 1e-12)
    if np.max(np.abs(mpos - centers)) > tol:
        return None
    if np.max(np.abs(mrad - mesh_rad)) <= tol:
        return None                       # already conforming
    out = member_deformed_coords(dg.dof_coords, centers, mesh_rad, mrad)
    if out is None:
        return None
    coords_def, _ = out
    T = dg.n_elems
    ed = dg.elem_dofs[:T].astype(np.int64)
    tabs = _iso_tables_for_nodes(coords_def[ed])
    if tabs is None:
        return None

    def full(new, old):
        if old.shape[0] > T:
            return np.concatenate([new, old[T:]], axis=0)
        return new

    qp_w, qp_xy, grad_phys, _ = tabs
    return dataclasses.replace(
        dg, qp_w=full(qp_w, dg.qp_w), qp_xy=full(qp_xy, dg.qp_xy),
        grad_phys=full(grad_phys, dg.grad_phys))


class _TableGrid:
    """Explicit quadrature tables quacking like a DeviceGrid subset."""

    def __init__(self, qp_w, qp_xy, grad_phys, shape_vals):
        self.qp_w = qp_w
        self.qp_xy = qp_xy
        self.grad_phys = grad_phys
        self.shape_vals = shape_vals
        self.n_elems = qp_w.shape[0]


_FAMILY_CACHE: dict = {}
_FAMILY_LOCK = threading.RLock()


def build_host_vector3_family(dg: DeviceGrid, eps_params,
                              alpha_p: float = 1.0) -> HostVector3Family:
    """Precompute the linear-coefficient data for one grid + layout.

    Cached per (grid connectivity, core layout, alpha): sweeps and
    repeat solves on a shared mesh pay the ~tens-of-seconds build once.
    Serialized under a lock: the dataset engine's bucket pipeline calls
    this from two threads, and an unsynchronized LRU could double-build
    a family or pop a key another thread just inserted.
    """
    import zlib

    key = (_grid_key(dg, 3),
           zlib.crc32(np.ascontiguousarray(eps_params.positions).tobytes()),
           zlib.crc32(np.ascontiguousarray(eps_params.core_radii).tobytes()),
           float(alpha_p))
    with _FAMILY_LOCK:
        fam = _FAMILY_CACHE.get(key)
        if fam is not None:
            return fam
        fam = _build_host_vector3_family(dg, eps_params, alpha_p)
        # LRU of a few families (~100s MB each). One slot thrashed: the
        # two-grid bootstrap alternates coarse/fine grids every solve,
        # and a single-entry cache rebuilt one of them per sweep
        # (measured ~7 s).
        while len(_FAMILY_CACHE) >= 4:
            _FAMILY_CACHE.pop(next(iter(_FAMILY_CACHE)))
        _FAMILY_CACHE[key] = fam
        return fam


def _build_host_vector3_family(dg: DeviceGrid, eps_params,
                               alpha_p: float = 1.0) -> HostVector3Family:
    x = dg.qp_xy[..., 0]
    y = dg.qp_xy[..., 1]
    pos = np.asarray(eps_params.positions)
    rad = np.asarray(eps_params.core_radii)
    d2 = ((x[..., None] - pos[:, 0]) ** 2 + (y[..., None] - pos[:, 1]) ** 2)
    in_core = np.any(d2 <= rad**2, axis=-1).astype(np.float64)

    pat = blockc_pattern(dg, 3)
    spat = scalar_pattern(dg)
    T = dg.n_elems

    def data_triple(weights):
        prim = vector3_prims_np(dg, None, weights=weights)
        A0 = stack_blocks_np(combine_vector3_np(prim, 0.0, alpha_p), 3)
        A1 = stack_blocks_np(
            combine_vector3_np(prim, 0.0, alpha_p, derivative=True), 3)
        Afull = stack_blocks_np(combine_vector3_np(prim, 1.0, alpha_p), 3)
        A2 = Afull - A0 - A1

        def slots(blocks):
            return np.bincount(pat.perm,
                               weights=_flat(blocks, T),
                               minlength=len(pat.indices))

        # float64: the sweep path's polish promises exact-f64 operator
        # coefficients, same as the single-design build_host_vector3
        return np.stack([slots(A0), slots(A1), slots(A2)])

    ones = np.ones_like(dg.qp_w)
    d_core = data_triple({"i": in_core, "u": None})
    d_clad = data_triple({"i": 1.0 - in_core, "u": None})
    d_u = data_triple({"i": None, "u": ones})

    prim_u = vector3_prims_np(dg, None, weights={"i": None, "u": ones})
    M = spat.with_blocks(_flat(prim_u["u_nn"], T))
    M3 = sp.block_diag([M, M, M], format="csr")
    Dxx = spat.with_blocks(_flat(prim_u["u_gxgx"], T))
    Dyy = spat.with_blocks(_flat(prim_u["u_gygy"], T))
    Dxy = spat.with_blocks(_flat(prim_u["u_gxgy"], T))
    Msig = None
    if eps_params.pml_thickness > 0.0 and eps_params.pml_start > 0.0:
        xq = dg.qp_xy[..., 0]
        yq = dg.qp_xy[..., 1]
        rho = np.clip((np.hypot(xq, yq) - eps_params.pml_start)
                      / eps_params.pml_thickness, 0.0, 1.0)
        sigma = eps_params.pml_strength * rho ** eps_params.pml_order
        if np.any(sigma > 0.0):
            Nq = np.broadcast_to(dg.shape_vals[None], dg.qp_w.shape + (6,))
            Msig = spat.with_blocks(
                _flat(_wsum_np(dg.qp_w, sigma, Nq, Nq), T))
    return HostVector3Family(pat=pat, spat=spat, d_core=d_core,
                             d_clad=d_clad, d_u=d_u, M3=M3, Dxx=Dxx,
                             Dyy=Dyy, Dxy=Dxy, Msig=Msig, dg=dg,
                             in_core_base=in_core.astype(bool),
                             alpha_p=alpha_p,
                             base_positions=pos.astype(np.float64),
                             base_radii=rad.astype(np.float64))


# ---------------------------------------------------------------------------
# f64 subspace algebra
# ---------------------------------------------------------------------------

def b_orthonormalize_np(X: np.ndarray, B: sp.csr_matrix,
                        drop_tol: float = 1e-10,
                        return_BV: bool = False, matmul=None):
    """Whiten X in the B inner product; drops near-dependent directions.

    With ``return_BV`` also returns B @ V reusing the B @ X product
    (V = X T implies B V = (B X) T — no second SpMV). ``matmul(B, X)``
    replaces ``B @ X`` (``spmm``: on all host cores)."""
    BX = B @ X if matmul is None else matmul(B, X)
    G = X.T @ BX
    G = 0.5 * (G + G.T)
    w, V = np.linalg.eigh(G)
    keep = w > drop_tol * w.max()
    T = V[:, keep] / np.sqrt(w[keep])[None, :]
    if return_BV:
        return X @ T, BX @ T
    return X @ T


def rr_pencil(A: sp.csr_matrix, B: sp.csr_matrix, X: np.ndarray,
              mask: Optional[np.ndarray] = None):
    """Exact f64 Rayleigh-Ritz of (A, B) on span(X).

    ``mask`` (0/1 per row) restricts the residual to free DOFs when X
    spans a Dirichlet-constrained subspace (boundary rows of A X are
    reaction forces, not errors).

    Returns (theta ascending, B-orthonormal Ritz vectors, rel residuals).
    """
    X = b_orthonormalize_np(X, B)
    AX = A @ X
    H = X.T @ AX
    H = 0.5 * (H + H.T)
    theta, V = np.linalg.eigh(H)
    Xr = X @ V
    AXr = AX @ V
    R = AXr - (B @ Xr) * theta[None, :]
    if mask is not None:
        R = R * mask[:, None]
    res = np.linalg.norm(R, axis=0) / (np.linalg.norm(AXr, axis=0) + 1e-300)
    return theta, Xr, res


_SLAB = 1 << 15     # rows of the polish's residual formed at a time


def quadratic_subspace(hv: HostVector3, X: np.ndarray, k0: float,
                       beta_lo: float, beta_hi: float,
                       mask: Optional[np.ndarray] = None):
    """Solve (A0 + b A1 + b^2 A2 - k0^2 M3) h = 0 projected on span(X).

    Companion linearization of the projected quadratic pencil; keeps
    real roots in (beta_lo, beta_hi). Returns (betas desc, H fields
    (n3, m), V basis, residuals of the full-space quadratic pencil).
    """
    import scipy.linalg as sla

    V, MV = b_orthonormalize_np(X, hv.M3, return_BV=True, matmul=spmm)
    A0V, A1V, A2V = hv.Ai_matvec(V)
    a0 = V.T @ A0V
    a1 = V.T @ A1V
    a2 = V.T @ A2V
    a0 = 0.5 * (a0 + a0.T)
    a1 = 0.5 * (a1 + a1.T)
    a2 = 0.5 * (a2 + a2.T)
    m = a0.shape[0]
    Im = np.eye(m)
    L = np.block([[-a1, -(a0 - k0**2 * Im)], [Im, np.zeros((m, m))]])
    R = np.block([[a2, np.zeros((m, m))], [np.zeros((m, m)), Im]])
    w, Z = sla.eig(L, R)
    keep = (np.abs(w.imag) <= 1e-6 * (np.abs(w.real) + 1.0)) \
        & (w.real > beta_lo) & (w.real < beta_hi)
    betas = w.real[keep]
    ys = Z[m:, keep].real
    ys /= (np.linalg.norm(ys, axis=0) + 1e-300)
    order = np.argsort(-betas)
    betas, ys = betas[order], ys[:, order]
    H = V @ ys
    # Residuals for all roots WITHOUT extra SpMVs: H = V ys and each
    # A_i H = (A_i V) ys is linear in the projected products already
    # computed above (halves the SpMV count of the polish — the 1-core
    # host's serial tail). Formed a slab of rows at a time, with the
    # roots' scales folded into the small coefficient blocks: only the
    # column norms are kept, and no full-size temporary is made.
    coefs = ((A0V, ys), (A1V, ys * betas[None, :]),
             (A2V, ys * (betas**2)[None, :]), (MV, -k0**2 * ys))
    rr = np.zeros(len(betas))
    for lo in range(0, V.shape[0], _SLAB):
        rows = slice(lo, lo + _SLAB)
        R = sum(P[rows] @ C for P, C in coefs)
        if mask is not None:
            R *= mask[rows, None]
        rr += np.einsum("ij,ij->j", R, R)
    res = np.sqrt(rr) / (k0**2 * np.sqrt(np.einsum("ij,ij->j", H, H))
                         + 1e-300)
    return betas, H, V, res
