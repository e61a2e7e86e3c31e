"""Device-side FEM assembly in PyTorch: quadrature factors, permittivity,
element blocks and the mass diagonal.

Port of pl_fem_tpu/ops/assembly.py for the vectorial sweep path and the
scalar Helmholtz pencil. All functions take tensors already on the
target device (``grid_to_device`` and ``grid_from_numpy`` put them
there) and return tensors on it. The permittivity at the quadrature
points is K6 (``triton_kernels.eps_at_quadrature``; for a vectorial
sweep ``assemble_vector3_sweep`` takes 1/eps of all its designs from
one launch of ``triton_kernels.inv_eps_at_quadrature``). The scalar
pencil's permittivity, element blocks and spectrum bound are one K11
launch (``cuda_kernels.scalar_pencil``); K7
(``cuda_kernels.scalar_blocks``) builds the same blocks from a given
permittivity.

Matrix convention: blocks[e, i, j] couples test function i with trial
function j of element e; global A[I, J] = sum_e blocks[e, i, j] over the
(I=dof(e,i), J=dof(e,j)) scatter.
"""
from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.weak import WeakTensorKeyDictionary

from ..models.geometry import EpsParams
from . import triton_kernels


class GridArrays(NamedTuple):
    """Device-resident subset of DeviceGrid used by assembly/operators."""

    elem_dofs: torch.Tensor          # (E, 6) int32
    elem_valid: torch.Tensor         # (E,) bool
    dof_gather_v: torch.Tensor       # (split, Wv) int32 transpose-gather table
    dof_gather_valid_v: torch.Tensor  # (split, Wv) bool
    dof_gather_e: torch.Tensor       # (D - split, 2) int32 (edge-midpoint DOFs)
    dof_gather_valid_e: torch.Tensor  # (D - split, 2) bool
    inv_jt: torch.Tensor             # (E, 2, 2) J^{-T}
    qp_xy: torch.Tensor              # (E, Q, 2)
    qp_w: torch.Tensor               # (E, Q)
    grad_phys: torch.Tensor          # (E, Q, 6, 2)
    shape_vals: torch.Tensor         # (Q, 6)
    dof_coords: torch.Tensor         # (D, 2)
    interior_mask: torch.Tensor      # (D,) float (1 interior, 0 boundary/pad)
    dof_valid: torch.Tensor          # (D,) float


def grid_to_device(dg, device, dtype=torch.float32) -> GridArrays:
    """Ship a DeviceGrid's arrays to ``device``; floats as ``dtype``.

    ``dg`` is any object with the DeviceGrid array fields as numpy
    arrays (the port's own DeviceGrid or the JAX package's).
    """
    def t(a, dt):
        return torch.tensor(np.asarray(a), device=device, dtype=dt)

    return GridArrays(
        elem_dofs=t(dg.elem_dofs, torch.int32),
        elem_valid=t(dg.elem_valid, torch.bool),
        dof_gather_v=t(dg.dof_gather_v, torch.int32),
        dof_gather_valid_v=t(dg.dof_gather_valid_v, torch.bool),
        dof_gather_e=t(dg.dof_gather_e, torch.int32),
        dof_gather_valid_e=t(dg.dof_gather_valid_e, torch.bool),
        inv_jt=t(dg.inv_jt, dtype),
        qp_xy=t(dg.qp_xy, dtype),
        qp_w=t(dg.qp_w, dtype),
        grad_phys=t(dg.grad_phys, dtype),
        shape_vals=t(dg.shape_vals, dtype),
        dof_coords=t(dg.dof_coords, dtype),
        interior_mask=t(dg.interior_mask, dtype),
        dof_valid=t(dg.dof_valid, dtype),
    )


def grid_from_numpy(dg_like, device) -> GridArrays:
    """The port's f32 device grid from any object carrying the DeviceGrid
    fields as numpy arrays, the JAX package's DeviceGrid included (the
    tests feed both packages one mesh this way)."""
    return grid_to_device(dg_like, device, torch.float32)


def qfactor_sweep_from_numpy(invJT, w, inv_eps, gp, device):
    """A QFactorSweep of f32 tensors on ``device`` from numpy arrays
    (invJT (E,2,2), w (E,Q), inv_eps (B,E,Q), gp (E,Q,6,2))."""
    from .kernels import QFactorSweep

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    return QFactorSweep(invJT=t(invJT), w=t(w), inv_eps=t(inv_eps), gp=t(gp))


class EpsArrays(NamedTuple):
    """Permittivity parameters as device tensors.

    ``pml_start <= 0`` disables the PML branchlessly.
    """

    positions: torch.Tensor     # (N, 2)
    core_radii: torch.Tensor    # (N,)
    eps_core: torch.Tensor      # scalar
    eps_clad: torch.Tensor
    pml_start: torch.Tensor
    pml_thickness: torch.Tensor
    pml_strength: torch.Tensor
    pml_order: torch.Tensor


class EpsBatch(NamedTuple):
    """The permittivities of a sweep's B designs stacked for the batched
    K6 (``eps_batch``): designs with fewer than N cores are padded with
    r2 = -1, which no squared distance is below."""

    positions: torch.Tensor     # (B, N, 2)
    r2: torch.Tensor            # (B, N) squared core radii, -1 on padding
    eps_core: torch.Tensor      # (B,)
    eps_clad: torch.Tensor      # (B,)


MASS_ROWS = 32        # DOF rows per block of the mass kernel (kRows)
APPLY_ROWS = 256      # DOF rows per block of the A(beta) apply (at most)


class MassPlan(NamedTuple):
    """The mass kernel's per-grid plan (``mass_plan``).

    Block b owns the rows ``order[b*R:(b+1)*R]`` (R = MASS_ROWS, the
    last block padded with empty rows). It stages its halo, the DOF
    rows its entries gather, once per lane chunk, and each owned row
    sums its transpose-table entries in table order from there.
    """

    order: torch.Tensor      # (D,) int32 Morton walk of the DOF rows
    halo: torch.Tensor       # (NB, H) int32 the block's gathered rows, -1 pad
    n_halo: torch.Tensor     # (NB,) int32
    row_ptr: torch.Tensor    # (NB * R + 1,) int32 entry offsets per position
    ent: torch.Tensor        # (n_entries,) int32 flat e * 6 + i, table order
    loc: torch.Tensor        # (n_entries, 6) int16 halo slot of dof(e, j)
    max_entries: int         # the most entries one block holds


class ApplyPlan(NamedTuple):
    """The per-grid plan (``apply_plan``) of the two row-owned applies,
    K1 (the A(beta) apply) and K5 (the stacked-block apply).

    Block b owns the rows ``order[b*R:(b+1)*R]`` and their transpose-
    table entries, numbered per block in row order and, within a row, in
    table order (``row_ptr``). It evaluates every element with an entry
    among them (its element halo, ``elems``) and keeps only the entries
    it owns: node i of element slot s is the block's entry ``dst[b, s,
    i]``, or -1 where dof(e, i) is another block's row, and its DOF is
    ``dofs[b, s, i]`` (the element table read through the slots, so a
    block's lookups depend on no other load). Elements on block borders
    are evaluated by every block they touch: ``recompute`` element
    evaluations per element.
    """

    rows: int                # R, rows per block
    order: torch.Tensor      # (D,) int32 Morton walk of the DOF rows
    row_ptr: torch.Tensor    # (NB * R + 1,) int32 entry offsets per position
    elems: torch.Tensor      # (NB, HE) int32 the block's elements, -1 pad
    n_elems: torch.Tensor    # (NB,) int32
    dst: torch.Tensor        # (NB, HE, 6) int16 block entry of node i, or -1
    dofs: torch.Tensor       # (NB, HE, 6) int32 dof(e, i) of slot s
    max_entries: int         # the most entries one block holds
    recompute: float         # element evaluations per element


_PLANS = WeakTensorKeyDictionary()
_APPLY_PLANS = WeakTensorKeyDictionary()
_PLAN_LOCK = threading.Lock()      # two sweep threads build plans at once


def _spread_bits(v):
    """The low 16 bits of ``v`` (int64) moved to the even bit positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def dof_row_order(dof_coords: torch.Tensor) -> torch.Tensor:
    """The Morton (Z-curve) order of the DOF rows: (D,) int32, a
    permutation of range(D), on the device of ``dof_coords`` (D, 2).

    Coordinates are quantised to 16 bits per axis over their bounding
    box; ties keep storage order (stable sort), so the order is
    deterministic. Consecutive rows of it are neighbours in the mesh.
    """
    xy = dof_coords.to(torch.float32)
    lo = xy.amin(dim=0)
    span = torch.clamp(xy.amax(dim=0) - lo, min=1e-30)
    q = torch.clamp(torch.round((xy - lo) / span * 65535.0), 0, 65535)
    q = q.to(torch.int64)
    code = _spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
    return torch.sort(code, stable=True).indices.to(torch.int32)


def _row_blocks(ga: GridArrays, R: int):
    """The rows of ``dof_row_order`` in blocks of R and their entries.

    Returns (order (D,) int32, ent (NB * R, W) int64, row_ptr
    (NB * R + 1,) int64): ent holds each row position's transpose-table
    entries (flat e * 6 + i), valid ones first in table order and -1
    after, the last block padded with empty rows. Inside a block the
    rows are sorted by entry count, most first (stable): rows summed side
    by side then carry similar work.
    """
    dev = ga.elem_dofs.device
    i64 = torch.int64
    D = ga.dof_coords.shape[0]
    split, Wv = ga.dof_gather_v.shape
    W = max(Wv, 2)
    NB = (D + R - 1) // R
    ent = torch.full((D, W), -1, dtype=i64, device=dev)
    ent[:split, :Wv] = torch.where(ga.dof_gather_valid_v,
                                   ga.dof_gather_v.to(i64), -1)
    ent[split:, :2] = torch.where(ga.dof_gather_valid_e,
                                  ga.dof_gather_e.to(i64), -1)
    key = (ent < 0).to(i64) * W + torch.arange(W, device=dev)
    ent = torch.gather(ent, 1, torch.argsort(key, dim=1))
    order = dof_row_order(ga.dof_coords).to(i64)
    ent = torch.cat([ent[order],
                     torch.full((NB * R - D, W), -1, dtype=i64, device=dev)])
    blk = torch.arange(NB * R, device=dev) // R
    within = torch.argsort(blk * (W + 1) + W - (ent >= 0).sum(dim=1),
                           stable=True)
    ent = ent[within]
    order = order[within[:D]].to(torch.int32)
    row_ptr = torch.zeros(NB * R + 1, dtype=i64, device=dev)
    row_ptr[1:] = torch.cumsum((ent >= 0).sum(dim=1), 0)
    return order, ent, row_ptr


def _dedupe_rows(vals):
    """Per row of ``vals`` (NB, n) int64 with -1 for none: the sorted
    distinct values (NB, M) padded with -1, their counts (NB,), and each
    entry's slot among them (NB, n; arbitrary where the entry is -1)."""
    NB = vals.shape[0]
    srt, perm = torch.sort(vals, dim=1, stable=True)
    new = srt >= 0
    new[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    slot = torch.cumsum(new.to(torch.int64), dim=1) - 1
    count = new.sum(dim=1)
    M = max(int(count.max()), 1)
    uniq = torch.full((NB, M + 1), -1, dtype=torch.int64, device=vals.device)
    uniq.scatter_(1, torch.where(new, slot, M), torch.where(new, srt, -1))
    return uniq[:, :M], count, torch.empty_like(vals).scatter_(1, perm, slot)


def mass_plan(ga: GridArrays) -> MassPlan:
    """The mass kernel's plan for the grid of ``ga``, built once per
    device grid (cached on its ``dof_coords`` tensor).

    Rows go in ``dof_row_order`` blocks of MASS_ROWS, so a block's halo
    is a compact patch of the mesh: about 2.6 rows per owned row on the
    r5 dataset mesh, against the 17.8 row gathers the rows make. Inside
    a block the rows are sorted by entry count.
    """
    with _PLAN_LOCK:
        plan = _PLANS.get(ga.dof_coords)
        if plan is None:
            plan = _PLANS[ga.dof_coords] = _mass_plan(ga)
        return plan


def _mass_plan(ga: GridArrays) -> MassPlan:
    R = MASS_ROWS
    order, ent, row_ptr = _row_blocks(ga, R)
    NB, W = ent.shape[0] // R, ent.shape[1]
    valid = ent >= 0
    # the DOFs every entry gathers, per block: sorted, deduplicated into
    # the halo, and each mapped to its halo slot
    dofs = ga.elem_dofs.to(torch.int64)[torch.clamp(ent, min=0) // 6]
    dofs = torch.where(valid[..., None], dofs, -1).reshape(NB, R * W * 6)
    halo, n_halo, loc = _dedupe_rows(dofs)
    loc = loc.reshape(NB * R, W, 6)[valid]
    per_block = row_ptr[R::R] - row_ptr[:-1:R]
    return MassPlan(order=order, halo=halo.to(torch.int32).contiguous(),
                    n_halo=n_halo.to(torch.int32),
                    row_ptr=row_ptr.to(torch.int32),
                    ent=ent[valid].to(torch.int32),
                    loc=loc.to(torch.int16).contiguous(),
                    max_entries=max(int(per_block.max()), 1))


APPLY_SHARED_LIMIT = 226 * 1024   # of a block's 227 KB, less static use


def apply_shared_bytes(R: int, HE: int, max_entries: int) -> int:
    """Dynamic shared memory of one block of the A(beta) apply kernel
    (the count of ``shared_bytes`` in csrc/apply_vector3.cu): the
    entries' and the owned rows' lanes of a 16-pair chunk, the owned
    rows' masks, entry offsets and ids, and each element's id, DOFs,
    masks and entry slots.

    The stacked apply (csrc/apply_stacked.cu) keeps at most 48 floats
    per entry too (a lane chunk of min(k, 48 / C) columns for C
    components) but no owned-row lanes, so on a plan that fits here it
    has 4 * 48 * R bytes or more left for the element blocks it stages
    (in batches where they do not all fit)."""
    return (4 * 48 * (max_entries + R) + 4 * R + 4 * (2 * R + 1)
            + 4 * 7 * HE + 4 * 6 * HE + 2 * 6 * HE)


def apply_plan(ga: GridArrays) -> ApplyPlan:
    """The row-owned applies' plan (K1 and K5) for the grid of ``ga``,
    built once per device grid (cached on its ``dof_coords`` tensor).

    Rows go in ``dof_row_order`` blocks of APPLY_ROWS, halved until a
    block's shared memory (``apply_shared_bytes``) fits. Larger blocks
    recompute fewer border elements: on the config-1 mesh about 1.35
    evaluations per element at 256 rows, 1.5 at 128.
    """
    with _PLAN_LOCK:
        plan = _APPLY_PLANS.get(ga.dof_coords)
        if plan is None:
            R = APPLY_ROWS
            plan = _apply_plan(ga, R)
            while R > 8 and apply_shared_bytes(
                    R, plan.elems.shape[1],
                    plan.max_entries) > APPLY_SHARED_LIMIT:
                R //= 2
                plan = _apply_plan(ga, R)
            _APPLY_PLANS[ga.dof_coords] = plan
        return plan


def _apply_plan(ga: GridArrays, R: int) -> ApplyPlan:
    order, ent, row_ptr = _row_blocks(ga, R)
    NB, W = ent.shape[0] // R, ent.shape[1]
    valid = ent.reshape(NB, R * W) >= 0
    elems, n_elems, slot = _dedupe_rows(
        torch.where(valid, ent.reshape(NB, R * W) // 6, -1))
    # valid entries are numbered in row-major order of ent, which is the
    # order of row_ptr: rows in block order, table order within a row
    local = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    blk = torch.arange(NB, device=ent.device)[:, None].expand(NB, R * W)
    dst = torch.full((NB, elems.shape[1], 6), -1, dtype=torch.int64,
                     device=ent.device)
    dst[blk[valid], slot[valid], ent.reshape(NB, R * W)[valid] % 6] = \
        local[valid]
    per_block = row_ptr[R::R] - row_ptr[:-1:R]
    n_distinct = torch.unique(ent[ent >= 0] // 6).numel()
    return ApplyPlan(rows=R, order=order, row_ptr=row_ptr.to(torch.int32),
                     elems=elems.to(torch.int32).contiguous(),
                     n_elems=n_elems.to(torch.int32),
                     dst=dst.to(torch.int16).contiguous(),
                     dofs=ga.elem_dofs[elems.clamp(min=0)].to(torch.int32)
                     .contiguous(),
                     max_entries=max(int(per_block.max()), 1),
                     recompute=float(n_elems.sum()) / max(n_distinct, 1))


def gather_scatter(ga: GridArrays):
    """GatherScatter topology bundle for the matrix-free kernels."""
    from .kernels import GatherScatter

    return GatherScatter(elem_dofs=ga.elem_dofs, idx_v=ga.dof_gather_v,
                         valid_v=ga.dof_gather_valid_v,
                         idx_e=ga.dof_gather_e,
                         valid_e=ga.dof_gather_valid_e,
                         plan=mass_plan(ga), apply_plan=apply_plan(ga))


def eps_arrays(p: EpsParams, device, dtype=torch.float32) -> EpsArrays:
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=dtype, device=device)

    return EpsArrays(
        positions=t(p.positions), core_radii=t(p.core_radii),
        eps_core=t(p.eps_core), eps_clad=t(p.eps_clad),
        pml_start=t(p.pml_start), pml_thickness=t(p.pml_thickness),
        pml_strength=t(p.pml_strength), pml_order=t(float(p.pml_order)))


def eps_batch(eas: Sequence[EpsArrays]) -> EpsBatch:
    """Stack the EpsArrays of a sweep's designs (one device) for the
    batched K6; r2 is ``core_radii ** 2`` as the single-design K6 forms
    it, -1 where a design has fewer cores than the most."""
    B = len(eas)
    n = max(ea.positions.shape[0] for ea in eas)
    like = eas[0].positions
    pos = torch.zeros((B, n, 2), dtype=like.dtype, device=like.device)
    r2 = torch.full((B, n), -1.0, dtype=like.dtype, device=like.device)
    for b, ea in enumerate(eas):
        m = ea.positions.shape[0]
        pos[b, :m] = ea.positions
        r2[b, :m] = ea.core_radii ** 2
    return EpsBatch(positions=pos, r2=r2,
                    eps_core=torch.stack([ea.eps_core for ea in eas]),
                    eps_clad=torch.stack([ea.eps_clad for ea in eas]))


def eps_at_quadrature(ga: GridArrays, eps: EpsArrays):
    """Relative permittivity (re, im) at every quadrature point (K6).

    Same piecewise-constant + annular-PML model as the geometry layer
    (models/geometry.py ``epsilon_at``), evaluated on device so one grid
    serves any (eps, k0).
    """
    return triton_kernels.eps_at_quadrature(ga.qp_xy, eps)


def vector3_primitives(ga: GridArrays, eps_re) -> Dict[str, torch.Tensor]:
    """Quadrature primitives for the fixed-beta 3-component H formulation.

    A(beta) = A0 + beta A1 + beta^2 A2 (all real symmetric) for
        a(h, h') = int (1/eps) [ (dy hz~ - b hy)(.) + (b hx - dx hz~)(.)
                                 + (dx hy - dy hx)(.) ]
                 + alpha_p int (dx hx + dy hy - b hz~)(.)
    Returns the twelve weighted primitives {w}{pair} with w in (i=1/eps,
    u=1) and pair in (gxgx, gygy, gxgy, nn, ngx, ngy); pair [i, j] =
    test_i * trial_j.
    """
    return quadrature_primitives(ga.grad_phys, ga.qp_w, ga.shape_vals,
                                 1.0 / eps_re)


def quadrature_primitives(gp, w, N, inv_eps) -> Dict[str, torch.Tensor]:
    """``vector3_primitives`` from the quadrature data: gradients gp
    (E, Q, 6, 2), weights w (E, Q), shape table N (Q, 6) and one
    design's 1/eps (E, Q)."""
    gx = gp[..., 0]
    gy = gp[..., 1]
    Nq = N[None].expand(w.shape + (6,))
    one = torch.ones_like(inv_eps)
    out = {}
    for wname, c in (("i", inv_eps), ("u", one)):
        cw = w * c
        for pair, a, b in (("gxgx", gx, gx), ("gygy", gy, gy),
                           ("gxgy", gx, gy), ("nn", Nq, Nq),
                           ("ngx", Nq, gx), ("ngy", Nq, gy)):
            out[f"{wname}_{pair}"] = torch.einsum("eq,eqi,eqj->eij", cw,
                                                  a, b)
    return out


def combine_vector3(prim: Dict[str, torch.Tensor], beta,
                    alpha_p: float = 1.0) -> Dict:
    """Combine primitives into the 3x3 component blocks of A(beta).

    Components ordered (0=x, 1=y, 2=z~). Only the upper triangle is
    returned; block (j, i) is the element-wise transpose of (i, j).
    """
    ap = alpha_p
    b2 = beta * beta

    def T(M):
        return M.transpose(1, 2)

    return {
        (0, 0): (prim["i_gygy"] + ap * prim["u_gxgx"]) + b2 * prim["i_nn"],
        (1, 1): (prim["i_gxgx"] + ap * prim["u_gygy"]) + b2 * prim["i_nn"],
        (2, 2): (prim["i_gxgx"] + prim["i_gygy"]) + b2 * ap * prim["u_nn"],
        (0, 1): -T(prim["i_gxgy"]) + ap * prim["u_gxgy"],
        (0, 2): beta * (-prim["i_ngx"] - ap * T(prim["u_ngx"])),
        (1, 2): beta * (-prim["i_ngy"] - ap * T(prim["u_ngy"])),
    }


def assemble_vector3_system(ga: GridArrays, ea: EpsArrays):
    """Quadrature primitives + mass diagonal for the fixed-beta operator."""
    eps_re, eps_im = eps_at_quadrature(ga, ea)
    prim = vector3_primitives(ga, eps_re)
    diag_e = torch.diagonal(prim["u_nn"].to(torch.float32), dim1=1, dim2=2)
    diag = torch.zeros(ga.dof_valid.shape[0], dtype=torch.float32,
                       device=diag_e.device)
    diag.index_add_(0, ga.elem_dofs.reshape(-1).long(), diag_e.reshape(-1))
    diag = torch.where(ga.interior_mask > 0, diag, torch.ones_like(diag))
    return prim, diag, eps_im


def mass_diagonal(ga: GridArrays, gs):
    """The assembled consistent-mass diagonal sum_e sum_q w N_i^2 (D,),
    1.0 off the interior: K2 at lane count 1 on the element terms, over
    the grid's GatherScatter ``gs``. It depends on the quadrature weights
    alone, so one serves every design of a sweep."""
    from .kernels import _N_REF, _accumulate_fused

    f32 = torch.float32
    w = ga.qp_w.to(f32)
    n2 = torch.as_tensor(_N_REF, dtype=f32, device=w.device) ** 2
    diag_e = torch.einsum("eq,qi->ei", w, n2)
    diag = _accumulate_fused(diag_e[:, :, None].contiguous(), gs)[:, 0]
    return torch.where(ga.interior_mask > 0, diag, torch.ones_like(diag))


def assemble_vector3_qf(ga: GridArrays, ea: EpsArrays):
    """Quadrature factors + mass diagonal of one design for the
    matrix-free path (the sweep takes ``assemble_vector3_sweep``).

    The diagonal sum_e sum_q w N_i^2 goes through the K2 accumulate
    (lane count 1)."""
    from .kernels import QFactor

    eps_re, _ = eps_at_quadrature(ga, ea)
    f32 = torch.float32
    qf = QFactor(invJT=ga.inv_jt.to(f32), w=ga.qp_w.to(f32),
                 inv_eps=(1.0 / eps_re).to(f32))
    return qf, mass_diagonal(ga, gather_scatter(ga))


def assemble_vector3_sweep(ga: GridArrays, gs, eas: Sequence[EpsArrays]):
    """The sweep's quadrature factors and mass diagonal for the designs
    ``eas`` on one grid: 1/eps of every design from one batched K6
    launch (``triton_kernels.inv_eps_at_quadrature``) and the one mass
    diagonal (``mass_diagonal``). Returns (QFactorSweep, diag)."""
    from .kernels import QFactorSweep

    inv_eps = triton_kernels.inv_eps_at_quadrature(ga.qp_xy, eps_batch(eas))
    qs = QFactorSweep(invJT=ga.inv_jt.to(torch.float32),
                      w=ga.qp_w.to(torch.float32), inv_eps=inv_eps,
                      gp=ga.grad_phys)
    return qs, mass_diagonal(ga, gs)


def assemble_scalar_system(ga: GridArrays, ea: EpsArrays, k0):
    """(A, B, diag_B, bound) of the scalar Helmholtz pencil
    (K - k0^2 M_eps) psi = lambda M psi: the element blocks A and B
    (E, 6, 6) and the spectrum bound of (A, B) (0-d, ``kernels``'s
    ``pencil_bounds_elem`` bound_A) from one K11 launch, which also
    decides the permittivity at the quadrature points; the assembled
    mass diagonal (D,) through the K2 accumulate at lane count 1 on K11's
    diagonal terms, 1.0 on padded DOF rows."""
    from .cuda_kernels import scalar_pencil
    from .kernels import _TRACE_REF, _accumulate_fused, _linv_ref_on

    k0 = np.float32(k0)
    A, B, diag_e, bound = scalar_pencil(
        ga.grad_phys, ga.qp_w, ga.qp_xy, ga.shape_vals, ea, float(k0 * k0),
        ga.elem_valid, _linv_ref_on(str(ga.qp_w.device)), _TRACE_REF)
    diag = _accumulate_fused(diag_e[:, :, None], gather_scatter(ga))[:, 0]
    diag = torch.where(ga.dof_valid > 0, diag, torch.ones_like(diag))
    return A, B, diag, bound


def stack_blocks(blocks: Dict, n_components: int) -> torch.Tensor:
    """Fuse symmetric component blocks into one (E, 6C, 6C) tensor.

    ``blocks`` maps (ci, cj) with ci <= cj to (E, 6, 6); missing (cj, ci)
    is the element-wise transpose."""
    some = next(iter(blocks.values()))
    zero = torch.zeros_like(some)
    rows = []
    for ci in range(n_components):
        cols = []
        for cj in range(n_components):
            if (ci, cj) in blocks:
                b = blocks[(ci, cj)]
            elif (cj, ci) in blocks:
                b = blocks[(cj, ci)].transpose(1, 2)
            else:
                b = zero
            cols.append(b)
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def vector3_stacked_A(prim, beta, alpha_p):
    """Stacked (E, 18, 18) operator A(beta) from primitives."""
    return stack_blocks(combine_vector3(prim, beta, alpha_p), 3)
