"""Host-side meshing frozen into static-shape device arrays.

Pipeline (capability parity with the reference's mesh.py:223-340, redesigned
for XLA): build an adaptive point cloud (cartesian base grid, per-core radial
fans, PML annulus), Delaunay-triangulate on the host (Qhull), refine to the
configured point budget, number P2 degrees of freedom, then export padded,
bucketed element/DOF arrays (`DeviceGrid`) so every downstream computation is
static-shape and jit-cacheable. Meshes with the same bucket reuse one XLA
executable.

The permittivity is *not* baked into the grid: it is evaluated on device at
quadrature points from `EpsParams`, so one grid serves every wavelength of a
multi-band sweep.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import pickle
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay, QhullError

from ..config import MeshConfig, SimulationConfig
from .quadrature import RULES, p2_local_nodes, p2_shape

logger = logging.getLogger("pl_fem_tpu_torch.femgrid")


# ============================================================================
# Triangle mesh with refinement
# ============================================================================

class TriMesh:
    """Minimal host triangle mesh: points (P,2) f64, tris (T,3) i32 (CCW)."""

    def __init__(self, points: np.ndarray, tris: np.ndarray):
        self.points = np.ascontiguousarray(points, dtype=np.float64)
        tris = np.ascontiguousarray(tris, dtype=np.int64)
        # enforce CCW orientation
        p = self.points
        v1 = p[tris[:, 1]] - p[tris[:, 0]]
        v2 = p[tris[:, 2]] - p[tris[:, 0]]
        det = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
        flip = det < 0
        tris[flip, 1], tris[flip, 2] = tris[flip, 2].copy(), tris[flip, 1].copy()
        self.tris = tris

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tris.shape[0]

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Unique edges and per-element edge ids.

        Returns:
            uniq:     (E, 2) sorted vertex pairs
            elem2edge:(T, 3) edge id opposite local vertex k
        """
        t = self.tris
        # edge opposite local vertex k connects vertices (k+1)%3, (k+2)%3
        e = np.stack([t[:, [1, 2]], t[:, [2, 0]], t[:, [0, 1]]], axis=1)  # (T,3,2)
        e = np.sort(e.reshape(-1, 2), axis=1)
        uniq, inv = np.unique(e, axis=0, return_inverse=True)
        return uniq, inv.reshape(-1, 3)

    def refined(self, circles=None) -> "TriMesh":
        """Uniform red refinement: every triangle into four.

        ``circles`` ((C, 3) rows x, y, r): edge-split points whose edge
        lies on a material circle are placed on the ARC, keeping every
        interface vertex exactly on the circle across refinement levels
        (the geometric half of isoparametric interface elements).
        """
        uniq, elem2edge = self.edges()
        mids = 0.5 * (self.points[uniq[:, 0]] + self.points[uniq[:, 1]])
        if circles is not None:
            mids = snap_mids_to_circles(self.points[uniq[:, 0]],
                                        self.points[uniq[:, 1]], mids,
                                        circles)
        m = self.n_points + elem2edge  # (T,3) midpoint ids
        t = self.tris
        children = np.concatenate([
            np.stack([t[:, 0], m[:, 2], m[:, 1]], axis=1),
            np.stack([m[:, 2], t[:, 1], m[:, 0]], axis=1),
            np.stack([m[:, 1], m[:, 0], t[:, 2]], axis=1),
            np.stack([m[:, 0], m[:, 1], m[:, 2]], axis=1),
        ], axis=0)
        return TriMesh(np.vstack([self.points, mids]), children)

    def refined_marked(self, marked: np.ndarray,
                       circles=None) -> "TriMesh":
        """Conforming red-green refinement of the marked elements.

        Marked elements are red-refined (4 children); propagation promotes
        any element with >=2 split edges to red; elements left with exactly
        one split edge are green-bisected. Replaces the reference's partial
        ``mesh.refined(0.5)`` step (mesh.py:330-332) with a well-defined
        conforming algorithm. ``circles`` as in :meth:`refined`.
        """
        uniq, elem2edge = self.edges()
        split = np.zeros(len(uniq), dtype=bool)
        red = np.zeros(self.n_tris, dtype=bool)
        red[np.asarray(marked)] = True
        # fixpoint: red elements split all edges; >=2 split edges -> red
        for _ in range(64):
            split_new = split.copy()
            split_new[elem2edge[red].ravel()] = True
            nsplit = split_new[elem2edge].sum(axis=1)
            red_new = red | (nsplit >= 2)
            if np.array_equal(split_new, split) and np.array_equal(red_new, red):
                break
            split, red = split_new, red_new

        mid_id = np.full(len(uniq), -1, dtype=np.int64)
        mid_id[split] = self.n_points + np.arange(split.sum())
        mids = 0.5 * (self.points[uniq[split, 0]] + self.points[uniq[split, 1]])
        if circles is not None:
            mids = snap_mids_to_circles(self.points[uniq[split, 0]],
                                        self.points[uniq[split, 1]],
                                        mids, circles)
        new_points = np.vstack([self.points, mids])

        t, m = self.tris, mid_id[elem2edge]  # m: (T,3), -1 where unsplit
        out = []
        red_idx = np.where(red)[0]
        if len(red_idx):
            tr, mr = t[red_idx], m[red_idx]
            out += [np.stack([tr[:, 0], mr[:, 2], mr[:, 1]], axis=1),
                    np.stack([mr[:, 2], tr[:, 1], mr[:, 0]], axis=1),
                    np.stack([mr[:, 1], mr[:, 0], tr[:, 2]], axis=1),
                    np.stack([mr[:, 0], mr[:, 1], mr[:, 2]], axis=1)]
        nsplit = split[elem2edge].sum(axis=1)
        green_idx = np.where(~red & (nsplit == 1))[0]
        if len(green_idx):
            tg, mg = t[green_idx], m[green_idx]
            k = np.argmax(mg >= 0, axis=1)  # the single split edge (opp. vertex k)
            rows = np.arange(len(green_idx))
            vk = tg[rows, k]
            va = tg[rows, (k + 1) % 3]
            vb = tg[rows, (k + 2) % 3]
            mk = mg[rows, k]
            out += [np.stack([vk, va, mk], axis=1),
                    np.stack([vk, mk, vb], axis=1)]
        keep_idx = np.where(~red & (nsplit == 0))[0]
        if len(keep_idx):
            out.append(t[keep_idx])
        return TriMesh(new_points, np.concatenate(out, axis=0))

    def areas(self) -> np.ndarray:
        p, t = self.points, self.tris
        v1 = p[t[:, 1]] - p[t[:, 0]]
        v2 = p[t[:, 2]] - p[t[:, 0]]
        return 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])


# ============================================================================
# Point-cloud strategy
# ============================================================================

def _ring_points(cx: float, cy: float, radii: np.ndarray, stagger: bool = True):
    """Isotropic concentric rings: azimuthal spacing tracks radial spacing.

    Returns (points, h) where h is the local target spacing per point.
    """
    out, hs = [], []
    dr = np.diff(radii, prepend=max(radii[0], 1e-9))
    dr = np.maximum(dr, 1e-9)
    for i, r in enumerate(radii):
        if r <= 0:
            out.append(np.array([[cx, cy]]))
            hs.append(np.array([dr[min(i + 1, len(radii) - 1)]]))
            continue
        h = dr[i] if dr[i] > 1e-9 else r
        n_az = max(6, int(np.ceil(2 * np.pi * r / h)))
        phase = (np.pi / n_az) * (i % 2) if stagger else 0.0
        th = phase + 2 * np.pi * np.arange(n_az) / n_az
        out.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1))
        hs.append(np.full(n_az, h))
    return np.vstack(out), np.concatenate(hs)


def adaptive_point_cloud(geometry, refinement: float = 1.0) -> np.ndarray:
    """Adaptive point cloud for a lantern cross-section.

    Covers the same three density zones as the reference mesher
    (mesh.py:233-297: core interiors, core/cladding interfaces, PML
    annulus over a cartesian background) but uses *isotropic graded
    rings* instead of fixed-count radial fans: azimuthal spacing follows
    the local radial spacing, so element aspect ratios stay O(1). This is
    a deliberate accelerator-first change — the spectral radius of the assembled
    operator scales like 1/h_min^2 and directly sets the Chebyshev filter
    degree of the eigensolver, so sliver-free grading buys solver speed
    at equal accuracy.
    """
    R = float(geometry.domain_radius)
    n_base = max(int(25 + 20 * refinement), 16)
    h_far = 2 * R / n_base

    positions = np.atleast_2d(np.asarray(geometry.positions))
    core_radii = np.asarray(geometry.core_radii)
    pml_thick = float(getattr(geometry, "pml_thickness", 0.0))
    pml_start = R - pml_thick * 1.1 if pml_thick > 0 else R

    pts = []
    fan_extents = []
    for (cx, cy), r in zip(positions, core_radii):
        # core interior: uniform spacing ~ r / (5.5 * refinement)
        h_core = r / max(5.5 * refinement, 3.0)
        radii_in = np.arange(0.0, 0.90 * r - 0.25 * h_core, h_core)
        # interface band [0.90r, 1.30r]: finest spacing ~ r / (9 * refinement),
        # ANCHORED on the interface — one ring sits at exactly r, so the
        # eps jump runs along element edges (conforming; curvable onto
        # the arc by snap_mids_to_circles) instead of cutting through
        # element interiors, which costs an O(h) consistency error
        h_int = r / max(9.0 * refinement, 5.0)
        k = np.arange(-int(np.floor(0.10 * r / h_int)),
                      int(np.floor(0.30 * r / h_int)) + 1)
        radii_ifc = r + h_int * k
        # graded escape: geometric growth from h_int to h_far
        radii_out = []
        rr, h = radii_ifc[-1] if len(radii_ifc) else 1.3 * r, h_int
        extent = min(max(3.0 * r, 1.3 * r + 3 * h_far),
                     0.5 * getattr(geometry, "pitch", 1e9) + 1.3 * r
                     if geometry.n_cores > 1 else 1e9)
        while rr < extent and h < h_far:
            h = min(h * 1.45, h_far)
            rr = rr + h
            radii_out.append(rr)
        radii = np.concatenate([radii_in, radii_ifc, np.array(radii_out)])
        ring_p, ring_h = _ring_points(cx, cy, radii)
        if geometry.n_cores > 1:
            # Voronoi clip: drop points closer to another core's territory
            # (with a local-spacing margin) so overlapping ring systems
            # cannot create near-coincident points / sliver triangles.
            d_all = np.linalg.norm(ring_p[:, None, :] - positions[None], axis=-1)
            own = np.linalg.norm(ring_p - np.array([cx, cy]), axis=1)
            d_all[:, np.argmin(np.linalg.norm(positions - np.array([cx, cy]),
                                              axis=1))] = np.inf
            keep_ring = own <= d_all.min(axis=1) - 0.35 * ring_h
            ring_p = ring_p[keep_ring]
        pts.append(ring_p)
        fan_extents.append(rr + 0.55 * h_far)

    # cartesian background, excluding core fans, PML and boundary zones
    ax = np.linspace(-R, R, n_base)
    X, Y = np.meshgrid(ax, ax)
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)
    keep = np.linalg.norm(grid, axis=1) <= pml_start - 0.55 * h_far
    for (c, ext) in zip(positions, fan_extents):
        keep &= np.linalg.norm(grid - c[None, :], axis=1) > ext
    pts.append(grid[keep])

    # PML annulus: isotropic rings from pml_start to R
    if pml_thick > 0 and pml_start > 0:
        n_r = max(int(6 * refinement), 4)
        h_pml = (R - pml_start) / n_r
        radii = np.arange(pml_start, R - 0.25 * h_pml, h_pml)
        pts.append(_ring_points(0.0, 0.0, radii)[0])

    # exact outer boundary circle
    h_bd = min(h_far, (R - pml_start) / max(int(6 * refinement), 4)) \
        if pml_thick > 0 else h_far
    n_bd = max(24, int(np.ceil(2 * np.pi * R / h_bd)))
    th = 2 * np.pi * np.arange(n_bd) / n_bd
    pts.append(R * np.stack([np.cos(th), np.sin(th)], axis=1))

    p = np.vstack(pts)
    p = p[np.linalg.norm(p, axis=1) <= R * (1 + 1e-12)]
    p = np.unique(np.round(p, 8), axis=0)
    return p


def delaunay_mesh(points: np.ndarray) -> TriMesh:
    # Default Qhull options merge co-circular facets and retriangulate,
    # avoiding the zero-area slivers a QJ joggle can leave behind.
    try:
        tri = Delaunay(points)
    except QhullError:
        try:
            tri = Delaunay(points, qhull_options="QJ Pp")
        except QhullError as e:  # pragma: no cover
            raise RuntimeError(f"Delaunay triangulation failed: {e}") from e
    return TriMesh(tri.points, tri.simplices)


# ============================================================================
# P2 grid
# ============================================================================

@dataclasses.dataclass
class FEMGrid:
    """P2 discretization of a TriMesh (host arrays, exact sizes)."""

    mesh: TriMesh
    elem_dofs: np.ndarray        # (T, 6) int64: v0 v1 v2 m0 m1 m2
    dof_coords: np.ndarray       # (D, 2)
    boundary_dofs: np.ndarray    # (Bd,) int64
    interior_mask: np.ndarray    # (D,) bool
    # material-interface circles ((C, 3) x, y, r) the mesh CONFORMS to
    # (vertices + curved P2 midpoints sit on them) — the anchor for the
    # bucket engine's member-conforming deformation (host_assembly
    # member_deformed_coords). None for meshes built without circles.
    circles: Optional[np.ndarray] = None
    # quality provenance, populated by MeshGenerator._generate (gate
    # per MeshConfig.quality_gate; reference seam mesh.py:527-569)
    quality: Optional[Dict] = None
    quality_ok: bool = True
    quality_msg: str = ""

    @property
    def n_dofs(self) -> int:
        return self.dof_coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elem_dofs.shape[0]

    @property
    def n_points(self) -> int:
        return self.mesh.n_points


def snap_mids_to_circles(a: np.ndarray, b: np.ndarray, mids: np.ndarray,
                         circles, max_chord_frac: float = 0.8,
                         tol_rel: float = 1e-6) -> np.ndarray:
    """Place midpoints of on-circle edges onto the circular ARC.

    ``a``/``b``: edge endpoints, ``mids``: straight midpoints (all
    (E, 2)); ``circles``: (C, 3) rows (x, y, r) of material interfaces.
    An edge is on a circle when both endpoints are within ``tol_rel*r``
    of it (the point cloud and circle-aware refinement place interface
    vertices exactly on circles) and its chord is shorter than
    ``max_chord_frac*r`` (rejects far-apart chord pairs). The snapped
    midpoint is the arc point — the geometric half of isoparametric
    P2 interface elements; the P2 element map then resolves the curved
    interface to O(h^3) instead of the straight chord's O(h^2) (the
    dominant n_eff discretization-error term at high index contrast).
    No reference analog: the reference meshes straight elements only
    (the reference's mesh.py:246-332).
    """
    mids = np.array(mids, copy=True)
    for cx, cy, r in np.asarray(circles, dtype=np.float64):
        c = np.array([cx, cy])
        tol = tol_rel * max(r, 1e-12)
        on = ((np.abs(np.linalg.norm(a - c, axis=1) - r) < tol)
              & (np.abs(np.linalg.norm(b - c, axis=1) - r) < tol)
              & (np.linalg.norm(a - b, axis=1) < max_chord_frac * r))
        if not on.any():
            continue
        idx = np.nonzero(on)[0]
        v = mids[idx] - c
        n = np.linalg.norm(v, axis=1, keepdims=True)
        good = n[:, 0] > 1e-12 * r
        mids[idx[good]] = c + r * (v[good] / n[good])
    return mids


def geometry_circles(geometry) -> Optional[np.ndarray]:
    """Material-interface circles of a geometry ((C, 3) x, y, r)."""
    pos = np.asarray(getattr(geometry, "positions", None))
    rad = np.asarray(getattr(geometry, "core_radii", None))
    if pos is None or rad is None or pos.size == 0:
        return None
    return np.column_stack([pos[:, 0], pos[:, 1], rad])


def build_p2_grid(mesh: TriMesh, circles=None) -> FEMGrid:
    uniq, elem2edge = mesh.edges()
    nv = mesh.n_points
    elem_dofs = np.concatenate([mesh.tris, nv + elem2edge], axis=1)
    mid_coords = 0.5 * (mesh.points[uniq[:, 0]] + mesh.points[uniq[:, 1]])
    if circles is not None:
        mid_coords = snap_mids_to_circles(
            mesh.points[uniq[:, 0]], mesh.points[uniq[:, 1]], mid_coords,
            circles)
    dof_coords = np.vstack([mesh.points, mid_coords])

    counts = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(counts, elem2edge.ravel(), 1)
    bd_edges = np.where(counts == 1)[0]
    bd_vertices = np.unique(uniq[bd_edges].ravel())
    boundary_dofs = np.concatenate([bd_vertices, nv + bd_edges])
    interior = np.ones(dof_coords.shape[0], dtype=bool)
    interior[boundary_dofs] = False
    return FEMGrid(mesh, elem_dofs.astype(np.int64), dof_coords,
                   boundary_dofs.astype(np.int64), interior,
                   circles=(None if circles is None
                            else np.asarray(circles, dtype=np.float64)))


# ============================================================================
# Device export (padded static shapes)
# ============================================================================

@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Padded, bucket-shaped arrays ready to ship to a device.

    Shapes are a function of (elem_bucket, dof_bucket) only, so designs in
    the same bucket share a compiled executable. Pad elements reference
    DOF 0 with zero quadrature weight; pad DOFs are flagged invalid and
    masked out of every inner product.
    """

    elem_dofs: np.ndarray      # (E, 6) int32
    elem_vertices: np.ndarray  # (E, 3, 2) f32/f64 vertex coords
    elem_valid: np.ndarray     # (E,) bool
    qp_xy: np.ndarray          # (E, Q, 2) physical quadrature points
    qp_w: np.ndarray           # (E, Q) |detJ|-scaled weights (0 on pads)
    grad_phys: np.ndarray      # (E, Q, 6, 2) physical shape gradients
    shape_vals: np.ndarray     # (Q, 6) reference shape values
    dof_coords: np.ndarray     # (D, 2)
    dof_valid: np.ndarray      # (D,) bool
    interior_mask: np.ndarray  # (D,) bool (False on boundary + pads)
    dof_gather_v: np.ndarray   # (split, Wv) int32 into flat (E*6) entries
    dof_gather_valid_v: np.ndarray  # (split, Wv) bool
    dof_gather_e: np.ndarray   # (D - split, 2) int32 (edge-midpoint DOFs)
    dof_gather_valid_e: np.ndarray  # (D - split, 2) bool
    inv_jt: np.ndarray         # (E, 2, 2) J^{-T} per element
    n_elems: int               # actual element count
    n_dofs: int                # actual DOF count
    bucket: Tuple[int, ...]
    # conforming material-interface circles (see FEMGrid.circles)
    circles: Optional[np.ndarray] = None

    @property
    def n_dofs_padded(self) -> int:
        return self.dof_coords.shape[0]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _dof_gather_table(elem_dofs: np.ndarray, n_elems: int, D: int,
                      n_vertices: int, split_round: int = 1024):
    """Transpose of the element->DOF scatter as bounded gather tables.

    For each DOF d, the (element, local) entries that accumulate into it
    as flat indices e*6+l into the per-element result array. A scatter
    (segment_sum) serializes; fixed-width gathers + sums vectorize, so
    the operator apply becomes gather -> batched GEMM -> gather-sum with
    no scatter anywhere.

    The table is SPLIT by DOF class: P2 edge midpoints (75% of DOFs)
    have valence exactly <= 2 while vertices go up to mesh valence, so
    one wide table would waste ~4x the gathered rows. Rows [0, split)
    use the wide table, rows [split, D) the width-2 table, with the
    split at the (rounded-up) vertex count — DOF numbering already puts
    vertices first (build_p2_grid).

    Returns (idx_v (split, Wv), valid_v, idx_e (D - split, 2), valid_e,
    split).
    """
    flat = elem_dofs[:n_elems].astype(np.int64).ravel()     # entry i -> dof
    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    counts = np.bincount(sorted_dofs, minlength=D)
    split = min(_round_up(max(n_vertices, 1), split_round), D)

    vmax_v = int(counts[:split].max()) if split else 0
    width_v = max(int(_round_up(max(vmax_v, 1), 4)), 4)
    vmax_e = int(counts[split:].max()) if split < D else 0
    if vmax_e > 2:
        raise ValueError(f"edge-DOF valence {vmax_e} > 2; DOF numbering "
                         "does not put vertices first")

    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(flat)) - np.repeat(starts, counts)

    idx_v = np.zeros((split, width_v), dtype=np.int32)
    valid_v = np.zeros((split, width_v), dtype=bool)
    idx_e = np.zeros((D - split, 2), dtype=np.int32)
    valid_e = np.zeros((D - split, 2), dtype=bool)
    is_v = sorted_dofs < split
    idx_v[sorted_dofs[is_v], pos[is_v]] = order[is_v].astype(np.int32)
    valid_v[sorted_dofs[is_v], pos[is_v]] = True
    idx_e[sorted_dofs[~is_v] - split, pos[~is_v]] = \
        order[~is_v].astype(np.int32)
    valid_e[sorted_dofs[~is_v] - split, pos[~is_v]] = True
    return idx_v, valid_v, idx_e, valid_e, split


def export_device_grid(grid: FEMGrid, bucket_rounding: int = 4096,
                       quad_degree: int = 4) -> DeviceGrid:
    qp, qw = RULES[quad_degree]
    _, dN = p2_shape(qp)                      # (Q,6,2) reference gradients
    Nv, _ = p2_shape(qp)

    p = grid.mesh.points
    t = grid.mesh.tris
    v0, v1, v2 = p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]
    J = np.stack([v1 - v0, v2 - v0], axis=2)  # (T,2,2) columns = edge vectors
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    invJT = (np.stack([
        np.stack([J[:, 1, 1], -J[:, 1, 0]], axis=1),
        np.stack([-J[:, 0, 1], J[:, 0, 0]], axis=1)], axis=1)
        / detJ[:, None, None])                 # (T,2,2) = J^{-T}

    # Isoparametric P2 quadrature geometry: the element map uses all 6
    # nodes, x(xi) = sum_i N_i(xi) x_i, with a per-quadrature-point
    # Jacobian. For straight elements (midpoints at chord centers) this
    # reduces EXACTLY to the affine map; elements whose interface
    # midpoints were snapped onto material circles (snap_mids_to_
    # circles) get a curved boundary resolved to O(h^3). Every solver
    # path consumes these per-(e, q) tables, so curvature support is
    # confined to this export.
    def _iso_tables(nodes):
        Jq = np.einsum("tia,qib->tqab", nodes, dN)     # (T, Q, 2, 2)
        detJq = (Jq[..., 0, 0] * Jq[..., 1, 1]
                 - Jq[..., 0, 1] * Jq[..., 1, 0])
        invJTq = np.empty_like(Jq)
        invJTq[..., 0, 0] = Jq[..., 1, 1]
        invJTq[..., 0, 1] = -Jq[..., 1, 0]
        invJTq[..., 1, 0] = -Jq[..., 0, 1]
        invJTq[..., 1, 1] = Jq[..., 0, 0]
        invJTq = invJTq / detJq[..., None, None]
        return Jq, detJq, invJTq

    nodes = grid.dof_coords[grid.elem_dofs]            # (T, 6, 2)
    _, detJq, invJTq = _iso_tables(nodes)
    for _ in range(3):
        bad = np.nonzero(detJq.min(axis=1) <= 0)[0]
        if len(bad) == 0:
            break
        # a snapped arc bulged a sliver element inside-out: revert its
        # midpoints to the straight chord centers (shared edges revert
        # consistently for both neighbours) and recompute
        logger.warning("straightening %d tangled curved elements",
                       len(bad))
        for e in bad:
            for loc in range(3):
                d = grid.elem_dofs[e, 3 + loc]
                a_, b_ = grid.mesh.points[
                    grid.mesh.tris[e, [(loc + 1) % 3, (loc + 2) % 3]]]
                grid.dof_coords[d] = 0.5 * (a_ + b_)
        nodes = grid.dof_coords[grid.elem_dofs]
        _, detJq, invJTq = _iso_tables(nodes)

    grad_phys = np.einsum("tqab,qib->tqia", invJTq, dN)
    qp_xy = np.einsum("qi,tia->tqa", Nv, nodes)
    qp_w = np.abs(detJq) * qw[None, :]

    E = _round_up(grid.n_elems, bucket_rounding)
    D = _round_up(grid.n_dofs, bucket_rounding)

    def pad_e(a, fill=0.0):
        out = np.full((E,) + a.shape[1:], fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    elem_dofs = np.zeros((E, 6), dtype=np.int32)
    elem_dofs[: grid.n_elems] = grid.elem_dofs
    elem_valid = np.zeros(E, dtype=bool)
    elem_valid[: grid.n_elems] = True

    dof_coords = np.zeros((D, 2))
    dof_coords[: grid.n_dofs] = grid.dof_coords
    dof_valid = np.zeros(D, dtype=bool)
    dof_valid[: grid.n_dofs] = True
    interior = np.zeros(D, dtype=bool)
    interior[: grid.n_dofs] = grid.interior_mask

    gv_idx, gv_valid, ge_idx, ge_valid, split = _dof_gather_table(
        grid.elem_dofs, grid.n_elems, D, grid.n_points)

    return DeviceGrid(
        elem_dofs=elem_dofs,
        elem_vertices=pad_e(np.stack([v0, v1, v2], axis=1)),
        elem_valid=elem_valid,
        qp_xy=pad_e(qp_xy),
        qp_w=pad_e(qp_w),
        grad_phys=pad_e(grad_phys),
        shape_vals=Nv,
        dof_coords=dof_coords,
        dof_valid=dof_valid,
        interior_mask=interior,
        dof_gather_v=gv_idx,
        dof_gather_valid_v=gv_valid,
        dof_gather_e=ge_idx,
        dof_gather_valid_e=ge_valid,
        inv_jt=pad_e(invJT),
        n_elems=grid.n_elems,
        n_dofs=grid.n_dofs,
        bucket=(E, D, split, gv_idx.shape[1]),
        circles=grid.circles,
    )


# ============================================================================
# P2 prolongation (two-grid bootstrap)
# ============================================================================

def p2_prolongation(coarse: FEMGrid, fine_coords: np.ndarray):
    """Sparse interpolation matrix from a coarse P2 grid to points.

    For each query point, locates a containing coarse element (k-NN over
    element centroids + best-barycentric fallback for hull-roundoff
    points) and records the 6 P2 shape values there. The result P
    (n_points x n_coarse_dofs) prolongs coarse fields to the fine grid —
    the transfer operator of the two-grid spectral bootstrap (coarse
    Ritz vectors seed the fine Chebyshev filter, cutting filter passes).
    No reference analog: the reference re-solves every problem from
    scratch with ARPACK.
    """
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    pts = np.asarray(fine_coords, dtype=np.float64)
    n_q = pts.shape[0]
    p, t = coarse.mesh.points, coarse.mesh.tris
    v0 = p[t[:, 0]]
    J = np.stack([p[t[:, 1]] - v0, p[t[:, 2]] - v0], axis=2)  # (T,2,2)
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    invJ = (np.stack([
        np.stack([J[:, 1, 1], -J[:, 0, 1]], axis=1),
        np.stack([-J[:, 1, 0], J[:, 0, 0]], axis=1)], axis=1)
        / detJ[:, None, None])                                 # (T,2,2)

    centroids = (p[t[:, 0]] + p[t[:, 1]] + p[t[:, 2]]) / 3.0
    kq = min(12, len(t))
    _, cand = cKDTree(centroids).query(pts, k=kq)
    cand = np.atleast_2d(cand.reshape(n_q, -1))                # (n_q, kq)

    d = pts[:, None, :] - v0[cand]                             # (n_q, kq, 2)
    ref = np.einsum("qkab,qkb->qka", invJ[cand], d)            # (n_q, kq, 2)
    bary_min = np.minimum(np.minimum(ref[..., 0], ref[..., 1]),
                          1.0 - ref[..., 0] - ref[..., 1])
    best = np.argmax(bary_min, axis=1)
    rows_q = np.arange(n_q)
    elem = cand[rows_q, best]
    rs = np.clip(ref[rows_q, best], 0.0, 1.0)
    s = rs.sum(axis=1)
    over = s > 1.0
    rs[over] /= s[over, None]

    N, _ = p2_shape(rs)                                        # (n_q, 6)
    cols = coarse.elem_dofs[elem]                              # (n_q, 6)
    rows = np.repeat(rows_q, 6)
    P = sp.coo_matrix((N.ravel(), (rows, cols.ravel())),
                      shape=(n_q, coarse.n_dofs))
    return P.tocsr()


# ============================================================================
# MeshGenerator with cache (reference seam: mesh.py:50-416)
# ============================================================================

class MeshGenerator:
    """Adaptive mesh generation with an LRU cache keyed by the cross-
    section's shape."""

    _cache: "OrderedDict[str, FEMGrid]" = OrderedDict()
    _cache_hits = 0
    _cache_misses = 0
    _cache_max_memory_mb = 500.0
    MAX_REFINEMENT_ITERATIONS = 5
    # the class-level LRU is shared across the dataset engine's bucket-
    # pipeline threads (the reference's unsynchronized class cache is a
    # known hazard, SURVEY.md §5); generation itself serializes too —
    # meshing is host-bound and this VM has one core anyway
    _lock = threading.RLock()

    @classmethod
    def generate(cls, geometry, refinement: float = 1.0,
                 config: Optional[SimulationConfig] = None) -> FEMGrid:
        config = config or SimulationConfig()
        mc = config.derived_mesh()
        key = cls._cache_key(geometry, refinement, mc)
        with cls._lock:
            if config.enable_mesh_cache and key in cls._cache:
                cls._cache_hits += 1
                cls._cache.move_to_end(key)
                return cls._cache[key]
            cls._cache_misses += 1
            grid = cls._generate(geometry, refinement,
                                 config.derived_mesh())
            if config.enable_mesh_cache:
                cls._add(key, grid, config.cache_max_size)
            return grid

    @classmethod
    def _generate(cls, geometry, refinement: float, mc: MeshConfig) -> FEMGrid:
        circles = geometry_circles(geometry) if mc.curved_interfaces \
            else None
        pts = adaptive_point_cloud(geometry, refinement)
        mesh = delaunay_mesh(pts)
        it = 0
        while (mesh.n_points < mc.mesh_min_points
               and it < cls.MAX_REFINEMENT_ITERATIONS):
            mesh = mesh.refined(circles=circles)
            it += 1
            if mesh.n_points > mc.mesh_target_points * 2.5:
                logger.warning("mesh too dense (%d pts), stopping refinement",
                               mesh.n_points)
                break
        if (mc.semi_refine and mesh.n_points < mc.mesh_target_points
                and refinement > 0.8 and it < cls.MAX_REFINEMENT_ITERATIONS):
            areas = mesh.areas()
            marked = np.argsort(areas)[len(areas) // 2:]  # largest 50%
            mesh = mesh.refined_marked(marked, circles=circles)
        grid = build_p2_grid(mesh, circles=circles)
        logger.info("mesh: %d pts, %d tris, %d P2 DOFs",
                    mesh.n_points, mesh.n_tris, grid.n_dofs)
        if mc.quality_gate != "off":
            # reference seam: mesh.py:527-569 validates every generated
            # mesh; 'warn' records the verdict on the grid (the dataset
            # engine copies it into the record), 'strict' refuses the
            # mesh so the caller skip-and-records the design
            from .mesh_quality import MeshQualityAnalyzer
            grid.quality = MeshQualityAnalyzer.analyze(mesh)
            ok, msg = MeshQualityAnalyzer.validate_mesh_quality(mesh)
            grid.quality_ok, grid.quality_msg = ok, msg
            if not ok:
                logger.warning("mesh quality gate: %s", msg)
                if mc.quality_gate == "strict":
                    raise RuntimeError(f"mesh quality gate failed: {msg}")
        return grid

    # -- cache management ----------------------------------------------------
    @classmethod
    def _cache_key(cls, geometry, refinement: float,
                   mc: Optional[MeshConfig] = None) -> str:
        # the cross-section's shape alone: the mesh does not depend on
        # the wavelength or the indices, so one entry serves a band sweep
        # and each of its bootstrap's coarse grids
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(geometry.positions,
                                      dtype=np.float64).tobytes())
        h.update(np.ascontiguousarray(geometry.core_radii,
                                      dtype=np.float64).tobytes())
        h.update(f"{geometry.domain_radius:.6f}".encode())
        h.update(f"{refinement:.4f}".encode())
        h.update(str(geometry.n_cores).encode())
        h.update(f"{geometry.pml_thickness:.2f}".encode())
        h.update(str(geometry.use_complex_pml).encode())
        if mc is not None:
            # size/refinement targets change the produced grid — two
            # configs must not alias one cache entry (this silently
            # returned a coarse mesh for a finer request)
            h.update(f"{mc.mesh_min_points}:{mc.mesh_target_points}:"
                     f"{mc.semi_refine}:{mc.min_edge_factor:.4f}:"
                     f"{mc.curved_interfaces}:{mc.quality_gate}".encode())
        return h.hexdigest()[:24]

    @classmethod
    def _grid_mb(cls, g: FEMGrid) -> float:
        b = (g.mesh.points.nbytes + g.mesh.tris.nbytes + g.elem_dofs.nbytes
             + g.dof_coords.nbytes)
        return b / (1024 ** 2)

    @classmethod
    def _add(cls, key: str, grid: FEMGrid, max_size: int):
        total = sum(cls._grid_mb(g) for g in cls._cache.values())
        size = cls._grid_mb(grid)
        while cls._cache and (len(cls._cache) >= max_size
                              or total + size > cls._cache_max_memory_mb):
            _, old = cls._cache.popitem(last=False)
            total -= cls._grid_mb(old)
        cls._cache[key] = grid

    @classmethod
    def clear_cache(cls):
        cls._cache.clear()
        cls._cache_hits = 0
        cls._cache_misses = 0

    @classmethod
    def get_cache_stats(cls) -> Dict:
        total = cls._cache_hits + cls._cache_misses
        return {
            "size": len(cls._cache),
            "hits": cls._cache_hits,
            "misses": cls._cache_misses,
            "hit_rate": cls._cache_hits / total if total else 0.0,
            "memory_mb": sum(cls._grid_mb(g) for g in cls._cache.values()),
            "max_memory_mb": cls._cache_max_memory_mb,
        }

    @classmethod
    def save_cache(cls, filepath):
        with open(Path(filepath), "wb") as f:
            pickle.dump({"cache": cls._cache, "hits": cls._cache_hits,
                         "misses": cls._cache_misses}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load_cache(cls, filepath):
        fp = Path(filepath)
        if not fp.exists():
            logger.warning("cache file missing: %s", fp)
            return
        with open(fp, "rb") as f:
            data = pickle.load(f)
        cls._cache = data["cache"]
        cls._cache_hits = data["hits"]
        cls._cache_misses = data["misses"]
