"""The P2 mesh and its quadrature tables, worked out from the
configuration.

Frozen copy of the program's host mesher (``ops/femgrid.py``: the graded
point cloud, Qhull's Delaunay triangulation, red and red-green
refinement with interface midpoints on the core circles, P2 numbering
with vertices first, the isoparametric quadrature tables) and of its
quadrature rule (``ops/quadrature.py``). Same inputs, same mesh, DOF for
DOF: the reference reads the program's fields on it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import Delaunay, QhullError

# Dunavant degree-4, 6-point rule (weights sum to 1/2).
_A1, _B1 = 0.445948490915965, 0.108103018168070
_A2, _B2 = 0.091576213509771, 0.816847572980459
QP = np.array([[_A1, _A1], [_B1, _A1], [_A1, _B1],
               [_A2, _A2], [_B2, _A2], [_A2, _B2]])
QW = 0.5 * np.array([0.223381589678011] * 3 + [0.109951743655322] * 3)
MAX_REFINEMENTS = 5


def p2_shape(points):
    """P2 shape values (Q, 6) and reference gradients (Q, 6, 2); vertices
    L_i (2 L_i - 1), edge 3 + k: 4 L_{k+1} L_{k+2}."""
    pts = np.asarray(points, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    L = np.stack([1.0 - x - y, x, y], axis=1)
    dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    N = np.zeros((len(pts), 6))
    dN = np.zeros((len(pts), 6, 2))
    for i in range(3):
        N[:, i] = L[:, i] * (2.0 * L[:, i] - 1.0)
        dN[:, i, :] = (4.0 * L[:, i] - 1.0)[:, None] * dL[i][None, :]
    for k in range(3):
        a, b = (k + 1) % 3, (k + 2) % 3
        N[:, 3 + k] = 4.0 * L[:, a] * L[:, b]
        dN[:, 3 + k, :] = 4.0 * (L[:, a][:, None] * dL[b][None, :]
                                 + L[:, b][:, None] * dL[a][None, :])
    return N, dN


def _ccw(points, tris):
    tris = np.ascontiguousarray(tris, dtype=np.int64)
    v1 = points[tris[:, 1]] - points[tris[:, 0]]
    v2 = points[tris[:, 2]] - points[tris[:, 0]]
    flip = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0] < 0
    tris[flip, 1], tris[flip, 2] = tris[flip, 2].copy(), tris[flip, 1].copy()
    return tris


def _edges(tris):
    e = np.stack([tris[:, [1, 2]], tris[:, [2, 0]], tris[:, [0, 1]]], axis=1)
    uniq, inv = np.unique(np.sort(e.reshape(-1, 2), axis=1), axis=0,
                          return_inverse=True)
    return uniq, inv.reshape(-1, 3)


def _snap(a, b, mids, circles, max_chord_frac=0.8, tol_rel=1e-6):
    """Midpoints of edges lying on a core circle moved onto the arc."""
    mids = np.array(mids, copy=True)
    for cx, cy, r in circles:
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


def _refine(points, tris, circles):
    uniq, e2e = _edges(tris)
    mids = _snap(points[uniq[:, 0]], points[uniq[:, 1]],
                 0.5 * (points[uniq[:, 0]] + points[uniq[:, 1]]), circles)
    m = len(points) + e2e
    t = tris
    children = np.concatenate([
        np.stack([t[:, 0], m[:, 2], m[:, 1]], axis=1),
        np.stack([m[:, 2], t[:, 1], m[:, 0]], axis=1),
        np.stack([m[:, 1], m[:, 0], t[:, 2]], axis=1),
        np.stack([m[:, 0], m[:, 1], m[:, 2]], axis=1)], axis=0)
    pts = np.vstack([points, mids])
    return pts, _ccw(pts, children)


def _refine_marked(points, tris, marked, circles):
    uniq, e2e = _edges(tris)
    split = np.zeros(len(uniq), dtype=bool)
    red = np.zeros(len(tris), dtype=bool)
    red[np.asarray(marked)] = True
    for _ in range(64):
        split_new = split.copy()
        split_new[e2e[red].ravel()] = True
        red_new = red | (split_new[e2e].sum(axis=1) >= 2)
        if np.array_equal(split_new, split) and np.array_equal(red_new, red):
            break
        split, red = split_new, red_new
    mid_id = np.full(len(uniq), -1, dtype=np.int64)
    mid_id[split] = len(points) + np.arange(split.sum())
    mids = _snap(points[uniq[split, 0]], points[uniq[split, 1]],
                 0.5 * (points[uniq[split, 0]] + points[uniq[split, 1]]),
                 circles)
    new_points = np.vstack([points, mids])
    t, m = tris, mid_id[e2e]
    out = []
    ri = np.where(red)[0]
    if len(ri):
        tr, mr = t[ri], m[ri]
        out += [np.stack([tr[:, 0], mr[:, 2], mr[:, 1]], axis=1),
                np.stack([mr[:, 2], tr[:, 1], mr[:, 0]], axis=1),
                np.stack([mr[:, 1], mr[:, 0], tr[:, 2]], axis=1),
                np.stack([mr[:, 0], mr[:, 1], mr[:, 2]], axis=1)]
    nsplit = split[e2e].sum(axis=1)
    gi = np.where(~red & (nsplit == 1))[0]
    if len(gi):
        tg, mg = t[gi], m[gi]
        k = np.argmax(mg >= 0, axis=1)
        rows = np.arange(len(gi))
        vk, va, vb = tg[rows, k], tg[rows, (k + 1) % 3], tg[rows, (k + 2) % 3]
        mk = mg[rows, k]
        out += [np.stack([vk, va, mk], axis=1), np.stack([vk, mk, vb], axis=1)]
    keep = np.where(~red & (nsplit == 0))[0]
    if len(keep):
        out.append(t[keep])
    return new_points, _ccw(new_points, np.concatenate(out, axis=0))


def _rings(cx, cy, radii):
    out, hs = [], []
    dr = np.maximum(np.diff(radii, prepend=max(radii[0], 1e-9)), 1e-9)
    for i, r in enumerate(radii):
        if r <= 0:
            out.append(np.array([[cx, cy]]))
            hs.append(np.array([dr[min(i + 1, len(radii) - 1)]]))
            continue
        h = dr[i] if dr[i] > 1e-9 else r
        n_az = max(6, int(np.ceil(2 * np.pi * r / h)))
        th = (np.pi / n_az) * (i % 2) + 2 * np.pi * np.arange(n_az) / n_az
        out.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1))
        hs.append(np.full(n_az, h))
    return np.vstack(out), np.concatenate(hs)


def point_cloud(lan, refinement: float) -> np.ndarray:
    """Graded rings around each core over a cartesian background, PML
    rings and the boundary circle."""
    R = float(lan.domain_radius)
    n_base = max(int(25 + 20 * refinement), 16)
    h_far = 2 * R / n_base
    positions = np.atleast_2d(lan.positions)
    pml = lan.pml_thickness
    pml_start = R - pml * 1.1 if pml > 0 else R
    pts, fans = [], []
    for (cx, cy), r in zip(positions, lan.core_radii):
        h_core = r / max(5.5 * refinement, 3.0)
        radii_in = np.arange(0.0, 0.90 * r - 0.25 * h_core, h_core)
        h_int = r / max(9.0 * refinement, 5.0)
        k = np.arange(-int(np.floor(0.10 * r / h_int)),
                      int(np.floor(0.30 * r / h_int)) + 1)
        radii_ifc = r + h_int * k
        radii_out = []
        rr, h = radii_ifc[-1] if len(radii_ifc) else 1.3 * r, h_int
        extent = min(max(3.0 * r, 1.3 * r + 3 * h_far),
                     0.5 * lan.pitch + 1.3 * r if lan.n_cores > 1 else 1e9)
        while rr < extent and h < h_far:
            h = min(h * 1.45, h_far)
            rr = rr + h
            radii_out.append(rr)
        ring_p, ring_h = _rings(cx, cy, np.concatenate(
            [radii_in, radii_ifc, np.array(radii_out)]))
        if lan.n_cores > 1:
            c = np.array([cx, cy])
            d_all = np.linalg.norm(ring_p[:, None, :] - positions[None], axis=-1)
            own = np.linalg.norm(ring_p - c, axis=1)
            d_all[:, np.argmin(np.linalg.norm(positions - c, axis=1))] = np.inf
            ring_p = ring_p[own <= d_all.min(axis=1) - 0.35 * ring_h]
        pts.append(ring_p)
        fans.append(rr + 0.55 * h_far)
    ax = np.linspace(-R, R, n_base)
    X, Y = np.meshgrid(ax, ax)
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)
    keep = np.linalg.norm(grid, axis=1) <= pml_start - 0.55 * h_far
    for c, ext in zip(positions, fans):
        keep &= np.linalg.norm(grid - c[None, :], axis=1) > ext
    pts.append(grid[keep])
    if pml > 0 and pml_start > 0:
        n_r = max(int(6 * refinement), 4)
        h_pml = (R - pml_start) / n_r
        pts.append(_rings(0.0, 0.0, np.arange(pml_start, R - 0.25 * h_pml,
                                              h_pml))[0])
    h_bd = min(h_far, (R - pml_start) / max(int(6 * refinement), 4)) \
        if pml > 0 else h_far
    n_bd = max(24, int(np.ceil(2 * np.pi * R / h_bd)))
    th = 2 * np.pi * np.arange(n_bd) / n_bd
    pts.append(R * np.stack([np.cos(th), np.sin(th)], axis=1))
    p = np.vstack(pts)
    p = p[np.linalg.norm(p, axis=1) <= R * (1 + 1e-12)]
    return np.unique(np.round(p, 8), axis=0)


@dataclasses.dataclass
class Mesh:
    """P2 mesh with its quadrature tables (exact sizes, f64)."""

    elem_dofs: np.ndarray     # (T, 6)
    dof_coords: np.ndarray    # (n, 2)
    interior: np.ndarray      # (n,) bool: not on the outer boundary
    qp_xy: np.ndarray         # (T, Q, 2)
    qp_w: np.ndarray          # (T, Q)
    grad: np.ndarray          # (T, Q, 6, 2) physical shape gradients
    N: np.ndarray             # (Q, 6)

    @property
    def n_dofs(self) -> int:
        return len(self.dof_coords)


def build(lan, mesh_cfg: dict) -> Mesh:
    """The mesh of ``lan`` under a configuration's ``mesh`` block
    (refinement, mesh_min_points, mesh_target_points)."""
    circles = np.column_stack([lan.positions[:, 0], lan.positions[:, 1],
                               lan.core_radii])
    pts = point_cloud(lan, float(mesh_cfg["refinement"]))
    try:
        tri = Delaunay(pts)
    except QhullError:
        tri = Delaunay(pts, qhull_options="QJ Pp")
    points = np.ascontiguousarray(tri.points, dtype=np.float64)
    tris = _ccw(points, tri.simplices)
    lo, target = int(mesh_cfg["mesh_min_points"]), int(
        mesh_cfg["mesh_target_points"])
    it = 0
    while len(points) < lo and it < MAX_REFINEMENTS:
        points, tris = _refine(points, tris, circles)
        it += 1
        if len(points) > target * 2.5:
            break
    if (len(points) < target and float(mesh_cfg["refinement"]) > 0.8
            and it < MAX_REFINEMENTS):
        v1 = points[tris[:, 1]] - points[tris[:, 0]]
        v2 = points[tris[:, 2]] - points[tris[:, 0]]
        areas = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])
        points, tris = _refine_marked(
            points, tris, np.argsort(areas)[len(areas) // 2:], circles)
    return _p2(points, tris, circles)


def _p2(points, tris, circles) -> Mesh:
    uniq, e2e = _edges(tris)
    nv = len(points)
    elem_dofs = np.concatenate([tris, nv + e2e], axis=1)
    mids = _snap(points[uniq[:, 0]], points[uniq[:, 1]],
                 0.5 * (points[uniq[:, 0]] + points[uniq[:, 1]]), circles)
    coords = np.vstack([points, mids])
    counts = np.bincount(e2e.ravel(), minlength=len(uniq))
    bd = np.where(counts == 1)[0]
    interior = np.ones(len(coords), dtype=bool)
    interior[np.unique(uniq[bd].ravel())] = False
    interior[nv + bd] = False

    N, dN = p2_shape(QP)

    def iso(nodes):
        Jq = np.einsum("tia,qib->tqab", nodes, dN)
        det = Jq[..., 0, 0] * Jq[..., 1, 1] - Jq[..., 0, 1] * Jq[..., 1, 0]
        inv = np.empty_like(Jq)
        inv[..., 0, 0] = Jq[..., 1, 1]
        inv[..., 0, 1] = -Jq[..., 1, 0]
        inv[..., 1, 0] = -Jq[..., 0, 1]
        inv[..., 1, 1] = Jq[..., 0, 0]
        return det, inv / det[..., None, None]

    det, invT = iso(coords[elem_dofs])
    for _ in range(3):
        bad = np.nonzero(det.min(axis=1) <= 0)[0]
        if len(bad) == 0:
            break
        # an arc midpoint turned a sliver inside out: straight chords
        for e in bad:
            for loc in range(3):
                a_, b_ = points[tris[e, [(loc + 1) % 3, (loc + 2) % 3]]]
                coords[elem_dofs[e, 3 + loc]] = 0.5 * (a_ + b_)
        det, invT = iso(coords[elem_dofs])
    nodes = coords[elem_dofs]
    return Mesh(elem_dofs=elem_dofs, dof_coords=coords, interior=interior,
                qp_xy=np.einsum("qi,tia->tqa", N, nodes),
                qp_w=np.abs(det) * QW[None, :],
                grad=np.einsum("tqab,qib->tqia", invT, dN), N=N)
