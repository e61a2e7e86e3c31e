"""P2 Lagrange reference element and triangle quadrature.

Local node convention (barycentric coordinates L0, L1, L2):
  nodes 0..2 : vertices
  node  3+k  : midpoint of the edge opposite vertex k (between vertices
               (k+1)%3 and (k+2)%3)

Shape functions:
  vertex i : Li (2 Li - 1)
  edge 3+k : 4 L_{k+1} L_{k+2}

Quadrature: Dunavant rules on the reference triangle
{(x, y) : x, y >= 0, x + y <= 1}; the degree-4 six-point rule matches the
exactness the reference obtains through scikit-fem's default P2 rule
(the reference's solver_fem.py:153-156 assembles with ElementTriP2).
"""
from __future__ import annotations

import numpy as np

# Dunavant degree-4, 6-point rule (weights sum to 1/2 = reference area).
_A1, _B1 = 0.445948490915965, 0.108103018168070
_A2, _B2 = 0.091576213509771, 0.816847572980459
DUNAVANT4_POINTS = np.array([
    [_A1, _A1], [_B1, _A1], [_A1, _B1],
    [_A2, _A2], [_B2, _A2], [_A2, _B2],
])
DUNAVANT4_WEIGHTS = 0.5 * np.array([
    0.223381589678011, 0.223381589678011, 0.223381589678011,
    0.109951743655322, 0.109951743655322, 0.109951743655322,
])

# Degree-2 three-point rule (exact for the P1xP1 products).
DUNAVANT2_POINTS = np.array([
    [1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
DUNAVANT2_WEIGHTS = 0.5 * np.array([1 / 3, 1 / 3, 1 / 3])

# Degree-5 seven-point rule (for convergence studies).
_W0 = 0.225
_A3, _B3, _W3 = 0.470142064105115, 0.059715871789770, 0.132394152788506
_A4, _B4, _W4 = 0.101286507323456, 0.797426985353087, 0.125939180544827
DUNAVANT5_POINTS = np.array([
    [1 / 3, 1 / 3],
    [_A3, _A3], [_B3, _A3], [_A3, _B3],
    [_A4, _A4], [_B4, _A4], [_A4, _B4],
])
DUNAVANT5_WEIGHTS = 0.5 * np.array([_W0, _W3, _W3, _W3, _W4, _W4, _W4])

RULES = {2: (DUNAVANT2_POINTS, DUNAVANT2_WEIGHTS),
         4: (DUNAVANT4_POINTS, DUNAVANT4_WEIGHTS),
         5: (DUNAVANT5_POINTS, DUNAVANT5_WEIGHTS)}


def p2_shape(points: np.ndarray):
    """Evaluate P2 shape functions and reference gradients.

    Args:
        points: (Q, 2) reference coordinates (x, y); L0 = 1-x-y, L1 = x, L2 = y.

    Returns:
        N:  (Q, 6) shape function values
        dN: (Q, 6, 2) gradients w.r.t. reference coordinates
    """
    pts = np.asarray(points, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    L = np.stack([1.0 - x - y, x, y], axis=1)            # (Q, 3)
    dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2) constant

    Q = pts.shape[0]
    N = np.zeros((Q, 6))
    dN = np.zeros((Q, 6, 2))
    for i in range(3):
        N[:, i] = L[:, i] * (2.0 * L[:, i] - 1.0)
        dN[:, i, :] = (4.0 * L[:, i] - 1.0)[:, None] * dL[i][None, :]
    for k in range(3):
        a, b = (k + 1) % 3, (k + 2) % 3
        N[:, 3 + k] = 4.0 * L[:, a] * L[:, b]
        dN[:, 3 + k, :] = 4.0 * (L[:, a][:, None] * dL[b][None, :] +
                                 L[:, b][:, None] * dL[a][None, :])
    return N, dN


def p2_local_nodes():
    """Reference coordinates of the 6 local nodes (vertices + midpoints)."""
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    mids = np.array([(verts[(k + 1) % 3] + verts[(k + 2) % 3]) / 2.0
                     for k in range(3)])
    return np.vstack([verts, mids])
