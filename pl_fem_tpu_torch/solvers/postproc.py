"""Mode post-processing shared by the scalar and vectorial solvers.

Replicates the diagnostics of the reference's solver_fem.py:47-107
(DOF-energy confinement, in-core polarization power ratio with the
V18.11 TE/HE/Hybrid/EH/TM thresholds, PDL in dB) as numpy array
functions over all candidate modes at once.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# Polarization classification thresholds on ratio = P_x / P_y
# (solver_fem.py:100-105).
_POL_THRESHOLDS = (10.0, 2.5, 0.4, 0.1)
_POL_LABELS = ("TE-like", "HE-like", "Hybrid", "EH-like", "TM-like")


def in_core_mask(dof_coords, positions, radii, factor: float = 1.0):
    """Boolean (D,) mask of DOFs inside any (scaled) core disk."""
    xy = np.asarray(dof_coords)
    positions = np.asarray(positions)
    d2 = ((xy[:, 0:1] - positions[None, :, 0]) ** 2
          + (xy[:, 1:2] - positions[None, :, 1]) ** 2)
    return np.any(d2 <= (factor * np.asarray(radii)) ** 2, axis=-1)


def confinement_from_dofs(energy, core_mask):
    """In-core DOF-energy fraction, batched over modes.

    Args:
        energy: (D, k) per-DOF energy density (|v|^2 summed over field
            components).
        core_mask: (D,) boolean.

    Returns:
        (k,) confinement in [0, 1]  (solver_fem.py:47-65 semantics).
    """
    energy = np.asarray(energy)
    total = energy.sum(axis=0) + 1e-30
    inside = np.where(np.asarray(core_mask)[:, None], energy, 0.0).sum(axis=0)
    return np.clip(inside / total, 0.0, 1.0)


def polarization_from_powers(P_x, P_y) -> Tuple[np.ndarray, np.ndarray]:
    """PDL (dB) and polarization class index from in-core powers.

    ratio > 10 TE-like | > 2.5 HE-like | > 0.4 Hybrid | > 0.1 EH-like |
    else TM-like (solver_fem.py:100-105). Returns (PDL_dB, class_idx);
    map class_idx through :data:`_POL_LABELS` for the string label.
    """
    P_x = np.asarray(P_x) + 1e-30
    P_y = np.asarray(P_y) + 1e-30
    ratio = P_x / P_y
    pdl = np.clip(10.0 * np.log10(np.maximum(ratio, 1.0 / ratio)), 0.0, 50.0)
    idx = np.select([ratio > t for t in _POL_THRESHOLDS], [0, 1, 2, 3],
                    default=4)
    return pdl, idx


def polarization_label(idx: int) -> str:
    return _POL_LABELS[int(idx)]
