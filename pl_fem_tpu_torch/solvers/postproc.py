"""Mode post-processing of the vectorial solver.

Replicates the diagnostics of the reference's solver_fem.py:88-107
(in-core polarization power ratio with the V18.11 TE/HE/Hybrid/EH/TM
thresholds, PDL in dB) as numpy array functions over all candidate
modes at once.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# Polarization classification thresholds on ratio = P_x / P_y
# (solver_fem.py:100-105).
_POL_THRESHOLDS = (10.0, 2.5, 0.4, 0.1)
_POL_LABELS = ("TE-like", "HE-like", "Hybrid", "EH-like", "TM-like")


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
