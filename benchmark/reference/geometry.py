"""A configuration's lantern cross-section: core positions, the derived
radii and the real permittivity at points.

Frozen copy of the sizing rules of the program's ``models/layouts.py`` and
``MCFGeometry`` (cladding and domain radii, the PML annulus), so that the
reference meshes the same domain from the configuration alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _ring(n: int, radius: float, phase_deg: float = 0.0) -> np.ndarray:
    ang = np.deg2rad(phase_deg) + 2.0 * np.pi * np.arange(n) / n
    return radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)


LAYOUTS = {
    "hexagonal_1plus6_7": lambda p: np.vstack([np.zeros((1, 2)),
                                               _ring(6, p, 0.0)]),
}


@dataclasses.dataclass(frozen=True)
class Lantern:
    positions: np.ndarray        # (N, 2) um
    core_radii: np.ndarray       # (N,) um
    n_core: float
    n_clad: float
    wavelength_um: float
    pitch: float
    domain_radius: float
    pml_thickness: float

    @property
    def n_cores(self) -> int:
        return len(self.core_radii)

    @property
    def k0(self) -> float:
        return 2.0 * np.pi / self.wavelength_um

    def eps_re(self, x, y):
        """Real relative permittivity at points: n_core^2 inside a core
        (boundary included), n_clad^2 elsewhere; the PML changes only the
        imaginary part, which the guided modes' real pencil leaves out."""
        pos, rad = self.positions, self.core_radii
        d2 = ((x[..., None] - pos[:, 0]) ** 2 + (y[..., None] - pos[:, 1]) ** 2)
        inside = np.any(d2 <= rad ** 2, axis=-1)
        return np.where(inside, self.n_core ** 2, self.n_clad ** 2)


def lantern(geometry: dict, wavelength_um: float) -> Lantern:
    """The cross-section that ``geometry`` (a configuration's block)
    describes, at ``wavelength_um``."""
    pos = np.asarray(LAYOUTS[geometry["layout"]](float(geometry["pitch_um"])),
                     dtype=np.float64)
    r = float(geometry["core_radius_um"])
    n = len(pos)
    rad = np.full(n, r)
    if n > 1:
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        pitch = float(d[np.triu_indices(n, 1)].min())
        max_r = float(np.linalg.norm(pos, axis=1).max())
    else:
        pitch, max_r = 0.0, 0.0
    pml = float(geometry["pml_thickness_um"])
    clad = max(max_r * 1.8 + r * 2, 20.0)
    domain = max(max_r + r * 4, clad + pml * 1.2)
    return Lantern(pos, rad, float(geometry["n_core"]),
                   float(geometry["n_clad"]), float(wavelength_um), pitch,
                   domain, pml)
