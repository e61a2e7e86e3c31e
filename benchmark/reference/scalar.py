"""Plain reference of the scalar configurations: the LP pencil's parts
assembled on the reference's own mesh, each returned design held to
them, and the exact guided modes of a design after the cascade
selection (``solve.scalar_modes``)."""
from __future__ import annotations

import numpy as np

from . import fem, geometry, judge, mesh, solve


class Checker:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        lan = geometry.lantern(cfg["geometry"], cfg["mesh"]["wavelength_um"])
        self.mesh = mesh.build(lan, cfg["mesh"])
        self.n_modes = int(cfg["n_modes"])
        self.k = int(cfg["correct"]["reference_k"])
        self.parts = fem.scalar_parts(self.mesh, lan)
        self.Ml = fem.core_mass(self.mesh, lan, 1.10)

    def lantern(self, wavelength_um: float):
        return geometry.lantern(self.cfg["geometry"], wavelength_um)

    def numbers(self, wavelength_um: float, out: list) -> dict:
        return judge.scalar(out, self.n_modes, self.lantern(wavelength_um).k0,
                            self.parts, self.Ml)

    def exact(self, wavelength_um: float, dtype=np.float64) -> list:
        return solve.scalar_modes(self.mesh, self.lantern(wavelength_um),
                                  self.n_modes, self.k, dtype=dtype,
                                  parts=self.parts)
