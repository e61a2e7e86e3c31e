"""Material dispersion models.

The reference README documents (but its snapshot does not ship) a
``materials.py`` with an IP-Dip Cauchy model used for multi-band sweeps
(the reference's README.md:272-279):

    n(lambda) = 1.5259 + 0.00860/lambda^2 + 0.000210/lambda^4   [lambda in um]

with residual |dn| < 3e-4 over 1460-1675 nm. This module provides that
model plus silica/air, as pure functions usable both on host and inside
jitted code (they are simple polynomials in 1/lambda^2).
"""
from __future__ import annotations

import numpy as np

from .constants import PHYS


class CauchyMaterial:
    """n(lambda) = A + B/lambda^2 + C/lambda^4 with lambda in micrometres."""

    def __init__(self, A: float, B: float, C: float, name: str = "cauchy"):
        self.A = float(A)
        self.B = float(B)
        self.C = float(C)
        self.name = name

    def n_um(self, wavelength_um):
        """Refractive index at wavelength [um]. Works on numpy arrays."""
        il2 = 1.0 / (wavelength_um * wavelength_um)
        return self.A + self.B * il2 + self.C * il2 * il2

    def n(self, wavelength_nm):
        """Refractive index at wavelength [nm] (reference README API)."""
        return self.n_um(np.asarray(wavelength_nm, dtype=np.float64) * 1e-3)

    def group_index_um(self, wavelength_um):
        """n_g = n - lambda dn/dlambda."""
        lam = wavelength_um
        dn = -2.0 * self.B / lam**3 - 4.0 * self.C / lam**5
        return self.n_um(lam) - lam * dn


class _IPDipCauchy(CauchyMaterial):
    """IP-Dip photoresist Cauchy fit (README.md:275)."""

    def __init__(self):
        super().__init__(A=1.5259, B=0.00860, C=0.000210, name="IP-Dip")


class _Silica(CauchyMaterial):
    """Fused-silica Cauchy approximation anchored at n(1.55um)=1.4440.

    Coefficients fitted to the Malitson Sellmeier curve over 1.3-1.7 um;
    only used for MMF cladding indices where the reference uses the fixed
    PhysConst.N_SILICA (geometry_unified.py:62).
    """

    def __init__(self):
        super().__init__(A=1.4380, B=0.00390, C=0.0, name="silica")
        # shift A so n(1.55) == PHYS.N_SILICA exactly
        self.A += PHYS.N_SILICA - self.n_um(1.55)


IPDipCauchy = _IPDipCauchy()
Silica = _Silica()
Air = CauchyMaterial(A=PHYS.N_AIR, B=0.0, C=0.0, name="air")

MATERIALS = {"ip-dip": IPDipCauchy, "silica": Silica, "air": Air}
