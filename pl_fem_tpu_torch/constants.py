"""Physical constants and default PML parameters.

Parity notes: mirrors the constant set of the reference implementation
(the reference's geometry_unified.py:61-67 ``PhysConst`` and
the reference's main.py:51-54 module constants), re-expressed as frozen
dataclasses so they can be threaded through jitted functions as static
configuration.
"""
from __future__ import annotations

import dataclasses

C_UM_PER_S = 2.99792458e14  # speed of light [um/s]


@dataclasses.dataclass(frozen=True)
class PhysConst:
    """Material / PML defaults (geometry_unified.py:61-67)."""

    N_SILICA: float = 1.4440        # fused silica @ 1550 nm
    N_POLYMER_BASE: float = 1.5200  # IP-Dip (two-photon polymer) base index
    N_AIR: float = 1.0000
    PML_STRENGTH: float = 3.0
    PML_ORDER: int = 2
    PML_THICKNESS_UM: float = 10.0


# CLI-pipeline constants (main.py:51-54)
POLYMER_N = 1.53
AIR_N = 1.0
V_MIN = 2.4
V_MAX = 10.0

PHYS = PhysConst()
