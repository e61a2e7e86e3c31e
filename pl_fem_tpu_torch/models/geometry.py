"""Unified MCF / taper / MMF geometry models.

Capability parity with the reference's geometry_unified.py (MCFGeometry,
TaperSection, MMFGeometry, PhotonicLantern, PhotonicLanternGeometry),
redesigned so permittivity evaluation is a pure array function
(`eps_params()` + :func:`epsilon_at`) usable on host for meshing and on
device for jitted quadrature-point evaluation.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..constants import PHYS
from . import layouts


@dataclasses.dataclass(frozen=True)
class EpsParams:
    """Static array bundle describing eps(x, y); consumable inside jit."""

    positions: np.ndarray      # (N, 2)
    core_radii: np.ndarray     # (N,)
    eps_core: float
    eps_clad: float
    pml_start: float           # radius where PML begins (<=0 disables)
    pml_thickness: float
    pml_strength: float
    pml_order: int


def epsilon_at(p: EpsParams, x, y, xp=np):
    """Complex relative permittivity at points (x, y).

    Piecewise-constant core/cladding with annular polynomial PML
    eps *= (1 + i*sigma*rho^order) (same model as the reference,
    geometry_unified.py:325-347). `xp` is an array namespace such as numpy.
    """
    x = xp.asarray(x)
    y = xp.asarray(y)
    in_core = xp.zeros(x.shape, dtype=bool)
    for (cx, cy), r in zip(np.asarray(p.positions), np.asarray(p.core_radii)):
        in_core = in_core | ((x - cx) ** 2 + (y - cy) ** 2 <= r * r)
    eps_re = xp.where(in_core, p.eps_core, p.eps_clad)
    if p.pml_thickness > 0.0 and p.pml_start > 0.0:
        r_dist = xp.sqrt(x * x + y * y)
        rho = xp.clip((r_dist - p.pml_start) / p.pml_thickness, 0.0, 1.0)
        sigma = p.pml_strength * rho ** p.pml_order
        return eps_re * (1.0 + 1j * sigma)
    return eps_re + 0.0j


class MCFGeometry:
    """Multicore-fiber cross-section geometry with derived optics.

    Guaranteed attribute contract (consumed by mesh/solver/loss layers;
    parity with geometry_unified.py:15-32): positions, core_positions,
    core_radii, r_core, n_core, n_clad, n_cores, k0, wavelength,
    domain_radius, cladding_radius, pml_thickness, use_complex_pml,
    V_number, epsilon(x, y), hash.
    """

    SUPPORTED_N = layouts.SUPPORTED_N_CORES

    def __init__(
        self,
        n_cores: int,
        pitch_um: float,
        core_radius_um: float,
        n_core: float,
        n_clad: float = PHYS.N_AIR,
        wavelength_um: float = 1.55,
        cladding_radius: Optional[float] = None,
        pml_thickness: float = PHYS.PML_THICKNESS_UM,
        pml_strength: float = PHYS.PML_STRENGTH,
        pml_order: int = PHYS.PML_ORDER,
        use_complex_pml: bool = True,
        taper_length_um: Optional[float] = None,
        variant: Optional[str] = None,
    ):
        self.n_cores = int(n_cores)
        self.n_core = float(n_core)
        self.n_clad = float(n_clad)
        self.delta_n = self.n_core - self.n_clad
        if self.delta_n < 1e-6:
            raise ValueError(f"delta_n={self.delta_n:.2e} too small")
        self.wavelength = float(wavelength_um)
        self.k0 = 2.0 * np.pi / self.wavelength
        self.variant = variant

        (self.positions, self.config_type, self.has_central_core,
         self.n_peripheral, self.R_ring) = layouts.generate_core_positions(
            n_cores, pitch_um, variant)
        # constructor pitch parameter: positions are linear in it, but
        # the MEASURED nearest-neighbour `pitch` below differs for the
        # pure-ring layouts (N=3: sqrt(3)x, N=5: 1.18x) — rescaling a
        # geometry (tapers, canonical bucketing) must reuse THIS value
        self.pitch_param = float(pitch_um)
        self.core_radii = np.full(self.n_cores, float(core_radius_um))
        self.core_positions = self.positions   # mesh-layer alias
        self.r_core = float(core_radius_um)    # CLI-layer alias

        self.V_number = self.k0 * self.r_core * np.sqrt(
            max(self.n_core**2 - self.n_clad**2, 0.0))

        if self.n_cores > 1:
            d = np.linalg.norm(
                self.positions[:, None, :] - self.positions[None, :, :], axis=-1)
            self.pitch = float(d[np.triu_indices(self.n_cores, 1)].min())
            max_r = float(np.linalg.norm(self.positions, axis=1).max())
        else:
            self.pitch = 0.0
            max_r = 0.0
        self.pitch_min = self.pitch
        self.pitch_ratio = self.pitch / (2 * self.r_core) if self.r_core > 0 else 0.0

        # Derived radii: same sizing rules as the reference
        # (geometry_unified.py:269-278) so meshes are comparable.
        self.cladding_radius = (
            float(cladding_radius) if cladding_radius is not None
            else max(max_r * 1.8 + self.r_core * 2, 20.0))
        self._domain_radius = max(
            max_r + self.r_core * 4,
            self.cladding_radius + pml_thickness * 1.2)

        self.pml_thickness = float(pml_thickness)
        self.pml_strength = float(pml_strength)
        self.pml_order = int(pml_order)
        self.use_complex_pml = bool(use_complex_pml)
        self.taper_length = taper_length_um

        area_c = self.n_cores * np.pi * self.r_core**2
        area_t = np.pi * (max_r + self.r_core) ** 2 if self.n_cores > 1 else area_c
        self.packing_efficiency = float(area_c / max(area_t, 1e-9))

        self._hash = self._compute_hash()

    # -- properties ---------------------------------------------------------
    @property
    def domain_radius(self) -> float:
        return self._domain_radius

    @property
    def hash(self) -> str:
        return self._hash

    def _compute_hash(self) -> str:
        h = hashlib.sha256()
        h.update(str(self.n_cores).encode())
        h.update(np.ascontiguousarray(self.positions).tobytes())
        h.update(np.ascontiguousarray(self.core_radii).tobytes())
        h.update(f"{self.n_core:.6f}{self.n_clad:.6f}{self.wavelength:.6f}".encode())
        h.update(f"{self.cladding_radius:.4f}{self.pml_thickness:.2f}".encode())
        h.update(str(self.use_complex_pml).encode())
        return h.hexdigest()[:20]

    # -- permittivity -------------------------------------------------------
    def eps_params(self) -> EpsParams:
        return EpsParams(
            positions=np.asarray(self.positions, dtype=np.float64),
            core_radii=np.asarray(self.core_radii, dtype=np.float64),
            eps_core=self.n_core**2,
            eps_clad=self.n_clad**2,
            pml_start=(self._domain_radius - self.pml_thickness
                       if self.use_complex_pml else -1.0),
            pml_thickness=self.pml_thickness if self.use_complex_pml else 0.0,
            pml_strength=self.pml_strength,
            pml_order=self.pml_order,
        )

    def epsilon(self, x, y) -> np.ndarray:
        """Complex relative permittivity eps(x, y) on the host."""
        return epsilon_at(self.eps_params(), np.asarray(x, dtype=np.float64),
                          np.asarray(y, dtype=np.float64))

    # -- validation ---------------------------------------------------------
    def validate(self) -> Tuple[bool, str]:
        """Physical sanity gates (geometry_unified.py:351-363 semantics)."""
        if self.delta_n < 5e-4:
            return False, f"delta_n too small ({self.delta_n:.2e})"
        if self.V_number < 0.5:
            return False, f"V-number too small ({self.V_number:.2f})"
        if self.V_number > 20.0:
            return False, f"V-number too large ({self.V_number:.2f})"
        for i in range(self.n_cores):
            for j in range(i + 1, self.n_cores):
                d = np.linalg.norm(self.positions[i] - self.positions[j])
                if d < (self.core_radii[i] + self.core_radii[j]) * 0.85:
                    return False, f"core overlap {i}<->{j}: d={d:.2f}um"
        return True, "OK"

    # -- taper --------------------------------------------------------------
    def get_tapered(self, z: float) -> "MCFGeometry":
        """Geometry scaled to longitudinal position z along the taper."""
        if self.taper_length is None or self.taper_length <= 0.0:
            return self
        s = float(np.clip(z / self.taper_length, 0.0, 1.0))
        return MCFGeometry(
            n_cores=self.n_cores,
            pitch_um=(self.pitch_param * s if self.n_cores > 1
                      else max(self.pitch_param, 1.0)),
            core_radius_um=self.r_core * s,
            n_core=self.n_core,
            n_clad=self.n_clad,
            wavelength_um=self.wavelength,
            cladding_radius=self.cladding_radius,
            pml_thickness=self.pml_thickness,
            pml_strength=self.pml_strength,
            pml_order=self.pml_order,
            use_complex_pml=self.use_complex_pml,
            taper_length_um=self.taper_length,
            variant=self.variant,
        )

    def get_info(self) -> Dict:
        return {
            "n_cores": self.n_cores,
            "config_type": self.config_type,
            "has_central_core": self.has_central_core,
            "n_peripheral": self.n_peripheral,
            "R_ring_um": float(self.R_ring),
            "pitch_um": float(self.pitch),
            "pitch_ratio": float(self.pitch_ratio),
            "core_radius_um": float(self.r_core),
            "n_core": self.n_core,
            "n_clad": self.n_clad,
            "delta_n": float(self.delta_n),
            "V_number": float(self.V_number),
            "wavelength_um": self.wavelength,
            "cladding_radius_um": float(self.cladding_radius),
            "domain_radius_um": float(self._domain_radius),
            "pml_thickness_um": float(self.pml_thickness),
            "packing_efficiency": float(self.packing_efficiency),
            "taper_length_um": self.taper_length,
            "hash": self.hash,
        }

    def __repr__(self) -> str:
        return (f"MCFGeometry(N={self.n_cores}, {self.config_type}, "
                f"pitch={self.pitch:.1f}um, r={self.r_core:.2f}um, "
                f"V={self.V_number:.2f}, n={self.n_core:.4f}/{self.n_clad:.4f})")


def taper_profile_fraction(profile: str, t: float,
                           exponent: float = 1.0) -> float:
    """Normalized taper profile p(t): [0, 1] -> [0, 1], p(0)=0, p(1)=1.

    The four profile shapes of the reference's TaperSection
    (geometry_unified.py:468-480); shared by ``TaperSection.scale_at``
    and the CMT z-slice placement in the dataset generator (which maps
    a sampled ``taper_profile`` to the cross-section scale along z —
    the column is physical, not just recorded).
    """
    t = float(np.clip(t, 0.0, 1.0))
    if profile == "power":
        return float(t ** exponent)
    if profile == "sinusoidal":
        return float(0.5 * (1.0 - np.cos(np.pi * t)))
    if profile == "exponential":
        return float((np.exp(t) - 1.0) / (np.e - 1.0))
    return t  # linear


@dataclasses.dataclass
class TaperSection:
    """Three-section taper: Source -> MUX -> Output.

    Parity with geometry_unified.py:423-500 (Dana et al. LSA 2024 device
    structure); scale profiles are pure functions so they can be traced.
    """

    source_length_um: float
    source_diam_in_um: float
    source_diam_out_um: float
    mux_length_um: float
    mux_diam_in_um: float
    mux_diam_out_um: float
    output_length_um: float
    output_diam_in_um: float
    output_diam_out_um: float
    profile: str = "exponential"   # linear | power | sinusoidal | exponential
    exponent: float = 1.0

    @property
    def total_length_um(self) -> float:
        return self.source_length_um + self.mux_length_um + self.output_length_um

    @property
    def total_length_mm(self) -> float:
        return self.total_length_um / 1000.0

    def validate(self) -> Tuple[bool, str]:
        tol = 0.1
        if abs(self.source_diam_out_um - self.mux_diam_in_um) > tol:
            return False, ("source->mux diameter discontinuity: "
                           f"{self.source_diam_out_um:.3f} != {self.mux_diam_in_um:.3f}")
        if abs(self.mux_diam_out_um - self.output_diam_in_um) > tol:
            return False, ("mux->output diameter discontinuity: "
                           f"{self.mux_diam_out_um:.3f} != {self.output_diam_in_um:.3f}")
        if self.total_length_um <= 0:
            return False, "zero total length"
        return True, "TaperSection valid"

    def scale_at(self, z_um: float) -> float:
        """Geometric scale factor at longitudinal position z."""
        L = self.total_length_um
        if L <= 0:
            return 1.0
        return taper_profile_fraction(self.profile, z_um / L,
                                      self.exponent)

    @classmethod
    def from_mcf(cls, mcf: MCFGeometry, total_length_mm: float,
                 output_diam_um: float = 125.0) -> "TaperSection":
        """Standard 15/60/25% split taper built from an MCF cross-section."""
        L = total_length_mm * 1000.0
        d_src = 2 * (mcf.R_ring + mcf.r_core)
        d_mid = d_src * 0.3
        return cls(
            source_length_um=L * 0.15,
            source_diam_in_um=d_src,
            source_diam_out_um=d_mid,
            mux_length_um=L * 0.60,
            mux_diam_in_um=d_mid,
            mux_diam_out_um=output_diam_um * 0.15,
            output_length_um=L * 0.25,
            output_diam_in_um=output_diam_um * 0.15,
            output_diam_out_um=output_diam_um,
        )


class MMFGeometry:
    """Output multimode fiber (standard 125-um silica, NA~0.22)."""

    def __init__(
        self,
        core_radius_um: float = 25.0,
        clad_radius_um: float = 62.5,
        n_core: float = PHYS.N_SILICA * 1.005,
        n_clad: float = PHYS.N_SILICA,
        wavelength_um: float = 1.55,
        length_um: float = 100.0,
    ):
        self.r_core = float(core_radius_um)
        self.r_clad = float(clad_radius_um)
        self.n_core = float(n_core)
        self.n_clad = float(n_clad)
        self.wavelength = float(wavelength_um)
        self.length_um = float(length_um)
        self.k0 = 2 * np.pi / self.wavelength
        self.NA = float(np.sqrt(max(n_core**2 - n_clad**2, 0.0)))
        self.V_number = self.k0 * self.r_core * self.NA
        self.M_modes = max(1, int(self.V_number**2 / 2))

    @property
    def n_modes_estimate(self) -> int:
        return self.M_modes

    def get_info(self) -> Dict:
        return {
            "r_core_um": self.r_core, "r_clad_um": self.r_clad,
            "n_core": self.n_core, "n_clad": self.n_clad,
            "NA": self.NA, "V_number": self.V_number, "M_modes": self.M_modes,
            "length_um": self.length_um, "wavelength_um": self.wavelength,
        }

    def __repr__(self) -> str:
        return (f"MMFGeometry(r={self.r_core:.1f}um, NA={self.NA:.3f}, "
                f"V={self.V_number:.1f}, M~{self.M_modes})")


class PhotonicLantern:
    """Complete assembly: MCF + TaperSection + MMF."""

    def __init__(self, mcf: MCFGeometry, taper: TaperSection, mmf: MMFGeometry):
        self.mcf = mcf
        self.taper = taper
        self.mmf = mmf

    @classmethod
    def build(
        cls,
        n_cores: int,
        pitch_um: float,
        core_radius_um: float,
        n_core: float,
        n_clad: float = 1.0,
        wavelength_um: float = 1.55,
        taper_length_mm: float = 0.375,
        mmf_core_radius: float = 25.0,
        mmf_clad_radius: float = 62.5,
        cladding_radius: Optional[float] = None,
        pml_thickness: float = 10.0,
        use_complex_pml: bool = True,
        variant: Optional[str] = None,
    ) -> "PhotonicLantern":
        mcf = MCFGeometry(
            n_cores=n_cores, pitch_um=pitch_um, core_radius_um=core_radius_um,
            n_core=n_core, n_clad=n_clad, wavelength_um=wavelength_um,
            cladding_radius=cladding_radius, pml_thickness=pml_thickness,
            use_complex_pml=use_complex_pml,
            taper_length_um=taper_length_mm * 1000.0, variant=variant)
        taper = TaperSection.from_mcf(mcf, taper_length_mm,
                                      output_diam_um=2 * mmf_core_radius)
        mmf = MMFGeometry(
            core_radius_um=mmf_core_radius, clad_radius_um=mmf_clad_radius,
            n_core=n_core * 0.998,
            n_clad=n_clad * 1.002 if n_clad > 1.01 else n_clad,
            wavelength_um=wavelength_um)
        return cls(mcf, taper, mmf)

    def summary(self) -> str:
        return "\n".join([
            "PhotonicLantern:",
            f"  MCF  : {self.mcf}",
            f"         V={self.mcf.V_number:.2f} pitch={self.mcf.pitch:.2f}um "
            f"r={self.mcf.r_core:.2f}um dn={self.mcf.delta_n:.4f} "
            f"packing={self.mcf.packing_efficiency * 100:.1f}%",
            f"  Taper: L={self.taper.total_length_mm:.3f}mm "
            f"profile={self.taper.profile} "
            f"d_in={self.taper.source_diam_in_um:.1f}um -> "
            f"d_out={self.taper.output_diam_out_um:.1f}um",
            f"  MMF  : {self.mmf}",
        ])


class PhotonicLanternGeometry(MCFGeometry):
    """Explicit-positions facade over MCFGeometry.

    Accepts arbitrary core_positions/core_radii (back-compat seam used by
    the reference solver/mesh imports, geometry_unified.py:637-678).
    """

    def __init__(self, n_cores, arrangement, core_positions, core_radii,
                 n_core, n_clad=1.0, cladding_radius=None, wavelength=1.55,
                 taper_length=None, pml_thickness=10.0, pml_strength=3.0,
                 pml_order=2, use_complex_pml=True, **kwargs):
        positions = np.atleast_2d(np.asarray(core_positions, dtype=np.float64))
        radii = np.atleast_1d(np.asarray(core_radii, dtype=np.float64))
        if len(positions) > 1:
            d = np.linalg.norm(positions[:, None] - positions[None, :], axis=-1)
            pitch = float(d[np.triu_indices(len(positions), 1)].min())
        else:
            pitch = float(radii.max()) * 4
        super().__init__(
            n_cores=n_cores, pitch_um=pitch,
            core_radius_um=float(radii.mean()), n_core=n_core, n_clad=n_clad,
            wavelength_um=wavelength, cladding_radius=cladding_radius,
            pml_thickness=pml_thickness, pml_strength=pml_strength,
            pml_order=pml_order, use_complex_pml=use_complex_pml,
            taper_length_um=taper_length)
        # Exact user-provided layout overrides the catalog positions.
        self.positions = positions
        self.core_positions = positions
        self.core_radii = radii
        self.arrangement = str(arrangement)
        self.pitch = self.pitch_min = pitch
        self.pitch_ratio = pitch / (2 * self.r_core) if self.r_core > 0 else 0.0
        self._hash = self._compute_hash()
