"""Canonical-grid bucketing: arbitrary LHS designs -> shared-mesh sweeps.

The packed sweep solver (solvers/vectorial.py ``solve_sweep``) needs
all members on ONE grid, which a raw LHS never provides (every design
has its own pitch/radius). But Maxwell's equations are scale-invariant:
a design at (pitch p, radius r, wavelength lam) has exactly the same
eigenmodes (same n_eff, scaled fields) as its rescaling to (p_can,
r*p_can/p, lam*p_can/p). So designs that share a core LAYOUT and a
radius-to-pitch RATIO class collapse onto one canonical cross-section,
differing only in quadrature-point permittivity and wavelength — which
is precisely what a packed sweep varies per lane.

The mesh is built once per bucket from the class-center geometry; the
interface-refinement band of the mesher (ops/femgrid.py: rings over
[0.90 r, 1.30 r]) absorbs the within-class radius spread (+-2.5% at
the default 5% class width). Cladding/PML radii are taken from the
class geometry for every member — they are absorbing-boundary
artifacts, not physics, and a shared domain is what makes the grid
shareable (the reference re-meshes per design and pays ARPACK + a new
factorization each time; the reference's main.py:343-386).

A taper is the special case that makes this pay twice: ``get_tapered``
scales pitch and radius together, so EVERY z-slice of a taper lands in
the same bucket — all CMT cross-sections solve as one sweep on one
grid (and the CMT overlap integrals get a common P2 basis for free).

No reference analog (SURVEY.md gap: the reference has no batching of
any kind).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from ..models import MCFGeometry

logger = logging.getLogger("pl_fem_tpu_torch.dataset.bucketing")

#: canonical pitch for multi-core buckets / canonical core radius for
#: single-core buckets (um) — the flagship values, so flagship-size
#: designs canonicalize near scale 1.
P_CANONICAL = 8.0
R_CANONICAL = 1.5

#: relative width of one radius-to-pitch class (geometric binning).
#: Wider bands collapse more designs per bucket (220-sample LHS: 146
#: buckets at 0.05, 71 at 0.20, 46 at 0.40 — layout diversity is the
#: residual) at the cost of a higher bucket accuracy floor: members sit
#: up to band/2 away from the class mesh's interface-refinement ring
#: ([0.90 r, 1.30 r], ops/femgrid.py), so +-10% (band 0.20) still keeps
#: every member interface inside the refined band. Configure per run
#: via MeshConfig.bucket_ratio_band; 0.05 stays the accuracy-safe
#: default (~1e-4 floor, docs/PARITY_r3.md §A).
RATIO_BAND = 0.05


@dataclasses.dataclass(frozen=True)
class BucketKey:
    n_cores: int
    variant: Optional[str]
    ratio_class: int
    n_clad_mil: int      # cladding index in milli-units (mesh-neutral,
    # kept in the key so bucket members share loss/validation regimes)

    def __hash__(self):
        return hash((self.n_cores, self.variant, self.ratio_class,
                     self.n_clad_mil))


def _ratio(geom: MCFGeometry) -> float:
    if geom.n_cores > 1:
        # constructor pitch parameter, NOT the measured nearest-
        # neighbour distance (they differ for pure-ring layouts)
        return geom.r_core / geom.pitch_param
    return 1.0


def _ratio_class(ratio: float, band: float = RATIO_BAND) -> int:
    return int(round(math.log(max(ratio, 1e-9))
                     / math.log1p(band)))


def _class_ratio(cls: int, band: float = RATIO_BAND) -> float:
    return float(math.exp(cls * math.log1p(band)))


def bucket_key(geom: MCFGeometry, band: float = RATIO_BAND) -> BucketKey:
    return BucketKey(
        n_cores=geom.n_cores,
        variant=geom.variant,
        ratio_class=_ratio_class(_ratio(geom), band),
        n_clad_mil=int(round(geom.n_clad * 1000)),
    )


def canonical_scale(geom: MCFGeometry) -> float:
    """s such that canonical lengths = physical lengths * s."""
    if geom.n_cores > 1:
        return P_CANONICAL / geom.pitch_param
    return R_CANONICAL / geom.r_core


def class_geometry(key: BucketKey, example: MCFGeometry,
                   band: float = RATIO_BAND) -> MCFGeometry:
    """Class-center representative used to build the bucket's mesh."""
    if key.n_cores > 1:
        r_can = _class_ratio(key.ratio_class, band) * P_CANONICAL
        pitch = P_CANONICAL
    else:
        r_can = R_CANONICAL
        pitch = P_CANONICAL
    return MCFGeometry(
        n_cores=key.n_cores,
        pitch_um=pitch,
        core_radius_um=r_can,
        n_core=example.n_core,
        n_clad=key.n_clad_mil / 1000.0,
        wavelength_um=example.wavelength,
        pml_strength=example.pml_strength,
        pml_order=example.pml_order,
        use_complex_pml=example.use_complex_pml,
        variant=key.variant,
    )


def canonicalize(geom: MCFGeometry, cls_geom: MCFGeometry
                 ) -> Tuple[MCFGeometry, float]:
    """Rescale ``geom`` to the bucket's canonical frame.

    Returns (canonical geometry, scale s). The canonical member keeps
    its own exact r/pitch ratio and indices (the sweep evaluates eps at
    quadrature points per design), but inherits the CLASS cladding/PML
    radii so all members see the identical computational domain.
    n_eff is invariant; beta scales back as beta_phys = beta_can * s.
    """
    s = canonical_scale(geom)
    can = MCFGeometry(
        n_cores=geom.n_cores,
        pitch_um=(geom.pitch_param * s if geom.n_cores > 1
                  else P_CANONICAL),
        core_radius_um=geom.r_core * s,
        n_core=geom.n_core,
        n_clad=geom.n_clad,
        wavelength_um=geom.wavelength * s,
        cladding_radius=cls_geom.cladding_radius,
        pml_thickness=cls_geom.pml_thickness,
        pml_strength=geom.pml_strength,
        pml_order=geom.pml_order,
        use_complex_pml=geom.use_complex_pml,
        taper_length_um=(geom.taper_length * s
                         if geom.taper_length else None),
        variant=geom.variant,
    )
    return can, s


def rescale_modes(modes: List[Dict], s: float, k0_phys: float) -> List[Dict]:
    """Map canonical-frame mode dicts back to physical beta/beta_im.

    n_eff, confinement, polarization, PDL, div_ratio and the (grid-
    resident) field DOFs are scale-invariant; only the propagation
    constants carry units of 1/length.
    """
    for m in modes:
        m["beta"] = m["n_eff"] * k0_phys
        if "beta_im" in m:
            m["beta_im"] = float(m["beta_im"]) * s
    return modes


#: past this band width the worst-case member interface
#: ((1+band)**-0.5 * r_class) falls below the 0.90*r inner edge of the
#: class mesh's refinement ring — accuracy degrades beyond the
#: documented band tradeoff
BAND_SAFE_CEILING = 0.90 ** -2 - 1.0  # ~0.2346


def check_band(band: float) -> None:
    """Warn when ``band`` puts member interfaces outside the refined ring."""
    if (1.0 + band) ** -0.5 < 0.90:
        logger.warning(
            "bucket_ratio_band=%.2f puts worst-case member interfaces at "
            "%.3f*r_class, below the 0.90*r refinement-ring floor — "
            "accuracy degrades beyond the documented tradeoff (safe "
            "ceiling ~%.2f)", band, (1.0 + band) ** -0.5, BAND_SAFE_CEILING)


def group_by_bucket(geometries: Sequence[MCFGeometry],
                    band: float = RATIO_BAND
                    ) -> Dict[Hashable, List[int]]:
    """Indices of ``geometries`` grouped by bucket key (stable order)."""
    check_band(band)
    groups: Dict[Hashable, List[int]] = {}
    for i, g in enumerate(geometries):
        groups.setdefault(bucket_key(g, band), []).append(i)
    return groups
