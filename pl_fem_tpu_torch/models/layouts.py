"""Multicore-fiber core-layout catalog.

Twelve experimentally demonstrated MCF layouts (N = 1, 2, 3, 4, 5, 6(x2),
7, 8, 9, 12, 13, 19), each returning core centre positions plus layout
metadata. Capability parity with the reference's geometry_mcf.py:41-173
(same published constructions: ring/hex/1+6/1+6+12 etc.), implemented as
a registry of small builders emitting fixed-shape (N, 2) float64 arrays.

Primary literature for each layout is listed in LAYOUTS[...].ref.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LayoutInfo:
    """Metadata describing one catalog entry."""

    n_cores: int
    config_type: str
    has_central_core: bool
    n_peripheral: int
    ring_radius_factor: float  # R_ring = factor * pitch
    label: str
    ref: str
    standard: bool = True
    variant: Optional[str] = None


def _ring(n: int, radius: float, phase_deg: float = 0.0) -> np.ndarray:
    ang = np.deg2rad(phase_deg) + 2.0 * np.pi * np.arange(n) / n
    return radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)


def _center() -> np.ndarray:
    return np.zeros((1, 2))


# Each builder: pitch -> (N,2) positions. ring_radius_factor gives R_ring/pitch.
_BUILDERS: Dict[Tuple[int, Optional[str]], Tuple[Callable, LayoutInfo]] = {}


def _register(key, builder, info):
    _BUILDERS[key] = (builder, info)


_register((1, None), lambda p: _center(),
          LayoutInfo(1, "single_1", True, 0, 0.0, "Single-core", "baseline",
                     standard=False))
_register((2, None), lambda p: np.array([[-p / 2, 0.0], [p / 2, 0.0]]),
          LayoutInfo(2, "linear_2", False, 2, 0.5, "Dual-core linear",
                     "Kokubun & Koshiba, IEICE Electron. Express 6, 522 (2009)"))
_register((3, None), lambda p: _ring(3, p, 90.0),
          LayoutInfo(3, "triangular_3", False, 3, 1.0, "3-core triangle",
                     "Fontaine et al., Opt. Express 20, 2662 (2012)"))
_register((4, None),
          lambda p: (p / 2) * np.array([[-1., -1.], [1., -1.], [-1., 1.], [1., 1.]]),
          LayoutInfo(4, "square_2x2_4", False, 4, np.sqrt(2) / 2, "4-core 2x2 square",
                     "Hayashi et al., Opt. Express 19, 16576 (2011)"))
_register((5, None), lambda p: _ring(5, p, 90.0),
          LayoutInfo(5, "pentagonal_ring_5", False, 5, 1.0, "5-core pentagon",
                     "Jinno et al., OFC 2020 M3F.3"))
_register((6, "ring"), lambda p: _ring(6, p, 0.0),
          LayoutInfo(6, "hexagonal_ring_6", False, 6, 1.0, "6-core hex ring",
                     "Zhu et al., Opt. Lett. 36, 3999 (2011)", variant="ring"))
_register((6, "pentagon_center"),
          lambda p: np.vstack([_center(), _ring(5, p, 90.0)]),
          LayoutInfo(6, "pentagon_center_6", True, 5, 1.0, "6-core 1+5",
                     "Stern et al., Optica 8, 1119 (2021)",
                     variant="pentagon_center"))
_register((7, None), lambda p: np.vstack([_center(), _ring(6, p, 0.0)]),
          LayoutInfo(7, "hexagonal_1plus6_7", True, 6, 1.0, "7-core hex 1+6",
                     "Carpenter et al., Nat. Photon. 9, 751 (2015); "
                     "Dana et al., Light Sci. Appl. 13, 116 (2024)"))
_register((8, None), lambda p: np.vstack([_center(), _ring(7, p, 0.0)]),
          LayoutInfo(8, "heptagonal_center_8", True, 7, 1.0, "8-core 1+7",
                     "Hayashi et al., OFC 2015 Th5C.6"))


def _grid3x3(p: float) -> np.ndarray:
    c = np.array([-p, 0.0, p])
    return np.array([[x, y] for y in c for x in c])


_register((9, None), _grid3x3,
          LayoutInfo(9, "square_3x3_9", True, 8, np.sqrt(2), "9-core 3x3 grid",
                     "Igarashi et al., Opt. Express 22, 1220 (2014)"))
_register((12, None),
          lambda p: np.vstack([_ring(6, p, 0.0), _ring(6, p * np.sqrt(3), 30.0)]),
          LayoutInfo(12, "hex_double_ring_12", False, 12, np.sqrt(3),
                     "12-core hex 6+6",
                     "Takenaga/Ishida et al., OFC 2014 W4D.3"))
_register((13, None),
          lambda p: np.vstack([_center(), _ring(6, p, 0.0),
                               _ring(6, p * np.sqrt(3), 30.0)]),
          LayoutInfo(13, "hex_1plus6plus6_13", True, 12, np.sqrt(3),
                     "13-core hex 1+6+6", "Takenaga et al., OFC 2011"))
_register((19, None),
          lambda p: np.vstack([_center(), _ring(6, p, 0.0), _ring(6, 2 * p, 0.0),
                               _ring(6, p * np.sqrt(3), 30.0)]),
          LayoutInfo(19, "hex_1plus6plus12_19", True, 18, 2.0,
                     "19-core hex 1+6+12",
                     "Mizuno et al., Nat. Photon. 10, 591 (2016)"))


SUPPORTED_N_CORES: List[int] = sorted({k[0] for k in _BUILDERS})

SUPPORTED_CONFIGS: Dict[int, Dict] = {
    n: {
        "label": _BUILDERS[(n, "ring" if n == 6 else None)][1].label,
        "standard": _BUILDERS[(n, "ring" if n == 6 else None)][1].standard,
        "refs": _BUILDERS[(n, "ring" if n == 6 else None)][1].ref,
        **({"variants": {"ring": "6-core hex ring",
                         "pentagon_center": "1 centre + 5 pentagon"}}
           if n == 6 else {}),
    }
    for n in SUPPORTED_N_CORES
}

# Relative frequency of each core count in the SDM/PL literature
# (sampling prior, parity with geometry_mcf.py:201-213).
SAMPLING_WEIGHTS: Dict[int, float] = {
    2: 0.04, 3: 0.11, 4: 0.13, 5: 0.05, 6: 0.10,
    7: 0.30, 8: 0.05, 9: 0.08, 12: 0.07, 13: 0.07, 19: 0.10,
}


def generate_core_positions(
    n_cores: int, pitch: float, variant: Optional[str] = None
) -> Tuple[np.ndarray, str, bool, int, float]:
    """Return (positions, config_type, has_central_core, n_peripheral, R_ring).

    ``pitch`` is the nearest-neighbour spacing in micrometres; for the
    centred layouts it is the centre-to-ring distance.
    """
    n_cores = int(n_cores)
    key = (n_cores, variant if n_cores == 6 else None)
    if n_cores == 6 and variant not in ("pentagon_center",):
        key = (6, "ring")
    if key not in _BUILDERS:
        raise ValueError(
            f"n_cores={n_cores} unsupported; valid: {SUPPORTED_N_CORES}")
    builder, info = _BUILDERS[key]
    pos = np.asarray(builder(float(pitch)), dtype=np.float64)
    return (pos, info.config_type, info.has_central_core, info.n_peripheral,
            info.ring_radius_factor * float(pitch))


def layout_info(n_cores: int, variant: Optional[str] = None) -> LayoutInfo:
    key = (int(n_cores), variant if int(n_cores) == 6 else None)
    if key not in _BUILDERS:
        key = (int(n_cores), "ring" if int(n_cores) == 6 else None)
    return _BUILDERS[key][1]


def get_n_cores_options(exclude_single: bool = True, max_cores: int = 19) -> List[int]:
    return [n for n in SUPPORTED_N_CORES
            if n <= max_cores and (n > 1 or not exclude_single)]


def get_sampling_weights(n_cores_list: List[int]) -> List[float]:
    w = np.array([SAMPLING_WEIGHTS.get(n, 0.01) for n in n_cores_list], float)
    return (w / w.sum()).tolist()


def build_geometry_from_sample(sample: Dict, use_pml: bool = True) -> Dict:
    """Derive layout metrics from a sampled design point.

    Same output keys as the reference helper (geometry_mcf.py:226-263):
    n_cores/positions/config_type/has_central_core/n_peripheral_cores/
    R_ring/pitch_min/pitch_ratio/packing_efficiency/geometry_config.
    """
    n_cores = int(sample["n_cores"])
    pitch = float(sample["pitch_um"])
    r_core = float(sample["core_radius_um"])
    variant = sample.get("variant", None)

    pos, config_type, has_central, n_peri, r_ring = generate_core_positions(
        n_cores, pitch, variant=variant)

    if n_cores > 1:
        d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
        pitch_min = float(d[np.triu_indices(n_cores, 1)].min())
        max_dist = float(np.linalg.norm(pos, axis=1).max())
        area_total = np.pi * (max_dist + r_core) ** 2
    else:
        pitch_min = 0.0
        area_total = np.pi * r_core**2

    area_cores = n_cores * np.pi * r_core**2
    return {
        "n_cores": n_cores,
        "positions": pos,
        "config_type": config_type,
        "has_central_core": has_central,
        "n_peripheral_cores": n_peri,
        "R_ring": float(r_ring),
        "pitch_min": pitch_min,
        "pitch_ratio": pitch / (2.0 * r_core) if r_core > 0 else 0.0,
        "packing_efficiency": float(area_cores / area_total) if area_total > 0 else 0.0,
        "geometry_config": SUPPORTED_CONFIGS.get(n_cores, {}).get(
            "label", f"{n_cores}-core"),
    }
