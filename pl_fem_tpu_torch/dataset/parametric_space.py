"""Parametric design space, physical validator and quality scorer.

The reference imports ``ParametricSpace``, ``PhysicalValidator`` and
``SampleQualityScorer`` from a ``parametric_space`` module missing from
its snapshot (sampling.py:27). This reconstruction is driven by the
consuming call sites:

- continuous bounds / discrete options: sampling.py:154-189 and the CLI
  draw ranges (main.py:327-340: r in [0.9, 1.6] um, pitch in [4.5, 12]
  um, delta_n_percent in [0.8, 2.5], wavelengths {1530..1610} nm);
- refractive model: n_core = 1.53 + (delta_n% - 1)/100 over air cladding
  (main.py:51-54, 82);
- physics gates: V in [2.4, 10] (main.py:53-54), core-overlap rule
  d >= 0.85 (r_i + r_j) (geometry_unified.py:358-362);
- quality dimensions: packing window [0.5, 0.85] and pitch_ratio ~ 3.5
  (losses.py:404-415), guided-mode margin.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models import layouts

POLYMER_N = 1.53
AIR_N = 1.0
V_MIN = 2.4
V_MAX = 10.0


def sample_refractive_indices(sample: Dict) -> Tuple[float, float]:
    """(n_core, n_clad) from a sample dict (main.py:82 model)."""
    if "n_core" in sample:
        n_core = float(sample["n_core"])
    else:
        n_core = POLYMER_N + (float(sample.get("delta_n_percent", 1.0))
                              - 1.0) / 100.0
    return n_core, float(sample.get("n_clad", AIR_N))


class ParametricSpace:
    """Design-space definition consumed by the samplers."""

    CONTINUOUS_BOUNDS: Dict[str, Tuple[float, float]] = {
        "core_radius_um": (0.9, 1.6),
        "pitch_um": (4.5, 12.0),
        "delta_n_percent": (0.8, 2.5),
        "taper_length_mm": (0.15, 1.0),
    }

    DISCRETE_OPTIONS: Dict[str, List] = {
        "wavelength_nm": [1530, 1550, 1570, 1590, 1610],
        "taper_profile": ["linear", "power", "sinusoidal", "exponential"],
        "arrangement": ["default", "ring", "pentagon_center"],
    }

    def __init__(self, n_cores_options: Optional[List[int]] = None,
                 continuous_bounds: Optional[Dict] = None,
                 discrete_options: Optional[Dict] = None):
        self.n_cores_options = list(
            n_cores_options if n_cores_options is not None
            else layouts.get_n_cores_options())
        self._continuous = dict(continuous_bounds or self.CONTINUOUS_BOUNDS)
        self._discrete = dict(discrete_options or self.DISCRETE_OPTIONS)

    # -- interface used by sampling.py:154-155 ------------------------------
    def get_continuous_bounds(self) -> Dict[str, Tuple[float, float]]:
        return dict(self._continuous)

    def get_discrete_options(self) -> Dict[str, List]:
        return dict(self._discrete)

    def get_sampling_weights(self) -> List[float]:
        return layouts.get_sampling_weights(self.n_cores_options)

    # -- geometric validation (sampling.py:193) -----------------------------
    def validate_sample_geometry(self, sample: Dict) -> Tuple[bool, str]:
        n_cores = int(sample.get("n_cores", 0))
        if n_cores not in layouts.SUPPORTED_N_CORES:
            return False, f"unsupported n_cores={n_cores}"
        r = float(sample.get("core_radius_um", 0.0))
        pitch = float(sample.get("pitch_um", 0.0))
        if r <= 0 or pitch <= 0:
            return False, "non-positive core radius or pitch"
        variant = None
        if n_cores == 6 and sample.get("arrangement") in ("ring",
                                                          "pentagon_center"):
            variant = sample["arrangement"]
        try:
            positions, *_ = layouts.generate_core_positions(
                n_cores, pitch, variant)
        except ValueError as e:
            return False, str(e)
        if n_cores > 1:
            d = np.linalg.norm(positions[:, None] - positions[None, :],
                               axis=-1)
            dmin = d[np.triu_indices(n_cores, 1)].min()
            # overlap rule (geometry_unified.py:358-362)
            if dmin < 2.0 * r * 0.85:
                return False, (f"cores overlap: min dist {dmin:.2f} um < "
                               f"0.85 * 2r = {1.7 * r:.2f} um")
        return True, "OK"


class PhysicalValidator:
    """Physics gates on a candidate sample (sampling.py:200 seam)."""

    def validate_sample_physics(self, sample: Dict
                                ) -> Tuple[bool, str, Dict]:
        n_core, n_clad = sample_refractive_indices(sample)
        wl_um = float(sample.get("wavelength_nm", 1550.0)) / 1000.0
        k0 = 2.0 * np.pi / wl_um
        r = float(sample["core_radius_um"])
        NA2 = n_core**2 - n_clad**2
        if not np.isfinite([n_core, n_clad, wl_um, r]).all():
            # reject non-finite inputs explicitly: NaN fails every
            # comparison below, so without this a NaN design would
            # crash on int(NaN) instead of skip-and-record
            return False, "non-finite sample parameters", {}
        if NA2 <= 0:
            return False, "n_core <= n_clad", {}
        NA = float(np.sqrt(NA2))
        V = k0 * r * NA
        metrics = {
            "V_number": float(V),
            "NA": NA,
            "n_core": n_core,
            "n_clad": n_clad,
            "n_modes_est": max(1, int(V**2 / 4)),
        }
        if V < V_MIN:
            return False, f"V={V:.2f} < {V_MIN} (below guidance)", metrics
        if V > V_MAX:
            return False, f"V={V:.2f} > {V_MAX} (too multimode)", metrics
        # pitch ratio sanity: cores neither fused nor decoupled
        pitch_ratio = float(sample["pitch_um"]) / (2.0 * r)
        metrics["pitch_ratio"] = pitch_ratio
        if pitch_ratio > 8.0:
            return False, f"pitch_ratio={pitch_ratio:.1f} too large", metrics
        return True, "OK", metrics


class SampleQualityScorer:
    """Scalar quality score in [0, 1] (sampling.py:206 seam).

    Dimensions mirror the dataset's own quality notions: V centered in
    the guided band, packing in the [0.5, 0.85] window and pitch_ratio
    near 3.5 (losses.py:404-415 penalties), plus a mild mode-count
    reward.
    """

    def score_sample(self, sample: Dict, metrics: Dict) -> float:
        V = float(metrics.get("V_number", 0.0))
        v_mid = 0.5 * (V_MIN + V_MAX)
        v_score = max(0.0, 1.0 - abs(V - v_mid) / (V_MAX - v_mid))

        n_cores = int(sample["n_cores"])
        r = float(sample["core_radius_um"])
        pitch = float(sample["pitch_um"])
        variant = sample.get("arrangement") if n_cores == 6 else None
        try:
            positions, *_ = layouts.generate_core_positions(
                n_cores, pitch,
                variant if variant in ("ring", "pentagon_center") else None)
            max_r = (float(np.linalg.norm(positions, axis=1).max())
                     if n_cores > 1 else 0.0)
            packing = n_cores * np.pi * r**2 / (np.pi * (max_r + r) ** 2) \
                if (max_r + r) > 0 else 0.0
        except ValueError:
            packing = 0.0
        if packing < 0.5:
            p_score = max(0.0, 1.0 - (0.5 - packing) * 3.0)
        elif packing > 0.85:
            p_score = max(0.0, 1.0 - (packing - 0.85) * 2.0)
        else:
            p_score = 1.0

        pitch_ratio = float(metrics.get("pitch_ratio",
                                        pitch / (2.0 * r + 1e-12)))
        pr_score = max(0.0, 1.0 - abs(pitch_ratio - 3.5) / 4.5)

        m_est = float(metrics.get("n_modes_est", 1))
        m_score = min(1.0, np.log1p(m_est) / np.log1p(25.0))

        return float(np.clip(
            0.35 * v_score + 0.30 * p_score + 0.20 * pr_score
            + 0.15 * m_score, 0.0, 1.0))
