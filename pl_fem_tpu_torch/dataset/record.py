"""Dataset record schema.

Capability parity with the reference's dataset_record.py:29-292 (7
category dataclass: identification + success flags, geometry/material/
taper inputs, SM/MM optics, mode summary, mux & demux losses, CMT
results, quality/perf/timing/mesh stats; validation; dict/JSON/CSV
exports). The reference's ``calculate_performance_index`` is a broken
stub (dataset_record.py:193-200 references undefined weights and
returns nothing); here it is implemented with explicit weights and
normalizations so the field is actually populated.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class DatasetRecord:
    """Complete record of one photonic-lantern simulation."""

    # -- 1. identification & status -----------------------------------------
    sample_id: str
    timestamp: str = field(default_factory=lambda:
                           datetime.now(timezone.utc).isoformat())
    success: bool = False
    success_geometry: bool = False
    success_physics: bool = False
    success_solver: bool = False
    success_losses: bool = False
    error_msg: Optional[str] = None
    warnings: List[str] = field(default_factory=list)

    # -- 2. input parameters -------------------------------------------------
    n_cores: int = 0
    core_radius_um: float = 0.0
    pitch_um: float = 0.0
    arrangement: str = ""
    config_type: str = "default"
    geometry_config: str = "standard"
    n_peripheral_cores: Optional[int] = None
    R_ring: Optional[float] = None
    packing_efficiency: Optional[float] = None

    delta_n_percent: float = 0.0
    wavelength_nm: float = 1550.0
    n_polymer: float = 1.53

    taper_length_mm: float = 0.0
    taper_profile: str = "power"
    taper_exponent: float = 0.8
    L_mux: Optional[float] = None
    L_taper: Optional[float] = None
    L_MMF: Optional[float] = None
    L_total: Optional[float] = None
    n_taper: Optional[float] = None

    # -- 3. SM & MM optics ---------------------------------------------------
    V_number: float = 0.0
    n_core: float = 0.0
    n_clad: float = 0.0
    delta_n: float = 0.0

    r_core_SM: Optional[float] = None
    r_clad_SM: Optional[float] = None
    n_core_SM: Optional[float] = None
    n_clad_SM: Optional[float] = None
    V_SM: Optional[float] = None
    NA_SM: Optional[float] = None
    MFD: Optional[float] = None
    n_eff_LP01: Optional[float] = None

    r_core_MM: Optional[float] = None
    V_MM: Optional[float] = None
    NA_MM: Optional[float] = None
    M_max: Optional[int] = None

    # -- 4. mode results -----------------------------------------------------
    n_modes_found: int = 0
    modes: List[Dict] = field(default_factory=list)
    n_eff_max: float = 0.0
    n_eff_min: float = 0.0
    n_eff_mean: float = 0.0
    confinement_max: float = 0.0
    confinement_min: float = 0.0
    avg_confinement: float = 0.0

    # -- 5. physical losses --------------------------------------------------
    losses_mux: Optional[Dict] = None
    IL_phys_mux_dB: Optional[float] = None
    MDL_phys_mux_dB: Optional[float] = None
    PDL_mux_dB: Optional[float] = None
    crosstalk_mux_dB: Optional[float] = None
    radiation_mux_dB_m: Optional[float] = None

    losses_demux: Optional[Dict] = None
    IL_phys_demux_dB: Optional[float] = None
    MDL_phys_demux_dB: Optional[float] = None
    PDL_demux_dB: Optional[float] = None
    crosstalk_demux_dB: Optional[float] = None
    radiation_demux_dB_m: Optional[float] = None

    # -- 6. CMT --------------------------------------------------------------
    cmt_mux: Optional[Dict] = None
    cmt_demux: Optional[Dict] = None
    IL_CMT_mux_dB: Optional[float] = None
    IL_CMT_demux_dB: Optional[float] = None
    power_conservation_mux: Optional[float] = None
    power_conservation_demux: Optional[float] = None

    # -- 7. quality / metadata ----------------------------------------------
    quality_score: Optional[float] = None
    adiabatic_score: Optional[float] = None
    performance_index: Optional[float] = None

    solver_time_s: float = 0.0
    mesh_points: int = 0
    mesh_elements: int = 0
    n_dofs: int = 0

    # solver/accuracy provenance (round-4: bucket-floor records must be
    # distinguishable from per-design solves, docs/PARITY_r3.md §A)
    solver_mode: str = ""          # 'per_design' | 'bucketed_sweep' | ...
    accuracy_class: str = ""       # expected relative n_eff error class
    mesh_quality_ok: bool = True   # MeshQualityAnalyzer gate verdict
    mesh_quality_msg: str = ""

    coupling_uniformity: Optional[float] = None
    coupling_degradation: Optional[float] = None
    crosstalk_penalty: Optional[float] = None

    # ------------------------------------------------------------------
    def validate(self) -> Tuple[bool, List[str]]:
        """Cross-field consistency (dataset_record.py:169-191)."""
        errors: List[str] = []
        if self.success:
            if not all([self.success_geometry, self.success_physics,
                        self.success_solver]):
                errors.append("success=True but a sub-flag is False")
        if self.n_modes_found > 0 and self.modes \
                and len(self.modes) != self.n_modes_found:
            errors.append(f"n_modes_found ({self.n_modes_found}) != "
                          f"len(modes) ({len(self.modes)})")
        if self.n_eff_max <= 0 and self.n_modes_found > 0:
            errors.append("n_modes_found > 0 but n_eff_max <= 0")
        if self.V_number < 0 or self.V_number > 25:
            errors.append(f"V_number out of range: {self.V_number}")
        if self.n_core < self.n_clad:
            errors.append(f"n_core ({self.n_core}) < n_clad ({self.n_clad})")
        if self.IL_phys_mux_dB is not None \
                and not (0 <= self.IL_phys_mux_dB <= 50):
            errors.append(f"IL_phys_mux_dB out of range: "
                          f"{self.IL_phys_mux_dB}")
        return len(errors) == 0, errors

    def calculate_performance_index(self) -> float:
        """Weighted global performance index (lower = better).

        Working implementation of the reference stub
        (dataset_record.py:193-200): each metric is normalized to its
        observed dataset range (README.md:240-250) and combined with
        weights IL 0.40 / MDL 0.25 / PDL 0.15 / XT 0.20.
        """
        w_IL, w_MDL, w_PDL, w_XT = 0.40, 0.25, 0.15, 0.20

        def norm(val, lo, hi):
            if val is None:
                return 1.0
            return float(np.clip((val - lo) / max(hi - lo, 1e-12), 0.0, 2.0))

        IL_norm = norm(self.IL_phys_mux_dB, 0.3, 10.0)
        MDL_norm = norm(self.MDL_phys_mux_dB, 0.0, 8.0)
        PDL_norm = norm(self.PDL_mux_dB, 0.05, 5.0)
        # XT: more negative is better; map [-40, -15] -> [0, 1]
        xt = self.crosstalk_mux_dB
        XT_norm = 1.0 if xt is None else \
            float(np.clip((xt + 40.0) / 25.0, 0.0, 2.0))

        index = (w_IL * IL_norm + w_MDL * MDL_norm + w_PDL * PDL_norm
                 + w_XT * XT_norm)
        return float(index)

    # ------------------------------------------------------------------
    def to_dict(self, include_modes: bool = False) -> Dict[str, Any]:
        data = asdict(self)
        if not include_modes:
            for key in ("modes", "cmt_mux", "cmt_demux", "losses_mux",
                        "losses_demux"):
                data.pop(key, None)
        for k, v in data.items():
            if isinstance(v, (np.integer, np.floating)):
                data[k] = float(v)
            elif isinstance(v, np.ndarray):
                data[k] = v.tolist()
        return data

    def to_json(self, filepath, include_modes: bool = False):
        with open(Path(filepath), "w") as f:
            json.dump(self.to_dict(include_modes), f, indent=2)

    def to_csv_row(self) -> Dict[str, Any]:
        """Flat export row (dataset_record.py:221-267 column set)."""
        return {
            "sample_id": self.sample_id,
            "timestamp": self.timestamp,
            "success": self.success,
            "n_cores": self.n_cores,
            "core_radius_um": self.core_radius_um,
            "pitch_um": self.pitch_um,
            "delta_n_percent": self.delta_n_percent,
            "wavelength_nm": self.wavelength_nm,
            "taper_length_mm": self.taper_length_mm,
            "V_number": self.V_number,
            "n_modes_found": self.n_modes_found,
            "n_eff_max": self.n_eff_max,
            "avg_confinement": self.avg_confinement,
            "IL_phys_mux_dB": self.IL_phys_mux_dB,
            "MDL_phys_mux_dB": self.MDL_phys_mux_dB,
            "PDL_mux_dB": self.PDL_mux_dB,
            "crosstalk_mux_dB": self.crosstalk_mux_dB,
            "radiation_mux_dB_m": self.radiation_mux_dB_m,
            "IL_phys_demux_dB": self.IL_phys_demux_dB,
            "MDL_phys_demux_dB": self.MDL_phys_demux_dB,
            "PDL_demux_dB": self.PDL_demux_dB,
            "IL_CMT_mux_dB": self.IL_CMT_mux_dB,
            "IL_CMT_demux_dB": self.IL_CMT_demux_dB,
            "quality_score": self.quality_score,
            "performance_index": self.performance_index,
            "solver_time_s": self.solver_time_s,
            "config_type": self.config_type,
            "geometry_config": self.geometry_config,
            "n_peripheral_cores": self.n_peripheral_cores,
            "R_ring": self.R_ring,
            "packing_efficiency": self.packing_efficiency,
            "r_core_SM": self.r_core_SM,
            "V_SM": self.V_SM,
            "NA_SM": self.NA_SM,
            "MFD": self.MFD,
            "r_core_MM": self.r_core_MM,
            "V_MM": self.V_MM,
            "NA_MM": self.NA_MM,
            "M_max": self.M_max,
            "coupling_uniformity": self.coupling_uniformity,
            "crosstalk_penalty": self.crosstalk_penalty,
            "coupling_degradation": self.coupling_degradation,
        }

    def summary_string(self) -> str:
        status = "OK " if self.success else "FAIL"
        il = self.IL_phys_mux_dB
        mdl = self.MDL_phys_mux_dB
        lines = [
            f"[{status}] {self.sample_id} | {self.n_cores} cores | "
            f"lambda={self.wavelength_nm} nm",
            f"  V={self.V_number:.2f} | modes={self.n_modes_found} | "
            f"n_eff_max={self.n_eff_max:.4f}",
            f"  conf avg={self.avg_confinement:.3f} | "
            f"IL_mux={il if il is None else f'{il:.2f}'}dB | "
            f"MDL={mdl if mdl is None else f'{mdl:.2f}'}dB",
        ]
        if self.quality_score is not None:
            perf = self.performance_index
            lines.append(f"  quality={self.quality_score:.3f} | "
                         f"perf={perf if perf is None else f'{perf:.2f}'}")
        if self.error_msg:
            lines.append(f"  error: {self.error_msg}")
        return "\n".join(lines)

    @classmethod
    def from_dict(cls, data: Dict) -> "DatasetRecord":
        valid_keys = {f.name for f in cls.__dataclass_fields__.values()}
        return cls(**{k: v for k, v in data.items() if k in valid_keys})

    @classmethod
    def from_json(cls, filepath) -> "DatasetRecord":
        with open(Path(filepath)) as f:
            return cls.from_dict(json.load(f))
