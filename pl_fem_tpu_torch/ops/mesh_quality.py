"""Mesh quality metrics and validation gates.

Vectorized per-element metrics (aspect ratio, equilateral quality
4*sqrt(3)*A/sum(l^2), minimum angle) with the same acceptance gates as the
reference analyzer (the reference's mesh.py:419-569).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class MeshQualityAnalyzer:
    @staticmethod
    def analyze(mesh) -> Dict:
        p, t = mesh.points, mesh.tris
        v1 = p[t[:, 1]] - p[t[:, 0]]
        v2 = p[t[:, 2]] - p[t[:, 0]]
        areas = 0.5 * np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])

        edges = np.stack([p[t[:, (i + 1) % 3]] - p[t[:, i]] for i in range(3)])
        lens = np.linalg.norm(edges, axis=2)  # (3, T)

        aspect = lens.max(axis=0) / (lens.min(axis=0) + 1e-12)
        quality = 4 * np.sqrt(3) * areas / ((lens**2).sum(axis=0) + 1e-12)

        cosa = []
        for i in range(3):
            a2 = lens[(i + 1) % 3] ** 2
            b2 = lens[(i + 2) % 3] ** 2
            c2 = lens[i] ** 2
            cosa.append((a2 + b2 - c2) / (2 * np.sqrt(a2 * b2) + 1e-12))
        min_angle = np.degrees(np.arccos(np.clip(np.max(cosa, axis=0), -1, 1)))

        return {
            "n_points": p.shape[0],
            "n_elements": t.shape[0],
            "area_min": float(areas.min()),
            "area_max": float(areas.max()),
            "area_mean": float(areas.mean()),
            "aspect_min": float(aspect.min()),
            "aspect_max": float(aspect.max()),
            "aspect_mean": float(aspect.mean()),
            "quality_min": float(quality.min()),
            "quality_max": float(quality.max()),
            "quality_mean": float(quality.mean()),
            "min_angle_min": float(min_angle.min()),
            "min_angle_mean": float(min_angle.mean()),
            "poor_quality_frac": float((quality < 0.35).mean()),
            "bad_aspect_frac": float((aspect > 8.0).mean()),
            "small_angle_frac": float((min_angle < 20.0).mean()),
        }

    @staticmethod
    def print_analysis(mesh, log=None) -> Dict:
        """Human-readable quality report (the reference's mesh.py:498-524).

        Emits via ``log`` (default: module print) and returns the metric
        dict so callers can reuse the numbers.
        """
        m = MeshQualityAnalyzer.analyze(mesh)
        emit = log or print
        emit("=== mesh quality ===")
        emit(f"points: {m['n_points']}  elements: {m['n_elements']}")
        emit(f"area      min/mean/max: {m['area_min']:.3e} / "
             f"{m['area_mean']:.3e} / {m['area_max']:.3e} um^2")
        emit(f"aspect    min/mean/max: {m['aspect_min']:.2f} / "
             f"{m['aspect_mean']:.2f} / {m['aspect_max']:.2f}")
        emit(f"quality   min/mean/max: {m['quality_min']:.3f} / "
             f"{m['quality_mean']:.3f} / {m['quality_max']:.3f}")
        emit(f"min angle min/mean: {m['min_angle_min']:.1f} / "
             f"{m['min_angle_mean']:.1f} deg")
        emit(f"poor quality (<0.35): {m['poor_quality_frac'] * 100:.1f}%  "
             f"bad aspect (>8): {m['bad_aspect_frac'] * 100:.1f}%  "
             f"small angle (<20 deg): {m['small_angle_frac'] * 100:.1f}%")
        ok, msg = MeshQualityAnalyzer.validate_mesh_quality(mesh)
        emit(f"verdict: {'OK' if ok else 'FAIL'} - {msg}")
        return m

    @staticmethod
    def validate_mesh_quality(mesh, strict: bool = False) -> Tuple[bool, str]:
        m = MeshQualityAnalyzer.analyze(mesh)
        if not m:
            return False, "invalid mesh"
        issues = []
        if m["min_angle_min"] < 10.0:
            issues.append(f"critical min angle {m['min_angle_min']:.1f} < 10 deg")
        if m["aspect_max"] > 20.0:
            issues.append(f"excessive aspect ratio {m['aspect_max']:.1f} > 20")
        if m["poor_quality_frac"] > 0.2:
            issues.append(
                f"too many poor elements {m['poor_quality_frac'] * 100:.0f}%")
        if strict:
            if m["min_angle_min"] < 20.0:
                issues.append(f"[strict] min angle {m['min_angle_min']:.1f}")
            if m["aspect_mean"] > 3.0:
                issues.append(f"[strict] mean aspect {m['aspect_mean']:.1f}")
            if m["quality_mean"] < 0.7:
                issues.append(f"[strict] mean quality {m['quality_mean']:.2f}")
        if issues:
            return False, "; ".join(issues)
        return True, "mesh quality acceptable"
