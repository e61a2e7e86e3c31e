"""Smart / adaptive design-space samplers.

Capability parity with the reference's sampling.py (SmartSampler
sampling.py:34-371, AdaptiveSampler sampling.py:374-560): stratified
per-architecture scrambled LHS with deterministic seeds, geometric +
physical validation, quality scoring with oversampling, greedy
diversity filtering, gaussian focused sampling, and the
exploit/explore adaptive loop with convergence metrics.

Deliberate fix vs the reference: seeds derive from ``zlib.crc32``
instead of Python's process-salted ``hash()`` (sampling.py:161, 314),
so identical (base_seed, n_cores, n_target) produce identical samples
across processes and machines — the determinism the reference's
docstring promises but its implementation doesn't deliver.
"""
from __future__ import annotations

import logging
import zlib
from typing import Dict, List, Optional

import numpy as np
from scipy.spatial.distance import pdist, squareform
from scipy.stats import qmc

from ..config import SimulationConfig
from .parametric_space import (
    ParametricSpace,
    PhysicalValidator,
    SampleQualityScorer,
)

logger = logging.getLogger("pl_fem_tpu_torch.dataset.sampling")


def _stable_seed(*parts) -> int:
    return zlib.crc32("_".join(str(p) for p in parts).encode()) % (2**31)


class SmartSampler:
    """Stratified LHS sampler with validation, scoring and diversity."""

    def __init__(self, space: ParametricSpace,
                 config: Optional[SimulationConfig] = None,
                 base_seed: int = 42):
        self.space = space
        self.config = config or SimulationConfig()
        self.validator = PhysicalValidator()
        self.scorer = SampleQualityScorer()
        self.base_seed = base_seed
        self.rng = np.random.default_rng(base_seed)
        self.total_generated = 0
        self.total_valid = 0
        self.generation_history: List[Dict] = []

    # ------------------------------------------------------------------
    def generate_stratified_samples(self, n_samples: int,
                                    apply_filter: bool = True,
                                    quality_threshold: float = 0.35,
                                    oversample_factor: float = 3.0,
                                    ensure_diversity: bool = True,
                                    min_distance: float = 0.05) -> List[Dict]:
        n_cores_options = self.space.n_cores_options
        if not n_cores_options:
            raise ValueError("ParametricSpace.n_cores_options is empty")

        per_arch = max(1, n_samples // len(n_cores_options))
        samples: List[Dict] = []
        for n_cores in n_cores_options:
            samples.extend(self._lhs_for_architecture(
                n_cores, per_arch, apply_filter, quality_threshold,
                oversample_factor))

        remaining = n_samples - len(samples)
        if remaining > 0:
            extra_arch = int(self.rng.choice(n_cores_options))
            samples.extend(self._lhs_for_architecture(
                extra_arch, remaining, apply_filter, quality_threshold,
                oversample_factor))

        if ensure_diversity and len(samples) > 1:
            samples = self._ensure_diversity(samples, min_distance)
        samples = samples[:n_samples]

        self.total_generated += int(n_samples * oversample_factor)
        self.total_valid += len(samples)
        logger.info("stratified: %d/%d validated", len(samples), n_samples)
        return samples

    # ------------------------------------------------------------------
    def _lhs_for_architecture(self, n_cores: int, n_target: int,
                              apply_filter: bool, quality_threshold: float,
                              oversample_factor: float) -> List[Dict]:
        bounds = self.space.get_continuous_bounds()
        discrete = self.space.get_discrete_options()
        n_gen = max(int(n_target * oversample_factor)
                    if apply_filter else n_target, 1)

        seed = _stable_seed(self.base_seed, n_cores, n_target)
        sampler = qmc.LatinHypercube(d=len(bounds), scramble=True, seed=seed)
        lhs_raw = sampler.random(n=n_gen)
        names = list(bounds.keys())
        lower = np.array([bounds[n][0] for n in names])
        upper = np.array([bounds[n][1] for n in names])
        scaled = qmc.scale(lhs_raw, lower, upper)

        candidates: List[Dict] = []
        rejected = {"geom": 0, "phys": 0, "quality": 0}
        for idx, row in enumerate(scaled):
            sample = {names[i]: float(row[i]) for i in range(len(names))}
            local_rng = np.random.default_rng(seed + idx)
            sample["n_cores"] = n_cores
            sample["wavelength_nm"] = int(
                local_rng.choice(discrete["wavelength_nm"]))
            sample["taper_profile"] = str(
                local_rng.choice(discrete["taper_profile"]))
            sample["arrangement"] = str(
                local_rng.choice(discrete["arrangement"]))
            # Globally unique id: the per-call LHS seed disambiguates the
            # remainder top-up batch (same n_cores, different n_target)
            # from the main batch, and the raw LHS row index is unique
            # within a call — reused counter values would collide with
            # DatasetGenerator's resume dedup and silently drop designs.
            sample["sample_id"] = f"S_{n_cores}C_{seed:08x}_{idx:04d}"

            ok_geom, _ = self.space.validate_sample_geometry(sample)
            if not ok_geom:
                rejected["geom"] += 1
                continue
            if apply_filter:
                ok_phys, _, metrics = \
                    self.validator.validate_sample_physics(sample)
                if not ok_phys:
                    rejected["phys"] += 1
                    continue
                score = self.scorer.score_sample(sample, metrics)
                if score < quality_threshold:
                    rejected["quality"] += 1
                    continue
                sample.update(metrics)
                sample["quality_score"] = score
            candidates.append(sample)
            if not apply_filter and len(candidates) >= n_target:
                break

        logger.debug("%d-cores: %d/%d ok (rejects %s)", n_cores,
                     len(candidates), n_gen, rejected)
        if apply_filter and candidates:
            candidates.sort(key=lambda s: s.get("quality_score", 0.0),
                            reverse=True)
        return candidates[:n_target]

    # ------------------------------------------------------------------
    def _ensure_diversity(self, samples: List[Dict],
                          min_distance: float) -> List[Dict]:
        """Greedy keep-if-far filter on normalized coordinates."""
        if len(samples) < 2:
            return samples
        bounds = self.space.get_continuous_bounds()
        names = list(bounds.keys())
        X = np.array([[(s.get(n, bounds[n][0]) - bounds[n][0])
                       / (bounds[n][1] - bounds[n][0] + 1e-12)
                       for n in names] for s in samples])
        dists = squareform(pdist(X, metric="euclidean"))
        selected = [0]
        for i in range(1, len(samples)):
            if np.min(dists[i, selected]) >= min_distance:
                selected.append(i)
        if len(selected) < len(samples):
            logger.info("diversity filter: kept %d/%d", len(selected),
                        len(samples))
        return [samples[i] for i in selected]

    # ------------------------------------------------------------------
    def generate_focused_samples(self, reference: Dict, n_samples: int,
                                 rel_variation: float = 0.15,
                                 min_distance: Optional[float] = 0.02
                                 ) -> List[Dict]:
        """Gaussian perturbations around a reference design."""
        bounds = self.space.get_continuous_bounds()
        ref_seed = _stable_seed(self.base_seed,
                                *sorted(f"{k}={v}" for k, v in
                                        reference.items()
                                        if isinstance(v, (int, float, str))))
        local_rng = np.random.default_rng(ref_seed)
        samples: List[Dict] = []
        for i in range(n_samples * 3):
            sample = reference.copy()
            for name, (lo, hi) in bounds.items():
                if name in sample:
                    sigma = rel_variation * (hi - lo) / 3.0
                    sample[name] = float(np.clip(
                        local_rng.normal(sample[name], sigma), lo, hi))
            sample["sample_id"] = \
                f"FOCUS_{i:04d}_{reference.get('sample_id', 'REF')}"
            ok, _ = self.space.validate_sample_geometry(sample)
            if not ok:
                continue
            if min_distance and samples:
                if min(self._sample_distance(sample, s)
                       for s in samples) < min_distance:
                    continue
            samples.append(sample)
            if len(samples) >= n_samples:
                break
        return samples[:n_samples]

    def _sample_distance(self, s1: Dict, s2: Dict) -> float:
        bounds = self.space.get_continuous_bounds()
        diffs = [(s1[n] - s2[n]) / (hi - lo)
                 for n, (lo, hi) in bounds.items()
                 if n in s1 and n in s2 and hi > lo]
        return float(np.sqrt(np.mean(np.square(diffs)))) if diffs else 0.0

    def get_sampling_stats(self) -> Dict:
        return {
            "total_generated": self.total_generated,
            "total_valid": self.total_valid,
            "validation_rate": self.total_valid / max(self.total_generated, 1),
            "base_seed": self.base_seed,
            "n_calls": len(self.generation_history),
        }


class AdaptiveSampler:
    """Exploit/explore refinement loop (sampling.py:374-560)."""

    def __init__(self, space: ParametricSpace, base_seed: int = 42):
        self.space = space
        self.base_sampler = SmartSampler(space, base_seed=base_seed)
        self.successful: List[Dict] = []
        self.failed: List[Dict] = []
        self.iteration = 0

    def update_from_results(self, samples: List[Dict],
                            successes: List[bool],
                            metrics: Optional[List[Dict]] = None):
        if len(samples) != len(successes):
            raise ValueError("samples and successes length mismatch")
        for i, (s, ok) in enumerate(zip(samples, successes)):
            enriched = {**s, **(metrics[i] if metrics and i < len(metrics)
                                else {})}
            enriched["success"] = ok
            enriched["iteration"] = self.iteration
            (self.successful if ok else self.failed).append(enriched)
        self.iteration += 1

    def generate_adaptive_samples(self, n_samples: int,
                                  focus_ratio: float = 0.7,
                                  variation: float = 0.15,
                                  diversity_threshold: float = 0.05
                                  ) -> List[Dict]:
        if not self.successful:
            return self.base_sampler.generate_stratified_samples(n_samples)

        n_focus = int(focus_ratio * n_samples)
        n_explore = n_samples - n_focus
        samples: List[Dict] = []

        if n_focus > 0:
            if "quality_score" in self.successful[0]:
                scores = np.array([s.get("quality_score", 0.5)
                                   for s in self.successful])
                scores = scores / (scores.sum() + 1e-12)
            else:
                scores = np.full(len(self.successful),
                                 1.0 / len(self.successful))
            for _ in range(n_focus):
                idx = self.base_sampler.rng.choice(len(self.successful),
                                                   p=scores)
                samples.extend(self.base_sampler.generate_focused_samples(
                    self.successful[idx], 1, rel_variation=variation,
                    min_distance=None))

        if n_explore > 0:
            samples.extend(self.base_sampler.generate_stratified_samples(
                n_explore, apply_filter=True, quality_threshold=0.3))

        if diversity_threshold > 0:
            samples = self.base_sampler._ensure_diversity(
                samples, diversity_threshold)
        return samples[:n_samples]

    def get_convergence_metrics(self) -> Dict:
        if not self.successful:
            return {"converged": False, "reason": "no successes"}
        history = []
        pool = self.successful + self.failed
        for it in range(self.iteration + 1):
            it_samples = [s for s in pool if s.get("iteration", 0) == it]
            if it_samples:
                history.append(
                    sum(1 for s in it_samples if s.get("success", False))
                    / len(it_samples))
        converged = False
        if len(history) >= 3:
            last3 = history[-3:]
            converged = np.var(last3) < 0.01 and np.mean(last3) > 0.5
        return {
            "converged": converged,
            "iteration": self.iteration,
            "n_successful": len(self.successful),
            "n_failed": len(self.failed),
            "success_rate_history": history,
            "current_success_rate": history[-1] if history else 0.0,
            "best_success_rate": max(history) if history else 0.0,
        }

    def get_best_samples(self, n: int = 10,
                         metric: str = "quality_score") -> List[Dict]:
        if not self.successful:
            return []
        valid = [s for s in self.successful if metric in s]
        if not valid:
            return self.successful[:n]
        reverse = "score" in metric.lower() or "quality" in metric.lower()
        return sorted(valid, key=lambda s: s[metric], reverse=reverse)[:n]
