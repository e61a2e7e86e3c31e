"""Sectional loss model (polymer / taper / MMF) + crosstalk + PDL.

Port of pl_fem_tpu/physics/losses.py (capability parity with the
reference's losses.py: EnhancedLossCalculator :57-716,
VectorialLossCalculator :996-1221, the LossCalculator facade with the
mux/demux PDL asymmetry :723-989). The numerical core is a set of pure
torch functions over padded, masked mode tensors (:class:`ModeBatch`);
calibrated constants (L_beat = 150 um, alpha_polymer = 0.5 dB/m, clip
windows, XT formula coefficients) are the reference's.

Precision and device: float64 on ``HOST`` (the CPU). A mode set holds
at most 64 modes, so these are a few hundred flops per design, far
below what a kernel launch costs; they run on the host by design, like
the f64 polish, and nothing here looks for a GPU. The JAX package runs
the same functions in float32 in its CLI (it never enables x64) and in
float64 under its tests; the port always uses float64.

The class facades at the bottom keep the reference's API and return
dictionaries of Python floats.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import PhotonicLanternDesignParameters

HOST = torch.device("cpu")
F64 = torch.float64


def _t(x, device=HOST) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


# ============================================================================
# Padded mode batch
# ============================================================================

class ModeBatch(NamedTuple):
    """Padded per-mode float64 tensors; ``valid`` masks the live entries."""

    n_eff: torch.Tensor        # (M,)
    beta_im: torch.Tensor      # (M,) imaginary part of beta (0 if lossless)
    confinement: torch.Tensor  # (M,)
    P_x: torch.Tensor          # (M,)
    P_y: torch.Tensor          # (M,)
    PDL_dB: torch.Tensor       # (M,)
    valid: torch.Tensor        # (M,) float 0/1


class DesignArrays(NamedTuple):
    """Design scalars (0-d float64 tensors) consumed by the loss formulas."""

    L_mux: torch.Tensor
    L_taper: torch.Tensor
    L_MMF: torch.Tensor
    n_taper: torch.Tensor
    coupling_uniformity: torch.Tensor
    packing_efficiency: torch.Tensor
    pitch_ratio: torch.Tensor
    d_polymer: torch.Tensor
    wavelength_nm: torch.Tensor


def modes_to_batch(modes: List[Dict], max_modes: int = 64,
                   device=HOST) -> ModeBatch:
    """Pack reference-style mode dicts into a padded ModeBatch."""
    m = len(modes)
    M = max(max_modes, m)

    def arr(key, default):
        out = np.full(M, default, dtype=np.float64)
        for i, md in enumerate(modes[:M]):
            out[i] = float(np.real(md.get(key, default)))
        return _t(out, device)

    beta_im = np.zeros(M)
    for i, md in enumerate(modes[:M]):
        if "beta_im" in md:           # PML perturbation (vectorial solver)
            beta_im[i] = float(md["beta_im"])
        else:
            b = md.get("beta", 0.0)
            beta_im[i] = float(np.imag(b)) if np.iscomplexobj(b) else 0.0
    return ModeBatch(
        n_eff=arr("n_eff", 0.0),
        beta_im=_t(beta_im, device),
        confinement=arr("confinement", 0.0),
        P_x=arr("P_x", 1.0),
        P_y=arr("P_y", 1.0),
        PDL_dB=arr("PDL_dB", 0.0),
        valid=_t(np.concatenate([np.ones(min(m, M)),
                                 np.zeros(M - min(m, M))]), device),
    )


def design_to_arrays(dp: PhotonicLanternDesignParameters,
                     wavelength_nm: float, device=HOST) -> DesignArrays:
    return DesignArrays(
        L_mux=_t(float(dp.L_mux), device),
        L_taper=_t(float(dp.L_taper), device),
        L_MMF=_t(float(dp.L_MMF), device),
        n_taper=_t(float(dp.n_taper), device),
        coupling_uniformity=_t(float(dp.coupling_uniformity), device),
        packing_efficiency=_t(float(dp.packing_efficiency), device),
        pitch_ratio=_t(float(dp.pitch_ratio), device),
        d_polymer=_t(float(dp.d_polymer), device),
        wavelength_nm=_t(float(wavelength_nm), device),
    )


# ============================================================================
# masked reductions
# ============================================================================

def _mcount(v):
    return torch.clamp(v.sum(), min=1.0)


def _mmean(x, v):
    return (x * v).sum() / _mcount(v)


def _mstd(x, v):
    mu = _mmean(x, v)
    return torch.sqrt(_mmean((x - mu) ** 2, v))


def _mmin(x, v, big=1e30):
    return torch.where(v > 0, x, big).min()


def _mmax(x, v, big=1e30):
    return torch.where(v > 0, x, -big).max()


def _topk_mean(x, v, k: int, largest: bool = True):
    """Mean of the k largest (or smallest) valid entries.

    With fewer than k valid entries the mean runs over what exists
    (numpy slicing semantics in the reference, e.g. losses.py:283-285
    ``sorted_confs[-3:]``).
    """
    key = torch.where(v > 0, x, -torch.inf if largest else torch.inf)
    s = torch.sort(key, descending=largest).values
    sel = s[:k]
    w = torch.isfinite(sel).to(x.dtype)
    n_avail = torch.clamp(v.sum(), max=float(k))
    sel = torch.where(torch.isfinite(sel), sel, 0.0)
    return sel.sum() / torch.clamp(torch.minimum(w.sum(), n_avail), min=1.0)


def _sorted_gaps(ne_sorted, valid, fill):
    """Neighbour gaps of the sorted valid n_eff (first n-1 entries) and
    their 0/1 mask; the other entries hold ``fill``."""
    m = valid.shape[0]
    gap_valid = (torch.arange(m, device=valid.device)
                 < valid.sum() - 1).to(ne_sorted.dtype)
    diffs = torch.diff(ne_sorted, append=ne_sorted[-1:])
    return torch.where(gap_valid > 0, diffs, fill), gap_valid


# ============================================================================
# crosstalk (losses.py:546-686)
# ============================================================================

def crosstalk_vectorial(b: ModeBatch) -> torch.Tensor:
    """Spectral-spread XT proxy (losses.py:546-619), masked."""
    n = b.valid.sum()
    ne = torch.sort(torch.where(b.valid > 0, b.n_eff, torch.inf)).values
    gaps, gap_valid = _sorted_gaps(ne, b.valid, 0.0)

    ne_min = _mmin(b.n_eff, b.valid)
    ne_max = _mmax(b.n_eff, b.valid)
    delta = ne_max - ne_min
    denom_guide = torch.clamp((ne_max + 0.01) - (ne_min - 0.002), min=1e-6)
    Q = torch.clamp(delta / denom_guide, 0.0, 1.0)

    ngap = torch.clamp(gap_valid.sum(), min=1.0)
    mean_gap = (gaps * gap_valid).sum() / ngap + 1e-12
    std_gap = torch.sqrt(((gaps - mean_gap) ** 2 * gap_valid).sum() / ngap)
    CV_norm = torch.where(gap_valid.sum() > 1,
                          torch.clamp((std_gap / mean_gap) / 2.0, 0.0, 1.0),
                          0.5)

    strong = (b.confinement > 0.01) * b.valid
    Gamma = torch.where(strong.sum() > 0,
                        (b.confinement * strong).sum()
                        / torch.clamp(strong.sum(), min=1.0), 0.5)

    xt = -10.0 - 20.0 * Q - 5.0 * CV_norm - 5.0 * Gamma
    xt = torch.clamp(xt, -40.0, -15.0)
    return torch.where(n < 2, -25.0, xt)


def crosstalk_scalar(b: ModeBatch, fields: torch.Tensor) -> torch.Tensor:
    """Max normalized field overlap XT (losses.py:622-663).

    fields: (D, M) padded mode field vectors (columns masked by b.valid).
    """
    G = fields.T @ fields                      # (M, M)
    P = torch.diagonal(G)
    vv = b.valid[:, None] * b.valid[None, :]
    ok = vv * (P[:, None] > 1e-12) * (P[None, :] > 1e-12)
    ov = torch.abs(G) ** 2 / (P[:, None] * P[None, :] + 1e-16)
    iu = torch.triu(torch.ones_like(ov), diagonal=1)
    max_ov = (ov * ok * iu).max()

    xt = -10.0 * torch.log10(max_ov + 1e-15)
    # degeneracy penalty
    ne = torch.sort(torch.where(b.valid > 0, b.n_eff, torch.inf)).values
    gaps, _ = _sorted_gaps(ne, b.valid, torch.inf)
    min_gap = gaps.min()
    xt = torch.where(min_gap < 1e-4, xt - (15.0 + (1e-4 - min_gap) * 1e6), xt)
    xt = torch.clamp(xt, -70.0, -15.0)
    return torch.where((b.valid.sum() < 2) | (max_ov == 0.0), -70.0, xt)


# ============================================================================
# PDL (losses.py:444-539)
# ============================================================================

def pdl_vectorial(b: ModeBatch) -> torch.Tensor:
    """PDL from FEM-exact total P_x / P_y (losses.py:444-468)."""
    Px = (b.P_x * b.valid).sum()
    Py = (b.P_y * b.valid).sum()
    eps = 1e-30
    pdl = 10.0 * torch.log10(torch.maximum(Px, Py)
                             / (torch.minimum(Px, Py) + eps))
    pdl = torch.clamp(pdl, 0.0, 50.0)
    return torch.where((Px < eps) & (Py < eps), 0.1, pdl)


def pdl_realistic(b: ModeBatch, positions: torch.Tensor, n_pos: int,
                  wavelength_nm) -> torch.Tensor:
    """Scalar-mode PDL heuristic (losses.py:470-539)."""
    # birefringence from near-degenerate n_eff gaps (< 5e-4)
    ne = torch.sort(torch.where(b.valid > 0, b.n_eff, -torch.inf),
                    descending=True).values
    # invalid gaps get a large FINITE sentinel: inf would poison the
    # masked sum below (inf * 0 = nan)
    gaps, gap_valid = _sorted_gaps(-ne, b.valid, 1e30)
    gaps = torch.abs(gaps)
    deg = (gaps < 5e-4).to(ne.dtype) * gap_valid
    mean_biref = torch.where(deg > 0, gaps, 0.0).sum() \
        / torch.clamp(deg.sum(), min=1.0)
    k0_m = 2.0 * np.pi / (wavelength_nm * 1e-9)
    pdl_biref_deg = 4.343 * k0_m * mean_biref * 375e-6
    ptp = _mmax(b.n_eff, b.valid) - _mmin(b.n_eff, b.valid)
    pdl_biref = torch.where(deg.sum() > 0, pdl_biref_deg, ptp * 800.0)

    # geometric asymmetry (second moments of core positions)
    pc = positions - positions.mean(dim=0, keepdim=True)
    Ixx = (pc[:, 0] ** 2).sum()
    Iyy = (pc[:, 1] ** 2).sum()
    Ixy = (pc[:, 0] * pc[:, 1]).sum()
    disc = torch.sqrt(((Ixx - Iyy) / 2.0) ** 2 + Ixy**2)
    I_max = (Ixx + Iyy) / 2.0 + disc
    I_min = (Ixx + Iyy) / 2.0 - disc
    asym = torch.abs(I_max - I_min) / (I_max + I_min + 1e-12)
    pdl_geom = asym * 4.0 if n_pos >= 3 else torch.zeros_like(asym)

    pdl_coupling = 0.15 * torch.log10(b.valid.sum() + 1.0)
    wl = wavelength_nm
    wl_factor = torch.where(wl < 1530.0, 1.0 + (1530.0 - wl) / 1000.0,
                            torch.where(wl > 1565.0,
                                        1.0 + (wl - 1565.0) / 1000.0, 1.0))
    pdl_conf = _mstd(b.confinement, b.valid) * 2.0
    total = (pdl_biref + pdl_geom + pdl_coupling + pdl_conf) * wl_factor
    total = torch.clamp(total, 0.05, 6.0)
    return torch.where(b.valid.sum() < 2, 0.3, total)


# ============================================================================
# radiation (losses.py:692-716)
# ============================================================================

def radiation_loss(b: ModeBatch, wavelength_nm) -> torch.Tensor:
    wl_factor = 1550.0 / wavelength_nm
    has_im = torch.abs(b.beta_im) > 1e-9
    from_im = 2.0 * torch.abs(b.beta_im) * 1e6 * 8.685889638 * wl_factor
    pen = torch.clamp(1.0 - b.confinement, min=0.0) * 100.0
    pen = pen + torch.where(b.confinement < 0.95,
                            (0.95 - b.confinement) * 250.0, 0.0)
    rads = torch.where(has_im, from_im, pen)
    return _mmean(rads, b.valid)


# ============================================================================
# sectional model — scalar route (losses.py:181-438)
# ============================================================================

def sectional_losses(b: ModeBatch, da: DesignArrays, positions, n_pos: int,
                     delta_n: float, vectorial: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """EnhancedLossCalculator.calculate_sectional_losses numerical core."""
    # -- polymer (losses.py:181-234) --
    strong = (b.confinement > 0.01) * b.valid
    avg_conf_s = torch.where(strong.sum() > 0,
                             (b.confinement * strong).sum()
                             / torch.clamp(strong.sum(), min=1.0), 0.5)
    coupling_mismatch = 0.5 * (1.0 - da.coupling_uniformity)
    loss_conf = -10.0 * torch.log10(torch.clamp(avg_conf_s, min=1e-6))
    loss_prop = 0.5 * (da.L_mux * 1e-6)
    IL_polymer = coupling_mismatch + loss_conf + loss_prop

    nvalid = b.valid.sum()
    cmin = _mmin(b.confinement, b.valid)
    cmax = _mmax(b.confinement, b.valid)
    MDL_polymer = torch.where(
        nvalid >= 2,
        -10.0 * torch.log10(torch.clamp(cmin, min=1e-9) / (cmax + 1e-12))
        + 3.0 * _mstd(b.confinement, b.valid), 0.0)

    if vectorial:
        PDL_polymer = pdl_vectorial(b)
    else:
        PDL_polymer = pdl_realistic(b, positions, n_pos, da.wavelength_nm)

    polymer = {
        "IL": torch.clamp(IL_polymer, 0.0, 10.0),
        "MDL": torch.clamp(MDL_polymer, 0.0, 5.0),
        "PDL": torch.clamp(PDL_polymer, 0.05, 3.0),
    }

    # -- taper (losses.py:240-309) --
    L_beat = 150.0
    eta = 1.0 - torch.exp(-da.L_taper
                          / (L_beat * torch.clamp(da.n_taper, min=0.5)))
    IL_coupling = -10.0 * torch.log10(torch.clamp(eta, min=1e-6))
    IL_prop = 0.5 * (da.L_taper * 1e-6)
    conf_mean = _mmean(b.confinement, b.valid)
    IL_rad = (torch.clamp(1.0 - conf_mean, min=0.0) * 0.5
              + 0.05 * torch.log10(nvalid + 1.0))
    IL_taper = IL_coupling + IL_prop + IL_rad

    low_order = _topk_mean(b.confinement, b.valid, 3, largest=True)
    high_order = _topk_mean(b.confinement, b.valid, 3, largest=False)
    MDL_taper = torch.where(
        nvalid >= 2,
        torch.clamp(-10.0 * torch.log10(high_order / (low_order + 1e-12)),
                    0.0, 3.0), 0.0)

    k0_um = 2.0 * np.pi / (da.wavelength_nm * 1e-3)
    PDL_taper = 4.343 * k0_um * 1e-5 * da.L_taper

    taper = {
        "IL": torch.clamp(IL_taper, 0.0, 8.0),
        "MDL": torch.clamp(MDL_taper, 0.0, 3.0),
        "PDL": torch.clamp(PDL_taper, 0.01, 2.0),
    }

    # -- MMF (losses.py:315-349) --
    IL_MMF = 0.2 * (da.L_MMF * 1e-9) + 0.3
    short = da.L_MMF < 1.0
    mmf = {
        "IL": torch.where(short, 0.0, torch.clamp(IL_MMF, 0.0, 5.0)),
        "MDL": torch.where(short, 0.0, _t(0.05)),
        "PDL": torch.where(short, 0.0, _t(0.05)),
    }

    # -- global (losses.py:355-438) --
    IL_total = polymer["IL"] + taper["IL"] + mmf["IL"]
    MDL_total = torch.sqrt(polymer["MDL"]**2 + taper["MDL"]**2
                           + mmf["MDL"]**2)
    PDL_total = polymer["PDL"] + taper["PDL"] + mmf["PDL"]
    Efficiency = 10.0 ** (-IL_total / 10.0)

    cv_conf = _mstd(b.confinement, b.valid) / (conf_mean + 1e-9)
    n_eff_spread = (_mmax(b.n_eff, b.valid) - _mmin(b.n_eff, b.valid)) \
        / max(delta_n, 1e-6)
    conf_min_pen = torch.clamp(0.70 - cmin, min=0.0)
    coupling_degradation = torch.where(
        nvalid >= 2,
        torch.clamp(cv_conf * 1.5 + n_eff_spread * 0.8 + conf_min_pen * 2.0,
                    0.0, 5.0), 5.0)

    packing = da.packing_efficiency
    packing_penalty = torch.where(
        packing < 0.5, (0.5 - packing) * 3.0,
        torch.where(packing > 0.85, (packing - 0.85) * 2.0, 0.0))
    geometry_penalty = packing_penalty + torch.abs(da.pitch_ratio - 3.5) * 0.2

    pos_conf = b.valid * (b.confinement > 0)
    return {
        "IL_polymer": polymer["IL"], "MDL_polymer": polymer["MDL"],
        "PDL_polymer": polymer["PDL"],
        "IL_taper": taper["IL"], "MDL_taper": taper["MDL"],
        "PDL_taper": taper["PDL"],
        "IL_MMF": mmf["IL"], "MDL_MMF": mmf["MDL"], "PDL_MMF": mmf["PDL"],
        "IL_total": torch.clamp(IL_total, 0.0, 40.0),
        "MDL_total": torch.clamp(MDL_total, 0.0, 10.0),
        "PDL_total": torch.clamp(PDL_total, 0.05, 10.0),
        "Total_Loss": IL_total,
        "Efficiency": torch.clamp(Efficiency, 0.0, 1.0),
        "coupling_degradation": coupling_degradation,
        "geometry_penalty": torch.clamp(geometry_penalty, 0.0, 5.0),
        "radiation_loss_dB_per_m": radiation_loss(b, da.wavelength_nm),
        "avg_confinement": torch.where(
            pos_conf.sum() > 0,
            (b.confinement * pos_conf).sum()
            / torch.clamp(pos_conf.sum(), min=1.0), 0.0),
    }


# ============================================================================
# sectional model — vectorial route (losses.py:1011-1221)
# ============================================================================

def vectorial_losses_core(b: ModeBatch, da: DesignArrays
                          ) -> Dict[str, torch.Tensor]:
    """VectorialLossCalculator.calculate_vectorial_losses numerical core."""
    nvalid = b.valid.sum()

    # polymer (losses.py:1108-1140)
    IL_polymer = 0.2 * (da.d_polymer * 1e-6)
    cmax = _mmax(b.confinement, b.valid)
    cmin = _mmin(b.confinement, b.valid)
    MDL_polymer = torch.where(
        nvalid > 1, 10.0 * torch.log10(cmax / (cmin + 1e-12)), 0.0)
    PDL_polymer = pdl_vectorial(b)
    polymer = {
        "IL": torch.clamp(IL_polymer, 0.0, 1.0),
        "MDL": torch.clamp(MDL_polymer, 0.0, 2.0),
        "PDL": torch.clamp(torch.where((b.P_x * b.valid).sum() > 1e-30,
                                       PDL_polymer, 0.1), 0.05, 1.0),
    }

    # taper (losses.py:1144-1203)
    L_beat = 150.0
    eta = 1.0 - torch.exp(-da.L_taper
                          / (L_beat * torch.clamp(da.n_taper, min=0.5)))
    IL_coupling = -10.0 * torch.log10(torch.clamp(eta, min=1e-6))
    IL_prop = 0.5 * (da.L_taper * 1e-6)
    conf_mean = _mmean(b.confinement, b.valid)
    IL_rad = (torch.clamp(1.0 - conf_mean, min=0.0) * 0.5
              + 0.05 * torch.log10(nvalid + 1.0))
    IL_taper = IL_coupling + IL_prop + IL_rad

    # MDL from variance of P_x / P_y over valid modes
    def mvar(x):
        mu = _mmean(x, b.valid)
        return _mmean((x - mu) ** 2, b.valid)

    MDL_taper = torch.where(
        nvalid > 1,
        10.0 * torch.log10(1.0 + (mvar(b.P_x) + mvar(b.P_y)) / 2.0), 0.0)

    powers = (b.P_x + b.P_y) * b.valid
    P_total = powers.sum()
    PDL_w = torch.where(P_total > 1e-12,
                        (b.PDL_dB * powers).sum()
                        / torch.clamp(P_total, min=1e-12),
                        _mmean(b.PDL_dB, b.valid))
    k0_um = 2.0 * np.pi / (da.wavelength_nm * 1e-3)
    PDL_taper = PDL_w + 4.343 * k0_um * 1e-5 * da.L_taper
    taper = {
        "IL": torch.clamp(IL_taper, 0.0, 10.0),
        "MDL": torch.clamp(MDL_taper, 0.0, 5.0),
        "PDL": torch.clamp(PDL_taper, 0.01, 3.0),
    }

    # MMF fixed (losses.py:1208-1221)
    mmf = {"IL": _t(0.32), "MDL": _t(0.05), "PDL": _t(0.05)}

    IL_total = polymer["IL"] + taper["IL"] + mmf["IL"]
    MDL_total = torch.sqrt(polymer["MDL"]**2 + taper["MDL"]**2
                           + mmf["MDL"]**2)
    PDL_total = polymer["PDL"] + taper["PDL"] + mmf["PDL"]
    return {
        "IL_polymer": polymer["IL"], "MDL_polymer": polymer["MDL"],
        "PDL_polymer": polymer["PDL"],
        "IL_taper": taper["IL"], "MDL_taper": taper["MDL"],
        "PDL_taper": taper["PDL"],
        "IL_MMF": mmf["IL"], "MDL_MMF": mmf["MDL"], "PDL_MMF": mmf["PDL"],
        "IL_total": torch.clamp(IL_total, 0.0, 40.0),
        "MDL_total": torch.clamp(MDL_total, 0.0, 10.0),
        "PDL_total": torch.clamp(PDL_total, 0.05, 10.0),
    }


def demux_pdl_asymmetry(b: ModeBatch) -> torch.Tensor:
    """Mux->demux PDL asymmetry factor (losses.py:784-802)."""
    pdl_low = _topk_mean(b.PDL_dB, b.valid, 4, largest=True)
    pdl_high = _topk_mean(b.PDL_dB, b.valid, 4, largest=False)
    spread = torch.where(b.valid.sum() >= 4,
                         torch.clamp(pdl_low - pdl_high, min=0.0), 0.3)
    conf_cv = _mstd(b.confinement, b.valid) \
        / (_mmean(b.confinement, b.valid) + 1e-9)
    return torch.clamp(0.04 + 0.06 * conf_cv + 0.02 * spread, 0.02, 0.12)


# ============================================================================
# design-parameter reconstruction (losses.py:871-989)
# ============================================================================

def build_design_params(modes: List[Dict], geometry,
                        wavelength_nm: float) -> PhotonicLanternDesignParameters:
    """Reconstruct DesignParameters from the geometry (host side)."""
    n_cores = int(getattr(geometry, "n_cores", 3))
    _cr = getattr(geometry, "core_radii", None)
    r_core = float(np.asarray(_cr).flat[0]) if _cr is not None \
        else float(getattr(geometry, "r_core", 1.2))
    n_core = float(np.asarray(getattr(geometry, "n_core", 1.535)).flat[0])
    n_clad = float(np.asarray(getattr(geometry, "n_clad", 1.0)).flat[0])
    k0 = float(np.asarray(getattr(
        geometry, "k0", 2.0 * np.pi / (wavelength_nm / 1000.0))).flat[0])
    _V = getattr(geometry, "V_number", None)
    V_num = float(np.asarray(_V).flat[0]) if _V is not None else \
        float(k0 * r_core * np.sqrt(max(n_core**2 - n_clad**2, 1e-6)))
    NA = float(np.sqrt(max(n_core**2 - n_clad**2, 1e-6)))
    MFD = float(2.0 * r_core * (0.65 + 1.619 / max(V_num, 0.5) ** 1.5
                                + 2.879 / max(V_num, 0.5) ** 6))

    positions = getattr(geometry, "positions",
                        getattr(geometry, "core_positions", None))
    if positions is not None and len(positions) >= 2:
        pos = np.asarray(positions, dtype=float)
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        pitch_val = float(d[np.triu_indices(len(pos), 1)].min())
        R_ring = float(np.linalg.norm(pos, axis=1).max())
    else:
        pitch_val, R_ring = 8.0, 8.0
    packing_val = float(np.clip(
        n_cores * np.pi * r_core**2 / (np.pi * max(R_ring + r_core, 1.0)**2),
        0.01, 0.90))
    pitch_ratio_val = float(pitch_val / (2.0 * r_core + 1e-9))
    has_central = False
    if positions is not None and len(positions) > 0:
        norms = np.linalg.norm(np.asarray(positions, dtype=float), axis=1)
        has_central = bool(np.any(norms < 0.5 * r_core))
    config_type_val = "hexagonal" if n_cores in (7, 19) else "circular"
    n_eff_lp01 = float(modes[0]["n_eff"]) if modes else float(n_core - 0.01)

    _tl = getattr(geometry, "taper_length", None)
    taper_len = float(np.asarray(_tl).flat[0]) if _tl is not None else 0.0
    if taper_len > 0.0:
        L_taper_val = taper_len
        L_mux_val = max(L_taper_val * 0.5, 100.0)
    else:
        L_taper_val, L_mux_val = 375.0, 200.0
    L_MMF_val = 100.0

    return PhotonicLanternDesignParameters(
        N_cores=n_cores, has_central_core=has_central,
        config_type=config_type_val,
        geometry_config=f"{n_cores}-{config_type_val}",
        n_peripheral_cores=n_cores - (1 if has_central else 0),
        R_ring=R_ring, packing_efficiency=packing_val, pitch=pitch_val,
        pitch_min=pitch_val, pitch_ratio=pitch_ratio_val,
        wavelength=float(wavelength_nm), r_core_SM=r_core, r_clad_SM=62.5,
        n_core_SM=n_core, n_clad_SM=n_clad, V_SM=V_num, NA_SM=NA, MFD=MFD,
        n_eff_LP01=n_eff_lp01, r_core_MM=25.0,
        V_MM=float(np.sqrt(n_cores) * V_num), NA_MM=0.22,
        M_max=max(int(n_cores * V_num**2 / 4), 1), n_polymer=n_core,
        d_polymer=2.0, coupling_uniformity=0.95, L_mux=L_mux_val,
        L_taper=L_taper_val, L_MMF=L_MMF_val,
        L_total=L_mux_val + L_taper_val + L_MMF_val, n_taper=1.0,
        taper_profile="exponential",
    )


# ============================================================================
# reference-API facades
# ============================================================================

def _geo_arrays(modes, geometry):
    positions = getattr(geometry, "positions",
                        getattr(geometry, "core_positions", None))
    if positions is None or len(np.atleast_2d(positions)) == 0:
        positions = np.zeros((1, 2))
    positions = np.atleast_2d(np.asarray(positions, dtype=float))
    n_core = float(np.asarray(getattr(geometry, "n_core", 1.53)).flat[0])
    n_clad = float(np.asarray(getattr(geometry, "n_clad", 1.0)).flat[0])
    return _t(positions), len(positions), max(n_core - n_clad, 1e-6)


def _fields_matrix(modes: List[Dict], M: int) -> Optional[torch.Tensor]:
    vecs = [m.get("field_vector") for m in modes]
    if not vecs or vecs[0] is None:
        return None
    D = len(vecs[0])
    F = np.zeros((D, M))
    for i, v in enumerate(vecs[:M]):
        if v is not None and len(v) == D:
            F[:, i] = np.real(v)
    return _t(F)


class EnhancedLossCalculator:
    """Sectional loss calculator (reference seam: losses.py:57-716)."""

    REQUIRED_MODE_KEYS = {"n_eff", "beta", "confinement"}

    @staticmethod
    def calculate_sectional_losses(modes, geometry, design_params,
                                   direction: str = "mux",
                                   wavelength_nm: float = 1550.0) -> Dict:
        if not modes:
            return {"success": False, "error": "no modes"}
        b = modes_to_batch(modes)
        da = design_to_arrays(design_params, wavelength_nm)
        positions, n_pos, delta_n = _geo_arrays(modes, geometry)
        vectorial = bool(modes[0].get("is_vectorial", False))
        out = sectional_losses(b, da, positions, n_pos, delta_n,
                               vectorial=vectorial)
        xt = EnhancedLossCalculator._calculate_crosstalk(modes)
        result = {key: float(v) for key, v in out.items()}
        result.update({
            "Crosstalk": float(xt),
            "crosstalk_penalty": float(np.clip(
                max(0.0, -20.0 - float(xt)) * 0.1, 0.0, 5.0)),
            "n_modes_used": len(modes),
            "direction": direction,
            "wavelength_nm": float(wavelength_nm),
            "success": True,
        })
        return result

    @staticmethod
    def _calculate_pdl_vectorial(modes: List[Dict]) -> float:
        return float(pdl_vectorial(modes_to_batch(modes)))

    @staticmethod
    def _calculate_pdl_realistic(modes, geometry,
                                 wavelength_nm: float) -> float:
        b = modes_to_batch(modes)
        positions, n_pos, _ = _geo_arrays(modes, geometry)
        return float(pdl_realistic(b, positions, n_pos,
                                   _t(float(wavelength_nm))))

    @staticmethod
    def _calculate_crosstalk_vectorial(modes: List[Dict]) -> float:
        return float(crosstalk_vectorial(modes_to_batch(modes)))

    @staticmethod
    def _calculate_crosstalk_scalar(modes: List[Dict]) -> float:
        b = modes_to_batch(modes)
        F = _fields_matrix(modes, b.valid.shape[0])
        if F is None:
            return -70.0
        return float(crosstalk_scalar(b, F))

    @staticmethod
    def _calculate_crosstalk(modes: List[Dict]) -> float:
        if not modes:
            return -70.0
        if modes[0].get("is_vectorial", False):
            return EnhancedLossCalculator._calculate_crosstalk_vectorial(modes)
        return EnhancedLossCalculator._calculate_crosstalk_scalar(modes)

    @staticmethod
    def _calculate_radiation_loss(modes: List[Dict],
                                  wavelength_nm: float) -> float:
        if not modes:
            return 0.0
        return float(radiation_loss(modes_to_batch(modes),
                                    _t(float(wavelength_nm))))


class VectorialLossCalculator:
    """PDL-exact vectorial loss calculator (losses.py:996-1221)."""

    @staticmethod
    def calculate_vectorial_losses(modes_vectorial, geometry, design_params,
                                   direction: str = "mux",
                                   wavelength_nm: float = 1550.0) -> Dict:
        if not modes_vectorial:
            return {"success": False, "error": "no modes"}
        if not modes_vectorial[0].get("is_vectorial", False):
            return {"success": False, "error": "modes not vectorial"}
        b = modes_to_batch(modes_vectorial)
        da = design_to_arrays(design_params, wavelength_nm)
        out = {key: float(v) for key, v in vectorial_losses_core(b, da).items()}
        out.update({
            "success": True, "is_vectorial": True,
            "n_modes_used": len(modes_vectorial),
            "direction": direction, "wavelength_nm": float(wavelength_nm),
        })
        return out


class LossCalculator(EnhancedLossCalculator):
    """V17-compatible entry point (losses.py:723-989).

    Routes vectorial modes through VectorialLossCalculator (+ vectorial
    XT + mux/demux PDL asymmetry), scalar modes through the sectional
    model (x1.02 demux PDL).
    """

    @staticmethod
    def calculate_physical_losses(modes, geometry, direction: str = "mux",
                                  wavelength_nm: float = 1550.0) -> Dict:
        if modes and modes[0].get("is_vectorial", False):
            dp = build_design_params(modes, geometry, wavelength_nm)
            rv = VectorialLossCalculator.calculate_vectorial_losses(
                modes, geometry, dp, direction, wavelength_nm)
            if rv.get("success", False):
                b = modes_to_batch(modes)
                xt = float(crosstalk_vectorial(b))
                PDL_base = rv["PDL_total"]
                if direction == "demux":
                    PDL_out = PDL_base * (1.0 + float(demux_pdl_asymmetry(b)))
                else:
                    PDL_out = PDL_base
                confs = [m.get("confinement", 0.0) for m in modes]
                # the vectorial core has no global-metrics block; run
                # the sectional model's to surface the same coupling/
                # geometry penalties the scalar route reports
                # (reference: losses.py:386-415)
                rs = EnhancedLossCalculator.calculate_sectional_losses(
                    modes, geometry, dp, direction, wavelength_nm)
                return {
                    "IL_dB": rv["IL_total"],
                    "MDL_dB": rv["MDL_total"],
                    "PDL_dB": float(np.clip(PDL_out, 0.05, 10.0)),
                    "crosstalk_dB": xt,
                    "radiation_loss_dB_per_m":
                        EnhancedLossCalculator._calculate_radiation_loss(
                            modes, wavelength_nm),
                    "avg_confinement": float(np.mean(confs)) if confs else 0.0,
                    "coupling_degradation": rs.get("coupling_degradation"),
                    "geometry_penalty": rs.get("geometry_penalty"),
                    "n_modes_used": rv["n_modes_used"],
                    "direction": direction,
                    "wavelength_nm": float(wavelength_nm),
                    "is_vectorial": True,
                    "success": True,
                }
            # fall through to scalar route on failure

        dp = build_design_params(modes, geometry, wavelength_nm)
        rf = EnhancedLossCalculator.calculate_sectional_losses(
            modes, geometry, dp, direction, wavelength_nm)
        if not rf.get("success", False):
            return {"success": False, "error": rf.get("error", "unknown")}
        PDL_base = rf["PDL_total"]
        PDL_out = PDL_base * 1.02 if direction == "demux" else PDL_base
        return {
            "IL_dB": rf["IL_total"],
            "MDL_dB": rf["MDL_total"],
            "PDL_dB": float(np.clip(PDL_out, 0.05, 10.0)),
            "crosstalk_dB": rf["Crosstalk"],
            "radiation_loss_dB_per_m": rf["radiation_loss_dB_per_m"],
            "avg_confinement": rf["avg_confinement"],
            "coupling_degradation": rf.get("coupling_degradation"),
            "geometry_penalty": rf.get("geometry_penalty"),
            "n_modes_used": rf["n_modes_used"],
            "direction": direction,
            "wavelength_nm": float(wavelength_nm),
            "is_vectorial": False,
            "success": True,
        }

    _build_design_params = staticmethod(
        lambda modes, geometry, wavelength_nm:
        build_design_params(modes, geometry, wavelength_nm))
