"""The comparison that decides ``correct``: each returned design's modes
held to the reference's operators, and designs drawn from the seed
against the reference's exact modes.

Numbers compared, each the worst over the window's designs:

- ``missing``: how many of the first ``n_modes`` guided modes a design
  lacks (limit 0; the sampled design's exact solve gives how many
  exist);
- ``rq_gap``: |beta - beta_rq| / beta over the first ``n_modes`` modes,
  where beta_rq is the root nearest beta of the returned field's own
  quadratic form on the reference's operators (vectorial:
  h^T Q(beta) h = 0; scalar: beta^2 = -v^T A v / v^T B v): the returned
  beta is the Rayleigh value of the returned field, as the float64
  polish makes it;
- ``conf_gap``: |confinement - confinement of the returned field|, the
  post-processing's number recomputed;
- ``neff_gap``: |n_eff - n_eff_ref| / n_eff_ref mode by mode in order of
  n_eff, against the reference's exact modes of the same mesh, on the
  designs the run draws for it: whether the filter, the Rayleigh-Ritz
  and the polish found the modes at all. Its limit is the accuracy the
  configuration states.
"""
from __future__ import annotations

import numpy as np


def _f64(a):
    return np.asarray(a, dtype=np.float64)


def neff_gap(out, ref, n_modes: int) -> float:
    m = min(n_modes, len(out), len(ref))
    return max((abs(float(out[i]["n_eff"]) - float(ref[i]["n_eff"]))
                / float(ref[i]["n_eff"]) for i in range(m)), default=0.0)


def vectorial(out, n_modes: int, k0: float, ops: dict, core) -> dict:
    """Numbers of one vectorial design's mode list ``out`` on the
    operators ``ops`` (``fem.vectorial``); ``core`` the in-core DOFs."""
    m = min(n_modes, len(out))
    worst = {"missing": float(n_modes - m), "rq_gap": 0.0, "conf_gap": 0.0}
    if not m:
        return worst
    H = np.column_stack([np.concatenate([_f64(o[key]) for key in
                                         ("Ex_dofs", "Ey_dofs", "Hz_dofs")])
                         for o in out[:m]])
    a = np.sum(H * (ops["A2"] @ H), axis=0)
    b = np.sum(H * (ops["A1"] @ H), axis=0)
    c = np.sum(H * (ops["A0"] @ H), axis=0) - k0 ** 2 * np.sum(
        H * (ops["M"] @ H), axis=0)
    n = len(core)
    for i, o in enumerate(out[:m]):
        beta = float(o["beta"])
        roots = np.roots([a[i], b[i], c[i]])
        roots = roots[np.abs(roots.imag) <= 1e-9 * np.abs(roots)].real
        rq = roots[np.argmin(np.abs(roots - beta))] if len(roots) else 0.0
        worst["rq_gap"] = max(worst["rq_gap"], abs(beta - rq) / beta)
        e = H[:n, i] ** 2 + H[n:2 * n, i] ** 2
        conf = np.clip(e[core].sum() / (e.sum() + 1e-300), 0.0, 1.0)
        worst["conf_gap"] = max(worst["conf_gap"],
                                abs(float(o["confinement"]) - conf))
    return worst


def scalar(out, n_modes: int, k0: float, ops: dict, Ml) -> dict:
    """Numbers of one scalar design's mode list ``out``: ``ops`` holds
    K, Me and B (``fem.scalar_parts``), ``Ml`` the loose core mass."""
    m = min(n_modes, len(out))
    worst = {"missing": float(n_modes - m), "rq_gap": 0.0, "conf_gap": 0.0}
    if not m:
        return worst
    V = np.column_stack([_f64(o["field_vector"])[:ops["B"].shape[0]]
                         for o in out[:m]])
    A = ops["K"] - k0 ** 2 * ops["Me"]
    vAv = np.sum(V * (A @ V), axis=0)
    vBv = np.sum(V * (ops["B"] @ V), axis=0)
    vMv = np.sum(V * (Ml @ V), axis=0)
    for i, o in enumerate(out[:m]):
        beta = float(o["beta"])
        rq = np.sqrt(max(-vAv[i] / vBv[i], 0.0))
        worst["rq_gap"] = max(worst["rq_gap"], abs(beta - rq) / beta)
        conf = np.clip(vMv[i] / (vBv[i] + 1e-20), 0.0, 1.0)
        worst["conf_gap"] = max(worst["conf_gap"],
                                abs(float(o["confinement"]) - conf))
    return worst
