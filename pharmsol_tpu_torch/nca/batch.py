"""Vectorized population NCA over a shared time grid.

For simulation post-processing (the BASELINE 10k-subject pipeline) every
profile shares one dense time grid and all concentrations are positive. This
module computes the core NCA parameter set for the whole batch with numpy
array programs instead of the per-subject scalar path:

- exposure: cmax/tmax/clast/tlast/auc_last/aumc_last (lin-up/log-down or
  linear);
- λz: every terminal window size regressed at once across subjects,
  PKNCA scoring (adj-R² + factor·n with R²/span-ratio gates);
- derived: half_life, auc_inf (obs/pred), pct extrapolation, aumc_inf, mrt,
  cl_f, vz_f.

Parity: results equal `nca()` per subject (tested); requires positive
concentrations and at least `min_points` samples after Tmax — rows that
fail the gates get NaN λz-derived values, mirroring a LambdaZNotEstimable
warning.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ..data.event import AUCMethod
from .types import LambdaZMethod, NCAOptions

LN2 = math.log(2.0)


def _segment_areas(t, c, method: AUCMethod):
    """[N, T-1] per-segment AUC and AUMC (lin-up/log-down or linear)."""
    t1, t2 = t[:-1][None, :], t[1:][None, :]
    c1, c2 = c[:, :-1], c[:, 1:]
    dt = (t2 - t1)
    lin = (c1 + c2) / 2.0 * dt
    lin_m = (t1 * c1 + t2 * c2) / 2.0 * dt
    if method is AUCMethod.LINEAR:
        return lin, lin_m
    with np.errstate(divide="ignore", invalid="ignore"):
        use_log = (c2 < c1) & (c1 > 0) & (c2 > 0)
        ratio = np.where(use_log, c1 / np.where(c2 > 0, c2, 1.0), np.e)
        use_log &= np.abs(ratio - 1.0) >= 1e-10
        logr = np.log(np.where(use_log, ratio, np.e))
        logv = (c1 - c2) * dt / logr
        k = logr / np.where(dt != 0, dt, 1.0)
        logv_m = np.where(use_log, (t1 * c1 - t2 * c2) / k + (c1 - c2) / (k * k), lin_m)
    return np.where(use_log, logv, lin), np.where(use_log, logv_m, lin_m)


def batch_nca(
    times,
    profiles,
    dose=None,
    options: Optional[NCAOptions] = None,
) -> Dict[str, np.ndarray]:
    """Core NCA for [N, T] profiles over one shared [T] time grid."""
    options = options or NCAOptions()
    lz = options.lambda_z
    t = np.asarray(times, dtype=np.float64)
    c = np.asarray(profiles, dtype=np.float64)
    N, T = c.shape
    if t.shape != (T,):
        raise ValueError("times must be [T] matching profiles [N, T]")
    if np.any(c <= 0.0):
        raise ValueError("batch_nca requires strictly positive concentrations")
    if lz.method is not LambdaZMethod.ADJ_R2:
        raise ValueError("batch_nca supports the AdjR2 lambda-z method")

    cmax_idx = np.argmax(c, axis=1)
    cmax = c[np.arange(N), cmax_idx]
    tmax = t[cmax_idx]
    clast = c[:, -1]
    tlast = np.full(N, t[-1])

    areas, moments = _segment_areas(t, c, options.auc_method)
    auc_last = np.sum(areas, axis=1)
    aumc_last = np.sum(moments, axis=1)

    # -- vectorized lambda-z over all window sizes -------------------------------
    logc = np.log(c)
    best_score = np.full(N, -np.inf)
    best = {
        "lambda_z": np.full(N, np.nan),
        "intercept": np.full(N, np.nan),
        "r_squared": np.full(N, np.nan),
        "adj_r_squared": np.full(N, np.nan),
        "n_points": np.zeros(N, dtype=np.int64),
        "span_ratio": np.full(N, np.nan),
    }
    max_n = T if lz.max_points is None else min(T, lz.max_points)
    for n in range(lz.min_points, max_n + 1):
        first = T - n
        # window must start after Tmax (include_tmax=False semantics)
        valid = first >= cmax_idx + (0 if lz.include_tmax else 1)
        tw = t[first:]
        yw = logc[:, first:]
        sum_x = tw.sum()
        sum_x2 = (tw**2).sum()
        denom = n * sum_x2 - sum_x**2
        if abs(denom) < 1e-15:
            continue
        sum_y = yw.sum(axis=1)
        sum_xy = yw @ tw
        slope = (n * sum_xy - sum_x * sum_y) / denom
        intercept = (sum_y - slope * sum_x) / n
        resid = yw - (intercept[:, None] + slope[:, None] * tw[None, :])
        ss_res = np.sum(resid**2, axis=1)
        mean_y = sum_y / n
        ss_tot = np.sum((yw - mean_y[:, None]) ** 2, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.where(np.abs(ss_tot) < 1e-15, 1.0, 1.0 - ss_res / ss_tot)
        adj = 1.0 - (1.0 - r2) * (n - 1.0) / (n - 2.0) if n > 2 else r2
        lam = -slope
        hl = LN2 / lam
        span_ratio = (tw[-1] - tw[0]) / hl
        qualifies = valid & (lam > 0) & (r2 >= lz.min_r_squared) & (
            span_ratio >= lz.min_span_ratio
        )
        score = adj + lz.adj_r_squared_factor * n
        better = qualifies & (score > best_score)
        best_score = np.where(better, score, best_score)
        for key, val in (
            ("lambda_z", lam),
            ("intercept", intercept),
            ("r_squared", r2),
            ("adj_r_squared", adj),
            ("span_ratio", span_ratio),
        ):
            best[key] = np.where(better, val, best[key])
        best["n_points"] = np.where(better, n, best["n_points"])

    lam = best["lambda_z"]
    with np.errstate(invalid="ignore", divide="ignore"):
        half_life = LN2 / lam
        clast_pred = np.exp(best["intercept"] - lam * t[-1])
        auc_inf_obs = auc_last + clast / lam
        auc_inf_pred = auc_last + clast_pred / lam
        pct_extrap_obs = (auc_inf_obs - auc_last) / auc_inf_obs * 100.0
        pct_extrap_pred = (auc_inf_pred - auc_last) / auc_inf_pred * 100.0
        aumc_inf = aumc_last + clast * t[-1] / lam + clast / lam**2
        mrt = aumc_inf / auc_inf_obs

    out = {
        "cmax": cmax,
        "tmax": tmax,
        "clast": clast,
        "tlast": tlast,
        "auc_last": auc_last,
        "aumc_last": aumc_last,
        "lambda_z": lam,
        "half_life": half_life,
        "r_squared": best["r_squared"],
        "adj_r_squared": best["adj_r_squared"],
        "lambda_z_n_points": best["n_points"],
        "span_ratio": best["span_ratio"],
        "auc_inf_obs": auc_inf_obs,
        "auc_inf_pred": auc_inf_pred,
        "auc_pct_extrap_obs": pct_extrap_obs,
        "auc_pct_extrap_pred": pct_extrap_pred,
        "aumc_inf": aumc_inf,
        "mrt": mrt,
    }
    if dose is not None:
        d = np.broadcast_to(np.asarray(dose, dtype=np.float64), (N,))
        with np.errstate(invalid="ignore", divide="ignore"):
            out["cl_f"] = d / auc_inf_obs
            out["vz_f"] = d / (lam * auc_inf_obs)
            out["cmax_dn"] = cmax / d
            out["auc_last_dn"] = auc_last / d
            out["auc_inf_dn"] = auc_inf_obs / d
    return out
