"""NCA calculation primitives: lambda-z regression, derived parameters.

Parity with LAPKB/pharmsol src/nca/calc.rs:

- λz candidates enumerate every terminal window from min_points up to the
  full post-Tmax tail; the best candidate maximizes adjusted R² +
  adj_r_squared_factor * n (PKNCA scoring), subject to min R² and span-ratio
  gates (calc.rs:123-335);
- regression is plain least squares on (t, ln C); the reference's Kahan
  compensation is matched by numpy's pairwise summation at f64;
- C0 cascade: Observed -> LogSlope (semilog back-extrapolation from the
  first two declining positives) -> FirstConc -> Cmin -> Zero;
- tlag from raw pre-BLQ-filter data (BLQ treated as 0): the time point
  before the first concentration increase (PKNCA parity);
- steady-state helpers: cmin/cavg/fluctuation/swing/peak-trough;
- time above a concentration threshold with interpolated crossings.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.event import Censor
from .types import C0Method, LambdaZMethod, LambdaZOptions

LN2 = math.log(2.0)


@dataclass
class LambdaZResult:
    lambda_z: float
    intercept: float
    r_squared: float
    adj_r_squared: float
    n_points: int
    time_first: float
    time_last: float
    clast_pred: float
    corrxy: float = float("nan")


@dataclass
class LambdaZCandidate:
    n_points: int
    start_idx: int
    end_idx: int
    start_time: float
    end_time: float
    lambda_z: float
    half_life: float
    intercept: float
    r_squared: float
    adj_r_squared: float
    span_ratio: float
    auc_inf: float
    auc_pct_extrap: float
    is_selected: bool = False


def linear_regression(x: Sequence[float], y: Sequence[float]):
    """Least squares (slope, intercept, r_squared, corrxy); None if degenerate."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 2:
        return None
    sum_x = float(np.sum(x))
    sum_y = float(np.sum(y))
    sum_xy = float(np.sum(x * y))
    sum_x2 = float(np.sum(x * x))
    denom = n * sum_x2 - sum_x * sum_x
    if abs(denom) < 1e-15:
        return None
    slope = (n * sum_xy - sum_x * sum_y) / denom
    intercept = (sum_y - slope * sum_x) / n
    mean_y = sum_y / n
    ss_tot = float(np.sum((y - mean_y) ** 2))
    ss_res = float(np.sum((y - (intercept + slope * x)) ** 2))
    r_squared = 1.0 if abs(ss_tot) < 1e-15 else 1.0 - ss_res / ss_tot
    sd_x = float(np.std(x, ddof=1))
    sd_y = float(np.std(y, ddof=1))
    corrxy = slope * sd_x / sd_y if sd_x > 0 and sd_y > 0 else float("nan")
    return slope, intercept, r_squared, corrxy


def fit_lambda_z(profile, first_idx: int, last_idx: int, options: LambdaZOptions):
    """Log-linear fit over [first_idx, last_idx] (positive concs only)."""
    times, log_c = [], []
    for i in range(first_idx, last_idx + 1):
        if i in options.exclude_indices:
            continue
        c = float(profile.concentrations[i])
        if c > 0.0:
            times.append(float(profile.times[i]))
            log_c.append(math.log(c))
    if len(times) < 2:
        return None
    reg = linear_regression(times, log_c)
    if reg is None:
        return None
    slope, intercept, r_squared, corrxy = reg
    lambda_z = -slope
    if lambda_z <= 0.0:
        return None
    n = len(times)
    adj = 1.0 - (1.0 - r_squared) * (n - 1.0) / (n - 2.0) if n > 2 else r_squared
    clast_pred = math.exp(intercept + slope * float(profile.times[last_idx]))
    return LambdaZResult(
        lambda_z=lambda_z,
        intercept=intercept,
        r_squared=r_squared,
        adj_r_squared=adj,
        n_points=n,
        time_first=times[0],
        time_last=times[-1],
        clast_pred=clast_pred,
        corrxy=corrxy,
    )


def lambda_z_candidates(
    profile, options: LambdaZOptions, auc_last: float
) -> List[LambdaZCandidate]:
    """All valid terminal regressions; the best one has is_selected=True."""
    start_idx = 0 if options.include_tmax else profile.cmax_idx + 1
    if profile.tlast_idx < start_idx + options.min_points - 1:
        return []
    max_n = profile.tlast_idx - start_idx + 1
    if options.max_points is not None:
        max_n = min(max_n, options.max_points)
    clast_obs = float(profile.concentrations[profile.tlast_idx])

    candidates: List[LambdaZCandidate] = []
    best_idx = None
    best_score = -np.inf
    for n_points in range(options.min_points, max_n + 1):
        first_idx = profile.tlast_idx - n_points + 1
        if first_idx < start_idx:
            continue
        result = fit_lambda_z(profile, first_idx, profile.tlast_idx, options)
        if result is None:
            continue
        hl = LN2 / result.lambda_z
        span = result.time_last - result.time_first
        span_ratio = span / hl
        auc_inf_val = auc_inf(auc_last, clast_obs, result.lambda_z)
        extrap = auc_extrap_pct(auc_last, auc_inf_val)
        cand = LambdaZCandidate(
            n_points=result.n_points,
            start_idx=first_idx,
            end_idx=profile.tlast_idx,
            start_time=result.time_first,
            end_time=result.time_last,
            lambda_z=result.lambda_z,
            half_life=hl,
            intercept=result.intercept,
            r_squared=result.r_squared,
            adj_r_squared=result.adj_r_squared,
            span_ratio=span_ratio,
            auc_inf=auc_inf_val,
            auc_pct_extrap=extrap,
        )
        qualifies = (
            result.r_squared >= options.min_r_squared
            and span_ratio >= options.min_span_ratio
        )
        if qualifies:
            if options.method is LambdaZMethod.ADJ_R2:
                score = result.adj_r_squared + options.adj_r_squared_factor * result.n_points
            else:
                score = result.r_squared
            if score > best_score:
                best_score = score
                best_idx = len(candidates)
        candidates.append(cand)
    if best_idx is not None:
        candidates[best_idx].is_selected = True
    return candidates


def lambda_z(profile, options: LambdaZOptions) -> Optional[LambdaZResult]:
    start_idx = 0 if options.include_tmax else profile.cmax_idx + 1
    if profile.tlast_idx < start_idx + options.min_points - 1:
        return None
    if options.method is LambdaZMethod.MANUAL:
        n = options.manual_points or options.min_points
        if n < options.min_points:
            return None
        first_idx = max(profile.tlast_idx - (n - 1), 0)
        if first_idx < start_idx:
            return None
        return fit_lambda_z(profile, first_idx, profile.tlast_idx, options)
    candidates = lambda_z_candidates(profile, options, 0.0)
    selected = next((c for c in candidates if c.is_selected), None)
    if selected is None:
        return None
    clast_pred = math.exp(
        selected.intercept - selected.lambda_z * float(profile.times[selected.end_idx])
    )
    # recover corrxy by refitting the selected window (cheap)
    refit = fit_lambda_z(profile, selected.start_idx, selected.end_idx, options)
    return LambdaZResult(
        lambda_z=selected.lambda_z,
        intercept=selected.intercept,
        r_squared=selected.r_squared,
        adj_r_squared=selected.adj_r_squared,
        n_points=selected.n_points,
        time_first=selected.start_time,
        time_last=selected.end_time,
        clast_pred=clast_pred,
        corrxy=refit.corrxy if refit else float("nan"),
    )


# -- derived parameters (calc.rs:396-560) --------------------------------------


def half_life(lambda_z: float) -> float:
    return LN2 / lambda_z


def auc_inf(auc_last: float, clast: float, lambda_z: float) -> float:
    if lambda_z <= 0.0:
        return float("nan")
    return auc_last + clast / lambda_z


def auc_extrap_pct(auc_last: float, auc_inf_val: float) -> float:
    if auc_inf_val <= 0.0 or not math.isfinite(auc_inf_val):
        return float("nan")
    return (auc_inf_val - auc_last) / auc_inf_val * 100.0


def aumc_inf(aumc_last: float, clast: float, tlast: float, lambda_z: float) -> float:
    if lambda_z <= 0.0:
        return float("nan")
    return aumc_last + clast * tlast / lambda_z + clast / (lambda_z * lambda_z)


def mrt(aumc_inf_val: float, auc_inf_val: float) -> float:
    if auc_inf_val <= 0.0 or not math.isfinite(auc_inf_val):
        return float("nan")
    return aumc_inf_val / auc_inf_val


def clearance(dose: float, auc_inf_val: float) -> float:
    if auc_inf_val <= 0.0 or not math.isfinite(auc_inf_val):
        return float("nan")
    return dose / auc_inf_val


def vz(dose: float, lambda_z: float, auc_inf_val: float) -> float:
    if lambda_z <= 0.0 or auc_inf_val <= 0.0 or not math.isfinite(auc_inf_val):
        return float("nan")
    return dose / (lambda_z * auc_inf_val)


def vd_bolus(dose: float, c0_val: float) -> float:
    if c0_val <= 0.0 or not math.isfinite(c0_val):
        return float("nan")
    return dose / c0_val


def vss(dose: float, aumc_inf_val: float, auc_inf_val: float) -> float:
    if auc_inf_val <= 0.0 or not math.isfinite(auc_inf_val):
        return float("nan")
    return dose * aumc_inf_val / (auc_inf_val * auc_inf_val)


def mrt_infusion(mrt_val: float, duration: float) -> float:
    return mrt_val - duration / 2.0


def effective_half_life(mrt_val: float) -> float:
    if not math.isfinite(mrt_val) or mrt_val <= 0.0:
        return float("nan")
    return LN2 * mrt_val


def kel(mrt_val: float) -> float:
    if not math.isfinite(mrt_val) or mrt_val <= 0.0:
        return float("nan")
    return 1.0 / mrt_val


# -- C0 cascade (calc.rs:462-540) ------------------------------------------------


def c0(profile, methods: List[C0Method], lambda_z_val: float):
    for m in methods:
        val = _try_c0(profile, m)
        if val is not None:
            return val, m
    return float("nan"), None


def _try_c0(profile, method: C0Method):
    c = profile.concentrations
    t = profile.times
    if method is C0Method.OBSERVED:
        if len(t) and abs(float(t[0])) < 1e-10 and float(c[0]) > 0.0:
            return float(c[0])
        return None
    if method is C0Method.LOG_SLOPE:
        pos = [(float(tt), float(cc)) for tt, cc in zip(t, c) if cc > 0.0][:2]
        if len(pos) < 2:
            return None
        (t1, c1), (t2, c2) = pos
        if c2 >= c1 or abs(t2 - t1) < 1e-10:
            return None
        slope = (math.log(c2) - math.log(c1)) / (t2 - t1)
        return math.exp(math.log(c1) - slope * t1)
    if method is C0Method.FIRST_CONC:
        for cc in c:
            if cc > 0.0:
                return float(cc)
        return None
    if method is C0Method.CMIN:
        pos = [float(cc) for cc in c if cc > 0.0]
        return min(pos) if pos else None
    if method is C0Method.ZERO:
        return 0.0
    return None


# -- tlag / steady-state (calc.rs:572-700) ----------------------------------------


def tlag_from_raw(times, concentrations, censoring) -> Optional[float]:
    """Time before the first concentration increase, BLQ treated as 0."""
    if len(times) < 2 or len(concentrations) < 2:
        return None
    prev = None
    for i, (c, cen) in enumerate(zip(concentrations, censoring)):
        cc = 0.0 if cen is Censor.BLOQ else c
        if prev is not None and cc > prev:
            return float(times[i - 1])
        prev = cc
    return None


def cmin(profile) -> float:
    pos = [float(c) for c in profile.concentrations if c > 0.0]
    return min(pos) if pos else 0.0


def cavg(auc_tau: float, tau: float) -> float:
    if tau <= 0.0:
        return float("nan")
    return auc_tau / tau


def fluctuation(cmax: float, cmin_val: float, cavg_val: float) -> float:
    if cavg_val <= 0.0:
        return float("nan")
    return (cmax - cmin_val) / cavg_val * 100.0


def swing(cmax: float, cmin_val: float) -> float:
    if cmin_val <= 0.0:
        return float("nan")
    return (cmax - cmin_val) / cmin_val


def peak_trough_ratio(cmax: float, cmin_val: float) -> float:
    if cmin_val <= 0.0 or not math.isfinite(cmin_val):
        return float("nan")
    return cmax / cmin_val


def time_above_concentration(times, concentrations, threshold: float) -> float:
    """Total time above threshold with interpolated crossings (calc.rs:695)."""
    t = np.asarray(times, dtype=np.float64)
    c = np.asarray(concentrations, dtype=np.float64)
    if t.shape != c.shape:
        raise ValueError("times/concentrations length mismatch")
    if t.shape[0] < 2:
        raise ValueError("insufficient data")
    total = 0.0
    for i in range(t.shape[0] - 1):
        t1, c1v, t2, c2v = t[i], c[i], t[i + 1], c[i + 1]
        dt = t2 - t1
        if c1v >= threshold and c2v >= threshold:
            total += dt
        elif c1v >= threshold and c2v < threshold:
            total += dt * (c1v - threshold) / (c1v - c2v)
        elif c1v < threshold and c2v >= threshold:
            t_cross = t1 + dt * (threshold - c1v) / (c2v - c1v)
            total += t2 - t_cross
    return float(total)
