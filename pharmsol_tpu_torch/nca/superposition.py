"""Steady-state prediction by superposition of a single-dose profile.

Parity with LAPKB/pharmsol src/nca/superposition.rs: sum shifted copies of
the single-dose profile (interpolated within the observed range, terminal
mono-exponential beyond Tlast) until the incremental contribution falls
below 1e-10 of the running maximum (max 1000 doses).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .observation import NCAError, ObservationProfile
from .types import NCAOptions, NCAResult


@dataclass
class SuperpositionResult:
    times: List[float]
    concentrations: List[float]
    cmax_ss: float
    tmax_ss: float
    cmin_ss: float
    auc_tau_ss: float
    cavg_ss: float
    n_doses: int
    accumulation_ratio: float


def _conc_at(profile: ObservationProfile, clast, tlast, lambda_z, time: float) -> float:
    if time < 0.0:
        return 0.0
    if time <= tlast:
        try:
            return profile.interpolate(time)
        except Exception:
            return 0.0
    return clast * math.exp(-lambda_z * (time - tlast))


def _trap(times, concs) -> float:
    t = np.asarray(times)
    c = np.asarray(concs)
    return float(np.sum((c[:-1] + c[1:]) / 2.0 * np.diff(t)))


def predict(
    profile: ObservationProfile,
    lambda_z: float,
    tau: float,
    n_eval_points: Optional[int] = None,
) -> Optional[SuperpositionResult]:
    if lambda_z <= 0.0 or not math.isfinite(lambda_z) or tau <= 0.0 or not len(profile.times):
        return None
    clast = profile.clast()
    tlast = profile.tlast()

    if n_eval_points is not None and n_eval_points >= 2:
        eval_times = [i * tau / (n_eval_points - 1) for i in range(n_eval_points)]
    else:
        eval_times = [float(t) for t in profile.times if 0.0 <= t <= tau]
        if not eval_times or abs(eval_times[-1] - tau) > 1e-10:
            eval_times.append(tau)
        if eval_times[0] > 0.0:
            eval_times.insert(0, 0.0)

    tolerance = 1e-10
    max_doses = 1000
    ss = np.zeros(len(eval_times))
    n_doses = 0
    for k in range(max_doses):
        contrib = np.asarray(
            [_conc_at(profile, clast, tlast, lambda_z, t + k * tau) for t in eval_times]
        )
        ss += contrib
        n_doses = k + 1
        if k > 0 and float(np.max(contrib)) < tolerance * float(np.max(ss)):
            break

    cmax_idx = int(np.argmax(ss))
    positives = ss[ss > 0.0]
    cmin_ss = float(np.min(positives)) if positives.size else 0.0
    auc_tau_ss = _trap(eval_times, ss)
    cavg_ss = auc_tau_ss / tau if tau > 0 else 0.0
    single = _trap(
        eval_times,
        [_conc_at(profile, clast, tlast, lambda_z, min(t, tau)) for t in eval_times],
    )
    accumulation = auc_tau_ss / single if single > 0.0 else float("nan")

    return SuperpositionResult(
        times=list(map(float, eval_times)),
        concentrations=list(map(float, ss)),
        cmax_ss=float(ss[cmax_idx]),
        tmax_ss=float(eval_times[cmax_idx]),
        cmin_ss=cmin_ss,
        auc_tau_ss=auc_tau_ss,
        cavg_ss=cavg_ss,
        n_doses=n_doses,
        accumulation_ratio=accumulation,
    )


def predict_from_nca(
    profile: ObservationProfile,
    nca_result: NCAResult,
    tau: float,
    n_eval_points: Optional[int] = None,
) -> SuperpositionResult:
    if nca_result.terminal is None:
        raise NCAError("superposition requires a terminal phase (lambda-z)")
    result = predict(profile, nca_result.terminal.lambda_z, tau, n_eval_points)
    if result is None:
        raise NCAError("superposition prediction failed")
    return result


def superposition(subject_or_occasion, tau: float, options: Optional[NCAOptions] = None,
                  n_eval_points: Optional[int] = None) -> SuperpositionResult:
    """Run NCA then superposition on the first occasion."""
    from .api import nca

    options = options or NCAOptions()
    result = nca(subject_or_occasion, options)
    from ..data.structs import Subject

    occ = (
        subject_or_occasion.occasions()[0]
        if isinstance(subject_or_occasion, Subject)
        else subject_or_occasion
    )
    profile = ObservationProfile.from_occasion(occ, options.outeq, options.blq_rule)
    return predict_from_nca(profile, result, tau, n_eval_points)
