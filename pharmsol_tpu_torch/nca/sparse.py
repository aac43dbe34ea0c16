"""Sparse/destructive-sampling population AUC (Bailer's method).

Parity with LAPKB/pharmsol src/nca/sparse.rs:73-204: group observations by
nominal time (within tolerance), trapezoid on the mean concentrations,
variance-propagated SE with trapezoid weights, 95% normal-approximation CI.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..data.structs import Data


@dataclass
class SparsePKResult:
    auc: float
    auc_se: float
    auc_ci_lower: float
    auc_ci_upper: float
    n_timepoints: int
    mean_concentrations: List[float]
    n_per_timepoint: List[int]
    times: List[float]


def sparse_auc(times, concentrations, time_tolerance: Optional[float] = None):
    times = list(map(float, times))
    concentrations = list(map(float, concentrations))
    if not times or len(times) != len(concentrations):
        return None
    tol = time_tolerance or 0.0

    groups: List[tuple] = []  # (time, [concs])
    for idx in sorted(range(len(times)), key=lambda i: times[i]):
        t, c = times[idx], concentrations[idx]
        for g in groups:
            if abs(t - g[0]) <= tol:
                g[1].append(c)
                break
        else:
            groups.append((t, [c]))
    groups.sort(key=lambda g: g[0])
    if len(groups) < 2:
        return None

    gt = np.asarray([g[0] for g in groups])
    means = np.asarray([float(np.mean(g[1])) for g in groups])
    variances = np.asarray(
        [float(np.var(g[1], ddof=1)) if len(g[1]) >= 2 else 0.0 for g in groups]
    )
    n_per = [len(g[1]) for g in groups]

    dt = np.diff(gt)
    auc = float(np.sum((means[:-1] + means[1:]) / 2.0 * dt))

    weights = np.zeros(len(groups))
    weights[:-1] += dt / 2.0
    weights[1:] += dt / 2.0
    auc_var = float(np.sum(weights**2 * variances / np.asarray(n_per, dtype=np.float64)))
    se = math.sqrt(auc_var)
    z = 1.96
    return SparsePKResult(
        auc=auc,
        auc_se=se,
        auc_ci_lower=auc - z * se,
        auc_ci_upper=auc + z * se,
        n_timepoints=len(groups),
        mean_concentrations=list(map(float, means)),
        n_per_timepoint=n_per,
        times=list(map(float, gt)),
    )


def sparse_auc_from_data(data: Data, outeq: int = 0, time_tolerance=None):
    """Pool every subject/occasion's observations for one outeq, then Bailer."""
    times: List[float] = []
    concs: List[float] = []
    for subject in data:
        for occ in subject.occasions():
            for obs in occ.observations():
                if obs.outeq_index() == outeq and obs.value is not None:
                    times.append(obs.time)
                    concs.append(obs.value)
    return sparse_auc(times, concs, time_tolerance)
