"""Population summaries and CSV export for NCA results.

Parity with LAPKB/pharmsol src/nca/summary.rs: per-parameter descriptive
stats (mean/sd/CV/median/geomean/geoCV/percentiles) over
``NCAResult.to_params()`` and a union-of-columns CSV.
"""

from __future__ import annotations

import io
import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .types import NCAResult


@dataclass
class ParameterSummary:
    name: str
    n: int
    mean: float
    sd: float
    cv_pct: float
    median: float
    min: float
    max: float
    geo_mean: float
    geo_cv_pct: float
    p5: float
    p25: float
    p75: float
    p95: float


@dataclass
class PopulationSummary:
    n_subjects: int
    parameters: List[ParameterSummary]

    def get(self, name: str):
        for p in self.parameters:
            if p.name == name:
                return p
        return None


def _summary(name: str, values: Sequence[float]) -> ParameterSummary:
    v = np.asarray([x for x in values if math.isfinite(x)], dtype=np.float64)
    n = v.shape[0]
    if n == 0:
        nan = float("nan")
        return ParameterSummary(name, 0, nan, nan, nan, nan, nan, nan, nan, nan, nan, nan, nan, nan)
    mean = float(np.mean(v))
    sd = float(np.std(v, ddof=1)) if n > 1 else 0.0
    cv = sd / mean * 100.0 if mean != 0.0 else float("nan")
    if np.all(v > 0.0):
        ln = np.log(v)
        geo_mean = float(np.exp(np.mean(ln)))
        geo_sd2 = float(np.var(ln, ddof=1)) if n > 1 else 0.0
        geo_cv = math.sqrt(math.exp(geo_sd2) - 1.0) * 100.0
    else:
        geo_mean = float("nan")
        geo_cv = float("nan")
    return ParameterSummary(
        name=name,
        n=n,
        mean=mean,
        sd=sd,
        cv_pct=cv,
        median=float(np.median(v)),
        min=float(np.min(v)),
        max=float(np.max(v)),
        geo_mean=geo_mean,
        geo_cv_pct=geo_cv,
        p5=float(np.percentile(v, 5)),
        p25=float(np.percentile(v, 25)),
        p75=float(np.percentile(v, 75)),
        p95=float(np.percentile(v, 95)),
    )


def summarize(results: Sequence[NCAResult]) -> PopulationSummary:
    if not results:
        return PopulationSummary(0, [])
    all_params = {}
    for r in results:
        for name, value in r.to_params().items():
            all_params.setdefault(name, []).append(value)
    parameters = [_summary(name, vals) for name, vals in sorted(all_params.items())]
    return PopulationSummary(n_subjects=len(results), parameters=parameters)


def nca_to_csv(results: Sequence[NCAResult]) -> str:
    if not results:
        return ""
    param_maps = [r.to_params() for r in results]
    names = sorted({name for p in param_maps for name in p})
    buf = io.StringIO()
    buf.write("subject_id,occasion")
    for n in names:
        buf.write(f",{n}")
    buf.write("\n")
    for r, params in zip(results, param_maps):
        buf.write(r.subject_id or "")
        buf.write(",")
        buf.write("" if r.occasion is None else str(r.occasion))
        for n in names:
            v = params.get(n)
            buf.write("," + (f"{v}" if v is not None else ""))
        buf.write("\n")
    return buf.getvalue()
