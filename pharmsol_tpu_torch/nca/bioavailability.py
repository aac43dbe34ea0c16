"""Bioavailability / bioequivalence comparisons.

Parity with LAPKB/pharmsol src/nca/bioavailability.rs:

- ``bioavailability``: dose-normalized AUC ratios (F) for AUClast / AUCinf;
- ``bioequivalence``: geometric mean ratio with a t-based CI on the log
  scale across (test, reference) pairs;
- ``metabolite_parent_ratio``; ``compare`` for ad-hoc parameter ratios.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import NCAResult


@dataclass
class BioavailabilityResult:
    f_auc_inf: Optional[float]
    f_auc_last: float
    test_auc_inf_dn: Optional[float]
    ref_auc_inf_dn: Optional[float]
    test_auc_last_dn: float
    ref_auc_last_dn: float


def bioavailability(test: NCAResult, reference: NCAResult) -> Optional[BioavailabilityResult]:
    if not test.dose_amount or test.dose_amount <= 0:
        return None
    if not reference.dose_amount or reference.dose_amount <= 0:
        return None
    t_dn = test.exposure.auc_last / test.dose_amount
    r_dn = reference.exposure.auc_last / reference.dose_amount
    f_last = t_dn / r_dn if r_dn > 0 else float("nan")

    f_inf = t_inf_dn = r_inf_dn = None
    if test.exposure.auc_inf_obs is not None and reference.exposure.auc_inf_obs is not None:
        t_inf_dn = test.exposure.auc_inf_obs / test.dose_amount
        r_inf_dn = reference.exposure.auc_inf_obs / reference.dose_amount
        f_inf = t_inf_dn / r_inf_dn if r_inf_dn > 0 else float("nan")

    return BioavailabilityResult(
        f_auc_inf=f_inf,
        f_auc_last=f_last,
        test_auc_inf_dn=t_inf_dn,
        ref_auc_inf_dn=r_inf_dn,
        test_auc_last_dn=t_dn,
        ref_auc_last_dn=r_dn,
    )


@dataclass
class BioequivalenceResult:
    n: int
    gmr_auc_last: float
    ci_lower_auc_last: float
    ci_upper_auc_last: float
    gmr_auc_inf: Optional[float]
    ci_lower_auc_inf: Optional[float]
    ci_upper_auc_inf: Optional[float]
    ci_level: float
    individual_f: List[float]


def _t_quantile(p: float, df: float) -> float:
    from scipy.stats import t as t_dist

    return float(t_dist.ppf(p, df))


def _log_ci(values: Sequence[float], ci_level: float):
    n = len(values)
    ln = np.log(np.asarray(values))
    mean_ln = float(np.mean(ln))
    var_ln = float(np.var(ln, ddof=1))
    se = math.sqrt(var_ln / n)
    t_crit = _t_quantile(1.0 - (1.0 - ci_level) / 2.0, n - 1)
    return math.exp(mean_ln), math.exp(mean_ln - t_crit * se), math.exp(mean_ln + t_crit * se)


def bioequivalence(
    pairs: Sequence[Tuple[NCAResult, NCAResult]], ci_level: float = 0.90
) -> Optional[BioequivalenceResult]:
    f_values = []
    f_inf_values = []
    for test, ref in pairs:
        ba = bioavailability(test, ref)
        if ba is None:
            continue
        if math.isfinite(ba.f_auc_last) and ba.f_auc_last > 0:
            f_values.append(ba.f_auc_last)
        if ba.f_auc_inf is not None and math.isfinite(ba.f_auc_inf) and ba.f_auc_inf > 0:
            f_inf_values.append(ba.f_auc_inf)
    if len(f_values) < 2:
        return None
    gmr, lo, hi = _log_ci(f_values, ci_level)
    if len(f_inf_values) >= 2:
        gmr_i, lo_i, hi_i = _log_ci(f_inf_values, ci_level)
    else:
        gmr_i = lo_i = hi_i = None
    return BioequivalenceResult(
        n=len(f_values),
        gmr_auc_last=gmr,
        ci_lower_auc_last=lo,
        ci_upper_auc_last=hi,
        gmr_auc_inf=gmr_i,
        ci_lower_auc_inf=lo_i,
        ci_upper_auc_inf=hi_i,
        ci_level=ci_level,
        individual_f=f_values,
    )


def metabolite_parent_ratio(parent: NCAResult, metabolite: NCAResult) -> Dict[str, float]:
    ratios: Dict[str, float] = {}
    if parent.exposure.auc_last > 0:
        ratios["auc_last_ratio"] = metabolite.exposure.auc_last / parent.exposure.auc_last
    if (
        parent.exposure.auc_inf_obs is not None
        and metabolite.exposure.auc_inf_obs is not None
        and parent.exposure.auc_inf_obs > 0
    ):
        ratios["auc_inf_ratio"] = metabolite.exposure.auc_inf_obs / parent.exposure.auc_inf_obs
    if parent.exposure.cmax > 0:
        ratios["cmax_ratio"] = metabolite.exposure.cmax / parent.exposure.cmax
    return ratios


def compare(a: NCAResult, b: NCAResult) -> Dict[str, float]:
    """Ratios (a / b) for every parameter the two results share."""
    pa = a.to_params()
    pb = b.to_params()
    out: Dict[str, float] = {}
    for name, va in pa.items():
        vb = pb.get(name)
        if vb is not None and vb != 0.0:
            out[name] = va / vb
    return out
