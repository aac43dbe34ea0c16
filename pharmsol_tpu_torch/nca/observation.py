"""Observation profiles: BLQ-filtered time/concentration arrays.

Parity with LAPKB/pharmsol src/nca/observation.rs:

- BLQ rules: Zero (keep as 0), LoqOver2 (keep value/2), Exclude (drop),
  Positional (keep leading/trailing as 0, drop middle), TmaxRelative
  (keep-as-0 flags before/after Tmax);
- profile invalid when fewer than 2 points survive or all are <= 0;
- cmax/cmin at the FIRST occurrence (PKNCA tie-breaking), tlast at the
  last positive concentration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..data import auc as aucmod
from ..data.event import AUCMethod, BLQRule, Censor
from ..errors import DataError
from .types import TmaxRelative


class NCAError(DataError):
    pass


@dataclass
class ObservationProfile:
    times: np.ndarray
    concentrations: np.ndarray
    cmax_idx: int
    cmin_idx: int
    tlast_idx: int

    # -- accessors -----------------------------------------------------------
    def cmax(self) -> float:
        return float(self.concentrations[self.cmax_idx])

    def tmax(self) -> float:
        return float(self.times[self.cmax_idx])

    def cmin(self) -> float:
        return float(self.concentrations[self.cmin_idx])

    def clast(self) -> float:
        return float(self.concentrations[self.tlast_idx])

    def tlast(self) -> float:
        return float(self.times[self.tlast_idx])

    def __len__(self) -> int:
        return int(self.times.shape[0])

    # -- AUC delegation --------------------------------------------------------
    def auc_last(self, method: AUCMethod) -> float:
        end = self.tlast_idx + 1
        return aucmod.auc(self.times[:end], self.concentrations[:end], method)

    def auc_interval(self, start: float, end: float, method: AUCMethod) -> float:
        return aucmod.auc_interval(self.times, self.concentrations, start, end, method)

    def aumc_last(self, method: AUCMethod) -> float:
        end = self.tlast_idx + 1
        return aucmod.aumc(self.times[:end], self.concentrations[:end], method)

    def interpolate(self, time: float) -> float:
        return aucmod.interpolate_linear(self.times, self.concentrations, time)

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_occasion(occasion, outeq: int, blq_rule) -> "ObservationProfile":
        times, concs, censoring = get_observations(occasion, outeq)
        return ObservationProfile.from_arrays(times, concs, censoring, blq_rule)

    @staticmethod
    def from_arrays(times, concentrations, censoring, blq_rule) -> "ObservationProfile":
        times = list(times)
        concentrations = list(concentrations)
        censoring = list(censoring)
        if not (len(times) == len(concentrations) == len(censoring)):
            raise NCAError("times/concentrations/censoring length mismatch")
        if not times:
            raise NCAError("insufficient data: 0 points, need 2")
        for i in range(1, len(times)):
            if times[i] < times[i - 1]:
                raise NCAError("invalid time sequence")

        tfirst_idx = tlast_idx = None
        if blq_rule is BLQRule.POSITIONAL:
            tfirst_idx, tlast_idx = _find_tfirst_tlast(concentrations, censoring)
        tmax_idx = None
        if isinstance(blq_rule, TmaxRelative) or blq_rule is BLQRule.TMAX_RELATIVE:
            tmax_idx = _find_tmax_idx(concentrations, censoring)
        if blq_rule is BLQRule.TMAX_RELATIVE:
            blq_rule = TmaxRelative()

        proc_t: List[float] = []
        proc_c: List[float] = []
        for i, (t, c, cen) in enumerate(zip(times, concentrations, censoring)):
            if cen is Censor.BLOQ:
                if blq_rule is BLQRule.ZERO:
                    proc_t.append(t)
                    proc_c.append(0.0)
                elif blq_rule is BLQRule.LOQ_OVER_2:
                    proc_t.append(t)
                    proc_c.append(c / 2.0)
                elif blq_rule is BLQRule.EXCLUDE:
                    pass
                elif blq_rule is BLQRule.POSITIONAL:
                    # keep leading (before tfirst) and trailing (after tlast)
                    # BLQ points as zero; drop embedded ones
                    keep = (
                        tfirst_idx is None
                        or i < tfirst_idx
                        or (tlast_idx is not None and i > tlast_idx)
                    )
                    if keep:
                        proc_t.append(t)
                        proc_c.append(0.0)
                elif isinstance(blq_rule, TmaxRelative):
                    before = tmax_idx is None or i < tmax_idx
                    keep = blq_rule.before_tmax_keep if before else blq_rule.after_tmax_keep
                    if keep:
                        proc_t.append(t)
                        proc_c.append(0.0)
                else:
                    raise NCAError(f"unknown BLQ rule {blq_rule!r}")
            else:
                proc_t.append(t)
                proc_c.append(c)

        return _finalize(proc_t, proc_c)


def _find_tfirst_tlast(concentrations, censoring):
    tfirst = tlast = None
    for i, (c, cen) in enumerate(zip(concentrations, censoring)):
        if cen is not Censor.BLOQ and c > 0.0:
            if tfirst is None:
                tfirst = i
            tlast = i
    return tfirst, tlast


def _find_tmax_idx(concentrations, censoring) -> Optional[int]:
    best = None
    best_c = -np.inf
    for i, (c, cen) in enumerate(zip(concentrations, censoring)):
        if cen is not Censor.BLOQ and c > best_c:
            best_c = c
            best = i
    return best


def _finalize(proc_t, proc_c) -> ObservationProfile:
    if len(proc_t) < 2:
        raise NCAError(f"insufficient data: {len(proc_t)} points, need 2")
    c = np.asarray(proc_c, dtype=np.float64)
    t = np.asarray(proc_t, dtype=np.float64)
    if np.all(c <= 0.0):
        raise NCAError("all concentrations below LOQ")
    cmax_idx = int(np.argmax(c))  # first occurrence of max (PKNCA)
    cmin_idx = int(np.argmin(c))
    positive = np.nonzero(c > 0.0)[0]
    tlast_idx = int(positive[-1]) if positive.size else len(c) - 1
    return ObservationProfile(t, c, cmax_idx, cmin_idx, tlast_idx)


def get_observations(occasion, outeq):
    """Extract (times, concs, censoring) for one output equation
    (structs.rs:993-1011 — missing values are skipped).

    ``outeq`` may be a numeric index or a string label. Divergence from the
    reference: a numeric ``outeq`` that matches nothing falls back to the
    occasion's sole distinct label when there is exactly one — the
    reference's own README NCA example (observations labelled "cp" with
    the default ``outeq: 0``) returns "insufficient data" upstream because
    string labels never parse as indices (event.rs:616-618).
    """
    def collect(match):
        times, concs, censoring = [], [], []
        for obs in occasion.observations():
            if match(obs) and obs.value is not None:
                times.append(obs.time)
                concs.append(obs.value)
                censoring.append(obs.censoring)
        return times, concs, censoring

    if isinstance(outeq, str) and not outeq.isdigit():
        return collect(lambda o: str(o.outeq) == outeq)
    idx = int(outeq)
    times, concs, censoring = collect(lambda o: o.outeq_index() == idx)
    if not times:
        labels = {str(o.outeq) for o in occasion.observations()}
        if len(labels) == 1:
            (label,) = labels
            return collect(lambda o: str(o.outeq) == label)
    return times, concs, censoring
