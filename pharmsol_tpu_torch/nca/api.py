"""NCA entry points: .nca() / .nca_all() / nca_grouped() + dose detection.

Parity with LAPKB/pharmsol src/nca/traits.rs:

- ``nca(subject)`` analyzes the first occasion; ``nca_all`` every occasion;
- ``nca_grouped(data)`` returns per-subject grouped results with isolated
  per-occasion errors (SubjectNCAResult);
- ``nca_with_dose`` overrides the auto-detected dose/route/duration;
- dose detection from events (structs.rs:878-978): any infusion ->
  IVInfusion; any bolus into input 0 -> Extravascular; else IVBolus.

The reference parallelizes with rayon; profiles here are tiny host-side
arrays and the batch loop is vectorized numpy per profile, so a plain loop
over subjects is bandwidth-trivial. Methods are attached to Subject /
Occasion / Data for reference API parity.
"""

from __future__ import annotations

from typing import List, Optional

from ..data.event import Infusion as _Infusion, Bolus as _Bolus, Route
from ..data.structs import Data, Occasion, Subject
from .analyze import AnalysisContext, analyze
from .calc import tlag_from_raw
from .observation import NCAError, ObservationProfile, get_observations
from .types import NCAOptions, NCAResult, SubjectNCAResult


# -- dose detection (structs.rs:878-978) ---------------------------------------


def total_dose(occasion: Occasion) -> float:
    return sum(
        e.amount for e in occasion.events if isinstance(e, (_Bolus, _Infusion))
    )


def detect_route(occasion: Occasion) -> Route:
    has_infusion = has_extravascular = has_dose = False
    for e in occasion.events:
        if isinstance(e, _Infusion):
            has_infusion = True
            has_dose = True
        elif isinstance(e, _Bolus):
            has_dose = True
            if (e.input_index() or 0) == 0:
                has_extravascular = True
    if not has_dose:
        return Route.EXTRAVASCULAR
    if has_infusion:
        return Route.IV_INFUSION
    if has_extravascular:
        return Route.EXTRAVASCULAR
    return Route.IV_BOLUS


def detect_routes(occasion: Occasion) -> List[Route]:
    has_infusion = has_extravascular = has_iv_bolus = False
    for e in occasion.events:
        if isinstance(e, _Infusion):
            has_infusion = True
        elif isinstance(e, _Bolus):
            if (e.input_index() or 0) == 0:
                has_extravascular = True
            else:
                has_iv_bolus = True
    routes = []
    if has_infusion:
        routes.append(Route.IV_INFUSION)
    if has_iv_bolus:
        routes.append(Route.IV_BOLUS)
    if has_extravascular:
        routes.append(Route.EXTRAVASCULAR)
    return routes


def detect_infusion_duration(occasion: Occasion) -> Optional[float]:
    for e in occasion.events:
        if isinstance(e, _Infusion):
            return e.duration
    return None


# -- core per-occasion analysis -------------------------------------------------


def nca_occasion(
    occasion: Occasion, options: NCAOptions, subject_id: Optional[str] = None
) -> NCAResult:
    profile = ObservationProfile.from_occasion(occasion, options.outeq, options.blq_rule)
    times, concs, censoring = get_observations(occasion, options.outeq)
    raw_tlag = tlag_from_raw(times, concs, censoring)

    d = total_dose(occasion)
    dose_amount = d if d > 0.0 else None
    route = options.route_override or detect_route(occasion)
    infusion_duration = detect_infusion_duration(occasion)

    result = analyze(
        AnalysisContext(
            profile=profile,
            dose_amount=dose_amount,
            route=route,
            infusion_duration=infusion_duration,
            options=options,
            raw_tlag=raw_tlag,
            subject_id=subject_id,
            occasion=occasion.index,
        )
    )
    routes = detect_routes(occasion)
    if len(routes) > 1 and options.route_override is None:
        from .types import Warning_

        result.quality.warnings.append(Warning_.mixed_routes(routes))
    return result


def nca_with_dose(
    occasion: Occasion,
    dose_amount: float,
    route: Route,
    infusion_duration: Optional[float],
    options: NCAOptions,
) -> NCAResult:
    profile = ObservationProfile.from_occasion(occasion, options.outeq, options.blq_rule)
    times, concs, censoring = get_observations(occasion, options.outeq)
    raw_tlag = tlag_from_raw(times, concs, censoring)
    return analyze(
        AnalysisContext(
            profile=profile,
            dose_amount=dose_amount,
            route=route,
            infusion_duration=infusion_duration,
            options=options,
            raw_tlag=raw_tlag,
            subject_id=None,
            occasion=occasion.index,
        )
    )


# -- public functions over Subject/Occasion/Data ----------------------------------


def nca(target, options: Optional[NCAOptions] = None) -> NCAResult:
    options = options or NCAOptions()
    if isinstance(target, Occasion):
        return nca_occasion(target, options)
    if isinstance(target, Subject):
        occs = target.occasions()
        if not occs:
            raise NCAError("subject has no occasions")
        return nca_occasion(occs[0], options, target.id)
    if isinstance(target, Data):
        subs = target.subjects()
        if not subs:
            raise NCAError("data has no subjects")
        return nca(subs[0], options)
    raise TypeError(f"cannot run NCA on {type(target)}")


def nca_all(target, options: Optional[NCAOptions] = None) -> List:
    options = options or NCAOptions()
    results: List = []
    if isinstance(target, Occasion):
        targets = [(None, target)]
    elif isinstance(target, Subject):
        targets = [(target.id, occ) for occ in target.occasions()]
    elif isinstance(target, Data):
        targets = [
            (s.id, occ) for s in target.subjects() for occ in s.occasions()
        ]
    else:
        raise TypeError(f"cannot run NCA on {type(target)}")
    for sid, occ in targets:
        try:
            results.append(nca_occasion(occ, options, sid))
        except Exception as e:  # isolate per-occasion failures
            results.append(e)
    return results


def nca_grouped(data: Data, options: Optional[NCAOptions] = None) -> List[SubjectNCAResult]:
    options = options or NCAOptions()
    grouped = []
    for subject in data.subjects():
        occ_results: List = []
        for occ in subject.occasions():
            try:
                occ_results.append(nca_occasion(occ, options, subject.id))
            except Exception as e:
                occ_results.append(e)
        grouped.append(SubjectNCAResult(subject_id=subject.id, occasions=occ_results))
    return grouped


# -- attach reference-parity methods -------------------------------------------------


def _occ_nca(self, options=None):
    return nca(self, options)


def _occ_nca_all(self, options=None):
    return nca_all(self, options)


def _occ_nca_with_dose(self, dose_amount, route, infusion_duration, options=None):
    return nca_with_dose(self, dose_amount, route, infusion_duration, options or NCAOptions())


def _subject_nca_with_dose(self, dose_amount, route, infusion_duration, options=None):
    occs = self.occasions()
    if not occs:
        raise NCAError("subject has no occasions")
    return nca_with_dose(occs[0], dose_amount, route, infusion_duration, options or NCAOptions())


Occasion.nca = _occ_nca
Occasion.nca_all = _occ_nca_all
Occasion.nca_with_dose = _occ_nca_with_dose
Occasion.total_dose = total_dose
Occasion.route = detect_route
Occasion.routes = detect_routes
Occasion.infusion_duration = detect_infusion_duration
Subject.nca = _occ_nca
Subject.nca_all = _occ_nca_all
Subject.nca_with_dose = _subject_nca_with_dose
Data.nca = _occ_nca
Data.nca_all = _occ_nca_all
Data.nca_grouped = lambda self, options=None: nca_grouped(self, options)


def _superposition(self, tau, options=None, n_eval_points=None):
    from .superposition import superposition as _sp

    return _sp(self, tau, options, n_eval_points)


Subject.superposition = _superposition
Occasion.superposition = _superposition
