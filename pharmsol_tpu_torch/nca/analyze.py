"""NCA orchestrator: exposure -> terminal -> clearance -> route-specific ->
steady-state -> multi-dose -> quality.

Parity with LAPKB/pharmsol src/nca/analyze.rs:42-431.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from ..data.event import Route
from . import calc
from .observation import NCAError, ObservationProfile
from .types import (
    C0Method,
    ClearanceParams,
    ExposureParams,
    IVBolusParams,
    IVInfusionParams,
    MultiDoseParams,
    NCAOptions,
    NCAResult,
    Quality,
    RegressionStats,
    RouteParams,
    SteadyStateParams,
    TerminalParams,
    Warning_,
)


@dataclass
class _Pre:
    auc_last: float
    aumc_last: float
    cmax: float
    tmax: float
    clast: float
    tlast: float

    @staticmethod
    def from_profile(profile: ObservationProfile, method) -> "_Pre":
        return _Pre(
            auc_last=profile.auc_last(method),
            aumc_last=profile.aumc_last(method),
            cmax=profile.cmax(),
            tmax=profile.tmax(),
            clast=profile.clast(),
            tlast=profile.tlast(),
        )

    def auc_inf(self, clast: float, lz: float) -> float:
        return calc.auc_inf(self.auc_last, clast, lz)

    def aumc_inf(self, clast: float, lz: float) -> float:
        return calc.aumc_inf(self.aumc_last, clast, self.tlast, lz)


@dataclass
class AnalysisContext:
    profile: ObservationProfile
    dose_amount: Optional[float]
    route: Route
    infusion_duration: Optional[float]
    options: NCAOptions
    raw_tlag: Optional[float] = None
    subject_id: Optional[str] = None
    occasion: Optional[int] = None


def analyze(ctx: AnalysisContext) -> NCAResult:
    opts = ctx.options
    pre = _Pre.from_profile(ctx.profile, opts.auc_method)

    exposure = _compute_exposure(pre, ctx.profile, opts, ctx.raw_tlag)
    terminal, lz = _compute_terminal(pre, ctx.profile, opts)

    if lz is not None:
        auc_inf_obs = pre.auc_inf(pre.clast, lz.lambda_z)
        exposure.auc_inf_obs = auc_inf_obs
        exposure.auc_pct_extrap_obs = calc.auc_extrap_pct(pre.auc_last, auc_inf_obs)
        auc_inf_pred = pre.auc_inf(lz.clast_pred, lz.lambda_z)
        exposure.auc_inf_pred = auc_inf_pred
        exposure.auc_pct_extrap_pred = calc.auc_extrap_pct(pre.auc_last, auc_inf_pred)
        if exposure.aumc_last is not None:
            exposure.aumc_inf = pre.aumc_inf(pre.clast, lz.lambda_z)

    clearance = None
    if ctx.dose_amount is not None and lz is not None and exposure.auc_inf_obs is not None:
        clearance = _compute_clearance(
            ctx.dose_amount, exposure.auc_inf_obs, lz.lambda_z, ctx.route, pre
        )

    route_params = _compute_route_specific(
        pre, ctx.profile, ctx.dose_amount, ctx.route, ctx.infusion_duration, lz, opts
    )

    steady_state = (
        _compute_steady_state(pre, ctx.profile, opts.tau, opts) if opts.tau else None
    )

    if ctx.dose_amount is not None and ctx.dose_amount > 0.0:
        d = ctx.dose_amount
        exposure.cmax_dn = exposure.cmax / d
        exposure.auc_last_dn = exposure.auc_last / d
        if exposure.auc_inf_obs is not None:
            exposure.auc_inf_dn = exposure.auc_inf_obs / d

    multi_dose = _compute_multi_dose(ctx.profile, opts)
    quality = _build_quality(exposure, terminal, lz, opts)

    return NCAResult(
        subject_id=ctx.subject_id,
        occasion=ctx.occasion,
        dose_amount=ctx.dose_amount,
        route=ctx.route,
        infusion_duration=ctx.infusion_duration,
        exposure=exposure,
        terminal=terminal,
        clearance=clearance,
        route_params=route_params,
        steady_state=steady_state,
        multi_dose=multi_dose,
        quality=quality,
    )


def _compute_exposure(pre, profile, options, raw_tlag) -> ExposureParams:
    auc_partial = None
    if options.auc_interval is not None:
        start, end = options.auc_interval
        auc_partial = profile.auc_interval(start, end, options.auc_method)
    tfirst = None
    for t, c in zip(profile.times, profile.concentrations):
        if c > 0.0:
            tfirst = float(t)
            break
    time_above = None
    if options.concentration_threshold is not None:
        time_above = calc.time_above_concentration(
            profile.times, profile.concentrations, options.concentration_threshold
        )
    return ExposureParams(
        cmax=pre.cmax,
        tmax=pre.tmax,
        clast=pre.clast,
        tlast=pre.tlast,
        tfirst=tfirst,
        auc_last=pre.auc_last,
        auc_partial=auc_partial,
        aumc_last=pre.aumc_last,
        tlag=raw_tlag,
        time_above_mic=time_above,
    )


def _compute_terminal(pre, profile, options):
    lz = calc.lambda_z(profile, options.lambda_z)
    if lz is None:
        return None, None
    hl = calc.half_life(lz.lambda_z)
    auc_inf_val = pre.auc_inf(pre.clast, lz.lambda_z)
    aumc_inf_val = pre.aumc_inf(pre.clast, lz.lambda_z)
    mrt_val = calc.mrt(aumc_inf_val, auc_inf_val)
    eff_hl = calc.effective_half_life(mrt_val) if math.isfinite(mrt_val) and mrt_val > 0 else None
    kel_val = calc.kel(mrt_val) if math.isfinite(mrt_val) and mrt_val > 0 else None
    span = lz.time_last - lz.time_first
    stats = RegressionStats(
        r_squared=lz.r_squared,
        adj_r_squared=lz.adj_r_squared,
        corrxy=lz.corrxy,
        n_points=lz.n_points,
        time_first=lz.time_first,
        time_last=lz.time_last,
        span_ratio=span / hl,
    )
    terminal = TerminalParams(
        lambda_z=lz.lambda_z,
        half_life=hl,
        mrt=mrt_val,
        effective_half_life=eff_hl,
        kel=kel_val,
        regression=stats,
    )
    return terminal, lz


def _compute_clearance(dose, auc_inf_val, lambda_z, route, pre) -> ClearanceParams:
    cl = calc.clearance(dose, auc_inf_val)
    vz_val = calc.vz(dose, lambda_z, auc_inf_val)
    vss_val = None
    if route in (Route.IV_BOLUS, Route.IV_INFUSION):
        a_inf = pre.auc_inf(pre.clast, lambda_z)
        am_inf = pre.aumc_inf(pre.clast, lambda_z)
        vss_val = calc.vss(dose, am_inf, a_inf)
    return ClearanceParams(cl_f=cl, vz_f=vz_val, vss=vss_val)


def _compute_route_specific(
    pre, profile, dose_amount, route, infusion_duration, lz, options
) -> Optional[RouteParams]:
    if route is Route.IV_BOLUS:
        lz_val = lz.lambda_z if lz is not None else float("nan")
        c0_val, method = calc.c0(profile, options.c0_methods, lz_val)
        vd = calc.vd_bolus(dose_amount, c0_val) if dose_amount is not None else float("nan")
        return RouteParams.iv_bolus(IVBolusParams(c0=c0_val, vd=vd, c0_method=method))
    if route is Route.IV_INFUSION:
        duration = infusion_duration or 0.0
        mrt_iv = None
        if lz is not None:
            a_inf = pre.auc_inf(pre.clast, lz.lambda_z)
            am_inf = pre.aumc_inf(pre.clast, lz.lambda_z)
            mrt_iv = calc.mrt_infusion(calc.mrt(am_inf, a_inf), duration)
        ceoi = None
        if duration > 0.0:
            try:
                ceoi = profile.interpolate(duration)
            except Exception:
                ceoi = None
        return RouteParams.iv_infusion(
            IVInfusionParams(infusion_duration=duration, mrt_iv=mrt_iv, ceoi=ceoi)
        )
    return RouteParams.extravascular()


def _compute_steady_state(pre, profile, tau, options) -> SteadyStateParams:
    cmin_val = calc.cmin(profile)
    auc_tau = profile.auc_interval(0.0, tau, options.auc_method)
    cavg_val = calc.cavg(auc_tau, tau)
    return SteadyStateParams(
        tau=tau,
        auc_tau=auc_tau,
        cmin=cmin_val,
        cmax_ss=pre.cmax,
        cavg=cavg_val,
        fluctuation=calc.fluctuation(pre.cmax, cmin_val, cavg_val),
        swing=calc.swing(pre.cmax, cmin_val),
        peak_trough_ratio=calc.peak_trough_ratio(pre.cmax, cmin_val),
        accumulation=None,
    )


def _compute_multi_dose(profile, options) -> Optional[MultiDoseParams]:
    if not options.dose_times:
        return None
    times = sorted(options.dose_times)
    if not len(profile.times):
        return None
    last_obs = float(profile.times[-1])
    aucs, cmaxes, tmaxes = [], [], []
    for i, start in enumerate(times):
        end = times[i + 1] if i + 1 < len(times) else last_obs
        aucs.append(profile.auc_interval(start, end, options.auc_method))
        cmax, tmax = _cmax_tmax_in_window(profile, start, end)
        cmaxes.append(cmax)
        tmaxes.append(tmax)
    return MultiDoseParams(
        dose_times=times,
        auc_intervals=aucs,
        cmax_intervals=cmaxes,
        tmax_intervals=tmaxes,
    )


def _cmax_tmax_in_window(profile, start, end):
    cmax = -math.inf
    tmax = start
    for t, c in zip(profile.times, profile.concentrations):
        if start <= t <= end and c > cmax:
            cmax = float(c)
            tmax = float(t)
    return (0.0, start) if cmax == -math.inf else (cmax, tmax)


def _build_quality(exposure, terminal, lz, options) -> Quality:
    warnings: List[Warning_] = []
    if exposure.cmax <= 0.0:
        warnings.append(Warning_.low_cmax())
    if exposure.auc_inf_obs is not None and lz is not None:
        pct = calc.auc_extrap_pct(exposure.auc_last, exposure.auc_inf_obs)
        if pct > options.max_auc_extrap_pct:
            warnings.append(Warning_.high_extrapolation(pct, options.max_auc_extrap_pct))
        if terminal is not None and terminal.regression is not None:
            if terminal.regression.span_ratio < options.lambda_z.min_span_ratio:
                warnings.append(
                    Warning_.short_terminal_phase(
                        terminal.regression.span_ratio, options.lambda_z.min_span_ratio
                    )
                )
        if lz.r_squared < options.lambda_z.min_r_squared:
            warnings.append(Warning_.poor_fit(lz.r_squared, options.lambda_z.min_r_squared))
    else:
        warnings.append(Warning_.lambda_z_not_estimable())
    return Quality(warnings=warnings)
