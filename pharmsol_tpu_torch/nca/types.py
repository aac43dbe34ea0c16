"""NCA types: options, results, quality diagnostics.

Parity with LAPKB/pharmsol src/nca/types.rs: NCAOptions (defaults:
lin-up/log-down AUC, BLQ Exclude, λz AdjR2 with min 3 points / R² 0.90 /
span 2.0 / PKNCA adj-R² factor 1e-4, max extrapolation 20%), presets
``bioequivalence()`` and ``sparse()``, and the grouped result structs with
``to_params()`` / ``to_row()`` flattening and severity-graded warnings.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ..data.event import AUCMethod, BLQRule, Route


@dataclass(frozen=True)
class TmaxRelative:
    """BLQ policy relative to Tmax (BLQRule::TmaxRelative)."""

    before_tmax_keep: bool = True
    after_tmax_keep: bool = False


class LambdaZMethod(enum.Enum):
    ADJ_R2 = "adj_r2"
    R2 = "r2"
    MANUAL = "manual"  # pair with LambdaZOptions.manual_points


class C0Method(enum.Enum):
    OBSERVED = "observed"
    LOG_SLOPE = "log_slope"
    FIRST_CONC = "first_conc"
    CMIN = "cmin"
    ZERO = "zero"


@dataclass
class LambdaZOptions:
    method: LambdaZMethod = LambdaZMethod.ADJ_R2
    manual_points: Optional[int] = None
    min_points: int = 3
    max_points: Optional[int] = None
    min_r_squared: float = 0.90
    min_span_ratio: float = 2.0
    include_tmax: bool = False
    adj_r_squared_factor: float = 0.0001  # PKNCA default
    exclude_indices: List[int] = field(default_factory=list)


@dataclass
class NCAOptions:
    auc_method: AUCMethod = AUCMethod.LIN_UP_LOG_DOWN
    blq_rule: object = BLQRule.EXCLUDE  # BLQRule or TmaxRelative
    lambda_z: LambdaZOptions = field(default_factory=LambdaZOptions)
    tau: Optional[float] = None
    auc_interval: Optional[Tuple[float, float]] = None
    c0_methods: List[C0Method] = field(
        default_factory=lambda: [C0Method.OBSERVED, C0Method.LOG_SLOPE, C0Method.FIRST_CONC]
    )
    max_auc_extrap_pct: float = 20.0
    concentration_threshold: Optional[float] = None
    route_override: Optional[Route] = None
    outeq: int = 0
    dose_times: Optional[List[float]] = None

    # -- presets (types.rs:105-128) -----------------------------------------
    @staticmethod
    def bioequivalence() -> "NCAOptions":
        return NCAOptions(
            lambda_z=LambdaZOptions(min_r_squared=0.90, min_points=3),
            max_auc_extrap_pct=20.0,
        )

    @staticmethod
    def sparse() -> "NCAOptions":
        return NCAOptions(
            lambda_z=LambdaZOptions(min_r_squared=0.80, min_points=3),
            max_auc_extrap_pct=30.0,
        )

    # -- builder methods -------------------------------------------------------
    def with_auc_method(self, method: AUCMethod) -> "NCAOptions":
        self.auc_method = method
        return self

    def with_blq_rule(self, rule) -> "NCAOptions":
        self.blq_rule = rule
        return self

    def with_tau(self, tau: float) -> "NCAOptions":
        self.tau = float(tau)
        return self

    def with_auc_interval(self, start: float, end: float) -> "NCAOptions":
        self.auc_interval = (float(start), float(end))
        return self

    def with_lambda_z(self, options: LambdaZOptions) -> "NCAOptions":
        self.lambda_z = options
        return self

    def with_min_r_squared(self, value: float) -> "NCAOptions":
        self.lambda_z.min_r_squared = float(value)
        return self

    def with_c0_methods(self, methods: List[C0Method]) -> "NCAOptions":
        self.c0_methods = list(methods)
        return self

    def with_concentration_threshold(self, threshold: float) -> "NCAOptions":
        self.concentration_threshold = float(threshold)
        return self

    def with_route(self, route: Route) -> "NCAOptions":
        self.route_override = route
        return self

    def with_outeq(self, outeq: int) -> "NCAOptions":
        self.outeq = int(outeq)
        return self

    def with_dose_times(self, times: List[float]) -> "NCAOptions":
        self.dose_times = [float(t) for t in times]
        return self


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass
class ExposureParams:
    cmax: float
    tmax: float
    clast: float
    tlast: float
    tfirst: Optional[float] = None
    auc_last: float = 0.0
    auc_inf_obs: Optional[float] = None
    auc_inf_pred: Optional[float] = None
    auc_pct_extrap_obs: Optional[float] = None
    auc_pct_extrap_pred: Optional[float] = None
    auc_partial: Optional[float] = None
    aumc_last: Optional[float] = None
    aumc_inf: Optional[float] = None
    tlag: Optional[float] = None
    cmax_dn: Optional[float] = None
    auc_last_dn: Optional[float] = None
    auc_inf_dn: Optional[float] = None
    time_above_mic: Optional[float] = None


@dataclass
class RegressionStats:
    r_squared: float
    adj_r_squared: float
    corrxy: float
    n_points: int
    time_first: float
    time_last: float
    span_ratio: float


@dataclass
class TerminalParams:
    lambda_z: float
    half_life: float
    mrt: Optional[float] = None
    effective_half_life: Optional[float] = None
    kel: Optional[float] = None
    regression: Optional[RegressionStats] = None


@dataclass
class ClearanceParams:
    cl_f: float
    vz_f: float
    vss: Optional[float] = None


@dataclass
class IVBolusParams:
    c0: float
    vd: float
    c0_method: Optional[C0Method] = None


@dataclass
class IVInfusionParams:
    infusion_duration: float
    mrt_iv: Optional[float] = None
    ceoi: Optional[float] = None


class RouteParams:
    """Discriminated union: IVBolus(params) | IVInfusion(params) | Extravascular."""

    def __init__(self, kind: str, params=None):
        self.kind = kind  # 'iv_bolus' | 'iv_infusion' | 'extravascular'
        self.params = params

    @staticmethod
    def iv_bolus(params: IVBolusParams) -> "RouteParams":
        return RouteParams("iv_bolus", params)

    @staticmethod
    def iv_infusion(params: IVInfusionParams) -> "RouteParams":
        return RouteParams("iv_infusion", params)

    @staticmethod
    def extravascular() -> "RouteParams":
        return RouteParams("extravascular")


@dataclass
class SteadyStateParams:
    tau: float
    auc_tau: float
    cmin: float
    cmax_ss: float
    cavg: float
    fluctuation: float
    swing: float
    peak_trough_ratio: float
    accumulation: Optional[float] = None


@dataclass
class MultiDoseParams:
    dose_times: List[float]
    auc_intervals: List[float]
    cmax_intervals: List[float]
    tmax_intervals: List[float]


class Severity(enum.Enum):
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"


@dataclass
class Warning_:
    """One NCA quality warning (types.rs Warning enum)."""

    kind: str
    message: str
    severity: Severity
    data: Dict = field(default_factory=dict)

    @staticmethod
    def high_extrapolation(pct: float, threshold: float) -> "Warning_":
        return Warning_(
            "high_extrapolation",
            f"AUC extrapolation {pct:.1f}% exceeds {threshold:.1f}%",
            Severity.WARNING,
            {"pct": pct, "threshold": threshold},
        )

    @staticmethod
    def poor_fit(r_squared: float, threshold: float) -> "Warning_":
        return Warning_(
            "poor_fit",
            f"lambda-z R² {r_squared:.3f} below {threshold:.3f}",
            Severity.WARNING,
            {"r_squared": r_squared, "threshold": threshold},
        )

    @staticmethod
    def lambda_z_not_estimable() -> "Warning_":
        return Warning_(
            "lambda_z_not_estimable", "lambda-z could not be estimated", Severity.ERROR
        )

    @staticmethod
    def short_terminal_phase(span_ratio: float, threshold: float) -> "Warning_":
        return Warning_(
            "short_terminal_phase",
            f"terminal span ratio {span_ratio:.2f} below {threshold:.2f}",
            Severity.INFO,
            {"span_ratio": span_ratio, "threshold": threshold},
        )

    @staticmethod
    def low_cmax() -> "Warning_":
        return Warning_("low_cmax", "Cmax is zero or negative", Severity.ERROR)

    @staticmethod
    def mixed_routes(routes: List[Route]) -> "Warning_":
        return Warning_(
            "mixed_routes",
            f"multiple routes detected: {[r.value for r in routes]}",
            Severity.INFO,
            {"routes": routes},
        )


@dataclass
class Quality:
    warnings: List[Warning_] = field(default_factory=list)

    def errors(self) -> List[Warning_]:
        return [w for w in self.warnings if w.severity is Severity.ERROR]

    def warnings_only(self) -> List[Warning_]:
        return [w for w in self.warnings if w.severity is Severity.WARNING]

    def info(self) -> List[Warning_]:
        return [w for w in self.warnings if w.severity is Severity.INFO]

    def has_errors(self) -> bool:
        return any(w.severity is Severity.ERROR for w in self.warnings)


@dataclass
class NCAResult:
    subject_id: Optional[str]
    occasion: Optional[int]
    dose_amount: Optional[float]
    route: Optional[Route]
    infusion_duration: Optional[float]
    exposure: ExposureParams
    terminal: Optional[TerminalParams]
    clearance: Optional[ClearanceParams]
    route_params: Optional[RouteParams]
    steady_state: Optional[SteadyStateParams]
    multi_dose: Optional[MultiDoseParams]
    quality: Quality

    def __str__(self) -> str:
        """Human-readable boxed summary (types.rs:605-700 Display)."""
        w = 38
        bar = "═" * w
        lines = [f"╔{bar}╗", f"║{'NCA Results':^{w}}║", f"╠{bar}╣"]

        def row(text: str) -> None:
            lines.append(f"║ {text:<{w - 2}} ║")

        if self.subject_id is not None:
            row(f"Subject: {self.subject_id}")
        if self.occasion is not None:
            row(f"Occasion: {self.occasion}")
        if self.dose_amount is not None:
            route = self.route.name if self.route is not None else "Unknown"
            row(f"Dose: {self.dose_amount:.2f} ({route})")
        lines.append(f"╠{bar}╣")
        row("EXPOSURE")
        row(f"  Cmax:    {self.exposure.cmax:>10.4g} at Tmax={self.exposure.tmax:.2f}")
        row(f"  AUClast: {self.exposure.auc_last:>10.4g}")
        if self.exposure.auc_inf_obs is not None:
            row(f"  AUCinf(obs):  {self.exposure.auc_inf_obs:>10.4g}")
        if self.exposure.auc_inf_pred is not None:
            row(f"  AUCinf(pred): {self.exposure.auc_inf_pred:>10.4g}")
        row(f"  Clast:   {self.exposure.clast:>10.4g} at Tlast={self.exposure.tlast:.2f}")
        if self.terminal is not None:
            lines.append(f"╠{bar}╣")
            row("TERMINAL")
            row(f"  lambda_z: {self.terminal.lambda_z:>10.5g}")
            row(f"  t1/2:     {self.terminal.half_life:>10.4g}")
            if self.terminal.regression is not None:
                row(f"  R^2:      {self.terminal.regression.r_squared:>10.4f}")
        if self.clearance is not None:
            lines.append(f"╠{bar}╣")
            row("CLEARANCE")
            row(f"  CL/F:    {self.clearance.cl_f:>10.4g}")
            row(f"  Vz/F:    {self.clearance.vz_f:>10.4g}")
        if self.route_params is not None and self.route_params.kind == "iv_bolus":
            lines.append(f"╠{bar}╣")
            row("IV BOLUS")
            row(f"  C0:      {self.route_params.params.c0:>10.4g}")
            row(f"  Vd:      {self.route_params.params.vd:>10.4g}")
        elif self.route_params is not None and self.route_params.kind == "iv_infusion":
            lines.append(f"╠{bar}╣")
            row("IV INFUSION")
            row(f"  Dur:     {self.route_params.params.infusion_duration:>10.4g}")
        if self.quality.warnings:
            lines.append(f"╠{bar}╣")
            row("WARNINGS")
            for warning in self.quality.warnings:
                row(f"  - {warning.message}")
        lines.append(f"╚{bar}╝")
        return "\n".join(lines)

    # -- convenience accessors (types.rs NCAResult impl) --------------------
    def half_life(self) -> Optional[float]:
        return self.terminal.half_life if self.terminal else None

    def c0(self) -> Optional[float]:
        if self.route_params and self.route_params.kind == "iv_bolus":
            return self.route_params.params.c0
        return None

    def vd(self) -> Optional[float]:
        if self.route_params and self.route_params.kind == "iv_bolus":
            return self.route_params.params.vd
        return None

    def vss(self) -> Optional[float]:
        return self.clearance.vss if self.clearance else None

    def ceoi(self) -> Optional[float]:
        if self.route_params and self.route_params.kind == "iv_infusion":
            return self.route_params.params.ceoi
        return None

    def mrt_iv(self) -> Optional[float]:
        if self.route_params and self.route_params.kind == "iv_infusion":
            return self.route_params.params.mrt_iv
        return None

    def to_params(self) -> Dict[str, float]:
        """Flatten to name -> value, omitting absent optionals."""
        p: Dict[str, float] = {}
        e = self.exposure
        p["cmax"] = e.cmax
        p["tmax"] = e.tmax
        p["clast"] = e.clast
        p["tlast"] = e.tlast
        for name, v in [
            ("tfirst", e.tfirst),
            ("auc_inf_obs", e.auc_inf_obs),
            ("auc_inf_pred", e.auc_inf_pred),
            ("auc_pct_extrap_obs", e.auc_pct_extrap_obs),
            ("auc_pct_extrap_pred", e.auc_pct_extrap_pred),
            ("auc_partial", e.auc_partial),
            ("aumc_last", e.aumc_last),
            ("aumc_inf", e.aumc_inf),
            ("tlag", e.tlag),
            ("cmax_dn", e.cmax_dn),
            ("auc_last_dn", e.auc_last_dn),
            ("auc_inf_dn", e.auc_inf_dn),
            ("time_above_mic", e.time_above_mic),
            ("dose", self.dose_amount),
        ]:
            if v is not None:
                p[name] = v
        p["auc_last"] = e.auc_last
        if self.terminal:
            t = self.terminal
            p["lambda_z"] = t.lambda_z
            p["half_life"] = t.half_life
            if t.mrt is not None:
                p["mrt"] = t.mrt
            if t.effective_half_life is not None:
                p["effective_half_life"] = t.effective_half_life
            if t.kel is not None:
                p["kel"] = t.kel
            if t.regression is not None and math.isfinite(t.regression.corrxy):
                p["lambda_z_corrxy"] = t.regression.corrxy
        if self.clearance:
            p["cl_f"] = self.clearance.cl_f
            p["vz_f"] = self.clearance.vz_f
            if self.clearance.vss is not None:
                p["vss"] = self.clearance.vss
        if self.route_params:
            rp = self.route_params
            if rp.kind == "iv_bolus":
                p["c0"] = rp.params.c0
                p["vd"] = rp.params.vd
            elif rp.kind == "iv_infusion":
                p["infusion_duration"] = rp.params.infusion_duration
                if rp.params.mrt_iv is not None:
                    p["mrt_iv"] = rp.params.mrt_iv
                if rp.params.ceoi is not None:
                    p["ceoi"] = rp.params.ceoi
        if self.steady_state:
            ss = self.steady_state
            p["tau"] = ss.tau
            p["auc_tau"] = ss.auc_tau
            p["cmin"] = ss.cmin
            p["cmax_ss"] = ss.cmax_ss
            p["cavg"] = ss.cavg
            p["fluctuation"] = ss.fluctuation
            p["swing"] = ss.swing
            p["peak_trough_ratio"] = ss.peak_trough_ratio
            if ss.accumulation is not None:
                p["accumulation"] = ss.accumulation
        return p

    # canonical column order: exposure → terminal → clearance → route →
    # steady-state → dose-normalized → dose (types.rs to_row)
    ROW_COLUMNS = [
        "cmax", "tmax", "clast", "tlast", "tfirst", "auc_last", "auc_inf_obs",
        "auc_inf_pred", "auc_pct_extrap_obs", "auc_pct_extrap_pred",
        "auc_partial", "aumc_last", "aumc_inf", "tlag", "lambda_z",
        "half_life", "mrt", "effective_half_life", "kel", "cl_f", "vz_f",
        "vss", "c0", "vd", "infusion_duration", "ceoi", "tau", "auc_tau",
        "cmin", "cmax_ss", "cavg", "fluctuation", "swing",
        "peak_trough_ratio", "accumulation", "cmax_dn", "auc_last_dn",
        "auc_inf_dn", "time_above_mic", "dose",
    ]

    def to_row(self) -> List[Tuple[str, Optional[float]]]:
        params = self.to_params()
        return [(name, params.get(name)) for name in self.ROW_COLUMNS]


@dataclass
class SubjectNCAResult:
    """Per-subject grouped results (nca/traits.rs:29-53)."""

    subject_id: str
    occasions: List  # list of NCAResult or exceptions

    def successes(self) -> List[NCAResult]:
        return [r for r in self.occasions if isinstance(r, NCAResult)]

    def errors(self) -> List:
        return [r for r in self.occasions if not isinstance(r, NCAResult)]
