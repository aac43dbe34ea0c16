"""Device-side population NCA over a shared time grid.

The counterpart of the JAX package's ``nca/batch_device.py`` (a jitted XLA
program there), written as torch tensor operations on an explicit device.
Where the reference rayon-parallels scalar NCA per subject
(nca/traits.rs:206-243) and the host batch path loops window sizes, this
evaluates the whole parameter set as one array program:

- segment AUC/AUMC as elementwise ops on the [N, T-1] grid;
- the λz candidate search as a *closed-form suffix-sum regression*: every
  window length is scored simultaneously from reversed cumulative sums
  (Σy, Σy², Σxy as [N, W] gathers), qualification gates applied as masks,
  and the PKNCA adj-R² + factor·n score arg-maxed on the device — no data
  movement, no Python loop over windows, O(N·T) instead of O(N·T²);
- λz-derived exposure/terminal/clearance parameters as elementwise
  follow-ups, and the route-specific and steady-state blocks.

Gates and scoring mirror nca/calc.rs:123-394 (candidate windows after Tmax,
min-R², span-ratio). Results match the host ``batch_nca`` (parity-tested),
which itself matches per-subject ``nca()``. Every reduction is per row, so
the subjects axis splits across devices without change.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..config import float_dtype, resolve_device
from ..data.event import AUCMethod
from .types import LambdaZMethod, NCAOptions

LN2 = math.log(2.0)


def _segment_areas(t, c, method: AUCMethod):
    """[N, T-1] per-segment AUC and AUMC (lin-up/log-down or linear)."""
    t1, t2 = t[:-1][None, :], t[1:][None, :]
    c1, c2 = c[:, :-1], c[:, 1:]
    dt = t2 - t1
    lin = (c1 + c2) / 2.0 * dt
    lin_m = (t1 * c1 + t2 * c2) / 2.0 * dt
    if method is AUCMethod.LINEAR:
        return lin, lin_m
    one, e = torch.ones_like(c2), torch.full_like(c2, math.e)
    use_log = (c2 < c1) & (c1 > 0) & (c2 > 0)
    safe_c2 = torch.where(c2 > 0, c2, one)
    ratio = torch.where(use_log, c1 / safe_c2, e)
    use_log = use_log & (torch.abs(ratio - 1.0) >= 1e-10)
    logr = torch.log(torch.where(use_log, ratio, e))
    safe_dt = torch.where(dt != 0, dt, torch.ones_like(dt))
    logv = (c1 - c2) * dt / logr
    k = logr / safe_dt
    logv_m = torch.where(use_log, (t1 * c1 - t2 * c2) / k + (c1 - c2) / (k * k), lin_m)
    return torch.where(use_log, logv, lin), torch.where(use_log, logv_m, lin_m)


def _suffix_sums(a):
    """s[..., j] = sum of elements j..T-1 (the window starting at index j)."""
    return torch.flip(torch.cumsum(torch.flip(a, (-1,)), dim=-1), (-1,))


def _batch_nca_core(
    t, c, dose, inf_dur,
    *, method, min_points, max_points, include_tmax,
    min_r_squared, min_span_ratio, adj_r_squared_factor, with_dose,
    route=None, tau=None, c0_methods=(),
):
    N, T = c.shape
    dev = c.device

    cmax, cmax_idx = torch.max(c, dim=1)
    # the first maximum, as argmax on the host and in the JAX program
    cmax_idx = torch.argmax((c == cmax[:, None]).to(torch.int8), dim=1)
    tmax = t[cmax_idx]
    clast = c[:, -1]
    tlast = torch.full((N,), float(t[-1]), dtype=c.dtype, device=dev)

    areas, moments = _segment_areas(t, c, method)
    auc_last = torch.sum(areas, dim=1)
    aumc_last = torch.sum(moments, dim=1)

    # -- λz: all window lengths at once via suffix sums ------------------------
    logc = torch.log(c)
    sy = _suffix_sums(logc)          # [N, T] : sy[:, j] = Σ last T-j of log c
    syy = _suffix_sums(logc * logc)  # [N, T]
    sxy = _suffix_sums(logc * t[None, :])  # [N, T]
    sx = _suffix_sums(t)             # [T]
    sxx = _suffix_sums(t * t)        # [T]

    max_n = T if max_points is None else min(T, max_points)
    W = int(max_n + 1 - min_points)
    n_vals = torch.arange(min_points, max_n + 1 if W > 0 else min_points + 1, device=dev)
    nf = n_vals.to(c.dtype)                              # [W]
    first = T - n_vals                                   # [W] window start index

    Sx = sx[first]                                       # [W]
    Sxx = sxx[first]                                     # [W]
    Sy = sy[:, first]                                    # [N, W]
    Syy = syy[:, first]
    Sxy = sxy[:, first]

    denom = nf * Sxx - Sx * Sx                           # [W]
    safe_denom = torch.where(torch.abs(denom) < 1e-15, torch.ones_like(denom), denom)
    slope = (nf * Sxy - Sx * Sy) / safe_denom            # [N, W]
    intercept = (Sy - slope * Sx) / nf
    # Σ(y - a - b x)² expanded in the suffix sums
    ss_res = (
        Syy + nf * intercept ** 2 + slope ** 2 * Sxx
        - 2.0 * intercept * Sy - 2.0 * slope * Sxy + 2.0 * intercept * slope * Sx
    )
    ss_tot = Syy - Sy * Sy / nf
    r2 = torch.where(torch.abs(ss_tot) < 1e-15, torch.ones_like(ss_tot), 1.0 - ss_res / ss_tot)
    adj = torch.where(n_vals > 2, 1.0 - (1.0 - r2) * (nf - 1.0) / (nf - 2.0), r2)
    lam = -slope
    t_first = t[first]                                   # [W]
    span_ratio = (t[-1] - t_first)[None, :] * lam / LN2  # [N, W]

    valid = first[None, :] >= (cmax_idx[:, None] + (0 if include_tmax else 1))  # [N, W]
    qualifies = (
        valid
        & (lam > 0)
        & (r2 >= min_r_squared)
        & (span_ratio >= min_span_ratio)
        & (torch.abs(denom) >= 1e-15)[None, :]
    )
    score = adj + adj_r_squared_factor * nf
    score = torch.where(qualifies, score, torch.full_like(score, -math.inf))
    # the first maximum of each row's score, as jnp.argmax
    best = torch.max(score, dim=1, keepdim=True).values
    best_w = torch.argmax((score == best).to(torch.int8), dim=1)  # [N]
    any_ok = torch.any(qualifies, dim=1)
    nan = torch.full((N,), math.nan, dtype=c.dtype, device=dev)

    def pick(a):
        v = torch.gather(a, 1, best_w[:, None])[:, 0]
        return torch.where(any_ok, v, nan)

    lam_b = pick(lam)
    intercept_b = pick(intercept)
    r2_b = pick(r2)
    adj_b = pick(adj)
    span_b = pick(span_ratio)
    n_b = torch.where(any_ok, n_vals[best_w], torch.zeros_like(best_w))

    half_life = LN2 / lam_b
    clast_pred = torch.exp(intercept_b - lam_b * t[-1])
    auc_inf_obs = auc_last + clast / lam_b
    auc_inf_pred = auc_last + clast_pred / lam_b
    pct_obs = (auc_inf_obs - auc_last) / auc_inf_obs * 100.0
    pct_pred = (auc_inf_pred - auc_last) / auc_inf_pred * 100.0
    aumc_inf = aumc_last + clast * t[-1] / lam_b + clast / lam_b ** 2
    mrt = aumc_inf / auc_inf_obs

    out = {
        "cmax": cmax,
        "tmax": tmax,
        "clast": clast,
        "tlast": tlast,
        "auc_last": auc_last,
        "aumc_last": aumc_last,
        "lambda_z": lam_b,
        "half_life": half_life,
        "r_squared": r2_b,
        "adj_r_squared": adj_b,
        "lambda_z_n_points": n_b,
        "span_ratio": span_b,
        "auc_inf_obs": auc_inf_obs,
        "auc_inf_pred": auc_inf_pred,
        "auc_pct_extrap_obs": pct_obs,
        "auc_pct_extrap_pred": pct_pred,
        "aumc_inf": aumc_inf,
        "mrt": mrt,
    }
    if with_dose:
        out["cl_f"] = dose / auc_inf_obs
        out["vz_f"] = dose / (lam_b * auc_inf_obs)
        out["cmax_dn"] = cmax / dose
        out["auc_last_dn"] = auc_last / dose
        out["auc_inf_dn"] = auc_inf_obs / dose
        if route in ("iv_bolus", "iv_infusion"):
            # Vss = dose * AUMC_inf / AUC_inf^2 (IV routes only,
            # analyze.rs clearance block)
            out["vss"] = dose * aumc_inf / (auc_inf_obs * auc_inf_obs)

    # -- route-specific block (analyze.rs:218-363) ------------------------
    if route == "iv_bolus":
        c0_v = _c0_cascade(t, c, c0_methods)
        out["c0"] = c0_v
        if with_dose:
            out["vd"] = dose / c0_v
    elif route == "iv_infusion":
        out["infusion_duration"] = inf_dur
        out["ceoi"] = _interp_at(t, c, inf_dur)
        # MRT corrected for infusion: MRT - duration / 2
        out["mrt_iv"] = mrt - inf_dur / 2.0

    # -- steady-state block (tau known; analyze.rs:280-330) ---------------
    if tau is not None:
        auc_tau = _auc_interval_0_tau(t, c, float(tau), method)
        cmin_v = torch.min(c, dim=1).values
        cavg = auc_tau / float(tau)
        out["tau"] = torch.full_like(cmax, float(tau))
        out["auc_tau"] = auc_tau
        out["cmin"] = cmin_v
        out["cmax_ss"] = cmax
        out["cavg"] = cavg
        out["fluctuation"] = (cmax - cmin_v) / cavg * 100.0
        out["swing"] = (cmax - cmin_v) / cmin_v
        out["peak_trough_ratio"] = cmax / cmin_v
    return out


def _interp_at(t, c, tq):
    """Linear interpolation of [N, T] profiles at per-row times [N].

    Mirrors ObservationProfile.interpolate (clamped to the grid range).
    """
    T = t.shape[0]
    tq = torch.clamp(tq, min=float(t[0]), max=float(t[-1]))
    idx = torch.clamp(torch.searchsorted(t, tq, right=True) - 1, 0, T - 2)
    t0, t1 = t[idx], t[idx + 1]
    c0_ = torch.gather(c, 1, idx[:, None])[:, 0]
    c1_ = torch.gather(c, 1, (idx + 1)[:, None])[:, 0]
    w = torch.where(t1 > t0, (tq - t0) / torch.where(t1 > t0, t1 - t0, torch.ones_like(t1)),
                    torch.zeros_like(tq))
    return c0_ + (c1_ - c0_) * w


def _c0_cascade(t, c, c0_methods):
    """Device C0 back-extrapolation cascade (calc.rs:396-560 semantics).

    The batch contract guarantees strictly positive concentrations on a
    shared grid, which collapses the per-method feasibility checks to
    elementwise masks: OBSERVED needs t[0] ~ 0; LOG_SLOPE needs the first
    two concentrations declining; FIRST_CONC/CMIN always qualify; ZERO
    is the terminal fallback.
    """
    c1 = c[:, 0]
    c2 = c[:, 1] if c.shape[1] > 1 else c[:, 0]
    t1, t2 = t[0], (t[1] if t.shape[0] > 1 else t[0])
    out = torch.full(c.shape[:1], math.nan, dtype=c.dtype, device=c.device)
    done = torch.zeros(c.shape[:1], dtype=torch.bool, device=c.device)
    for m in c0_methods:
        name = getattr(m, "value", str(m))
        if name == "observed":
            ok = (torch.abs(t1) < 1e-10) & (c1 > 0.0)
            val = c1
        elif name == "log_slope":
            ok = (c2 < c1) & (torch.abs(t2 - t1) >= 1e-10)
            step = torch.where(torch.abs(t2 - t1) < 1e-10, torch.ones_like(t1), t2 - t1)
            slope = (torch.log(torch.clamp(c2, min=1e-300))
                     - torch.log(torch.clamp(c1, min=1e-300))) / step
            val = torch.exp(torch.log(torch.clamp(c1, min=1e-300)) - slope * t1)
        elif name == "first_conc":
            ok = torch.ones_like(done)
            val = c1
        elif name == "cmin":
            ok = torch.ones_like(done)
            val = torch.min(c, dim=1).values
        elif name == "zero":
            ok = torch.ones_like(done)
            val = torch.zeros_like(c1)
        else:
            continue
        take = ok & ~done
        out = torch.where(take, val, out)
        done = done | ok
    return out


def _auc_interval_0_tau(t, c, tau, method):
    """AUC over [0, tau] on the shared grid (the partial last segment
    interpolated linearly at the boundary, auc.rs semantics)."""
    areas, _ = _segment_areas(t, c, method)
    t1s, t2s = t[:-1], t[1:]
    inside = (t1s >= 0.0) & (t2s <= tau)
    full = torch.sum(torch.where(inside[None, :], areas, torch.zeros_like(areas)), dim=1)
    # the partial segment containing tau
    crosses = (t1s < tau) & (t2s > tau)
    has_cross = torch.any(crosses)
    j = torch.argmax(crosses.to(torch.int8))
    c1_ = c[:, j]
    c2_ = c[:, j + 1]
    tj, tj1 = t1s[j], t2s[j]
    ctau = c1_ + (c2_ - c1_) * (tau - tj) / torch.where(tj1 > tj, tj1 - tj, torch.ones_like(tj))
    dt = tau - tj
    lin = (c1_ + ctau) / 2.0 * dt
    zero = torch.zeros_like(lin)
    if method is AUCMethod.LINEAR:
        return full + torch.where(has_cross, lin, zero)
    # same per-segment rule as _segment_areas (lin-up/log-down)
    use_log = (ctau < c1_) & (c1_ > 0) & (ctau > 0)
    safe = torch.where(ctau > 0, ctau, torch.ones_like(ctau))
    e = torch.full_like(ctau, math.e)
    ratio = torch.where(use_log, c1_ / safe, e)
    use_log = use_log & (torch.abs(ratio - 1.0) >= 1e-10)
    logr = torch.log(torch.where(use_log, ratio, e))
    part = torch.where(use_log, (c1_ - ctau) * dt / logr, lin)
    return full + torch.where(has_cross, part, zero)


def batch_nca_device(
    times,
    profiles,
    dose=None,
    options: Optional[NCAOptions] = None,
    as_numpy: bool = True,
    route: Optional[str] = None,
    infusion_duration=None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Full NCA for [N, T] profiles on ``device`` (default: the card), one
    array program.

    Same contract as :func:`pharmsol_tpu_torch.nca.batch.batch_nca`
    (strictly positive concentrations, AdjR2 λz method). ``profiles`` may
    already live on the device (e.g. straight out of a simulation); pass
    ``as_numpy=False`` to keep the results there as tensors.

    Route-specific and steady-state parameters (analyze.rs:218-363) join
    the core set so a 10k-population pipeline needs no host pass:

    - ``route='iv_bolus'``: the C0 back-extrapolation cascade
      (``options.c0_methods``), Vd = dose/C0, and Vss;
    - ``route='iv_infusion'``: Ceoi (profile interpolated at the end of
      infusion), the infusion-corrected MRT (MRT - dur/2), and Vss;
      ``infusion_duration`` is scalar or [N];
    - ``options.tau``: the steady-state block — AUC_tau (partial-segment
      interpolation at the boundary), Cmin/Cavg/Cmax_ss, fluctuation,
      swing, peak-trough ratio.
    """
    options = options or NCAOptions()
    lz = options.lambda_z
    if lz.method is not LambdaZMethod.ADJ_R2:
        raise ValueError("batch_nca_device supports the AdjR2 lambda-z method")
    if route not in (None, "iv_bolus", "iv_infusion", "extravascular"):
        raise ValueError(
            "route must be one of None/'iv_bolus'/'iv_infusion'/"
            "'extravascular'"
        )
    dev, fd = resolve_device(device), float_dtype()
    t = torch.as_tensor(times).to(device=dev, dtype=fd)
    c = torch.as_tensor(profiles).to(device=dev, dtype=fd)
    if t.ndim != 1 or c.ndim != 2 or c.shape[1] != t.shape[0]:
        raise ValueError("times must be [T] matching profiles [N, T]")
    N = c.shape[0]
    with_dose = dose is not None
    d = (torch.as_tensor(dose).to(device=dev, dtype=fd).expand(N).clone()
         if with_dose else torch.zeros((N,), dtype=fd, device=dev))
    inf_dur = torch.as_tensor(
        infusion_duration if infusion_duration is not None else 0.0
    ).to(device=dev, dtype=fd).expand(N).clone()
    out = _batch_nca_core(
        t, c, d, inf_dur,
        method=options.auc_method,
        min_points=lz.min_points,
        max_points=lz.max_points,
        include_tmax=lz.include_tmax,
        min_r_squared=lz.min_r_squared,
        min_span_ratio=lz.min_span_ratio,
        adj_r_squared_factor=lz.adj_r_squared_factor,
        with_dose=with_dose,
        route=route,
        tau=(float(options.tau) if options.tau is not None else None),
        c0_methods=tuple(getattr(m, "value", str(m)) for m in (options.c0_methods or ())),
    )
    if as_numpy:
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out
