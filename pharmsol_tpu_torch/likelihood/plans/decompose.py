"""Host-side decomposition of covariates, lag and fa for the fused psi plan.

The counterpart of the JAX package's ``likelihood/plans/decompose.py``: it
turns the model's closures and the population's covariates into the
per-row streams and per-(row, support) planes kernel K1b reads. Every
closure is evaluated on the host in float64 through ``torch.func.vmap``;
numpy carries the results to the plan. A model outside what the kernel can
take raises :class:`PharmsolError` with the reason, and ``engine='auto'``
records it and takes the general engine.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ...config import BIG_TIME
from ...errors import PharmsolError

F64 = torch.float64


def _t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64)


def _constant_covariate_values(grid) -> dict:
    """Per-row covariate values, requiring time-constant covariates
    (JAX :48): one value for the whole occasion row (a single knot, or
    identical knot values — padding repeats the last knot)."""
    cov_v = np.asarray(grid.rows.cov_v, dtype=np.float64)  # [R, ncov, K]
    if cov_v.ndim != 3 or not grid.cov_names:
        return {}
    if not np.all(cov_v == cov_v[..., :1]):
        raise PharmsolError(
            "engine='fused' supports time-constant covariates only here "
            "(a covariate changes value within an occasion; use the general "
            "engine)"
        )
    return {name: cov_v[:, c, 0] for c, name in enumerate(grid.cov_names)}


def _classify_covariates(grid):
    """(row_values, varying) (JAX :67): ``row_values[name]`` is each row's
    value at its first knot, ``varying`` the names whose value changes
    within at least one occasion row."""
    cov_v = np.asarray(grid.rows.cov_v, dtype=np.float64)  # [R, ncov, K]
    if cov_v.ndim != 3 or not grid.cov_names:
        return {}, set()
    row_values = {}
    varying = set()
    for c, name in enumerate(grid.cov_names):
        row_values[name] = cov_v[:, c, 0]
        if not np.all(cov_v[:, c, :] == cov_v[:, c, :1]):
            varying.add(name)
    return row_values, varying


def _interp_rows(ts, vs, fixed, tq):
    """covariate.rs interpolation of every row at its own time ``tq`` [R]:
    clamped to the knot range, linear between knots, carry-forward where
    ``fixed``."""
    K = ts.shape[1]
    rr = np.arange(ts.shape[0])
    tcl = np.clip(tq, ts[:, 0], ts[:, -1])
    idx = np.clip((ts <= tcl[:, None]).sum(-1) - 1, 0, K - 1)
    nxt = np.minimum(idx + 1, K - 1)
    tk0, tk1 = ts[rr, idx], ts[rr, nxt]
    vk0, vk1 = vs[rr, idx], vs[rr, nxt]
    denom = np.where(tk1 > tk0, tk1 - tk0, 1.0)
    lin = np.where(tk1 > tk0, vk0 + (vk1 - vk0) * (tcl - tk0) / denom, vk0)
    return np.where(fixed, vk0, lin)


def _covariate_values_at(grid, tq: float) -> dict:
    """Exact per-row covariate values at absolute time ``tq`` (JAX :87),
    ``{name: [R] float64}``: how a covariate-dependent init is evaluated at
    t = 0 (analytical/mod.rs:408-426)."""
    cov_t = np.asarray(grid.rows.cov_t, np.float64)  # [R, ncov, K]
    if cov_t.ndim != 3 or not grid.cov_names:
        return {}
    cov_v = np.asarray(grid.rows.cov_v, np.float64)
    fixed = np.asarray(grid.rows.cov_fixed).astype(bool)
    tq = np.full(cov_t.shape[0], float(tq))
    return {name: _interp_rows(cov_t[:, c], cov_v[:, c], fixed[:, c], tq)
            for c, name in enumerate(grid.cov_names)}


def _host_cov_values(grid, te: np.ndarray) -> dict:
    """Covariate values per row at per-row times ``te`` [R] (JAX :320), with
    :class:`~...engine.grid.CovView` semantics."""
    names = list(grid.cov_names)
    if not names:
        return {}
    cov_t = np.asarray(grid.rows.cov_t, dtype=np.float64)  # [R, C, K]
    cov_v = np.asarray(grid.rows.cov_v, dtype=np.float64)
    fixed = np.asarray(grid.rows.cov_fixed).astype(bool)
    te = np.asarray(te, np.float64)
    return {name: _interp_rows(cov_t[:, c], cov_v[:, c], fixed[:, c], te)
            for c, name in enumerate(names)}


def _affine_covariate_streams(grid, names, seg_t0, seg_dt):
    """Per-segment affine ``(a, b)`` streams, ``cov(t) = a + b t`` inside
    each segment, for time-varying covariates (JAX :119).

    The interpolation is affine within any span that holds no interior knot,
    so this is exact provided every knot falls on a segment boundary;
    raises PharmsolError when a knot lies strictly inside a segment.
    """
    cov_t = np.asarray(grid.rows.cov_t, np.float64)  # [R, ncov, K]
    cov_v = np.asarray(grid.rows.cov_v, np.float64)
    fixed = np.asarray(grid.rows.cov_fixed).astype(bool)  # [R, ncov]
    t0 = np.asarray(seg_t0, np.float64)  # [R, M]
    dt = np.asarray(seg_dt, np.float64)
    t1 = t0 + dt
    name_to_idx = {n: i for i, n in enumerate(grid.cov_names)}
    out = {}
    for name in names:
        c = name_to_idx[name]
        ts, vs = cov_t[:, c, :], cov_v[:, c, :]  # [R, K]
        # a knot within relative 1e-9 of a breakpoint counts as on it
        # (t0 + dt can land 1 ulp past a breakpoint)
        eps = 1e-9 * np.maximum(1.0, np.abs(ts))[:, None, :]
        interior = ((ts[:, None, :] > t0[:, :, None] + eps)
                    & (ts[:, None, :] < t1[:, :, None] - eps))
        if np.any(interior & (dt > 0.0)[:, :, None]):
            raise PharmsolError(
                f"engine='fused' requires covariate `{name}`'s change points "
                "to fall on event/segment boundaries (a knot lies strictly "
                "inside a segment — use the general engine)"
            )
        fx = fixed[:, c]

        def interp(tq):  # tq [R, M]
            return np.stack([_interp_rows(ts, vs, fx, tq[:, m])
                             for m in range(tq.shape[1])], axis=1)

        v0, v1 = interp(t0), interp(t1)
        span = np.where(dt > 0.0, dt, 1.0)
        b = np.where(dt > 0.0, (v1 - v0) / span, 0.0)
        b = np.where(fx[:, None], 0.0, b)  # fixed: carry v(t0) across the span
        out[name] = (v0 - b * t0, b)
    return out


class _RowCov:
    """Covariate shim handing per-row constants to a probe (JAX :186)."""

    def __init__(self, vals: dict):
        self.vals = vals

    def __call__(self, name, t=None):
        try:
            return self.vals[str(name)]
        except KeyError:
            raise PharmsolError(f"closure reads unknown covariate `{name}`")

    value = __call__


def _affine_solve(f_a, f_b, f_c, p_a, p_b, p_c, tol):
    """The diagonal-affine form ``f[..., i] = g[..., i] p[i] + h[..., i]``
    solved from probes a and b and checked at c (JAX :282). Returns (g, h)
    or None when the form does not hold."""
    g = (f_a - f_b) / (p_a - p_b)  # nonzero by probe construction
    h = f_a - g * p_a
    pred_c = g * p_c + h
    scale = np.maximum(np.abs(f_c), 1.0)
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(h))
            and np.all(np.abs(pred_c - f_c) <= tol * 100 * scale)):
        return None
    return g, h


class _InputPlaneDynamic(PharmsolError):
    """A lag/fa closure is time-dependent or reads a time-varying covariate
    (JAX :527): its value is not one constant per (row, support). Such
    closures need per-dose-segment planes (:func:`_decompose_input_seg_planes`):
    the ODE plan builds them for kernel K2e; the closed-form kernel's are
    K1c, not ported yet."""


def _decompose_input_plane(fn, sp, grid, ninput: int, fill: float,
                           what: str, rows: bool = False) -> np.ndarray:
    """Input 0 of :func:`_decompose_input_planes`, [R, S] float64, or [1,
    S] with ``rows`` for a covariate-free closure (JAX :534): the
    closed-form kernel doses input 0 only."""
    return _decompose_input_planes(fn, sp, grid, ninput, fill, what, rows)[0]


def _decompose_input_planes(fn, sp, grid, ninput: int, fill: float,
                            what: str, rows: bool = False) -> np.ndarray:
    """A lag/fa closure as per-(input, row, support) planes (JAX :544).

    Probes: the value must not change with t (the engine evaluates it at
    each bolus's own time) and must not follow a time-varying covariate
    (raises :class:`_InputPlaneDynamic`). Time-constant covariates may
    enter: the closure is then evaluated per row. A covariate-free closure
    is one support row: broadcast over the rows, or with ``rows`` kept as
    that row (the closed-form kernels read it with a row stride of 0).
    Returns [ninput, R, S], or [ninput, 1, S].
    """
    from ...engine.grid import _as_input_vector

    cov_values, varying = _classify_covariates(grid) if grid.cov_names else ({}, set())
    names = list(cov_values)
    R, S = grid.n_rows, sp.shape[0]
    sp_t = _t64(sp)

    def at(t, covd):
        tt = torch.tensor(float(t), dtype=F64)
        return vmap(lambda p: _as_input_vector(fn(p, tt, _RowCov(covd)), ninput, p,
                                               fill))(sp_t)

    cov0 = {n: float(np.asarray(v)[0]) for n, v in cov_values.items()}
    cov1 = {n: v * 1.31 + 0.17 for n, v in cov0.items()}
    cov_var = {n: (v * 1.31 + 0.17 if n in varying else v) for n, v in cov0.items()}
    try:
        v_ref = at(0.0, cov0).numpy()
        v_t = at(123.456, cov0).numpy()
        v_cov = at(0.0, cov1).numpy()
        v_var = at(0.0, cov_var).numpy() if varying else v_ref
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not probe the {what} equation: {e}") from e
    scale = np.maximum(np.abs(v_ref).max(), 1e-12)
    if np.abs(v_t - v_ref).max() > 1e-9 * scale:
        raise _InputPlaneDynamic(
            f"engine='fused' requires a time-independent {what} equation (the "
            "engine evaluates it at each bolus's own time; per-dose planes are "
            "kernel K1c, not ported) — use the general engine"
        )
    if varying and np.abs(v_var - v_ref).max() > 1e-9 * scale:
        raise _InputPlaneDynamic(
            f"engine='fused' requires the {what} equation not to read a "
            "time-varying covariate (per-dose planes are kernel K1c, not "
            "ported) — use the general engine"
        )
    if not np.all(np.isfinite(v_ref)):
        raise PharmsolError(f"engine='fused' {what} probe produced non-finite values")
    if names and np.abs(v_cov - v_ref).max() > 1e-9 * scale:
        # covariate-dependent: evaluate per (row, support)
        stacked = _t64(np.stack([np.asarray(cov_values[n]) for n in names], axis=1))
        tt = torch.tensor(0.0, dtype=F64)

        def one_row(row):
            covd = {n: row[i] for i, n in enumerate(names)}
            return vmap(lambda p: _as_input_vector(fn(p, tt, _RowCov(covd)), ninput,
                                                   p, fill))(sp_t)

        try:
            plane = vmap(one_row)(stacked).numpy()  # [R, S, ninput]
        except PharmsolError:
            raise
        except Exception as e:
            raise PharmsolError(
                f"engine='fused' could not probe the {what} equation per row: {e}") from e
        if not np.all(np.isfinite(plane)):
            raise PharmsolError(f"engine='fused' {what} probe produced non-finite values")
        return np.ascontiguousarray(np.transpose(plane, (2, 0, 1)))
    if rows:
        return np.ascontiguousarray(v_ref.T[:, None, :])
    return np.broadcast_to(v_ref.T[:, None, :], (ninput, R, S)).copy()


def _decompose_input_seg_planes(equation, sp, grid, ninput: int, dose_cols,
                                t0_np) -> dict:
    """Exact per-(row, support) lag/fa planes per dose-carrying segment (JAX
    :204-279), for the closures :func:`_decompose_input_planes` refuses as
    :class:`_InputPlaneDynamic`: lag evaluated at each bolus's original
    breakpoint time (structs.rs:629), fa at the lag-shifted time per input
    (engine/grid.py's order), with the engine's :class:`CovView`
    interpolation, in float64 on the host.

    ``dose_cols``: segment columns that carry a bolus on any row; ``t0_np``
    [R, M]: segment start times. Returns ``{m: (lag [ninput, R, S], fa
    [ninput, R, S])}``.
    """
    from ...engine.grid import CovView, _as_input_vector

    lag_fn, fa_fn = equation._lag, equation._fa
    names = tuple(grid.cov_names)
    kt = _t64(grid.rows.cov_t)
    kv = _t64(grid.rows.cov_v)
    kf = torch.as_tensor(np.asarray(grid.rows.cov_fixed).astype(bool))
    sp_t = _t64(sp)

    def per_cell(p, tr, kt_r, kv_r, kf_r):
        cv = CovView(kt_r, kv_r, kf_r, names)
        if lag_fn is not None:
            lag_v = _as_input_vector(lag_fn(p, tr, cv), ninput, p, 0.0)
        else:
            lag_v = torch.zeros(ninput, dtype=F64)
        if fa_fn is not None:
            fa_v = torch.stack([_as_input_vector(fa_fn(p, tr + lag_v[j], cv), ninput, p,
                                                 1.0)[j] for j in range(ninput)])
        else:
            fa_v = torch.ones(ninput, dtype=F64)
        return lag_v, fa_v

    per_row = vmap(lambda tr, a, b, c: vmap(lambda p: per_cell(p, tr, a, b, c))(sp_t))
    out = {}
    try:
        for m in dose_cols:
            lag_rs, fa_rs = per_row(_t64(t0_np[:, m]), kt, kv, kf)  # [R, S, ninput]
            lag_p = np.ascontiguousarray(np.transpose(lag_rs.numpy(), (2, 0, 1)))
            fa_p = np.ascontiguousarray(np.transpose(fa_rs.numpy(), (2, 0, 1)))
            if not (np.all(np.isfinite(lag_p)) and np.all(np.isfinite(fa_p))):
                raise PharmsolError("engine='fused' lag/fa probe produced non-finite values")
            out[int(m)] = (lag_p, fa_p)
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(
            f"engine='fused' could not evaluate the lag/fa equations per dose "
            f"segment: {e}") from e
    if grid.n_rows and any(np.any(v[0] < 0.0) for v in out.values()):
        raise PharmsolError(
            "engine='fused' does not support negative lag times — use the "
            "general engine"
        )
    return out


def _init_states(equation, sp, grid, n_states: int):
    """The init equation as (init_rows [n_states, S] or None, init_planes
    [n_states, R, S] or None) (JAX analytical plan :108-194, ODE plan
    :339-411): one row per support when init reads no covariate, else exact
    planes per (row, support) at t = 0; (None, None) when it is zero."""
    from ...engine.sim import as_vector

    init_fn = equation._init
    cov_vals0 = _classify_covariates(grid)[0] if grid.cov_names else {}
    icov0 = {n: float(np.asarray(v)[0]) for n, v in cov_vals0.items()}
    icov1 = {n: v * 1.31 + 0.17 for n, v in icov0.items()}
    sp_t = _t64(sp)
    t0 = torch.tensor(0.0, dtype=F64)

    def init_at(covd):
        return vmap(lambda p: as_vector(init_fn(p, t0, _RowCov(covd)), p))(sp_t).numpy()

    try:
        i_ref = init_at(icov0)
        i_cov = init_at(icov1) if icov0 else i_ref
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not probe the init equation: {e}") from e
    if not np.all(np.isfinite(i_ref)):
        raise PharmsolError("engine='fused' init probe produced non-finite values")
    if i_ref.shape[1] != n_states:
        raise PharmsolError(
            f"engine='fused' expects init to return {n_states} states, got "
            f"{i_ref.shape[1]}"
        )
    iscale = np.maximum(np.abs(i_ref).max(), 1e-12)
    if not (icov0 and np.abs(i_cov - i_ref).max() > 1e-6 * iscale):
        return (i_ref.T.copy() if np.any(i_ref != 0.0) else None), None
    # covariate-dependent init: exact per (row, support) at t = 0
    cov_at0 = _covariate_values_at(grid, 0.0)
    names = tuple(grid.cov_names)
    cov_mat = _t64(np.stack([cov_at0[n] for n in names], axis=1))  # [R, ncov]

    def init_row(cv):
        covd = {n: cv[i] for i, n in enumerate(names)}
        return vmap(lambda p: as_vector(init_fn(p, t0, _RowCov(covd)), p))(sp_t)

    try:
        planes = vmap(init_row)(cov_mat).numpy()  # [R, S, n_states]
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(
            f"engine='fused' could not evaluate the covariate-dependent init per "
            f"row: {e}") from e
    if not np.all(np.isfinite(planes)):
        raise PharmsolError(
            "engine='fused' covariate-dependent init produced non-finite values")
    if not np.any(planes != 0.0):
        return None, None
    return None, np.ascontiguousarray(np.transpose(planes, (2, 0, 1)))


def _validate_lag_no_overlap(lag_plane: np.ndarray, grid, input_j: int = None) -> None:
    """Refuse a lag under which two doses of a row could pend at once
    (JAX :645): the kernel holds one pending dose, so each row's largest lag
    must stay strictly below its smallest gap between boluses (of input
    ``input_j``; None = all). Negative lags are refused too. ``lag_plane``
    is [R, S], or one row per support [1, S]."""
    if np.any(lag_plane < 0.0):
        raise PharmsolError(
            "engine='fused' does not support negative lag times — use the "
            "general engine"
        )
    bolus_t = np.asarray(grid.rows.bolus_t, dtype=np.float64)
    real = bolus_t < BIG_TIME / 2
    if input_j is not None:
        real = real & (np.asarray(grid.rows.bolus_input) == input_j)
    ts = np.sort(np.where(real, bolus_t, np.inf), axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf between padding slots
        gaps = np.diff(ts, axis=1) if ts.shape[1] > 1 else np.full((ts.shape[0], 1), np.inf)
    gaps = np.where(np.isfinite(gaps), gaps, np.inf)
    min_gap = gaps.min(axis=1)  # [R]; inf for rows with fewer than 2 doses
    lag_max = np.broadcast_to(lag_plane.max(axis=1), min_gap.shape)  # [R]
    # strict: at lag == gap the arriving dose would overwrite the pending
    # one in the very column where it fires
    bad = np.nonzero(lag_max >= min_gap)[0]
    if bad.size:
        r = int(bad[0])
        raise PharmsolError(
            f"engine='fused' lag support requires each dose's lag to elapse "
            f"strictly before the next dose (row {r}: max lag {lag_max[r]:.4g} "
            f">= min inter-dose gap {min_gap[r]:.4g}) — use the general engine"
        )


def _check_out_covariate_free(equation, sp, cov_values, n_states) -> None:
    """Refuse an out() closure whose value depends on a covariate (JAX :684):
    the kernel's output coefficients are per support only."""
    from ...engine.grid import CovView
    from ...ops.fused_psi import extract_linear_out

    n_out = int(equation.nouteqs())
    names = list(cov_values)

    def cov_view(scale, shift):
        vals = np.stack([np.asarray(cov_values[n])[:1] for n in names])  # [C, 1]
        return CovView(torch.zeros((len(names), 1), dtype=F64),
                       _t64(vals * scale + shift),
                       torch.zeros((len(names),), dtype=torch.bool), names)

    try:
        C1, b1 = extract_linear_out(equation._out, sp, n_states, n_out, cov_view(1.0, 0.0))
        C2, b2 = extract_linear_out(equation._out, sp, n_states, n_out, cov_view(1.31, 0.17))
    except Exception:
        return  # extraction problems are diagnosed later by the plan itself
    if not (np.allclose(C1, C2, rtol=1e-9, atol=1e-12)
            and np.allclose(b1, b2, rtol=1e-9, atol=1e-12)):
        raise PharmsolError(
            "engine='fused' requires covariate effects to act through the seq "
            "equation; this model's out() reads a covariate — use the general "
            "engine"
        )


def _decompose_kernel_inputs(kernel_inputs, sp, grid, n_kernel_params: int,
                             allow_mult: bool):
    """Anchored decomposition of a kernel-input mapping (JAX :355-531).

    The declarative and DSL closed forms (``models/declarative.py::
    analytical_model``, ``dsl/runtime.py``) compute the kernel's parameters
    as ``kp(p, t, cov)`` from the DECLARED parameters (any order, derived
    values), so the support is not in kernel order. Writing ``kp_i(p, t,
    cov) = b_i(p) * g_i(t, cov) + h_i(t, cov)`` (covariate scaling and
    additive effects), everything the kernel needs factors through an
    anchor A = (t = 0, the first row's first-knot covariates):

    - the kernel support ``sp_k[s, i] = kp_i(sp_s, A)``, per support;
    - g and h per (row, segment), solved from two parameter probes (kp at
      ``p_ref`` and ``p_alt``, at the anchor and at each segment's end with
      its row's covariates), checked at a third probe ``p_val``.

    No reset/carry chain applies: the propagate re-derives from the raw
    parameters at every segment end. Every (row, segment) pair is probed in
    one nested ``torch.func.vmap`` over the rows' :class:`CovView` and the
    segment-end times, in float64 on the host.

    Returns (sp_kernel [S, P], mult_row [R, P] | None, off_row | None,
    mult_seg [R, P, M] | None, off_seg | None): time-constant effects
    collapse to K1b's row mode, purely multiplicative ones drop the offsets,
    and a mapping with neither time nor covariate effect is K1a on the
    remapped support.
    """
    from ...engine.grid import CovView
    from ...ops.fused_psi import segment_schedule

    tol = 1e-9
    names = list(grid.cov_names)
    cov_t = np.asarray(grid.rows.cov_t, dtype=np.float64)  # [R, C, K]
    cov_v = np.asarray(grid.rows.cov_v, dtype=np.float64)
    fixed = np.asarray(grid.rows.cov_fixed).astype(bool)
    if fixed.ndim == 1 and cov_t.ndim == 3:
        fixed = np.broadcast_to(fixed[None, :], cov_t.shape[:2])

    if names:
        anchor_view = CovView(torch.zeros((len(names), 1), dtype=F64),
                              _t64(cov_v[0, :, :1]),
                              torch.zeros((len(names),), dtype=torch.bool), names)
    else:
        anchor_view = CovView.empty(F64)

    def kp_vec(vals):
        return torch.stack([torch.as_tensor(v, dtype=F64) for v in vals])

    def kp_at_anchor(p_rows, t=0.0):
        tt = torch.tensor(float(t), dtype=F64)
        return vmap(lambda p: kp_vec(kernel_inputs(p, tt, anchor_view)))(
            _t64(p_rows)).numpy()

    def probe_failed(e):
        return PharmsolError(
            f"engine='fused' could not probe the kernel-input mapping: {e}")

    p_ref = np.where(np.abs(sp[0]) > 1e-30, sp[0], 1.0)
    p_alt = p_ref * 1.37 + 0.011
    if np.any(np.abs(p_ref - p_alt) < 1e-9):
        p_alt = p_ref * 1.61 + 0.173
    p_val = p_ref * 0.73 + 0.311
    try:
        sp_kernel = kp_at_anchor(sp)
        kp_ref = kp_at_anchor(p_ref[None, :])[0]  # [P]
        kp_ref_t = kp_at_anchor(p_ref[None, :], t=123.456)[0]
    except PharmsolError:
        raise
    except Exception as e:
        raise probe_failed(e) from e
    if not (np.all(np.isfinite(sp_kernel)) and np.all(np.isfinite(kp_ref))):
        raise PharmsolError(
            "engine='fused' kernel inputs are non-finite at the probe points "
            "— use the general engine"
        )

    time_dependent = not np.allclose(kp_ref, kp_ref_t, rtol=tol, atol=tol)
    cov_varying = bool(names) and cov_t.ndim == 3
    if cov_varying:
        cov_varying = not bool(np.all(cov_v == cov_v[0:1, :, 0:1]))
    if not time_dependent and not cov_varying:
        # a pure reindex/derive over parameters: K1a on the remapped support
        return sp_kernel, None, None, None, None

    if not allow_mult:
        raise PharmsolError(
            "engine='fused' does not support a covariate- or time-dependent "
            "derive with 3-compartment structures (their eigen preparation is "
            "per support) — use the general engine"
        )

    _, t_sorted, seg_dt, _ = segment_schedule(grid.rows)
    R, M = t_sorted.shape
    real = t_sorted < BIG_TIME / 2
    t_real_max = np.max(np.where(real, t_sorted, -np.inf), axis=1)
    t_real_max = np.where(np.isfinite(t_real_max), t_real_max, 0.0)
    te = _t64(np.minimum(t_sorted + seg_dt, t_real_max[:, None]))  # [R, M]
    kt, kv = _t64(cov_t), _t64(cov_v)
    kf = torch.as_tensor(np.ascontiguousarray(fixed))

    def kp_cells(p, cols=slice(None)):
        """kp at every (row, segment end) of the columns ``cols``: [R, P, m]."""
        p_t = _t64(p)

        def one(kt_r, kv_r, kf_r, t_r):
            view = CovView(kt_r, kv_r, kf_r, names)
            return kp_vec(kernel_inputs(p_t, t_r, view))

        cells = vmap(vmap(one, in_dims=(None, None, None, 0)))(kt, kv, kf, te[:, cols])
        return cells.permute(0, 2, 1).numpy()

    sample = sorted({0, M // 2, M - 1})
    try:
        kp_alt = kp_at_anchor(p_alt[None, :])[0]
        kp_val = kp_at_anchor(p_val[None, :])[0]
        f_ref = kp_cells(p_ref)
        f_alt = kp_cells(p_alt)
        f_val = dict(zip(sample, np.moveaxis(kp_cells(p_val, sample), 2, 0)))
    except PharmsolError:
        raise
    except Exception as e:
        raise probe_failed(e) from e
    denom = (kp_ref - kp_alt)[None, :, None]
    if np.any(np.abs(denom) < 1e-30):
        raise PharmsolError(
            "engine='fused' kernel-input mapping is parameter-degenerate at "
            "the probe points — use the general engine"
        )
    g = (f_ref - f_alt) / denom  # [R, P, M]
    h = f_ref - kp_ref[None, :, None] * g
    for m in sample:
        pred = kp_val[None, :] * g[:, :, m] + h[:, :, m]
        scale = np.maximum(np.abs(f_val[m]), 1.0)
        if not (np.all(np.isfinite(pred))
                and np.all(np.abs(pred - f_val[m]) <= tol * 100 * scale)):
            raise PharmsolError(
                "engine='fused' requires affinely separable derive closures "
                "(kp_i = b_i(p) * g_i(t, cov) + h_i(t, cov)); this one mixes "
                "anchored parameter structure with the covariate effect — use "
                "the general engine"
            )
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(h))):
        raise PharmsolError(
            "engine='fused' derive produced non-finite factors — use the "
            "general engine"
        )
    off_zero = np.allclose(h, 0.0, atol=tol * 10)
    if (np.allclose(g, g[:, :, :1], rtol=1e-12, atol=1e-12)
            and np.allclose(h, h[:, :, :1], rtol=1e-12, atol=1e-12)):
        g_row = np.ascontiguousarray(g[:, :, 0])
        h_row = None if off_zero else np.ascontiguousarray(h[:, :, 0])
        return sp_kernel, g_row, h_row, None, None
    return (sp_kernel, None, None, np.ascontiguousarray(g),
            None if off_zero else np.ascontiguousarray(h))
