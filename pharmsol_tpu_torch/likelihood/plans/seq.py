"""Secondary-equation (seq) tiers of the fused analytical psi plan.

The counterpart of the JAX package's ``likelihood/plans/seq.py``. Each tier
turns a ``seq(p, t, cov)`` closure into what kernel K1b reads, cheapest
first:

- per-row affine factors (``_decompose_seq``: time-constant covariates,
  ``seq[i] = p[i] g_i(cov) + h_i(cov)``), the kernel's ``row`` mode;
- per-segment affine factors with the engine's reset/carry chain baked in
  (``_decompose_seq_tv``: time-varying covariates, infusion-end
  compounding), ``segment`` mode;
- chain-depth level tables (``_decompose_seq_levels``: covariate-free,
  time-independent seq of any form), ``levels`` mode;
- per-(row, support) parameter planes (``_decompose_seq_planes``:
  time-constant covariates in any form), ``planes`` mode;
- segment-indexed planes (``_decompose_seq_segplanes``: seq reading t or a
  time-varying covariate in any form, without lag), ``planes`` mode;
- with lag, the event codes of ``_seq_depth_stream(lag_mode=True)`` for a
  chain deeper than one (kernel K1c's in-kernel depth counter), and
  per-column main and post planes (``_decompose_seq_colplanes``: lag with a
  time-varying or time-dependent seq, K1c's split march).

Levels and planes are in the structure's micro-constant parameterization
(the CL remap applied here); the kernel derives the eigen quantities. The
closures run on the host in float64 through ``torch.func.vmap``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ...config import BIG_TIME
from ...engine.sim import as_vector
from ...errors import PharmsolError
from .decompose import (
    F64,
    _RowCov,
    _affine_solve,
    _classify_covariates,
    _constant_covariate_values,
    _t64,
)

_MAX_SEQ_LEVELS = 8
# the planes tiers materialise [L, n_base, R, S] float64 on the host: a cap
# keeps a pathological population from swallowing host memory
_MAX_PLANE_FLOATS = 1 << 27
# segment-indexed planes: past this many distinct chain values per row the
# level select stops paying for itself
_MAX_SEQ_SEGPLANES = 16

# the probes' tolerance: the closures run in float64 on the host
_TOL = 1e-9


def _probe_points(sp):
    p_ref = np.where(np.abs(sp[0]) > 1e-30, sp[0], 1.0)
    p_alt = p_ref * 1.37 + 0.011
    if np.any(np.abs(p_ref - p_alt) < 1e-9):
        p_alt = p_ref * 1.61 + 0.173
    return p_ref, p_alt, p_ref * 0.73 + 0.311


def _seq_fn(seq):
    """seq on one support row with a covariate view, as a float64 vector."""
    return lambda p, t, cov: as_vector(seq(p, t, cov), p)


def _knots(grid):
    """The rows' covariate knots as float64 tensors ([R, 0, 1] without
    covariates), for per-row CovViews."""
    R = grid.n_rows
    if not grid.cov_names:
        z = torch.zeros((R, 0, 1), dtype=F64)
        return z, z, torch.zeros((R, 0), dtype=torch.bool)
    return (_t64(grid.rows.cov_t), _t64(grid.rows.cov_v),
            torch.as_tensor(np.asarray(grid.rows.cov_fixed).astype(bool)))


def _segment_end_times(t_sorted, seg_dt):
    """Each segment's end time, padding clamped to the row's last real
    breakpoint so closures reading t stay finite."""
    real = t_sorted < BIG_TIME / 2
    t_real_max = np.max(np.where(real, t_sorted, -np.inf), axis=1)
    t_real_max = np.where(np.isfinite(t_real_max), t_real_max, 0.0)
    return np.minimum(t_sorted + seg_dt, t_real_max[:, None])


def _decompose_seq(seq, sp, cov_values: dict, n_kernel_params: int,
                   n_rows_total: int = 1):
    """Per-row diagonal-affine factors of a time-independent seq (JAX :31).

    Probes: seq must not change with t, and ``seq[i] = p[i] g_i(cov) +
    h_i(cov)`` solved from two parameter probes must hold at a third.
    Returns (mult [R, k], offset [R, k] or None when identically zero).
    """
    n_rows = len(next(iter(cov_values.values()))) if cov_values else n_rows_total
    p_ref, p_alt, p_val = _probe_points(sp)
    f = _seq_fn(seq)

    def eval_rows(p, t):
        p, t = _t64(p), torch.tensor(float(t), dtype=F64)
        if cov_values:
            names = list(cov_values)
            stacked = _t64(np.stack([np.asarray(v) for v in cov_values.values()], axis=1))
            return vmap(lambda row: f(p, t, _RowCov(
                {n: row[i] for i, n in enumerate(names)})))(stacked).numpy()
        out = f(p, t, _RowCov({})).numpy()
        return np.broadcast_to(out[None, :], (n_rows, out.shape[0])).copy()

    try:
        out_ref = eval_rows(p_ref, 0.0)
        out_t = eval_rows(p_ref, 123.456)
        out_alt = eval_rows(p_alt, 0.0)
        out_val = eval_rows(p_val, 0.0)
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not probe the seq equation: {e}") from e
    if not np.allclose(out_ref, out_t, rtol=_TOL, atol=_TOL):
        raise PharmsolError(
            "engine='fused' requires a time-independent seq equation "
            "(this one changes with t; use the general engine)"
        )
    k = n_kernel_params
    solved = _affine_solve(out_ref[:, :k], out_alt[:, :k], out_val[:, :k],
                           p_ref[None, :k], p_alt[None, :k], p_val[None, :k], _TOL)
    if solved is None:
        raise PharmsolError(
            "engine='fused' requires diagonal-affine covariate effects "
            "(seq[i] = p[i] * g_i(cov) + h_i(cov)); this seq equation mixes "
            "parameters or is nonlinear — use the general engine"
        )
    g, h = solved
    if np.allclose(h, 0.0, atol=_TOL * 10):
        return np.ascontiguousarray(g), None
    return np.ascontiguousarray(g), np.ascontiguousarray(h)


def _decompose_seq_tv(seq, sp, grid, n_kernel_params: int):
    """Per-row, per-segment diagonal-affine factors (JAX :110).

    The factors are evaluated at each segment's end (the engine evaluates
    seq at ``t + dt``) through each row's own CovView, and the engine's
    reset/carry chain is baked in: parameters reset to the support point at
    real events and compound across infusion-end sub-splits
    (analytical/mod.rs:331,360). Returns (mult_seg [R, k, M], offset_seg
    [R, k, M] or None).
    """
    from ...engine.grid import CovView
    from ...ops.fused_psi import segment_schedule

    _, t_sorted, seg_dt, is_event = segment_schedule(grid.rows)
    R, M = t_sorted.shape
    k = n_kernel_params
    p_ref, p_alt, p_val = _probe_points(sp)
    te = _segment_end_times(t_sorted, seg_dt)
    names = list(grid.cov_names)
    kt, kv, kf = _knots(grid)
    f = _seq_fn(seq)

    def values_at(p, m):
        p_t = _t64(p)
        out = vmap(lambda ct, cv, cf, t: f(p_t, t, CovView(ct, cv, cf, names)))(
            kt, kv, kf, _t64(te[:, m])).numpy()
        if out.shape[1] != sp.shape[1]:
            # the engine carries the seq output as the next p_base
            raise PharmsolError(
                "engine='fused' seq must return exactly the support width — "
                "use the general engine"
            )
        return out[:, :k]

    sample = {0, M // 2, M - 1}
    try:
        f_ref = np.stack([values_at(p_ref, m) for m in range(M)], axis=2)
        f_alt = np.stack([values_at(p_alt, m) for m in range(M)], axis=2)
        f_vals = {m: values_at(p_val, m) for m in sample}
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not probe the seq equation: {e}") from e
    g = (f_ref - f_alt) / (p_ref - p_alt)[None, :k, None]  # [R, k, M]
    h = f_ref - g * p_ref[None, :k, None]
    for m in sample:
        pred = g[:, :, m] * p_val[None, :k] + h[:, :, m]
        scale = np.maximum(np.abs(f_vals[m]), 1.0)
        if not (np.all(np.isfinite(pred))
                and np.all(np.abs(pred - f_vals[m]) <= _TOL * 100 * scale)):
            raise PharmsolError(
                "engine='fused' requires diagonal-affine covariate effects "
                "(seq[i] = p[i] * g_i(t, cov) + h_i(t, cov)); this seq equation "
                "mixes parameters or is nonlinear — use the general engine"
            )
    if not (np.all(np.isfinite(g)) and np.all(np.isfinite(h))):
        raise PharmsolError(
            "engine='fused' seq decomposition produced non-finite factors — "
            "use the general engine"
        )
    # the engine's chain: p_base = support at events, else carried;
    # p_seg = affine_m(p_base) on spanned segments, p_base otherwise
    mult = np.empty_like(g)
    off = np.empty_like(h)
    prev_g = np.ones((R, k))
    prev_h = np.zeros((R, k))
    for m in range(M):
        ev = is_event[:, m][:, None]
        base_g = np.where(ev, 1.0, prev_g)
        base_h = np.where(ev, 0.0, prev_h)
        span = seg_dt[:, m][:, None] > 0
        prev_g = mult[:, :, m] = np.where(span, g[:, :, m] * base_g, base_g)
        prev_h = off[:, :, m] = np.where(span, g[:, :, m] * base_h + h[:, :, m], base_h)
    if np.allclose(off, 0.0, atol=_TOL * 10):
        return np.ascontiguousarray(mult), None
    return np.ascontiguousarray(mult), np.ascontiguousarray(off)


def _seq_depth_stream(grid, lag_mode: bool = False):
    """Chain depth per (row, segment) under the engine's reset/carry rule
    (JAX :253): (depth [R, M], 1-based, 0 on dead segments; L = max depth).

    ``lag_mode=True`` gives instead the upper bound L of the chain depth
    when lag-shifted doses move the resets (no dose firing), which decides
    whether a lag plan needs the in-kernel depth counter (kernel K1c): the
    first element is then the per-column event codes (1 observation or
    infusion start, 2 infusion end, 0 bolus column or padding).
    """
    from ...ops.fused_psi import segment_schedule

    if not lag_mode:
        _, t_sorted, seg_dt, is_event = segment_schedule(grid.rows)
        R, M = t_sorted.shape
        depth = np.zeros((R, M), dtype=np.float64)
        d_cur = np.zeros(R, dtype=np.int64)
        for m in range(M):
            base = np.where(is_event[:, m], 0, d_cur)
            span = seg_dt[:, m] > 0
            d_cur = np.where(span, base + 1, base)
            depth[:, m] = np.where(span, d_cur, 0)
        L = max(int(depth.max()), 1)  # no spanned segment: one trivial level
        if L > _MAX_SEQ_LEVELS:
            raise PharmsolError(
                f"engine='fused' seq chain depth {L} exceeds {_MAX_SEQ_LEVELS} "
                "— use the general engine"
            )
        return depth, L

    _, t_sorted, seg_dt, _, rank = segment_schedule(grid.rows, with_ranks=True)
    R, M = t_sorted.shape
    real = t_sorted < BIG_TIME / 2
    evcode = np.zeros((R, M), dtype=np.float64)
    evcode[real & ((rank == 1.0) | (rank == 3.0))] = 1.0  # obs / inf-start
    evcode[real & (rank == 0.0)] = 2.0  # infusion-end sub-split
    # a zero-amount bolus still resets the chain in the engine but carries
    # no dose whose firing could
    b_t = np.asarray(grid.rows.bolus_t, np.float64)
    b_a = np.asarray(grid.rows.bolus_amt, np.float64)
    if np.any((b_t < BIG_TIME / 2) & (b_a == 0.0)):
        raise PharmsolError(
            "engine='fused' lag with a seq chain does not support zero-amount "
            "bolus records — use the general engine"
        )
    # the counter with no dose firing: fires only reset the chain, so this
    # bounds every column's depth
    dc = np.zeros(R, dtype=np.int64)
    app = np.zeros(R, dtype=bool)
    max_d = 1
    for m in range(M):
        span = seg_dt[:, m] > 0
        code = evcode[:, m]
        dc = np.where(code == 1.0, np.where(span, 1, 0),
                      np.where(code == 2.0, dc + span, dc + (span & ~app)))
        app = np.where(code == 1.0, span, np.where(code == 2.0, span, app | span))
        max_d = max(max_d, int(np.where(span, dc, 0).max(initial=0)))
    if max_d > _MAX_SEQ_LEVELS:
        raise PharmsolError(
            f"engine='fused' seq chain depth {max_d} (lag no-fire bound) "
            f"exceeds {_MAX_SEQ_LEVELS} — use the general engine"
        )
    return evcode, max_d


def _n_base(sdef, k: int) -> int:
    remap = sdef["remap"]
    return len(remap([1.0] * k)) if remap else k


def _micro_rows(sdef, rows):
    """The structure's micro-constant rows of the kernel columns ``rows``."""
    return sdef["remap"](rows) if sdef["remap"] else rows


def _decompose_seq_levels(seq, sp, grid, sdef, n_kernel_params: int,
                          lag_mode: bool = False):
    """Chain-depth level tables of a covariate-free, time-independent seq of
    any form (JAX :342): ``p_seg = seq^d(p)`` with the depth d a function of
    the row's events only. Returns (param_levels [L, n_base, S] in
    micro-constants, seg_depth [R, M]); with ``lag_mode`` the second element
    is the event-code stream of :func:`_seq_depth_stream`.
    """
    p_ref = _probe_points(sp)[0]
    cov_values = _constant_covariate_values(grid) if grid.cov_names else {}
    cov0 = {n: float(np.asarray(v)[0]) for n, v in cov_values.items()}
    cov1 = {n: v * 1.31 + 0.17 for n, v in cov0.items()}
    f = _seq_fn(seq)

    def seq_once(p_rows, t, covd):
        tt = torch.tensor(float(t), dtype=F64)
        return vmap(lambda p: f(p, tt, _RowCov(covd)))(_t64(p_rows)).numpy()

    try:
        f0 = seq_once(p_ref[None, :], 0.0, cov0)
        ft = seq_once(p_ref[None, :], 123.456, cov0)
        fc = seq_once(p_ref[None, :], 0.0, cov1)
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not probe the seq equation: {e}") from e
    scale = np.maximum(np.abs(f0).max(), 1.0)
    if np.abs(ft - f0).max() > _TOL * scale:
        raise PharmsolError(
            "engine='fused' seq levels require a time-independent seq equation "
            "— use the general engine"
        )
    if cov0 and np.abs(fc - f0).max() > _TOL * scale:
        raise PharmsolError(
            "engine='fused' seq levels require a covariate-free seq equation "
            "— use the general engine"
        )
    depth, L = _seq_depth_stream(grid, lag_mode)
    k = n_kernel_params
    levels = []
    cur = np.asarray(sp, np.float64)
    try:
        for _ in range(L):
            cur = seq_once(cur, 0.0, cov0)
            if cur.shape[1] < sp.shape[1]:
                raise PharmsolError(
                    "engine='fused' seq returned fewer columns than the support "
                    "width — use the general engine"
                )
            levels.append(np.stack(_micro_rows(sdef, [cur[:, i] for i in range(k)]),
                                   axis=0))  # [n_base, S]
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not iterate the seq equation: {e}") from e
    param_levels = np.stack(levels, axis=0)  # [L, n_base, S]
    if not np.all(np.isfinite(param_levels)):
        raise PharmsolError(
            "engine='fused' seq level tables are non-finite — use the general engine"
        )
    return np.ascontiguousarray(param_levels), np.ascontiguousarray(depth)


def _decompose_seq_planes(seq, sp, grid, sdef, n_kernel_params: int,
                          lag_mode: bool = False):
    """Per-(row, support) parameter planes of a time-independent seq that
    reads time-constant covariates in any form (JAX :438). Returns
    (param_planes [L, n_base, R, S] in micro-constants, seg_depth [R, M] or,
    with ``lag_mode``, the event codes)."""
    p_ref = _probe_points(sp)[0]
    cov_values, varying = _classify_covariates(grid) if grid.cov_names else ({}, set())
    names = list(cov_values)
    cov0 = {n: float(np.asarray(v)[0]) for n, v in cov_values.items()}
    cov_var = {n: (v * 1.31 + 0.17 if n in varying else v) for n, v in cov0.items()}
    f = _seq_fn(seq)

    def seq_once(p_rows, t, covd):
        tt = torch.tensor(float(t), dtype=F64)
        return vmap(lambda p: f(p, tt, _RowCov(covd)))(_t64(p_rows)).numpy()

    try:
        f0 = seq_once(p_ref[None, :], 0.0, cov0)
        ft = seq_once(p_ref[None, :], 123.456, cov0)
        fv = seq_once(p_ref[None, :], 0.0, cov_var) if varying else f0
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not probe the seq equation: {e}") from e
    scale = np.maximum(np.abs(f0).max(), 1.0)
    if np.abs(ft - f0).max() > _TOL * scale:
        raise PharmsolError(
            "engine='fused' seq planes require a time-independent seq equation "
            "— use the general engine"
        )
    if varying and np.abs(fv - f0).max() > _TOL * scale:
        raise PharmsolError(
            "engine='fused' seq planes require the seq equation not to read a "
            "time-varying covariate — use the general engine"
        )
    depth, L = _seq_depth_stream(grid, lag_mode)
    R, S = grid.n_rows, sp.shape[0]
    k = n_kernel_params
    n_base = _n_base(sdef, k)
    if L * n_base * R * S > _MAX_PLANE_FLOATS:
        raise PharmsolError(
            "engine='fused' covariate-dependent seq planes would exceed the "
            f"memory cap ({L}x{n_base}x{R}x{S} cells) — use the general engine"
        )
    cov_mat = (_t64(np.stack([np.asarray(cov_values[n]) for n in names], axis=1))
               if names else torch.zeros((R, 0), dtype=F64))
    tt = torch.tensor(0.0, dtype=F64)

    def step_row(cur_row, cov_row):
        covd = {n: cov_row[i] for i, n in enumerate(names)}
        return vmap(lambda p: f(p, tt, _RowCov(covd)))(cur_row)

    levels = []
    cur = _t64(sp).unsqueeze(0).expand(R, S, sp.shape[1])
    try:
        for _ in range(L):
            cur = vmap(step_row)(cur, cov_mat)  # [R, S, ncols]
            arr = cur.numpy()
            if arr.shape[2] < sp.shape[1]:
                raise PharmsolError(
                    "engine='fused' seq returned fewer columns than the support "
                    "width — use the general engine"
                )
            levels.append(np.stack(_micro_rows(sdef, [arr[:, :, i] for i in range(k)]),
                                   axis=0))  # [n_base, R, S]
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(
            f"engine='fused' could not iterate the seq equation per row: {e}") from e
    param_planes = np.stack(levels, axis=0)  # [L, n_base, R, S]
    if not np.all(np.isfinite(param_planes)):
        raise PharmsolError(
            "engine='fused' seq parameter planes are non-finite — use the "
            "general engine"
        )
    return np.ascontiguousarray(param_planes), np.ascontiguousarray(depth)


def _decompose_seq_segplanes(seq, sp, grid, sdef, n_kernel_params: int):
    """Exact segment-indexed parameter planes (JAX :568): seq reading t
    and/or a time-varying covariate in any form, without lag. The engine's
    chain ``p_base`` (support at real events, carried otherwise) and
    ``p_seg = seq(p_base, t + dt, cov)`` is walked on the host with each
    row's own CovView; distinct chain values per row become level slots.
    Returns (param_planes [L, n_base, R, S], slot stream [R, M] 1-based, 0 on
    dead segments).
    """
    from ...engine.grid import CovView
    from ...ops.fused_psi import segment_schedule

    _, t_sorted, seg_dt, is_event = segment_schedule(grid.rows)
    R, M = t_sorted.shape
    S = sp.shape[0]
    k = n_kernel_params
    n_base = _n_base(sdef, k)
    if M * n_base * R * S > _MAX_PLANE_FLOATS:
        raise PharmsolError(
            "engine='fused' segment-indexed seq planes would exceed the memory "
            f"cap ({M}x{n_base}x{R}x{S} cells) — use the general engine"
        )
    te = _segment_end_times(t_sorted, seg_dt)
    names = list(grid.cov_names)
    kt, kv, kf = _knots(grid)
    span_np = seg_dt > 0.0
    f = _seq_fn(seq)

    def per_row(p_rows, t_r, kt_r, kv_r, kf_r):
        cv = CovView(kt_r, kv_r, kf_r, names)
        return vmap(lambda p: f(p, t_r, cv))(p_rows)

    eval_col = vmap(per_row)
    col_planes = [None] * M  # spanned columns -> [n_base, R, S]
    sp_t = _t64(sp)
    try:
        cur = sp_t.unsqueeze(0).expand(R, S, sp.shape[1])
        for m in range(M):
            base = torch.where(torch.as_tensor(is_event[:, m]).view(R, 1, 1),
                               sp_t.unsqueeze(0), cur)
            if not span_np[:, m].any():
                cur = base
                continue
            new = eval_col(base, _t64(te[:, m]), kt, kv, kf)
            arr = new.numpy()
            if arr.shape[2] != sp.shape[1]:
                raise PharmsolError(
                    "engine='fused' seq must return exactly the support width "
                    "for segment-indexed planes — use the general engine"
                )
            col_planes[m] = np.stack(
                _micro_rows(sdef, [arr[:, :, i] for i in range(k)]), axis=0)
            cur = torch.where(torch.as_tensor(span_np[:, m]).view(R, 1, 1), new, base)
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(
            f"engine='fused' could not walk the seq chain per segment: {e}") from e

    # per-row dedup of spanned-column chain values into level slots
    depth = np.zeros((R, M), np.float64)
    slot_maps = [{} for _ in range(R)]
    planes_rows = [[] for _ in range(R)]  # r -> list of [n_base, S]
    for m in range(M):
        pm = col_planes[m]
        if pm is None:
            continue
        for r in np.nonzero(span_np[:, m])[0]:
            key = pm[:, r, :].tobytes()
            sl = slot_maps[r].setdefault(key, len(slot_maps[r]))
            if sl == len(planes_rows[r]):
                planes_rows[r].append(pm[:, r, :])
            depth[r, m] = sl + 1
    L = max([len(x) for x in planes_rows] + [1])
    if L > _MAX_SEQ_SEGPLANES:
        raise PharmsolError(
            f"engine='fused' segment-indexed seq planes need {L} slots "
            f"(> {_MAX_SEQ_SEGPLANES}) — use the general engine"
        )
    if L * n_base * R * S > _MAX_PLANE_FLOATS:
        raise PharmsolError(
            "engine='fused' segment-indexed seq planes would exceed the memory "
            f"cap ({L}x{n_base}x{R}x{S} cells) — use the general engine"
        )
    # rows without a spanned segment never select a slot: fill them with the
    # remapped support so every plane cell stays finite
    fill = np.stack(_micro_rows(sdef, [np.asarray(sp[:, i], np.float64)
                                       for i in range(k)]), axis=0)  # [n_base, S]
    param_planes = np.empty((L, n_base, R, S), np.float64)
    for r in range(R):
        lst = planes_rows[r] or [fill]
        for l in range(L):
            param_planes[l, :, r, :] = lst[min(l, len(lst) - 1)]
    if not np.all(np.isfinite(param_planes)):
        raise PharmsolError(
            "engine='fused' segment-indexed seq planes are non-finite — use the "
            "general engine"
        )
    return np.ascontiguousarray(param_planes), np.ascontiguousarray(depth)


# lag + time-varying seq column planes: main and post chain values share one
# slot space per row; past this many slots the select stops paying for itself
_MAX_SEQ_COLPLANES = 24


def _colplanes_dynamic_lag(equation, sp, grid, ninput: int) -> dict:
    """Per-dose-column [R, S] lag planes of a lag closure that changes with
    time or reads a time-varying covariate (JAX :733): evaluated on the host
    at each bolus's own breakpoint time with the engine's CovView. Returns
    ``{column m: [R, S]}`` for :func:`_decompose_seq_colplanes` (the
    closed-form kernel doses input 0: its plane applies)."""
    from ...ops.fused_psi import segment_schedule
    from .decompose import _decompose_input_seg_planes

    _, t_sorted, _, _, rank = segment_schedule(grid.rows, with_ranks=True)
    real = t_sorted < BIG_TIME / 2
    t_real_max = np.max(np.where(real, t_sorted, -np.inf), axis=1)
    t_real_max = np.where(np.isfinite(t_real_max), t_real_max, 0.0)
    t0 = np.minimum(t_sorted, t_real_max[:, None])
    dose_cols = sorted(int(m) for m in np.nonzero((real & (rank == 2.0)).any(axis=0))[0])
    if not dose_cols:
        raise PharmsolError(
            "engine='fused' dynamic lag with a time-varying seq found no dose "
            "columns — use the general engine")
    seg_pl = _decompose_input_seg_planes(equation, sp, grid, ninput, dose_cols, t0)
    return {m: np.asarray(seg_pl[m][0][0], np.float64) for m in dose_cols}


def _dedup_row_slots(main, post, span):
    """Per-row slots of the main and post chain values (JAX :968-990): each
    row's distinct [n_base, S] contents, numbered in order of first use over
    the columns (main before post). ``main``/``post`` [M, n_base, R, S],
    ``span`` [R, M]. Returns (slot stream [R, M], post slot stream [R, M],
    1-based, 0 on dead columns, and per row the list of its contents).

    Vectorised: each (row, column) content is keyed by a dot product with
    fixed random weights; contents sharing a key are then checked equal, so
    the grouping is exact."""
    M, n_base, R, S = main.shape
    w = np.random.RandomState(0).uniform(0.5, 1.5, (n_base, S))
    both = np.stack([main, post], axis=1)  # [M, 2, n_base, R, S]
    keys = np.einsum("mkbrs,bs->rmk", both, w).reshape(R, 2 * M)
    live = np.repeat(span, 2, axis=1)  # [R, 2M]
    depth = np.zeros((R, M), np.float64)
    postdepth = np.zeros((R, M), np.float64)
    planes_rows = []
    for r in range(R):
        cols = np.nonzero(live[r])[0]
        if cols.size == 0:
            planes_rows.append([])
            continue
        _, first, inverse = np.unique(keys[r, cols], return_index=True,
                                      return_inverse=True)
        rank = np.empty(first.size, np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(first.size)
        slot = rank[inverse]
        reps = [None] * first.size
        for c, sl in zip(cols, slot):
            content = both[c // 2, c % 2, :, r, :]
            if reps[sl] is None:
                reps[sl] = content
            elif not np.array_equal(reps[sl], content, equal_nan=True):
                raise PharmsolError(
                    "engine='fused' lag+tv-seq column planes: two chain values "
                    "share a key — use the general engine")
        for c, sl in zip(cols, slot):
            (depth if c % 2 == 0 else postdepth)[r, c // 2] = sl + 1
        planes_rows.append(reps)
    return depth, postdepth, planes_rows


def _decompose_seq_colplanes(seq, sp, grid, sdef, n_kernel_params: int, lag_probe):
    """Per-column exact planes for lag combined with a time-varying or
    time-dependent seq (JAX :764), the kernel's ``lag_post`` tier (K1c).

    A lag moves each dose's seq-reset breakpoint to the per-(row, support)
    fire time ``t_dose + lag``, host-known for a static lag plane [R, S]
    (or one row per support [1, S], broadcast over the rows) or for
    per-dose-column planes ``{m: [R, S]}``
    (:func:`_colplanes_dynamic_lag`). Each lane's merged event schedule (the
    static observation and infusion events plus its own fire times, in the
    engine's tie order) is walked with the closure through the row's own
    CovView at each spanned segment's end; the walk runs over every (row,
    support) lane at once, one event at a time. ``main[m]`` is the chain
    value governing column m's span start, ``post[m]`` the value after a
    fire inside column m (main where none lands). Both dedup per row into
    one slot space. Returns (param_planes [L, n_base, R, S], seg_depth
    [R, M] main slots, seg_postdepth [R, M] post slots), 1-based; raises
    PharmsolError past the slot and memory caps.
    """
    from ...engine.grid import CovView
    from ...ops.fused_psi import segment_schedule

    _, t_sorted, seg_dt, _, rank = segment_schedule(grid.rows, with_ranks=True)
    R, M = t_sorted.shape
    S = sp.shape[0]
    k = n_kernel_params
    n_base = _n_base(sdef, k)
    real = t_sorted < BIG_TIME / 2
    t_real_max = np.max(np.where(real, t_sorted, -np.inf), axis=1)
    t_real_max = np.where(np.isfinite(t_real_max), t_real_max, 0.0)

    # a real zero-amount bolus resets the chain but has no dose to fire
    b_t = np.asarray(grid.rows.bolus_t, np.float64)
    b_a = np.asarray(grid.rows.bolus_amt, np.float64)
    if np.any((b_t < BIG_TIME / 2) & (b_a == 0.0)):
        raise PharmsolError(
            "engine='fused' lag with a time-varying seq does not support "
            "zero-amount bolus records — use the general engine")

    # static chain events: observation (1) and infusion start (3) reset,
    # infusion end (0) compounds; bolus columns (2) moved with their lag.
    # The grid's start leads as a reset, so pre-fire spans chain from raw.
    stat_mask = real & (rank != 2.0)
    n_stat = stat_mask.sum(axis=1)
    E1 = int(n_stat.max(initial=0)) + 1
    pos = np.cumsum(stat_mask, axis=1)  # 1-based slot of each static event
    stat_t = np.full((R, E1), BIG_TIME, np.float64)
    stat_code = np.ones((R, E1), np.float64)
    stat_t[:, 0] = np.where(real.any(axis=1), t_sorted[:, 0], 0.0)
    rr, mm = np.nonzero(stat_mask)
    stat_t[rr, pos[rr, mm]] = t_sorted[rr, mm]
    stat_code[rr, pos[rr, mm]] = np.where(rank[rr, mm] == 0.0, 0.0, 1.0)

    # doses: each row's bolus columns, fired at t + lag[r, s]
    dose_mask = real & (rank == 2.0)
    ND = max(int(dose_mask.sum(axis=1).max(initial=0)), 1)
    dpos = np.cumsum(dose_mask, axis=1) - 1
    dose_t = np.full((R, ND), BIG_TIME, np.float64)
    dose_col = np.zeros((R, ND), np.int64)
    has_dose = np.zeros((R, ND), bool)
    rr, mm = np.nonzero(dose_mask)
    dose_t[rr, dpos[rr, mm]] = t_sorted[rr, mm]
    dose_col[rr, dpos[rr, mm]] = mm
    has_dose[rr, dpos[rr, mm]] = True

    E = E1 + ND
    if M * n_base * R * S > _MAX_PLANE_FLOATS or E * R * S * sp.shape[1] > _MAX_PLANE_FLOATS:
        raise PharmsolError(
            "engine='fused' lag+tv-seq column planes would exceed the memory "
            f"cap ({M}x{n_base}x{R}x{S} cells) — use the general engine")

    # the lag of every (row, support, dose)
    if isinstance(lag_probe, dict):
        lag_nd = np.zeros((R, S, ND), np.float64)
        for jd in range(ND):
            for m in np.unique(dose_col[has_dose[:, jd], jd]):
                rows = np.nonzero(has_dose[:, jd] & (dose_col[:, jd] == m))[0]
                lag_nd[rows, :, jd] = lag_probe[int(m)][rows, :]
    else:
        lag_nd = np.broadcast_to(np.asarray(lag_probe, np.float64)[:, :, None],
                                 (R, S, ND)).copy()

    # every lane's merged schedule, sorted with the static events first on
    # ties (stable), then walked one event at a time over all lanes
    fire_t = dose_t[:, None, :] + lag_nd  # [R, S, ND]
    times = np.concatenate([np.broadcast_to(stat_t[:, None, :], (R, S, E1)), fire_t], axis=2)
    codes = np.concatenate([np.broadcast_to(stat_code[:, None, :], (R, S, E1)),
                            np.ones((R, S, ND))], axis=2)
    order = np.argsort(times, axis=2, kind="stable")
    times = np.take_along_axis(times, order, axis=2)
    codes = np.take_along_axis(codes, order, axis=2)
    ends = np.concatenate([times[..., 1:], times[..., -1:]], axis=2)
    t_eval = np.minimum(ends, t_real_max[:, None, None])

    names = list(grid.cov_names)
    kt, kv, kf = _knots(grid)
    f = _seq_fn(seq)

    def per_row(p_rows, t_rs, kt_r, kv_r, kf_r):
        cv = CovView(kt_r, kv_r, kf_r, names)
        return vmap(lambda p, t: f(p, t, cv))(p_rows, t_rs)

    eval_lanes = vmap(per_row)
    raw = _t64(sp).unsqueeze(0).expand(R, S, sp.shape[1])
    seg_vals = np.empty((R, S, E, sp.shape[1]), np.float64)
    try:
        cur = raw
        for i in range(E):
            base = torch.where(torch.as_tensor(codes[..., i] == 1.0)[..., None], raw, cur)
            new = eval_lanes(base, _t64(t_eval[..., i]), kt, kv, kf)
            if new.shape[-1] != sp.shape[1]:
                raise PharmsolError(
                    "engine='fused' seq must return exactly the support width for "
                    "lag+tv-seq column planes — use the general engine")
            span = torch.as_tensor(ends[..., i] > times[..., i])[..., None]
            cur = torch.where(span, new, base)
            seg_vals[:, :, i, :] = cur.numpy()
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(f"engine='fused' could not walk the lag+seq chain: {e}") from e

    # main[m]: the segment holding column m's start (after all ties)
    idx_main = np.clip((times[:, :, None, :] <= t_sorted[:, None, :, None]).sum(axis=3) - 1,
                       0, E - 1)  # [R, S, M]
    main_vals = np.take_along_axis(seg_vals, idx_main[..., None], axis=2)  # [R, S, M, nc]
    # post[m]: the segment starting at a fire inside column m
    post_vals = main_vals.copy()
    for j in range(ND):
        fire = dose_t[:, j][:, None] + lag_nd[:, :, j]  # [R, S]
        live = has_dose[:, j][:, None] & (fire < BIG_TIME / 2)
        if not live.any():
            continue
        col_j = np.clip((t_sorted[:, None, :] <= fire[:, :, None]).sum(axis=2) - 1, 0, M - 1)
        idx_af = np.clip((times <= fire[:, :, None]).sum(axis=2) - 1, 0, E - 1)
        val_j = np.take_along_axis(seg_vals, idx_af[:, :, None, None], axis=2)[:, :, 0, :]
        r_ix, s_ix = np.nonzero(live)
        post_vals[r_ix, s_ix, col_j[r_ix, s_ix], :] = val_j[r_ix, s_ix, :]

    def to_base(vals):  # [R, S, M, nc] -> [M, n_base, R, S]
        rows = _micro_rows(sdef, [vals[..., i] for i in range(k)])
        return np.stack(rows, axis=0).transpose(3, 0, 1, 2)

    depth, postdepth, planes_rows = _dedup_row_slots(
        to_base(main_vals), to_base(post_vals), seg_dt > 0.0)
    L = max([len(x) for x in planes_rows] + [1])
    if L > _MAX_SEQ_COLPLANES:
        raise PharmsolError(
            f"engine='fused' lag+tv-seq column planes need {L} slots "
            f"(> {_MAX_SEQ_COLPLANES}) — use the general engine")
    if L * n_base * R * S > _MAX_PLANE_FLOATS:
        raise PharmsolError(
            "engine='fused' lag+tv-seq column planes would exceed the memory "
            f"cap ({L}x{n_base}x{R}x{S} cells) — use the general engine")
    fill = np.stack(_micro_rows(sdef, [np.asarray(sp[:, i], np.float64)
                                       for i in range(k)]), axis=0)  # [n_base, S]
    param_planes = np.empty((L, n_base, R, S), np.float64)
    for r in range(R):
        lst = planes_rows[r] or [fill]
        for lv in range(L):
            param_planes[lv, :, r, :] = lst[min(lv, len(lst) - 1)]
    if not np.all(np.isfinite(param_planes)):
        raise PharmsolError(
            "engine='fused' lag+tv-seq column planes are non-finite — use the "
            "general engine")
    return (np.ascontiguousarray(param_planes), np.ascontiguousarray(depth),
            np.ascontiguousarray(postdepth))
