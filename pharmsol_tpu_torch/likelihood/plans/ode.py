"""Fused ODE psi plan (``_FusedOdePsiPlan``) and the merged-run lowering.

The counterpart of the JAX package's ``likelihood/plans/ode.py`` for its
explicit and feature tiers: the plan validates an ODE model against the CUDA
kernel's scope, generates the kernel's RHS from the model's closure
(:mod:`~pharmsol_tpu_torch.ops.rhs_codegen`, the port's counterpart of the
JAX plan-time probe kernel), builds the segment streams, the feature inputs,
the output coefficients and the merged runs on the host, moves them to the
device, runs :func:`~pharmsol_tpu_torch.ops.fused_ode.psi_ode` and sums the
occasion rows into subjects.

Boluses are applied inside the kernel by the RHS difference (two RHS calls at
a dose boundary), which is the general engine's own semantics. So the JAX
plan's host probe of a static per-unit-dose bolus map has no counterpart
here.

In scope: dopri5, tsit5; expm (the exact propagation tier, kernel K2d,
for an RHS that host probes find affine in the state and autonomous, with
covariates constant within every segment; it never merges runs); trbdf2,
kvaerno3 (= esdirk34) and kvaerno5 (the SDIRK tier, kernel K2b; the first two
merge runs, captured by cubic Hermite, kvaerno5 never does) and bdf (the BDF
tier, kernel K2c, orders 1 to ``bdf_max_order``, never merged); the implicit
tiers and expm need the RHS's Jacobian columns, generated beside the RHS;
boluses and infusions into any input below
``ndrugs``, with one stream per active input; linear outputs; censoring;
several outputs; merged runs. With any of the following the plan runs kernel
K2e instead of K2a: covariates (a per-row constant, or a per-segment affine
``(a, b)`` stream, exact when every knot lies on a breakpoint); init (rows
per support, or planes per (row, support) when it reads a covariate); lag
and fa (static planes, or per-dose-segment planes selected by slot tables
when they change with time or read a time-varying covariate). Out of scope,
raising PharmsolError with the JAX plan's reason so that ``engine='auto'``
takes the general engine and records why: an RHS with an operation that has
no Jacobian rule under a solver that needs one, a covariate knot inside a
segment, a lag that does not elapse before the input's next dose,
a negative lag, an ``out`` that reads a covariate, and closures the
generator rejects. The RHS is taken list-style or, where that fails on
lists, vector-style (``torch.zeros_like(x)``, writes with static indices,
whole-vector arithmetic), as the JAX plan's lane-then-stacked retry; the
host probes call it in that style.
"""

from __future__ import annotations

import numpy as np
import torch

from ...errors import PharmsolError
from .decompose import (
    _InputPlaneDynamic,
    _RowCov,
    _affine_covariate_streams,
    _check_out_covariate_free,
    _classify_covariates,
    _decompose_input_planes,
    _decompose_input_seg_planes,
    _init_states,
    _t64,
    _validate_lag_no_overlap,
)
from .split import RowSplit

# merged spans are capped at this many segments (the JAX kernel holds one
# carry lane per interior observation; the CUDA kernel keeps the cap so the
# two march the same spans)
_ODE_MERGE_MAX_SPAN = 16


def _ode_merge_runs(streams, seg_t0, solver, *, n_bolus_in, n_rate_in,
                    affine_streams, has_lag):
    """Static (m0, m1) spans whose interior breakpoints the fused ODE kernel
    may cross with dense output (the explicit pairs' quartic interpolant,
    the cubic Hermite of trbdf2 and kvaerno3/esdirk34; kvaerno5, bdf and expm
    never merge, and neither does a model with lag).

    ``streams`` is ``[seg_dt, bolus per active input..., rate per active
    input..., ...]`` as numpy [R, M]. A breakpoint m (the start of column m)
    is crossable iff on EVERY row: no bolus lands there (any input), the
    infusion rates and time-varying covariate affine (a, b) streams are
    identical across it, and the segment times are contiguous
    (t0[m] == t0[m-1] + dt[m-1]; dead trailing columns satisfy this with dt
    0). Returns None when no span would merge (the kernel then runs the
    classic per-segment march). The JAX function's ``PHARMSOL_ODE_NO_MERGE``
    switch is not copied: ``_FusedOdePsiPlan.kernel_kwargs(merge=False)``
    gives the per-segment march.
    """
    from ...engine.ode import SDIRK_TABLEAUS
    from ...ops.fused_ode import dense_P_for

    if (dense_P_for(solver) is None and solver not in SDIRK_TABLEAUS) or has_lag:
        return None
    if solver in SDIRK_TABLEAUS and SDIRK_TABLEAUS[solver]["order"] > 3.0:
        # the cubic Hermite capture is order-matched only for the 2nd and 3rd
        # order stiffly accurate pairs: kvaerno5 marches segment by segment
        return None
    dt_np = np.asarray(streams[0], np.float64)
    M = dt_np.shape[1]
    if M < 2:
        return None
    mergeable = np.ones(M, dtype=bool)
    mergeable[0] = False
    for b in range(n_bolus_in):
        bol = np.asarray(streams[1 + b], np.float64)
        mergeable &= np.all(bol == 0.0, axis=0)
    for r in range(n_rate_in):
        rate = np.asarray(streams[1 + n_bolus_in + r], np.float64)
        mergeable[1:] &= np.all(rate[:, 1:] == rate[:, :-1], axis=0)
    for a, bb in affine_streams.values():
        a = np.asarray(a, np.float64)
        bb = np.asarray(bb, np.float64)
        mergeable[1:] &= np.all(a[:, 1:] == a[:, :-1], axis=0)
        mergeable[1:] &= np.all(bb[:, 1:] == bb[:, :-1], axis=0)
    t0_np = np.asarray(seg_t0, np.float64)
    cont = np.abs(t0_np[:, 1:] - (t0_np[:, :-1] + dt_np[:, :-1])) \
        <= 1e-9 * np.maximum(1.0, np.abs(t0_np[:, 1:]))
    mergeable[1:] &= np.all(cont, axis=0)
    runs = []
    start = 0
    for m in range(1, M + 1):
        if m == M or not mergeable[m] or (m - start) >= _ODE_MERGE_MAX_SPAN:
            runs.append((start, m))
            start = m
    if all(b - a == 1 for a, b in runs):
        return None
    return tuple(runs)


def _active_inputs(rows, ninput: int):
    """The RHS inputs that receive boluses and infusions (one stream each;
    (0,) when none does), as the JAX plan."""
    from ...config import BIG_TIME

    bt = np.asarray(rows.bolus_t, np.float64)
    ba = np.asarray(rows.bolus_amt, np.float64)
    bi = np.asarray(rows.bolus_input)
    real_b = (bt < BIG_TIME / 2) & (ba != 0.0)
    bolus_inputs = tuple(sorted({int(j) for j in bi[real_b]})) or (0,)
    rate_inputs = (0,)
    it = np.asarray(rows.inf_t, np.float64)
    if it.size:
        ia = np.asarray(rows.inf_amt, np.float64)
        ii = np.asarray(rows.inf_input)
        real_i = (it < BIG_TIME / 2) & (ia != 0.0)
        rate_inputs = tuple(sorted({int(j) for j in ii[real_i]})) or (0,)
    if max(bolus_inputs + rate_inputs) >= ninput:
        raise PharmsolError(
            f"engine='fused' psi: a dose targets input >= ndrugs ({ninput})"
        )
    return bolus_inputs, rate_inputs


def _seg_t0(rows):
    """Start time of every segment [R, M], the last real breakpoint time on
    padding columns (as the JAX plans)."""
    from ...config import BIG_TIME
    from ...ops.fused_psi import segment_schedule

    _, t_sorted, _, _ = segment_schedule(rows)
    real = t_sorted < BIG_TIME / 2
    t_real_max = np.max(np.where(real, t_sorted, -np.inf), axis=1)
    t_real_max = np.where(np.isfinite(t_real_max), t_real_max, 0.0)
    return np.minimum(t_sorted, t_real_max[:, None])


def _lag_fa_planes(equation, sp, grid, ninput: int, bolus_inputs, bol, seg_t0):
    """The lag and fa inputs of kernel K2e (JAX :530-625): ``(lag_planes,
    fa_planes, lag_slots, fa_slots)``, each plane stack [n, R, S] float64 or
    None (a lag of 0 everywhere, an fa of 1 everywhere).

    Static path: one plane per bolus plane, the closure constant in time and
    reading no time-varying covariate (:func:`_decompose_input_planes`); the
    lag of each input must elapse strictly before that input's next dose.
    Dynamic path, for the other closures: exact planes per dose-carrying
    segment (:func:`_decompose_input_seg_planes`), selected by the
    ``[nb][M]`` slot tables (-1 where no bolus lands), with the no-overlap
    check dose by dose. ``bol`` [nb, R, M] are the bolus streams.
    """
    sel = list(bolus_inputs)
    lag_fn, fa_fn = equation._lag, equation._fa
    lag_planes = fa_planes = None
    if lag_fn is None and fa_fn is None:
        return None, None, None, None
    try:
        if lag_fn is not None:
            lp = _decompose_input_planes(lag_fn, sp, grid, ninput, 0.0, "lag")[sel]
            for k, j in enumerate(bolus_inputs):
                if np.any(lp[k] != 0.0):
                    _validate_lag_no_overlap(lp[k], grid, input_j=j)
            lag_planes = lp if np.any(lp != 0.0) else None
        if fa_fn is not None:
            fp = _decompose_input_planes(fa_fn, sp, grid, ninput, 1.0, "fa")[sel]
            fa_planes = fp if not np.all(fp == 1.0) else None
        return lag_planes, fa_planes, None, None
    except _InputPlaneDynamic:
        pass
    nb, M = len(sel), bol.shape[2]
    dose_cols = [m for m in range(M) if np.any(bol[:, :, m] != 0.0)]
    seg_pl = _decompose_input_seg_planes(equation, sp, grid, ninput, dose_cols, seg_t0)
    has_lag = lag_fn is not None and any(np.any(seg_pl[m][0][sel] != 0.0) for m in dose_cols)
    has_fa = fa_fn is not None and any(not np.all(seg_pl[m][1][sel] == 1.0) for m in dose_cols)
    if has_lag:
        # each dose's lag (largest over the supports) must elapse strictly
        # before the same input's next dose: a pending slot holds one dose
        for k, j in enumerate(sel):
            for r in range(bol.shape[1]):
                cols = sorted((m for m in dose_cols if bol[k, r, m] != 0.0),
                              key=lambda m: seg_t0[r, m])
                for m1, m2 in zip(cols, cols[1:]):
                    gap = seg_t0[r, m2] - seg_t0[r, m1]
                    lag_max = seg_pl[m1][0][j, r, :].max()
                    if lag_max >= gap:
                        raise PharmsolError(
                            f"engine='fused' lag support requires each dose's lag to "
                            f"elapse strictly before the input's next dose (row {r}, "
                            f"input {j}: max lag {lag_max:.4g} >= gap {gap:.4g}) — use "
                            "the general engine"
                        )

    def slotted(which):
        planes, slots = [], [[-1] * M for _ in range(nb)]
        for m in dose_cols:
            for k in range(nb):
                slots[k][m] = len(planes)
                planes.append(seg_pl[m][which][sel][k])
        return np.stack(planes), tuple(tuple(row) for row in slots)

    lag_planes, lag_slots = slotted(0) if has_lag else (None, None)
    fa_planes, fa_slots = slotted(1) if has_fa else (None, None)
    return lag_planes, fa_planes, lag_slots, fa_slots


def _check_expm_rhs(rhs, sp, n_states: int, ninput: int, rate_inputs, cov_values):
    """The contracts of the exact propagation tier (JAX :274-337), checked
    once on the host in float64 over every support: the RHS is affine in the
    state (a superposition probe) and autonomous (a probe at two times),
    under both covariate probes and every rate probe. The kernel trusts
    them; the general engine checks them at run time and poisons the lane.
    ``rhs`` is the model's GeneratedRhs: its closure is called in its style.
    Raises PharmsolError naming the probe that failed."""
    from ...ops.fused_ode import call_rhs

    S = sp.shape[0]
    p_lanes = list(_t64(sp).t())
    x_a = np.linspace(0.7, 1.9, n_states)
    x_b = np.flip(x_a) * 1.31 + 0.23
    cov0 = {n: float(np.asarray(v)[0]) for n, v in cov_values.items()}
    cov1 = {n: v * 1.31 + 0.17 for n, v in cov0.items()}
    rate_probes = [np.zeros(ninput)]
    for j in rate_inputs:
        rv = np.zeros(ninput)
        rv[j] = 1.73
        rate_probes.append(rv)
    zero = torch.zeros(S, dtype=torch.float64)

    def ev(x, t, covd, rv):
        out = call_rhs(rhs, [zero + float(v) for v in x], p_lanes, zero + t, [zero] * ninput,
                       [zero + float(v) for v in rv], _RowCov(covd), (S,), torch.float64,
                       zero.device)
        return torch.stack(out, dim=1).numpy()

    try:
        for covd in (cov0, cov1):
            for rv in rate_probes:
                f0 = ev(np.zeros(n_states), 0.11, covd, rv)
                fa_p = ev(x_a, 0.11, covd, rv)
                fb_p = ev(x_b, 0.11, covd, rv)
                fab = ev(x_a + x_b, 0.11, covd, rv)
                pscale = 1.0 + np.abs(fa_p).max() + np.abs(fb_p).max()
                if np.abs(fab + f0 - fa_p - fb_p).max() > 1e-6 * pscale:
                    raise PharmsolError(
                        "engine='fused' expm psi requires an RHS AFFINE in the "
                        "state (dx = A(p, cov) x + u); the superposition probe "
                        "failed — use an adaptive solver or the general engine"
                    )
                fa_t = ev(x_a, 17.31, covd, rv)
                if np.abs(fa_t - fa_p).max() > 1e-6 * pscale:
                    raise PharmsolError(
                        "engine='fused' expm psi requires an RHS autonomous "
                        "within segments (no direct t reads) — use the general "
                        "engine"
                    )
    except PharmsolError:
        raise
    except Exception as e:
        raise PharmsolError(
            f"engine='fused' could not probe RHS affinity for expm: {e}") from e


class _FusedOdePsiPlan(RowSplit):
    """Validated device inputs for one fused ODE psi evaluation.

    Same contract as :class:`~.analytical._FusedPsiPlan`: ``__init__``
    validates (raising PharmsolError for a model outside the kernel's
    scope), :meth:`run` gives psi [n_subjects, S], :meth:`finalize` sums
    occasion rows into subjects. ``features`` holds K2e's inputs (all None
    or empty: kernel K2a).
    """

    def __init__(self, equation, grid, sp, lowered, device, dtype,
                 bdf_max_order: int = None):
        from ...engine.ode import EXPM_SOLVERS, check_solver
        from ...engine.grid import CovView
        from ...ops.fused_ode import BDF_DEFAULT_MAX_ORDER, JACOBIAN_SOLVERS
        from ...ops.fused_psi import extract_linear_out, streams_from_grid
        from ...ops.rhs_codegen import generate_rhs

        if getattr(equation, "kind", None) != "ode":
            raise PharmsolError("engine='fused' ODE psi needs an ODE equation")
        opts = equation._opts
        check_solver(opts.solver)
        use_expm = opts.solver in EXPM_SOLVERS
        # the kernel's name for the solver (`expm_rolled` is an alias)
        self.solver = "expm" if use_expm else opts.solver
        need_jac = self.solver in JACOBIAN_SOLVERS
        # the BDF tier's order cap (the JAX kernel's default unless given)
        self.bdf_max_order = int(BDF_DEFAULT_MAX_ORDER if bdf_max_order is None
                                 else bdf_max_order)
        self.opts = opts
        self.n_states = n_states = int(equation.nstates())
        self.n_out = int(equation.nouteqs())
        ninput = int(equation.ndrugs())
        self.bolus_inputs, self.rate_inputs = _active_inputs(grid.rows, ninput)
        # covariates constant over every row ride one value per row; the
        # others per-segment affine (a, b) streams (JAX :168-173)
        cov_values, varying = _classify_covariates(grid)
        self.cov_names = tuple(grid.cov_names)
        self.cov_modes = tuple("affine" if n in varying else "const" for n in self.cov_names)

        init_rows = init_planes = None
        if equation._init is not None:
            init_rows, init_planes = _init_states(equation, sp, grid, n_states)

        # the kernel's RHS, generated once per (support width, inputs,
        # covariates): PharmsolError here is the plan-time rejection of an
        # RHS the generator cannot express in either style (lanes, then
        # vector-style code: ``self.rhs.style``, JAX ``rhs_style``)
        # with expm or an implicit solver, also its Jacobian columns
        # (rhs_jvp): part of the key
        key = (int(sp.shape[1]), ninput, self.cov_names, self.cov_modes, need_jac)
        self.rhs = equation._rhs_cache.get(key)
        if self.rhs is None:
            self.rhs = generate_rhs(equation._diffeq, n_states, int(sp.shape[1]),
                                    ninput, self.cov_names, self.cov_modes,
                                    jacobian=need_jac)
            equation._rhs_cache[key] = self.rhs
        if use_expm:
            _check_expm_rhs(self.rhs, sp, n_states, ninput, self.rate_inputs, cov_values)
        if grid.cov_names and equation._out is not None:
            _check_out_covariate_free(equation, sp, cov_values, n_states)

        try:
            streams = streams_from_grid(grid.rows, lowered, inputs=ninput)
        except ValueError as e:
            raise PharmsolError(f"engine='fused' ODE psi: {e}") from e
        (seg_dt, seg_bolus3, seg_rate3, mask, value, sigma, cens,
         outeq) = streams
        bol = np.stack([seg_bolus3[..., j] for j in self.bolus_inputs])
        rate = np.stack([seg_rate3[..., j] for j in self.rate_inputs])
        seg_t0 = _seg_t0(grid.rows)
        self.R, self.M = seg_dt.shape
        self.S = sp.shape[0]
        self.device, self.dtype = device, dtype

        lag_planes, fa_planes, self.lag_slots, self.fa_slots = _lag_fa_planes(
            equation, sp, grid, ninput, self.bolus_inputs, bol, seg_t0)
        affine = (_affine_covariate_streams(grid, sorted(varying), seg_t0, seg_dt)
                  if varying else {})
        if use_expm:
            # expm is exact only for an RHS autonomous within the segment: a
            # covariate that interpolates linearly with a nonzero slope makes
            # it time-dependent (carry-forward covariates ride affine streams
            # with b == 0 and stay exact)
            for name, (_a_s, b_s) in affine.items():
                if np.any(np.asarray(b_s, np.float64) != 0.0):
                    raise PharmsolError(
                        f"engine='fused' expm psi requires covariates constant "
                        f"within segments; `{name}` interpolates linearly with "
                        f"a nonzero slope — use an adaptive solver or the "
                        f"general engine"
                    )
        cov_streams = {}
        for name in self.cov_names:
            if name in affine:
                cov_streams[name] = affine[name]
            else:
                vs = np.zeros((self.R, self.M))
                vs[:, 0] = cov_values[name]
                cov_streams[name] = vs

        out_fn = equation._out or (lambda x, p, t, cov: x[: self.n_out])
        # occasion 0's covariates: _check_out_covariate_free proved out()
        # reads none that matter
        cov0 = CovView(_t64(grid.rows.cov_t[0]), _t64(grid.rows.cov_v[0]),
                       torch.as_tensor(np.asarray(grid.rows.cov_fixed[0]).astype(bool)),
                       grid.cov_names)
        try:
            C, b = extract_linear_out(out_fn, sp, n_states, self.n_out, cov0)
        except PharmsolError:
            raise
        except Exception as e:
            raise PharmsolError(
                f"engine='fused' ODE psi could not extract linear output "
                f"coefficients (non-linear output?): {e}"
            ) from e

        # merged-march spans: breakpoints that are observation-only on every
        # row, with the rates and the covariates' affine streams unchanged,
        # need not stop the adaptive march; none with lag
        self.merge_runs = _ode_merge_runs(
            [seg_dt, *bol, *rate], seg_t0, self.solver,
            n_bolus_in=len(self.bolus_inputs), n_rate_in=len(self.rate_inputs),
            affine_streams=affine, has_lag=lag_planes is not None,
        )

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        # all-zero optional streams are passed as None: the kernel skips the
        # work and reads nothing
        self.streams = (
            dev(seg_dt), dev(bol), dev(rate) if np.any(rate) else None,
            dev(mask), dev(value), dev(sigma),
            dev(cens) if np.any(cens) else None,
            dev(seg_t0),
        )
        self.outeq = dev(outeq) if self.n_out > 1 else None
        self.support = dev(sp)
        self.out_coef = dev(np.transpose(C, (1, 2, 0)))  # [n_out, n_states, S]
        self.out_bias = dev(b.T) if np.any(b) else None
        has_init = init_rows is not None or init_planes is not None
        self.features = dict(
            cov_streams={n: (tuple(dev(x) for x in v) if isinstance(v, tuple) else dev(v))
                         for n, v in cov_streams.items()},
            cov_names=self.cov_names,
            init_rows=dev(init_rows) if init_rows is not None else None,
            init_planes=dev(init_planes) if init_planes is not None else None,
            init_mask=(dev(np.asarray(grid.rows.init_mask, np.float64).reshape(-1))
                       if has_init else None),
            lag_plane=dev(lag_planes) if lag_planes is not None else None,
            fa_plane=dev(fa_planes) if fa_planes is not None else None,
            lag_slots=self.lag_slots, fa_slots=self.fa_slots,
        )
        self.row_subject = torch.as_tensor(
            np.asarray(grid.row_subject, dtype=np.int64), device=device)
        self.n_subjects = grid.n_subjects

    def kernel_kwargs(self, merge: bool = True) -> dict:
        """Keyword arguments of psi_ode / psi_ode_plain for this plan
        (``merge=False`` marches segment by segment)."""
        o = self.opts
        return dict(
            obs_outeq=self.outeq, out_coef=self.out_coef, out_bias=self.out_bias,
            bolus_inputs=self.bolus_inputs, rate_inputs=self.rate_inputs,
            merge_runs=self.merge_runs if merge else None, solver=self.solver,
            rtol=o.rtol, atol=o.atol, h0=o.h0, max_steps=o.max_steps,
            newton_iters=o.newton_iters, bdf_max_order=self.bdf_max_order,
            **self.features,
        )

    def launch_spec(self):
        """``psi_ode``'s arguments with their row axes
        (:class:`~.split.RowSplit`): the bolus and rate stacks ``[n, R, M]``,
        the lag/fa planes ``[n, R, S]`` and the init planes on axis 1, the
        other streams, the covariate streams and the init mask on axis 0;
        the support, the output coefficients and the init rows shared."""
        from ...ops.fused_ode import psi_ode

        axes = {0: 0, 1: 1, 2: 1, 3: 0, 4: 0, 5: 0, 6: 0, 7: 0, 8: None, "obs_outeq": 0,
                "out_coef": None, "out_bias": None, "cov_streams": 0, "init_rows": None,
                "init_mask": 0, "init_planes": 1, "lag_plane": 1, "fa_plane": 1}
        return psi_ode, (*self.streams, self.support, self.rhs), self.kernel_kwargs(), axes

    def run(self) -> torch.Tensor:
        """psi [n_subjects, S] on the plan's device."""
        return self.finalize(self.run_rows())

    def finalize(self, psi_rows: torch.Tensor) -> torch.Tensor:
        """Sum occasion rows [R, S] into subjects [n_subjects, S]."""
        psi = torch.zeros((self.n_subjects, self.S), dtype=psi_rows.dtype,
                          device=psi_rows.device)
        return psi.index_add_(0, self.row_subject, psi_rows)
