"""Fused ODE psi plan (``_FusedOdePsiPlan``) and the merged-run lowering.

The counterpart of the JAX package's ``likelihood/plans/ode.py`` for its
explicit tier: the plan validates an ODE model against the CUDA kernel's
scope, generates the kernel's RHS from the model's closure
(:mod:`~pharmsol_tpu_torch.ops.rhs_codegen`, the port's counterpart of the
JAX plan-time probe kernel), builds the segment streams, the output
coefficients and the merged runs on the host, moves them to the device, runs
:func:`~pharmsol_tpu_torch.ops.fused_ode.psi_ode` and sums the occasion rows
into subjects.

Boluses are applied inside the kernel by the RHS difference (two RHS calls at
a dose boundary), which is the general engine's own semantics. So the JAX
plan's host probe of a static per-unit-dose bolus map has no counterpart
here.

In scope: dopri5 and tsit5; boluses and infusions into any input below
``ndrugs``, with one stream per active input; linear outputs; censoring;
several outputs; merged runs. Out of scope, raising PharmsolError so that
``engine='auto'`` takes the general engine and records why: covariates,
lag, fa and init (the port's ODE class refuses the last three), other
solvers, and RHS styles the generator rejects.
"""

from __future__ import annotations

import numpy as np
import torch

from ...errors import PharmsolError

# merged spans are capped at this many segments (the JAX kernel holds one
# carry lane per interior observation; the CUDA kernel keeps the cap so the
# two march the same spans)
_ODE_MERGE_MAX_SPAN = 16


def _ode_merge_runs(streams, seg_t0, solver, *, n_bolus_in, n_rate_in,
                    affine_streams, has_lag):
    """Static (m0, m1) spans whose interior breakpoints the fused ODE kernel
    may cross with dense output.

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
    from ...ops.fused_ode import dense_P_for

    if dense_P_for(solver) is None or has_lag:
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


class _FusedOdePsiPlan:
    """Validated device inputs for one fused ODE psi evaluation.

    Same contract as :class:`~.analytical._FusedPsiPlan`: ``__init__``
    validates (raising PharmsolError for a model outside the kernel's
    scope), :meth:`run` gives psi [n_subjects, S], :meth:`finalize` sums
    occasion rows into subjects.
    """

    def __init__(self, equation, grid, sp, lowered, device, dtype):
        from ...engine.ode import TABLEAUS
        from ...engine.grid import CovView
        from ...ops.fused_psi import extract_linear_out, streams_from_grid
        from ...ops.rhs_codegen import generate_rhs

        if getattr(equation, "kind", None) != "ode":
            raise PharmsolError("engine='fused' ODE psi needs an ODE equation")
        opts = equation._opts
        if opts.solver not in TABLEAUS:
            raise PharmsolError(
                f"engine='fused' ODE psi supports solvers {sorted(TABLEAUS)} "
                f"(model uses `{opts.solver}`)"
            )
        if grid.cov_names:
            raise PharmsolError("the PyTorch port does not support covariates yet")
        self.opts = opts
        self.n_states = n_states = int(equation.nstates())
        self.n_out = int(equation.nouteqs())
        ninput = int(equation.ndrugs())
        self.bolus_inputs, self.rate_inputs = _active_inputs(grid.rows, ninput)

        # the kernel's RHS, generated once per (support width, inputs):
        # PharmsolError here is the plan-time rejection of an RHS style
        key = (int(sp.shape[1]), ninput)
        self.rhs = equation._rhs_cache.get(key)
        if self.rhs is None:
            self.rhs = generate_rhs(equation._diffeq, n_states, int(sp.shape[1]),
                                    ninput)
            equation._rhs_cache[key] = self.rhs

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

        out_fn = equation._out or (lambda x, p, t, cov: x[: self.n_out])
        try:
            C, b = extract_linear_out(out_fn, sp, n_states, self.n_out,
                                      CovView.empty())
        except PharmsolError:
            raise
        except Exception as e:
            raise PharmsolError(
                f"engine='fused' ODE psi could not extract linear output "
                f"coefficients (non-linear output?): {e}"
            ) from e

        # merged-march spans: breakpoints that are observation-only on every
        # row need not stop the adaptive march
        self.merge_runs = _ode_merge_runs(
            [seg_dt, *bol, *rate], seg_t0, opts.solver,
            n_bolus_in=len(self.bolus_inputs), n_rate_in=len(self.rate_inputs),
            affine_streams={}, has_lag=False,
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
            merge_runs=self.merge_runs if merge else None, solver=o.solver,
            rtol=o.rtol, atol=o.atol, h0=o.h0, max_steps=o.max_steps,
        )

    def run(self) -> torch.Tensor:
        """psi [n_subjects, S] on the plan's device."""
        from ...ops.fused_ode import psi_ode

        psi_rows = psi_ode(*self.streams, self.support, self.rhs,
                           **self.kernel_kwargs())
        return self.finalize(psi_rows)

    def finalize(self, psi_rows: torch.Tensor) -> torch.Tensor:
        """Sum occasion rows [R, S] into subjects [n_subjects, S]."""
        psi = torch.zeros((self.n_subjects, self.S), dtype=psi_rows.dtype,
                          device=psi_rows.device)
        return psi.index_add_(0, self.row_subject, psi_rows)
