"""Fused analytical psi plan (``_FusedPsiPlan``): base and feature tiers.

The counterpart of the JAX package's ``likelihood/plans/analytical.py::
_PallasPsiPlan`` (:81-684). It validates the model against the kernel's
scope, builds the segment streams, the linear output coefficients and the
feature inputs on the host, moves them to the device, runs
:func:`~pharmsol_tpu_torch.ops.fused_psi.psi_analytical` and sums the
occasion rows into subjects on the device. A model without seq, lag, fa or
init runs kernel K1a; any of them runs kernel K1b:

- a kernel-input mapping (the declarative and DSL closed forms:
  ``_fused_structure``, ``_kernel_inputs``, ``_bolus_dest``): the kernel
  reads the remapped support, and row or segment multipliers and offsets
  where the mapping reads covariates or time
  (``plans/decompose.py::_decompose_kernel_inputs``); a pure reorder or
  derive over the parameters is K1a;
- init: per-support initial states, or per-(row, support) planes when the
  init equation reads covariates;
- seq, cheapest tier first (``plans/seq.py``): per-row affine factors
  (``row`` mode), per-segment affine factors (``segment``), chain-depth
  level tables (``levels``), per-(row, support) planes or segment-indexed
  planes (``planes``);
- lag and fa that are static in time: one row per support where the
  closure reads no covariate, else per-(row, support) planes.

With any of the following the kernel runs its K1c paths (JAX :290-500):

- lag or fa that changes with time or reads a time-varying covariate:
  per-dose-segment planes selected by ``lag_slots``/``fa_slots``;
- lag with a seq chain deeper than one (infusion-end compounding): the
  event-code stream ``seg_evcode`` drives an in-kernel depth counter and a
  split march at the fire (``lag_depth``);
- lag with a time-varying or time-dependent seq: per-column main and post
  planes, ``seg_depth`` and ``seg_postdepth`` (``lag_post``).

Lag with per-segment streams, overlapping and negative lags, and a zero fa
cell under ``lag_depth``/``lag_post`` (the dose would never fire its seq
reset) raise PharmsolError as in the JAX plan, and ``engine='auto'``
records the reason and takes the general engine.

Every shape is passed as it is: the kernels take ragged R and S, so there is
no row or support padding, and the working dtype is kept.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import BIG_TIME
from ...errors import PharmsolError
from .decompose import (
    _InputPlaneDynamic,
    _check_out_covariate_free,
    _constant_covariate_values,
    _decompose_input_plane,
    _decompose_kernel_inputs,
    _init_states,
    _t64,
    _validate_lag_no_overlap,
)
from .seq import (
    _colplanes_dynamic_lag,
    _decompose_seq,
    _decompose_seq_colplanes,
    _decompose_seq_levels,
    _decompose_seq_planes,
    _decompose_seq_segplanes,
    _decompose_seq_tv,
    _seq_depth_stream,
)

def _fused_structure_name(equation) -> str:
    """Map an Analytical equation to a fused psi structure: the structure a
    declarative or DSL closed form declares (JAX ``_pallas_structure_name``
    :19-45), else the built-in kernel its ``eq`` is."""
    from ...engine.analytical import KERNELS
    from ...ops.fused_psi import STRUCTURES

    declared = getattr(equation, "_fused_structure", None)
    if declared is not None:  # the authoring surfaces name it directly
        if declared not in STRUCTURES:
            raise PharmsolError(
                f"analytical structure `{declared}` has no fused psi "
                f"structure (available: {', '.join(sorted(STRUCTURES))})"
            )
        return declared
    eq_fn = getattr(equation, "_eq", None)
    for name, (fn, _, _) in KERNELS.items():
        if fn is eq_fn:
            if name not in STRUCTURES:
                raise PharmsolError(
                    f"analytical kernel `{name}` has no fused psi structure "
                    f"(available: {', '.join(sorted(STRUCTURES))})"
                )
            return name
    raise PharmsolError(
        "engine='fused' requires an Analytical equation built on a named "
        "built-in kernel (one_compartment, two_compartments, "
        "*_with_absorption, *_cl, ...)"
    )


class _FusedPsiPlan:
    """Validated device inputs for one fused psi evaluation.

    Raises PharmsolError when the model is outside the kernels' scope; the
    caller (``engine='auto'``) then takes the general engine and records
    the reason. ``mode`` is K1b's parameter mode (None, ``row``,
    ``segment``, ``levels``, ``planes``); ``features`` holds the feature
    inputs on the device (all None: kernel K1a), with K1c's ``seg_evcode``,
    ``seg_postdepth`` and the slot tables ``lag_slots``/``fa_slots``.
    """

    def __init__(self, equation, grid, sp, lowered, device, dtype):
        from ...engine.grid import CovView
        from ...ops.fused_psi import (
            FEATURES, STRUCTURES, extract_linear_out, streams_from_grid,
        )

        if getattr(equation, "kind", None) != "analytical":
            raise PharmsolError(
                "engine='fused' covers closed-form (Analytical) models only"
            )
        self.structure = _fused_structure_name(equation)
        sdef = STRUCTURES[self.structure]
        n_kernel_params = sdef["n_params"]
        n_states = sdef["n_states"]
        # the authoring surfaces map their declared columns onto the
        # kernel's parameters (JAX :87-107): the width check holds only for
        # kernel-order supports, and their boluses must land where the
        # structure doses
        kernel_inputs = getattr(equation, "_kernel_inputs", None)
        if kernel_inputs is not None:
            dest = getattr(equation, "_bolus_dest", None)
            if dest and int(dest[0]) != int(sdef["dose_state"]):
                raise PharmsolError(
                    f"engine='fused' with `{self.structure}` expects the bolus "
                    f"route to target state {sdef['dose_state']}, this model "
                    f"doses state {dest[0]} — use the general engine"
                )
        elif sp.shape[1] < n_kernel_params:
            raise PharmsolError(
                f"engine='fused' with `{self.structure}` needs support columns "
                f"[{n_kernel_params} kernel params..., out params...], got "
                f"{sp.shape[1]} columns"
            )
        if int(equation.nstates()) != n_states:
            raise PharmsolError(
                f"engine='fused' with `{self.structure}` expects nstates="
                f"{n_states}, got {equation.nstates()}"
            )
        self.n_out = int(equation.nouteqs())
        f = dict.fromkeys(FEATURES)
        if equation._init is not None:
            f["init_rows"], f["init_planes"] = _init_states(equation, sp, grid, n_states)

        # the lag probe first: an active lag changes which seq tiers hold
        ninput = int(equation.ndrugs())
        lag_probe = None
        lag_active = dynamic = False
        if equation._lag is not None:
            try:
                lag_probe = _decompose_input_plane(equation._lag, sp, grid, ninput,
                                                   0.0, "lag", rows=True)
                lag_active = bool(np.any(lag_probe != 0.0))
            except _InputPlaneDynamic:
                # per-dose-segment planes, built with the streams below
                lag_active = dynamic = True
        cov_values = {}
        mode = None
        sp_kernel = None
        if kernel_inputs is not None:
            (sp_kernel, f["param_mult"], f["param_offset"], f["param_mult_seg"],
             f["param_offset_seg"]) = _decompose_kernel_inputs(
                kernel_inputs, sp, grid, n_kernel_params, allow_mult=sdef["eigs"] is None)
            mode = ("row" if f["param_mult"] is not None
                    else "segment" if f["param_mult_seg"] is not None else None)
        elif equation._seq is not None:
            mode, cov_values = self._seq_tier(equation, sp, grid, sdef, lag_active,
                                              dynamic, lag_probe, ninput, f)
        if lag_active and mode == "segment":
            raise PharmsolError(
                "engine='fused' does not support lag together with "
                "per-segment seq streams (a lag-shifted dose adds a seq-reset "
                "breakpoint the host-side affine chain cannot express) — use "
                "the general engine"
            )
        if lag_active and not dynamic:
            _validate_lag_no_overlap(lag_probe, grid)
            f["lag_plane"] = lag_probe
        if equation._fa is not None and not dynamic:
            try:
                fp = _decompose_input_plane(equation._fa, sp, grid, ninput, 1.0, "fa",
                                            rows=True)
                if np.any(fp != 1.0):
                    f["fa_plane"] = fp
            except _InputPlaneDynamic:
                # fa is taken at the lag-shifted time: both closures go per
                # dose segment
                dynamic = True
                f["lag_plane"] = None
        if grid.cov_names and equation._out is not None:
            # covariates act through seq only: out() must be support-only
            # for the per-support output coefficients to hold
            if not cov_values:
                cov_v3 = np.asarray(grid.rows.cov_v, dtype=np.float64)
                cov_values = {n: cov_v3[:, c, 0] for c, n in enumerate(grid.cov_names)}
            _check_out_covariate_free(equation, sp, cov_values, n_states)
        self.mode = mode

        try:
            streams = streams_from_grid(grid.rows, lowered)
        except ValueError as e:
            raise PharmsolError(f"engine='fused': {e}") from e
        self.R, self.M = streams[0].shape
        self.S = sp.shape[0]
        self.device, self.dtype = device, dtype
        self.lag_slots = self.fa_slots = None
        if dynamic:
            self._dynamic_lag_fa(equation, sp, grid, ninput, streams[1], f)
        if f["seg_evcode"] is not None and f["lag_plane"] is None:
            # every per-dose lag came back zero: no dose fires in the kernel,
            # so boluses reset the chain at their own breakpoints and the
            # plain depth stream holds
            f["seg_evcode"] = None
            f["seg_depth"], _ = _seq_depth_stream(grid)
        if f["seg_evcode"] is not None or f["seg_postdepth"] is not None:
            # the split march fires on a nonzero pending dose: an fa cell of
            # exactly 0 would never fire the seq reset the engine applies at
            # the shifted dose
            fas = f["fa_plane"] if isinstance(f["fa_plane"], list) else [f["fa_plane"]]
            if any(fp is not None and np.any(np.asarray(fp) == 0.0) for fp in fas):
                raise PharmsolError(
                    "engine='fused' lag combined with seq does not support "
                    "bioavailability cells that are exactly zero (the pending "
                    "dose would never fire its seq reset) — use the general engine")
        self.mode = mode
        if f["init_rows"] is not None or f["init_planes"] is not None:
            f["init_mask"] = np.asarray(grid.rows.init_mask, np.float64).reshape(-1)

        # output coefficients: y_k = C_k(p) . x + b_k(p), per support point,
        # extracted on the host in float64 with the first row's covariates
        out_fn = equation._out or (lambda x, p, t, cov: x[: self.n_out])
        cov0 = CovView(_t64(grid.rows.cov_t[0]), _t64(grid.rows.cov_v[0]),
                       torch.as_tensor(np.asarray(grid.rows.cov_fixed[0]).astype(bool)),
                       grid.cov_names)
        try:
            C, b = extract_linear_out(out_fn, sp, n_states, self.n_out, cov0)
        except PharmsolError:
            raise
        except Exception as e:
            raise PharmsolError(
                f"engine='fused' could not extract linear output "
                f"coefficients for `{self.structure}` (support columns "
                f"mismatch or non-linear output): {e}"
            ) from e

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        # all-zero optional streams are passed as None: the kernel skips
        # the infusion / censoring work and reads no outeq stream
        (seg_dt, seg_bolus, seg_rate, mask, value, sigma, cens,
         outeq) = streams
        self.streams = (
            dev(seg_dt), dev(seg_bolus),
            dev(seg_rate) if np.any(seg_rate) else None,
            dev(mask), dev(value), dev(sigma),
            dev(cens) if np.any(cens) else None,
        )
        self.outeq = dev(outeq) if self.n_out > 1 else None
        # the kernel reads the remapped support of a kernel-input mapping;
        # the output coefficients above keep the declared one
        self.support = dev(sp if sp_kernel is None else sp_kernel)
        self.out_coef = dev(np.transpose(C, (1, 2, 0)))  # [n_out, n_states, S]
        self.out_bias = dev(b.T) if np.any(b) else None
        self.features = {k: (None if v is None else [dev(x) for x in v]
                             if isinstance(v, list) else dev(v)) for k, v in f.items()}
        self.features.update(lag_slots=self.lag_slots, fa_slots=self.fa_slots)
        self.row_subject = torch.as_tensor(
            np.asarray(grid.row_subject, dtype=np.int64), device=device)
        self.n_subjects = grid.n_subjects

    def _dynamic_lag_fa(self, equation, sp, grid, ninput, seg_bolus, f):
        """Per-dose-segment lag and fa planes with their ``[M]`` slot tables
        (JAX :411-483), the ODE plan's (``plans/ode.py::_lag_fa_planes``) for
        the one bolus input: the closures evaluated on the host at each
        bolus's breakpoint (lag at its own time, fa at the shifted one), each
        dose's largest lag to elapse strictly before the row's next dose."""
        from .ode import _lag_fa_planes, _seg_t0

        bol = np.asarray(seg_bolus, np.float64)[None]
        lag, fa, lag_slots, fa_slots = _lag_fa_planes(
            equation, sp, grid, ninput, (0,), bol, _seg_t0(grid.rows))
        f["lag_plane"] = list(lag) if lag is not None else None
        f["fa_plane"] = list(fa) if fa is not None else None
        self.lag_slots = lag_slots[0] if lag_slots is not None else None
        self.fa_slots = fa_slots[0] if fa_slots is not None else None

    def _seq_tier(self, equation, sp, grid, sdef, lag_active, dynamic, lag_probe,
                  ninput, f):
        """Pick the cheapest seq tier that holds (JAX :229-352); fills ``f``
        and returns (mode, the per-row covariate values it read)."""
        seq = equation._seq
        k = sdef["n_params"]
        cov_values = {}
        affine_err = None
        if sdef["eigs"] is None:
            # affine tiers: 1- and 2-compartment structures, as in the JAX
            # plan (its 3-compartment eigen preparation ran per support)
            has_real_inf = bool(np.any(np.asarray(grid.rows.inf_t) < BIG_TIME / 2))
            cov_v = np.asarray(grid.rows.cov_v, dtype=np.float64)
            time_varying = bool(grid.cov_names and cov_v.ndim == 3
                                and not np.all(cov_v == cov_v[..., :1]))
            try:
                if time_varying or has_real_inf:
                    # per-segment factors carry time-varying covariates and
                    # the compounding across infusion-end sub-splits; an
                    # active lag moves the resets, which they cannot express
                    if not lag_active:
                        f["param_mult_seg"], f["param_offset_seg"] = _decompose_seq_tv(
                            seq, sp, grid, k)
                        return "segment", cov_values
                else:
                    cov_values = (_constant_covariate_values(grid)
                                  if grid.cov_names else {})
                    try:
                        f["param_mult"], f["param_offset"] = _decompose_seq(
                            seq, sp, cov_values, k, n_rows_total=grid.n_rows)
                        return "row", cov_values
                    except PharmsolError as e:
                        if "time-independent" not in str(e) or lag_active:
                            raise
                        # time-dependent but maybe affine: per-segment factors
                        f["param_mult_seg"], f["param_offset_seg"] = _decompose_seq_tv(
                            seq, sp, grid, k)
                        return "segment", cov_values
            except PharmsolError as e:
                affine_err = e
        # covariate-free time-independent seq of any form: chain-depth levels
        try:
            table, stream = _decompose_seq_levels(seq, sp, grid, sdef, k,
                                                  lag_mode=lag_active)
            key, mode = "param_levels", "levels"
        except PharmsolError as level_err:
            # time-constant covariates in any form: per-(row, support) planes
            try:
                table, stream = _decompose_seq_planes(seq, sp, grid, sdef, k,
                                                      lag_mode=lag_active)
                key, mode = "param_planes", "planes"
            except PharmsolError as plane_err:
                if lag_active:
                    # lag with a time-varying or time-dependent seq: exact
                    # per-column main and post planes (lag_post); the fire
                    # times are host-known for static and dynamic lags alike
                    try:
                        lag_arg = (_colplanes_dynamic_lag(equation, sp, grid, ninput)
                                   if dynamic else lag_probe)
                        (f["param_planes"], f["seg_depth"],
                         f["seg_postdepth"]) = _decompose_seq_colplanes(
                            seq, sp, grid, sdef, k, lag_arg)
                    except PharmsolError:
                        raise affine_err or plane_err or level_err
                    return "planes", cov_values
                # seq reading t or a time-varying covariate in any form:
                # exact segment-indexed planes
                try:
                    table, stream = _decompose_seq_segplanes(seq, sp, grid, sdef, k)
                except PharmsolError:
                    raise affine_err or plane_err or level_err
                key, mode = "param_planes", "planes"
        if lag_active and table.shape[0] > 1:
            # lag with a chain deeper than one: the event codes drive the
            # in-kernel depth counter (lag_depth)
            f[key], f["seg_evcode"] = table, stream
            return mode, cov_values
        if lag_active:
            # depth 1 everywhere: the reset a lag-shifted dose moves is a
            # no-op, so the plain depth stream holds
            stream, _ = _seq_depth_stream(grid)
        f[key], f["seg_depth"] = table, stream
        return mode, cov_values

    def kernel_kwargs(self) -> dict:
        """The keyword arguments of ``psi_analytical`` besides the streams
        and the support."""
        return dict(structure=self.structure, obs_outeq=self.outeq,
                    out_coef=self.out_coef, out_bias=self.out_bias, **self.features)

    def run(self) -> torch.Tensor:
        """psi [n_subjects, S] on the plan's device."""
        from ...ops.fused_psi import psi_analytical

        return self.finalize(psi_analytical(*self.streams, self.support,
                                            **self.kernel_kwargs()))

    def finalize(self, psi_rows: torch.Tensor) -> torch.Tensor:
        """Sum occasion rows [R, S] into subjects [n_subjects, S]."""
        psi = torch.zeros((self.n_subjects, self.S), dtype=psi_rows.dtype,
                          device=psi_rows.device)
        return psi.index_add_(0, self.row_subject, psi_rows)
