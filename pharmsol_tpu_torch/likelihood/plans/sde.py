"""Fused SDE psi plan (``_FusedSdePsiPlan``).

The counterpart of the JAX package's ``likelihood/plans/sde.py``
(``_PallasSdePsiPlan``), base and feature tiers: the plan validates an SDE
model against the CUDA kernel's scope, generates the kernel's drift and
diffusion from the model's closures
(:func:`~pharmsol_tpu_torch.ops.rhs_codegen.generate_sde`), builds the
segment streams, the feature inputs and the output coefficients on the host,
moves them to the device, runs :func:`~pharmsol_tpu_torch.ops.fused_sde.psi_sde`
and sums the occasion rows into subjects.

In scope: stratified resampling; boluses into any input below ``ndrugs``,
each landing in its inject-to-destination state, and infusions, with one
stream per active input; linear outputs; censoring; several outputs; both
``em_control`` modes. With any of the following the kernel runs its feature
tier (K3b) instead of the base tier (K3a): covariates (a per-row constant,
or a per-segment affine ``(a, b)`` stream, exact when every knot lies on a
breakpoint); init planes per (row, support) when init reads a covariate
(init rows per support otherwise, as K3a); lag and fa (static planes, or
per-dose-segment planes selected by slot tables when they change with time
or read a time-varying covariate; each dose's lag must elapse before its
input's next dose). Out of scope, raising PharmsolError so that
``engine='auto'`` takes the general engine and records why: systematic
resampling (and ``noise='common'`` is not honoured: the kernel draws per
cell, as the JAX kernel), a covariate knot inside a segment, a lag that
reaches the input's next dose, a negative lag, an ``out`` that reads a
covariate, drift or diffusion styles the generator rejects, and particle
counts the kernel's shared memory cannot hold. The drift and diffusion take
the generator's elementwise set (``tanh``, ``log1p``, ``erf``, ...) and must
be list-style: the plan refuses vector-style code (``torch.zeros_like``,
writes, whole-vector arithmetic), as the JAX plan, which traces lane shims
only (:238-270), and the twin calls them with lists of lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...errors import PharmsolError
from .split import RowSplit


class _FusedSdePsiPlan(RowSplit):
    """Validated device inputs for one fused SDE psi evaluation.

    Same contract as :class:`~.ode._FusedOdePsiPlan`: ``__init__`` validates
    (raising PharmsolError for a model outside the kernel's scope),
    :meth:`run` gives psi [n_subjects, S], :meth:`finalize` sums occasion rows
    into subjects.
    """

    def __init__(self, equation, grid, sp, lowered, device, dtype):
        from ...engine.grid import CovView
        from ...ops.fused_psi import extract_linear_out, streams_from_grid
        from ...ops.fused_sde import check_particle_count
        from ...ops.rhs_codegen import generate_sde
        from .decompose import (
            _affine_covariate_streams, _check_out_covariate_free, _classify_covariates,
            _init_states, _t64,
        )
        from .ode import _active_inputs, _lag_fa_planes, _seg_t0

        if getattr(equation, "kind", None) != "sde":
            raise PharmsolError("engine='fused' SDE psi needs an SDE equation")
        spec = equation.spec
        if spec.resampling != "stratified":
            raise PharmsolError(
                "engine='fused' SDE psi implements stratified resampling (the "
                "reference scheme): use the general engine for systematic "
                "resampling")
        self.n_states = n_states = int(spec.nstates)
        self.n_out = int(spec.nout)
        self.n_particles = int(spec.nparticles)
        self.seed = int(equation._seed)
        self.em_control = spec.em_control
        try:
            check_particle_count(n_states, self.n_particles, dtype)
        except ValueError as e:
            raise PharmsolError(f"engine='fused' SDE psi: {e}") from None
        ninput = int(spec.ninput)
        bolus_inputs, self.rate_inputs = _active_inputs(grid.rows, ninput)
        dest = spec.bolus_dest
        self.dose_states = tuple(int(dest[j]) if dest is not None else int(j)
                                 for j in bolus_inputs)
        if max(self.dose_states) >= n_states:
            raise PharmsolError(
                f"engine='fused' SDE psi: a bolus destination state is out of "
                f"range (nstates={n_states})")
        # covariates constant over every row ride one value per row; the
        # others per-segment affine (a, b) streams (JAX :93)
        cov_values, varying = _classify_covariates(grid)
        self.cov_names = tuple(grid.cov_names)
        self.cov_modes = tuple("affine" if n in varying else "const" for n in self.cov_names)

        # the kernel's drift and diffusion, generated once per (support
        # width, inputs, covariates): PharmsolError here is the plan-time
        # rejection
        key = (int(sp.shape[1]), ninput, self.cov_names, self.cov_modes)
        self.gen = equation._sde_cache.get(key)
        if self.gen is None:
            self.gen = generate_sde(spec.drift, spec.diffusion, n_states,
                                    int(sp.shape[1]), ninput, self.cov_names,
                                    self.cov_modes)
            equation._sde_cache[key] = self.gen
        if grid.cov_names and equation._out is not None:
            _check_out_covariate_free(equation, sp, cov_values, n_states)

        try:
            streams = streams_from_grid(grid.rows, lowered, inputs=ninput)
        except ValueError as e:
            raise PharmsolError(f"engine='fused' SDE psi: {e}") from e
        (seg_dt, seg_bolus3, seg_rate3, mask, value, sigma, cens, outeq) = streams
        bol = np.stack([seg_bolus3[..., j] for j in bolus_inputs])
        rate = np.stack([seg_rate3[..., j] for j in self.rate_inputs])
        seg_t0 = _seg_t0(grid.rows)
        self.R, self.M = seg_dt.shape
        self.S = sp.shape[0]
        self.device, self.dtype = device, dtype

        # init rows per support, or planes per (row, support) at t = 0 when
        # init reads a covariate (JAX :168-231)
        init_rows = init_planes = None
        if spec.init is not None:
            init_rows, init_planes = _init_states(equation, sp, grid, n_states)
        # lag/fa: static planes, or per-dose-segment planes and slot tables
        # (JAX :136-166, :300-357)
        lag_planes, fa_planes, self.lag_slots, self.fa_slots = _lag_fa_planes(
            equation, sp, grid, ninput, bolus_inputs, bol, seg_t0)
        affine = (_affine_covariate_streams(grid, sorted(varying), seg_t0, seg_dt)
                  if varying else {})
        cov_streams = {}
        for name in self.cov_names:
            if name in affine:
                cov_streams[name] = affine[name]
            else:
                vs = np.zeros((self.R, self.M))
                vs[:, 0] = cov_values[name]
                cov_streams[name] = vs

        out_fn = spec.out
        # occasion 0's covariates: _check_out_covariate_free proved out()
        # reads none that matter
        cov0 = (CovView(_t64(grid.rows.cov_t[0]), _t64(grid.rows.cov_v[0]),
                        torch.as_tensor(np.asarray(grid.rows.cov_fixed[0]).astype(bool)),
                        grid.cov_names) if grid.cov_names else CovView.empty())
        try:
            C, b = extract_linear_out(out_fn, sp, n_states, self.n_out, cov0)
        except PharmsolError:
            raise
        except Exception as e:
            raise PharmsolError(
                f"engine='fused' SDE psi could not extract linear output "
                f"coefficients (non-linear output?): {e}"
            ) from e

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

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
        self.init = dev(init_rows) if init_rows is not None else None
        has_init = init_rows is not None or init_planes is not None
        self.init_mask = (dev(np.asarray(grid.rows.init_mask, np.float64).reshape(-1))
                          if has_init else None)
        self.out_coef = dev(np.transpose(C, (1, 2, 0)))  # [n_out, n_states, S]
        self.out_bias = dev(b.T) if np.any(b) else None
        self.features = dict(
            init_planes=dev(init_planes) if init_planes is not None else None,
            cov_streams={n: (tuple(dev(x) for x in v) if isinstance(v, tuple) else dev(v))
                         for n, v in cov_streams.items()},
            cov_names=self.cov_names,
            lag_planes=dev(lag_planes) if lag_planes is not None else None,
            fa_planes=dev(fa_planes) if fa_planes is not None else None,
            lag_slots=self.lag_slots, fa_slots=self.fa_slots,
        )
        self.row_subject = torch.as_tensor(
            np.asarray(grid.row_subject, dtype=np.int64), device=device)
        self.n_subjects = grid.n_subjects

    def kernel_kwargs(self) -> dict:
        """Keyword arguments of psi_sde / psi_sde_plain for this plan."""
        return dict(
            obs_outeq=self.outeq, out_coef=self.out_coef, out_bias=self.out_bias,
            dose_states=self.dose_states, rate_inputs=self.rate_inputs,
            init=self.init, init_mask=self.init_mask, n_particles=self.n_particles,
            seed=self.seed, em_control=self.em_control, **self.features,
        )

    def launch_spec(self):
        """``psi_sde``'s arguments with their row axes
        (:class:`~.split.RowSplit`), laid out as the ODE plan's. The
        kernel's Philox counter holds the row index within the launch, so a
        row block draws other numbers than the same rows in a whole launch
        (as the JAX package's per-shard keys do)."""
        from ...ops.fused_sde import psi_sde

        axes = {0: 0, 1: 1, 2: 1, 3: 0, 4: 0, 5: 0, 6: 0, 7: 0, 8: None, "obs_outeq": 0,
                "out_coef": None, "out_bias": None, "init": None, "init_mask": 0,
                "cov_streams": 0, "init_planes": 1, "lag_planes": 1, "fa_planes": 1}
        return psi_sde, (*self.streams, self.support, self.gen), self.kernel_kwargs(), axes

    def run(self) -> torch.Tensor:
        """psi [n_subjects, S] on the plan's device."""
        return self.finalize(self.run_rows())

    def finalize(self, psi_rows: torch.Tensor) -> torch.Tensor:
        """Sum occasion rows [R, S] into subjects [n_subjects, S]."""
        psi = torch.zeros((self.n_subjects, self.S), dtype=psi_rows.dtype,
                          device=psi_rows.device)
        return psi.index_add_(0, self.row_subject, psi_rows)
