"""Fused SDE psi plan (``_FusedSdePsiPlan``).

The counterpart of the JAX package's ``likelihood/plans/sde.py``
(``_PallasSdePsiPlan``) for its base tier: the plan validates an SDE model
against the CUDA kernel's scope, generates the kernel's drift and diffusion
from the model's closures (:func:`~pharmsol_tpu_torch.ops.rhs_codegen.generate_sde`),
builds the segment streams, the init rows and the output coefficients on the
host, moves them to the device, runs
:func:`~pharmsol_tpu_torch.ops.fused_sde.psi_sde` and sums the occasion rows
into subjects.

In scope: stratified resampling; boluses into any input below ``ndrugs``,
each landing in its inject-to-destination state, and infusions, with one
stream per active input; init (one row per support); linear outputs;
censoring; several outputs; both ``em_control`` modes. Out of scope, raising
PharmsolError so that ``engine='auto'`` takes the general engine and records
why: systematic resampling, covariates, lag and fa (the port's SDE class
refuses the last two), drift or diffusion styles the generator rejects, and
particle counts the kernel's shared memory cannot hold.
"""

from __future__ import annotations

import numpy as np
import torch

from ...errors import PharmsolError


class _FusedSdePsiPlan:
    """Validated device inputs for one fused SDE psi evaluation.

    Same contract as :class:`~.ode._FusedOdePsiPlan`: ``__init__`` validates
    (raising PharmsolError for a model outside the kernel's scope),
    :meth:`run` gives psi [n_subjects, S], :meth:`finalize` sums occasion rows
    into subjects.
    """

    def __init__(self, equation, grid, sp, lowered, device, dtype):
        from torch.func import vmap

        from ...engine.grid import CovView
        from ...engine.sim import as_vector
        from ...ops.fused_psi import extract_linear_out
        from ...ops.fused_sde import check_particle_count
        from ...ops.rhs_codegen import generate_sde
        from .ode import _active_inputs, _seg_t0

        if getattr(equation, "kind", None) != "sde":
            raise PharmsolError("engine='fused' SDE psi needs an SDE equation")
        spec = equation.spec
        if spec.resampling != "stratified":
            raise PharmsolError(
                "engine='fused' SDE psi implements stratified resampling (the "
                "reference scheme): use the general engine for systematic "
                "resampling")
        if grid.cov_names:
            raise PharmsolError("the PyTorch port does not support covariates yet")
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

        # the kernel's drift and diffusion, generated once per (support
        # width, inputs): PharmsolError here is the plan-time rejection
        key = (int(sp.shape[1]), ninput)
        self.gen = equation._sde_cache.get(key)
        if self.gen is None:
            self.gen = generate_sde(spec.drift, spec.diffusion, n_states,
                                    int(sp.shape[1]), ninput)
            equation._sde_cache[key] = self.gen

        from ...ops.fused_psi import streams_from_grid

        try:
            streams = streams_from_grid(grid.rows, lowered, inputs=ninput)
        except ValueError as e:
            raise PharmsolError(f"engine='fused' SDE psi: {e}") from e
        (seg_dt, seg_bolus3, seg_rate3, mask, value, sigma, cens, outeq) = streams
        bol = np.stack([seg_bolus3[..., j] for j in bolus_inputs])
        rate = np.stack([seg_rate3[..., j] for j in self.rate_inputs])
        self.R, self.M = seg_dt.shape
        self.S = sp.shape[0]
        self.device, self.dtype = device, dtype

        # init rows per support, evaluated at t = 0 (no covariates in the port)
        init = None
        if spec.init is not None:
            try:
                t0 = torch.zeros((), dtype=torch.float64)
                init = vmap(lambda p: as_vector(spec.init(p, t0, CovView.empty()), p)
                            .reshape(n_states))(torch.as_tensor(sp, dtype=torch.float64))
            except PharmsolError:
                raise
            except Exception as e:
                raise PharmsolError(
                    f"engine='fused' could not evaluate the SDE init equation: {e}"
                ) from e
            init = init.numpy().T  # [n_states, S]
            if not np.all(np.isfinite(init)):
                raise PharmsolError("engine='fused' SDE init gave non-finite values")

        try:
            C, b = extract_linear_out(spec.out, sp, n_states, self.n_out, CovView.empty())
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
            dev(_seg_t0(grid.rows)),
        )
        self.outeq = dev(outeq) if self.n_out > 1 else None
        self.support = dev(sp)
        self.init = dev(init) if init is not None else None
        self.init_mask = (dev(np.asarray(grid.rows.init_mask, np.float64).reshape(-1))
                          if init is not None else None)
        self.out_coef = dev(np.transpose(C, (1, 2, 0)))  # [n_out, n_states, S]
        self.out_bias = dev(b.T) if np.any(b) else None
        self.row_subject = torch.as_tensor(
            np.asarray(grid.row_subject, dtype=np.int64), device=device)
        self.n_subjects = grid.n_subjects

    def kernel_kwargs(self) -> dict:
        """Keyword arguments of psi_sde / psi_sde_plain for this plan."""
        return dict(
            obs_outeq=self.outeq, out_coef=self.out_coef, out_bias=self.out_bias,
            dose_states=self.dose_states, rate_inputs=self.rate_inputs,
            init=self.init, init_mask=self.init_mask, n_particles=self.n_particles,
            seed=self.seed, em_control=self.em_control,
        )

    def run(self) -> torch.Tensor:
        """psi [n_subjects, S] on the plan's device."""
        from ...ops.fused_sde import psi_sde

        psi_rows = psi_sde(*self.streams, self.support, self.gen, **self.kernel_kwargs())
        return self.finalize(psi_rows)

    def finalize(self, psi_rows: torch.Tensor) -> torch.Tensor:
        """Sum occasion rows [R, S] into subjects [n_subjects, S]."""
        psi = torch.zeros((self.n_subjects, self.S), dtype=psi_rows.dtype,
                          device=psi_rows.device)
        return psi.index_add_(0, self.row_subject, psi_rows)
