"""Fused analytical psi plan (``_FusedPsiPlan``), base tier.

The counterpart of the JAX package's ``likelihood/plans/analytical.py::
_PallasPsiPlan`` for models without covariates, seq, lag, fa or init: it
validates the model against the kernel's scope, builds the segment streams
and the linear output coefficients on the host, moves them to the device,
runs :func:`~pharmsol_tpu_torch.ops.fused_psi.psi_analytical` and sums the
occasion rows into subjects on the device.

Every shape is passed as it is: the kernel takes ragged R and S, so there is
no row or support padding, and the working dtype is kept (no forced f32).
"""

from __future__ import annotations

import numpy as np
import torch

from ...errors import PharmsolError


def _fused_structure_name(equation) -> str:
    """Map an Analytical equation's kernel fn to a fused psi structure."""
    from ...engine.analytical import KERNELS
    from ...ops.fused_psi import STRUCTURES

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

    Raises PharmsolError when the model is outside the kernel's scope; the
    caller (``engine='auto'``) then takes the general engine and records
    the reason.
    """

    def __init__(self, equation, grid, sp, lowered, device, dtype):
        from ...engine.sim import NO_COVARIATES
        from ...ops.fused_psi import (
            STRUCTURES, extract_linear_out, streams_from_grid,
        )

        if getattr(equation, "kind", None) != "analytical":
            raise PharmsolError(
                "engine='fused' covers closed-form (Analytical) models only"
            )
        self.structure = _fused_structure_name(equation)
        sdef = STRUCTURES[self.structure]
        n_kernel_params = sdef["n_params"]
        if sp.shape[1] < n_kernel_params:
            raise PharmsolError(
                f"engine='fused' with `{self.structure}` needs support columns "
                f"[{n_kernel_params} kernel params..., out params...], got "
                f"{sp.shape[1]} columns"
            )
        if grid.cov_names:
            raise PharmsolError(
                "the PyTorch port does not support covariates yet"
            )
        self.n_out = int(equation.nouteqs())
        n_states = sdef["n_states"]
        if int(equation.nstates()) != n_states:
            raise PharmsolError(
                f"engine='fused' with `{self.structure}` expects nstates="
                f"{n_states}, got {equation.nstates()}"
            )
        try:
            streams = streams_from_grid(grid.rows, lowered)
        except ValueError as e:
            raise PharmsolError(f"engine='fused': {e}") from e
        self.R, self.M = streams[0].shape
        self.S = sp.shape[0]
        self.device, self.dtype = device, dtype

        # output coefficients: y_k = C_k(p) . x + b_k(p), per support point,
        # extracted on the host in float64
        out_fn = equation._out or (lambda x, p, t, cov: x[: self.n_out])
        try:
            C, b = extract_linear_out(
                out_fn, sp, n_states, self.n_out, NO_COVARIATES
            )
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
        self.support = dev(sp)
        self.out_coef = dev(np.transpose(C, (1, 2, 0)))  # [n_out, n_states, S]
        self.out_bias = dev(b.T) if np.any(b) else None
        self.row_subject = torch.as_tensor(
            np.asarray(grid.row_subject, dtype=np.int64), device=device)
        self.n_subjects = grid.n_subjects

    def run(self) -> torch.Tensor:
        """psi [n_subjects, S] on the plan's device."""
        from ...ops.fused_psi import psi_analytical

        psi_rows = psi_analytical(
            *self.streams, self.support, structure=self.structure,
            obs_outeq=self.outeq, out_coef=self.out_coef,
            out_bias=self.out_bias,
        )
        return self.finalize(psi_rows)

    def finalize(self, psi_rows: torch.Tensor) -> torch.Tensor:
        """Sum occasion rows [R, S] into subjects [n_subjects, S]."""
        psi = torch.zeros((self.n_subjects, self.S), dtype=psi_rows.dtype,
                          device=psi_rows.device)
        return psi.index_add_(0, self.row_subject, psi_rows)
