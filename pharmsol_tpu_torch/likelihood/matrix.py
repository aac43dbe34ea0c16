"""Population likelihood: the psi matrix (subjects x support points), and
the per-subject batch.

Parity with the reference's likelihood/matrix.rs and the JAX package's
``likelihood/matrix.py``: ``log_likelihood_matrix(eq, data, support_points,
error_models)`` gives the (n_subjects, n_support_points) log-likelihood
with observation-based sigma; ``log_likelihood_batch(eq, data, parameters,
residual_error_models)`` the log-likelihood of each subject under its own
parameter row with prediction-based sigma (the general engine's march in
its per-row mode), and ``log_likelihood_subject`` that of one subject.

Two engines compute it:

- ``general``: the segment march of ``engine/sim.py`` over every (support,
  occasion row) pair as batched tensors, then a sum of occasion rows into
  subjects. It takes any Analytical or ODE model the port supports; SDE
  models take the particle filter of ``engine/sde.py``, with covariates,
  lag, fa and init as well. The JAX package
  calls its counterpart ``xla``.
- ``fused``: a hand-written CUDA kernel (its plain twin on the CPU): for
  closed-form models ``ops/fused_psi.py`` through
  ``plans/analytical.py::_FusedPsiPlan``, for ODE models ``ops/fused_ode.py``
  through ``plans/ode.py::_FusedOdePsiPlan``, for SDE models
  ``ops/fused_sde.py`` through ``plans/sde.py::_FusedSdePsiPlan``. The JAX
  package calls its counterpart ``pallas``.

``engine='auto'`` takes ``fused`` on a CUDA device for every model the
fused plan accepts, and ``general`` on the CPU. A model outside the plan's
scope goes to ``general`` and the reason is kept
(:func:`last_engine_decision`). No engine is ever switched because a kernel
failed to build or launch: that error propagates.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import float_dtype, resolve_device
from ..data.error_model import AssayErrorModels
from ..data.residual_error import ResidualErrorModels, residual_sigma_array
from ..data.structs import Data
from ..errors import PharmsolError
from .distributions import LOG_2PI


def _as_data(subjects) -> Data:
    if isinstance(subjects, Data):
        return subjects
    return Data(list(subjects))


def check_error_model_coverage(grid, lowered) -> None:
    """Raise when a valued observation's outeq has error model None.

    Parity: the reference fails likelihood computation with
    ErrorModelError::NoneErrorModel (error_model.rs:683); the batched path
    would otherwise silently contribute zero.
    """
    kind = np.asarray(lowered.kind)
    outeq = np.asarray(grid.rows.obs_outeq)
    active = np.asarray(grid.rows.obs_valid) & np.asarray(grid.rows.obs_has_value)
    used = np.unique(outeq[active]) if active.any() else np.array([], dtype=int)
    missing = [int(o) for o in used if kind[int(o)] == 0]
    if missing:
        raise PharmsolError(
            f"output equation(s) {missing} have observations but error model "
            f"None (define an assay error model for every observed output)"
        )


def last_engine_decision(equation) -> Optional[dict]:
    """The engine choice made by the last ``engine='auto'`` psi call.

    Returns ``{"engine": "fused"|"general", "reason": str}`` or None when
    the equation has not been through an auto-engined
    :func:`log_likelihood_matrix` yet.
    """
    return getattr(equation, "_last_engine_decision", None)


def _auto_engine(device: torch.device) -> tuple:
    """Pick the psi engine for ``engine='auto'``: (engine, reason)."""
    if device.type == "cuda":
        return "fused", "CUDA device: the fused kernel takes every model its plan accepts"
    return "general", (
        "CPU device: the general engine (the fused kernel's plain twin "
        "is for parity tests)"
    )


def _fused_plan(equation, grid, sp, lowered, device, dtype):
    """The fused plan of the equation's family (PharmsolError when the model
    is outside its scope)."""
    kind = getattr(equation, "kind", None)
    if kind == "ode":
        from .plans.ode import _FusedOdePsiPlan

        return _FusedOdePsiPlan(equation, grid, sp, lowered, device, dtype)
    if kind == "sde":
        from .plans.sde import _FusedSdePsiPlan

        return _FusedSdePsiPlan(equation, grid, sp, lowered, device, dtype)
    from .plans.analytical import _FusedPsiPlan

    return _FusedPsiPlan(equation, grid, sp, lowered, device, dtype)


def _device_rows(grid, device, dtype):
    """The grid's rows as tensors on ``device``, cached on the grid."""
    from ..engine.grid import to_tensors

    cache = grid.__dict__.setdefault("_device_rows", {})
    key = (str(device), dtype)
    rows = cache.get(key)
    if rows is None:
        rows = cache[key] = to_tensors(grid.rows, device, dtype)
    return rows


def lowered_tensors(lowered, device, dtype) -> tuple:
    """Lowered assay error models as (kind, factor, poly) tensors."""
    kind = torch.as_tensor(np.asarray(lowered.kind, dtype=np.int64), device=device)
    factor = torch.as_tensor(lowered.factor).to(device=device, dtype=dtype)
    poly = torch.as_tensor(lowered.poly).to(device=device, dtype=dtype)
    return kind, factor, poly


def _general_psi(equation, grid, sp, lowered, device, dtype) -> torch.Tensor:
    """General engine: batched segment march, then rows -> subjects."""
    rows = _device_rows(grid, device, dtype)
    p = torch.as_tensor(sp).to(device=device, dtype=dtype)
    ll = equation._ll_rows(rows, p, *lowered_tensors(lowered, device, dtype),
                           grid.cov_names)  # [S, R]
    row_subject = torch.as_tensor(
        np.asarray(grid.row_subject, dtype=np.int64), device=device)
    psi = torch.zeros((grid.n_subjects, sp.shape[0]), dtype=dtype, device=device)
    return psi.index_add_(0, row_subject, ll.t())


def log_likelihood_matrix(
    equation,
    subjects,
    support_points,
    error_models: AssayErrorModels,
    progress: bool = False,
    on_error: str = "neg_inf",
    engine: str = "auto",
    device=None,
) -> torch.Tensor:
    """Log-likelihood of every subject at every support point.

    ``support_points``: [n_support, n_params] dense in model order (numpy or
    a tensor). Returns psi [n_subjects, n_support] as a tensor of the working
    dtype (:func:`~pharmsol_tpu_torch.config.float_dtype`) on ``device``
    (default :func:`~pharmsol_tpu_torch.config.device`).

    ``engine``: ``'auto'`` (default), ``'general'`` or ``'fused'`` (see the
    module docstring). The closed-form kernel supports every built-in
    structure with outputs linear in the state (support columns = kernel
    params, then the out closure's parameters), bolus/infusion regimens into
    input 0, censoring and errorpoly overrides, and covariates through the
    secondary equations, lag, fa and init (``plans/analytical.py`` names
    what it refuses). The ODE kernel supports
    dopri5 and tsit5, expm, and the stiff solvers trbdf2, kvaerno3 (=
    esdirk34), kvaerno5 and bdf, doses into any input, linear outputs and censoring,
    covariates (constant per row, or affine within every segment: each knot
    on a breakpoint), lag and fa (static planes, or per-dose-segment planes
    when they change with time or read a time-varying covariate) and init,
    for every RHS the CUDA generator accepts (``ops/rhs_codegen.py``;
    ``plans/ode.py`` names what it refuses). The SDE
    kernel supports stratified resampling, doses into any input (and their
    inject-to-destination states), init (rows, or planes when it reads a
    covariate), covariates (constant per row, or affine within every
    segment), lag and fa (static planes, or per-dose-segment planes), linear
    outputs, censoring and both ``em_control`` modes, for every drift and
    diffusion the generator accepts; its draws are independent per
    (subject, support) cell.

    Divergence note (as in the JAX package): the reference aborts the whole
    matrix on a simulation error; here non-finite cells are mapped to -inf
    (``on_error='neg_inf'``) or left as NaN (``on_error='nan'``).

    ``progress`` (the reference's fifth argument, matrix.rs:52) prints the
    matrix size before the general engine runs and the cell rate after, as
    the JAX package does on its ``xla`` path; the fused path prints nothing.
    """
    dev = resolve_device(device)
    dtype = float_dtype()
    data = _as_data(subjects)
    if isinstance(support_points, torch.Tensor):
        support_points = support_points.detach().cpu().numpy()
    sp = np.asarray(support_points, dtype=np.float64)
    if sp.ndim != 2:
        raise PharmsolError("support_points must be 2D [n_support, n_params]")
    grid = equation.lower(data.subjects())
    lowered = error_models.lower(equation.resolve_output_label, equation.nouteqs())
    check_error_model_coverage(grid, lowered)

    if engine not in ("auto", "general", "fused"):
        raise PharmsolError(
            f"unknown psi engine `{engine}` (auto, general or fused)"
        )
    plan = None
    if engine == "auto":
        engine, reason = _auto_engine(dev)
        if engine == "fused":
            try:
                plan = _fused_plan(equation, grid, sp, lowered, dev, dtype)
            except PharmsolError as e:
                engine, reason = "general", f"fused plan rejected the model: {e}"
        equation._last_engine_decision = {"engine": engine, "reason": reason}
    elif engine == "fused":
        plan = _fused_plan(equation, grid, sp, lowered, dev, dtype)

    # the progress lines belong to the general path (the JAX package's xla
    # path); the fused path prints nothing
    progress = progress and plan is None
    t0 = time.perf_counter()
    if progress:
        print(
            f"Computing log-likelihood matrix: {grid.n_subjects} subjects × "
            f"{sp.shape[0]} support points..."
        )
    psi = plan.run() if plan is not None else _general_psi(
        equation, grid, sp, lowered, dev, dtype)
    if on_error == "neg_inf":
        psi = torch.where(torch.isfinite(psi), psi,
                          torch.full_like(psi, -float("inf")))
    if progress:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        n = grid.n_subjects * sp.shape[0]
        print(f"  done: {n} cells in {dt:.3f}s ({n / max(dt, 1e-9):.0f} cells/s)")
    return psi


def log_likelihood_batch(
    equation,
    subjects,
    parameters,
    residual_error_models: ResidualErrorModels,
    device=None,
) -> torch.Tensor:
    """Per-subject log-likelihood with a parameter row per subject.

    The SAEM/FOCE surface (the JAX package's ``log_likelihood_batch``,
    likelihood/matrix.py:317-389): ``parameters`` [n_subjects, n_params]
    dense in model order, prediction-based sigma through
    ``residual_error_models``. One batched march over every occasion row,
    each under its subject's parameter row (``engine/sim.py::SegmentMarch``
    in its per-row mode: one cell per row), then a sum of rows into
    subjects. Returns [n_subjects] as a tensor of the working dtype on
    ``device`` (default: the card); -inf for a subject whose simulation
    fails (NaN) or that has an active observation on an output without a
    residual model.
    """
    dev = resolve_device(device)
    dtype = float_dtype()
    data = _as_data(subjects)
    if isinstance(parameters, torch.Tensor):
        parameters = parameters.detach().cpu().numpy()
    p = np.asarray(parameters, dtype=np.float64)
    if p.ndim != 2 or p.shape[0] != len(data):
        raise PharmsolError(
            f"parameters has {p.shape[0] if p.ndim == 2 else '?'} rows but there "
            f"are {len(data)} subjects"
        )
    grid = equation.lower(data.subjects())
    lowered = residual_error_models.lower(equation.resolve_output_label,
                                          equation.nouteqs())
    rows = _device_rows(grid, dev, dtype)
    row_subject = torch.as_tensor(np.asarray(grid.row_subject, dtype=np.int64), device=dev)
    p_rows = torch.as_tensor(p, dtype=dtype, device=dev)[row_subject]  # [R, n_params]
    total = _batch_row_totals(equation, rows, p_rows, grid.cov_names, lowered, dev, dtype)
    out = torch.zeros((grid.n_subjects,), dtype=dtype, device=dev)
    out = out.index_add_(0, row_subject, total)
    return torch.where(torch.isfinite(out) | torch.isneginf(out), out,
                       torch.full_like(out, -float("inf")))


def _batch_row_totals(equation, rows, p_rows, cov_names, lowered, dev, dtype):
    """The batch log-likelihood of every occasion row [R] under its own
    parameter row (``p_rows`` [R, n_params]); -inf for a row with an active
    observation on an output without a residual model."""
    pred = equation._batch_predictions(rows, p_rows, cov_names)  # [R, NO]
    outeq = rows.obs_outeq
    kind = torch.as_tensor(np.asarray(lowered.kind, dtype=np.int64), device=dev)[outeq]
    a = torch.as_tensor(lowered.a, dtype=dtype, device=dev)[outeq]
    b = torch.as_tensor(lowered.b, dtype=dtype, device=dev)[outeq]
    sigma = residual_sigma_array(kind, a, b, pred)
    z = (rows.obs_value - pred) / sigma
    ll = -0.5 * (LOG_2PI + 2.0 * torch.log(sigma) + z * z)
    active = rows.obs_valid & rows.obs_has_value
    total = torch.where(active, ll, torch.zeros_like(ll)).sum(dim=-1)  # [R]
    # an active observation with no model (kind 0) poisons the subject
    missing = (active & (kind == 0)).any(dim=-1)
    return torch.where(missing, torch.full_like(total, -float("inf")), total)


def log_likelihood_subject(equation, subject, parameters,
                           residual_error_models: ResidualErrorModels,
                           device=None) -> float:
    """Single-subject prediction-based log-likelihood (mod.rs:205)."""
    res = log_likelihood_batch(
        equation,
        Data([subject]),
        np.asarray(parameters, dtype=np.float64).reshape(1, -1),
        residual_error_models,
        device=device,
    )
    return float(res[0])
