"""Shared conditional-likelihood machinery for the parametric estimators.

SAEM (``optimize/saem.py``) and Laplace/FOCE (``optimize/laplace.py``) need
the same function: the conditional log-likelihood of every subject at its
own parameter row, under prediction-based residual error models. The
counterpart of the JAX package's ``optimize/_condll.py``. Predictions come
from the general engine's per-row march (``EquationBase._batch_predictions``
over the rows on the device, the march that ``log_likelihood_batch`` runs),
or, for the adaptive ODE solvers, from the continuous forward sensitivities
of ``engine/sens.py``, whose derivatives solve augmented ODEs.
``torch.autograd`` differentiates through either.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import float_dtype, resolve_device
from ..data.residual_error import ResidualErrorModels, residual_sigma_array
from ..data.structs import Data
from ..errors import PharmsolError
from ..likelihood.distributions import LOG_2PI

# None = a closed form; expm's Taylor chain is ordinary torch arithmetic
REVERSE_DIFF_SOLVERS = (None, "expm", "expm_rolled")


class CondLL(NamedTuple):
    """The conditional-LL function on the device plus its host context."""

    # (theta_rows [n_sub, p] natural scale, sig_a [nout], sig_b [nout])
    #   -> (ll_i [n_sub], r2 [R, O], f2 [R, O]); per_row=True reads [R, p]
    #   per-occasion-row parameters instead (the IOV hook)
    ll_parts: Callable
    # theta_rows [n_sub, p] natural scale -> predictions [R, O]
    pred_rows: Callable
    subjects: list
    n_sub: int
    nout: int
    kinds_np: np.ndarray          # [nout] residual kind codes (0 = none)
    lowered_a: np.ndarray         # [nout] initial sigma a
    lowered_b: np.ndarray         # [nout] initial sigma b
    n_obs_per_outeq: np.ndarray   # [nout]
    obs_outeq: torch.Tensor       # [R, O]
    obs_value: torch.Tensor       # [R, O]
    obs_time: torch.Tensor        # [R, O]
    active: torch.Tensor          # [R, O] bool
    row_subject: torch.Tensor     # [R]
    row_occasion: torch.Tensor = None  # [R] within-subject occasion index
    n_occ: np.ndarray = None           # [n_sub] occasion counts
    n_occ_max: int = 1                 # max occasions over subjects
    # per-occasion-row params [R, p] natural scale -> predictions [R, O]
    pred_rows_at: Callable = None
    device: torch.device = None
    rows: object = None                # the lowered rows on the device
    make_pred: Callable = None         # rows -> pred_rows_at over them


def _solver(eq):
    return getattr(getattr(eq, "_opts", None), "solver", None)


def build_cond_ll(
    equation,
    data,
    residual_error_models: ResidualErrorModels,
    *,
    require_reverse_diff: bool = False,
    device=None,
) -> CondLL:
    """Lower the data once and build the conditional-LL parts on ``device``
    (default: the card).

    ``require_reverse_diff=True`` gates the engine as the JAX package does
    for its exact-Hessian Laplace path: SDE likelihoods (discrete
    resampling) and the adaptive ODE solvers (which the Laplace fit takes
    through forward sensitivities instead) are refused.
    """
    eq = equation
    kind = getattr(eq, "kind", None)
    solver = _solver(eq)
    if require_reverse_diff:
        if kind == "sde":
            raise PharmsolError(
                "cannot reverse-differentiate SDE likelihoods (discrete "
                "particle resampling); use fit_saem"
            )
        if solver not in REVERSE_DIFF_SOLVERS:
            raise PharmsolError(
                f"solver '{solver}' integrates adaptively (forward-mode "
                f"only) and cannot back the exact-Hessian Laplace path; use "
                f"the analytical engine, with_solver('expm') for linear "
                f"models, or fit_saem"
            )

    from ..likelihood.matrix import _device_rows

    dev, fd = resolve_device(device), float_dtype()
    data = data if isinstance(data, Data) else Data(list(data))
    subjects = list(data.subjects())
    n_sub = len(subjects)
    grid = eq.lower(subjects)
    lowered = residual_error_models.lower(eq.resolve_output_label, eq.nouteqs())
    kinds_np = np.asarray(lowered.kind)
    rows = _device_rows(grid, dev, fd)
    names = tuple(grid.cov_names)
    sub_np = np.asarray(grid.row_subject).astype(np.int64)
    row_subject = torch.as_tensor(sub_np, device=dev)

    make_pred = _pred_maker(eq, names)
    pred_at = make_pred(rows)
    kinds_t = torch.as_tensor(kinds_np.astype(np.int64), device=dev)
    obs_outeq = rows.obs_outeq
    active = rows.obs_valid & rows.obs_has_value
    act_np = active.cpu().numpy()
    oe_np = obs_outeq.cpu().numpy()
    used = np.unique(oe_np[act_np]) if act_np.any() else np.asarray([], int)
    unmodeled = [int(o) for o in used if kinds_np[o] == 0]
    if unmodeled:
        raise PharmsolError(
            f"outeq(s) {unmodeled} have observations but no residual error "
            f"model"
        )
    nout = int(kinds_np.shape[0])
    n_obs_per_outeq = np.zeros(nout, dtype=np.float64)
    for o in range(nout):
        n_obs_per_outeq[o] = float(np.sum(act_np & (oe_np == o)))
    pred_rows, ll_parts = _cond_parts(pred_at, rows, row_subject, n_sub, kinds_t)

    occ_np = np.asarray(grid.rows.occasion_index).reshape(-1).astype(np.int64)
    n_occ = np.zeros(n_sub, dtype=np.int64)
    np.maximum.at(n_occ, sub_np, occ_np + 1)

    return CondLL(
        ll_parts=ll_parts,
        pred_rows=pred_rows,
        subjects=subjects,
        n_sub=n_sub,
        nout=nout,
        kinds_np=kinds_np,
        lowered_a=np.asarray(lowered.a, dtype=np.float64),
        lowered_b=np.asarray(lowered.b, dtype=np.float64),
        n_obs_per_outeq=n_obs_per_outeq,
        obs_outeq=obs_outeq,
        obs_value=rows.obs_value,
        obs_time=rows.obs_t,
        active=active,
        row_subject=row_subject,
        row_occasion=torch.as_tensor(occ_np, device=dev),
        n_occ=n_occ,
        n_occ_max=int(n_occ.max()) if n_sub else 1,
        pred_rows_at=pred_at,
        device=dev,
        rows=rows,
        make_pred=make_pred,
    )


def _pred_maker(eq, names) -> Callable:
    """``rows -> pred_at``: the predictions [R, O] of every row under its own
    parameter row. The adaptive ODE solvers take their derivatives from the
    augmented sensitivity systems instead of differentiating the stepper."""
    if getattr(eq, "kind", None) == "ode" and _solver(eq) not in REVERSE_DIFF_SOLVERS:
        from ..engine.sens import make_sens_pred, supports_forward_sens

        if supports_forward_sens(eq):
            return lambda rows: make_sens_pred(eq, rows, names)

    def make(rows):
        def pred_at(p_rows):
            return eq._batch_predictions(rows, p_rows, names)

        return pred_at

    return make


def _per_obs(sig: torch.Tensor, obs_outeq: torch.Tensor) -> torch.Tensor:
    """One residual parameter per observation: ``sig`` is [nout] (shared)
    or [R, nout] (a row of its own per grid row)."""
    return sig[obs_outeq] if sig.dim() == 1 else torch.gather(sig, 1, obs_outeq)


def _cond_parts(pred_at, rows, row_subject, n_sub: int, kinds_t):
    """``(pred_rows, ll_parts)`` over the rows ``rows`` of ``n_sub``
    subjects."""
    obs_outeq, obs_value = rows.obs_outeq, rows.obs_value
    active = rows.obs_valid & rows.obs_has_value
    kind_per_obs = kinds_t[obs_outeq]

    def pred_rows(theta_rows):
        """Raw predictions [R, O] at per-subject parameter rows."""
        return pred_at(theta_rows[row_subject])

    def ll_parts(theta_rows, sig_a, sig_b, y=None, per_row=False):
        """Conditional LL per subject and the per-observation (r2, f2).

        ``y [R, O]`` overrides the lowered observation values (the
        replicate-refit hook); ``per_row=True`` reads ``theta_rows`` as
        per-occasion-row parameters ``[R, p]`` (the IOV hook); ``sig_a`` /
        ``sig_b`` are [nout], or [R, nout] with a row per grid row.
        """
        obs = obs_value if y is None else y
        preds = pred_at(theta_rows if per_row else theta_rows[row_subject])
        sigma = residual_sigma_array(kind_per_obs, _per_obs(sig_a, obs_outeq),
                                     _per_obs(sig_b, obs_outeq), preds)
        z = (obs - preds) / sigma
        ll = -0.5 * (LOG_2PI + 2.0 * torch.log(sigma) + z * z)
        zero = torch.zeros((), dtype=preds.dtype, device=preds.device)
        per_row_ll = torch.where(active, ll, zero).sum(dim=-1)
        ll_i = per_row_ll.new_zeros(n_sub).index_add(0, row_subject, per_row_ll)
        r2 = torch.where(active, (obs - preds) ** 2, zero)
        f2 = torch.where(active, preds * preds, zero)
        return ll_i, r2, f2

    return pred_rows, ll_parts


def tile_cond_ll(cond: CondLL, n_lanes: int) -> CondLL:
    """The conditional LL over ``n_lanes`` copies of ``cond``'s population,
    lane-major: subject ``b * n_sub + i`` is lane b's copy of subject i and
    grid row ``b * R + r`` lane b's copy of row r. The rows are gathered by
    index on the device (the population is not lowered again), so one call
    evaluates every lane's subjects at once; the lanes share no operation
    that mixes them."""
    if n_lanes == 1:
        return cond
    if cond.rows is None:
        raise PharmsolError("this conditional LL cannot be tiled (no device rows)")
    dev = cond.device
    R = int(cond.row_subject.shape[0])
    n_sub = cond.n_sub
    ridx = torch.arange(R, device=dev).repeat(n_lanes)
    lane_of_row = torch.arange(n_lanes, device=dev).repeat_interleave(R)
    rows = type(cond.rows)(*(a[ridx] for a in cond.rows))
    row_subject = cond.row_subject[ridx] + n_sub * lane_of_row
    kinds_t = torch.as_tensor(cond.kinds_np.astype(np.int64), device=dev)
    pred_at = cond.make_pred(rows)
    pred_rows, ll_parts = _cond_parts(pred_at, rows, row_subject, n_lanes * n_sub, kinds_t)
    return cond._replace(
        ll_parts=ll_parts, pred_rows=pred_rows, subjects=list(cond.subjects) * n_lanes,
        n_sub=n_lanes * n_sub, n_obs_per_outeq=cond.n_obs_per_outeq * n_lanes,
        obs_outeq=rows.obs_outeq, obs_value=rows.obs_value, obs_time=rows.obs_t,
        active=rows.obs_valid & rows.obs_has_value, row_subject=row_subject,
        row_occasion=cond.row_occasion[ridx], n_occ=np.tile(cond.n_occ, n_lanes),
        pred_rows_at=pred_at, rows=rows)


def resolve_transform(transform, p: int) -> tuple:
    if isinstance(transform, str):
        transform = (transform,) * p
    transform = tuple(transform)
    if len(transform) != p or any(t not in ("log", "identity") for t in transform):
        raise PharmsolError(
            "transform must be 'log', 'identity', or a per-parameter "
            "sequence of those"
        )
    return transform


def named_theta0(equation, theta0):
    """``(theta0 as float64 [p], names or None)``: a dict needs the model's
    metadata and must cover its parameters exactly."""
    names = None
    if isinstance(theta0, dict):
        metadata = getattr(equation, "metadata", None)
        metadata = metadata() if callable(metadata) else metadata
        if metadata is None:
            raise PharmsolError("named theta0 requires model metadata")
        model_names = list(metadata.parameter_names)
        missing = [n for n in model_names if n not in theta0]
        extra = [n for n in theta0 if n not in model_names]
        if missing or extra:
            raise PharmsolError(
                f"theta0 must cover the model parameters exactly "
                f"(missing: {missing or '-'}, unknown: {extra or '-'})"
            )
        names = tuple(model_names)
        theta0 = [theta0[n] for n in model_names]
    theta0 = np.asarray(theta0, dtype=np.float64)
    if theta0.ndim != 1:
        raise PharmsolError("theta0 must be a vector of typical values")
    return theta0, names


def fitted_residual_models(equation, residual_error_models, sig_a, sig_b, est_sigma):
    """The residual models with the fitted a/b (the input ones when
    ``est_sigma`` is off)."""
    from ..data.residual_error import ResidualErrorModel, ResidualKind

    out = ResidualErrorModels()
    a_np = np.asarray(sig_a.detach().cpu().numpy(), dtype=np.float64)
    b_np = np.asarray(sig_b.detach().cpu().numpy(), dtype=np.float64)
    for label in residual_error_models.labels():
        model = residual_error_models.get(label)
        idx = equation.resolve_output_label(label)
        if model.kind is ResidualKind.CONSTANT:
            new = ResidualErrorModel.constant(a_np[idx])
        elif model.kind is ResidualKind.PROPORTIONAL:
            new = ResidualErrorModel.proportional(b_np[idx])
        elif model.kind is ResidualKind.COMBINED:
            new = ResidualErrorModel.combined(a_np[idx], b_np[idx])
        else:
            new = ResidualErrorModel.exponential(a_np[idx])
        out = out.add(label, new if est_sigma else model)
    return out


def to_natural(phi: torch.Tensor, is_log: torch.Tensor) -> torch.Tensor:
    """``exp(phi)`` on the log-transformed axes, ``phi`` elsewhere; the
    exponential sees 0 on the identity axes so that no overflow there
    poisons a gradient."""
    return torch.where(is_log, torch.exp(torch.where(is_log, phi, torch.zeros_like(phi))), phi)
