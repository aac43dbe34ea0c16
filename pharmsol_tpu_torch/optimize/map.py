"""Gradient-based MAP / maximum-likelihood fitting of one parameter vector.

The counterpart of the JAX package's ``optimize/map.py``: L-BFGS with a zoom
line search (``optimize/_lbfgs.py``, the iterates of ``optax.lbfgs``) on the
exact gradient of ``EquationBase.log_likelihood_fn``'s objective, and a
Laplace covariance (the inverse Hessian of the negative log posterior) for
standard errors.

Every engine is differentiated by ``torch.autograd``: the closed forms and
``expm`` end to end, the adaptive ODE steppers through their masked loop,
which gives the derivative of the discrete march that the JAX package takes
with ``jax.jacfwd`` (its ``custom_vjp`` shim is not needed: reverse mode
passes through the loop here). SDE likelihoods (particle resampling) are
refused.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.error_model import AssayErrorModels
from ..errors import PharmsolError
from ._lbfgs import Lbfgs, value_and_grad_fn


class MapResult(NamedTuple):
    """MAP fit result with Laplace (inverse-Hessian) uncertainty."""

    parameters: np.ndarray       # [n_params] at the optimum (natural scale)
    log_likelihood: float        # data log-likelihood at the optimum
    log_posterior: float         # + prior_logpdf when a prior was given
    converged: bool
    iterations: int
    gradient_norm: float         # inf-norm of the (transformed) gradient
    covariance: Optional[np.ndarray]  # Laplace covariance, natural scale
    standard_errors: Optional[np.ndarray]

    def summary(self) -> str:
        lines = [
            f"MAP fit: logpost={self.log_posterior:.6g} "
            f"(loglik={self.log_likelihood:.6g}), "
            f"{'converged' if self.converged else 'NOT converged'} in "
            f"{self.iterations} iters, |grad|={self.gradient_norm:.3g}"
        ]
        for i, v in enumerate(self.parameters):
            se = (f" +- {self.standard_errors[i]:.4g}"
                  if self.standard_errors is not None else "")
            lines.append(f"  p[{i}] = {v:.6g}{se}")
        return "\n".join(lines)


def fit_map(
    equation,
    data,
    error_models: AssayErrorModels,
    x0: Sequence[float],
    *,
    prior_logpdf: Optional[Callable] = None,
    log_space: bool = True,
    max_iters: int = 200,
    grad_tol: float = 1e-6,
    device=None,
) -> MapResult:
    """Fit one parameter vector to a subject or Data by MAP / ML, on
    ``device`` (default: the card).

    ``prior_logpdf``: optional torch ``params -> scalar`` log prior on the
    NATURAL scale (omit for maximum likelihood). ``log_space=True``
    (default) optimizes ``z = log(p)``; set False for sign-free parameters.
    Returns a :class:`MapResult` whose covariance is the Laplace
    approximation on the natural scale (delta method through exp when
    ``log_space``).
    """
    if getattr(equation, "kind", None) == "sde":
        raise PharmsolError(
            "fit_map cannot differentiate SDE likelihoods (discrete "
            "particle resampling); use the derivative-free "
            "ParameterOptimizer"
        )
    ll_rows, operands, _, _, _ = equation._ll_fn_parts(data, error_models, device=device)
    x0 = np.asarray(x0, dtype=np.float64)
    if log_space and np.any(x0 <= 0.0):
        raise PharmsolError(
            "fit_map(log_space=True) needs a strictly positive x0 "
            "(pass log_space=False for sign-free parameters)"
        )
    dev, fd = operands[0].obs_t.device, operands[0].obs_t.dtype

    def unpack(z):
        return torch.exp(z) if log_space else z

    def neg_log_post(z):
        p = unpack(z)
        val = ll_rows(*operands[:1], p, *operands[1:]).sum()
        if prior_logpdf is not None:
            val = val + prior_logpdf(p)
        return -val

    z0 = torch.as_tensor(np.log(x0) if log_space else x0, dtype=fd, device=dev)
    with torch.no_grad():
        f0 = float(neg_log_post(z0))
    if not np.isfinite(f0):
        raise PharmsolError(
            f"fit_map objective is non-finite at x0={list(map(float, x0))} "
            f"(neg log posterior = {f0}); pick a starting point off the "
            f"model's singular set (e.g. ka == ke in absorption kernels)"
        )

    opt = Lbfgs()
    vg = value_and_grad_fn(neg_log_post)
    z = z0
    state = opt.init(z0)
    gnorm = np.inf
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
        gnorm = float(grad.abs().max())
        if not np.isfinite(gnorm):
            break
        if gnorm < grad_tol:
            converged = True
            break

    p_hat = unpack(z).detach().cpu().numpy().astype(np.float64)
    with torch.no_grad():
        logpost = -float(neg_log_post(z))
        loglik = logpost - (float(prior_logpdf(unpack(z))) if prior_logpdf else 0.0)

    covariance = None
    ses = None
    try:
        H = torch.autograd.functional.hessian(neg_log_post, z.detach())
        cov_z = np.linalg.inv(H.detach().cpu().numpy().astype(np.float64))
        if log_space:
            # delta method: p = exp(z) -> cov_p = diag(p) cov_z diag(p)
            J = np.diag(p_hat)
            covariance = J @ cov_z @ J
        else:
            covariance = cov_z
        diag = np.diag(covariance)
        ses = np.where(diag > 0, np.sqrt(np.maximum(diag, 0.0)), np.nan)
        if not np.all(np.isfinite(covariance)):
            covariance, ses = None, None
    except np.linalg.LinAlgError:
        pass

    return MapResult(
        parameters=p_hat,
        log_likelihood=loglik,
        log_posterior=logpost,
        converged=converged,
        iterations=it,
        gradient_norm=gnorm,
        covariance=covariance,
        standard_errors=ses,
    )
