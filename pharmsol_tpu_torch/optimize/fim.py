"""Exact-Hessian (Laplace) standard errors at any fitter's estimates.

The counterpart of the JAX package's ``optimize/fim.py``. SAEM carries no
Hessian of its own; the standard practice (Monolix "linearization", NONMEM
$COV after METHOD=SAEM) evaluates a deterministic marginal approximation's
information matrix at the converged estimates. Here that approximation is
the Laplace objective of :func:`~.laplace.fit_laplace`, built in its
machinery-only mode (``_build_only``, ``_introspect``), assembled into the
psi vector from the fit's (theta, beta, omega, sigma) and differentiated
twice by ``torch.autograd``. The gradient norm at the point says how far it
sits from the Laplace surface's own stationary point.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..errors import PharmsolError

__all__ = ["FimResult", "laplace_standard_errors"]


class FimResult(NamedTuple):
    """Laplace-information uncertainty report at a point estimate."""

    theta_se: Optional[np.ndarray]        # natural scale (delta method)
    omega_se: Optional[np.ndarray]        # random-effect SD scale
    beta_se: Optional[np.ndarray]         # covariate coefficients
    sigma_se: Optional[np.ndarray]        # residual sigma coordinates
    covariance: Optional[np.ndarray]      # [dim, dim] psi-scale covariance
    correlation: Optional[np.ndarray]     # [dim, dim] estimate correlations
    condition_number: float               # of the psi-scale Hessian
    gradient_norm: float                  # |grad| of the Laplace objective
    log_likelihood: float                 # Laplace marginal LL at the point
    names: tuple                          # psi coordinate labels

    def summary(self) -> str:
        lines = [
            f"Laplace information at the supplied estimates: "
            f"LL {self.log_likelihood:.4f}, |grad| {self.gradient_norm:.3g}, "
            f"condition number {self.condition_number:.3g}"
        ]
        if self.covariance is None:
            lines.append("  Hessian not positive definite - no SEs")
        return "\n".join(lines)


def laplace_standard_errors(
    equation,
    data,
    residual_error_models,
    fit,
    device=None,
    **laplace_kwargs,
) -> FimResult:
    """Exact-Hessian SEs of the Laplace marginal at ``fit``'s estimates, on
    ``device`` (default: the card).

    ``fit``: a :class:`SaemResult` or :class:`LaplaceResult` (anything
    exposing ``theta``, ``omega`` / ``omega_cov``, ``transform`` and
    optionally ``beta`` + ``covariate_effects``). Pass the same structural
    keywords the fit used (``est_sigma``, ``inner_steps``...); ``omega``,
    ``covariate_effects`` and ``transform`` are read from the result, the
    residual sigmas from ``fit.residual_models`` when present.
    """
    from .laplace import _sigma_param_layout, fit_laplace, laplace_hessian

    theta = np.asarray(fit.theta, dtype=np.float64)
    transform = tuple(fit.transform)
    is_log = np.asarray([t == "log" for t in transform])
    p = theta.shape[0]
    om_cov = getattr(fit, "omega_cov", None)
    full_omega = om_cov is not None
    beta = getattr(fit, "beta", None)
    specs = getattr(fit, "covariate_effects", None)
    if beta is not None and not specs:
        raise PharmsolError("fit carries beta but no covariate_effects specs")
    rems = getattr(fit, "residual_models", None)
    if rems is None:
        rems = residual_error_models

    iov_params = getattr(fit, "iov_parameters", None)
    omega_iov = getattr(fit, "omega_iov", None)
    for k in ("omega", "covariate_effects", "transform", "iov",
              "_introspect", "_build_only", "compute_se"):
        laplace_kwargs.pop(k, None)
    intro: Dict[str, Any] = {}
    fit_laplace(
        equation, data, rems, theta,
        omega=("full" if full_omega else "diagonal"),
        covariate_effects=(list(specs) if specs else None),
        transform=transform,
        iov=(list(iov_params) if iov_params else None),
        _introspect=intro, _build_only=True, device=device, **laplace_kwargs,
    )
    neg = intro["neg_laplace"]
    lay = intro["layout"]
    cond = intro["cond"]
    n_eff = int(lay["n_eff"])
    o_ld, o_off = int(lay["o_ld"]), int(lay["o_off"])
    n_off = int(lay["n_off"])
    tril_r, tril_c = lay["tril"]

    # psi = [mu, beta, log diag L, off(L), log omega_iov, log sigma] from the fit
    mu = np.where(is_log, np.log(theta), theta)
    if full_omega:
        L = np.linalg.cholesky(np.asarray(om_cov, dtype=np.float64))
    else:
        L = np.diag(np.asarray(fit.omega, dtype=np.float64))
    parts = [mu]
    names = [f"mu[{i}]" for i in range(p)]
    if n_eff:
        parts.append(np.asarray(beta, dtype=np.float64))
        names += [f"beta[{k}]" for k in range(n_eff)]
    parts.append(np.log(np.maximum(np.diag(L), 1e-300)))
    names += [f"log_omega[{i}]" for i in range(p)]
    if n_off:
        parts.append(L[tril_r, tril_c])
        names += [f"chol_off[{k}]" for k in range(n_off)]
    q_iov = int(lay.get("q_iov", 0))
    if q_iov:
        parts.append(np.log(np.asarray(omega_iov, dtype=np.float64)))
        names += [f"log_omega_iov[{j}]" for j in iov_params]
    est_sigma = laplace_kwargs.get("est_sigma", True)
    slots = _sigma_param_layout(cond.kinds_np, est_sigma)
    sig_vals = []
    for o, field in slots:
        v = (cond.lowered_a if field == "a" else cond.lowered_b)[o]
        if v <= 0.0:
            raise PharmsolError(
                f"residual parameter for outeq {o} field {field} must be "
                f"positive to evaluate the information matrix (got {v})"
            )
        sig_vals.append(np.log(v))
        names.append(f"log_sigma[{o}.{field}]")
    if sig_vals:
        parts.append(np.asarray(sig_vals))
    psi = torch.as_tensor(np.concatenate(parts), dtype=intro["psi0"].dtype,
                          device=intro["psi0"].device)

    with torch.enable_grad():
        z = psi.detach().requires_grad_(True)
        value = neg(z)
        (g,) = torch.autograd.grad(value, z)
    loglik = -float(value.detach())
    gnorm = float(g.abs().max())
    H = laplace_hessian(neg, psi)
    H = 0.5 * (H + H.T)
    eigvals = np.linalg.eigvalsh(H)
    cond_num = float(eigvals[-1] / eigvals[0]) if eigvals[0] > 0 else float("inf")

    theta_se = omega_se = beta_se = sigma_se = None
    cov = corr = None
    try:
        cov = np.linalg.inv(H)
        d = np.diag(cov)
        if np.all(np.isfinite(d)) and np.all(d > -1e-12):
            sd = np.sqrt(np.maximum(d, 0.0))
            theta_se = np.where(is_log, theta * sd[:p], sd[:p])
            if n_eff:
                beta_se = sd[p:o_ld]
            if not full_omega:
                omega_se = np.asarray(fit.omega) * sd[o_ld:o_off]
            if sig_vals:
                # sigma = exp(psi): delta method on the natural scale
                o_sig = int(lay.get("o_sig", o_off + n_off))
                sigma_se = np.exp(np.asarray(sig_vals)) * sd[o_sig:]
            with np.errstate(invalid="ignore", divide="ignore"):
                corr = cov / np.outer(sd, sd)
        else:
            cov = None
    except np.linalg.LinAlgError:
        cov = None

    return FimResult(
        theta_se=theta_se,
        omega_se=omega_se,
        beta_se=beta_se,
        sigma_se=sigma_se,
        covariance=cov,
        correlation=corr,
        condition_number=cond_num,
        gradient_norm=gnorm,
        log_likelihood=loglik,
        names=tuple(names),
    )
