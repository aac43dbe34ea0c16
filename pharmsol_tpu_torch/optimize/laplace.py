"""Conditional maximum-likelihood population estimation (Laplace/FOCE class).

The counterpart of the JAX package's ``optimize/laplace.py``: maximize the
Laplace approximation of the marginal likelihood

  log p(y_i) ~= ll_i(phi_hat_i) - 0.5*eta_hat' D^-1 eta_hat
                - 0.5*log det D - 0.5*log det H_i,
  H_i = -grad^2_eta [ ll_i(mu + eta) - 0.5 eta' D^-1 eta ]  at eta_hat_i

over the population parameters (mu, omega, sigma), every ingredient exact:

- the inner modes eta_hat_i come from a fixed-length damped-Newton loop
  (Levenberg-Marquardt with per-subject accept/reject) whose per-subject
  gradients fall out of one reverse pass over the summed conditional LL
  (subjects are independent) and whose Hessians come from d
  Hessian-vector products with basis vectors broadcast over the subjects;
- the outer objective differentiates through the modes by the implicit
  function theorem: :class:`_InnerModes` is a ``torch.autograd.Function``
  whose ``backward`` solves with the inner Hessian and takes the partial
  derivatives of the inner gradient at the fixed modes, in differentiable
  operations, so that the standard-error Hessian differentiates through it
  again;
- L-BFGS with a zoom line search (``optimize/_lbfgs.py``) drives the outer
  objective; standard errors come from its exact Hessian (delta method
  back to the natural scale).

Every derivative is ``torch.autograd``'s: closed forms and ``expm`` end to
end, adaptive ODE solvers through the continuous forward sensitivities of
``engine/sens.py`` (where the JAX package switches its whole pipeline to
forward mode). SDE models are refused with a pointer to ``fit_saem``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import float_dtype
from ..data.residual_error import (
    RESIDUAL_KIND_CODE,
    ResidualErrorModels,
    ResidualKind,
)
from ..errors import PharmsolError
from ._condll import (
    REVERSE_DIFF_SOLVERS,
    build_cond_ll,
    fitted_residual_models,
    named_theta0,
    resolve_transform,
    tile_cond_ll,
    to_natural,
)
from ._coveffects import resolve_covariate_effects
from ._lbfgs import Lbfgs, batch_value_and_grad_fn, value_and_grad_fn


class LaplaceResult(NamedTuple):
    """Population estimates from a Laplace conditional-ML fit."""

    theta: np.ndarray            # [n_params] typical values, natural scale
    omega: np.ndarray            # [n_params] random-effect SDs (transformed scale)
    residual_models: ResidualErrorModels
    individual_parameters: np.ndarray  # [n_subjects, n_params] conditional modes
    eta: np.ndarray              # [n_subjects, n_params] random-effect modes
    log_likelihood: float        # Laplace marginal log-likelihood at the optimum
    converged: bool
    iterations: int
    gradient_norm: float
    standard_errors: Optional[np.ndarray]  # SEs of theta (natural scale)
    omega_standard_errors: Optional[np.ndarray]
    parameter_names: Optional[tuple]
    transform: tuple
    omega_cov: Optional[np.ndarray] = None  # [p, p] random-effect covariance
    beta: Optional[np.ndarray] = None       # [n_eff] covariate coefficients
    beta_standard_errors: Optional[np.ndarray] = None
    covariate_labels: Optional[tuple] = None
    covariate_effects: Optional[tuple] = None  # resolved (j, cov, form, ref)
    n_free: int = 0              # fitted psi coordinates (mu+beta+omega+sigma)
    n_obs: int = 0               # active observations in the fit
    omega_iov: Optional[np.ndarray] = None  # [q] occasion-level SDs
    omega_iov_standard_errors: Optional[np.ndarray] = None
    iov_parameters: Optional[tuple] = None  # parameter indices with IOV
    kappa: Optional[np.ndarray] = None      # [n_sub, K_max, q] occasion modes

    def aic(self) -> float:
        """Akaike information criterion: -2 LL + 2 k."""
        return -2.0 * self.log_likelihood + 2.0 * self.n_free

    def bic(self) -> float:
        """Bayesian information criterion: -2 LL + k log(n_obs)."""
        return -2.0 * self.log_likelihood + self.n_free * float(
            np.log(max(self.n_obs, 1))
        )

    def correlation(self) -> Optional[np.ndarray]:
        """Random-effect correlation matrix (None for diagonal fits)."""
        if self.omega_cov is None:
            return None
        sd = np.sqrt(np.diag(self.omega_cov))
        return self.omega_cov / np.outer(sd, sd)

    def summary(self) -> str:
        names = self.parameter_names or tuple(
            f"p[{i}]" for i in range(len(self.theta))
        )
        lines = [
            f"Laplace fit: loglik={self.log_likelihood:.6g}, "
            f"{'converged' if self.converged else 'NOT converged'} in "
            f"{self.iterations} iters, |grad|={self.gradient_norm:.3g}"
        ]
        for i, nm in enumerate(names):
            se = (f" +- {self.standard_errors[i]:.4g}"
                  if self.standard_errors is not None else "")
            lines.append(
                f"  {nm}: typical {self.theta[i]:.6g}{se}, "
                f"omega {self.omega[i]:.4g} ({self.transform[i]})"
            )
        corr = self.correlation()
        if corr is not None:
            for i in range(len(names)):
                for j in range(i):
                    lines.append(
                        f"  corr({names[j]}, {names[i]}) = {corr[j, i]:.3f}"
                    )
        if self.beta is not None and self.covariate_labels:
            for k, lbl in enumerate(self.covariate_labels):
                se = (f" +- {self.beta_standard_errors[k]:.4g}"
                      if self.beta_standard_errors is not None else "")
                lines.append(f"  {lbl}: beta {self.beta[k]:.4g}{se}")
        if self.omega_iov is not None and self.iov_parameters:
            for k, j in enumerate(self.iov_parameters):
                se = (f" +- {self.omega_iov_standard_errors[k]:.4g}"
                      if self.omega_iov_standard_errors is not None else "")
                lines.append(
                    f"  {names[j]}: omega_iov {self.omega_iov[k]:.4g}{se}"
                )
        return "\n".join(lines)


def _sigma_param_layout(kinds_np, est_sigma):
    """(outeq, field) slots exposed as free log-parameters."""
    slots = []
    if not est_sigma:
        return slots
    for o, k in enumerate(kinds_np):
        if k == RESIDUAL_KIND_CODE[ResidualKind.CONSTANT]:
            slots.append((o, "a"))
        elif k == RESIDUAL_KIND_CODE[ResidualKind.PROPORTIONAL]:
            slots.append((o, "b"))
        elif k == RESIDUAL_KIND_CODE[ResidualKind.COMBINED]:
            slots.append((o, "a"))
            slots.append((o, "b"))
        elif k == RESIDUAL_KIND_CODE[ResidualKind.EXPONENTIAL]:
            slots.append((o, "a"))
    return slots


def _resolve_iov(iov, p: int, names) -> tuple:
    """Normalize the IOV spec to sorted unique parameter indices."""
    if iov is None:
        return ()
    idx = []
    for item in (iov if isinstance(iov, (list, tuple)) else (iov,)):
        if isinstance(item, str):
            if names is not None and item in names:
                j = names.index(item)
            elif item.startswith("p[") and item.endswith("]"):
                j = int(item[2:-1])
            else:
                raise PharmsolError(
                    f"unknown IOV parameter {item!r} "
                    f"(known: {list(names) if names else f'p[0..{p - 1}]'})"
                )
        else:
            j = int(item)
        if not 0 <= j < p:
            raise PharmsolError(f"IOV parameter index {j} out of range")
        idx.append(j)
    if len(set(idx)) != len(idx):
        raise PharmsolError("duplicate IOV parameters")
    return tuple(sorted(idx))


class _InnerModes(torch.autograd.Function):
    """``u*(m, prec, prec_iov, sig_a, sig_b)`` (per subject: ``m`` [N, p],
    ``prec`` [N, p, p], ``prec_iov`` [N, q]; per grid row: ``sig_a``,
    ``sig_b`` [R, nout]): the inner modes, by the
    damped Newton loop forward and by the implicit function theorem
    backward. At the fixed point ``r(u*, args) = grad_u G(u*, args) = 0``,
    so ``du*/dargs = H^-1 dr/dargs`` with ``H = -hess_u G``: the backward
    pass is one block solve with ``H`` and one product with the partial
    derivatives of ``r`` at the fixed ``u*``. Those partials are taken with
    respect to aliases of the arguments (``view_as``), which the modes do
    not depend on, so that autograd does not follow ``u*`` back into this
    Function; under ``create_graph`` every operation is recorded, and the
    standard-error Hessian differentiates through the backward pass again
    (with ``u*``'s own derivative by this rule once more)."""

    @staticmethod
    def forward(ctx, m, prec, prec_iov, sig_a, sig_b, y, lap):
        u = lap.newton(m, prec, prec_iov, sig_a, sig_b, y)
        ctx.lap, ctx.y = lap, y
        ctx.save_for_backward(u, m, prec, prec_iov, sig_a, sig_b)
        return u

    @staticmethod
    def backward(ctx, w):
        u, *args = ctx.saved_tensors
        lap, y = ctx.lap, ctx.y
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            if create and u.requires_grad:
                aliases = [a.view_as(a) if a.requires_grad
                           else a.detach().requires_grad_(True) for a in args]
            else:
                u = u.detach().requires_grad_(True)
                aliases = [a.detach().requires_grad_(True) for a in args]
            g, H = lap.grad_hess(u, *aliases, y, create_graph=create)
            H = H + lap.ridge * lap.eye_d
            uu = torch.linalg.solve_ex(H, w.unsqueeze(-1))[0][..., 0]  # H is symmetric
            grads = torch.autograd.grad(g, aliases, grad_outputs=uu, create_graph=create,
                                        allow_unused=True)
        grads = [None if not need else gr for gr, need in zip(grads, ctx.needs_input_grad)]
        return tuple(grads) + (None, None)


class _Laplace:
    """The Laplace objective's pieces over one population (see
    :func:`fit_laplace`), or over ``B`` copies of it whose subjects each
    carry their lane's prior (a ``tile_cond_ll`` population): the prior
    precisions come per subject (``prec`` [N, p, p], ``prec_iov`` [N, q]) and
    the residual parameters per grid row (``sig_a``, ``sig_b`` [R, nout]).
    Subjects share no operation that mixes them, so a NaN in one lane stays
    in its lane."""

    def __init__(self, cond, p, d_in, k_max, q, is_log, onehot_iov, inner_steps, fd, dev):
        self.cond, self.p, self.d_in, self.k_max, self.q = cond, p, d_in, k_max, q
        self.n_sub = cond.n_sub
        self.is_log = is_log
        self.onehot_iov = onehot_iov
        self.inner_steps = inner_steps
        self.eye_d = torch.eye(d_in, dtype=fd, device=dev)
        self.ridge = 1e-9
        self.fd, self.dev = fd, dev

    def cond_ll(self, u, m, sig_a, sig_b, y=None):
        """Per-subject conditional LL at the inner variables ``u`` [n_sub,
        d_in] = [eta | kappa per occasion]."""
        p, q, cond = self.p, self.q, self.cond
        if q:
            phi = m + u[:, :p]
            kap = u[:, p:].reshape(self.n_sub, self.k_max, q)
            rs, ro = cond.row_subject, cond.row_occasion
            phi_rows = phi[rs] + kap[rs, ro] @ self.onehot_iov
            return cond.ll_parts(to_natural(phi_rows, self.is_log), sig_a, sig_b, y,
                                 per_row=True)[0]
        return cond.ll_parts(to_natural(m + u, self.is_log), sig_a, sig_b, y)[0]

    def prior_quad(self, u, prec, prec_iov):
        """Per-subject 0.5 u' P u under the block-diagonal prior."""
        p, q = self.p, self.q
        eta = u[:, :p]
        quad = 0.5 * torch.sum((eta.unsqueeze(1) @ prec)[:, 0] * eta, dim=-1)
        if q:
            kap = u[:, p:].reshape(self.n_sub, self.k_max, q)
            quad = quad + 0.5 * torch.sum(kap * kap * prec_iov[:, None, :], dim=(1, 2))
        return quad

    def objective(self, u, m, prec, prec_iov, sig_a, sig_b, y=None):
        return self.cond_ll(u, m, sig_a, sig_b, y) - self.prior_quad(u, prec, prec_iov)

    def grad_hess(self, u, m, prec, prec_iov, sig_a, sig_b, y=None, create_graph=False):
        """Per-subject gradient [n_sub, d] and negated Hessian [n_sub, d, d]
        of the joint log-density in ``u`` (which must require grad).
        Subjects are independent: the gradient of the sum is the stack of
        per-subject gradients, and the Hessian's blocks come from d
        Hessian-vector products with basis vectors broadcast over the
        subjects. The gradient keeps its graph (the implicit rule
        differentiates it); the Hessian does with ``create_graph``."""
        return self.value_grad_hess(u, m, prec, prec_iov, sig_a, sig_b, y, create_graph)[1:]

    def value_grad_hess(self, u, m, prec, prec_iov, sig_a, sig_b, y=None, create_graph=False):
        """:meth:`grad_hess` with the per-subject joint log-density [n_sub]
        it differentiates, from the same forward pass."""
        f = self.objective(u, m, prec, prec_iov, sig_a, sig_b, y)
        (g,) = torch.autograd.grad(torch.sum(f), u, create_graph=True)
        # the d products in one batched backward pass
        basis = self.eye_d[:, None, :].expand(self.d_in, self.n_sub, self.d_in)
        (cols,) = torch.autograd.grad(g, u, grad_outputs=basis, retain_graph=True,
                                      create_graph=create_graph, is_grads_batched=True)
        H = -cols.transpose(0, 1)  # [n_sub, k, d]: negative, a precision
        return f, g, H

    def newton(self, m, prec, prec_iov, sig_a, sig_b, y=None):
        """Per-subject Levenberg-Marquardt damped Newton to the modes, a
        fixed number of steps, on detached values. One forward pass a step:
        the candidate's objective, gradient and Hessian come together, and
        a subject that rejects its candidate keeps those of its current
        point (each subject's are its own)."""
        args = [a.detach() for a in (m, prec, prec_iov, sig_a, sig_b)]
        y = None if y is None else y.detach()
        eye_d = self.eye_d

        def obj(e):
            with torch.no_grad():
                return self.objective(e, *args, y)

        def obj_grad_hess(e):
            with torch.enable_grad():
                f, g, H = self.value_grad_hess(e.detach().requires_grad_(True), *args, y)
            return f.detach(), g.detach(), H.detach()

        u = torch.zeros((self.n_sub, self.d_in), dtype=self.fd, device=self.dev)
        lam = torch.full((self.n_sub,), 1e-2, dtype=self.fd, device=self.dev)
        f, g, H = obj_grad_hess(u)
        for step in range(self.inner_steps):
            Hd = H + (self.ridge + lam[:, None, None]) * eye_d[None]
            delta = torch.linalg.solve_ex(Hd, g.unsqueeze(-1))[0][..., 0]
            # overflow guard only: the damping does the real step control
            norm = torch.sqrt(torch.sum(delta * delta, dim=-1, keepdim=True))
            delta = delta * torch.clamp(6.0 / torch.clamp(norm, min=1e-12), max=1.0)
            cand = u + delta
            last = step == self.inner_steps - 1
            if last:
                fc = obj(cand)
            else:
                fc, gc, Hc = obj_grad_hess(cand)
            better = torch.isfinite(fc) & (fc >= f)
            u = torch.where(better[:, None], cand, u)
            f = torch.where(better, fc, f)
            if not last:
                g = torch.where(better[:, None], gc, g)
                H = torch.where(better[:, None, None], Hc, H)
            lam = torch.clamp(torch.where(better, lam * 0.25, lam * 8.0), 1e-10, 1e10)
        return u

    def modes(self, m, prec, prec_iov, sig_a, sig_b, y=None):
        return _InnerModes.apply(m, prec, prec_iov, sig_a, sig_b, y, self)


def fit_laplace(
    equation,
    data,
    residual_error_models: ResidualErrorModels,
    theta0,
    *,
    omega0=0.3,
    omega: str = "diagonal",
    transform="log",
    covariate_effects=None,
    iov=None,
    omega_iov0=0.1,
    est_sigma: bool = True,
    inner_steps: int = 25,
    max_iters: int = 100,
    grad_tol: float = 1e-4,
    compute_se: bool = True,
    _introspect: Optional[dict] = None,
    _build_only: bool = False,
    device=None,
) -> LaplaceResult:
    """Fit a parametric mixed-effects model by exact-Hessian Laplace ML, on
    ``device`` (default: the card).

    The keywords are the JAX package's (``optimize/laplace.py::
    fit_laplace``): ``theta0`` typical values (a dict needs metadata),
    ``omega0`` the initial random-effect SD on the transformed scale,
    ``omega='full'`` a Cholesky-parameterized full covariance,
    ``covariate_effects`` ``(parameter, covariate, form[, reference])``
    effects on the typical values (one fitted beta each), ``iov``
    parameters with occasion-level effects (``omega_iov0`` their initial
    SD), ``inner_steps`` the damped-Newton steps per inner solve. The
    private ``_introspect`` dict receives the objective's pieces (the JAX
    package's keys); ``_build_only`` stops before the fit.
    """
    theta0, names = named_theta0(equation, theta0)
    p = theta0.shape[0]
    transform = resolve_transform(transform, p)
    is_log = np.asarray([t == "log" for t in transform])
    if np.any(is_log & (theta0 <= 0.0)):
        raise PharmsolError("log-transformed parameters need theta0 > 0")
    omega0 = np.broadcast_to(np.asarray(omega0, dtype=np.float64), (p,)).copy()
    if np.any(omega0 <= 0.0):
        raise PharmsolError("omega0 must be positive")
    if omega not in ("diagonal", "full"):
        raise PharmsolError("omega must be 'diagonal' or 'full'")
    full_omega = omega == "full"
    n_off = p * (p - 1) // 2 if full_omega else 0
    tril_r, tril_c = np.tril_indices(p, -1)
    if inner_steps < 1:
        raise PharmsolError("inner_steps must be >= 1")

    # engine gating: SDE likelihoods (discrete resampling) are not
    # differentiable; adaptive ODE solvers differentiate through the
    # forward sensitivities of engine/sens.py
    if getattr(equation, "kind", None) == "sde":
        raise PharmsolError(
            "fit_laplace cannot differentiate SDE likelihoods (discrete "
            "particle resampling); use fit_saem"
        )
    solver = getattr(getattr(equation, "_opts", None), "solver", None)
    adaptive = getattr(equation, "kind", None) == "ode" and solver not in REVERSE_DIFF_SOLVERS
    cond = build_cond_ll(equation, data, residual_error_models,
                         require_reverse_diff=not adaptive, device=device)
    n_sub = cond.n_sub
    if n_sub < 2:
        raise PharmsolError("population fitting needs at least 2 subjects")
    iov_idx = _resolve_iov(iov, p, names)
    q = len(iov_idx)
    k_max = int(cond.n_occ_max) if q else 1
    if q and k_max < 2:
        raise PharmsolError(
            "iov requested but no subject has more than one occasion "
            "(occasion-level effects are unidentifiable)"
        )
    omega_iov0 = np.broadcast_to(np.asarray(omega_iov0, dtype=np.float64), (q,)).copy()
    if np.any(omega_iov0 <= 0.0):
        raise PharmsolError("omega_iov0 must be positive")
    ce = resolve_covariate_effects(covariate_effects, cond.subjects, p, names)
    n_eff = ce.n_eff if ce is not None else 0
    slots = _sigma_param_layout(cond.kinds_np, est_sigma)
    n_sig = len(slots)
    if est_sigma:
        for o, field in slots:
            v = (cond.lowered_a if field == "a" else cond.lowered_b)[o]
            if v <= 0.0:
                raise PharmsolError(
                    f"est_sigma needs positive initial residual "
                    f"parameters (outeq {o} {field} = {v})"
                )

    dev, fd = cond.device, float_dtype()
    # a closed form's objective reads no device value on the host: on the
    # card its evaluations replay from a CUDA graph (``_lbfgs.cuda_graphed``),
    # here and in the replicate programs, which take ``lanes_value_and_grad``
    graph = dev.type == "cuda" and getattr(equation, "kind", None) == "analytical"

    def tens(a, dtype=fd):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    is_log_t = tens(is_log, torch.bool)
    base_a, base_b = tens(cond.lowered_a), tens(cond.lowered_b)
    a_idx = tens([o for o, f in slots if f == "a"], torch.int64)
    b_idx = tens([o for o, f in slots if f == "b"], torch.int64)
    a_pos = tens([i for i, (_, f) in enumerate(slots) if f == "a"], torch.int64)
    b_pos = tens([i for i, (_, f) in enumerate(slots) if f == "b"], torch.int64)
    tril = (tens(tril_r, torch.int64), tens(tril_c, torch.int64))
    eye = torch.eye(p, dtype=fd, device=dev)
    # inner variable per subject: u = [eta(p), kappa_1..kappa_Kmax (q each)]
    d_in = p + (k_max * q if q else 0)
    onehot_iov = tens(np.eye(p)[list(iov_idx)]) if q else None
    lap = _Laplace(cond, p, d_in, k_max, q, is_log_t, onehot_iov, inner_steps, fd, dev)
    # psi layout:
    #   [mu(p), beta(n_eff), log-diag-L(p), offdiag(n_off), log-om-iov(q), sig]
    o_ld = p + n_eff
    o_off = o_ld + p
    o_iov = o_off + n_off
    o_sig = o_iov + q
    if ce is not None:
        x_eff, onehot_eff = tens(ce.x), tens(ce.onehot)

    def unpack_lanes(psi, x=None, onehot=None):
        """psi [B, dim] -> (m, L, om_iov, sig_a, sig_b) per lane: the
        transformed-scale prior means [B, n_sub, p], D = L L' (Cholesky
        omega, [B, p, p]), the occasion-level SDs [B, q] and the residual
        parameters [B, nout]. ``x [B, n_sub, n_eff]`` / ``onehot [B, n_eff,
        p]`` override the covariate design."""
        B = psi.shape[0]
        mu = psi[:, :p]
        if n_eff:
            beta = psi[:, p:o_ld]
            xd = x_eff.expand(B, n_sub, n_eff) if x is None else x
            oh = onehot_eff.expand(B, n_eff, p) if onehot is None else onehot
            m = mu[:, None, :] + (xd * beta[:, None, :]) @ oh
        else:
            m = mu[:, None, :].expand(B, n_sub, p)
        lane = torch.arange(B, device=dev)[:, None]
        L = torch.diag_embed(torch.exp(psi[:, o_ld:o_off]))
        if n_off:
            L = L.index_put((lane, tril[0][None], tril[1][None]), psi[:, o_off:o_iov])
        om_iov = torch.exp(psi[:, o_iov:o_sig])
        sig_a, sig_b = base_a.expand(B, -1), base_b.expand(B, -1)
        if n_sig:
            sig = torch.exp(psi[:, o_sig:])
            if a_idx.numel():
                sig_a = sig_a.index_put((lane, a_idx[None]), sig[:, a_pos])
            if b_idx.numel():
                sig_b = sig_b.index_put((lane, b_idx[None]), sig[:, b_pos])
        return m, L, om_iov, sig_a, sig_b

    def unpack(psi, x=None, onehot=None):
        """psi -> (m, L, om_iov, sig_a, sig_b): per-subject transformed-scale
        prior means [n_sub, p], D = L L' (Cholesky omega) and the
        occasion-level SDs [q]. ``x [n_sub, n_eff]`` / ``onehot [n_eff,
        p]`` override the covariate design."""
        out = unpack_lanes(psi[None], None if x is None else x[None],
                           None if onehot is None else onehot[None])
        return tuple(a[0] for a in out)

    def precision(L):
        l_inv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
        return l_inv.transpose(-1, -2) @ l_inv

    laps = {1: lap}

    def lap_of(n_lanes: int) -> _Laplace:
        """The objective's pieces over ``n_lanes`` copies of the population
        (built once per lane count)."""
        if n_lanes not in laps:
            laps[n_lanes] = _Laplace(tile_cond_ll(cond, n_lanes), p, d_in, k_max, q, is_log_t,
                                     onehot_iov, inner_steps, fd, dev)
        return laps[n_lanes]

    def per_subject(lp, prec, prec_iov, sig_a, sig_b):
        """Shared (one lane's) prior and residual parameters, broadcast to
        ``lp``'s subjects and grid rows."""
        n, R = lp.n_sub, lp.cond.row_subject.shape[0]
        return (prec.expand(n, p, p), prec_iov.expand(n, q), sig_a.expand(R, -1),
                sig_b.expand(R, -1))

    def joint_grad_hess(u, m, prec, prec_iov, sig_a, sig_b, y=None, lp=None):
        """The joint log-density's per-subject gradient and negated Hessian
        at ``u``; ``prec`` [p, p], ``prec_iov`` [q], ``sig_a``, ``sig_b``
        [nout] are one lane's (``lp=None``) or already per subject / row."""
        if lp is None:
            lp = lap
            prec, prec_iov, sig_a, sig_b = per_subject(lp, prec, prec_iov, sig_a, sig_b)
        with torch.enable_grad():
            u = u if u.requires_grad else u.detach().requires_grad_(True)
            return lp.grad_hess(u, m, prec, prec_iov, sig_a, sig_b, y, create_graph=True)

    def neg_laplace_wxy_lanes(psi, w, y, x=None, onehot=None):
        """The weighted marginal objective of ``B`` independent lanes at once
        (``psi [B, dim]`` -> ``[B]``): ``w [B, n_sub]`` scales each
        subject's contribution (a case-bootstrap replicate's
        multiplicities), ``y [B, R, O]`` (or None) swaps the observation
        values, ``(x [B, n_sub, n_eff], onehot [B, n_eff, p])`` the
        covariate design. The lanes are folded into the subject axis: one
        evaluation runs every lane's subjects' inner modes, conditional
        likelihood and Hessians, and the gradient of the sum is the stack of
        the lanes' gradients."""
        B = psi.shape[0]
        lp = lap_of(B)
        R = cond.row_subject.shape[0]
        sub_lane = torch.arange(B, device=dev).repeat_interleave(n_sub)
        row_lane = torch.arange(B, device=dev).repeat_interleave(R)
        with torch.enable_grad():
            m, L, om_iov, sig_a, sig_b = unpack_lanes(psi, x, onehot)
            m = m.reshape(B * n_sub, p)
            prec = precision(L)[sub_lane]
            prec_iov = (1.0 / (om_iov * om_iov))[sub_lane]
            sig_a, sig_b = sig_a[row_lane], sig_b[row_lane]
            yy = None if y is None else y.reshape((B * R,) + tuple(y.shape[2:]))
            u = lp.modes(m, prec, prec_iov, sig_a, sig_b, yy)
            ll_i = lp.cond_ll(u, m, sig_a, sig_b, yy)
            _, H = joint_grad_hess(u, m, prec, prec_iov, sig_a, sig_b, yy, lp=lp)
            H = H + lp.ridge * lp.eye_d[None]
            chol, info = torch.linalg.cholesky_ex(H)
            logdet_h = 2.0 * torch.sum(
                torch.log(torch.clamp(torch.diagonal(chol, dim1=1, dim2=2), min=1e-300)),
                dim=-1)
            # a Hessian that is not positive definite has no Cholesky factor
            logdet_h = torch.where(info == 0, logdet_h, torch.full_like(logdet_h, float("nan")))
            quad = lp.prior_quad(u, prec, prec_iov)
            # log det of the block-diagonal prior covariance per subject:
            # 2 tr log L plus K_max occasion blocks (padded kappas cancel
            # exactly against their prior block in logdet_h)
            logdet_d = 2.0 * torch.sum(psi[:, o_ld:o_off], dim=-1)
            if q:
                logdet_d = logdet_d + 2.0 * k_max * torch.sum(psi[:, o_iov:o_sig], dim=-1)
            obj_i = ll_i - quad - 0.5 * logdet_d[sub_lane] - 0.5 * logdet_h
            out = -torch.sum(w * obj_i.reshape(B, n_sub), dim=-1)
        return out if psi.requires_grad else out.detach()

    def neg_laplace_wxy(psi, w, y, x=None, onehot=None):
        """Weighted marginal objective: ``w_i`` scales subject i's
        contribution (a case-bootstrap replicate's multiplicities), ``y``
        swaps the observation values, ``(x, onehot)`` the covariate
        design: one lane of :func:`neg_laplace_wxy_lanes`."""
        return neg_laplace_wxy_lanes(psi[None], w[None], None if y is None else y[None],
                                     None if x is None else x[None],
                                     None if onehot is None else onehot[None])[0]

    ones_w = torch.ones((n_sub,), dtype=fd, device=dev)

    def neg_laplace_wy(psi, w, y):
        return neg_laplace_wxy(psi, w, y)

    def neg_laplace_w(psi, w):
        return neg_laplace_wxy(psi, w, None)

    def neg_laplace(psi):
        return neg_laplace_wxy(psi, ones_w, None)

    def neg_laplace_wy_lanes(psi, w, y):
        return neg_laplace_wxy_lanes(psi, w, y)

    def neg_laplace_w_lanes(psi, w):
        return neg_laplace_wxy_lanes(psi, w, None)

    def inner_modes(m, prec, prec_iov, sig_a, sig_b, y=None):
        return lap.modes(m, *per_subject(lap, prec, prec_iov, sig_a, sig_b), y)

    mu0 = np.where(is_log, np.log(theta0), theta0)
    sig0 = [np.log((cond.lowered_a if f == "a" else cond.lowered_b)[o]) for o, f in slots]
    psi0 = tens(np.concatenate([mu0, np.zeros(n_eff), np.log(omega0), np.zeros(n_off),
                                np.log(omega_iov0), np.asarray(sig0)]))
    if _introspect is not None:
        _introspect.update(
            neg_laplace=neg_laplace, psi0=psi0, unpack=unpack,
            inner_modes=inner_modes, cond=cond, cond_ll=lap.cond_ll,
            joint_grad_hess=joint_grad_hess,
            neg_laplace_w=neg_laplace_w,
            neg_laplace_wy=neg_laplace_wy,
            neg_laplace_wxy=neg_laplace_wxy,
            neg_laplace_w_lanes=neg_laplace_w_lanes,
            neg_laplace_wy_lanes=neg_laplace_wy_lanes,
            neg_laplace_wxy_lanes=neg_laplace_wxy_lanes,
            lanes_value_and_grad=lambda fn: batch_value_and_grad_fn(fn, graph=graph),
            layout=dict(p=p, n_eff=n_eff, o_ld=o_ld, o_off=o_off,
                        n_off=n_off, is_log=is_log, full_omega=full_omega,
                        n_sub=n_sub, tril=(tril_r, tril_c),
                        q_iov=q, o_iov=o_iov, o_sig=o_sig, k_max=k_max,
                        iov_idx=iov_idx),
        )
    if _build_only:
        # machinery only, for callers that run their own optimization over
        # the introspected objective
        return None
    f0 = float(neg_laplace(psi0))
    if not np.isfinite(f0):
        raise PharmsolError(
            f"Laplace objective is non-finite at theta0 (value {f0}); "
            f"adjust theta0/omega0 or the residual error models"
        )

    opt = Lbfgs()
    vg = value_and_grad_fn(neg_laplace, graph=graph)
    z = psi0
    state = opt.init(psi0)
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

    with torch.no_grad():
        m, L, om_iov, sig_a, sig_b = unpack(z)
        prec = precision(L)
        prec_iov = 1.0 / (om_iov * om_iov)
    u_opt = lap.newton(m, *per_subject(lap, prec, prec_iov, sig_a, sig_b)).cpu().numpy().astype(
        np.float64)
    eta = u_opt[:, :p]
    kappa = u_opt[:, p:].reshape(n_sub, k_max, q) if q else None
    loglik = -float(neg_laplace(z))
    z_np = z.detach().cpu().numpy().astype(np.float64)
    if _introspect is not None:
        _introspect["z_opt"] = z_np
    mu_np = z_np[:p]
    beta_np = z_np[p:o_ld] if n_eff else None
    theta = np.where(is_log, np.exp(mu_np), mu_np)
    L_np = L.cpu().numpy().astype(np.float64)
    om_cov = L_np @ L_np.T
    om_sd = np.sqrt(np.diag(om_cov))
    om_iov_np = np.exp(z_np[o_iov:o_sig]) if q else None
    phi = m.cpu().numpy().astype(np.float64) + eta
    indiv = np.where(is_log[None, :], np.exp(phi), phi)

    ses = om_ses = beta_ses = om_iov_ses = None
    if compute_se:
        H = laplace_hessian(neg_laplace, z)
        # the true Hessian is symmetric; asymmetry enters through the
        # implicit rule when the inner Newton is not fully converged:
        # symmetrize so that it degrades SEs instead of poisoning them
        H = 0.5 * (H + H.T)
        if _introspect is not None:
            _introspect["hessian"] = H
        try:
            cov = np.linalg.inv(H)
        except np.linalg.LinAlgError:  # singular Hessian: point estimates only
            cov = None
        d = np.diag(cov) if cov is not None else None
        if d is not None and np.all(np.isfinite(d)) and np.all(d > -1e-12):
            sd = np.sqrt(np.maximum(d, 0.0))
            # delta method: theta = exp(mu) on log axes, omega = exp(z);
            # the full-omega SD is a nonlinear mix of Cholesky entries, so
            # only the diagonal fit exposes omega SEs directly
            ses = np.where(is_log, theta * sd[:p], sd[:p])
            if n_eff:
                beta_ses = sd[p:o_ld]
            if not full_omega:
                om_ses = om_sd * sd[o_ld:o_off]
            if q:
                om_iov_ses = om_iov_np * sd[o_iov:o_sig]

    return LaplaceResult(
        theta=theta,
        omega=om_sd,
        residual_models=fitted_residual_models(equation, residual_error_models, sig_a,
                                               sig_b, est_sigma),
        individual_parameters=indiv,
        eta=eta,
        log_likelihood=loglik,
        converged=converged,
        iterations=it,
        gradient_norm=gnorm,
        standard_errors=ses,
        omega_standard_errors=om_ses,
        parameter_names=names,
        transform=transform,
        omega_cov=om_cov if full_omega else None,
        beta=beta_np,
        beta_standard_errors=beta_ses,
        covariate_labels=ce.labels if ce is not None else None,
        covariate_effects=ce.specs if ce is not None else None,
        n_free=int(psi0.shape[0]),
        n_obs=int(cond.active.sum()),
        omega_iov=om_iov_np,
        omega_iov_standard_errors=om_iov_ses,
        iov_parameters=iov_idx if q else None,
        kappa=kappa,
    )


def laplace_hessian(neg_laplace, z: torch.Tensor) -> np.ndarray:
    """The exact Hessian [dim, dim] (float64, host) of the Laplace objective
    at ``z``: its gradient with the graph kept, then one batched reverse
    pass over the coordinates through it (and through the implicit rule of
    the modes)."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(neg_laplace(zz), zz, create_graph=True)
        basis = torch.eye(zz.shape[0], dtype=zz.dtype, device=zz.device)
        (H,) = torch.autograd.grad(g, zz, grad_outputs=basis, is_grads_batched=True)
    return H.detach().cpu().numpy().astype(np.float64)
