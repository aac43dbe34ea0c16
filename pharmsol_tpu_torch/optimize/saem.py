"""Parametric population estimation (SAEM) on the per-subject batch march.

The counterpart of the JAX package's ``optimize/saem.py``, the parametric
sibling of ``optimize.npag.fit_population``:

  model:   phi_i = T(theta_i) ~ N(mu_i, Omega),  T = log or identity,
           mu_i = mu + W_i beta (covariate effects)
           y_ij ~ N(f(theta_i), sigma(f)^2)   per-outeq residual models
  E-step:  random-walk Metropolis on phi_i over every subject at once, the
           proposal shaped by the population covariance and scaled per
           subject by Robbins-Monro adaptation toward 0.3 acceptance; a
           second block over the occasion-level kappa draws (IOV)
  SA:      sufficient statistics smoothed with gamma_k = 1 (burn-in) then
           1/k (estimation)
  M-step:  mu (and the covariate coefficients by GLS), Omega and
           omega_iov from the smoothed moments; residual a/b from the
           smoothed squared residuals (closed form, or an MM fixed point
           for combined's joint (a, b))

Each iteration is a few batched calls of the conditional likelihood
(``optimize/_condll.py``: the general engine's per-row march on the
device); the loop over iterations and MH steps runs on the host. The draws
come from a CPU ``torch.Generator`` seeded with ``seed`` and are moved to
the device, so that a fit on the card and one on the CPU take the same
draws; the private ``_draws`` hook takes them from the caller instead (the
JAX package draws from its own key schedule, whose draws a test can hand
over).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import float_dtype
from ..data.residual_error import RESIDUAL_KIND_CODE, ResidualErrorModels, ResidualKind
from ..errors import PharmsolError
from ._condll import (
    build_cond_ll,
    fitted_residual_models,
    named_theta0,
    resolve_transform,
    to_natural,
)
from ._coveffects import resolve_covariate_effects


class SaemResult(NamedTuple):
    """Population estimates from a SAEM fit."""

    theta: np.ndarray            # [n_params] typical values, natural scale
    omega: np.ndarray            # [n_params] random-effect SDs (transformed scale)
    residual_models: ResidualErrorModels  # a/b updated when est_sigma
    individual_parameters: np.ndarray     # [n_subjects, n_params] natural scale
    ll_trace: np.ndarray         # [n_iters] total conditional LL per iteration
    accept_rate: float           # mean MH acceptance over the estimation phase
    log_likelihood: Optional[float]  # IS estimate (ll_draws>0) else None
    parameter_names: Optional[tuple]
    transform: tuple             # per-parameter 'log' / 'identity'
    omega_cov: Optional[np.ndarray] = None  # [p, p] random-effect covariance
    beta: Optional[np.ndarray] = None       # [n_eff] covariate coefficients
    covariate_labels: Optional[tuple] = None
    covariate_effects: Optional[tuple] = None  # resolved (j, cov, form, ref)
    n_free: int = 0              # fitted scalars (mu+beta+omega+sigma)
    n_obs: int = 0               # active observations in the fit
    omega_iov: Optional[np.ndarray] = None  # [q] occasion-level SDs
    iov_parameters: Optional[tuple] = None  # parameter indices with IOV
    kappa: Optional[np.ndarray] = None      # [n_sub, K_max, q] smoothed draws

    def aic(self) -> float:
        """AIC from the IS marginal LL (nan unless ll_draws > 0)."""
        if self.log_likelihood is None:
            return float("nan")
        return -2.0 * self.log_likelihood + 2.0 * self.n_free

    def bic(self) -> float:
        """BIC from the IS marginal LL (nan unless ll_draws > 0)."""
        if self.log_likelihood is None:
            return float("nan")
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
            f"SAEM fit: {len(self.theta)} parameters, "
            f"final conditional LL {self.ll_trace[-1]:.6g}, "
            f"MH acceptance {self.accept_rate:.2f}"
            + (
                f", IS log-likelihood {self.log_likelihood:.6g}"
                if self.log_likelihood is not None
                else ""
            )
        ]
        for i, nm in enumerate(names):
            lines.append(
                f"  {nm}: typical {self.theta[i]:.6g}, "
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
                lines.append(f"  {lbl}: beta {self.beta[k]:.4g}")
        if self.omega_iov is not None and self.iov_parameters:
            for k, j in enumerate(self.iov_parameters):
                lines.append(f"  {names[j]}: omega_iov {self.omega_iov[k]:.4g}")
        return "\n".join(lines)


def saem_draws(seed: int, n_total: int, mh_steps: int, n_sub: int, p: int, k_max: int,
               q: int, ll_draws: int) -> dict:
    """Every normal and uniform a fit takes, from CPU generators seeded with
    ``seed`` (the MH sweeps) and ``seed + 1`` / ``seed + 2`` (the importance
    sample), in float64 on the host: ``phi_noise`` [T, mh, n_sub, p],
    ``phi_unif`` [T, mh, n_sub], with IOV ``kap_noise`` [T, mh, n_sub,
    k_max, q] and ``kap_unif``, and ``is_eta`` [ll_draws, p] (``is_kap``
    [ll_draws, k_max, q])."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    f64 = torch.float64
    out = {"phi_noise": torch.randn((n_total, mh_steps, n_sub, p), generator=gen, dtype=f64),
           "phi_unif": torch.rand((n_total, mh_steps, n_sub), generator=gen, dtype=f64)}
    if q:
        out["kap_noise"] = torch.randn((n_total, mh_steps, n_sub, k_max, q), generator=gen,
                                       dtype=f64)
        out["kap_unif"] = torch.rand((n_total, mh_steps, n_sub), generator=gen, dtype=f64)
    if ll_draws > 0:
        g1 = torch.Generator(device="cpu").manual_seed(int(seed) + 1)
        out["is_eta"] = torch.randn((ll_draws, p), generator=g1, dtype=f64)
        if q:
            g2 = torch.Generator(device="cpu").manual_seed(int(seed) + 2)
            out["is_kap"] = torch.randn((ll_draws, k_max, q), generator=g2, dtype=f64)
    return out


def fit_saem(
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
    n_burn: int = 200,
    n_iters: int = 100,
    mh_steps: int = 5,
    est_sigma: bool = True,
    ll_draws: int = 0,
    seed: int = 0,
    progress: bool = False,
    _draws: Optional[dict] = None,
    _introspect: Optional[dict] = None,
    device=None,
) -> SaemResult:
    """Fit a parametric mixed-effects population model by SAEM, on
    ``device`` (default: the card).

    The keywords are the JAX package's (``optimize/saem.py::fit_saem``):
    ``theta0`` typical values (a dict needs metadata), ``omega0`` the
    initial random-effect SD on the transformed scale, ``omega='full'`` the
    full covariance, ``transform`` 'log' or 'identity' per parameter,
    ``covariate_effects`` ``(parameter, covariate, form[, reference])``,
    ``iov`` parameters with occasion-level effects, ``n_burn`` iterations
    at gamma = 1 then ``n_iters`` at gamma = 1/k, ``mh_steps`` Metropolis
    steps per iteration, ``ll_draws`` > 0 an importance-sampling estimate of
    the marginal log-likelihood at the estimates. Every engine the port has
    is accepted (SDE models predict particle means). ``_draws`` (private)
    replaces the generator's draws (see :func:`saem_draws` for the keys);
    ``_introspect`` (private), a dict, receives every Metropolis decision,
    ``accepted`` [T, mh_steps, n_sub] (and ``kappa_accepted`` with IOV), and
    ``loop_s``, the seconds of the iteration loop up to its ll trace on the
    host.
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
    if n_burn < 1 or n_iters < 1 or mh_steps < 1:
        raise PharmsolError("n_burn, n_iters, and mh_steps must be >= 1")

    cond = build_cond_ll(equation, data, residual_error_models, device=device)
    subjects = cond.subjects
    n_sub = cond.n_sub
    if n_sub < 2:
        raise PharmsolError("SAEM needs at least 2 subjects")
    from .laplace import _resolve_iov

    iov_idx = _resolve_iov(iov, p, names)
    q = len(iov_idx)
    k_max = int(cond.n_occ_max) if q else 1
    if q and k_max < 2:
        raise PharmsolError(
            "iov requested but no subject has more than one occasion "
            "(occasion-level effects are unidentifiable)"
        )
    omega_iov0 = np.broadcast_to(np.asarray(omega_iov0, dtype=np.float64), (q,)).copy()
    if q and np.any(omega_iov0 <= 0.0):
        raise PharmsolError("omega_iov0 must be positive")
    ce = resolve_covariate_effects(covariate_effects, subjects, p, names)
    n_eff = ce.n_eff if ce is not None else 0
    kinds_np = cond.kinds_np
    nout = cond.nout
    obs_outeq, obs_value, active = cond.obs_outeq, cond.obs_value, cond.active
    row_subject = cond.row_subject

    dev, fd = cond.device, float_dtype()

    def tens(a, dtype=fd):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    is_log_t = tens(is_log, torch.bool)
    mu0 = tens(np.where(is_log, np.log(theta0), theta0))
    tiny = float(np.finfo(np.float64).eps)

    if q:
        onehot_iov = tens(np.eye(p)[list(iov_idx)])  # [q, p]
        row_occ = cond.row_occasion
        # [n_sub, k_max] 1.0 on real occasions, 0.0 on padded slots
        occ_valid = tens((np.arange(k_max)[None, :] < np.asarray(cond.n_occ)[:, None])
                         .astype(np.float64))
        n_occ_total = float(np.sum(cond.n_occ))

    def ll_parts(phi_rows, sig_a, sig_b, kap=None):
        if q and kap is not None:
            rows = phi_rows[row_subject] + kap[row_subject, row_occ] @ onehot_iov
            return cond.ll_parts(to_natural(rows, is_log_t), sig_a, sig_b, per_row=True)
        return cond.ll_parts(to_natural(phi_rows, is_log_t), sig_a, sig_b)

    eye_p = torch.eye(p, dtype=fd, device=dev)
    if n_eff:
        x_eff = tens(ce.x)                   # [n_sub, n_eff]
        onehot_eff = tens(ce.onehot)         # [n_eff, p]
        xbar = tens(ce.x.mean(axis=0))       # [n_eff]
        sxx = tens(ce.x.T @ ce.x / n_sub)
        eye_g = torch.eye(p + n_eff, dtype=fd, device=dev)

    def prior_means(mu, beta):
        """Per-subject transformed-scale prior means m_i = mu + W_i beta."""
        if n_eff:
            return mu[None, :] + (x_eff * beta[None, :]) @ onehot_eff
        return mu[None, :].expand(n_sub, p)

    def om_factors(om):
        """Cholesky factor and precision of the [p, p] covariance (a full
        matrix in both modes; diagonal mode zeroes the off-diagonal in the
        M-step)."""
        L = torch.linalg.cholesky(om)
        l_inv = torch.linalg.solve_triangular(L, eye_p, upper=False)
        return L, l_inv.T @ l_inv

    def log_prior(phi, m, prec):
        d = phi - m
        return -0.5 * torch.einsum("np,pq,nq->n", d, prec, d)

    kinds = torch.as_tensor(kinds_np.astype(np.int64), device=dev)
    code = {k: RESIDUAL_KIND_CODE[k] for k in ResidualKind}
    oe_flat = obs_outeq.reshape(-1)
    act_f = active.reshape(-1)
    n_o = tens(np.maximum(cond.n_obs_per_outeq, 1.0))
    has_combined = bool(np.sum(kinds_np == code[ResidualKind.COMBINED]))
    if has_combined:
        oe_mask = act_f[None, :] & (oe_flat[None, :] == torch.arange(nout, device=dev)[:, None])

    def seg_sum(v):
        vals = torch.where(act_f, v.reshape(-1), torch.zeros((), dtype=fd, device=dev))
        return torch.zeros(nout, dtype=fd, device=dev).index_add(0, oe_flat, vals)

    def sigma_m_step(sr2, swsr, sf2, sig_a, sig_b):
        """Per-outeq residual updates from the smoothed statistics."""
        a_cand = torch.sqrt(torch.clamp(seg_sum(sr2) / n_o, min=tiny))
        b_cand = torch.sqrt(torch.clamp(seg_sum(swsr) / n_o, min=tiny))
        new_a = torch.where((kinds == code[ResidualKind.CONSTANT])
                            | (kinds == code[ResidualKind.EXPONENTIAL]), a_cand, sig_a)
        new_b = torch.where(kinds == code[ResidualKind.PROPORTIONAL], b_cand, sig_b)
        if has_combined:
            # joint (a, b) by the MM fixed point for heteroscedastic variance
            # components: with s_j = va + vb*f2_j,
            #   va <- va * sqrt(sum r2_j/s_j^2 / sum 1/s_j)
            # and symmetrically for vb
            zero = torch.zeros((), dtype=fd, device=dev)
            r2_o = torch.where(oe_mask, sr2.reshape(-1)[None, :], zero)
            f2_o = torch.where(oe_mask, sf2.reshape(-1)[None, :], zero)
            va = torch.clamp(sig_a * sig_a, min=tiny)
            vb = torch.clamp(sig_b * sig_b, min=tiny)
            one = torch.ones((), dtype=fd, device=dev)
            for _ in range(30):
                s = torch.where(oe_mask, va[:, None] + vb[:, None] * f2_o, one)
                num_a = torch.where(oe_mask, r2_o / (s * s), zero).sum(dim=1)
                den_a = torch.where(oe_mask, 1.0 / s, zero).sum(dim=1)
                va = va * torch.sqrt(torch.clamp(num_a, min=tiny) / torch.clamp(den_a, min=tiny))
                s = torch.where(oe_mask, va[:, None] + vb[:, None] * f2_o, one)
                num_b = torch.where(oe_mask, f2_o * r2_o / (s * s), zero).sum(dim=1)
                den_b = torch.where(oe_mask, f2_o / s, zero).sum(dim=1)
                vb = vb * torch.sqrt(torch.clamp(num_b, min=tiny) / torch.clamp(den_b, min=tiny))
            comb = kinds == code[ResidualKind.COMBINED]
            new_a = torch.where(comb, torch.sqrt(va), new_a)
            new_b = torch.where(comb, torch.sqrt(vb), new_b)
        return new_a, new_b

    n_total = n_burn + n_iters
    gammas = np.ones(n_total, dtype=np.float64)
    gammas[n_burn:] = 1.0 / (np.arange(n_iters, dtype=np.float64) + 1.0)

    if _draws is None:
        _draws = saem_draws(seed, n_total, mh_steps, n_sub, p, k_max, q, ll_draws)
    draws = {k: torch.as_tensor(v if isinstance(v, torch.Tensor) else np.array(v, dtype=np.float64),
                                dtype=fd).to(dev) for k, v in _draws.items()}

    def kap_log_prior(kap, om_iov):
        # padded slots hold 0 and contribute 0 (occ_valid masks proposals)
        pk = kap / om_iov[None, None, :]
        return -0.5 * torch.sum(pk * pk, dim=(1, 2))

    def take_rows(take, new, old):
        """``new`` on the rows of the subjects that took their proposal."""
        return torch.where(take[row_subject][:, None], new, old)

    decisions = {"accepted": [], "kappa_accepted": []}

    def mh_sweep(it, phi, kap, ll_i, r2, f2, c, ck, m, om_chol, prec, sig_a, sig_b, om_iov):
        lp = log_prior(phi, m, prec)
        acc = torch.zeros(n_sub, dtype=fd, device=dev)
        for j in range(mh_steps):
            # proposal shaped like the current population covariance
            prop = phi + c[:, None] * (draws["phi_noise"][it, j] @ om_chol.T)
            llp, r2p, f2p = ll_parts(prop, sig_a, sig_b, kap if q else None)
            lpp = log_prior(prop, m, prec)
            logr = (llp + lpp) - (ll_i + lp)
            u = torch.log(draws["phi_unif"][it, j])
            take = (u < logr) & torch.isfinite(llp)
            decisions["accepted"].append(take)
            phi = torch.where(take[:, None], prop, phi)
            ll_i = torch.where(take, llp, ll_i)
            lp = torch.where(take, lpp, lp)
            r2 = take_rows(take, r2p, r2)
            f2 = take_rows(take, f2p, f2)
            # Robbins-Monro proposal adaptation toward 0.3 acceptance
            c = torch.clamp(c * torch.exp(0.4 * (take.to(fd) - 0.3)), 1e-3, 10.0)
            acc = acc + take.to(fd)
            if q:
                # second block: occasion-level kappa at fixed phi (the phi
                # prior cancels; only the kappa prior enters)
                kprop = kap + (ck[:, None, None] * draws["kap_noise"][it, j]
                               * om_iov[None, None, :]) * occ_valid[:, :, None]
                llk, r2k, f2k = ll_parts(phi, sig_a, sig_b, kprop)
                logrk = (llk + kap_log_prior(kprop, om_iov)) - (ll_i + kap_log_prior(kap, om_iov))
                uk = torch.log(draws["kap_unif"][it, j])
                takek = (uk < logrk) & torch.isfinite(llk)
                decisions["kappa_accepted"].append(takek)
                kap = torch.where(takek[:, None, None], kprop, kap)
                ll_i = torch.where(takek, llk, ll_i)
                r2 = take_rows(takek, r2k, r2)
                f2 = take_rows(takek, f2k, f2)
                ck = torch.clamp(ck * torch.exp(0.4 * (takek.to(fd) - 0.3)), 1e-3, 10.0)
        return phi, kap, ll_i, r2, f2, c, ck, acc / mh_steps

    # initial state (the JAX package's run(): phi at mu0, the statistics at
    # the initial moments)
    ll0, _, _ = ll_parts(mu0[None, :].expand(n_sub, p).clone(), tens(cond.lowered_a),
                         tens(cond.lowered_b))
    ll0 = ll0.cpu().numpy()
    if not np.all(np.isfinite(ll0)):
        bad = [subjects[i].id for i in np.nonzero(~np.isfinite(ll0))[0][:5]]
        raise PharmsolError(
            f"theta0 gives non-finite likelihood for subject(s) {bad}; "
            f"adjust theta0 or the residual error models"
        )

    phi = mu0[None, :].expand(n_sub, p).clone()
    c = torch.full((n_sub,), 0.4, dtype=fd, device=dev)
    kap = torch.zeros((n_sub, k_max, q), dtype=fd, device=dev)
    ck = torch.full((n_sub,), 0.4, dtype=fd, device=dev)
    om_iov = tens(omega_iov0)
    mu = mu0
    beta = torch.zeros((n_eff,), dtype=fd, device=dev)
    om = torch.diag(tens(omega0 * omega0))
    sig_a, sig_b = tens(cond.lowered_a), tens(cond.lowered_b)
    zero_obs = torch.zeros_like(obs_value)
    s1, s2 = mu0, torch.outer(mu0, mu0) + om
    sxphi = xbar[:, None] * mu0[None, :] if n_eff else torch.zeros((0, p), dtype=fd, device=dev)
    sphi = phi
    sr2, swsr, sf2 = zero_obs, zero_obs, zero_obs
    skap2, skap = om_iov * om_iov, kap
    acc_sum = acc_n = 0.0
    ll_trace = []
    t_loop = time.perf_counter()
    for it in range(n_total):
        gamma, in_est = float(gammas[it]), it >= n_burn
        om_chol, prec = om_factors(om)
        m = prior_means(mu, beta)
        ll_i, r2, f2 = ll_parts(phi, sig_a, sig_b, kap if q else None)
        phi, kap, ll_i, r2, f2, c, ck, acc = mh_sweep(
            it, phi, kap, ll_i, r2, f2, c, ck, m, om_chol, prec, sig_a, sig_b, om_iov)
        # stochastic-approximation update of the sufficient statistics
        s1 = s1 + gamma * (phi.mean(dim=0) - s1)
        s2 = s2 + gamma * (phi.T @ phi / n_sub - s2)
        sphi = sphi + gamma * (phi - sphi)
        sr2 = sr2 + gamma * (r2 - sr2)
        swsr = swsr + gamma * (r2 / torch.clamp(f2, min=tiny) - swsr)
        sf2 = sf2 + gamma * (f2 - sf2)
        if q:
            # mean of kappa^2 over the real occasions, per IOV parameter
            k2m = torch.sum(kap * kap, dim=(0, 1)) / n_occ_total
            skap2 = skap2 + gamma * (k2m - skap2)
            skap = skap + gamma * (kap - skap)
            om_iov = torch.sqrt(torch.clamp(skap2, min=1e-8))
        # M-step: the smoothed moments give the covariance in closed form
        if n_eff:
            # joint (mu, beta) GLS: with design Z_i = [I_p, W_i] and
            # precision P, solve (mean_i Z_i' P Z_i) g = mean_i Z_i' P phi_i;
            # every block reduces to the smoothed cross-moment sxphi[k, j] =
            # mean_i x_ik phi_ij plus the constant covariate moments
            sxphi = sxphi + gamma * (x_eff.T @ phi / n_sub - sxphi)
            po = prec @ onehot_eff.T                   # [p, n_eff]
            a12 = po * xbar[None, :]
            a22 = sxx * (onehot_eff @ po)
            b2 = torch.sum((onehot_eff @ prec) * sxphi, dim=1)
            A = torch.cat([torch.cat([prec, a12], dim=1), torch.cat([a12.T, a22], dim=1)])
            rhs = torch.cat([prec @ s1, b2])
            sol = torch.linalg.solve(A + 1e-10 * eye_g, rhs)
            mu, beta = sol[:p], sol[p:]
            # E[(phi - m)(phi - m)'] by the same moments
            wb_phi = onehot_eff.T @ (beta[:, None] * sxphi)
            mwb = onehot_eff.T @ (xbar * beta)
            wbwb = onehot_eff.T @ (torch.outer(beta, beta) * sxx) @ onehot_eff
            cross = torch.outer(mu, s1) + wb_phi       # mean_i m_i phi_i'
            mm = (torch.outer(mu, mu) + torch.outer(mu, mwb)
                  + torch.outer(mwb, mu) + wbwb)
            om_full = s2 - cross - cross.T + mm
        else:
            mu = s1
            om_full = s2 - torch.outer(s1, s1)
        om_full = 0.5 * (om_full + om_full.T)
        diag_clamped = torch.clamp(torch.diag(om_full), min=1e-8)
        if full_omega:
            om = (om_full - torch.diag(torch.diag(om_full))
                  + torch.diag(diag_clamped) + 1e-10 * eye_p)
        else:
            om = torch.diag(diag_clamped)
        if est_sigma:
            sig_a, sig_b = sigma_m_step(sr2, swsr, sf2, sig_a, sig_b)
        if in_est:
            acc_sum = acc_sum + acc.mean()
            acc_n += 1.0
        ll_trace.append(ll_i.sum())

    ll_trace = torch.stack(ll_trace).cpu().numpy().astype(np.float64)
    if _introspect is not None:
        _introspect["loop_s"] = time.perf_counter() - t_loop
        for k, v in decisions.items():
            if v:
                _introspect[k] = torch.stack(v).reshape(n_total, mh_steps, n_sub).cpu().numpy()
    om_iov_np = om_iov.cpu().numpy().astype(np.float64) if q else None
    beta_np = beta.cpu().numpy().astype(np.float64) if n_eff else None
    m_final = prior_means(mu, beta)  # [n_sub, p] transformed-scale means
    mu_np = mu.cpu().numpy().astype(np.float64)
    om_np = om.cpu().numpy().astype(np.float64)
    om_sd = np.sqrt(np.diag(om_np))
    theta = np.where(is_log, np.exp(mu_np), mu_np)
    indiv = sphi.cpu().numpy().astype(np.float64)
    indiv = np.where(is_log[None, :], np.exp(indiv), indiv)
    accept = float(acc_sum) / max(acc_n, 1.0)

    marginal = None
    if ll_draws > 0:
        chol = np.linalg.cholesky(om_np)
        etas = draws["is_eta"].cpu().numpy() @ chol.T
        lls = []
        for d_i in range(ll_draws):
            # per-subject prior means shift the shared eta draw
            eta = tens(etas[d_i])
            if q:
                kap_d = ((draws["is_kap"][d_i] * om_iov[None, :])[None]
                         .expand(n_sub, k_max, q) * occ_valid[:, :, None])
                ll_d, _, _ = ll_parts(m_final + eta[None, :], sig_a, sig_b, kap_d)
            else:
                ll_d, _, _ = ll_parts(m_final + eta[None, :], sig_a, sig_b)
            lls.append(ll_d)
        lls = torch.stack(lls).cpu().numpy().astype(np.float64)  # [M, n_sub]
        mx = np.max(lls, axis=0)
        marginal = float(np.sum(np.log(np.mean(np.exp(lls - mx[None, :]), axis=0)) + mx))

    n_sig_free = 0
    if est_sigma:
        for label in residual_error_models.labels():
            kind = residual_error_models.get(label).kind
            n_sig_free += 2 if kind is ResidualKind.COMBINED else 1
    n_free = (p + n_eff + (p + p * (p - 1) // 2 if full_omega else p)
              + n_sig_free + q)

    result = SaemResult(
        theta=theta,
        omega=om_sd,
        residual_models=fitted_residual_models(equation, residual_error_models, sig_a,
                                               sig_b, est_sigma),
        individual_parameters=indiv,
        ll_trace=ll_trace,
        accept_rate=accept,
        log_likelihood=marginal,
        parameter_names=names,
        transform=transform,
        omega_cov=om_np if full_omega else None,
        beta=beta_np,
        covariate_labels=ce.labels if ce is not None else None,
        covariate_effects=ce.specs if ce is not None else None,
        n_free=n_free,
        n_obs=int(active.sum()),
        omega_iov=om_iov_np,
        iov_parameters=iov_idx if q else None,
        kappa=skap.cpu().numpy().astype(np.float64) if q else None,
    )
    if progress:
        print(result.summary())
    return result
