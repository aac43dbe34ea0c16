"""Simulation-based population model diagnostics: VPC, NPDE and GOF.

The reference library stops at simulation and likelihood surfaces; the
standard downstream workflow (Pmetrics / NONMEM practice) checks a fitted
population model by re-simulating the observed design and comparing the
simulated predictive distribution against the data:

- **VPC** (visual predictive check): per time bin, percentiles of the
  observed data against confidence bands of the same percentiles across
  simulated replicates.
- **NPDE** (normalized prediction distribution errors, Brendel/Mentre
  2006): per observation, the decorrelated rank of the datum within its
  simulated predictive distribution, mapped through the normal quantile
  function — under a correct model, npde ~ N(0, 1) iid.
- **GOF**: PRED, IPRED, IWRES and the FOCE-linearized CWRES per
  observation, with eta- and epsilon-shrinkage.

The counterpart of the JAX package's ``optimize/diagnostics.py``. Each
chunk of replicates re-simulates EVERY subject of every replicate in one
call on the device: the chunk's replicates are lanes of a tiled
conditional-likelihood population (``optimize/_condll.py::tile_cond_ll``),
so a 500-replicate VPC costs ~500/chunk prediction calls regardless of
population size. Accepts fits from every estimation layer: parametric
(``fit_saem`` / ``fit_laplace`` results — MVN on the transformed scale,
full covariance honored) and nonparametric (``fit_population`` — draws
support points by weight).

The draws come from a CPU ``torch.Generator`` seeded with ``seed`` and are
moved to the device (:func:`replicate_draws`), so a run on the card and on
the CPU take the same numbers; the JAX package draws from
``jax.random.PRNGKey(seed)``. The private ``_draws`` hook takes the draws
from the caller instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..config import float_dtype
from ..data.residual_error import ResidualErrorModels, residual_sigma_array
from ..errors import PharmsolError
from ._condll import build_cond_ll, tile_cond_ll

_NOT_A_POPULATION = (
    "population must be a fit result (fit_saem/fit_laplace/"
    "fit_population) or expose (support, weights) or "
    "(theta, omega, transform)"
)


class VpcResult(NamedTuple):
    """Binned visual-predictive-check summary for one output equation."""

    bin_edges: np.ndarray      # [nbin+1] time edges
    bin_times: np.ndarray      # [nbin] median observed time per bin
    n_obs: np.ndarray          # [nbin] observations per bin
    percentiles: tuple         # the summarised percentiles, e.g. (5, 50, 95)
    observed: np.ndarray       # [npct, nbin] observed percentile values
    predicted: np.ndarray      # [npct, nbin] median simulated percentile
    pi_low: np.ndarray         # [npct, nbin] lower simulated CI bound
    pi_high: np.ndarray        # [npct, nbin] upper simulated CI bound
    ci: float                  # CI mass of (pi_low, pi_high), e.g. 0.9
    outeq: int
    n_rep: int

    def coverage(self) -> float:
        """Fraction of observed percentile points inside their CI band."""
        inside = (self.observed >= self.pi_low) & (self.observed <= self.pi_high)
        return float(np.mean(inside))

    def summary(self) -> str:
        lines = [
            f"VPC (outeq {self.outeq}, {self.n_rep} replicates, "
            f"{int(self.n_obs.sum())} observations, "
            f"{100 * self.ci:.0f}% CI): coverage {self.coverage():.2f}"
        ]
        for j, pct in enumerate(self.percentiles):
            lines.append(f"  p{pct}:")
            for b in range(len(self.bin_times)):
                flag = (
                    ""
                    if self.pi_low[j, b] <= self.observed[j, b] <= self.pi_high[j, b]
                    else "  <-- outside"
                )
                lines.append(
                    f"    t={self.bin_times[b]:<8g} obs {self.observed[j, b]:.4g}"
                    f"  sim {self.predicted[j, b]:.4g}"
                    f"  [{self.pi_low[j, b]:.4g}, {self.pi_high[j, b]:.4g}]{flag}"
                )
        return "\n".join(lines)


class NpdeResult(NamedTuple):
    """Normalized prediction distribution errors for the whole dataset."""

    npde: np.ndarray            # [n_obs_total] flattened, subject-major
    subject_ids: list           # subject id per npde entry
    mean: float                 # should be ~0 under a correct model
    variance: float             # should be ~1
    z_mean: float               # mean * sqrt(N): ~N(0,1) under H0
    z_var: float                # (var-1) * sqrt(N/2): ~N(0,1) under H0
    n_rep: int

    def summary(self) -> str:
        n = len(self.npde)
        return (
            f"NPDE over {n} observations ({self.n_rep} replicates): "
            f"mean {self.mean:.4f} (z={self.z_mean:.2f}), "
            f"variance {self.variance:.4f} (z={self.z_var:.2f})"
        )


def _population_sampler(population, p: int, shift=None, device=None):
    """Return ``draw(draws, n_rep, n_sub) -> natural-scale [n_rep, n_sub,
    p]`` on ``device`` and the kind of draw it takes (``"idx"``: support
    indices [n_rep, n_sub]; ``"z"``: standard normals [n_rep, n_sub, p]).

    Duck-types the estimation-layer results: nonparametric fits carry
    (support, weights); parametric fits carry (theta, omega, transform)
    with an optional full covariance. ``shift [n_sub, p]`` adds
    per-subject transformed-scale mean offsets (covariate effects on
    typical values); parametric branch only.
    """
    fd = float_dtype()
    support = getattr(population, "support", None)
    weights = getattr(population, "weights", None)
    if support is not None and weights is not None:
        support = np.asarray(support, dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        if support.ndim != 2 or support.shape[1] != p:
            raise PharmsolError(
                f"population support has {support.shape[1] if support.ndim == 2 else '?'} "
                f"parameters; the model expects {p}"
            )
        sup = torch.as_tensor(support, dtype=fd, device=device)

        def draw(draws, n_rep, n_sub):
            return sup[draws["idx"].to(device)]

        return draw, "idx"

    theta = getattr(population, "theta", None)
    transform = getattr(population, "transform", None)
    if theta is not None and transform is not None:
        theta = np.asarray(theta, dtype=np.float64)
        if theta.shape[0] != p:
            raise PharmsolError(
                f"population theta has {theta.shape[0]} parameters; the "
                f"model expects {p}"
            )
        is_log = np.asarray([t == "log" for t in transform])
        mu = np.where(is_log, np.log(theta), theta)
        cov = getattr(population, "omega_cov", None)
        if cov is None:
            sd = np.asarray(population.omega, dtype=np.float64)
            cov = np.diag(sd * sd)
        chol = np.linalg.cholesky(np.asarray(cov, dtype=np.float64))
        mu_t = torch.as_tensor(mu, dtype=fd, device=device)
        chol_t = torch.as_tensor(chol, dtype=fd, device=device)
        is_log_t = torch.as_tensor(is_log, device=device)
        shift_t = None if shift is None else torch.as_tensor(
            np.asarray(shift, dtype=np.float64), dtype=fd, device=device)

        def draw(draws, n_rep, n_sub):
            z = draws["z"].to(device=device, dtype=fd)
            phi = mu_t[None, None, :] + z @ chol_t.T
            if shift_t is not None:
                phi = phi + shift_t[None, :, :]
            return torch.where(is_log_t[None, None, :], torch.exp(phi), phi)

        return draw, "z"

    raise PharmsolError(_NOT_A_POPULATION)


def _category_weights(population) -> np.ndarray:
    w = np.asarray(population.weights, dtype=np.float64)
    return np.maximum(w, 1e-300) / np.sum(np.maximum(w, 1e-300))


def replicate_draws(seed: int, kind: str, n_rep: int, n_sub: int, p: int, obs_shape,
                    k_max: int = 1, q: int = 0, weights=None) -> dict:
    """Every random number of a replicate simulation, from a CPU
    ``torch.Generator`` seeded with ``seed``, in float64 on the host:
    ``idx`` [n_rep, n_sub] support indices drawn by ``weights`` (``kind``
    "idx") or ``z`` [n_rep, n_sub, p] standard normals (``kind`` "z"); with
    occasion-level effects ``kap`` [n_rep, n_sub, k_max, q] standard
    normals; and ``eps`` [n_rep, R, O] standard normals for the residual
    noise."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    f64 = torch.float64
    out = {}
    if kind == "idx":
        w = torch.as_tensor(np.asarray(weights, dtype=np.float64))
        out["idx"] = torch.multinomial(w, n_rep * n_sub, replacement=True,
                                       generator=gen).reshape(n_rep, n_sub)
    else:
        out["z"] = torch.randn((n_rep, n_sub, p), generator=gen, dtype=f64)
    if q:
        out["kap"] = torch.randn((n_rep, n_sub, k_max, q), generator=gen, dtype=f64)
    out["eps"] = torch.randn((n_rep,) + tuple(obs_shape), generator=gen, dtype=f64)
    return out


def _simulate(equation, data, residual_error_models, population, n_rep,
              seed, include_residual, rep_chunk, device=None, _draws=None):
    """Simulate the observed design under the fitted population, on
    ``device`` (default: the card).

    Returns (cond, sims [n_rep, R, O] float64 numpy). ``_draws`` replaces
    :func:`replicate_draws`' numbers (the same keys and shapes).
    """
    cond = build_cond_ll(equation, data, residual_error_models, device=device)
    dev, fd = cond.device, float_dtype()
    theta = getattr(population, "theta", None)
    support = getattr(population, "support", None)
    if theta is not None:
        nparams = int(np.asarray(theta).shape[0])
    elif support is not None:
        nparams = int(np.asarray(support).shape[1])
    else:
        raise PharmsolError(_NOT_A_POPULATION)
    # covariate effects on typical values: replicate subjects keep their
    # OWN baseline covariates, so the sampler centers each subject at
    # mu + W_i beta on the transformed scale (same design the fitters use)
    beta = getattr(population, "beta", None)
    shift = None
    if beta is not None and np.any(np.asarray(beta) != 0.0):
        specs = getattr(population, "covariate_effects", None)
        if not specs:
            raise PharmsolError(
                "population carries nonzero beta but no covariate_effects "
                "specs — cannot reconstruct the per-subject design"
            )
        from ._coveffects import resolve_covariate_effects

        ce = resolve_covariate_effects(specs, cond.subjects, nparams, None)
        shift = (ce.x * np.asarray(beta, dtype=np.float64)[None, :]) @ ce.onehot
    draw, kind = _population_sampler(population, nparams, shift=shift, device=dev)

    # occasion-level (IOV) effects: draw kappa ~ N(0, omega_iov^2) per
    # replicate x subject x occasion and apply it on the TRANSFORMED
    # scale per occasion row (exp-multiplicative on log parameters,
    # additive on identity ones) — exactly how the fitters model it
    om_iov = getattr(population, "omega_iov", None)
    q = 0
    k_max = 1
    if om_iov is not None:
        iov_idx = getattr(population, "iov_parameters", None)
        if not iov_idx:
            raise PharmsolError(
                "population carries omega_iov but no iov_parameters — "
                "cannot reconstruct the occasion-level effects"
            )
        transform = getattr(population, "transform", None)
        if transform is None:
            raise PharmsolError(
                "IOV replicate simulation needs the fit's transform"
            )
        q = len(iov_idx)
        k_max = int(cond.n_occ_max)
        om_iov = np.asarray(om_iov, dtype=np.float64)

    n_sub = cond.n_sub
    obs_shape = tuple(cond.obs_value.shape)
    draws = _draws if _draws is not None else replicate_draws(
        seed, kind, n_rep, n_sub, nparams, obs_shape, k_max, q,
        _category_weights(population) if kind == "idx" else None)
    thetas = draw(draws, n_rep, n_sub)  # [n_rep, n_sub, p]

    chunk = int(min(max(rep_chunk, 1), n_rep))
    tiled = tile_cond_ll(cond, chunk)
    kinds_t = torch.as_tensor(cond.kinds_np.astype(np.int64), device=dev)
    oe = tiled.obs_outeq
    kind_per_obs = kinds_t[oe]
    sig_a = torch.as_tensor(cond.lowered_a, dtype=fd, device=dev)[oe]
    sig_b = torch.as_tensor(cond.lowered_b, dtype=fd, device=dev)[oe]
    if q:
        onehot_iov = torch.as_tensor(np.eye(nparams)[list(iov_idx)], dtype=fd, device=dev)
        is_log_row = torch.as_tensor(np.asarray([t == "log" for t in transform]),
                                     device=dev)[None, :]
        om_iov_t = torch.as_tensor(om_iov, dtype=fd, device=dev)
        row_sub, row_occ = tiled.row_subject, tiled.row_occasion

    def pad(a, n):
        """The ``n`` replicates of ``a`` repeated to fill a whole chunk (one
        tiled population for every chunk; the copies are dropped)."""
        return a[torch.arange(chunk, device=a.device) % n] if n < chunk else a

    out = []
    with torch.no_grad():
        for start in range(0, n_rep, chunk):
            stop = min(start + chunk, n_rep)
            n = stop - start
            tc = pad(thetas[start:stop], n).reshape(chunk * n_sub, nparams)
            if q:
                kap = pad(draws["kap"][start:stop].to(device=dev, dtype=fd), n)
                kap = kap.reshape(chunk * n_sub, k_max, q) * om_iov_t[None, None, :]
                adj = kap[row_sub, row_occ] @ onehot_iov  # [chunk * R, p]
                rows = tc[row_sub]
                rows = torch.where(is_log_row, rows * torch.exp(adj), rows + adj)
                f = tiled.pred_rows_at(rows)
            else:
                f = tiled.pred_rows(tc)
            if include_residual:
                sigma = residual_sigma_array(kind_per_obs, sig_a, sig_b, f)
                eps = pad(draws["eps"][start:stop].to(device=dev, dtype=f.dtype), n)
                f = f + sigma * eps.reshape(f.shape)
            sims = f.reshape((chunk,) + obs_shape)[:n]
            out.append(sims.cpu().numpy().astype(np.float64))
    return cond, np.concatenate(out, axis=0)


def vpc(
    equation,
    data,
    residual_error_models: ResidualErrorModels,
    population,
    *,
    n_rep: int = 500,
    percentiles: Sequence[float] = (5.0, 50.0, 95.0),
    bins: Union[int, Sequence[float]] = 8,
    ci: float = 0.9,
    outeq: int = 0,
    seed: int = 0,
    rep_chunk: int = 64,
    device=None,
    _draws: Optional[dict] = None,
) -> VpcResult:
    """Visual predictive check for one output equation.

    ``population`` is any estimation-layer result. ``bins`` is a bin
    count (quantile edges over observed times; collapses to one bin per
    unique time when there are few) or explicit edge array. Observed
    percentiles are compared against the ``ci`` band of the same
    percentile across ``n_rep`` simulated replicates of the SAME design
    (doses, observation times, covariates). Runs on ``device`` (default:
    the card); ``_draws`` replaces the seeded draws (see ``_simulate``).
    """
    if n_rep < 20:
        raise PharmsolError("vpc needs n_rep >= 20")
    if not 0.0 < ci < 1.0:
        raise PharmsolError("ci must be in (0, 1)")
    cond, sims = _simulate(
        equation, data, residual_error_models, population, n_rep, seed,
        True, rep_chunk, device, _draws,
    )
    mask = cond.active.cpu().numpy() & (cond.obs_outeq.cpu().numpy() == outeq)
    if not mask.any():
        raise PharmsolError(f"no observations on outeq {outeq}")
    t = cond.obs_time.cpu().numpy().astype(np.float64)[mask]
    y = cond.obs_value.cpu().numpy().astype(np.float64)[mask]
    s = sims[:, mask]  # [n_rep, M]

    uniq = np.unique(t)
    if np.isscalar(bins) or isinstance(bins, (int, np.integer)):
        nbin = int(bins)
        if len(uniq) <= nbin:
            mids = uniq
            edges = np.concatenate(
                [[uniq[0] - 0.5], (uniq[:-1] + uniq[1:]) / 2.0,
                 [uniq[-1] + 0.5]]
            )
        else:
            qs = np.linspace(0.0, 100.0, nbin + 1)
            edges = np.unique(np.percentile(t, qs))
            edges[0] -= 1e-9
            edges[-1] += 1e-9
    else:
        edges = np.asarray(bins, dtype=np.float64)
        if edges.ndim != 1 or len(edges) < 2:
            raise PharmsolError("explicit bins must be a 1-D edge array")
    nbin = len(edges) - 1
    which = np.clip(np.searchsorted(edges, t, side="right") - 1, 0, nbin - 1)

    pct = tuple(float(q) for q in percentiles)
    npct = len(pct)
    observed = np.full((npct, nbin), np.nan)
    predicted = np.full((npct, nbin), np.nan)
    pi_low = np.full((npct, nbin), np.nan)
    pi_high = np.full((npct, nbin), np.nan)
    bin_times = np.full(nbin, np.nan)
    n_obs = np.zeros(nbin, dtype=np.int64)
    alpha = (1.0 - ci) / 2.0
    for b in range(nbin):
        sel = which == b
        n_obs[b] = int(sel.sum())
        if not n_obs[b]:
            continue
        bin_times[b] = float(np.median(t[sel]))
        observed[:, b] = np.percentile(y[sel], pct)
        sim_pct = np.percentile(s[:, sel], pct, axis=1)  # [npct, n_rep]
        predicted[:, b] = np.median(sim_pct, axis=1)
        pi_low[:, b] = np.quantile(sim_pct, alpha, axis=1)
        pi_high[:, b] = np.quantile(sim_pct, 1.0 - alpha, axis=1)

    keep = n_obs > 0
    return VpcResult(
        bin_edges=edges,
        bin_times=bin_times[keep],
        n_obs=n_obs[keep],
        percentiles=pct,
        observed=observed[:, keep],
        predicted=predicted[:, keep],
        pi_low=pi_low[:, keep],
        pi_high=pi_high[:, keep],
        ci=float(ci),
        outeq=int(outeq),
        n_rep=int(n_rep),
    )


def npde(
    equation,
    data,
    residual_error_models: ResidualErrorModels,
    population,
    *,
    n_rep: int = 1000,
    seed: int = 0,
    rep_chunk: int = 64,
    device=None,
    _draws: Optional[dict] = None,
) -> NpdeResult:
    """Normalized prediction distribution errors (Brendel/Mentre 2006).

    Per subject: decorrelate the observation vector with the empirical
    mean/covariance of its simulated replicates, rank each decorrelated
    datum within the (equally decorrelated) replicates, and map through
    the normal quantile. Under a correct model the pooled npde are
    iid N(0, 1); ``z_mean``/``z_var`` are the standard moment tests.
    Runs on ``device`` (default: the card); ``_draws`` replaces the seeded
    draws (see ``_simulate``).
    """
    from scipy.special import ndtri

    if n_rep < 100:
        raise PharmsolError("npde needs n_rep >= 100")
    cond, sims = _simulate(
        equation, data, residual_error_models, population, n_rep, seed,
        True, rep_chunk, device, _draws,
    )
    active = cond.active.cpu().numpy()
    row_subject = cond.row_subject.cpu().numpy()
    y_all = cond.obs_value.cpu().numpy().astype(np.float64)

    values = []
    ids = []
    for i, subject in enumerate(cond.subjects):
        m = active & (row_subject[:, None] == i)
        k = int(m.sum())
        if k == 0:
            continue
        y = y_all[m]                       # [k]
        s = sims[:, m]                     # [n_rep, k]
        mean = s.mean(axis=0)
        centered = s - mean[None, :]
        cov = centered.T @ centered / (n_rep - 1)
        cov[np.diag_indices_from(cov)] += 1e-10 * max(1.0, np.trace(cov) / k)
        L = np.linalg.cholesky(cov)
        ystar = _tri_solve(L, y - mean)
        sstar = _tri_solve(L, centered.T)  # [k, n_rep]
        pde = (np.sum(sstar < ystar[:, None], axis=1) + 0.5) / n_rep
        pde = np.clip(pde, 1.0 / (2 * n_rep), 1.0 - 1.0 / (2 * n_rep))
        values.append(ndtri(pde))
        ids.extend([subject.id] * k)

    flat = np.concatenate(values) if values else np.asarray([])
    n = len(flat)
    mean = float(np.mean(flat)) if n else float("nan")
    var = float(np.var(flat, ddof=1)) if n > 1 else float("nan")
    return NpdeResult(
        npde=flat,
        subject_ids=ids,
        mean=mean,
        variance=var,
        z_mean=mean * np.sqrt(n) if n else float("nan"),
        z_var=(var - 1.0) * np.sqrt(n / 2.0) if n > 1 else float("nan"),
        n_rep=int(n_rep),
    )


def _tri_solve(L, b):
    """Forward substitution for lower-triangular L."""
    from scipy.linalg import solve_triangular

    return solve_triangular(L, b, lower=True)


class GofResult(NamedTuple):
    """Goodness-of-fit table: one row per active observation.

    ``pred`` is the population prediction (random effects at zero, any
    fitted covariate effects applied); ``ipred`` the individual
    prediction; ``iwres`` the individual weighted residual
    ``(y - ipred) / sigma(ipred)``; ``cwres`` the FOCE-linearized
    conditional weighted residual (Hooker/Staatz/Karlsson 2007): per
    subject, decorrelate ``y - (F(eta_hat) - G eta_hat)`` with
    ``V = G Omega G' + diag(sigma^2)`` where ``G = dF/deta`` at the
    conditional estimate. Under a correct model cwres ~ N(0, 1).
    """

    subject_ids: tuple           # [n_sub] ids in data order
    obs_subject: np.ndarray      # [N] subject index per observation
    time: np.ndarray             # [N]
    outeq: np.ndarray            # [N]
    observed: np.ndarray         # [N]
    pred: np.ndarray             # [N]
    ipred: np.ndarray            # [N]
    iwres: np.ndarray            # [N]
    cwres: np.ndarray            # [N]
    eta: np.ndarray              # [n_sub, p] transformed-scale deviations
    eta_shrinkage: np.ndarray    # [p] 1 - sd(eta_j)/omega_j
    epsilon_shrinkage: float     # 1 - sd(iwres)
    parameter_names: Optional[tuple]

    def summary(self) -> str:
        names = self.parameter_names or tuple(
            f"p[{j}]" for j in range(self.eta.shape[1])
        )
        n = len(self.observed)
        lines = [
            f"GOF: {n} observations, {self.eta.shape[0]} subjects; "
            f"cwres mean {np.mean(self.cwres):.3f} "
            f"var {np.var(self.cwres, ddof=1):.3f}, "
            f"iwres sd {np.std(self.iwres, ddof=1):.3f}"
        ]
        for j, nm in enumerate(names):
            lines.append(
                f"  eta-shrinkage {nm}: {100 * self.eta_shrinkage[j]:.1f}%"
            )
        lines.append(
            f"  epsilon-shrinkage: {100 * self.epsilon_shrinkage:.1f}%"
        )
        return "\n".join(lines)


def gof(
    equation,
    data,
    residual_error_models: ResidualErrorModels,
    population,
    *,
    parameter_names=None,
    device=None,
) -> GofResult:
    """Goodness-of-fit diagnostics for a fitted population model, with the
    predictions and their derivatives on ``device`` (default: the card).

    ``population`` is any estimation-layer result. Parametric fits
    (``fit_saem`` / ``fit_laplace``) use their MVN random-effect model
    exactly — transformed scale, full ``omega_cov`` and fitted
    ``covariate_effects`` honored. Nonparametric fits
    (``fit_population``) are moment-matched on the natural scale (mu /
    Omega = weighted mean / covariance of the support; individual
    parameters = posterior means) — cwres is then a normal
    approximation to a discrete mixture, fine for residual screening.
    Fitted residual sigmas on the result (``residual_models``) take
    precedence over ``residual_error_models``.
    """
    rems = getattr(population, "residual_models", None) or residual_error_models
    cond = build_cond_ll(equation, data, rems, device=device)
    dev = cond.device
    n_sub = cond.n_sub

    theta = getattr(population, "theta", None)
    support = getattr(population, "support", None)
    if theta is not None and getattr(population, "transform", None) is not None:
        theta = np.asarray(theta, dtype=np.float64)
        p = theta.shape[0]
        transform = population.transform
        is_log = np.asarray([t == "log" for t in transform])
        mu = np.where(is_log, np.log(theta), theta)
        omega_cov = getattr(population, "omega_cov", None)
        if omega_cov is None:
            sd = np.asarray(population.omega, dtype=np.float64)
            omega_cov = np.diag(sd * sd)
        omega_cov = np.asarray(omega_cov, dtype=np.float64)
        m = np.broadcast_to(mu[None, :], (n_sub, p)).copy()
        beta = getattr(population, "beta", None)
        specs = getattr(population, "covariate_effects", None)
        if beta is not None and specs:
            from ._coveffects import resolve_covariate_effects

            ce = resolve_covariate_effects(specs, cond.subjects, p, None)
            m += (ce.x * np.asarray(beta)[None, :]) @ ce.onehot
        indiv = np.asarray(population.individual_parameters, dtype=np.float64)
        phi_hat = np.where(is_log[None, :], np.log(indiv), indiv)
        if parameter_names is None:
            parameter_names = getattr(population, "parameter_names", None)
    elif support is not None:
        support = np.asarray(support, dtype=np.float64)
        w = np.asarray(population.weights, dtype=np.float64)
        w = w / w.sum()
        p = support.shape[1]
        is_log = np.zeros(p, dtype=bool)  # natural scale throughout
        mu = w @ support
        d = support - mu[None, :]
        omega_cov = (d * w[:, None]).T @ d
        omega_cov[np.diag_indices_from(omega_cov)] += 1e-12
        m = np.broadcast_to(mu[None, :], (n_sub, p)).copy()
        phi_hat = np.asarray(
            population.individual_posterior_means(), dtype=np.float64
        )
    else:
        raise PharmsolError(
            "population must be a fit result (fit_saem/fit_laplace/"
            "fit_population) with individual parameter estimates"
        )

    fd = float_dtype()
    is_log_t = torch.as_tensor(is_log, device=dev)

    def pred_phi(phi_rows):
        nat = torch.where(is_log_t[None, :], torch.exp(phi_rows), phi_rows)
        return cond.pred_rows(nat)

    # G = dF/dphi column by column: a forward derivative of the
    # predictions along each parameter axis of every subject at once (each
    # grid row reads its own subject's row), by the double-backward
    # product of the reverse-mode graph
    phi_t = torch.as_tensor(phi_hat, dtype=fd, device=dev)
    with torch.enable_grad():
        x = phi_t.clone().requires_grad_(True)
        f = pred_phi(x)
        probe = torch.zeros_like(f, requires_grad=True)
        (vjp,) = torch.autograd.grad(f, x, grad_outputs=probe, create_graph=True)
        basis = torch.eye(p, dtype=fd, device=dev)[:, None, :].expand(p, n_sub, p)
        (cols,) = torch.autograd.grad(vjp, probe, grad_outputs=basis, is_grads_batched=True)
    G = np.moveaxis(cols.detach().cpu().numpy().astype(np.float64), 0, -1)  # [R, O, p]
    ipred_all = f.detach().cpu().numpy().astype(np.float64)             # [R, O]
    with torch.no_grad():
        pred_all = pred_phi(torch.as_tensor(m, dtype=fd, device=dev)).cpu().numpy().astype(
            np.float64)

    # residual sigma at the individual predictions (FOCEI interaction)
    lowered = rems.lower(equation.resolve_output_label, equation.nouteqs())
    oe = cond.obs_outeq
    kind_per_obs = torch.as_tensor(np.asarray(lowered.kind).astype(np.int64), device=dev)[oe]
    sig_a = torch.as_tensor(np.asarray(lowered.a), dtype=fd, device=dev)[oe]
    sig_b = torch.as_tensor(np.asarray(lowered.b), dtype=fd, device=dev)[oe]
    sigma_all = residual_sigma_array(
        kind_per_obs, sig_a, sig_b, torch.as_tensor(ipred_all, dtype=fd, device=dev)
    ).cpu().numpy().astype(np.float64)

    active = cond.active.cpu().numpy()
    row_subject = cond.row_subject.cpu().numpy()
    y_all = cond.obs_value.cpu().numpy().astype(np.float64)
    t_all = cond.obs_time.cpu().numpy().astype(np.float64)
    oe_all = oe.cpu().numpy()
    eta = phi_hat - m

    obs_sub, times, outeqs = [], [], []
    obs, preds, ipreds, iwres, cwres = [], [], [], [], []
    for i in range(n_sub):
        msk = active & (row_subject[:, None] == i)
        k = int(msk.sum())
        if k == 0:
            continue
        y = y_all[msk]
        f_i = ipred_all[msk]
        sig = np.maximum(sigma_all[msk], 1e-12)
        g_i = G[msk]                                  # [k, p]
        e_i = f_i - g_i @ eta[i]                      # FOCE population mean
        V = g_i @ omega_cov @ g_i.T + np.diag(sig * sig)
        V[np.diag_indices_from(V)] += 1e-10 * max(1.0, np.trace(V) / k)
        L = np.linalg.cholesky(V)
        cwres.append(_tri_solve(L, y - e_i))
        obs_sub.append(np.full(k, i))
        times.append(t_all[msk])
        outeqs.append(oe_all[msk])
        obs.append(y)
        preds.append(pred_all[msk])
        ipreds.append(f_i)
        iwres.append((y - f_i) / sig)

    iwres_flat = np.concatenate(iwres)
    eta_sd = np.std(eta, axis=0, ddof=1)
    om_sd = np.sqrt(np.maximum(np.diag(omega_cov), 1e-300))
    return GofResult(
        subject_ids=tuple(s.id for s in cond.subjects),
        obs_subject=np.concatenate(obs_sub),
        time=np.concatenate(times),
        outeq=np.concatenate(outeqs),
        observed=np.concatenate(obs),
        pred=np.concatenate(preds),
        ipred=np.concatenate(ipreds),
        iwres=iwres_flat,
        cwres=np.concatenate(cwres),
        eta=eta,
        eta_shrinkage=1.0 - eta_sd / om_sd,
        epsilon_shrinkage=float(1.0 - np.std(iwres_flat, ddof=1)),
        parameter_names=parameter_names,
    )
