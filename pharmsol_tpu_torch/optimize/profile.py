"""Profile-likelihood confidence intervals (PsN ``llp``) on the Laplace fit.

Wald intervals (fit_laplace's exact-Hessian SEs) assume a locally
quadratic log-likelihood; profile-likelihood intervals drop that
assumption: the CI for psi_j is the set ``{v : 2*(LL_max - PL_j(v)) <
chi2_1(level)}`` where the profile ``PL_j(v)`` re-maximizes the Laplace
marginal over every OTHER parameter with psi_j pinned at v — the
standard remedy when a variance component or poorly-identified theta
makes the Wald interval lie (PsN's ``llp`` tool; the reference leaves
such workflows to external drivers, SURVEY §3.2).

The counterpart of the JAX package's ``optimize/profile.py``: every
(parameter, grid point) pair is an independent pinned-coordinate
re-optimization of the SAME objective — so ALL of them run as the lanes
of ONE batched L-BFGS (``optimize/_lbfgs.py::BatchLbfgs`` over the Laplace
objective's lanes), warm-started at the full optimum, with the pin
expressed as ``psi = where(mask, v, z)`` (the pinned coordinate's gradient
is exactly zero, so the optimizer leaves it in place). A 2-parameter 95%
profile with 12 grid points per side is 48 lanes of one program.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..errors import PharmsolError

__all__ = ["ProfileParameter", "ProfileResult", "llp"]


class ProfileParameter(NamedTuple):
    """Profile trace and interval for one parameter."""

    name: str                # e.g. "ke", "omega[ke]", "sigma[0]", "beta[...]"
    estimate: float          # natural scale
    lower: float             # profile CI bound (nan if not bracketed)
    upper: float
    wald_lower: float        # Wald bound from the same psi sd (nan if no SE)
    wald_upper: float
    grid: np.ndarray         # natural-scale profiled values (both sides)
    deviance: np.ndarray     # 2*(PL_max - PL(v)) aligned with grid
    ok: np.ndarray           # finite-refit flag per grid point

    @property
    def bracketed(self) -> bool:
        return bool(np.isfinite(self.lower) and np.isfinite(self.upper))


class ProfileResult(NamedTuple):
    """Profile-likelihood intervals around a Laplace fit."""

    parameters: Dict[str, ProfileParameter]
    level: float
    log_likelihood: float     # the full fit's maximum
    fit: Any                  # the underlying LaplaceResult

    def summary(self) -> str:
        lines = [
            f"Profile likelihood ({100 * self.level:.0f}% CI, "
            f"LL {self.log_likelihood:.4f})"
        ]
        for name, pp in self.parameters.items():
            flag = "" if pp.bracketed else "  <-- not bracketed"
            lines.append(
                f"  {name}: {pp.estimate:.6g} "
                f"[{pp.lower:.6g}, {pp.upper:.6g}] "
                f"(Wald [{pp.wald_lower:.6g}, {pp.wald_upper:.6g}]){flag}"
            )
        return "\n".join(lines)


def _crossing(vs: np.ndarray, dev: np.ndarray, ok: np.ndarray,
              target: float) -> float:
    """First monotone crossing of ``dev`` through ``target`` walking
    outward along ``vs`` (psi scale, already ordered from the optimum);
    linear interpolation between the bracketing grid points."""
    prev_v, prev_d = vs[0], dev[0]
    for v, d, k in zip(vs[1:], dev[1:], ok[1:]):
        if not k or not np.isfinite(d):
            return np.nan
        if d >= target:
            if d == prev_d:
                return float(v)
            t = (target - prev_d) / (d - prev_d)
            return float(prev_v + t * (v - prev_v))
        prev_v, prev_d = v, d
    return np.nan


def llp(
    equation,
    data,
    residual_error_models,
    theta0,
    *,
    parameters: Optional[Sequence[str]] = None,
    level: float = 0.95,
    n_grid: int = 12,
    max_width: float = 4.0,
    refit_iters: int = 40,
    device=None,
    **laplace_kwargs,
) -> ProfileResult:
    """Profile-likelihood CIs for a Laplace population fit.

    Fits the full model once on ``device`` (default: the card; extra
    keyword arguments go to :func:`~pharmsol_tpu_torch.optimize.fit_laplace`),
    then profiles each requested parameter over ``n_grid`` points per side
    spanning ``max_width`` Wald SDs on the internal (psi) scale,
    re-maximizing all other parameters at every point — all (parameter,
    point) refits as the lanes of one batched L-BFGS. Interval bounds interpolate the
    deviance crossing of ``chi2_1(level)``; a bound that never crosses
    inside the grid is reported ``nan`` (``bracketed`` False) — widen
    ``max_width`` for such parameters.

    ``parameters``: names to profile — typical values by model name
    (or ``p[i]``), ``omega[<name>]`` random-effect SDs, ``sigma[k]``
    residual coordinates, ``beta[<label>]`` covariate effects; default
    all typical values.
    """
    from ..config import float_dtype
    from .bootstrap import _vectorized_refits
    from .laplace import fit_laplace, laplace_hessian

    if not (0.0 < level < 1.0):
        raise PharmsolError("level must be in (0, 1)")
    if n_grid < 3:
        raise PharmsolError("n_grid must be >= 3")
    if max_width <= 0:
        raise PharmsolError("max_width must be positive")

    # the private ``_introspect`` dict receives the full fit's pieces and
    # the refits (``refits``: M, V, Z, G, F)
    intro = laplace_kwargs.pop("_introspect", None)
    intro = {} if intro is None else intro
    fit = fit_laplace(
        equation, data, residual_error_models, theta0,
        _introspect=intro, device=device, **laplace_kwargs,
    )
    neg = intro["neg_laplace"]
    neg_w_lanes = intro["neg_laplace_w_lanes"]
    lay = intro["layout"]
    z_opt = np.asarray(intro["z_opt"], dtype=np.float64)
    p = int(lay["p"])
    n_eff = int(lay["n_eff"])
    o_ld, o_off = int(lay["o_ld"]), int(lay["o_off"])
    is_log = np.asarray(lay["is_log"])
    dim = z_opt.shape[0]

    pnames = list(fit.parameter_names or (f"p[{i}]" for i in range(p)))
    # coordinate catalogue: name -> (psi index, natural-scale transform)
    catalogue: Dict[str, tuple] = {}
    for i, nm in enumerate(pnames):
        catalogue[nm] = (i, "exp" if is_log[i] else "id")
    for k in range(n_eff):
        lbl = (fit.covariate_labels[k]
               if fit.covariate_labels else f"eff{k}")
        catalogue[f"beta[{lbl}]"] = (p + k, "id")
    for i, nm in enumerate(pnames):
        catalogue[f"omega[{nm}]"] = (o_ld + i, "exp")
    o_iov = int(lay.get("o_iov", o_off + int(lay["n_off"])))
    o_sig = int(lay.get("o_sig", o_iov))
    for k, j in enumerate(lay.get("iov_idx", ())):
        catalogue[f"omega_iov[{pnames[j]}]"] = (o_iov + k, "exp")
    for k in range(dim - o_sig):
        catalogue[f"sigma[{k}]"] = (o_sig + k, "exp")

    wanted = list(parameters) if parameters is not None else list(pnames)
    for nm in wanted:
        if nm not in catalogue:
            raise PharmsolError(
                f"unknown profile parameter {nm!r} "
                f"(known: {sorted(catalogue)})"
            )

    # psi-scale SDs from the exact Hessian at the optimum (grid scaling
    # only — a singular direction falls back to a fixed step)
    fd, dev = float_dtype(), intro["psi0"].device
    z0 = torch.as_tensor(z_opt, dtype=fd, device=dev)
    H = laplace_hessian(neg, z0)
    sd = np.full(dim, 0.25)
    try:
        cov = np.linalg.inv(H)
        d = np.diag(cov)
        good = np.isfinite(d) & (d > 0)
        sd[good] = np.sqrt(d[good])
    except np.linalg.LinAlgError:
        pass

    offsets = np.linspace(max_width / n_grid, max_width, n_grid)
    masks, vals, meta = [], [], []   # meta: (name, side, rank)
    for nm in wanted:
        j, _ = catalogue[nm]
        m = np.zeros(dim)
        m[j] = 1.0
        for side in (-1.0, 1.0):
            for r, off in enumerate(offsets):
                masks.append(m)
                vals.append(z_opt[j] + side * off * sd[j])
                meta.append((nm, side, r))

    M = torch.as_tensor(np.stack(masks), dtype=fd, device=dev)
    V = torch.as_tensor(np.asarray(vals), dtype=fd, device=dev)
    ones = torch.ones((M.shape[0], int(lay["n_sub"])), dtype=fd, device=dev)

    def obj(z, mv):
        mask, v = mv
        return neg_w_lanes(torch.where(mask > 0, v[:, None], z), ones)

    Z, G, F = _vectorized_refits(obj, z0, (M, V), refit_iters,
                                 intro["lanes_value_and_grad"])
    intro["refits"] = dict(M=M.cpu().numpy(), V=V.cpu().numpy(), Z=Z, G=G, F=F)
    f_min = float(neg(z0))
    dev_all = 2.0 * (F - f_min)
    ok_all = np.isfinite(F) & np.isfinite(G)

    target = NormalDist().inv_cdf(0.5 + level / 2.0) ** 2
    out: Dict[str, ProfileParameter] = {}
    for nm in wanted:
        j, tf = catalogue[nm]
        idx = [i for i, (n, _, _) in enumerate(meta) if n == nm]
        lo_i = [i for i in idx if meta[i][1] < 0]
        hi_i = [i for i in idx if meta[i][1] > 0]
        vs = np.asarray(vals)
        # walk outward from the optimum on each side (prepend it)
        lo_v = np.concatenate([[z_opt[j]], vs[lo_i]])
        lo_d = np.concatenate([[0.0], dev_all[lo_i]])
        lo_k = np.concatenate([[True], ok_all[lo_i]])
        hi_v = np.concatenate([[z_opt[j]], vs[hi_i]])
        hi_d = np.concatenate([[0.0], dev_all[hi_i]])
        hi_k = np.concatenate([[True], ok_all[hi_i]])
        lower = _crossing(lo_v, lo_d, lo_k, target)
        upper = _crossing(hi_v, hi_d, hi_k, target)
        z_w = NormalDist().inv_cdf(0.5 + level / 2.0)
        wl, wu = z_opt[j] - z_w * sd[j], z_opt[j] + z_w * sd[j]

        def nat(v):
            return float(np.exp(v)) if tf == "exp" else float(v)

        grid_psi = np.concatenate([lo_v[::-1], hi_v[1:]])
        grid_dev = np.concatenate([lo_d[::-1], hi_d[1:]])
        grid_ok = np.concatenate([lo_k[::-1], hi_k[1:]])
        grid_nat = (np.exp(grid_psi) if tf == "exp" else grid_psi)
        out[nm] = ProfileParameter(
            name=nm,
            estimate=nat(z_opt[j]),
            lower=nat(lower) if np.isfinite(lower) else np.nan,
            upper=nat(upper) if np.isfinite(upper) else np.nan,
            wald_lower=nat(wl),
            wald_upper=nat(wu),
            grid=grid_nat,
            deviance=grid_dev,
            ok=grid_ok,
        )

    return ProfileResult(
        parameters=out,
        level=level,
        log_likelihood=float(fit.log_likelihood),
        fit=fit,
    )
