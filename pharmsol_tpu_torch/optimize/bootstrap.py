"""Case-resampling bootstrap for population-fit uncertainty.

The reference exposes the likelihood consumables and leaves the
population loop — and with it all uncertainty quantification — to
external drivers (SURVEY §3.2; optimize/parameters.rs:19-120 is the
only in-crate optimizer). This module closes the workflow the way
PsN's ``bootstrap`` tool does for NONMEM: resample SUBJECTS with
replacement (the exchangeable unit of a mixed-effects analysis), refit
every replicate with the user's fitter, and summarize the replicate
estimates into standard errors and percentile confidence intervals.

Replicate datasets reuse the ORIGINAL :class:`Subject` objects, so the
per-subject lowering/likelihood caches (keyed on the subject hash,
cache.rs:29-38 semantics) hit across replicates — a duplicated subject
costs nothing extra to lower.

The counterpart of the JAX package's ``optimize/bootstrap.py``. Where the
JAX package refits every replicate of :func:`bootstrap_laplace` as one
``jax.vmap`` of an optax L-BFGS scan, the port runs the lanes of
``optimize/_lbfgs.py::BatchLbfgs`` over the Laplace objective with the
replicate axis folded into the subject axis (``optimize/laplace.py``'s
``neg_laplace_*_lanes``): one objective evaluation computes every
replicate's subjects on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.structs import Data
from ..errors import PharmsolError

__all__ = ["BootstrapResult", "bootstrap", "bootstrap_laplace"]


def _default_extract(result: Any) -> Dict[str, np.ndarray]:
    """Pull the headline estimates out of any framework fit result.

    Handles :class:`LaplaceResult` / :class:`SaemResult` (theta, omega,
    optional beta), :class:`PopulationResult` (moment summaries of the
    discrete distribution), and :class:`MapResult` (theta) — plus any
    object exposing a ``theta`` attribute.
    """
    out: Dict[str, np.ndarray] = {}
    if hasattr(result, "support") and hasattr(result, "weights"):
        out["theta"] = np.asarray(result.population_mean(), dtype=np.float64)
        cov = np.asarray(result.population_covariance(), dtype=np.float64)
        out["omega"] = np.sqrt(np.maximum(np.diag(cov), 0.0))
        return out
    theta = getattr(result, "theta", None)
    if theta is None:
        # MapResult exposes the fitted vector as `parameters`
        theta = getattr(result, "parameters", None)
    if theta is None:
        raise PharmsolError(
            "cannot extract estimates from the fit result — pass "
            "extract=lambda result: {'name': value, ...}"
        )
    out["theta"] = np.asarray(theta, dtype=np.float64)
    omega = getattr(result, "omega", None)
    if omega is not None:
        out["omega"] = np.asarray(omega, dtype=np.float64)
    beta = getattr(result, "beta", None)
    if beta is not None:
        out["beta"] = np.asarray(beta, dtype=np.float64)
    return out


class BootstrapResult(NamedTuple):
    """Replicate estimates from a case-resampling bootstrap."""

    samples: Dict[str, np.ndarray]   # name -> [n_ok, ...] replicate values
    estimate: Optional[Dict[str, np.ndarray]]  # full-data fit (or None)
    n_requested: int
    n_failed: int
    alpha: float
    parameter_names: Optional[tuple]
    full: Optional[Any] = None       # the full-data fitter result object

    @property
    def n_ok(self) -> int:
        first = next(iter(self.samples.values()))
        return int(first.shape[0])

    def se(self) -> Dict[str, np.ndarray]:
        """Bootstrap standard errors (replicate SD, ddof=1) per quantity."""
        return {
            k: np.std(v, axis=0, ddof=1) for k, v in self.samples.items()
        }

    def ci(self, alpha: Optional[float] = None
           ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Percentile confidence intervals per quantity."""
        a = self.alpha if alpha is None else float(alpha)
        if not 0.0 < a < 1.0:
            raise PharmsolError("alpha must be in (0, 1)")
        return {
            k: (
                np.quantile(v, a / 2.0, axis=0),
                np.quantile(v, 1.0 - a / 2.0, axis=0),
            )
            for k, v in self.samples.items()
        }

    def bias(self) -> Optional[Dict[str, np.ndarray]]:
        """Mean(replicates) - full-data estimate (None without a full fit)."""
        if self.estimate is None:
            return None
        return {
            k: np.mean(v, axis=0) - self.estimate[k]
            for k, v in self.samples.items()
            if k in self.estimate
        }

    def summary(self) -> str:
        lines = [
            f"bootstrap: {self.n_ok}/{self.n_requested} replicates "
            f"({self.n_failed} failed), {100 * (1 - self.alpha):.0f}% "
            f"percentile CIs"
        ]
        se = self.se()
        ci = self.ci()
        for key, vals in self.samples.items():
            flat = vals.reshape(vals.shape[0], -1)
            names = None
            if key == "theta" and self.parameter_names is not None and \
                    len(self.parameter_names) == flat.shape[1]:
                names = self.parameter_names
            lo, hi = (c.reshape(-1) for c in ci[key])
            s = se[key].reshape(-1)
            est = None
            if self.estimate is not None and key in self.estimate:
                est = self.estimate[key].reshape(-1)
            for j in range(flat.shape[1]):
                label = f"{key}[{names[j]}]" if names else f"{key}[{j}]"
                head = (f"{est[j]:.6g}" if est is not None
                        else f"{np.mean(flat[:, j]):.6g}")
                lines.append(
                    f"  {label}: {head} +- {s[j]:.4g} "
                    f"({lo[j]:.6g}, {hi[j]:.6g})"
                )
        return "\n".join(lines)


def bootstrap(
    data: Data,
    fit: Callable[[Data], Any],
    *,
    n_boot: int = 200,
    seed: int = 0,
    alpha: float = 0.05,
    extract: Optional[Callable[[Any], Dict[str, np.ndarray]]] = None,
    stratify: Optional[Callable[[Any], Any]] = None,
    include_full: bool = True,
    on_error: str = "skip",
) -> BootstrapResult:
    """Case (subject-resampling) bootstrap around any fitter.

    ``fit`` is a closure ``Data -> result`` wrapping one of the
    framework fitters (``fit_laplace``, ``fit_saem``,
    ``fit_population``, ``fit_map``) or anything else whose result
    ``extract`` can read. ``stratify`` maps a Subject to a stratum key;
    resampling then happens within each stratum, preserving the stratum
    sizes (PsN ``-stratify_on`` semantics — keeps e.g. dose-group
    proportions fixed across replicates). ``on_error='skip'`` drops
    replicates whose refit raises (counted in ``n_failed``);
    ``'raise'`` propagates the first failure.
    """
    if n_boot < 2:
        raise PharmsolError("n_boot must be >= 2")
    if on_error not in ("skip", "raise"):
        raise PharmsolError("on_error must be 'skip' or 'raise'")
    subjects = list(data.subjects())
    n = len(subjects)
    if n < 2:
        raise PharmsolError("bootstrap needs at least 2 subjects")
    pull = extract or _default_extract
    rng = np.random.default_rng(seed)

    if stratify is not None:
        strata: Dict[Any, list] = {}
        for i, s in enumerate(subjects):
            strata.setdefault(stratify(s), []).append(i)
        if any(len(v) < 1 for v in strata.values()):
            raise PharmsolError("every stratum needs at least one subject")

        def draw() -> np.ndarray:
            idx = []
            for members in strata.values():
                members = np.asarray(members)
                idx.append(rng.choice(members, size=len(members),
                                      replace=True))
            return np.concatenate(idx)
    else:
        def draw() -> np.ndarray:
            return rng.integers(0, n, size=n)

    estimate = None
    full = None
    parameter_names = None
    if include_full:
        full = fit(data)
        estimate = pull(full)
        parameter_names = getattr(full, "parameter_names", None)

    collected: list = []
    n_failed = 0
    for _ in range(n_boot):
        idx = draw()
        rep = Data([subjects[i] for i in np.sort(idx)])
        try:
            res = fit(rep)
        except Exception:
            if on_error == "raise":
                raise
            n_failed += 1
            continue
        vals = pull(res)
        if parameter_names is None:
            parameter_names = getattr(res, "parameter_names", None)
        collected.append(vals)
    if len(collected) < 2:
        raise PharmsolError(
            f"bootstrap collapsed: {n_failed}/{n_boot} replicate refits "
            "failed — loosen the fitter settings or fix the model"
        )
    keys = list(collected[0].keys())
    samples = {
        k: np.stack([c[k] for c in collected], axis=0) for k in keys
    }
    return BootstrapResult(
        samples=samples,
        estimate=estimate,
        n_requested=n_boot,
        n_failed=n_failed,
        alpha=float(alpha),
        parameter_names=tuple(parameter_names) if parameter_names else None,
        full=full,
    )


def _lanes_of(batched) -> int:
    first = batched[0] if isinstance(batched, (tuple, list)) else batched
    return int(first.shape[0])


def _vectorized_refits(obj_of, z0, batched, refit_iters: int, value_and_grad=None):
    """All replicate refits as ONE batched L-BFGS over every lane at once.

    ``obj_of(Z [B, dim], batched) -> [B]`` is the replicates' objective,
    every lane at once with no operation mixing lanes (the JAX package's
    ``obj_of(z, arg)`` is one lane's, under ``jax.vmap``); ``batched``
    stacks each replicate's operand on axis 0 (frequency weights for the
    case bootstrap, simulated observation arrays for SSE, covariate designs
    for stepwise covariate search) and may be a tuple of such tensors.
    Warm-started at ``z0`` — one shared ``[dim]`` vector or per-replicate
    ``[B, dim]`` starts; a fixed step count, as in the JAX program. Every
    lane takes the iterates the JAX package's ``vmap(lax.scan(L-BFGS
    step))`` takes for it (``optimize/_lbfgs.py::BatchLbfgs``). Returns
    numpy ``(Z [B, dim], G [B], F [B])`` with G the final inf-norm
    gradient and F the final objective value per replicate.
    ``value_and_grad`` builds the lanes' value and gradient from a function
    of ``Z`` (``_lbfgs.batch_value_and_grad_fn`` when None; the Laplace
    objective's ``_introspect["lanes_value_and_grad"]``, which replays a
    closed form's evaluations from a CUDA graph on the card).
    """
    from ._lbfgs import BatchLbfgs, batch_value_and_grad_fn

    B = _lanes_of(batched)
    z0 = torch.as_tensor(z0)
    z = z0.expand(B, z0.shape[-1]).clone() if z0.dim() == 1 else z0.clone()
    vg = (value_and_grad or batch_value_and_grad_fn)(lambda Z: obj_of(Z, batched))
    opt = BatchLbfgs()
    state = opt.init(z)
    for _ in range(refit_iters):
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
    F, G = vg(z)
    return (z.detach().cpu().numpy().astype(np.float64),
            G.abs().max(dim=-1).values.cpu().numpy().astype(np.float64),
            F.cpu().numpy().astype(np.float64))


def _decode_psi_samples(Zk, lay) -> Dict[str, np.ndarray]:
    """Decode stacked Laplace psi vectors into named natural-scale samples."""
    p = int(lay["p"])
    n_eff = int(lay["n_eff"])
    o_ld, o_off = int(lay["o_ld"]), int(lay["o_off"])
    is_log = np.asarray(lay["is_log"])
    full_omega = bool(lay["full_omega"])
    tril_r, tril_c = lay["tril"]
    mu = Zk[:, :p]
    samples: Dict[str, np.ndarray] = {
        "theta": np.where(is_log[None, :], np.exp(mu), mu)
    }
    ld = Zk[:, o_ld:o_ld + p]
    if full_omega:
        B = Zk.shape[0]
        om_sd = np.empty((B, p))
        for i in range(B):
            L = np.diag(np.exp(ld[i]))
            L[tril_r, tril_c] = Zk[i, o_ld + p:o_off]
            om_sd[i] = np.sqrt(np.diag(L @ L.T))
        samples["omega"] = om_sd
    else:
        samples["omega"] = np.exp(ld)
    if n_eff:
        samples["beta"] = Zk[:, p:p + n_eff]
    return samples


def bootstrap_laplace(
    equation,
    data: Data,
    residual_error_models,
    theta0,
    *,
    n_boot: int = 200,
    seed: int = 0,
    alpha: float = 0.05,
    refit_iters: int = 40,
    device=None,
    **laplace_kwargs,
) -> BootstrapResult:
    """Device-vectorized case bootstrap around :func:`fit_laplace`, on
    ``device`` (default: the card).

    A case-bootstrap replicate's likelihood is the original likelihood
    with integer per-subject frequency weights (a subject drawn k times
    contributes k times), so no replicate needs its own Data: this fits
    the full data once, then refits EVERY replicate at once, the lanes of
    one batched L-BFGS over the weighted Laplace objective
    (``neg_laplace_w_lanes``: every replicate's subjects in one
    evaluation), warm-started at the full-data optimum.

    ``refit_iters`` fixed L-BFGS steps per replicate (no early stop, as in
    the JAX package's fixed-length program; warm-starting makes modest
    counts sufficient). Replicates whose refit goes non-finite are dropped
    and counted in ``n_failed``. The weight draws are numpy's
    ``default_rng(seed)``, the JAX package's own. Extra keyword arguments
    go to :func:`fit_laplace` for the full-data fit (and define the
    objective every replicate shares: omega structure, covariate effects,
    est_sigma, transform).
    """
    from ..config import float_dtype
    from .laplace import fit_laplace

    if n_boot < 2:
        raise PharmsolError("n_boot must be >= 2")
    if refit_iters < 1:
        raise PharmsolError("refit_iters must be >= 1")
    # the private ``_introspect`` dict receives the full fit's pieces and
    # the refits (``refits``: W, Z, G, F)
    intro = laplace_kwargs.pop("_introspect", None)
    intro = {} if intro is None else intro
    full = fit_laplace(
        equation, data, residual_error_models, theta0,
        _introspect=intro, device=device, **laplace_kwargs,
    )
    neg_w = intro["neg_laplace_w_lanes"]
    lay = intro["layout"]
    n = int(lay["n_sub"])

    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n, size=(n_boot, n))
    W = np.stack(
        [np.bincount(row, minlength=n) for row in draws]
    ).astype(np.float64)

    fd, dev = float_dtype(), intro["psi0"].device
    z0 = torch.as_tensor(intro["z_opt"], dtype=fd, device=dev)
    Z, G, F = _vectorized_refits(
        neg_w, z0, torch.as_tensor(W, dtype=fd, device=dev), refit_iters,
        intro["lanes_value_and_grad"],
    )
    intro["refits"] = dict(W=W, Z=Z, G=G, F=F)
    ok = np.isfinite(Z).all(axis=1) & np.isfinite(G)
    if int(ok.sum()) < 2:
        raise PharmsolError(
            f"bootstrap collapsed: {n_boot - int(ok.sum())}/{n_boot} "
            "vectorized refits went non-finite — raise refit_iters or "
            "check the model"
        )
    samples: Dict[str, np.ndarray] = _decode_psi_samples(Z[ok], lay)

    estimate = {"theta": np.asarray(full.theta, dtype=np.float64),
                "omega": np.asarray(full.omega, dtype=np.float64)}
    if full.beta is not None:
        estimate["beta"] = np.asarray(full.beta, dtype=np.float64)
    return BootstrapResult(
        samples=samples,
        estimate=estimate,
        n_requested=n_boot,
        n_failed=n_boot - int(ok.sum()),
        alpha=float(alpha),
        parameter_names=(tuple(full.parameter_names)
                         if full.parameter_names else None),
        full=full,
    )
