"""Simulation–re-estimation (SSE / parametric bootstrap) around any fitter.

The reference exposes simulation and likelihood primitives and leaves
study-level workflows to external drivers (SURVEY §3.2). This module
closes the remaining uncertainty workflow the way PsN's ``sse`` tool
does for NONMEM: simulate ``n_sim`` replicate datasets FROM the fitted
(or hypothesised) population on the exact observed design, refit every
replicate, and summarize estimator bias, precision (RMSE), and — when
the fitter reports standard errors — confidence-interval coverage
against the generating values.

Together with :func:`~pharmsol_tpu_torch.optimize.bootstrap` (case
resampling of the observed data) and the simulation diagnostics
(:func:`~pharmsol_tpu_torch.optimize.vpc` /
:func:`~pharmsol_tpu_torch.optimize.npde`) this completes the
estimation-uncertainty triad. The counterpart of the JAX package's
``optimize/sse.py``: replicate simulation reuses the VPC simulator (every
replicate of a chunk in one prediction call on the device); replicate
datasets share the original design.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.structs import Data, Occasion, Subject
from ..data.event import Censor, Observation
from ..errors import PharmsolError
from .bootstrap import _decode_psi_samples, _default_extract, _vectorized_refits
from .diagnostics import _simulate

__all__ = ["SseResult", "sse", "sse_laplace"]


def _replicate_subjects(subjects, sims_np, active_np) -> list:
    """Rebuild subjects with observation values replaced by one replicate.

    ``sims_np [R, O]`` and ``active_np [R, O]`` are aligned with the
    population grid's row order: rows are occasions, subject-major in
    data order, and observation slots fill in event order within each
    occasion (engine/grid.py:383-405). The walk below retraces exactly
    that order, so slot (r, o) lands on the same Observation event the
    lowering put there. Only events that HAD a value are replaced
    (``active``); missing observations (value=None, LL contribution 0)
    stay missing. Doses, covariates, times, and occasion structure are
    shared with the originals — only Observation events are copied.
    """
    from dataclasses import replace as _dc_replace

    out = []
    r = 0
    for subject in subjects:
        occs = []
        for occ in subject.occasions():
            slot = 0
            events = []
            for e in occ.events:
                if isinstance(e, Observation):
                    if e.value is not None:
                        if not active_np[r, slot]:
                            raise PharmsolError(
                                "internal: replicate walk out of sync "
                                f"with the lowering at row {r} slot {slot}"
                            )
                        events.append(
                            _dc_replace(e, value=float(sims_np[r, slot]))
                        )
                    else:
                        events.append(e)
                    slot += 1
                else:
                    events.append(e)
            oc = Occasion(occ.index)
            oc.events = events
            oc.covariates = occ.covariates
            occs.append(oc)
            r += 1
        out.append(Subject(subject.id, occs))
    if r != sims_np.shape[0]:
        raise PharmsolError(
            f"internal: replicate walk covered {r} rows, grid has "
            f"{sims_np.shape[0]}"
        )
    return out


class SseResult(NamedTuple):
    """Replicate estimates from a simulation–re-estimation study."""

    samples: Dict[str, np.ndarray]    # name -> [n_ok, ...] refit estimates
    generating: Dict[str, np.ndarray]  # name -> the simulating truth
    ses: Optional[np.ndarray]         # [n_ok, p] per-replicate theta SEs
    n_requested: int
    n_failed: int
    parameter_names: Optional[tuple]

    @property
    def n_ok(self) -> int:
        first = next(iter(self.samples.values()))
        return int(first.shape[0])

    def bias(self) -> Dict[str, np.ndarray]:
        """Mean replicate estimate minus the generating value."""
        return {
            k: np.mean(v, axis=0) - self.generating[k]
            for k, v in self.samples.items() if k in self.generating
        }

    def relative_bias(self) -> Dict[str, np.ndarray]:
        """bias / |generating| (nan where the generating value is 0)."""
        out = {}
        for k, b in self.bias().items():
            g = np.abs(self.generating[k])
            out[k] = np.where(g > 0, b / np.where(g > 0, g, 1.0), np.nan)
        return out

    def rmse(self) -> Dict[str, np.ndarray]:
        """Root-mean-square error of the replicates vs the truth."""
        return {
            k: np.sqrt(np.mean((v - self.generating[k]) ** 2, axis=0))
            for k, v in self.samples.items() if k in self.generating
        }

    def se(self) -> Dict[str, np.ndarray]:
        """Empirical SD of the replicate estimates (the TRUE estimator SE)."""
        return {k: np.std(v, axis=0, ddof=1) for k, v in self.samples.items()}

    def coverage(self, level: float = 0.95) -> Optional[np.ndarray]:
        """Wald CI coverage of the generating theta, per parameter.

        Needs per-replicate standard errors (fitters that report them:
        ``fit_map``, ``fit_laplace``). The headline SSE calibration
        check: nominal ``level`` coverage means the fitter's SEs are
        honest for this design.
        """
        if self.ses is None or "theta" not in self.generating:
            return None
        from statistics import NormalDist

        z = NormalDist().inv_cdf(0.5 + level / 2.0)
        theta = self.samples["theta"]
        truth = self.generating["theta"][None, :]
        ok = np.abs(theta - truth) <= z * self.ses
        return np.mean(ok.astype(np.float64), axis=0)

    def summary(self) -> str:
        lines = [
            f"SSE: {self.n_ok}/{self.n_requested} replicate refits ok"
            + (f" ({self.n_failed} failed)" if self.n_failed else "")
        ]
        rb = self.relative_bias()
        rmse = self.rmse()
        esd = self.se()
        cov = self.coverage() if self.ses is not None else None
        for k in self.samples:
            if k not in self.generating:
                continue
            names = (
                self.parameter_names
                if (k == "theta" and self.parameter_names is not None
                    and len(self.parameter_names)
                    == np.atleast_1d(self.generating[k]).shape[0])
                else None
            )
            g = np.atleast_1d(self.generating[k])
            for i in range(g.shape[0]):
                nm = names[i] if names else f"{k}[{i}]"
                extra = ""
                if cov is not None and k == "theta":
                    extra = f"  cov95={cov[i]:.2f}"
                lines.append(
                    f"  {nm}: truth={g[i]:.5g}  relbias="
                    f"{100 * np.atleast_1d(rb[k])[i]:+.2f}%  rmse="
                    f"{np.atleast_1d(rmse[k])[i]:.4g}  sd="
                    f"{np.atleast_1d(esd[k])[i]:.4g}{extra}"
                )
        return "\n".join(lines)


def sse(
    equation,
    data: Data,
    residual_error_models,
    population,
    fit: Callable[[Data], Any],
    *,
    n_sim: int = 200,
    seed: int = 0,
    extract: Optional[Callable[[Any], Dict[str, np.ndarray]]] = None,
    rep_chunk: int = 32,
    on_error: str = "skip",
    device=None,
) -> SseResult:
    """Simulate ``n_sim`` datasets from ``population`` and refit each.

    ``population`` is any fit result (``fit_saem`` / ``fit_laplace`` /
    ``fit_population``) or an object exposing ``(theta, omega,
    transform)`` / ``(support, weights)`` — each replicate draws fresh
    per-subject parameters from it and fresh residual noise through
    ``residual_error_models``, on the EXACT observed design of ``data``
    (same subjects, times, doses, covariates). ``fit`` is a closure
    ``Data -> result`` wrapping the fitter under study; ``extract``
    pulls named estimates from its result (defaults to the bootstrap
    extractor: theta/omega/beta or support moments).

    Returns an :class:`SseResult` whose ``bias()`` / ``rmse()`` /
    ``coverage()`` quantify the fitter's calibration on this design —
    the PsN ``sse`` workflow. Censored observations are not supported
    (a simulated value cannot be re-censored faithfully without the
    design's LOQ); pass uncensored data. The replicates are simulated on
    ``device`` (default: the card).
    """
    if n_sim < 2:
        raise PharmsolError("n_sim must be >= 2")
    if on_error not in ("skip", "raise"):
        raise PharmsolError("on_error must be 'skip' or 'raise'")
    data = data if isinstance(data, Data) else Data(list(data))
    for s in data.subjects():
        for occ in s.occasions():
            for e in occ.events:
                if isinstance(e, Observation) and e.censoring != Censor.NONE:
                    raise PharmsolError(
                        f"sse cannot re-simulate censored observations "
                        f"(subject {s.id}, t={e.time}); pass uncensored "
                        f"data"
                    )

    cond, sims = _simulate(
        equation, data, residual_error_models, population, n_sim, seed,
        True, rep_chunk, device,
    )
    active_np = cond.active.cpu().numpy()
    subjects = cond.subjects
    pull = extract or _default_extract
    generating = _default_extract(population)

    collected: list = []
    ses_list: list = []
    parameter_names = getattr(population, "parameter_names", None)
    n_failed = 0
    for rep in range(n_sim):
        rep_data = Data(_replicate_subjects(subjects, sims[rep], active_np))
        try:
            res = fit(rep_data)
        except Exception:
            if on_error == "raise":
                raise
            n_failed += 1
            continue
        collected.append(pull(res))
        rse = getattr(res, "standard_errors", None)
        ses_list.append(
            np.asarray(rse, dtype=np.float64) if rse is not None else None
        )
        if parameter_names is None:
            parameter_names = getattr(res, "parameter_names", None)
    if len(collected) < 2:
        raise PharmsolError(
            f"sse collapsed: {n_failed}/{n_sim} replicate refits failed — "
            "loosen the fitter settings or fix the model"
        )
    keys = list(collected[0].keys())
    samples = {k: np.stack([c[k] for c in collected], axis=0) for k in keys}
    ses = (
        np.stack(ses_list, axis=0)
        if all(s is not None for s in ses_list) else None
    )
    return SseResult(
        samples=samples,
        generating=generating,
        ses=ses,
        n_requested=n_sim,
        n_failed=n_failed,
        parameter_names=tuple(parameter_names) if parameter_names else None,
    )


def sse_laplace(
    equation,
    data: Data,
    residual_error_models,
    theta0,
    *,
    n_sim: int = 200,
    seed: int = 0,
    refit_iters: int = 40,
    rep_chunk: int = 32,
    device=None,
    **laplace_kwargs,
) -> SseResult:
    """Device-vectorized simulation–re-estimation around :func:`fit_laplace`,
    on ``device`` (default: the card).

    An SSE replicate's likelihood is the ORIGINAL likelihood with the
    observation values swapped, so no replicate needs its own Data: this
    fits the full data once, simulates ``n_sim`` observation arrays from
    the fitted population on the observed design (the VPC simulator), then
    refits EVERY replicate at once, the lanes of one batched L-BFGS over
    the y-parameterized Laplace objective (``neg_laplace_wy_lanes``),
    warm-started at the full-data optimum.

    ``refit_iters`` fixed L-BFGS steps per replicate (the warm start makes
    modest counts sufficient). Replicates whose refit goes non-finite are
    dropped and counted in ``n_failed``. Extra keyword arguments go to
    :func:`fit_laplace` and define the objective every replicate shares
    (omega structure, est_sigma, transform, covariate_effects — the
    replicate simulator applies the fitted typical-value covariate
    shifts per subject, and every refit re-estimates beta).
    """
    from ..config import float_dtype
    from .laplace import fit_laplace

    if n_sim < 2:
        raise PharmsolError("n_sim must be >= 2")
    if refit_iters < 1:
        raise PharmsolError("refit_iters must be >= 1")
    # the private ``_introspect`` dict receives the full fit's pieces and
    # the refits (``refits``: Y, Z, G, F)
    intro = laplace_kwargs.pop("_introspect", None)
    intro = {} if intro is None else intro
    full = fit_laplace(
        equation, data, residual_error_models, theta0,
        _introspect=intro, device=device, **laplace_kwargs,
    )
    neg_wy = intro["neg_laplace_wy_lanes"]
    lay = intro["layout"]
    n_sub = int(lay["n_sub"])

    fd, dev = float_dtype(), intro["psi0"].device
    _, sims = _simulate(
        equation, data, residual_error_models, full, n_sim, seed,
        True, rep_chunk, dev,
    )

    z0 = torch.as_tensor(intro["z_opt"], dtype=fd, device=dev)
    ones = torch.ones((n_sim, n_sub), dtype=fd, device=dev)
    Z, G, F = _vectorized_refits(
        lambda z, y: neg_wy(z, ones, y), z0,
        torch.as_tensor(sims, dtype=fd, device=dev), refit_iters,
        intro["lanes_value_and_grad"],
    )
    intro["refits"] = dict(Y=sims, Z=Z, G=G, F=F)
    ok = np.isfinite(Z).all(axis=1) & np.isfinite(G)
    if int(ok.sum()) < 2:
        raise PharmsolError(
            f"sse collapsed: {n_sim - int(ok.sum())}/{n_sim} vectorized "
            "refits went non-finite — raise refit_iters or check the model"
        )
    samples = _decode_psi_samples(Z[ok], lay)
    generating = _default_extract(full)
    return SseResult(
        samples=samples,
        generating=generating,
        ses=None,
        n_requested=n_sim,
        n_failed=n_sim - int(ok.sum()),
        parameter_names=(tuple(full.parameter_names)
                         if full.parameter_names else None),
    )
