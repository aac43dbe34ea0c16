"""Stepwise covariate model building (PsN ``scm``) on the Laplace fitter.

The reference exposes likelihood primitives and leaves model-building
workflows to external drivers (SURVEY §3.2). This module closes the
covariate-selection workflow the way PsN's ``scm`` tool does for
NONMEM: forward inclusion then backward elimination of NONMEM-style
covariate effects on typical values (``fit_laplace``'s
``covariate_effects``), scored by the likelihood-ratio test between
nested Laplace fits (each effect adds exactly one fitted beta, so every
comparison is a 1-dof chi-square).

Forward phase: at each step every remaining candidate is fitted on top
of the current model; the candidate with the LARGEST significant LRT
(p < ``forward_alpha``) enters. Backward phase: effects are removed one
at a time, dropping the LEAST significant at the stricter
``backward_alpha`` until all survivors are significant — the standard
guard against forward-selection overfitting (PsN defaults 0.05 / 0.01).

Batched screening (the counterpart of the JAX package's
``optimize/scm.py``): where PsN queues one NONMEM run per candidate, every
candidate model at a step shares the SAME psi dimension — only the
covariate design ``(x [n_sub, n_eff], onehot [n_eff, p])`` differs — so
all candidate fits run as the lanes of ONE batched L-BFGS over the
design-parameterized Laplace objective (``neg_laplace_wxy_lanes``),
warm-started at the current model's optimum (``vectorize=True``, the
default). The accepted
candidate is then confirmed with a full :func:`fit_laplace` call, whose
exact log-likelihood feeds the official step record.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import PharmsolError

__all__ = ["ScmStep", "ScmResult", "scm"]

_PHI = NormalDist()


def _lrt_pvalue_1dof(lrt: float) -> float:
    """P(chi2_1 > lrt) via the normal CDF: chi2_1 = Z^2."""
    if not np.isfinite(lrt) or lrt <= 0.0:
        return 1.0
    return 2.0 * (1.0 - _PHI.cdf(float(np.sqrt(lrt))))


class ScmStep(NamedTuple):
    """One accepted action (or phase stop) in the stepwise search."""

    action: str                 # 'add' | 'remove'
    effect: tuple               # the (parameter, covariate, form[, ref]) spec
    lrt: float                  # 2 * (ll_big - ll_small), always >= 0 nested
    p_value: float              # 1-dof chi-square tail
    log_likelihood: float       # of the model AFTER the action
    included: tuple             # effect set AFTER the action


class ScmResult(NamedTuple):
    """Final model from forward-inclusion / backward-elimination."""

    effects: tuple              # included covariate effects, add order
    final: Any                  # LaplaceResult of the final model
    base_log_likelihood: float  # the no-candidate starting model
    steps: Tuple[ScmStep, ...]
    trials: Tuple[dict, ...]    # every candidate evaluation, both phases
    n_fits: int                 # distinct FULL models fitted (cache hits and
                                # vectorized screening excluded)

    def summary(self) -> str:
        lines = [
            f"SCM: {len(self.effects)} effect(s) retained after "
            f"{len(self.steps)} step(s), {self.n_fits} model fits "
            f"(base LL {self.base_log_likelihood:.4f} -> final "
            f"{self.final.log_likelihood:.4f})"
        ]
        for s in self.steps:
            sign = "+" if s.action == "add" else "-"
            lines.append(
                f"  {sign} {s.effect}: LRT={s.lrt:.3f} p={s.p_value:.4g} "
                f"-> LL {s.log_likelihood:.4f}"
            )
        for e in self.effects:
            lines.append(f"  retained: {e}")
        return "\n".join(lines)


def _vectorized_candidate_lls(
    equation, data, residual_error_models, theta0, effect_sets,
    z0, laplace_kwargs, refit_iters, subjects, p, names, on_error, device=None,
):
    """Screen every same-shaped candidate effect set as ONE batched program.

    All sets share ``n_eff = len(effect_sets[0])``; only the covariate
    design differs, which rides as a per-lane operand of the
    design-parameterized Laplace objective (laplace.py
    ``neg_laplace_wxy_lanes(psi, w, y, x, onehot)``). ``z0``: shared ``[dim]`` or per-candidate ``[C, dim]``
    warm starts. Returns ``(lls [C], ok [C])`` aligned with
    ``effect_sets``; candidates whose design fails to resolve (or whose
    fit goes non-finite) get ``ll=-inf, ok=False``.
    """
    from ..config import float_dtype
    from ._coveffects import resolve_covariate_effects
    from .bootstrap import _vectorized_refits
    from .laplace import fit_laplace

    n_set = len(effect_sets)
    designs: list = []
    ok = np.ones(n_set, dtype=bool)
    for i, es in enumerate(effect_sets):
        try:
            ce = resolve_covariate_effects(list(es), subjects, p, names)
            designs.append((ce.x, ce.onehot))
        except Exception:
            if on_error == "raise":
                raise
            ok[i] = False
            designs.append(None)
    good = [i for i in range(n_set) if ok[i]]
    lls = np.full(n_set, -np.inf)
    if not good:
        return lls, ok
    intro: Dict[str, Any] = {}
    fit_laplace(
        equation, data, residual_error_models, theta0,
        covariate_effects=list(effect_sets[good[0]]),
        _introspect=intro, _build_only=True, device=device, **laplace_kwargs,
    )
    neg = intro["neg_laplace_wxy_lanes"]
    fd, dev = float_dtype(), intro["psi0"].device
    ones = torch.ones((len(good), int(intro["layout"]["n_sub"])), dtype=fd, device=dev)
    X = torch.as_tensor(np.stack([designs[i][0] for i in good]), dtype=fd, device=dev)
    O = torch.as_tensor(np.stack([designs[i][1] for i in good]), dtype=fd, device=dev)
    z0 = np.array(z0, dtype=np.float64)
    Z0 = torch.as_tensor(z0[good] if z0.ndim == 2 else z0, dtype=fd, device=dev)
    _, G, F = _vectorized_refits(
        lambda z, xo: neg(z, ones, None, xo[0], xo[1]),
        Z0, (X, O), refit_iters, intro["lanes_value_and_grad"],
    )
    for j, i in enumerate(good):
        if np.isfinite(F[j]) and np.isfinite(G[j]):
            lls[i] = -float(F[j])
        else:
            ok[i] = False
    return lls, ok


def scm(
    equation,
    data,
    residual_error_models,
    theta0,
    candidates: Sequence,
    *,
    forward_alpha: float = 0.05,
    backward_alpha: float = 0.01,
    base_effects: Sequence = (),
    max_effects: Optional[int] = None,
    on_error: str = "skip",
    vectorize: bool = True,
    refit_iters: int = 60,
    device=None,
    **laplace_kwargs,
) -> ScmResult:
    """Forward-inclusion / backward-elimination covariate search.

    ``candidates``: covariate-effect specs in ``fit_laplace``'s
    ``covariate_effects`` format — ``(parameter, covariate,
    'power'|'linear'[, reference])``. ``base_effects`` are always kept
    (never tested for removal). Each candidate adds ONE beta, so model
    comparisons are 1-dof likelihood-ratio tests: enter at
    ``forward_alpha``, survive backward elimination at the stricter
    ``backward_alpha``. ``on_error='skip'`` treats a failed candidate
    fit as non-significant (recorded in ``trials``); ``'raise'``
    propagates. Extra keyword arguments go to every
    :func:`~pharmsol_tpu_torch.optimize.fit_laplace` call (omega structure,
    transform, est_sigma, max_iters...), each on ``device`` (default: the
    card).

    ``vectorize=True`` screens all candidates at each step as the lanes of
    one batched L-BFGS (``refit_iters`` fixed L-BFGS steps each,
    warm-started at the current optimum) and confirms only the winner
    with a full fit; ``False`` runs one full fit per candidate (the
    PsN-equivalent sequential mode). Both make the same accept/remove
    decisions up to screening-convergence ties: the official LRT of
    every ACCEPTED step always comes from full fits.

    Returns :class:`ScmResult` with the final fit, the accepted step
    log, and every candidate evaluation for reporting.
    """
    from .laplace import fit_laplace

    if on_error not in ("skip", "raise"):
        raise PharmsolError("on_error must be 'skip' or 'raise'")
    if not (0.0 < forward_alpha < 1.0 and 0.0 < backward_alpha < 1.0):
        raise PharmsolError("alphas must be in (0, 1)")
    if refit_iters < 1:
        raise PharmsolError("refit_iters must be >= 1")
    base = [tuple(e) for e in base_effects]
    cands = [tuple(c) for c in candidates]
    if not cands:
        raise PharmsolError("scm needs at least one candidate effect")
    seen = set(base)
    for c in cands:
        if c in seen:
            raise PharmsolError(f"duplicate candidate effect {c}")
        seen.add(c)

    fits: Dict[frozenset, tuple] = {}   # key -> (result, z_opt)
    n_fits = 0
    subjects = None

    def fit(effects: list):
        nonlocal n_fits, subjects
        key = frozenset(effects)
        hit = fits.get(key)
        if hit is None:
            intro: Dict[str, Any] = {}
            res = fit_laplace(
                equation, data, residual_error_models, theta0,
                covariate_effects=(list(effects) or None),
                _introspect=intro, device=device, **laplace_kwargs,
            )
            if not np.isfinite(res.log_likelihood):
                raise PharmsolError(
                    f"non-finite Laplace log-likelihood with effects "
                    f"{effects}"
                )
            if subjects is None:
                subjects = intro["cond"].subjects
            hit = (res, intro["z_opt"])
            fits[key] = hit
            n_fits += 1
        return hit

    current = list(base)
    res_cur, z_cur = fit(current)
    base_ll = float(res_cur.log_likelihood)
    p = len(res_cur.theta)
    names = res_cur.parameter_names
    remaining = list(cands)
    steps: list = []
    trials: list = []

    def screen(phase: str, effect_keys: list, effect_sets: list, z0):
        """Vectorized screen -> {effect_key: ll} for finite candidates."""
        lls, ok = _vectorized_candidate_lls(
            equation, data, residual_error_models, theta0, effect_sets,
            z0, laplace_kwargs, refit_iters, subjects, p, names, on_error,
            device,
        )
        out = {}
        for i, ek in enumerate(effect_keys):
            if ok[i]:
                out[ek] = lls[i]
            else:
                trials.append(dict(phase=phase, effect=ek, lrt=np.nan,
                                   p_value=1.0 if phase == "forward" else 0.0,
                                   failed=True, screened=True))
        return out

    def try_full(phase: str, effects: list, eff):
        """Full fit for a screened winner; None on skipped failure."""
        try:
            return fit(effects)
        except Exception:
            if on_error == "raise":
                raise
            trials.append(dict(phase=phase, effect=eff, lrt=np.nan,
                               p_value=1.0 if phase == "forward" else 0.0,
                               failed=True, screened=False))
            return None

    # -- forward inclusion ----------------------------------------------
    while remaining and (
        max_effects is None or len(current) - len(base) < max_effects
    ):
        ll_cur = float(res_cur.log_likelihood)
        best = None
        if vectorize:
            z0 = np.insert(np.asarray(z_cur, dtype=np.float64),
                           p + len(current), 0.0)
            screened = screen(
                "forward", list(remaining),
                [current + [c] for c in remaining], z0,
            )
            # walk screened candidates best-first; confirm with full fits
            order = sorted(screened, key=lambda c: -screened[c])
            for cand in order:
                s_lrt = 2.0 * (screened[cand] - ll_cur)
                s_p = _lrt_pvalue_1dof(s_lrt)
                trials.append(dict(phase="forward", effect=cand, lrt=s_lrt,
                                   p_value=s_p, failed=False, screened=True))
                if s_p >= forward_alpha:
                    break  # ordered: nothing later can be significant
                hit = try_full("forward", current + [cand], cand)
                if hit is None:
                    continue
                res, _ = hit
                lrt = 2.0 * (float(res.log_likelihood) - ll_cur)
                pv = _lrt_pvalue_1dof(lrt)
                trials.append(dict(phase="forward", effect=cand, lrt=lrt,
                                   p_value=pv, failed=False, screened=False,
                                   converged=bool(res.converged)))
                if pv < forward_alpha:
                    best = (cand, hit, lrt, pv)
                    break
        else:
            for cand in remaining:
                hit = try_full("forward", current + [cand], cand)
                if hit is None:
                    continue
                res, _ = hit
                lrt = 2.0 * (float(res.log_likelihood) - ll_cur)
                pv = _lrt_pvalue_1dof(lrt)
                trials.append(dict(phase="forward", effect=cand, lrt=lrt,
                                   p_value=pv, failed=False,
                                   converged=bool(res.converged)))
                if pv < forward_alpha and (best is None or lrt > best[2]):
                    best = (cand, hit, lrt, pv)
        if best is None:
            break
        cand, (res, z), lrt, pv = best
        current.append(cand)
        remaining.remove(cand)
        res_cur, z_cur = res, z
        steps.append(ScmStep("add", cand, lrt, pv,
                             float(res.log_likelihood), tuple(current)))

    # -- backward elimination at the stricter alpha ----------------------
    while True:
        removable = [e for e in current if e not in base]
        if not removable:
            break
        ll_cur = float(res_cur.log_likelihood)
        worst = None
        reduced_sets = [[e for e in current if e != eff] for eff in removable]
        use_vector = vectorize and all(len(rs) > 0 for rs in reduced_sets)
        if use_vector:
            z_np = np.asarray(z_cur, dtype=np.float64)
            Z0 = np.stack([
                np.delete(z_np, p + current.index(eff)) for eff in removable
            ])
            screened = screen("backward", list(removable), reduced_sets, Z0)
            # candidates ordered weakest-first (largest p = smallest LRT)
            order = sorted(screened, key=lambda e: screened[e], reverse=True)
            for eff in order:
                s_lrt = 2.0 * (ll_cur - screened[eff])
                s_p = _lrt_pvalue_1dof(s_lrt)
                trials.append(dict(phase="backward", effect=eff, lrt=s_lrt,
                                   p_value=s_p, failed=False, screened=True))
                if s_p < backward_alpha:
                    break  # ordered: everything later is more significant
                hit = try_full("backward",
                               [e for e in current if e != eff], eff)
                if hit is None:
                    continue
                res, _ = hit
                lrt = 2.0 * (ll_cur - float(res.log_likelihood))
                pv = _lrt_pvalue_1dof(lrt)
                trials.append(dict(phase="backward", effect=eff, lrt=lrt,
                                   p_value=pv, failed=False, screened=False,
                                   converged=bool(res.converged)))
                if pv >= backward_alpha:
                    worst = (eff, hit, lrt, pv)
                    break
        else:
            for eff, reduced in zip(removable, reduced_sets):
                hit = try_full("backward", reduced, eff)
                if hit is None:
                    continue
                res, _ = hit
                lrt = 2.0 * (ll_cur - float(res.log_likelihood))
                pv = _lrt_pvalue_1dof(lrt)
                trials.append(dict(phase="backward", effect=eff, lrt=lrt,
                                   p_value=pv, failed=False,
                                   converged=bool(res.converged)))
                # NOT significant at backward_alpha -> removal candidate;
                # drop the least significant (largest p) first
                if pv >= backward_alpha and (worst is None or pv > worst[3]):
                    worst = (eff, hit, lrt, pv)
        if worst is None:
            break
        eff, (res, z), lrt, pv = worst
        current.remove(eff)
        res_cur, z_cur = res, z
        steps.append(ScmStep("remove", eff, lrt, pv,
                             float(res.log_likelihood), tuple(current)))

    return ScmResult(
        effects=tuple(e for e in current if e not in base) or tuple(),
        final=res_cur,
        base_log_likelihood=base_ll,
        steps=tuple(steps),
        trials=tuple(trials),
        n_fits=n_fits,
    )
