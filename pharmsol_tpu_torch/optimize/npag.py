"""Nonparametric adaptive-grid population estimation (NPAG-style).

The counterpart of the JAX package's ``optimize/npag.py``: the population
loop on top of the port's psi path.

  cycle:  psi = log_likelihood_matrix(model, data, support, ems)
          lam  = argmax_simplex  sum_i log( (psi @ lam)_i )      (NPML)
          condense (drop ~zero-weight points, merge duplicates)
          expand: +- delta moves per dimension for EVERY kept point,
                  ONE batched psi call for all candidates, keep those
                  whose D-score  sum_i psi_i(theta)/pyl_i - n  > 0
          shrink delta when nothing improves; stop at delta_min + no gain

The convex weight subproblem is solved by optimize/weights.py (burn-in on
the card, active-set Newton and the KKT check on the host in float64). The
D-score used to accept candidate points is the expression the reference uses
as its refinement objective (optimize/parameters.rs:19-120: cost =
-(sum_i psi_i/pyl_i - n)), so grid expansion and the reference's Nelder-Mead
point polish optimize one criterion; ``refine='nm'`` runs that inner polish
(ParameterOptimizer) over the final support.

The expansion step batches K*2P candidate points into ONE psi matrix call,
the access pattern the fused kernels are built for.

psi stays where ``log_likelihood_matrix`` leaves it, a tensor on the fit's
device: the row shift, ``exp`` and the float32 copy for the burn-in are taken
there, and only the float64 matrix the host Newton needs crosses to the
host. The JAX package pads the support to a multiple of 64 so that its
compiled program is reused across cycles; PyTorch compiles nothing per shape,
so every psi call here has exactly the support's columns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..data.error_model import AssayErrorModels
from ..errors import PharmsolError
from ..likelihood.matrix import log_likelihood_matrix

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)


def _halton(n: int, dim: int, skip: int = 20) -> np.ndarray:
    """Low-discrepancy start grid (radical-inverse Halton, unit cube)."""
    if dim > len(_PRIMES):
        raise PharmsolError(f"initial grid supports <= {len(_PRIMES)} dims")
    out = np.empty((n, dim), dtype=np.float64)
    for d in range(dim):
        base = _PRIMES[d]
        idx = np.arange(skip + 1, skip + n + 1, dtype=np.int64)
        col = np.zeros(n, dtype=np.float64)
        f = 1.0
        while np.any(idx > 0):
            f /= base
            col += f * (idx % base)
            idx //= base
        out[:, d] = col
    return out


class PopulationResult(NamedTuple):
    """Nonparametric population fit: a discrete distribution over theta."""

    support: np.ndarray        # [n_support, n_params], model order
    weights: np.ndarray        # [n_support], sums to 1
    log_likelihood: float      # sum_i log( sum_j psi_ij * w_j )
    cycles: int
    converged: bool
    d_max: float               # max_j D(theta_j) - n over the FINAL grid
    posterior: np.ndarray      # [n_subjects, n_support] P(point | subject)
    parameter_names: Optional[tuple]

    def population_mean(self) -> np.ndarray:
        return self.weights @ self.support

    def population_covariance(self) -> np.ndarray:
        mu = self.population_mean()
        centered = self.support - mu
        return (centered * self.weights[:, None]).T @ centered

    def individual_posterior_means(self) -> np.ndarray:
        """[n_subjects, n_params] posterior-expected parameters."""
        return self.posterior @ self.support

    def summary(self) -> str:
        lines = [
            f"NP population fit: loglik={self.log_likelihood:.6g}, "
            f"{self.support.shape[0]} support points, "
            f"{'converged' if self.converged else 'NOT converged'} in "
            f"{self.cycles} cycles, max D-n = {self.d_max:.3g}"
        ]
        names = self.parameter_names or tuple(
            f"p[{i}]" for i in range(self.support.shape[1])
        )
        mu = self.population_mean()
        sd = np.sqrt(np.maximum(np.diag(self.population_covariance()), 0.0))
        for i, nm in enumerate(names):
            lines.append(f"  {nm}: mean {mu[i]:.6g}, sd {sd[i]:.4g}")
        return "\n".join(lines)


def _solve_weights(psi: np.ndarray, max_iters: int = 4000,
                   tol: float = 1e-10, psi_f32=None):
    """NPML weights on the simplex for a row-normalized psi matrix
    (optimize/weights.py::solve_weights). Returns (lam, pyl, ll_shiftless)."""
    from .weights import solve_weights

    return solve_weights(psi, psi_f32=psi_f32, max_iters=max_iters, tol=tol)


def fit_population(
    equation,
    data,
    error_models: AssayErrorModels,
    ranges,
    *,
    init_points: int = 128,
    max_cycles: int = 50,
    delta: float = 0.2,
    delta_min: float = 1e-3,
    ll_tol: float = 1e-6,
    weight_floor: float = 1e-6,
    merge_tol: float = 1e-3,
    max_support: int = 4096,
    refine: Optional[str] = None,
    engine: str = "auto",
    mesh=None,
    progress: bool = False,
    device=None,
) -> PopulationResult:
    """Fit a nonparametric population distribution over the parameters.

    ``ranges``: dict ``{name: (lo, hi)}`` (needs model metadata; columns
    ordered to the model) or a sequence of ``(lo, hi)`` pairs already in
    model order. ``delta`` is the initial +-step of the adaptive grid as
    a fraction of each range; it halves whenever an expansion adds
    nothing and the fit stops when ``delta < delta_min`` with no
    log-likelihood gain. ``refine='nm'`` polishes the final support with
    the reference's shallow Nelder-Mead point refinement
    (optimize/parameters.rs:19-120) before the last weight solve.
    ``mesh``: a :class:`~pharmsol_tpu_torch.parallel.mesh.Mesh` routes
    every psi evaluation through the device split
    (``parallel/mesh.py::log_likelihood_matrix_sharded``, with ``engine``),
    as the JAX package does; the weight burn-in and the host solve read psi
    on the mesh's first device. ``device``: where psi and the burn-in run
    without a mesh, the card unless the caller asks for the CPU; with a
    mesh it must be None or the mesh's first device.
    """
    if mesh is None:
        dev = resolve_device(device)
    else:
        from ..parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise PharmsolError(
                f"mesh must be a pharmsol_tpu_torch.parallel.Mesh (population_mesh()), "
                f"got {type(mesh).__name__}")
        dev = mesh.first_device
        if device is not None and resolve_device(device) != dev:
            raise PharmsolError(
                f"fit_population: device `{device}` is not the mesh's first device "
                f"`{dev}`")
    names: Optional[tuple] = None
    if isinstance(ranges, dict):
        metadata = getattr(equation, "metadata", None)
        metadata = metadata() if callable(metadata) else metadata
        if metadata is None:
            raise PharmsolError(
                "named ranges require model metadata (.with_metadata)"
            )
        model_names = list(metadata.parameter_names)
        missing = [n for n in model_names if n not in ranges]
        extra = [n for n in ranges if n not in model_names]
        if missing or extra:
            raise PharmsolError(
                f"ranges must cover the model parameters exactly "
                f"(missing: {missing or '-'}, unknown: {extra or '-'})"
            )
        ordered = [ranges[n] for n in model_names]
        names = tuple(model_names)
        ranges = ordered
    bounds = np.asarray(ranges, dtype=np.float64)
    if bounds.ndim != 2 or bounds.shape[1] != 2:
        raise PharmsolError("ranges must be [(lo, hi), ...] per parameter")
    lo, hi = bounds[:, 0], bounds[:, 1]
    if np.any(hi <= lo):
        raise PharmsolError("every range needs hi > lo")
    p = bounds.shape[0]
    span = hi - lo

    from ..utils.profiling import stage

    from .weights import _device_eligible

    def psi_of(support: np.ndarray, require_finite: bool = True):
        with stage("npag/psi_device", dev):
            if mesh is not None:
                from ..parallel.mesh import log_likelihood_matrix_sharded

                log_psi = log_likelihood_matrix_sharded(
                    equation, data, support, error_models, mesh=mesh, engine=engine)
            else:
                log_psi = log_likelihood_matrix(
                    equation, data, support, error_models, engine=engine, device=dev
                )
        # row-shift before exponentiating: weights are scale-invariant
        # per row and the shifts add back into the reported loglik
        log_psi = log_psi.to(torch.float64)
        shift_t = torch.amax(log_psi, dim=1)
        ok_t = torch.isfinite(shift_t)
        shift = shift_t.cpu().numpy()
        ok = ok_t.cpu().numpy()
        if not np.all(ok):
            if require_finite:
                bad = int(np.sum(~ok))
                raise PharmsolError(
                    f"{bad} subject(s) have -inf likelihood at EVERY grid "
                    f"point; widen `ranges` or check the error model"
                )
            # candidate-only batches: an all--inf row just contributes
            # nothing to the D-score (exp(-inf - 0) = 0 keeps it NaN-free)
            shift = np.where(ok, shift, -np.inf)
        safe = torch.where(ok_t, shift_t, torch.zeros_like(shift_t))
        psi_t = torch.exp(log_psi - safe[:, None])
        # the float32 copy for the burn-in is formed where psi already is,
        # and only when the burn-in will run on the card
        psi_f32 = None
        if require_finite and _device_eligible(*psi_t.shape, dev):
            psi_f32 = psi_t.to(torch.float32)
        return psi_t.cpu().numpy(), shift, psi_f32

    def dedupe(support: np.ndarray, lam: np.ndarray):
        scaled = (support - lo) / span
        order = np.argsort(-lam)
        keep, kept_rows = [], []
        for j in order:
            row = scaled[j]
            if any(np.max(np.abs(row - r)) < merge_tol for r in kept_rows):
                continue
            keep.append(j)
            kept_rows.append(row)
        keep = np.sort(np.asarray(keep))
        return support[keep]

    def solve_weights_timed(psi_m, psi_f32=None):
        with stage("npag/weights"):
            return _solve_weights(psi_m, psi_f32=psi_f32)

    support = lo + _halton(init_points, p) * span
    psi, shifts, psi_f32 = psi_of(support)
    lam, pyl, ll = solve_weights_timed(psi, psi_f32)
    ll += float(np.sum(shifts))
    n_sub = psi.shape[0]

    cur_delta = float(delta)
    converged = False
    cycle = 0
    for cycle in range(1, max_cycles + 1):
        # condense: keep meaningful mass, merge near-duplicates
        keep = lam > weight_floor * np.max(lam)
        support = dedupe(support[keep], lam[keep])
        psi, shifts, psi_f32 = psi_of(support)
        lam, pyl, ll_new = solve_weights_timed(psi, psi_f32)
        ll_new += float(np.sum(shifts))

        # expand: +-delta per dimension for every kept point, one batch
        cand = np.concatenate([
            np.clip(support + cur_delta * span * e, lo, hi)
            for sgn in (1.0, -1.0)
            for e in (sgn * np.eye(p))
        ])
        cand = np.unique(cand, axis=0)
        if len(cand) + len(support) > max_support:
            cand = cand[: max(0, max_support - len(support))]
        cand_psi, cand_shift, _ = (
            psi_of(cand, require_finite=False)
            if len(cand) else (None, None, None)
        )
        added = 0
        if cand_psi is not None:
            # D-score with psi re-expressed on THIS cycle's row shifts
            rescale = np.exp(cand_shift - shifts)
            d = ((cand_psi * rescale[:, None]) / pyl[:, None]).sum(axis=0)
            good = d > n_sub * (1.0 + 1e-9)
            if np.any(good):
                support = np.concatenate([support, cand[good]])
                psi, shifts, psi_f32 = psi_of(support)
                lam, pyl, ll_new = solve_weights_timed(psi, psi_f32)
                ll_new += float(np.sum(shifts))
                added = int(np.sum(good))

        gained = ll_new - ll
        ll = ll_new
        if progress:
            print(
                f"cycle {cycle}: ll={ll:.6f} (+{gained:.2e}), "
                f"{len(support)} pts (+{added}), delta={cur_delta:.4g}"
            )
        # delta control keys on the OBJECTIVE, not the added-point count:
        # a candidate scoring epsilon above n can be re-added and merged
        # away every cycle without moving the log-likelihood, and must
        # still shrink the grid step
        if gained < ll_tol * max(1.0, abs(ll)):
            if cur_delta < delta_min:
                converged = True
                break
            cur_delta *= 0.5

    if refine == "nm":
        from .parameters import ParameterOptimizer

        opt = ParameterOptimizer(equation, data, error_models,
                                 pyl * np.exp(shifts), engine=engine, device=dev)
        polished = np.stack([
            np.clip(opt.optimize_point(pt), lo, hi) for pt in support
        ])
        support = dedupe(polished, lam)
        psi, shifts, psi_f32 = psi_of(support)
        lam, pyl, ll = solve_weights_timed(psi, psi_f32)
        ll += float(np.sum(shifts))
    elif refine is not None:
        raise PharmsolError("refine must be None or 'nm'")

    keep = lam > weight_floor * np.max(lam)
    support, lam = support[keep], lam[keep]
    lam = lam / lam.sum()
    psi, shifts, psi_f32 = psi_of(support)
    lam, pyl, ll = solve_weights_timed(psi, psi_f32)
    ll += float(np.sum(shifts))
    d_max = float((psi / pyl[:, None]).sum(axis=0).max() - n_sub)
    posterior = psi * lam[None, :]
    posterior /= posterior.sum(axis=1, keepdims=True)

    return PopulationResult(
        support=support,
        weights=lam,
        log_likelihood=ll,
        cycles=cycle,
        converged=converged,
        d_max=d_max,
        posterior=posterior,
        parameter_names=names,
    )
