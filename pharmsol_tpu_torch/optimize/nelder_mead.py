"""Nelder-Mead simplex minimizer (argmin-compatible semantics).

Standard coefficients (reflection 1, expansion 2, contraction 0.5, shrink
0.5); termination when the sample standard deviation of the simplex costs
falls below ``sd_tolerance`` or ``max_iters`` is reached — matching the
argmin solver the reference uses (optimize/parameters.rs:82-90).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass
class NelderMeadResult:
    best_param: np.ndarray
    best_cost: float
    iterations: int
    converged: bool


def nelder_mead(
    cost: Callable[[np.ndarray], float],
    simplex: Sequence[Sequence[float]],
    sd_tolerance: float = 1e-8,
    max_iters: int = 1000,
) -> NelderMeadResult:
    pts = [np.asarray(p, dtype=np.float64) for p in simplex]
    n = pts[0].shape[0]
    if len(pts) != n + 1:
        raise ValueError(f"simplex needs {n + 1} vertices for {n} dims, got {len(pts)}")
    costs = [float(cost(p)) for p in pts]

    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        order = np.argsort(costs)
        pts = [pts[i] for i in order]
        costs = [costs[i] for i in order]

        sd = float(np.std(costs, ddof=1)) if len(costs) > 1 else 0.0
        if sd <= sd_tolerance:
            converged = True
            break

        centroid = np.mean(pts[:-1], axis=0)
        worst = pts[-1]
        # reflection
        xr = centroid + 1.0 * (centroid - worst)
        fr = float(cost(xr))
        if costs[0] <= fr < costs[-2]:
            pts[-1], costs[-1] = xr, fr
            continue
        if fr < costs[0]:
            # expansion
            xe = centroid + 2.0 * (centroid - worst)
            fe = float(cost(xe))
            if fe < fr:
                pts[-1], costs[-1] = xe, fe
            else:
                pts[-1], costs[-1] = xr, fr
            continue
        # contraction
        xc = centroid + 0.5 * (worst - centroid)
        fc = float(cost(xc))
        if fc < costs[-1]:
            pts[-1], costs[-1] = xc, fc
            continue
        # shrink toward best
        best = pts[0]
        for i in range(1, len(pts)):
            pts[i] = best + 0.5 * (pts[i] - best)
            costs[i] = float(cost(pts[i]))

    best_idx = int(np.argmin(costs))
    return NelderMeadResult(
        best_param=pts[best_idx],
        best_cost=float(costs[best_idx]),
        iterations=it,
        converged=converged,
    )


def initial_simplex(point: Sequence[float], perturbation_pct: float = 0.008) -> List[List[float]]:
    """Perturbation simplex (optimize/parameters.rs:91-112): each dimension
    nudged by 0.8% (or 0.00025 when the coordinate is zero)."""
    point = list(map(float, point))
    vertices = [list(point)]
    for i in range(len(point)):
        perturbed = list(point)
        perturbed[i] += 0.00025 if point[i] == 0.0 else perturbation_pct * point[i]
        vertices.append(perturbed)
    return vertices
