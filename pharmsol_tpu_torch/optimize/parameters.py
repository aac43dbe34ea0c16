"""Support-point refinement against the population psi matrix.

Parity with the reference library, src/optimize/parameters.rs:19-120:
cost(theta) = -(sum_i psi_i(theta)/pyl_i - n); Nelder-Mead with the 0.8%
perturbation simplex, sd tolerance 1e-2, max 5 iterations (an NPAG-style
inner refinement, intentionally shallow).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..data.error_model import AssayErrorModels
from ..data.structs import Data
from ..likelihood.matrix import log_likelihood_matrix
from .nelder_mead import initial_simplex, nelder_mead


class ParameterOptimizer:
    """``engine`` and ``device`` go to :func:`log_likelihood_matrix` (the
    card unless the caller asks for the CPU); one psi column comes back to
    the host per cost evaluation."""

    def __init__(self, equation, data: Data, sig: AssayErrorModels, pyl: Sequence[float],
                 engine: str = "auto", device=None):
        self.equation = equation
        self.data = data
        self.sig = sig
        self.pyl = np.asarray(pyl, dtype=np.float64)
        self.engine = engine
        self.device = device

    def cost(self, parameters: np.ndarray) -> float:
        theta = np.asarray(parameters, dtype=np.float64).reshape(1, -1)
        log_psi = log_likelihood_matrix(self.equation, self.data, theta, self.sig,
                                        engine=self.engine, device=self.device)
        psi = np.exp(log_psi[:, 0].detach().cpu().numpy().astype(np.float64))
        if psi.shape[0] != self.pyl.shape[0]:
            raise ValueError(
                f"psi has {psi.shape[0]} rows but pyl has {self.pyl.shape[0]}"
            )
        nsub = float(psi.shape[0])
        total = -nsub + float(np.sum(psi / self.pyl))
        return -total

    def optimize_point(self, parameters: Sequence[float]) -> np.ndarray:
        simplex = initial_simplex(list(parameters))
        res = nelder_mead(self.cost, simplex, sd_tolerance=1e-2, max_iters=5)
        return res.best_param
