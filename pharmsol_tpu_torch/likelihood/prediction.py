"""Host-side prediction containers.

Parity with LAPKB/pharmsol src/simulator/likelihood/{prediction,subject}.rs:
``Prediction`` holds one observation/prediction pair with metadata;
``SubjectPredictions`` aggregates them with squared-error / log-likelihood
helpers. These are *views* assembled on the host from the prediction
march's tensors (``models/equation.py::_assemble_subject_predictions``); the
population paths (psi, the per-subject batch) never build them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..data.error_model import AssayErrorModels
from ..data.event import Censor, Observation
from ..errors import PharmsolError
from .distributions import LOG_2PI


@dataclass
class Prediction:
    time: float
    observation: Optional[float]
    prediction: float
    outeq: int
    errorpoly: Optional[tuple] = None
    state: List[float] = field(default_factory=list)
    occasion: int = 0
    censoring: Censor = Censor.NONE

    def prediction_error(self) -> Optional[float]:
        return None if self.observation is None else self.prediction - self.observation

    def percentage_error(self) -> Optional[float]:
        if self.observation is None or self.observation == 0.0:
            return None
        return (self.prediction - self.observation) / self.observation * 100.0

    def absolute_error(self) -> Optional[float]:
        return None if self.observation is None else abs(self.prediction - self.observation)

    def squared_error(self) -> Optional[float]:
        return None if self.observation is None else (self.prediction - self.observation) ** 2

    def log_likelihood(self, error_models: AssayErrorModels, output_label=None) -> float:
        """Observation-based log-likelihood of this single prediction."""
        if self.observation is None:
            return 0.0
        label = str(output_label) if output_label is not None else str(self.outeq)
        model = error_models.get(label)
        if model is None:
            raise PharmsolError(f"no error model for output `{label}`")
        from ..data.error_model import ErrorPoly

        poly = ErrorPoly(*self.errorpoly) if self.errorpoly is not None else None
        sigma = model.sigma_from_value(self.observation, poly)
        z = (self.observation - self.prediction) / sigma
        if self.censoring is Censor.NONE:
            return -0.5 * LOG_2PI - math.log(sigma) - 0.5 * z * z
        # host-side tails via erfc for BLOQ/ALOQ
        from math import erfc, log, sqrt

        if self.censoring is Censor.BLOQ:
            return log(max(0.5 * erfc(-z / sqrt(2.0)), 5e-324))
        return log(max(0.5 * erfc(z / sqrt(2.0)), 5e-324))

    def to_observation(self) -> Observation:
        return Observation(
            self.time,
            self.observation,
            str(self.outeq),
            self.errorpoly,
            self.occasion,
            self.censoring,
        )


class SubjectPredictions:
    """All predictions for one subject."""

    def __init__(self, predictions: Optional[List[Prediction]] = None):
        self._predictions: List[Prediction] = list(predictions or [])

    def add_prediction(self, prediction: Prediction) -> None:
        self._predictions.append(prediction)

    def predictions(self) -> List[Prediction]:
        return list(self._predictions)

    def get_predictions(self) -> List[Prediction]:
        return self.predictions()

    def flat_predictions(self) -> List[float]:
        return [p.prediction for p in self._predictions]

    def flat_times(self) -> List[float]:
        return [p.time for p in self._predictions]

    def flat_observations(self) -> List[Optional[float]]:
        return [p.observation for p in self._predictions]

    def squared_error(self) -> float:
        return float(
            sum(p.squared_error() or 0.0 for p in self._predictions if p.observation is not None)
        )

    def log_likelihood(self, error_models: AssayErrorModels, output_labels=None) -> float:
        total = 0.0
        for p in self._predictions:
            if p.observation is None:
                continue
            label = None
            if output_labels is not None:
                label = output_labels[p.outeq]
            total += p.log_likelihood(error_models, label)
        return total

    def __len__(self):
        return len(self._predictions)


class PopulationPredictions:
    """Predictions across a population: [n_subjects, n_points] of
    SubjectPredictions (subject.rs:145) — rows are subjects, columns support
    points or other groupings."""

    def __init__(self, grid):
        self.grid = np.asarray(grid, dtype=object)
        if self.grid.ndim == 1:
            self.grid = self.grid[:, None]

    @property
    def n_subjects(self) -> int:
        return self.grid.shape[0]

    @property
    def n_points(self) -> int:
        return self.grid.shape[1]

    def get(self, subject: int, point: int = 0) -> SubjectPredictions:
        return self.grid[subject, point]

    def flat_predictions(self) -> np.ndarray:
        """All prediction values, row-major over (subject, point, obs)."""
        out = []
        for row in self.grid:
            for sp in row:
                out.extend(sp.flat_predictions())
        return np.asarray(out)


def population_predictions(equation, subjects, support_points,
                           device=None) -> PopulationPredictions:
    """Simulate every subject at every support point (PopulationPredictions
    construction helper; reference builds this in PMcore), each through
    ``equation.estimate_predictions`` on ``device`` (default: the card)."""
    sp = np.asarray(support_points, dtype=np.float64)
    grid = np.empty((len(subjects), sp.shape[0]), dtype=object)
    for i, subject in enumerate(subjects):
        for j in range(sp.shape[0]):
            grid[i, j] = equation.estimate_predictions(subject, sp[j], device=device)
    return PopulationPredictions(grid)
