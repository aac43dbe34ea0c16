"""Residual (prediction-based) error models for parametric algorithms.

Parity with LAPKB/pharmsol src/data/residual_error.rs:69-220 and the JAX
package's ``data/residual_error.py``:

- Constant:     sigma = a
- Proportional: sigma = b * |f|
- Combined:     sigma = sqrt(a² + b²·f²)
- Exponential:  sigma = s (log scale)

sigma is floored at sqrt(machine eps) (residual_error.rs cutoff), and
``log_likelihood`` is the plain normal log-density. These are the surfaces a
SAEM/FOCE layer consumes. The per-model math takes a Python float (and
returns one) or a torch tensor (and returns a tensor of its shape);
:func:`residual_sigma_array` is the same formula over dense per-observation
tensors, for the batched likelihood (``likelihood/matrix.py::
log_likelihood_batch``).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

_EPS = float(np.finfo(np.float64).eps)
_CUTOFF = math.sqrt(_EPS)
_LOG_TAU = math.log(2.0 * math.pi)


class ResidualKind(enum.Enum):
    CONSTANT = "constant"
    PROPORTIONAL = "proportional"
    COMBINED = "combined"
    EXPONENTIAL = "exponential"


@dataclass(frozen=True)
class ResidualErrorModel:
    kind: ResidualKind
    a: float = 0.0
    b: float = 0.0

    # -- constructors ------------------------------------------------------
    @staticmethod
    def constant(a: float) -> "ResidualErrorModel":
        return ResidualErrorModel(ResidualKind.CONSTANT, a=a)

    @staticmethod
    def proportional(b: float) -> "ResidualErrorModel":
        return ResidualErrorModel(ResidualKind.PROPORTIONAL, b=b)

    @staticmethod
    def combined(a: float, b: float) -> "ResidualErrorModel":
        return ResidualErrorModel(ResidualKind.COMBINED, a=a, b=b)

    @staticmethod
    def exponential(sigma: float) -> "ResidualErrorModel":
        return ResidualErrorModel(ResidualKind.EXPONENTIAL, a=sigma)

    @staticmethod
    def default() -> "ResidualErrorModel":
        return ResidualErrorModel.constant(1.0)

    # -- math (Python floats or torch tensors) -------------------------------
    def sigma(self, prediction):
        if isinstance(prediction, torch.Tensor):
            f = prediction
            if self.kind is ResidualKind.PROPORTIONAL:
                raw = self.b * torch.abs(f)
            elif self.kind is ResidualKind.COMBINED:
                raw = torch.sqrt(self.a**2 + self.b**2 * f**2)
            else:  # constant, and exponential: constant on the log scale
                raw = torch.full_like(f, self.a)
            return torch.clamp(raw, min=_CUTOFF)
        f = float(prediction)
        if self.kind is ResidualKind.PROPORTIONAL:
            raw = self.b * abs(f)
        elif self.kind is ResidualKind.COMBINED:
            raw = math.sqrt(self.a**2 + self.b**2 * f**2)
        else:
            raw = self.a
        return max(raw, _CUTOFF)

    def variance(self, prediction):
        s = self.sigma(prediction)
        return s * s

    def weighted_squared_residual(self, observation, prediction):
        """Normalized residual for SAEM M-step sigma updates."""
        r2 = (observation - prediction) ** 2
        if self.kind is ResidualKind.PROPORTIONAL:
            den = prediction**2
        elif self.kind is ResidualKind.COMBINED:
            den = self.a**2 + self.b**2 * prediction**2
        else:
            return r2
        if isinstance(den, torch.Tensor):
            return r2 / torch.clamp(den, min=_EPS)
        return r2 / max(den, _EPS)

    def log_likelihood(self, observation, prediction):
        s = self.sigma(prediction)
        z = (observation - prediction) / s
        log_s = torch.log(s) if isinstance(s, torch.Tensor) else math.log(s)
        return -0.5 * (_LOG_TAU + 2.0 * log_s + z * z)

    def with_updated_sigma(self, new_sigma: float) -> "ResidualErrorModel":
        if self.kind is ResidualKind.CONSTANT:
            return ResidualErrorModel.constant(new_sigma)
        if self.kind is ResidualKind.PROPORTIONAL:
            return ResidualErrorModel.proportional(new_sigma)
        if self.kind is ResidualKind.COMBINED:
            return ResidualErrorModel.combined(new_sigma, self.b)
        return ResidualErrorModel.exponential(new_sigma)


# Dense kind codes for the lowered arrays.
RESIDUAL_KIND_CODE = {
    ResidualKind.CONSTANT: 1,
    ResidualKind.PROPORTIONAL: 2,
    ResidualKind.COMBINED: 3,
    ResidualKind.EXPONENTIAL: 4,
}


@dataclass
class LoweredResidualModels:
    """Dense per-outeq arrays for the batched likelihood."""

    kind: "np.ndarray"  # [nout] int32; 0 = no model (-> -inf, parity with mod.rs:132)
    a: "np.ndarray"  # [nout]
    b: "np.ndarray"  # [nout]


class ResidualErrorModels:
    """Per-outeq residual error models with total-log-likelihood helpers.

    An observation whose outeq has no model makes the total -inf
    (residual_error.rs:124-136).
    """

    def __init__(self):
        self._models: Dict[str, ResidualErrorModel] = {}

    def add(self, outeq, model: ResidualErrorModel) -> "ResidualErrorModels":
        self._models[str(outeq)] = model
        return self

    def get(self, outeq) -> Optional[ResidualErrorModel]:
        return self._models.get(str(outeq))

    def __len__(self) -> int:
        """Number of bound output models (residual_error.rs ``len``)."""
        return len(self._models)

    def sigma(self, outeq, prediction):
        """Sigma for one output at a prediction (residual_error.rs
        ``sigma``); raises KeyError for an unbound output."""
        m = self._models.get(str(outeq))
        if m is None:
            raise KeyError(f"no residual error model for output {outeq!r}")
        return m.sigma(prediction)

    def labels(self) -> List[str]:
        return list(self._models.keys())

    def total_log_likelihood(self, obs_pred_pairs) -> float:
        """``obs_pred_pairs``: iterable of (outeq_label, observation, prediction)."""
        total = 0.0
        for label, obs, pred in obs_pred_pairs:
            m = self._models.get(str(label))
            if m is None:
                return float("-inf")
            if obs is None:
                continue
            total += float(m.log_likelihood(obs, pred))
        return total

    def lower(self, output_resolver, nout: int) -> LoweredResidualModels:
        kind = np.zeros((nout,), dtype=np.int32)
        a = np.zeros((nout,), dtype=np.float64)
        b = np.zeros((nout,), dtype=np.float64)
        for label, m in self._models.items():
            idx = output_resolver(label)
            if idx is None or idx < 0 or idx >= nout:
                raise ValueError(
                    f"residual-model label `{label}` does not resolve to an output slot"
                )
            kind[idx] = RESIDUAL_KIND_CODE[m.kind]
            a[idx] = m.a
            b[idx] = m.b
        return LoweredResidualModels(kind=kind, a=a, b=b)


def residual_sigma_array(kind, a, b, pred):
    """Residual sigma over dense tensors: ``kind``/``a``/``b`` per
    observation (already gathered by outeq), ``pred`` the predictions."""
    raw = torch.where(
        kind == 1,
        a,
        torch.where(
            kind == 2,
            b * torch.abs(pred),
            torch.where(kind == 3, torch.sqrt(a**2 + b**2 * pred**2), a),
        ),
    )
    return torch.clamp(raw, min=_CUTOFF)
