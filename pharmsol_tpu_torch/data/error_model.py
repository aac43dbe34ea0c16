"""Assay (observation-based) error models.

Parity with LAPKB/pharmsol src/data/error_model.rs:

- ``ErrorPoly(c0..c3)``: alpha = c0 + c1*obs + c2*obs^2 + c3*obs^3 —
  **observation-based** (error_model.rs:1060-1072);
- ``additive``:     sigma = sqrt(alpha^2 + lambda^2)
- ``proportional``: sigma = gamma * alpha
- ``Factor`` fixed/variable drives "should this factor be optimized"
  (error_model.rs:17-43, :1140-1148);
- per-observation ErrorPoly overrides take precedence over the model default.

The host-side classes mirror the reference API; :meth:`AssayErrorModels.lower`
packs everything into dense per-outeq arrays for the batched likelihood path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..errors import ErrorModelError

# Dense kind codes used by the lowered arrays.
KIND_NONE = 0
KIND_ADDITIVE = 1
KIND_PROPORTIONAL = 2


@dataclass(frozen=True)
class ErrorPoly:
    """Assay error polynomial: error = c0 + c1*obs + c2*obs² + c3*obs³."""

    c0: float
    c1: float = 0.0
    c2: float = 0.0
    c3: float = 0.0

    def coefficients(self) -> tuple:
        return (self.c0, self.c1, self.c2, self.c3)

    def __call__(self, obs: float) -> float:
        return self.c0 + self.c1 * obs + self.c2 * obs**2 + self.c3 * obs**3


@dataclass
class Factor:
    """Scaling factor (lambda/gamma) with fixed/variable optimization state."""

    value: float
    fixed: bool = False

    @staticmethod
    def variable(value: float) -> "Factor":
        return Factor(value, fixed=False)

    @staticmethod
    def fixed_at(value: float) -> "Factor":
        return Factor(value, fixed=True)

    def is_fixed(self) -> bool:
        return self.fixed

    def is_variable(self) -> bool:
        return not self.fixed


class AssayErrorModel:
    """Per-output-equation assay error model (Additive/Proportional/None)."""

    def __init__(self, kind: int, factor: Optional[Factor], poly: Optional[ErrorPoly]):
        self.kind = kind
        self.factor_param = factor
        self.poly = poly

    # -- constructors (reference API parity) ---------------------------------
    @staticmethod
    def additive(poly: ErrorPoly, lam: float) -> "AssayErrorModel":
        return AssayErrorModel(KIND_ADDITIVE, Factor.variable(lam), poly)

    @staticmethod
    def additive_fixed(poly: ErrorPoly, lam: float) -> "AssayErrorModel":
        return AssayErrorModel(KIND_ADDITIVE, Factor.fixed_at(lam), poly)

    @staticmethod
    def proportional(poly: ErrorPoly, gamma: float) -> "AssayErrorModel":
        return AssayErrorModel(KIND_PROPORTIONAL, Factor.variable(gamma), poly)

    @staticmethod
    def proportional_fixed(poly: ErrorPoly, gamma: float) -> "AssayErrorModel":
        return AssayErrorModel(KIND_PROPORTIONAL, Factor.fixed_at(gamma), poly)

    @staticmethod
    def none() -> "AssayErrorModel":
        return AssayErrorModel(KIND_NONE, None, None)

    # -- queries ---------------------------------------------------------------
    def is_additive(self) -> bool:
        return self.kind == KIND_ADDITIVE

    def is_proportional(self) -> bool:
        return self.kind == KIND_PROPORTIONAL

    def is_none(self) -> bool:
        return self.kind == KIND_NONE

    def errorpoly(self) -> ErrorPoly:
        if self.poly is None:
            raise ErrorModelError("error model has no polynomial (None variant)")
        return self.poly

    def factor(self) -> float:
        if self.factor_param is None:
            raise ErrorModelError("error model has no factor (None variant)")
        return self.factor_param.value

    def set_factor(self, value: float) -> None:
        if self.factor_param is None:
            raise ErrorModelError("error model has no factor (None variant)")
        self.factor_param.value = float(value)

    def optimize(self) -> bool:
        """Should the factor be optimized? (non-None and variable)."""
        return self.factor_param is not None and self.factor_param.is_variable()

    def sigma_from_value(self, value: float, poly: Optional[ErrorPoly] = None) -> float:
        """Observation-based sigma (error_model.rs:1060-1072)."""
        if self.kind == KIND_NONE:
            raise ErrorModelError("output equation has error model None")
        p = poly if poly is not None else self.errorpoly()
        alpha = p(value)
        if self.kind == KIND_ADDITIVE:
            sigma = float(np.sqrt(alpha**2 + self.factor() ** 2))
        else:
            sigma = self.factor() * alpha
        if sigma < 0.0:
            raise ErrorModelError("computed sigma is negative")
        if not np.isfinite(sigma):
            raise ErrorModelError("computed sigma is non-finite")
        return sigma

    def variance_from_value(self, value: float) -> float:
        return self.sigma_from_value(value) ** 2


class AssayErrorModels:
    """Label-keyed collection of per-outeq assay error models.

    Labels are bound to dense outeq indices by the model's metadata (or
    interpreted as bare numeric indices in the no-metadata path), mirroring
    error_model.rs:150-460.
    """

    def __init__(self):
        self._models: Dict[str, AssayErrorModel] = {}

    @staticmethod
    def empty() -> "AssayErrorModels":
        return AssayErrorModels()

    @staticmethod
    def with_output_names(names: Sequence[str]) -> "AssayErrorModels":
        ems = AssayErrorModels()
        for n in names:
            ems._models[str(n)] = AssayErrorModel.none()
        return ems

    def add(self, outeq, model: AssayErrorModel) -> "AssayErrorModels":
        self._models[str(outeq)] = model
        return self

    def get(self, outeq) -> Optional[AssayErrorModel]:
        return self._models.get(str(outeq))

    def labels(self) -> List[str]:
        return list(self._models.keys())

    def __len__(self) -> int:
        return len(self._models)

    def items(self):
        return self._models.items()

    # -- per-output accessors (error_model.rs:473-626) -----------------------
    def _model_or_raise(self, outeq) -> AssayErrorModel:
        m = self._models.get(str(outeq))
        if m is None:
            raise ErrorModelError(f"no error model for output `{outeq}`")
        if m.is_none():
            raise ErrorModelError(f"output `{outeq}` has error model None")
        return m

    def errorpoly(self, outeq) -> ErrorPoly:
        return self._model_or_raise(outeq).errorpoly()

    def set_errorpoly(self, outeq, poly: ErrorPoly) -> None:
        self._model_or_raise(outeq).poly = poly

    def factor(self, outeq) -> float:
        return self._model_or_raise(outeq).factor()

    def set_factor(self, outeq, value: float) -> None:
        self._model_or_raise(outeq).set_factor(value)

    def factor_param(self, outeq) -> Factor:
        return self._model_or_raise(outeq).factor_param

    def is_factor_fixed(self, outeq) -> bool:
        return self._model_or_raise(outeq).factor_param.is_fixed()

    def fix_factor(self, outeq) -> None:
        self._model_or_raise(outeq).factor_param.fixed = True

    def unfix_factor(self, outeq) -> None:
        self._model_or_raise(outeq).factor_param.fixed = False

    def sigma(self, prediction) -> float:
        """Observation-based sigma for a host-side Prediction object."""
        m = self._model_or_raise(prediction.outeq)
        poly = ErrorPoly(*prediction.errorpoly) if prediction.errorpoly else None
        if prediction.observation is None:
            raise ErrorModelError("prediction has no observation")
        return m.sigma_from_value(prediction.observation, poly)

    def content_hash(self) -> str:
        h = hashlib.blake2b(digest_size=8)
        for label in sorted(self._models):
            m = self._models[label]
            h.update(label.encode())
            h.update(bytes([m.kind]))
            if m.poly is not None:
                for c in m.poly.coefficients():
                    h.update(np.float64(c).tobytes())
            if m.factor_param is not None:
                h.update(np.float64(m.factor_param.value).tobytes())
                h.update(b"F" if m.factor_param.fixed else b"V")
        return h.hexdigest()

    # -- lowering ------------------------------------------------------------
    def lower(self, output_resolver, nout: int) -> "LoweredErrorModels":
        """Bind labels to dense outeq slots and pack into arrays.

        ``output_resolver(label) -> int`` maps a public label to its dense
        output index (metadata-aware or numeric fallback).
        """
        kind = np.zeros((nout,), dtype=np.int32)
        factor = np.zeros((nout,), dtype=np.float64)
        poly = np.zeros((nout, 4), dtype=np.float64)
        for label, m in self._models.items():
            idx = output_resolver(label)
            if idx is None or idx < 0 or idx >= nout:
                raise ErrorModelError(
                    f"error-model label `{label}` does not resolve to an output slot"
                )
            kind[idx] = m.kind
            if m.factor_param is not None:
                factor[idx] = m.factor_param.value
            if m.poly is not None:
                poly[idx] = m.poly.coefficients()
        return LoweredErrorModels(kind=kind, factor=factor, poly=poly)


@dataclass
class LoweredErrorModels:
    """Dense per-outeq arrays for the batched likelihood path."""

    kind: np.ndarray  # [nout] int32 in {0 none, 1 additive, 2 proportional}
    factor: np.ndarray  # [nout] lambda or gamma
    poly: np.ndarray  # [nout, 4] default error polynomial
