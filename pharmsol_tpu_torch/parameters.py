"""Named parameter ingress and dense ordering.

Parity with the reference library, src/parameters.rs and parameter_order.rs:

- ``Parameters.with_model(model, [("ka", 1.2), ...])`` validates names
  against the model's metadata and orders values densely;
- ``ParameterOrder.with_model(model, names)`` precomputes the permutation
  once for batch matrices (``order.matrix(arr)`` permutes columns).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .errors import ParameterError


class Parameters:
    """Dense model-order parameter values for one support point."""

    def __init__(self, values: Sequence[float]):
        self._values = np.asarray(list(values), dtype=np.float64)

    @staticmethod
    def with_model(model, named_parameters) -> "Parameters":
        names = []
        values = []
        for name, value in named_parameters:
            names.append(str(name))
            values.append(float(value))
        order = ParameterOrder.with_model(model, names)
        return Parameters(order.values(values))

    def as_slice(self) -> np.ndarray:
        return self._values

    def as_array(self) -> np.ndarray:
        return self._values

    def into_inner(self) -> List[float]:
        return list(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __iter__(self):
        return iter(self._values)

    def __array__(self, dtype=None):
        return np.asarray(self._values, dtype=dtype)


def dense(values: Sequence[float]) -> Parameters:
    return Parameters(values)


class ParameterOrder:
    """Validated source-name -> model-order permutation."""

    def __init__(self, permutation: List[int], width: int):
        self._permutation = list(permutation)
        self._width = width

    @staticmethod
    def with_model(model, source_names: Sequence[str]) -> "ParameterOrder":
        metadata = getattr(model, "metadata", None)
        metadata = metadata() if callable(metadata) else metadata
        if metadata is None:
            raise ParameterError("named parameter ingress requires parameter metadata")
        model_names = metadata.parameter_names
        seen = set()
        for n in source_names:
            if n in seen:
                raise ParameterError(f"duplicate parameter `{n}`")
            seen.add(n)
            if n not in model_names:
                raise ParameterError(
                    f"unknown parameter `{n}` (available: {', '.join(model_names)})"
                )
        missing = [n for n in model_names if n not in seen]
        if missing:
            raise ParameterError(f"missing required parameter(s): {', '.join(missing)}")
        source_index = {n: i for i, n in enumerate(source_names)}
        permutation = [source_index[n] for n in model_names]
        return ParameterOrder(permutation, len(model_names))

    def permutation(self) -> List[int]:
        return list(self._permutation)

    def width(self) -> int:
        return self._width

    def is_identity(self) -> bool:
        return self._permutation == list(range(self._width))

    def values(self, source_values: Sequence[float]) -> np.ndarray:
        vals = np.asarray(source_values, dtype=np.float64)
        if vals.shape[-1] != self._width:
            raise ParameterError(
                f"parameter order expects {self._width} value(s), got {vals.shape[-1]}"
            )
        return vals[..., self._permutation]

    def matrix(self, source_values) -> np.ndarray:
        """Permute the columns of a [n_points, width] support matrix."""
        arr = np.asarray(source_values, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] != self._width:
            raise ParameterError(
                f"parameter order expects {self._width} column(s), got {arr.shape}"
            )
        if self.is_identity():
            return arr
        return arr[:, self._permutation]
