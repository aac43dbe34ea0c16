"""Unified error types.

Mirrors the reference's ``PharmsolError`` discipline
(LAPKB/pharmsol src/error/mod.rs): one library-wide error with contextual
helpers (unknown labels carry the available labels; solver errors carry the
subject id and named parameters).
"""

from __future__ import annotations

from typing import Sequence


class PharmsolError(Exception):
    """Base error for pharmsol-tpu and its PyTorch port."""


class UnknownLabelError(PharmsolError, KeyError):
    def __init__(self, kind: str, label: str, available: Sequence[str] = ()):
        self.kind = kind
        self.label = label
        self.available = list(available)
        hint = f" (available: {', '.join(self.available)})" if self.available else ""
        super().__init__(f"unknown {kind} label `{label}`{hint}")


def unknown_input_label(label: str, available: Sequence[str] = ()) -> UnknownLabelError:
    return UnknownLabelError("input", label, available)


def unknown_output_label(label: str, available: Sequence[str] = ()) -> UnknownLabelError:
    return UnknownLabelError("output", label, available)


class InputOutOfRangeError(PharmsolError):
    def __init__(self, input_index: int, ninput: int):
        self.input_index = input_index
        self.ninput = ninput
        super().__init__(
            f"input index {input_index} out of range for model with {ninput} drug inputs"
        )


class ErrorModelError(PharmsolError):
    pass


class MetadataError(PharmsolError):
    pass


class ParameterError(PharmsolError):
    pass


class DataError(PharmsolError):
    pass


class SolverError(PharmsolError):
    def __init__(self, message: str, subject_id: str | None = None, parameters=None):
        self.subject_id = subject_id
        self.parameters = parameters
        ctx = ""
        if subject_id is not None:
            ctx = f" [subject `{subject_id}`"
            if parameters is not None:
                ctx += f", parameters {parameters}"
            ctx += "]"
        super().__init__(message + ctx)
