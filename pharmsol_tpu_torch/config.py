"""Global numeric configuration for the PyTorch port: dtype and device.

- The working float dtype defaults to float64 on every device (the H100 has
  native f64). Set float32 explicitly for throughput runs, as the JAX
  package's ``bench.py`` does.
- The entry points run on the card: :func:`device` defaults to ``"cuda"``.
  The CPU is asked for with ``set_device("cpu")`` or ``device="cpu"`` (every
  entry point takes ``device=``). On a machine without a card the default
  raises instead of running on the CPU.
"""

from __future__ import annotations

import torch

from .errors import PharmsolError

# Sentinel used for padded event times: sorts after any real time but stays
# finite (also in float32) so arithmetic on padded rows never produces NaN.
BIG_TIME = 1e30

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_FLOAT_DTYPE = torch.float64
_DEVICE = torch.device("cuda")


def set_float_dtype(dtype) -> None:
    """Set the working float dtype: float32 or float64, given as a torch or
    numpy dtype or its name."""
    global _FLOAT_DTYPE
    name = str(getattr(dtype, "__name__", dtype)).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported float dtype {dtype}; use float32 or float64")
    _FLOAT_DTYPE = _DTYPES[name]


def float_dtype() -> torch.dtype:
    """The working float dtype for engine tensors (default float64)."""
    return _FLOAT_DTYPE


def int_dtype() -> torch.dtype:
    """The integer dtype of the index streams a kernel reads (int32, as the
    JAX package's ``config.int_dtype``); torch's own indexing (``gather``,
    ``index_add_``) keeps int64."""
    return torch.int32


def set_device(dev) -> None:
    """Set the default device of the entry points (default ``"cuda"``)."""
    global _DEVICE
    _DEVICE = resolve_device(dev)


def device() -> torch.device:
    """The default device of the entry points."""
    return _DEVICE


def resolve_device(dev=None) -> torch.device:
    """``dev`` (or the configured default) as a torch.device.

    Raises PharmsolError for a CUDA device (the default) when no card is
    present: the port never quietly runs on the CPU what was asked of the
    GPU.
    """
    d = _DEVICE if dev is None else torch.device(dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise PharmsolError(
            f"device `{d}` requested but torch.cuda.is_available() is False"
        )
    if d.type not in ("cpu", "cuda"):
        raise PharmsolError(f"unsupported device `{d}` (cpu or cuda)")
    return d
