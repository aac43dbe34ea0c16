"""Stage timers.

The counterpart of the JAX package's ``utils/profiling.py``:

- ``stage(name)``: a context manager that records wall time into a
  per-process registry and labels the stage for ``torch.profiler`` timelines
  (``torch.profiler.record_function``);
- ``stage_report()``: cumulative table of recorded stages;
- ``reset_stages()``: empty the registry.

PyTorch returns from a CUDA call before the card has finished, so a stage
that brackets device work synchronises the device before it reads the clock,
at entry and at exit: pass ``device=`` (a CUDA device) for that. Without it
the stage times the host only.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch

_lock = threading.Lock()
_stages: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str, device=None) -> Iterator[None]:
    """Time a named stage; with a CUDA ``device`` the clock is read after the
    device has drained, at both ends."""
    _sync(device)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        with _lock:
            count, total = _stages[name]
            _stages[name] = (count + 1, total + dt)


def stage_counts() -> Dict[str, Tuple[int, float]]:
    """``{name: (calls, total seconds)}`` of the recorded stages."""
    with _lock:
        return dict(_stages)


def stage_report() -> str:
    with _lock:
        rows = sorted(_stages.items(), key=lambda kv: -kv[1][1])
        lines = [f"{'stage':<32} {'calls':>8} {'total_s':>10} {'mean_ms':>10}"]
        for name, (count, total) in rows:
            lines.append(
                f"{name:<32} {count:>8} {total:>10.3f} {total / count * 1e3:>10.2f}"
            )
        return "\n".join(lines)


def reset_stages() -> None:
    with _lock:
        _stages.clear()
