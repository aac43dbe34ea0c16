"""Stage timers.

The counterpart of the JAX package's ``utils/profiling.py``:

- ``stage(name)``: a context manager that records wall time into a
  per-process registry and labels the stage for ``torch.profiler`` timelines
  (``torch.profiler.record_function``);
- ``profile_trace(log_dir)``: one ``torch.profiler`` capture (CPU and, on
  a machine with a card, CUDA activities) written into ``log_dir`` as a
  Chrome/Perfetto trace file;
- ``stage_report()``: cumulative table of recorded stages;
- ``reset_stages()``: empty the registry.

PyTorch returns from a CUDA call before the card has finished, so a stage
that brackets device work synchronises the device before it reads the clock,
at entry and at exit: pass ``device=`` (a CUDA device) for that. Without it
the stage times the host only.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch

from ..errors import PharmsolError

_lock = threading.Lock()
_stages: Dict[str, Tuple[int, float]] = defaultdict(lambda: (0, 0.0))
_traces = 0


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


class TraceCapture:
    """What :func:`profile_trace` captured: ``path`` is the trace file it
    wrote on exit, ``profiler`` the ``torch.profiler.profile`` object (its
    ``events()`` and ``key_averages()`` read the same capture)."""

    def __init__(self, profiler, path: str):
        self.profiler, self.path = profiler, path


@contextlib.contextmanager
def profile_trace(log_dir: str, create_perfetto_link: bool = False
                  ) -> Iterator[TraceCapture]:
    """Capture a trace of the enclosed work into ``log_dir``.

    The JAX package's ``profile_trace`` wraps ``jax.profiler.trace``. Here it
    is one ``torch.profiler.profile`` over the CPU and, where a card is
    present, its CUDA activities; on exit the device is synchronised and the
    capture is written as one Chrome/Perfetto trace file
    (``trace_<pid>_<n>.json``, opened by ui.perfetto.dev or
    chrome://tracing). Yields a :class:`TraceCapture`.

    ``create_perfetto_link=True`` asks the JAX profiler to upload the trace
    and print a link to it, which needs the network; the port raises
    PharmsolError for it instead of reaching out.
    """
    if create_perfetto_link:
        raise PharmsolError(
            "profile_trace(create_perfetto_link=True) uploads the trace over the "
            "network; the port only writes the trace file: open it in "
            "ui.perfetto.dev")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    global _traces
    with _lock:
        _traces += 1
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{_traces}.json")
    prof = torch.profiler.profile(activities=acts)
    capture = TraceCapture(prof, path)
    with prof:
        yield capture
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


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
