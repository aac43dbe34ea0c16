"""Trapezoidal AUC/AUMC primitives.

Functional parity with LAPKB/pharmsol src/data/auc.rs:67-391:

- methods: linear, lin-up/log-down, lin-log (tmax-aware);
- log rule applies when c2 < c1, both positive, and |c1/c2 - 1| >= 1e-10;
- log AUMC uses the PKNCA formula;
- ``auc_interval`` interpolates linearly at the boundary cut points;
- ``interpolate_linear`` clamps to boundary values.

Implemented with vectorized numpy over segment arrays: each profile's
segments are computed in one shot rather than the reference's per-segment
loop.
"""

from __future__ import annotations

import numpy as np

from ..errors import DataError
from .event import AUCMethod


class ObservationError(DataError):
    pass


def _validate(times, values, min_len=2):
    times = np.asarray(times, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if times.shape != values.shape:
        raise ObservationError(
            f"times ({times.shape[0]}) and values ({values.shape[0]}) length mismatch"
        )
    if times.shape[0] < min_len:
        raise ObservationError(
            f"insufficient data: {times.shape[0]} points, need {min_len}"
        )
    return times, values


def _tmax(times, values) -> float:
    return float(times[int(np.argmax(values))])


def _segment_areas(t1, c1, t2, c2, tmax, method: AUCMethod, moment: bool):
    """Vectorized per-segment AUC (or AUMC when ``moment``)."""
    dt = t2 - t1
    lin = (t1 * c1 + t2 * c2) / 2.0 * dt if moment else (c1 + c2) / 2.0 * dt
    use_log = (c2 < c1) & (c1 > 0.0) & (c2 > 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(use_log, c1 / np.where(c2 > 0, c2, 1.0), 1.0)
        use_log = use_log & (np.abs(ratio - 1.0) >= 1e-10)
        logr = np.log(np.where(use_log, ratio, np.e))
        if moment:
            k = logr / np.where(dt != 0, dt, 1.0)
            logv = (t1 * c1 - t2 * c2) / k + (c1 - c2) / (k * k)
        else:
            logv = (c1 - c2) * dt / logr
    if method is AUCMethod.LINEAR:
        return lin
    if method is AUCMethod.LIN_UP_LOG_DOWN:
        return np.where(use_log, logv, lin)
    # LIN_LOG: linear up to and at tmax, log for descending after tmax
    return np.where((t2 <= tmax) | ~use_log, lin, logv)


def auc(times, values, method: AUCMethod = AUCMethod.LINEAR) -> float:
    """Total AUC from first to last time point (auc.rs:178)."""
    t, v = _validate(times, values)
    tm = _tmax(t, v)
    areas = _segment_areas(t[:-1], v[:-1], t[1:], v[1:], tm, method, moment=False)
    if np.any(np.diff(t) <= 0):
        raise ObservationError("invalid time sequence (non-increasing times)")
    return float(np.sum(areas))


def aumc(times, values, method: AUCMethod = AUCMethod.LINEAR) -> float:
    """Total AUMC (first moment) from first to last time point."""
    t, v = _validate(times, values)
    tm = _tmax(t, v)
    if np.any(np.diff(t) <= 0):
        raise ObservationError("invalid time sequence (non-increasing times)")
    areas = _segment_areas(t[:-1], v[:-1], t[1:], v[1:], tm, method, moment=True)
    return float(np.sum(areas))


def interpolate_linear(times, values, time: float) -> float:
    """Linear interpolation clamped to boundary values (auc.rs:319)."""
    t, v = _validate(times, values, min_len=1)
    if time <= t[0]:
        return float(v[0])
    if time >= t[-1]:
        return float(v[-1])
    upper = int(np.searchsorted(t, time, side="left"))
    lower = max(upper - 1, 0)
    t1, t2 = t[lower], t[upper]
    if abs(t2 - t1) < 1e-10:
        return float(v[lower])
    return float(v[lower] + (v[upper] - v[lower]) * (time - t1) / (t2 - t1))


def auc_interval(
    times, values, start: float, end: float, method: AUCMethod = AUCMethod.LINEAR
) -> float:
    """Partial AUC over [start, end], interpolating at the boundaries."""
    t, v = _validate(times, values)
    if end < start:
        raise ObservationError("invalid time sequence (end < start)")
    if end == start:
        return 0.0
    tm = _tmax(t, v)
    total = 0.0
    for i in range(1, len(t)):
        t1, t2 = float(t[i - 1]), float(t[i])
        if t2 <= start or t1 >= end:
            continue
        seg_start = max(t1, start)
        seg_end = min(t2, end)
        c1 = interpolate_linear(t, v, start) if t1 < start else float(v[i - 1])
        c2 = interpolate_linear(t, v, end) if t2 > end else float(v[i])
        total += float(
            _segment_areas(
                np.float64(seg_start),
                np.float64(c1),
                np.float64(seg_end),
                np.float64(c2),
                tm,
                method,
                moment=False,
            )
        )
    return total


def auc_segment(t1, c1, t2, c2, method: AUCMethod = AUCMethod.LINEAR) -> float:
    """Single-segment AUC; LinLog degrades to linear without tmax context."""
    if t2 - t1 <= 0:
        raise ObservationError("invalid time sequence")
    m = AUCMethod.LINEAR if method is AUCMethod.LIN_LOG else method
    return float(
        _segment_areas(
            np.float64(t1), np.float64(c1), np.float64(t2), np.float64(c2),
            np.float64(t2), m, moment=False,
        )
    )
