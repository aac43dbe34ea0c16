"""Maximum-effect (E2) optimization for dual-site PD models.

Parity with the reference library, src/optimize/effect.rs: find the concentration
``xm`` solving ``a/xm^h1 + b/xm^h2 + w/xm^((h1+h2)/2) = 1`` by minimizing
the squared residual over ln(xm) with Nelder-Mead; single-site closed forms
``xm = a^(1/h1)`` / ``b^(1/h2)``; iterative ``find_m0`` continuation
fallback; effect = xm / (xm + 1).
"""

from __future__ import annotations

import math

from .nelder_mead import nelder_mead


def _effect_from_xm(xm: float) -> float:
    return xm / (xm + 1.0)


def _cost_factory(a, b, w, h1, h2, xx):
    def cost(y_arr):
        y = float(y_arr[0])
        xm = math.exp(y)
        if not (math.isfinite(xm) and xm > 0.0):
            return 1.0e100
        try:
            t1 = 0.0 if a == 0.0 else a / xm**h1
            t2 = 0.0 if b == 0.0 else b / xm**h2
            t3 = 0.0 if w == 0.0 else w / xm**xx
        except (OverflowError, ZeroDivisionError):
            return 1.0e100
        if not all(map(math.isfinite, (t1, t2, t3))):
            return 1.0e100
        val = (1.0 - t1 - t2 - t3) ** 2
        return val if math.isfinite(val) else 1.0e100

    return cost


def _get_best(cost, start_log: float, step_log: float):
    second = start_log + step_log
    if not math.isfinite(second) or abs(second - start_log) < 1e-12:
        simplex = [[start_log], [start_log + 0.1]]
    else:
        simplex = [[start_log], [second]]
    res = nelder_mead(cost, simplex, sd_tolerance=1e-8, max_iters=1000)
    return math.exp(float(res.best_param[0])), res.best_cost, res.converged


def find_m0(afinal: float, b: float, alpha: float, h1: float, h2: float) -> float:
    """Continuation estimator (effect.rs:125-157): integrate dxm/da from
    a=0 (where xm solves the b-only equation) up to a=afinal."""
    noint = 1000
    del_a = afinal / noint
    xm = b ** (1.0 / h2) if b > 0.0 else 1.0
    a = 0.0
    hh = (h1 + h2) / 2.0
    for i in range(1, noint + 1):
        if xm <= 0.0 or not math.isfinite(xm):
            return -1.0
        top = 1.0 / xm**h1 + alpha * b / xm**hh
        b1 = a * h1 / xm ** (h1 + 1.0)
        b2 = b * h2 / xm ** (h2 + 1.0)
        b3 = alpha * a * b * hh / xm ** (hh + 1.0)
        denom = b1 + b2 + b3
        if denom == 0.0 or not math.isfinite(denom):
            return -1.0
        xm += (top / denom) * del_a
        if not (math.isfinite(xm) and xm > 0.0):
            return -1.0
        a = del_a * i
    return xm


def get_e2(a: float, b: float, w: float, h1: float, h2: float, alpha_s: float) -> float:
    """Maximum achievable dual-site effect in [0, 1)."""
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return 0.0
    xx = (h1 + h2) / 2.0
    cost = _cost_factory(a, b, w, h1, h2, xx)

    if b <= 0.0 and a > 0.0:
        return _effect_from_xm(a ** (1.0 / h1))
    if a <= 0.0 and b > 0.0:
        return _effect_from_xm(b ** (1.0 / h2))

    xm_guess = b ** (1.0 / h2) if b > 0.0 else (a ** (1.0 / h1) if a > 0.0 else 1.0)
    start_log = math.log(max(xm_guess, 1e-12))
    try:
        xm1, val1, conv1 = _get_best(cost, start_log, 0.1)
    except Exception:
        xm0 = find_m0(a, b, alpha_s, h1, h2)
        if xm0 > 0.0:
            return _effect_from_xm(xm0)
        if a > 0.0:
            return _effect_from_xm(a ** (1.0 / h1))
        if b > 0.0:
            return _effect_from_xm(b ** (1.0 / h2))
        return 0.0

    if conv1 or val1 < 1e-10:
        return _effect_from_xm(xm1)

    xm0 = find_m0(a, b, alpha_s, h1, h2)
    if xm0 < 0.0:
        return _effect_from_xm(xm1)
    xm2, val2, conv2 = _get_best(cost, math.log(xm0), 0.1)
    if conv2 and val2 < val1:
        return _effect_from_xm(xm2)
    return _effect_from_xm(xm1)
