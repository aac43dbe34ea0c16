"""Event-segmented explicit Runge-Kutta steppers for the general ODE engine.

The counterpart of the JAX package's ``engine/ode.py`` for its explicit tier.
The event grid already splits the timeline at every discontinuity, so the
right-hand side is smooth within a segment (constant infusion rate) and each
segment is one clean initial-value problem.

- ``dopri5`` / ``tsit5``: embedded 5(4) pairs (Dormand-Prince, Tsitouras
  2011) with FSAL, adaptive I-controller, stall guard, and NaN poisoning of a
  lane whose step budget runs out (the population layer turns it into -inf).
- kvaerno3/5, esdirk34, trbdf2, bdf and expm are solvers of the JAX package
  that the port does not have yet: asking for one raises PharmsolError.

The JAX package vmaps a per-lane ``lax.while_loop``; here one masked Python
loop runs over all lanes at once (``x`` is ``[*lanes, n]``): every trial
computes the step on every lane, and only the lanes whose loop condition
holds take its result. The loop ends when no lane is active. Per lane this is
the JAX loop step for step (``unroll`` 1, its CPU setting), so the two agree
to rounding. Default tolerances follow ode/mod.rs:40-41 (rtol = atol = 1e-4,
h0 = 1e-3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ..errors import PharmsolError
from .sim import as_vector

DEFAULT_RTOL = 1e-4
DEFAULT_ATOL = 1e-4
DEFAULT_H0 = 1e-3
DEFAULT_MAX_STEPS = 10_000

# Dormand-Prince 5(4) Butcher tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600,
    0.0,
    7571 / 16695,
    393 / 640,
    -92097 / 339200,
    187 / 2100,
    1 / 40,
)
_DP_E = tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4))

# Tsitouras 5(4) tableau (Tsitouras 2011), FSAL like DP5.
_TS_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TS_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
_TS_B = _TS_A[6] + (0.0,)
# error weights (b - bhat): err = h * sum(e_i k_i)
_TS_E = (
    -0.00178001105222577714,
    -0.0008164344596567469,
    0.007880878010261995,
    -0.1447110071732629,
    0.5823571654525552,
    -0.45808210592918697,
    0.015151515151515152,
)

# (A, B, E, C) of the explicit solvers the port has.
TABLEAUS = {
    "dopri5": (_DP_A, _DP_B5, _DP_E, _DP_C),
    "tsit5": (_TS_A, _TS_B, _TS_E, _TS_C),
}
# Solvers of the JAX package (engine/ode.py _SEGMENT_SOLVERS) not ported yet.
UNPORTED_SOLVERS = ("kvaerno3", "kvaerno5", "esdirk34", "trbdf2", "bdf",
                    "expm", "expm_rolled")


class ODEOptions(NamedTuple):
    rtol: float = DEFAULT_RTOL
    atol: float = DEFAULT_ATOL
    h0: float = DEFAULT_H0
    max_steps: int = DEFAULT_MAX_STEPS
    solver: str = "dopri5"
    # kept for the JAX package's builder API (implicit solvers); unused by
    # the explicit tier
    newton_iters: int = 6


def check_solver(solver: str):
    """The (A, B, E, C) tableau of ``solver``; raises PharmsolError for a
    solver the port does not have."""
    if solver in TABLEAUS:
        return TABLEAUS[solver]
    if solver in UNPORTED_SOLVERS:
        raise PharmsolError(
            f"ODE solver `{solver}` is not ported to the PyTorch package yet "
            f"(ROADMAP Queue 1 item 8; available: {', '.join(TABLEAUS)})"
        )
    raise PharmsolError(
        f"unknown ODE solver `{solver}` (available: {', '.join(TABLEAUS)})"
    )


def _error_ratio(err, x0, x1, rtol, atol):
    scale = atol + rtol * torch.maximum(torch.abs(x0), torch.abs(x1))
    return torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))


def _done_threshold(t1):
    return t1 - 1e-14 * torch.clamp(torch.abs(t1), min=1.0)


def _poison_if_unfinished(x, t_end, t1):
    """NaN the state where the step budget ran out before reaching t1 (the
    population layer maps the NaN to a -inf cell)."""
    done = t_end >= _done_threshold(t1)
    return torch.where(done[..., None], x, torch.full_like(x, float("nan")))


def _h_stalled(h, t):
    """True where the step can no longer advance the clock (t + h == t): a
    lane whose dynamics went non-finite shrinks h forever otherwise."""
    return (t + h) <= t


def _resolve_h_start(h_start, span, opts: ODEOptions):
    """Initial step: the carried ``h_start`` where it is positive and finite,
    else ``h0``; clipped to the segment span."""
    h_default = torch.full_like(span, opts.h0)
    if h_start is not None:
        h_default = torch.where(torch.isfinite(h_start) & (h_start > 0.0),
                                h_start, h_default)
    return torch.minimum(h_default, torch.clamp(span, min=1e-14))


def _erk_segment(f: Callable, x0, t0, t1, opts: ODEOptions, A, B, E, C,
                 h_start=None):
    """Adaptive embedded RK with FSAL over every lane.

    ``x0`` [*lanes, n]; ``t0``, ``t1`` [*lanes]; ``f(x, t)`` evaluates the
    RHS on all lanes. Returns ``(x_end, h_cruise)``: the state at ``t1``
    (NaN where the step budget ran out) and the largest accepted step, the
    warm start of the next segment.
    """
    n_stages = len(C)
    t_done = _done_threshold(t1)

    def one_step(x, t, h, k1):
        hh = h[..., None]
        ks = [k1]
        for i in range(1, n_stages):
            xi = x
            for j, aij in enumerate(A[i]):
                if aij != 0.0:
                    xi = xi + hh * aij * ks[j]
            ks.append(f(xi, t + C[i] * h))
        x_new = x
        for bi, k in zip(B, ks):
            if bi != 0.0:
                x_new = x_new + hh * bi * k
        err = torch.zeros_like(x)
        for ei, k in zip(E, ks):
            if ei != 0.0:
                err = err + hh * ei * k
        return x_new, err, ks[-1]

    def cond(t, h, steps):
        return (t < t_done) & (steps < opts.max_steps) & ~_h_stalled(h, t)

    h = _resolve_h_start(h_start, t1 - t0, opts)
    t = t0 + torch.zeros_like(h)
    x = x0
    k1 = f(x0, t)
    steps = torch.zeros(h.shape, dtype=torch.int64, device=h.device)
    hmax = h
    active = cond(t, h, steps)
    while bool(active.any()):
        done = t >= t_done
        h_try = torch.minimum(h, torch.clamp(t1 - t, min=1e-14))
        x_new, err, k_last = one_step(x, t, h_try, k1)
        ratio = _error_ratio(err, x, x_new, opts.rtol, opts.atol)
        finite = torch.isfinite(x_new).all(dim=-1) & torch.isfinite(ratio)
        accept = active & (ratio <= 1.0) & finite & ~done
        factor = torch.where(
            finite,
            torch.clamp(0.9 * torch.pow(torch.clamp(ratio, min=1e-10), -0.2),
                        0.2, 5.0),
            torch.full_like(ratio, 0.25),
        )
        t = torch.where(accept, t + h_try, t)
        x = torch.where(accept[..., None], x_new, x)
        # on reject (x, t) are unchanged so the cached k1 stays valid
        k_ok = accept & torch.isfinite(k_last).all(dim=-1)
        k1 = torch.where(k_ok[..., None], k_last, k1)
        moving = active & ~done
        h = torch.where(moving, torch.clamp(h_try * factor, min=1e-14), h)
        hmax = torch.where(accept, torch.maximum(hmax, h_try), hmax)
        steps = steps + moving.to(steps.dtype)
        active = cond(t, h, steps)
    return _poison_if_unfinished(x, t, t1), hmax


def lane_rhs(diffeq: Callable, nstates: int, cov):
    """``f(x, p, t, rateiv)`` on lanes ``[S, R]``: the per-(state, parameter)
    closure ``diffeq(x, p, t, b, rateiv, cov)`` vmapped over supports (outer)
    and rows (inner), with ``b`` zero (boluses are applied at breakpoints).
    ``x`` [S, R, n], ``p`` [S, P], ``t`` [S, R], ``rateiv`` [S, R, ninput].
    ``cov`` holds every row's covariate knots (a :class:`~.grid.CovView`
    whose tensors lead with the row axis R); the closure sees its row's
    view, rebuilt inside the row vmap."""
    from .grid import CovView

    names = cov.names

    def one(x, p, t, rateiv, kt, kv, kf):
        dx = diffeq(x, p, t, torch.zeros_like(rateiv), rateiv, CovView(kt, kv, kf, names))
        return as_vector(dx, x).reshape(nstates)

    rows = vmap(one, in_dims=(0, None, 0, 0, 0, 0, 0))
    over = vmap(rows, in_dims=(0, 0, 0, 0, None, None, None))
    return lambda x, p, t, rateiv: over(x, p, t, rateiv, cov.knot_t, cov.knot_v, cov.fixed)


def make_ode_propagate_carry(diffeq: Callable, nstates: int, ninput: int,
                             opts: ODEOptions):
    """The engine's carry-threading propagate hook, batched over lanes.

    ``propagate_carry(x, p, dt, rateiv, t0, cov, h) -> (x_next, h_next)``
    with ``x`` [S, R, n], ``p`` [S, P], ``dt``/``t0`` [R] (or [S, R] when
    lag or fa sort every support's segments apart), ``rateiv`` [R, ninput]
    (or [S, R, ninput]), ``cov`` every row's covariate knots (see
    :func:`lane_rhs`) and ``h`` [S, R], the cruise step carried across
    segments (0 = no history yet: start from ``opts.h0``). A failed segment
    poisons ``x`` but not the carried step.
    """
    A, B, E, C = check_solver(opts.solver)

    def propagate_carry(x, p, dt, rateiv, t0, cov, h):
        rhs = lane_rhs(diffeq, nstates, cov)
        rate = rateiv.expand(h.shape + (rateiv.shape[-1],))

        def f(xx, tt):
            return rhs(xx, p, tt, rate)

        t0b = t0.expand(h.shape)
        t1 = t0b + torch.clamp(dt, min=0.0).expand(h.shape)
        x_next, h_next = _erk_segment(f, x, t0b, t1, opts, A, B, E, C,
                                      h_start=h)
        h_next = torch.where(torch.isfinite(h_next) & (h_next > 0.0),
                             h_next, torch.zeros_like(h_next))
        return x_next, h_next

    return propagate_carry


def make_ode_propagate(diffeq: Callable, nstates: int, ninput: int,
                       opts: ODEOptions):
    """Like :func:`make_ode_propagate_carry` without the carried step:
    ``propagate(x, p, dt, rateiv, t0, cov) -> x_next``, each segment started
    from ``opts.h0``."""
    carry = make_ode_propagate_carry(diffeq, nstates, ninput, opts)

    def propagate(x, p, dt, rateiv, t0, cov):
        h = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return carry(x, p, dt, rateiv, t0, cov, h)[0]

    return propagate
