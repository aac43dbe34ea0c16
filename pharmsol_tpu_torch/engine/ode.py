"""Event-segmented explicit Runge-Kutta steppers for the general ODE engine.

The counterpart of the JAX package's ``engine/ode.py`` for its explicit tier.
The event grid already splits the timeline at every discontinuity, so the
right-hand side is smooth within a segment (constant infusion rate) and each
segment is one clean initial-value problem.

- ``dopri5`` / ``tsit5``: embedded 5(4) pairs (Dormand-Prince, Tsitouras
  2011) with FSAL, adaptive I-controller, stall guard, and NaN poisoning of a
  lane whose step budget runs out (the population layer turns it into -inf).
- ``expm``: exact propagation of an RHS that is affine in the state and
  autonomous within a segment, ``x' = A x + u``: ``A`` by forward-mode
  differentiation of the lane RHS at zero, ``u = f(0)``, the exponential of
  the block ``[[A, u], [0, 0]]`` by a Taylor-13 Horner chain with scaling and
  up to 16 masked squarings. Runtime probes of superposition and autonomy
  poison a lane that violates them. ``expm_rolled`` is the JAX package's
  name for the same math under a rolled loop (a compile-time measure for
  reverse mode in XLA); here it is an alias of ``expm``.
- kvaerno3/5, esdirk34, trbdf2 and bdf are solvers of the JAX package that
  the port does not have yet: asking for one raises PharmsolError.

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
from torch.func import jacfwd, vmap

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
UNPORTED_SOLVERS = ("kvaerno3", "kvaerno5", "esdirk34", "trbdf2", "bdf")
# Exact propagation for affine systems; ``expm_rolled`` is an alias.
EXPM_SOLVERS = ("expm", "expm_rolled")


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
    """The (A, B, E, C) tableau of ``solver`` (None for the expm solvers,
    which have none); raises PharmsolError for a solver the port does not
    have."""
    if solver in TABLEAUS:
        return TABLEAUS[solver]
    if solver in EXPM_SOLVERS:
        return None
    available = ", ".join(tuple(TABLEAUS) + EXPM_SOLVERS)
    if solver in UNPORTED_SOLVERS:
        raise PharmsolError(
            f"ODE solver `{solver}` is not ported to the PyTorch package yet "
            f"(ROADMAP Queue 1 item 5; available: {available})"
        )
    raise PharmsolError(
        f"unknown ODE solver `{solver}` (available: {available})"
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


# -- expm: exact propagation for linear (affine) systems -----------------------
#
# Compartment PK models beyond the 12 closed-form kernels are still almost
# always linear: dx/dt = A(p, cov) x + u with A constant within a segment
# (parameters fixed, rateiv constant, covariates carry-forward). The exact
# segment solution is the matrix exponential of the augmented system
# [[A, u], [0, 0]]: a fixed chain of small matrix products, batched over the
# lanes, with no step controller and no tolerance error.

_EXPM_SQUARINGS = 16  # covers ||[A u]|| dt up to 2^16 past the Taylor radius
_EXPM_TAYLOR = 13  # remainder <= 1/14! ~ 1e-11 at the 1.0 radius


def _expm_affine(A, u):
    """(P, q) with exp([[A, u], [0, 0]]) = [[P, q], [0, 1]], batched over
    leading dims (``A`` [..., n, n], ``u`` [..., n]).

    The augmented matrix's zero bottom row is static, so every product in
    the Taylor and squaring chains keeps the block form [[P, q], [0, 1]]:
    a Taylor-Horner step is (P, q) <- (I + A P / d, (A q + u) / d) and a
    squaring is (P, q) <- (P P, P q + q).
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    P = eye + A / _EXPM_TAYLOR
    q = u / _EXPM_TAYLOR
    for d in range(_EXPM_TAYLOR - 1, 0, -1):
        P = eye + torch.matmul(A, P) / d
        q = (torch.matmul(A, q[..., None])[..., 0] + u) / d
    return P, q


def expm_segment(f: Callable, jac: Callable, x0, t0, t1):
    """Exact segment propagation for an affine RHS, ``x' = A x + u``, on
    every lane: ``x0`` [*lanes, n], ``t0``/``t1`` [*lanes]; ``f(x, t)`` is the
    RHS and ``jac(x, t)`` its state Jacobian [*lanes, n, n] on all lanes.

    ``A = jac(0)`` and ``u = f(0)`` are taken per segment at its midpoint.
    Correctness needs f affine in x and autonomous within the segment, which
    is checked numerically here: a superposition probe (f(xa + xb) + f(0) -
    f(xa) - f(xb) = 0) and a time-independence probe (f(xa, t0) = f(xa,
    mid)) poison the lane to NaN on violation (the population layer turns
    that into -inf), and so do a scaled norm beyond 2^16 and a non-finite
    result.
    """
    n = x0.shape[-1]
    span = torch.clamp(t1 - t0, min=0.0)
    tc = t0 + 0.5 * span
    zero = torch.zeros_like(x0)
    f0 = f(zero, tc)
    A = jac(zero, tc)

    # runtime guards (scaled to the state/RHS magnitude)
    xa = torch.arange(1, n + 1, dtype=x0.dtype, device=x0.device) + torch.abs(x0)
    xb = torch.flip(xa, dims=(-1,)) * 0.7 + 1.0
    fa_, fb_, fab = f(xa, tc), f(xb, tc), f(xa + xb, tc)
    scale = 1.0 + torch.amax(torch.abs(fa_), dim=-1) + torch.amax(torch.abs(fb_), dim=-1)
    nonlinear = torch.amax(torch.abs(fab + f0 - fa_ - fb_), dim=-1) > 1e-4 * scale
    fa_t0 = f(xa, t0)
    nonautonomous = torch.amax(torch.abs(fa_t0 - fa_), dim=-1) > 1e-4 * scale

    # scaling and squaring on the affine block form; the squaring count is
    # per lane, so each of the (at most 16) squarings is masked
    Adt, udt = A * span[..., None, None], f0 * span[..., None]
    norm = torch.clamp(
        torch.amax(torch.sum(torch.abs(Adt), dim=-1) + torch.abs(udt), dim=-1), min=1e-30)
    s = torch.ceil(torch.clamp(torch.log2(norm), min=0.0))
    sc = torch.exp2(-s)
    P, q = _expm_affine(Adt * sc[..., None, None], udt * sc[..., None])
    s_fin = s[torch.isfinite(s)]
    n_sq = min(_EXPM_SQUARINGS, int(s_fin.max()) if s_fin.numel() else 0)
    for i in range(n_sq):
        on = i < s
        Pq = torch.matmul(P, q[..., None])[..., 0] + q
        P = torch.where(on[..., None, None], torch.matmul(P, P), P)
        q = torch.where(on[..., None], Pq, q)
    x1 = torch.matmul(P, x0[..., None])[..., 0] + q
    bad = (nonlinear | nonautonomous | ~(s <= _EXPM_SQUARINGS)
           | ~torch.isfinite(x1).all(dim=-1))
    return torch.where(bad[..., None], torch.full_like(x1, float("nan")), x1)


def _lane_closure(diffeq: Callable, nstates: int, names):
    """The per-lane RHS ``one(x, p, t, rateiv, knot_t, knot_v, fixed)`` of
    :func:`lane_rhs` (``b`` zero, the row's covariate view rebuilt)."""
    from .grid import CovView

    def one(x, p, t, rateiv, kt, kv, kf):
        dx = diffeq(x, p, t, torch.zeros_like(rateiv), rateiv, CovView(kt, kv, kf, names))
        return as_vector(dx, x).reshape(nstates)

    return one


def _over_lanes(one: Callable):
    """``one`` vmapped over supports (outer) and rows (inner)."""
    rows = vmap(one, in_dims=(0, None, 0, 0, 0, 0, 0))
    return vmap(rows, in_dims=(0, 0, 0, 0, None, None, None))


def lane_jacobian(diffeq: Callable, nstates: int, cov):
    """``J(x, p, t, rateiv)`` [S, R, n, n] on the lanes of :func:`lane_rhs`:
    the state Jacobian of the closure by forward mode (``jacfwd``)."""
    over = _over_lanes(jacfwd(_lane_closure(diffeq, nstates, cov.names), argnums=0))
    return lambda x, p, t, rateiv: over(x, p, t, rateiv, cov.knot_t, cov.knot_v, cov.fixed)


def lane_rhs(diffeq: Callable, nstates: int, cov):
    """``f(x, p, t, rateiv)`` on lanes ``[S, R]``: the per-(state, parameter)
    closure ``diffeq(x, p, t, b, rateiv, cov)`` vmapped over supports (outer)
    and rows (inner), with ``b`` zero (boluses are applied at breakpoints).
    ``x`` [S, R, n], ``p`` [S, P], ``t`` [S, R], ``rateiv`` [S, R, ninput].
    ``cov`` holds every row's covariate knots (a :class:`~.grid.CovView`
    whose tensors lead with the row axis R); the closure sees its row's
    view, rebuilt inside the row vmap."""
    over = _over_lanes(_lane_closure(diffeq, nstates, cov.names))
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
    tableau = check_solver(opts.solver)

    def propagate_carry(x, p, dt, rateiv, t0, cov, h):
        rhs = lane_rhs(diffeq, nstates, cov)
        rate = rateiv.expand(h.shape + (rateiv.shape[-1],))

        def f(xx, tt):
            return rhs(xx, p, tt, rate)

        t0b = t0.expand(h.shape)
        t1 = t0b + torch.clamp(dt, min=0.0).expand(h.shape)
        if tableau is None:
            # expm has no step to carry: it returns a zero step
            jac = lane_jacobian(diffeq, nstates, cov)
            x_next = expm_segment(f, lambda xx, tt: jac(xx, p, tt, rate), x, t0b, t1)
            return x_next, torch.zeros_like(h)
        x_next, h_next = _erk_segment(f, x, t0b, t1, opts, *tableau,
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
