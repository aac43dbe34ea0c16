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
- ``kvaerno3`` (alias ``esdirk34``), ``kvaerno5``, ``trbdf2``: embedded ESDIRK
  pairs for stiff systems. The first stage is explicit; every later stage is
  solved by Newton's method with a fresh Jacobian of the stage equation each
  iteration; a step whose Newton residual stays above 0.1 (WRMS) or whose
  state jumps more than tenfold is rejected.
- ``bdf``: variable-order (1-5) BDF with a fixed leading coefficient
  (the SUNDIALS/ode15s family), the reference's default solver: a
  backward-difference array ``D[8, n]`` per lane, the Jacobian frozen at the
  predicted point, the order chosen among k-1, k, k+1 after k+1 equal steps.

The JAX package vmaps a per-lane ``lax.while_loop``; here one masked Python
loop runs over all lanes at once (``x`` is ``[*lanes, n]``): every trial
computes the step on every lane, and only the lanes whose loop condition
holds take its result. The loop ends when no lane is active. Per lane this is
the JAX loop step for step (``unroll`` 1, its CPU setting), so the two agree
to rounding. Default tolerances follow ode/mod.rs:40-41 (rtol = atol = 1e-4,
h0 = 1e-3).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
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

# Kvaerno 3/2: 4-stage ESDIRK, stiffly accurate, L-stable.
_KV3_GAMMA = 0.4358665215084590
_KV3_A = (
    (0.0,),
    (_KV3_GAMMA, _KV3_GAMMA),
    (0.490563388419108, 0.073570090080892, _KV3_GAMMA),
    (0.308809969973036, 1.490563388254106, -1.235239879727145, _KV3_GAMMA),
)
_KV3_C = (0.0, 2 * _KV3_GAMMA, 1.0, 1.0)
_KV3_B = (0.308809969973036, 1.490563388254106, -1.235239879727145, _KV3_GAMMA)
_KV3_BHAT = (0.490563388419108, 0.073570090080892, _KV3_GAMMA, 0.0)

# Kvaerno 5(4): 7-stage ESDIRK, L-stable (Kvaerno 2004).
_KV5_GAMMA = 0.26
_KV5_A = (
    (0.0,),
    (_KV5_GAMMA, _KV5_GAMMA),
    (0.13, 0.84033320996790809, _KV5_GAMMA),
    (0.22371961478320505, 0.47675532319799699, -0.06470895363112615, _KV5_GAMMA),
    (0.16648564323248321, 0.10450018841591720, 0.03631482272098715,
     -0.13090704451073998, _KV5_GAMMA),
    (0.13855640231268224, 0.0, -0.04245337201752043, 0.02446657898003141,
     0.61943039072480676, _KV5_GAMMA),
    (0.13659751177640291, 0.0, -0.05496908796538376, -0.04118626728321046,
     0.62993304899016403, 0.06962479448202728, _KV5_GAMMA),
)
_KV5_C = (0.0, 0.52, 1.230333209967908, 0.8957659843500759, 0.43639360985864756,
          1.0, 1.0)
_KV5_B = _KV5_A[6]
_KV5_BHAT = _KV5_A[5] + (0.0,)

# TR-BDF2 as a 3-stage ESDIRK 2(3) (Hosea & Shampine 1996): one trapezoidal
# half-step to t + gamma*h, one BDF2 step to t + h; L-stable, first stage
# explicit, uniform implicit diagonal d = (2 - sqrt(2)) / 2.
_TRBDF2_D = (2.0 - math.sqrt(2.0)) / 2.0
_TRBDF2_W = math.sqrt(2.0) / 4.0
_TRBDF2_A = (
    (0.0,),
    (_TRBDF2_D, _TRBDF2_D),
    (_TRBDF2_W, _TRBDF2_W, _TRBDF2_D),
)
_TRBDF2_C = (0.0, 2.0 * _TRBDF2_D, 1.0)
_TRBDF2_B = (_TRBDF2_W, _TRBDF2_W, _TRBDF2_D)
_TRBDF2_BHAT = (
    (1.0 - _TRBDF2_W) / 3.0,
    (3.0 * _TRBDF2_W + 1.0) / 3.0,
    _TRBDF2_D / 3.0,
)

# Variable-order BDF (1-5), fixed leading coefficient with the kappa
# stabilisation (SUNDIALS/ode15s): alpha, the gamma sums, the error constant
# of each order.
BDF_MAX_ORDER = 5
_BDF_KAPPA = (0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0)
_BDF_GAMMA = tuple(float(g) for g in np.hstack(
    ([0.0], np.cumsum(1.0 / np.arange(1, BDF_MAX_ORDER + 1)))))
_BDF_ALPHA = tuple((1.0 - k) * g for k, g in zip(_BDF_KAPPA, _BDF_GAMMA))
_BDF_ERROR_CONST = tuple(k * g + 1.0 / (i + 1.0)
                         for i, (k, g) in enumerate(zip(_BDF_KAPPA, _BDF_GAMMA)))
_BDF_MIN_FACTOR = 0.2
_BDF_MAX_FACTOR = 10.0

# (A, B, E, C) of the explicit solvers the port has.
TABLEAUS = {
    "dopri5": (_DP_A, _DP_B5, _DP_E, _DP_C),
    "tsit5": (_TS_A, _TS_B, _TS_E, _TS_C),
}
# The embedded ESDIRK pairs: stage matrix, weights, embedded weights, nodes,
# the implicit diagonal, the order the step controller assumes and the most a
# step may grow. kvaerno5's estimator is optimistic across sharp nonlinear
# transitions (TMDD target depletion), so its growth stays at 1.5; esdirk34
# is the Kvaerno 3/2 scheme, a 4-stage ESDIRK of order 3.
SDIRK_TABLEAUS = {
    "trbdf2": dict(A=_TRBDF2_A, B=_TRBDF2_B, BHAT=_TRBDF2_BHAT, C=_TRBDF2_C,
                   gamma=_TRBDF2_D, order=2.0, max_growth=5.0),
    "kvaerno3": dict(A=_KV3_A, B=_KV3_B, BHAT=_KV3_BHAT, C=_KV3_C,
                     gamma=_KV3_GAMMA, order=3.0, max_growth=5.0),
    "kvaerno5": dict(A=_KV5_A, B=_KV5_B, BHAT=_KV5_BHAT, C=_KV5_C,
                     gamma=_KV5_GAMMA, order=5.0, max_growth=1.5),
}
SDIRK_TABLEAUS["esdirk34"] = SDIRK_TABLEAUS["kvaerno3"]
BDF_SOLVERS = ("bdf",)
# Solvers of the JAX package (engine/ode.py _SEGMENT_SOLVERS) not ported yet:
# none.
UNPORTED_SOLVERS = ()
# Exact propagation for affine systems; ``expm_rolled`` is an alias.
EXPM_SOLVERS = ("expm", "expm_rolled")


class ODEOptions(NamedTuple):
    rtol: float = DEFAULT_RTOL
    atol: float = DEFAULT_ATOL
    h0: float = DEFAULT_H0
    max_steps: int = DEFAULT_MAX_STEPS
    solver: str = "dopri5"
    # Newton iterations per implicit stage (ESDIRK) or step (BDF)
    newton_iters: int = 6


def check_solver(solver: str):
    """What the solver steps with: the (A, B, E, C) tableau of an explicit
    pair, the :data:`SDIRK_TABLEAUS` entry of an ESDIRK pair, None for
    ``bdf`` and the expm solvers (which have no tableau); raises
    PharmsolError for a solver the package does not have."""
    if solver in TABLEAUS:
        return TABLEAUS[solver]
    if solver in SDIRK_TABLEAUS:
        return SDIRK_TABLEAUS[solver]
    if solver in EXPM_SOLVERS or solver in BDF_SOLVERS:
        return None
    available = ", ".join(tuple(TABLEAUS) + tuple(SDIRK_TABLEAUS) + BDF_SOLVERS
                          + EXPM_SOLVERS)
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


# -- ESDIRK (Kvaerno, TR-BDF2) implicit methods ----------------------------------


def _dense_solve(A, b):
    """Solve the batched n x n systems ``A z = b`` (``A`` [*lanes, n, n],
    ``b`` [*lanes, n]) by LU with partial pivoting. The unchecked variant: a
    singular or non-finite lane gives a non-finite answer that the step
    controller rejects, where the checked one would raise for the batch."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _newton_stage(f, jac, x_base, t_stage, hg, x_guess, newton_iters):
    """Solve ``z = x_base + hg * f(z, t_stage)`` by Newton's method with a
    fresh Jacobian each iteration; ``hg`` [*lanes, 1] is ``h * gamma``.
    Returns ``(z, F(z))``: the residual lets the controller reject a step
    whose fixed-count iteration did not converge."""
    eye = torch.eye(x_base.shape[-1], dtype=x_base.dtype, device=x_base.device)

    def F(z):
        return z - x_base - hg * f(z, t_stage)

    z = x_guess
    for _ in range(newton_iters):
        resid = F(z)
        J = eye - hg[..., None] * jac(z, t_stage)
        z = z - _dense_solve(J, resid)
    return z, F(z)


def _esdirk_segment(f: Callable, jac: Callable, x0, t0, t1, opts: ODEOptions,
                    A, B, BHAT, C, gamma, order, max_growth, h_start=None):
    """Adaptive embedded ESDIRK over every lane: ``(x_end, h_cruise)`` as
    :func:`_erk_segment`; ``jac(x, t)`` is the RHS's state Jacobian
    [*lanes, n, n]."""
    n_stages = len(C)
    t_done = _done_threshold(t1)

    def one_step(x, t, h):
        hh = h[..., None]
        ks = [f(x, t)]
        resid_max = torch.zeros_like(h)
        for i in range(1, n_stages):
            x_base = x
            for j in range(i):
                x_base = x_base + hh * A[i][j] * ks[j]
            t_stage = t + C[i] * h
            z, resid = _newton_stage(f, jac, x_base, t_stage, hh * gamma,
                                     x_base + hh * gamma * ks[i - 1],
                                     opts.newton_iters)
            scale = opts.atol + opts.rtol * torch.abs(z)
            resid_max = torch.maximum(
                resid_max, torch.sqrt(torch.mean((resid / scale) ** 2, dim=-1)))
            ks.append(f(z, t_stage))
        x_new = x_hat = x
        for bi, bhi, k in zip(B, BHAT, ks):
            x_new = x_new + hh * bi * k
            x_hat = x_hat + hh * bhi * k
        return x_new, x_new - x_hat, resid_max

    def cond(t, h, steps):
        return (t < t_done) & (steps < opts.max_steps) & ~_h_stalled(h, t)

    h = _resolve_h_start(h_start, t1 - t0, opts)
    t = t0 + torch.zeros_like(h)
    x = x0
    steps = torch.zeros(h.shape, dtype=torch.int64, device=h.device)
    hmax = h
    active = cond(t, h, steps)
    while bool(active.any()):
        h_try = torch.minimum(h, t1 - t)
        x_new, err, resid_max = one_step(x, t, h_try)
        ratio = _error_ratio(err, x, x_new, opts.rtol, opts.atol)
        # a Newton stage that did not converge invalidates the step even when
        # the (equally unconverged) embedded error estimate looks small
        finite = (torch.isfinite(x_new).all(dim=-1) & torch.isfinite(resid_max)
                  & (resid_max <= 0.1))
        # growth guard: at a large h a nonlinear stage equation can grow
        # spurious roots far from the solution branch, with a tiny residual
        # and a self-consistent embedded error. A tenfold jump of the state in
        # one step is never a resolved trajectory at these tolerances
        growth_ok = (torch.amax(torch.abs(x_new - x), dim=-1)
                     <= 10.0 * (1.0 + torch.amax(torch.abs(x), dim=-1)))
        finite = finite & growth_ok
        accept = active & (ratio <= 1.0) & finite
        factor = torch.where(
            finite,
            torch.clamp(0.9 * torch.pow(torch.clamp(ratio, min=1e-10),
                                        -1.0 / (order + 1.0)), 0.2, max_growth),
            torch.full_like(ratio, 0.25),
        )
        hmax = torch.where(accept, torch.maximum(hmax, h_try), hmax)
        t = torch.where(accept, t + h_try, t)
        x = torch.where(accept[..., None], x_new, x)
        h = torch.where(active, torch.clamp(h_try * factor, min=1e-14), h)
        steps = steps + active.to(steps.dtype)
        active = cond(t, h, steps)
    return _poison_if_unfinished(x, t, t1), hmax


# -- BDF (variable order 1-5, fixed leading coefficient) -----------------------
#
# The reference's default solver is diffsol's BDF, the SUNDIALS/ode15s family:
# quasi-constant step size, a backward-difference history and a
# kappa-stabilised fixed leading coefficient. Here every lane carries a
# difference array D[BDF_MAX_ORDER + 3, n] and its own order; order and step
# adaptation are masked selects.


def _bdf_R(factor):
    """The difference-array rescaling matrix R(factor) [*lanes, 6, 6] of a
    step-size change by ``factor`` [*lanes]: row 0 ones, column 0 zero below
    it, ``R[i][j] = prod_{l <= i} (l - 1 - factor j) / l``."""
    K = BDF_MAX_ORDER + 1
    idx = torch.arange(1, K, dtype=factor.dtype, device=factor.device)
    i, j = idx[:, None], idx[None, :]
    M = torch.zeros(factor.shape + (K, K), dtype=factor.dtype, device=factor.device)
    M[..., 1:, 1:] = (i - 1.0 - factor[..., None, None] * j) / i
    M[..., 0, :] = 1.0
    return torch.cumprod(M, dim=-2)


def _bdf_segment(f: Callable, jac: Callable, x0, t0, t1, opts: ODEOptions,
                 h_start=None):
    """Variable-order BDF over every lane: ``(x_end, h_cruise)`` as
    :func:`_erk_segment`."""
    dtype, dev = x0.dtype, x0.device
    n = x0.shape[-1]
    K = BDF_MAX_ORDER + 1
    t_done = _done_threshold(t1)
    gamma = torch.tensor(_BDF_GAMMA, dtype=dtype, device=dev)
    alpha = torch.tensor(_BDF_ALPHA, dtype=dtype, device=dev)
    error_const = torch.tensor(_BDF_ERROR_CONST, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    eye6 = torch.eye(K, dtype=dtype, device=dev)
    idx6 = torch.arange(K, device=dev)
    idx8 = torch.arange(BDF_MAX_ORDER + 3, device=dev)
    U = _bdf_R(torch.ones((), dtype=dtype, device=dev))

    # D[:k+1] <- (R(k, factor) @ R(k, 1)).T @ D[:k+1]; R(k, 1) is involutory,
    # so factor 1 is the identity. Rows and columns beyond the lane's order
    # are masked to the identity, so one 6 x 6 product serves every order
    def change_D(D, order, factor):
        o = order[..., None, None]
        act = (idx6[:, None] <= o) & (idx6[None, :] <= o)
        Rm = torch.where(act, _bdf_R(factor), eye6)
        Um = torch.where(act, U, eye6)
        RU = torch.matmul(Rm, Um)
        D6 = torch.matmul(RU.transpose(-1, -2), D[..., :K, :])
        return torch.cat([D6, D[..., K:, :]], dim=-2)

    def rms(v, scale):
        return torch.sqrt(torch.mean((v / scale) ** 2, dim=-1))

    def row(D, k):
        """D[k] per lane, ``k`` [*lanes] (clamped into the array)."""
        k = torch.clamp(k, 0, D.shape[-2] - 1)
        return torch.gather(D, -2, k[..., None, None].expand(k.shape + (1, n)))[..., 0, :]

    def cond(t, h, steps):
        return (t < t_done) & (steps < opts.max_steps) & ~_h_stalled(h, t)

    h = _resolve_h_start(h_start, t1 - t0, opts)
    t = t0 + torch.zeros_like(h)
    D = torch.zeros(h.shape + (BDF_MAX_ORDER + 3, n), dtype=dtype, device=dev)
    D[..., 0, :] = x0
    D[..., 1, :] = h[..., None] * f(x0, t)
    order = torch.ones(h.shape, dtype=torch.int64, device=dev)
    neq = torch.zeros_like(order)
    steps = torch.zeros_like(order)
    hmax = h
    active = cond(t, h, steps)
    while bool(active.any()):
        # clip the step to the remaining span, rescaling the history to match
        h_req = torch.minimum(h, t1 - t)
        clip_factor = h_req / h
        clip = clip_factor < 1.0
        D_c = torch.where(clip[..., None, None], change_D(D, order, clip_factor), D)
        neq_c = torch.where(clip, torch.zeros_like(neq), neq)

        alpha_k = alpha[order]
        c = h_req / alpha_k
        upto = (idx6 <= order[..., None])[..., None]
        D6 = D_c[..., :K, :]
        x_pred = torch.sum(torch.where(upto, D6, torch.zeros_like(D6)), dim=-2)
        scale = opts.atol + opts.rtol * torch.abs(x_pred)
        gmask = torch.where((idx6 >= 1) & (idx6 <= order[..., None]), gamma,
                            torch.zeros_like(gamma))
        psi = torch.matmul(gmask[..., None, :], D6)[..., 0, :] / alpha_k[..., None]
        t_new = t + h_req

        # Newton on g(d) = d - c f(x_pred + d, t_new) + psi with the Jacobian
        # frozen at the predicted point
        cc = c[..., None]
        Am = eye - cc[..., None] * jac(x_pred, t_new)
        d = torch.zeros_like(x_pred)
        y = x_pred
        for _ in range(opts.newton_iters):
            step = _dense_solve(Am, cc * f(y, t_new) - psi - d)
            d, y = d + step, y + step
        resid = cc * f(y, t_new) - psi - d

        err_norm = rms(error_const[order][..., None] * d, scale)
        res_norm = rms(resid, scale)
        finite = torch.isfinite(y).all(dim=-1) & torch.isfinite(err_norm)
        converged = res_norm <= 0.1
        accept = (err_norm <= 1.0) & converged & finite

        # accepted-path difference update: D[k+2] = d - D[k+1]; D[k+1] = d;
        # D[i] += D[i+1] downward; afterwards D[0] is the new solution
        o8 = order[..., None]
        D_acc = torch.where((idx8 == o8 + 2)[..., None],
                            (d - row(D_c, order + 1))[..., None, :], D_c)
        D_acc = torch.where((idx8 == o8 + 1)[..., None], d[..., None, :], D_acc)
        rows = list(D_acc.unbind(-2))
        for i in range(BDF_MAX_ORDER, -1, -1):
            rows[i] = rows[i] + torch.where((i <= order)[..., None], rows[i + 1],
                                            torch.zeros_like(rows[i]))
        D_acc = torch.stack(rows, dim=-2)

        neq_acc = neq_c + 1
        do_adapt = accept & (neq_acc > order)

        # order adaptation: the error norms at order - 1, order, order + 1;
        # an invalid candidate is masked to -1 after the power, so it loses
        # the argmax against the middle one (factors >= 0)
        err_m = rms(error_const[order - 1][..., None] * row(D_acc, order), scale)
        err_p = rms(error_const[torch.clamp(order + 1, max=BDF_MAX_ORDER)][..., None]
                    * row(D_acc, order + 2), scale)
        norms = torch.stack([err_m, torch.clamp(err_norm, min=1e-16), err_p], dim=-1)
        exps = -1.0 / (order[..., None].to(dtype)
                       + torch.tensor([0.0, 1.0, 2.0], dtype=dtype, device=dev))
        facs = torch.pow(torch.clamp(norms, min=1e-16), exps)
        valid = torch.stack([order > 1, torch.ones_like(accept),
                             order < BDF_MAX_ORDER], dim=-1) & torch.isfinite(facs)
        facs = torch.where(valid, facs, torch.full_like(facs, -1.0))
        best = torch.argmax(facs, dim=-1)
        order_adapted = torch.clamp(order + best - 1, 1, BDF_MAX_ORDER)
        fac_best = torch.gather(facs, -1, best[..., None])[..., 0]
        factor_adapt = torch.clamp(0.9 * fac_best, _BDF_MIN_FACTOR, _BDF_MAX_FACTOR)

        # rejected path: shrink by the error, hard on a Newton failure
        factor_rej = torch.where(
            finite & converged,
            torch.clamp(0.9 * torch.pow(torch.clamp(err_norm, min=1e-16),
                                        -1.0 / (order.to(dtype) + 1.0)),
                        _BDF_MIN_FACTOR, 1.0),
            torch.full_like(err_norm, 0.25),
        )
        one = torch.ones_like(err_norm)
        factor = torch.where(accept, torch.where(do_adapt, factor_adapt, one), factor_rej)
        order_new = torch.where(do_adapt, order_adapted, order)
        neq_new = torch.where(accept & ~do_adapt, neq_acc, torch.zeros_like(neq))
        D_new = torch.where(accept[..., None, None], D_acc, D_c)
        D_final = torch.where((factor == 1.0)[..., None, None], D_new,
                              change_D(D_new, order_new, factor))

        a3 = active[..., None, None]
        D = torch.where(a3, D_final, D)
        hmax = torch.where(active & accept, torch.maximum(hmax, h_req), hmax)
        t = torch.where(active & accept, t_new, t)
        h = torch.where(active, torch.clamp(h_req * factor, min=1e-14), h)
        order = torch.where(active, order_new, order)
        neq = torch.where(active, neq_new, neq)
        steps = steps + active.to(steps.dtype)
        active = cond(t, h, steps)
    return _poison_if_unfinished(D[..., 0, :], t, t1), hmax


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


def _over_lanes(one: Callable, cov):
    """``one`` vmapped over supports (outer) and rows (inner), called with
    every row's covariate knots: the parameters are shared by the rows
    (``p`` [S, P]) or given per lane (``p`` [S, R, P])."""
    shared = vmap(vmap(one, in_dims=(0, None, 0, 0, 0, 0, 0)),
                  in_dims=(0, 0, 0, 0, None, None, None))
    per_lane = vmap(vmap(one, in_dims=(0, 0, 0, 0, 0, 0, 0)),
                    in_dims=(0, 0, 0, 0, None, None, None))

    def over(x, p, t, rateiv):
        fn = per_lane if p.dim() == 3 else shared
        return fn(x, p, t, rateiv, cov.knot_t, cov.knot_v, cov.fixed)

    return over


def lane_jacobian(diffeq: Callable, nstates: int, cov):
    """``J(x, p, t, rateiv)`` [S, R, n, n] on the lanes of :func:`lane_rhs`:
    the state Jacobian of the closure by forward mode (``jacfwd``)."""
    return _over_lanes(jacfwd(_lane_closure(diffeq, nstates, cov.names), argnums=0), cov)


def lane_rhs(diffeq: Callable, nstates: int, cov):
    """``f(x, p, t, rateiv)`` on lanes ``[S, R]``: the per-(state, parameter)
    closure ``diffeq(x, p, t, b, rateiv, cov)`` vmapped over supports (outer)
    and rows (inner), with ``b`` zero (boluses are applied at breakpoints).
    ``x`` [S, R, n], ``p`` [S, P] (or [S, R, P], a parameter row per lane),
    ``t`` [S, R], ``rateiv`` [S, R, ninput]. ``cov`` holds every row's
    covariate knots (a :class:`~.grid.CovView` whose tensors lead with the
    row axis R); the closure sees its row's view, rebuilt inside the row
    vmap."""
    return _over_lanes(_lane_closure(diffeq, nstates, cov.names), cov)


def make_ode_propagate_carry(diffeq: Callable, nstates: int, ninput: int,
                             opts: ODEOptions):
    """The engine's carry-threading propagate hook, batched over lanes.

    ``propagate_carry(x, p, dt, rateiv, t0, cov, h) -> (x_next, h_next)``
    with ``x`` [S, R, n], ``p`` [S, P] (or [S, R, P], a parameter row per
    lane), ``dt``/``t0`` [R] (or [S, R] when
    lag or fa sort every support's segments apart), ``rateiv`` [R, ninput]
    (or [S, R, ninput]), ``cov`` every row's covariate knots (see
    :func:`lane_rhs`) and ``h`` [S, R], the cruise step carried across
    segments (0 = no history yet: start from ``opts.h0``). A failed segment
    poisons ``x`` but not the carried step.
    """
    tableau = check_solver(opts.solver)
    solver = opts.solver

    def propagate_carry(x, p, dt, rateiv, t0, cov, h):
        rhs = lane_rhs(diffeq, nstates, cov)
        lane_jac = lane_jacobian(diffeq, nstates, cov)
        rate = rateiv.expand(h.shape + (rateiv.shape[-1],))

        def f(xx, tt):
            return rhs(xx, p, tt, rate)

        def jac(xx, tt):
            return lane_jac(xx, p, tt, rate)

        t0b = t0.expand(h.shape)
        t1 = t0b + torch.clamp(dt, min=0.0).expand(h.shape)
        if solver in EXPM_SOLVERS:
            # expm has no step to carry: it returns a zero step
            return expm_segment(f, jac, x, t0b, t1), torch.zeros_like(h)
        if solver in BDF_SOLVERS:
            x_next, h_next = _bdf_segment(f, jac, x, t0b, t1, opts, h_start=h)
        elif solver in SDIRK_TABLEAUS:
            x_next, h_next = _esdirk_segment(f, jac, x, t0b, t1, opts,
                                             h_start=h, **tableau)
        else:
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
