"""Models written in the closure styles the RHS generator takes, for the
tests and ``chip_smoke.py``'s phase 28.

- Vector-style spellings (``torch.zeros_like``, writes with static indices,
  whole-vector arithmetic) of three list-style right-hand sides of the
  repo: the 2-cmt oral ODE "Short" (:func:`short_vector`), the full TMDD
  (:func:`tmdd_vector`) and the 5-state transit chain of
  ``examples/expm_linear_ode.py`` (:func:`transit_vector`). Each traces to
  its list-style spelling's graph, so to its header and key
  (``VECTOR_SPELLINGS`` names the list-style one).
- The "math" model (:func:`math_case`): a 2-state oral model whose
  elimination and absorption carry small terms of every operation of the
  generator's elementwise set and a power with a state-dependent exponent,
  with a time-varying weight and a lag (``features``), written once for
  either package through a namespace ``F`` of its functions.
- The README SDE with a ``tanh`` term in its drift
  (:func:`readme_tanh_drift`).
"""

from __future__ import annotations

import torch

from .f32_budget import _rhs_short, _rhs_tmdd, _rhs_transit


def short_vector(x, p, t, b, r, cov):
    """The 2-cmt oral RHS (``f32_budget._rhs_short``), vector-style."""
    dx = torch.zeros_like(x)
    dx[0] += -p[1] * x[0] + b[0]
    dx[1] = p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + r[0]
    dx[2] += p[2] * x[1] - p[3] * x[2]
    return dx


def tmdd_vector(x, p, t, b, r, cov):
    """The full TMDD RHS (``f32_budget._rhs_tmdd``), vector-style."""
    bind = p[1] * x[0] * x[1] - p[2] * x[2]
    dx = torch.zeros_like(x)
    dx[0] = -p[0] * x[0] - bind + b[0] + r[0]
    dx[1] += p[3] - p[4] * x[1] - bind
    dx[2] = bind - p[5] * x[2]
    return dx


def transit_vector(x, p, t, b, r, cov):
    """The transit chain (``f32_budget._rhs_transit``) as whole-vector
    arithmetic: the chain's and the periphery's rows as vectors."""
    dx = torch.zeros_like(x)
    dx[0] = -p[0] * x[0] + b[0]
    dx[1:3] = p[0] * x[0:2] - torch.stack([p[0], p[1] + p[2] + p[4]]) * x[1:3]
    dx[2] = dx[2] + p[3] * x[3]
    dx[2] += p[5] * x[4]
    dx[2] += r[0]
    dx[3:] = torch.stack([p[2], p[4]]) * x[2] - torch.stack([p[3], p[5]]) * x[3:]
    return dx


# vector-style closure -> its list-style spelling's builder (of ``stack``)
VECTOR_SPELLINGS = {
    "short": (short_vector, _rhs_short),
    "tmdd": (tmdd_vector, _rhs_tmdd),
    "transit": (transit_vector, _rhs_transit),
}

# the math model's parameters: ka, ke, v, lag, q (the base of the
# state-dependent power)
MATH_CENTRE = (1.2, 0.15, 10.0, 0.3, 1.5)
MATH_TIMES = (0.5, 1.0, 2.0, 4.0, 6.0, 8.0, 12.0)
# the weight's knots: at the dose and at an observation, so on breakpoints
MATH_KNOTS = (0.0, 2.0)


def math_rhs(F, stack, features: bool = True):
    """The math model's RHS with the functions of namespace ``F`` (``torch``,
    or the JAX package's ``jnp`` with ``sigmoid``, ``erf``, ``erfc`` and
    ``rsqrt`` added) and ``stack``. Every operation of the elementwise set
    enters a small term, each argument inside its function's domain; sign
    reads a parameter (of a state, its jump would put a discontinuity into
    the RHS, and the fused and general engines would part by far more than
    the controller's error); ``features`` reads the weight ``wt`` (else 70
    kg)."""

    def diffeq(x, p, t, b, r, cov):
        c = x[1] / p[2]
        wt = cov("wt", t) if features else 70.0
        kel = (p[1] * (wt / 70.0) ** 0.75 * (1.0 + 0.1 * F.tanh(0.05 * c))
               * p[4] ** (0.001 * x[0]))
        absorb = p[0] * x[0] * (1.0 + 0.02 * F.erf(0.01 * x[0])
                                - 0.01 * F.erfc(1.0 + 0.01 * x[1]))
        extra = (0.01 * F.sigmoid(0.1 * c - 1.0) + 0.002 * F.atan(0.01 * c)
                 + 0.001 * F.atan2(x[0], x[1] + 1.0) + 0.001 * F.sinh(0.01 * c)
                 - 0.001 * F.cosh(0.01 * c)
                 + 0.001 * F.asin(0.5 * F.tanh(0.01 * x[0]))
                 + 0.001 * F.acos(0.5 * F.tanh(0.01 * x[1]))
                 + 0.001 * F.log1p(0.01 * x[1]) - 0.001 * F.expm1(-0.01 * x[0])
                 + 0.001 * F.square(0.01 * c) + 0.001 * F.rsqrt(1.0 + 0.01 * x[1] * x[1])
                 + 0.001 * F.reciprocal(1.0 + 0.01 * x[0] * x[0])
                 + 0.001 * F.sign(p[0] - 1.0))
        return stack([-absorb + b[0], absorb - kel * x[1] - extra * x[1] + r[0]])

    return diffeq


def math_case(n_subjects: int = 6, n_support: int = 12, seed: int = 0, lib=None,
              F=None, stack=None, solver: str = "dopri5", features: bool = True,
              times=MATH_TIMES):
    """The math model (see :func:`math_rhs`) with ``.with_solver(solver)``:
    (model, data, support, ems), built with ``lib`` (default this package),
    ``F`` and ``stack`` (default ``torch``, ``torch.stack``). With
    ``features`` the RHS reads a weight with knots at 0 and 2 h and input 0
    has a lag (kernel K2e); without, neither (K2a). A bolus of 100 at 0, an
    infusion into the central state on every third subject, observations at
    ``times`` (2 h among them); observed values and supports come from
    ``seed``."""
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if F is None:
        F = torch
    if stack is None:
        stack = torch.stack
    rng = np.random.RandomState(seed)
    sp = np.asarray(MATH_CENTRE)[None, :] * rng.uniform(0.75, 1.25, (n_support, 5))
    closures = dict(lag=lambda p, t, cov: {0: p[3]}) if features else {}
    model = lib.ODE(math_rhs(F, stack, features), out=lambda x, p, t, cov: x[1:2] / p[2],
                    nstates=2, ndrugs=1, nout=1, **closures).with_solver(solver)
    subjects = []
    for i in range(n_subjects):
        sb = lib.Subject.builder(f"m{i}").bolus(0.0, 100.0, 0)
        if i % 3 == 0:
            sb = sb.infusion(1.0, 40.0, 0, 2.0)
        if features:
            sb = (sb.covariate("wt", MATH_KNOTS[0], float(rng.uniform(50.0, 90.0)))
                  .covariate("wt", MATH_KNOTS[1], float(rng.uniform(50.0, 90.0))))
        for t in times:
            sb = sb.observation(t, float(6.0 * np.exp(-0.15 * t) * np.exp(0.2 * rng.randn())), 0)
        subjects.append(sb.build())
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    return model, lib.Data(subjects), sp, ems


def readme_tanh_drift(x, p, t, r, cov):
    """The README SDE's drift (``examples/sde_readme.py``: p = ke0, v,
    sigma_ke) with its elimination damped by a ``tanh`` of the amount."""
    return torch.stack([-x[1] * x[0] * (1.0 - 0.1 * torch.tanh(0.01 * x[0])),
                        -(x[1] - p[0])])
