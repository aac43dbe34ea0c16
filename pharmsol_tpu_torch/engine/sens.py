"""Continuous forward sensitivities for adaptive-ODE derivatives.

The counterpart of the JAX package's ``engine/sens.py``. The derivative of an
ODE solution is itself the solution of an ODE, the variational system

    d/dt s = (df/dx) s + (df/dp) p_dot,      s(0) = (dx0/dp) p_dot,

so a directional derivative of the predictions is one integration of the
augmented system ``X = [x; s]``, ``F(X) = [f(x, p); jvp_f((x, p), (s,
p_dot))]`` (:func:`augmented_equation`, an ordinary :class:`ODE` of twice the
states) instead of a derivative of the adaptive stepper. Where the RHS
generator (``ops/rhs_codegen.py``) traces the closure, the augmented RHS is
that trace differentiated symbolically and run as one straight-line program
on every lane at once (``lanes.py::LaneProgram``); otherwise its tangent half is
``torch.func.jvp`` of the closure, lane by lane under ``vmap``, a dearer
call. The augmented model's adaptive error norm covers
the sensitivity states, as the JAX package's does: both march the same step
sequence.

:class:`_SensYAll` installs the rule on the per-row march as a
``torch.autograd.Function``:

- ``forward`` is the base solve; the primal never comes from the augmented
  solve's first half, whose step sequence depends on the direction;
- ``jvp`` (forward mode, ``torch.func.jvp``) solves the augmented model along
  the tangent; ``vmap`` folds a batch of directions into extra rows, so
  ``torch.func.jacfwd`` works;
- ``backward`` builds the Jacobian one basis direction at a time, every
  direction an extra row of one augmented solve, through the next level's
  Function, and returns ``J^T g``. The next level is again a
  :class:`_SensYAll` over the augmented model, so its own derivatives solve
  the model augmented once more: second and higher orders work (the
  Laplace inner Hessian, its outer gradient and the standard-error
  Hessian) up to :data:`SENS_DEPTH` orders; a derivative beyond those
  raises.

Scope guard (:func:`supports_forward_sens`): models whose segment grid
depends on the parameters (lag, fa) take the stepper path: the variational
system cannot see a moving segment boundary.
"""

from __future__ import annotations

import torch

from .grid import OccasionArrays
from .lanes import LaneProgram
from .sim import as_vector, simulate_occasion

__all__ = ["SENS_DEPTH", "augmented_equation", "make_sens_pred", "supports_forward_sens"]

# the orders of derivative the tower gives: the Laplace pipeline with
# standard errors differentiates four times (inner Hessian 2, outer gradient 3,
# standard-error Hessian 4)
SENS_DEPTH = 4


def supports_forward_sens(eq) -> bool:
    """True when ``eq`` can take the continuous-sensitivity path: an ODE
    model without lag or fa."""
    if getattr(eq, "kind", None) != "ode":
        return False
    return eq._lag is None and eq._fa is None


def _traced_rhs(eq, n_params: int):
    """The model's RHS as a traced graph over ``n_params`` parameters (its
    own when it is a symbolic level already; list-style or vector-style, as
    the generator takes it), or None where the generator cannot express the
    closure (a covariate read, an unsupported operation): the augmented
    model then differentiates the closure by ``torch.func``."""
    from ..errors import PharmsolError
    from ..ops.rhs_codegen import _ODE_ARGS, _sizes, _traced

    graph = getattr(eq._diffeq, "sens_graph", None)
    if graph is not None:
        return graph
    args = _sizes(_ODE_ARGS, eq._nstates, n_params, max(eq._ndrugs, 1))
    try:
        return _traced(eq._diffeq, args, eq._nstates, "RHS", "ODE", ((), ()))[0]
    except PharmsolError:
        return None


def _symbolic_aug_rhs(graph, n: int, n_params: int):
    """The augmented RHS ``[f; (df/dx) s + (df/dp) p_dot]`` built from the
    traced graph by symbolic forward mode (``rhs_codegen.tangents``): the
    tangent seeds are the augmented state's and parameters' second halves.
    None when an operation has no derivative rule."""
    from ..errors import PharmsolError
    from ..ops.rhs_codegen import Sym, tangents

    try:
        tx = tangents(graph, wrt="x", seed="x", seed_offset=n)
        tp = tangents(graph, wrt="p", seed="p", seed_offset=n_params)
    except PharmsolError:
        return None
    aug = list(graph) + [Sym("add", (a, b)) for a, b in zip(tx, tp)]
    program = LaneProgram(aug)

    def aug_diffeq(x_aug, p_aug, t, b, rateiv, cov):
        return program(x=x_aug, p=p_aug, t=t, b=b, rateiv=rateiv)

    aug_diffeq.sens_graph = aug
    # the engine may call it on every lane at once (engine/ode.py::lane_rhs)
    aug_diffeq.lanes = True
    return aug_diffeq


def augmented_equation(eq, n_params: int):
    """The ODE ``[x; s]`` over parameters ``[p; p_dot]`` (twice the states,
    parameters and outputs of ``eq``, whose parameter vector has
    ``n_params`` entries), cached on ``eq`` per solver options and parameter
    count. For a closure the RHS generator can trace, the augmented RHS is
    one straight-line program on all lanes, its tangent half built
    symbolically; otherwise it is the closure's ``torch.func.jvp``, lane by
    lane."""
    from ..models.equation import ODE

    cache = eq.__dict__.setdefault("_sens_aug_eq", {})
    key = (eq._opts, n_params)
    aug = cache.get(key)
    if aug is not None:
        return aug
    diffeq, user_init, n, nout = eq._diffeq, eq._init, eq._nstates, eq._nout
    base_out = eq._out or (lambda x, p, t, cov: x[:nout])

    def halves(p_aug):
        npar = p_aug.shape[0] // 2
        return p_aug[:npar], p_aug[npar:]

    graph = _traced_rhs(eq, n_params)
    aug_diffeq = None if graph is None else _symbolic_aug_rhs(graph, n, n_params)
    if aug_diffeq is None:
        def aug_diffeq(x_aug, p_aug, t, b, rateiv, cov):
            p, pd = halves(p_aug)
            primal, tangent = torch.func.jvp(
                lambda xx, pp: as_vector(diffeq(xx, pp, t, b, rateiv, cov), xx).reshape(n),
                (x_aug[:n], p), (x_aug[n:], pd))
            return torch.cat([primal, tangent])

    aug_init = None
    if user_init is not None:
        def aug_init(p_aug, t, cov):
            p, pd = halves(p_aug)
            x0, s0 = torch.func.jvp(lambda pp: as_vector(user_init(pp, t, cov), pp).reshape(n),
                                    (p,), (pd,))
            return torch.cat([x0, s0])

    def aug_out(x_aug, p_aug, t, cov):
        p, pd = halves(p_aug)
        y, yd = torch.func.jvp(
            lambda xx, pp: as_vector(base_out(xx, pp, t, cov), xx).reshape(nout),
            (x_aug[:n], p), (x_aug[n:], pd))
        return torch.cat([y, yd])

    aug = ODE(aug_diffeq, init=aug_init, out=aug_out, nstates=2 * n, ndrugs=eq._ndrugs,
              nout=2 * nout)
    aug._opts = eq._opts
    cache[key] = aug
    return aug


def tile_rows(rows: OccasionArrays, k: int) -> OccasionArrays:
    """``rows`` repeated ``k`` times along the row axis (direction-major)."""
    return OccasionArrays(*(a.repeat((k,) + (1,) * (a.dim() - 1)) for a in rows))


class _Level:
    """One level of the sensitivity tower: the per-row march of ``eq`` on
    ``rows`` at parameters ``cat([p, const])``, whose derivatives reach
    ``p`` only (``const`` holds the lower levels' directions), ``depth``
    orders of them."""

    def __init__(self, eq, rows: OccasionArrays, cov_names, depth: int):
        self.eq, self.rows, self.names, self.depth = eq, rows, tuple(cov_names), depth
        self._up = {}

    def base(self, full: torch.Tensor) -> torch.Tensor:
        """Every output at the observation slots [R, NO, nout]."""
        return simulate_occasion(self.eq.spec, self.rows, full, self.names,
                                 per_row=True).y_all[0]

    def y_all(self, p: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
        return _SensYAll.apply(p, const, self)

    def tiled(self, k: int) -> "_Level":
        """This level over its rows repeated ``k`` times."""
        key = ("tiled", k)
        lvl = self._up.get(key)
        if lvl is None:
            lvl = self._up[key] = _Level(self.eq, tile_rows(self.rows, k), self.names,
                                         self.depth)
        return lvl

    def up(self, k: int, n_params: int) -> "_Level":
        """The augmented model's level (over ``n_params`` parameters) on the
        rows repeated ``k`` times."""
        if self.depth <= 0:
            from ..errors import PharmsolError

            raise PharmsolError(
                f"forward sensitivities give {SENS_DEPTH} orders of derivative; "
                "a higher order was asked for")
        lvl = self._up.get((k, n_params))
        if lvl is None:
            lvl = self._up[(k, n_params)] = _Level(augmented_equation(self.eq, n_params),
                                                   tile_rows(self.rows, k), self.names,
                                                   self.depth - 1)
        return lvl

    def tangents(self, p: torch.Tensor, const: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """The derivative [k, R, NO, nout] of :meth:`y_all` along each of the
        ``k`` directions ``V`` [k, R, P] of ``p``: one augmented solve whose
        rows are the directions' copies of the rows."""
        k = V.shape[0]
        R, P = p.shape
        C = const.shape[-1]
        pk = p.unsqueeze(0).expand(k, R, P).reshape(k * R, P)
        ck = torch.cat([const.unsqueeze(0).expand(k, R, C), V.to(p.dtype),
                        p.new_zeros(k, R, C)], -1).reshape(k * R, P + 2 * C)
        y2 = self.up(k, P + C).y_all(pk, ck)  # [k * R, NO, 2 nout]
        nout = self.eq._nout
        return y2[..., nout:].reshape((k, R) + y2.shape[1:-1] + (nout,))


class _SensYAll(torch.autograd.Function):
    """``y_all(p, const)`` of one :class:`_Level` with the sensitivity rule
    (see the module docstring)."""

    @staticmethod
    def forward(p, const, level):
        return level.base(torch.cat([p, const], -1))

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, const, level = inputs
        ctx.level = level
        ctx.save_for_backward(p, const)
        ctx.save_for_forward(p, const)

    @staticmethod
    def backward(ctx, g):
        p, const = ctx.saved_tensors
        R, P = p.shape
        basis = torch.eye(P, dtype=p.dtype, device=p.device)
        J = ctx.level.tangents(p, const, basis[:, None, :].expand(P, R, P))
        return (g.unsqueeze(0) * J).sum(dim=(2, 3)).transpose(0, 1), None, None

    @staticmethod
    def jvp(ctx, p_dot, const_dot, _):
        # derivatives reach p only: const holds constant directions
        p, const = ctx.saved_tensors
        return ctx.level.tangents(p, const, p_dot.unsqueeze(0))[0]

    @staticmethod
    def vmap(info, in_dims, p, const, level):
        B = info.batch_size

        def batched(a, d):
            return a.unsqueeze(0).expand((B,) + a.shape) if d is None else a.movedim(d, 0)

        p, const = batched(p, in_dims[0]), batched(const, in_dims[1])
        R = p.shape[1]
        out = level.tiled(B).y_all(p.reshape(B * R, -1), const.reshape(B * R, -1))
        return out.reshape((B, R) + out.shape[1:]), 0


def make_sens_pred(eq, rows: OccasionArrays, cov_names):
    """``pred(p_rows) -> [R, NO]``: the predictions of every row under its
    own parameter row (``p_rows`` [R, n_params]), whose derivatives in
    ``p_rows`` (up to :data:`SENS_DEPTH` orders) integrate augmented
    sensitivity systems instead of differentiating the adaptive stepper."""
    level = _Level(eq, rows, cov_names, SENS_DEPTH)
    idx = rows.obs_outeq.unsqueeze(-1)

    def pred(p_rows: torch.Tensor) -> torch.Tensor:
        y = level.y_all(p_rows, p_rows.new_zeros(p_rows.shape[0], 0))
        return torch.gather(y, 2, idx)[..., 0]

    return pred
