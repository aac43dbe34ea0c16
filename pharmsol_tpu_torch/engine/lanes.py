"""Closures as straight-line programs on every lane, and the two ways to run
an adaptive march.

The general engine calls a model's closures lane by lane under
``torch.func.vmap`` and takes an implicit solver's Jacobian by
``torch.func.jacfwd``; its adaptive marches loop in Python on ``while
bool(active.any())``. ``torch.export`` can trace none of that inside a
loop, so the exported programs (``ops/export.py``) take these instead:

- :class:`LaneProgram` runs a traced closure graph (``ops/rhs_codegen.py``'s
  symbolic scalars) as straight-line torch operations on tensors with any
  leading dims: one call serves every lane at once, with no vmap. The
  sensitivity tower (``engine/sens.py``) runs its augmented RHS with it too.
- :class:`CovLanes` reads a covariate for every lane at the lane's own time
  from its row's knots: ``grid.py::CovView``'s interpolation and
  carry-forward, batched.
- :class:`RhsLanes` and :class:`SdeLanes` trace an ODE's RHS (with its state
  Jacobian by symbolic tangents for the implicit solvers) and an SDE's drift
  and diffusion into such programs, covariate reads included; a closure the
  tracer cannot express raises PharmsolError naming the construct.
- :func:`march` drives one adaptive march from its step body: eagerly by the
  Python loop, under ``torch.export`` by ``while_loop``; :func:`repeat` runs
  a fixed count of Newton iterations the same way, so that a traced step
  body holds one iteration, not every one.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..errors import PharmsolError


class LaneProgram:
    """A traced closure graph as straight-line torch operations on tensors
    with any leading dims: the closure's arguments by name, ``x``, ``p``,
    ``b``, ``rateiv`` (and a tangent seed ``v``) indexed along their last
    axis, ``t`` as it is, covariate reads through ``cov(i, t)``. Broadcasts,
    so one program serves every lane of a march at once and a single lane
    under ``vmap``."""

    def __init__(self, outputs):
        from ..ops.rhs_codegen import _TORCH_BINARY, _TORCH_UNARY, _topo

        slot = {}
        self.leaves, self.steps = [], []

        def ref(node):
            if node.op == "const":
                return ("c", float(node.value))
            if node.op == "bconst":
                return ("c", bool(node.value))
            if id(node) not in slot:  # a leaf
                slot[id(node)] = len(slot)
                self.leaves.append((slot[id(node)], node.op, node.value))
            return ("s", slot[id(node)])

        for node in _topo(outputs):
            args = [ref(a) for a in node.args]
            if node.op in ("cov", "cast"):
                fn = (node.op, node.value)  # read at call time
            else:
                fn = (torch.where if node.op == "where" else _TORCH_UNARY.get(node.op)
                      or _TORCH_BINARY[node.op])
            slot[id(node)] = len(slot)
            self.steps.append((slot[id(node)], fn, args))
        self.outputs = [ref(o) for o in outputs]
        self.n_slots = len(slot)

    def __call__(self, cov=None, **leaves) -> torch.Tensor:
        vals = [None] * self.n_slots
        for i, name, idx in self.leaves:
            leaf = leaves[name]
            vals[i] = leaf if idx is None else leaf[..., idx]
        base = leaves["x"][..., 0] if "x" in leaves else leaves["t"]

        def get(a):
            return vals[a[1]] if a[0] == "s" else a[1]

        for i, fn, args in self.steps:
            if isinstance(fn, tuple):
                a = get(args[0])
                vals[i] = cov(fn[1], a) if fn[0] == "cov" else a.to(base.dtype)
            else:
                vals[i] = fn(*[get(a) for a in args])
        outs = [get(o) for o in self.outputs]
        outs = [o if isinstance(o, torch.Tensor) else torch.full_like(base, o) for o in outs]
        return torch.stack(torch.broadcast_tensors(base, *outs)[1:], dim=-1)


class CovLanes:
    """``cov(i, t)``: covariate ``i`` of every lane at the lane's time ``t``
    from its row's knots (``knot_t``/``knot_v`` [R, ncov, K], ``fixed``
    [R, ncov]), with :meth:`~.grid.CovView.value`'s interpolation (linear
    between knots, the first value carried backward and the last forward,
    carry-forward for a fixed covariate) in the same operations. The lanes'
    row axis is ``-(1 + trailing)``."""

    def __init__(self, knot_t, knot_v, fixed, trailing: int = 0):
        self.knot_t, self.knot_v, self.fixed = knot_t, knot_v, fixed
        self.trailing = trailing

    def __call__(self, i: int, t) -> torch.Tensor:
        R, K = self.knot_t.shape[0], self.knot_t.shape[-1]
        rows = (R,) + (1,) * self.trailing
        ts = self.knot_t[:, i, :].reshape(rows + (K,))
        vs = self.knot_v[:, i, :].reshape(rows + (K,))
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        lane = torch.broadcast_shapes(t.shape, rows)
        # clamp into the knot range: carries first backward / last forward
        tc = torch.minimum(torch.maximum(t, ts[..., 0]), ts[..., K - 1]).expand(lane)
        # rightmost knot <= tc (searchsorted 'right' - 1)
        idx = torch.clamp((ts <= tc[..., None]).sum(dim=-1) - 1, 0, K - 1)[..., None]
        nxt = torch.clamp(idx + 1, max=K - 1)
        tsb, vsb = ts.expand(lane + (K,)), vs.expand(lane + (K,))
        t0, t1 = tsb.gather(-1, idx)[..., 0], tsb.gather(-1, nxt)[..., 0]
        v0, v1 = vsb.gather(-1, idx)[..., 0], vsb.gather(-1, nxt)[..., 0]
        denom = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
        lin = torch.where(t1 > t0, v0 + (v1 - v0) * (tc - t0) / denom, v0)
        return torch.where(self.fixed[:, i].reshape(rows), v0, lin)


def traced_graph(fn: Callable, args, n_out: int, what: str, family: str,
                 cov_names: Sequence[str]):
    """The graph of ``fn`` traced in the first style that takes it, every
    covariate read kept as a read at the closure's time; PharmsolError
    naming the construct where the tracer cannot express the closure."""
    from ..ops.rhs_codegen import _traced

    names = tuple(str(n) for n in cov_names)
    return _traced(fn, args, n_out, what, family, (names, ("read",) * len(names)),
                   target="be exported")[0]


class RhsLanes:
    """An ODE closure ``diffeq(x, p, t, b, rateiv, cov)`` as lane programs:
    the RHS and, with ``jacobian``, its state Jacobian by symbolic forward
    mode (``rhs_codegen.tangents``) in place of ``jacfwd``."""

    def __init__(self, diffeq: Callable, nstates: int, n_params: int, ninput: int,
                 cov_names: Sequence[str], jacobian: bool):
        from ..ops.rhs_codegen import _ODE_ARGS, _sizes, tangents

        graph = getattr(diffeq, "sens_graph", None)
        if graph is None:
            graph = traced_graph(diffeq, _sizes(_ODE_ARGS, nstates, n_params, max(ninput, 1)),
                                 nstates, "RHS", "ODE", cov_names)
        self.rhs = LaneProgram(graph)
        self.jv = None
        if jacobian:
            try:
                self.jv = LaneProgram(tangents(graph))
            except PharmsolError as e:
                raise PharmsolError(f"the ODE RHS has no Jacobian to export: {e}") from None

    def bind(self, p: torch.Tensor, rateiv: torch.Tensor, cov) -> tuple:
        """``(f(x, t), jac(x, t))`` on lanes [S, R]: ``p`` [S, P] (or
        [S, R, P]), ``rateiv`` [S, R, ninput], ``cov`` every row's knots (a
        :class:`~.grid.CovView` over the rows); ``x`` [S, R, n], ``t`` [S, R];
        the Jacobian [S, R, n, n]."""
        pl = p.unsqueeze(-2) if p.dim() == 2 else p
        b = torch.zeros_like(rateiv)
        knots = (cov.knot_t, cov.knot_v, cov.fixed)
        read, read_cols = CovLanes(*knots), CovLanes(*knots, trailing=1)

        def f(x, t):
            return self.rhs(x=x, p=pl, t=t, b=b, rateiv=rateiv, cov=read)

        def jac(x, t):
            # every column at once: the seeds e_j along a new axis before the
            # states, (df/dx) e_j there; then rows i, columns j
            eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
            cols = self.jv(x=x.unsqueeze(-2), p=pl.unsqueeze(-2), t=t.unsqueeze(-1),
                           b=b.unsqueeze(-2), rateiv=rateiv.unsqueeze(-2), v=eye,
                           cov=read_cols)
            return cols.transpose(-1, -2)

        return f, jac


class SdeLanes:
    """An SDE's ``drift(x, p, t, rateiv, cov)`` and ``diffusion(p, t, cov)``
    as lane programs."""

    def __init__(self, drift: Callable, diffusion: Callable, nstates: int, n_params: int,
                 ninput: int, cov_names: Sequence[str]):
        from ..ops.rhs_codegen import _DIFFUSION_ARGS, _DRIFT_ARGS, _sizes

        ninput = max(ninput, 1)
        self.drift = LaneProgram(traced_graph(
            drift, _sizes(_DRIFT_ARGS, nstates, n_params, ninput), nstates, "drift", "SDE",
            cov_names))
        self.diffusion = LaneProgram(traced_graph(
            diffusion, _sizes(_DIFFUSION_ARGS, nstates, n_params, ninput), nstates,
            "diffusion", "SDE", cov_names))

    def bind(self, knot_t, knot_v, fixed) -> tuple:
        """``(drift(X, p, t, rateiv), diffusion(p, t))`` as the engine's
        batched closures: clouds ``X`` [S, R, P, n], ``p`` [S, n_params] (or
        [S, R, n_params]), times [S, R], rates [S, R, ninput]; the diffusion
        [S, R, n]."""
        read_cells = CovLanes(knot_t, knot_v, fixed)
        read_particles = CovLanes(knot_t, knot_v, fixed, trailing=1)

        def cells(p):
            return p.unsqueeze(-2) if p.dim() == 2 else p

        def drift(X, p, t, rateiv):
            return self.drift(x=X, p=cells(p).unsqueeze(-2), t=t.unsqueeze(-1),
                              rateiv=rateiv.unsqueeze(-2), cov=read_particles)

        def diffusion(p, t):
            return self.diffusion(p=cells(p), t=t, cov=read_cells)

        return drift, diffusion


def march(cond: Callable, body: Callable, carry: tuple) -> tuple:
    """Run an adaptive march: ``carry = body(active, *carry)`` while any lane
    is active, ``active = cond(*carry)``. Eagerly a Python loop that reads
    ``active.any()`` on the host every trip; under ``torch.export`` a
    ``while_loop`` whose condition is the same 0-d ``any``. ``body`` must
    keep every carried tensor's shape and dtype and return new tensors."""
    carry = tuple(carry)
    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop

        return tuple(while_loop(lambda *c: cond(*c).any(),
                                lambda *c: tuple(body(cond(*c), *c)), carry))
    active = cond(*carry)
    while bool(active.any()):
        carry = tuple(body(active, *carry))
        active = cond(*carry)
    return carry


def repeat(count: int, step: Callable, state: tuple) -> tuple:
    """``state = step(*state)`` ``count`` times: eagerly a Python loop, under
    ``torch.export`` a ``while_loop`` on a 0-d counter."""
    state = tuple(state)
    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop

        i = torch.zeros((), dtype=torch.int64, device=state[0].device)
        return tuple(while_loop(lambda i, *s: i < count,
                                lambda i, *s: (i + 1,) + tuple(step(*s)), (i,) + state))[1:]
    for _ in range(count):
        state = tuple(step(*state))
    return state
