"""Pure-Python `.pkm` evaluator: the portable-target replacement for WASM.

The reference ships models to foreign hosts as WASM bundles
(src/dsl/wasm_compile.rs:30-43) executed by wasmtime or a browser. Here the
`.pkm` artifact is plain JSON carrying the analyzed statement IR, and this
evaluator runs it with NOTHING but the Python standard library — no torch,
no jax, no numpy, no compilation. Any host that can parse JSON and evaluate
arithmetic can run a pharmsol model; this file is the reference
implementation of that contract (the analogue of the reference's browser JS
loader). It is the same file as the JAX package's ``dsl/pure.py``, and reads
artifacts written by either package.

Covers: derive / outputs / init / dynamics (drift) statement roles, lag/fa
route tables, constants, covariate carry/linear interpolation, and a
``simulate`` for EVERY model kind — so a `.pkm` produced from any
authoring surface runs identically in all three tiers (the torch engine,
.pkm-reload, pure):

- **ode**: fixed-step RK4 over the event timeline;
- **analytical**: EXACT closed-form segment propagation — the kernel's
  compartment matrix is built from the artifact's kernel plan and
  propagated with a stdlib matrix exponential (scaling-and-squaring
  Taylor on the affine augmented system), re-deriving kernel inputs at
  each segment end exactly like the engine;
- **sde**: fixed-step Euler-Maruyama particle cloud with
  ``random.Random`` draws (mean predictions; zero-diffusion artifacts
  reproduce the deterministic tiers).

Demonstration-grade throughput; the production path is the torch engine.
"""

from __future__ import annotations

import json
import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .ast import Expr, Stmt
from .diagnostic import Diagnostic, DslError, Span

_INTRINSICS = {
    "abs": abs,
    "min": min,
    "max": max,
    "floor": math.floor,
    "ceil": math.ceil,
    "exp": math.exp,
    "ln": math.log,
    "log": math.log,
    "log10": math.log10,
    "log2": math.log2,
    "pow": pow,
    "round": round,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "sqrt": math.sqrt,
}

_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "^": pow,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&&": lambda a, b: bool(a) and bool(b),
    "||": lambda a, b: bool(a) or bool(b),
}


def eval_expr_py(expr: Expr, env: Dict[str, float]):
    """Evaluate one expression on plain Python floats."""
    if expr.kind == "number":
        return expr.value
    if expr.kind == "bool":
        return bool(expr.value)
    if expr.kind == "name":
        try:
            return env[expr.name]
        except KeyError:
            raise DslError(Diagnostic.error(
                "DSL3001", f"unbound name `{expr.name}` at runtime", expr.span))
    if expr.kind == "unary":
        v = eval_expr_py(expr.args[0], env)
        if expr.name == "-":
            return -v
        if expr.name == "+":
            return v
        return not bool(v)
    if expr.kind == "binary":
        a = eval_expr_py(expr.args[0], env)
        b = eval_expr_py(expr.args[1], env)
        return _BINOPS[expr.name](a, b)
    if expr.kind == "call":
        fn = _INTRINSICS.get(expr.name)
        if fn is None:
            raise DslError(Diagnostic.error(
                "DSL3002", f"unknown function `{expr.name}` at runtime", expr.span))
        return fn(*(eval_expr_py(a, env) for a in expr.args))
    if expr.kind == "index":
        base, idx = expr.args
        i = int(eval_expr_py(idx, env))
        return env[f"{base.name}[{i}]"]
    raise DslError(Diagnostic.error(
        "DSL3003", f"unsupported expression `{expr.kind}`", expr.span))


def eval_stmts_py(stmts: List[Stmt], env: Dict[str, float]) -> Dict[str, float]:
    """Evaluate statements in order; `if` takes ONE branch (host control flow)."""
    for s in stmts:
        if s.kind in ("assign", "let"):
            if s.kind == "assign" and s.target_kind == "call":
                for a in s.target_args:
                    env[f"{s.target}:{a}"] = eval_expr_py(s.value, env)
            elif s.kind == "assign" and s.target_kind == "index":
                i = int(eval_expr_py(s.index_expr, env))
                env[f"{s.target}:{s.index_base}[{i}]"] = eval_expr_py(s.value, env)
            else:
                env[s.target] = eval_expr_py(s.value, env)
        elif s.kind == "if":
            branch = s.then_branch if eval_expr_py(s.condition, env) else s.else_branch
            eval_stmts_py(branch, env)
        elif s.kind == "for":
            lo = int(eval_expr_py(s.range_start, env))
            hi = int(eval_expr_py(s.range_end, env))
            for i in range(lo, hi):
                env[s.binding] = float(i)
                eval_stmts_py(s.body, env)
            env.pop(s.binding, None)
    return env


class PureCovariate:
    """Carry/linear interpolation over (time, value) knots — stdlib only."""

    def __init__(self, knots: Sequence[Tuple[float, float]], fixed: bool = False):
        self.knots = sorted((float(t), float(v)) for t, v in knots)
        self.fixed = fixed

    def __call__(self, t: float) -> float:
        ks = self.knots
        if not ks:
            return 0.0
        if t <= ks[0][0]:
            return ks[0][1]
        for (t0, v0), (t1, v1) in zip(ks, ks[1:]):
            if t0 <= t < t1:
                if self.fixed or t1 == t0:
                    return v0
                return v0 + (v1 - v0) * (t - t0) / (t1 - t0)
        return ks[-1][1]


# Compartment matrices of the closed-form kernels in MICRO-CONSTANT
# parameterization (engine/analytical.py conventions: depot first for
# *_with_absorption, infusions into central). Each entry:
# (n_micro_params, builder(kp) -> (A rows, central index)).
def _A_1cmt(kp):
    (ke,) = kp
    return [[-ke]], 0


def _A_1cmt_oral(kp):
    ka, ke = kp
    return [[-ka, 0.0], [ka, -ke]], 1


def _A_2cmt(kp):
    ke, kcp, kpc = kp
    return [[-(ke + kcp), kpc], [kcp, -kpc]], 0


def _A_2cmt_oral(kp):
    ke, ka, kcp, kpc = kp
    return [
        [-ka, 0.0, 0.0],
        [ka, -(ke + kcp), kpc],
        [0.0, kcp, -kpc],
    ], 1


def _A_3cmt(kp):
    k10, k12, k13, k21, k31 = kp
    return [
        [-(k10 + k12 + k13), k21, k31],
        [k12, -k21, 0.0],
        [k13, 0.0, -k31],
    ], 0


def _A_3cmt_oral(kp):
    ka, k10, k12, k13, k21, k31 = kp
    return [
        [-ka, 0.0, 0.0, 0.0],
        [ka, -(k10 + k12 + k13), k21, k31],
        [0.0, k12, -k21, 0.0],
        [0.0, k13, 0.0, -k31],
    ], 1


# CL -> micro remaps (engine/analytical.py *_cl kernels).
_PURE_KERNELS = {
    "one_compartment": (lambda kp: kp, _A_1cmt),
    "one_compartment_with_absorption": (lambda kp: kp, _A_1cmt_oral),
    "one_compartment_cl": (lambda kp: [kp[0] / kp[1]], _A_1cmt),
    "one_compartment_cl_with_absorption": (
        lambda kp: [kp[0], kp[1] / kp[2]], _A_1cmt_oral),
    "two_compartments": (lambda kp: kp, _A_2cmt),
    "two_compartments_with_absorption": (lambda kp: kp, _A_2cmt_oral),
    "two_compartments_cl": (
        lambda kp: [kp[0] / kp[2], kp[1] / kp[2], kp[1] / kp[3]], _A_2cmt),
    "two_compartments_cl_with_absorption": (
        lambda kp: [kp[1] / kp[3], kp[0], kp[2] / kp[3], kp[2] / kp[4]],
        _A_2cmt_oral),
    "three_compartments": (lambda kp: kp, _A_3cmt),
    "three_compartments_with_absorption": (lambda kp: kp, _A_3cmt_oral),
    "three_compartments_cl": (
        lambda kp: [kp[0] / kp[3], kp[1] / kp[3], kp[2] / kp[3],
                    kp[1] / kp[4], kp[2] / kp[5]], _A_3cmt),
    "three_compartments_cl_with_absorption": (
        lambda kp: [kp[0], kp[1] / kp[4], kp[2] / kp[4], kp[3] / kp[4],
                    kp[2] / kp[5], kp[3] / kp[6]], _A_3cmt_oral),
}


def _expm_affine_py(A: List[List[float]], u: List[float], dt: float):
    """(P, q) with exp([[A*dt, u*dt], [0, 0]]) = [[P, q], [0, 1]].

    Stdlib scaling-and-squaring with a 13-term Taylor-Horner chain on the
    affine block form (the pure twin of engine/ode._expm_affine).
    """
    n = len(A)
    Adt = [[A[i][j] * dt for j in range(n)] for i in range(n)]
    udt = [u[i] * dt for i in range(n)]
    norm = max(
        (sum(abs(Adt[i][j]) for j in range(n)) + abs(udt[i]))
        for i in range(n)
    ) if n else 0.0
    s = max(0, math.ceil(math.log2(norm))) if norm > 1.0 else 0
    scale = 0.5 ** s
    As = [[Adt[i][j] * scale for j in range(n)] for i in range(n)]
    us = [udt[i] * scale for i in range(n)]

    def mm(X, Y):
        return [
            [sum(X[i][l] * Y[l][j] for l in range(n)) for j in range(n)]
            for i in range(n)
        ]

    def mv(X, y):
        return [sum(X[i][l] * y[l] for l in range(n)) for i in range(n)]

    eye = [[1.0 if i == j else 0.0 for j in range(n)] for i in range(n)]
    P = [[eye[i][j] + As[i][j] / 13.0 for j in range(n)] for i in range(n)]
    q = [us[i] / 13.0 for i in range(n)]
    for d in range(12, 0, -1):
        AP = mm(As, P)
        P = [[eye[i][j] + AP[i][j] / d for j in range(n)] for i in range(n)]
        Aq = mv(As, q)
        q = [(Aq[i] + us[i]) / d for i in range(n)]
    for _ in range(s):
        q = [a + b for a, b in zip(mv(P, q), q)]
        P = mm(P, P)
    return P, q


class PureModel:
    """A `.pkm` artifact evaluated with the Python standard library only."""

    def __init__(self, payload: dict):
        model = payload["model"]
        self.name = model["name"]
        self.kind = model["kind"]
        self.parameters: List[str] = list(model["parameters"])
        self.covariates: List[str] = [c[0] for c in model["covariates"]]
        self.states: List[str] = list(model["states"])
        self.state_arrays: Dict[str, int] = {
            k: int(v) for k, v in model.get("state_arrays", {}).items()
        }
        self.outputs: List[str] = list(model["outputs"])
        self.constants: Dict[str, float] = dict(model["constants"])
        self.routes = list(model["routes"])
        self.derived: List[str] = list(model.get("derived", []))
        self.analytical_kernel: Optional[str] = model.get("analytical")
        self.kernel_plan: Optional[dict] = model.get("kernel_plan")
        self.particles: Optional[int] = model.get("particles")
        self._derive = [Stmt.from_json(s) for s in model["derive"]]
        self._dynamics = [Stmt.from_json(s) for s in model["dynamics"]]
        self._outputs = [Stmt.from_json(s) for s in model["outputs_stmts"]]
        self._init = [Stmt.from_json(s) for s in model["init"]]
        self._diffusion = [
            Stmt.from_json(s) for s in model.get("diffusion", [])
        ]
        self._state_slots = self._expand_state_slots()

    @staticmethod
    def load(path: str) -> "PureModel":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != "pharmsol-tpu-pkm":
            raise DslError(Diagnostic.error(
                "DSL4002", f"`{path}` is not a pharmsol-tpu artifact", Span.empty()))
        return PureModel(payload)

    def _expand_state_slots(self) -> List[str]:
        slots: List[str] = []
        for s in self.states:
            if s in self.state_arrays:
                slots.extend(f"{s}[{i}]" for i in range(self.state_arrays[s]))
            else:
                slots.append(s)
        return slots

    @property
    def nstates(self) -> int:
        return len(self._state_slots)

    def _env(self, params: Sequence[float], t: float,
             cov: Optional[Dict[str, PureCovariate]] = None) -> Dict[str, float]:
        env: Dict[str, float] = {"t": float(t)}
        for name, value in zip(self.parameters, params):
            env[name] = float(value)
        for name in self.covariates:
            env[name] = cov[name](t) if cov and name in cov else 0.0
        env.update(self.constants)
        return eval_stmts_py(self._derive, env)

    def derive(self, params, t=0.0, cov=None) -> Dict[str, float]:
        env = self._env(params, t, cov)
        return {k: v for k, v in env.items() if k not in self.constants}

    def init(self, params, cov=None) -> List[float]:
        env = self._env(params, 0.0, cov)
        eval_stmts_py(self._init, env)
        return [env.get(f"init:{s}", 0.0) for s in self._state_slots]

    def dynamics(self, x: Sequence[float], params, t: float, cov=None) -> List[float]:
        env = self._env(params, t, cov)
        for slot, value in zip(self._state_slots, x):
            env[slot] = float(value)
        eval_stmts_py(self._dynamics, env)
        return [env.get(f"dx:{s}", 0.0) for s in self._state_slots]

    def out(self, x: Sequence[float], params, t: float, cov=None) -> List[float]:
        env = self._env(params, t, cov)
        for slot, value in zip(self._state_slots, x):
            env[slot] = float(value)
        eval_stmts_py(self._outputs, env)
        return [env.get(f"out:{o}", 0.0) for o in self.outputs]

    def diffusion(self, params, t: float, cov=None) -> List[float]:
        """Per-state diffusion coefficients g[nstates] (SDE artifacts)."""
        env = self._env(params, t, cov)
        eval_stmts_py(self._diffusion, env)
        # runtime parity: noise targets are keyed per STATE name
        return [env.get(f"noise:{s}", 0.0) for s in self.states]

    def kernel_inputs(self, params, t: float, cov=None) -> List[float]:
        """Kernel parameter vector via the artifact's kernel plan bindings.

        Mirrors dsl/runtime.make_analytical_propagate: primary -> declared
        parameter column, derived -> the derive env, covariate -> the
        covariate value at t.
        """
        if not self.kernel_plan:
            raise DslError(Diagnostic.error(
                "DSL3005", "artifact has no analytical kernel plan",
                Span.empty()))
        env = self._env(params, t, cov)
        out = []
        for source, index in self.kernel_plan["bindings"]:
            if source == "primary":
                out.append(float(params[index]))
            elif source == "covariate":
                name = self.covariates[index]
                out.append(cov[name](t) if cov and name in cov else 0.0)
            else:
                out.append(float(env[self.derived[index]]))
        return out

    def simulate(self, params, boluses, obs_times, cov=None, dt=0.01,
                 nparticles=None, seed=0):
        """Event-timeline simulation for EVERY artifact kind.

        ``boluses``: list of (time, amount, state_index). ODE-kind runs
        fixed-step RK4; analytical-kind propagates segments EXACTLY via the
        kernel compartment matrix and a stdlib matrix exponential
        (kernel inputs re-derived at each segment end, engine parity);
        sde-kind advances a fixed-step Euler-Maruyama particle cloud and
        reports mean outputs. Demonstration-grade portable execution — the
        production path is the torch engine.
        """
        if self.kind == "analytical":
            return self._simulate_analytical(params, boluses, obs_times, cov)
        if self.kind == "sde":
            return self._simulate_sde(
                params, boluses, obs_times, cov, dt=dt,
                nparticles=nparticles, seed=seed,
            )
        if self.kind != "ode":
            raise DslError(Diagnostic.error(
                "DSL3004", f"pure simulate supports ode/analytical/sde "
                f"models, not {self.kind}", Span.empty()))
        x = self.init(params, cov)
        t = 0.0
        events = sorted(
            [(bt, "bolus", amt, idx) for bt, amt, idx in boluses]
            + [(ot, "obs", 0.0, 0) for ot in obs_times]
        )
        results = []

        def rk4_to(t0, t1, x):
            n = max(1, int(math.ceil((t1 - t0) / dt)))
            h = (t1 - t0) / n
            for i in range(n):
                ti = t0 + i * h
                k1 = self.dynamics(x, params, ti, cov)
                k2 = self.dynamics([a + 0.5 * h * b for a, b in zip(x, k1)],
                                   params, ti + 0.5 * h, cov)
                k3 = self.dynamics([a + 0.5 * h * b for a, b in zip(x, k2)],
                                   params, ti + 0.5 * h, cov)
                k4 = self.dynamics([a + h * b for a, b in zip(x, k3)],
                                   params, ti + h, cov)
                x = [a + h / 6.0 * (b1 + 2 * b2 + 2 * b3 + b4)
                     for a, b1, b2, b3, b4 in zip(x, k1, k2, k3, k4)]
            return x

        for et, kind, amount, idx in events:
            if et > t:
                x = rk4_to(t, et, x)
                t = et
            if kind == "obs":
                results.append(self.out(x, params, t, cov))
            else:
                x[idx] += amount
        return results

    def _simulate_analytical(self, params, boluses, obs_times, cov=None):
        kname = self.analytical_kernel
        if kname not in _PURE_KERNELS:
            raise DslError(Diagnostic.error(
                "DSL3006", f"unknown analytical kernel `{kname}`",
                Span.empty()))
        remap, build_A = _PURE_KERNELS[kname]
        x = self.init(params, cov)
        n = len(x)
        t = 0.0
        events = sorted(
            [(bt, "bolus", amt, idx) for bt, amt, idx in boluses]
            + [(ot, "obs", 0.0, 0) for ot in obs_times]
        )
        results = []
        for et, kind, amount, idx in events:
            if et > t:
                # kernel inputs at the segment END (engine parity:
                # dsl/runtime.make_analytical_propagate derives at t0+dt)
                kp = remap(self.kernel_inputs(params, et, cov))
                A, _central = build_A(kp)
                P, q = _expm_affine_py(A, [0.0] * n, et - t)
                x = [
                    sum(P[i][j] * x[j] for j in range(n)) + q[i]
                    for i in range(n)
                ]
                t = et
            if kind == "obs":
                results.append(self.out(x, params, t, cov))
            else:
                x[idx] += amount
        return results

    def _simulate_sde(self, params, boluses, obs_times, cov=None, dt=0.01,
                      nparticles=None, seed=0):
        P_n = int(nparticles or self.particles or 100)
        rng = random.Random(seed)
        x0 = self.init(params, cov)
        n = len(x0)
        cloud = [list(x0) for _ in range(P_n)]
        t = 0.0
        events = sorted(
            [(bt, "bolus", amt, idx) for bt, amt, idx in boluses]
            + [(ot, "obs", 0.0, 0) for ot in obs_times]
        )
        results = []

        def em_to(t0, t1):
            steps = max(1, int(math.ceil((t1 - t0) / dt)))
            h = (t1 - t0) / steps
            sq = math.sqrt(h)
            for i in range(steps):
                ti = t0 + i * h
                g = self.diffusion(params, ti, cov)
                for part in cloud:
                    d = self.dynamics(part, params, ti, cov)
                    for s in range(n):
                        part[s] += d[s] * h + g[s] * rng.gauss(0.0, 1.0) * sq

        for et, kind, amount, idx in events:
            if et > t:
                em_to(t, et)
                t = et
            if kind == "obs":
                outs = [self.out(part, params, t, cov) for part in cloud]
                results.append([
                    sum(o[k] for o in outs) / P_n
                    for k in range(len(self.outputs))
                ])
            else:
                for part in cloud:
                    part[idx] += amount
        return results
