"""DSL analyzer: name/type checking and kernel structure planning.

Parity with pharmsol-dsl/src/{analyze.rs,analysis.rs}:

- namespaces (parameters / covariates / states / derived / outputs /
  constants) are checked for duplicates and cross-domain collisions;
- every free name in an expression must resolve in its role's scope, with
  edit-distance typo suggestions in the diagnostics;
- math intrinsics whitelist (analysis.rs MathFunction);
- analytical ``structure`` kernels validate state counts and bind their
  required parameter names against primary params and derived variables
  (AnalyticalStructureInputPlan, analysis.rs:301-423);
- SDE models require particles; lag/fa only on bolus routes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..engine.analytical import KERNELS
from .ast import DslModel, DslModelKind, DslModule, DslRouteKind, Expr, Stmt
from .diagnostic import Diagnostic, DslError, Span, best_suggestion

MATH_FUNCTIONS = {
    "abs", "min", "max", "floor", "ceil", "exp", "ln", "log", "log10",
    "log2", "pow", "round", "sin", "cos", "tan", "sqrt",
}

_ARITY = {
    "abs": 1, "floor": 1, "ceil": 1, "exp": 1, "ln": 1, "log": 1,
    "log10": 1, "log2": 1, "round": 1, "sin": 1, "cos": 1, "tan": 1,
    "sqrt": 1, "pow": 2, "min": 2, "max": 2,
}


@dataclass
class KernelPlan:
    """Sources for each required kernel input: ('primary'|'derived', index)."""

    kernel: str
    bindings: List[Tuple[str, int]]


@dataclass
class AnalyzedModel:
    name: str
    kind: DslModelKind
    parameters: List[str]
    covariates: List[Tuple[str, Optional[str]]]  # (name, interpolation)
    states: List[str]
    state_arrays: Dict[str, int]
    derived: List[str]
    outputs: List[str]
    constants: Dict[str, float]
    routes: List  # RouteDeclAst, with has_lag/has_fa resolved
    route_lag: Dict[str, Stmt]  # input label -> lag stmt
    route_fa: Dict[str, Stmt]
    derive_stmts: List[Stmt]
    dynamics_stmts: List[Stmt]
    output_stmts: List[Stmt]
    init_stmts: List[Stmt]
    diffusion_stmts: List[Stmt]
    output_annotations: Dict[str, tuple]
    analytical_kernel: Optional[str] = None
    kernel_plan: Optional[KernelPlan] = None
    particles: Optional[int] = None


def _collect_call_targets(stmts: List[Stmt], callee: str) -> Set[str]:
    """All `callee(arg)` assignment targets, including inside if/for bodies."""
    out: Set[str] = set()
    for s in stmts:
        if s.kind == "assign" and s.target_kind == "call" and s.target == callee:
            out.update(s.target_args)
        elif s.kind == "if":
            out |= _collect_call_targets(s.then_branch, callee)
            out |= _collect_call_targets(s.else_branch, callee)
        elif s.kind == "for":
            out |= _collect_call_targets(s.body, callee)
    return out


def _collect_index_targets(
    stmts: List[Stmt],
    callee: str,
    arrays: Dict[str, int],
    constants: Dict[str, float],
) -> Set[str]:
    """Expanded element names written via `callee(x[i])` / `callee[i]`.

    A constant index covers exactly its element. Constant-bounded ``for``
    loops (the only kind the interpreter accepts) are simulated iteration by
    iteration with the binding folded as a constant, so
    ``for i in 1..3 { dx[i] = ... }`` covers exactly elements 1 and 2 —
    partially-covered arrays still trip DSL2018. Only a genuinely
    undecidable index (non-const bound) falls back to whole-array coverage.
    """
    out: Set[str] = set()
    for s in stmts:
        if s.kind == "assign" and s.target_kind == "index" and s.target == callee:
            base = s.index_base
            if base is not None and base in arrays:
                cv = _const_value(s.index_expr, constants)
                if cv is not None:
                    out.add(f"{base}[{int(cv)}]")
                else:
                    out |= {f"{base}[{k}]" for k in range(arrays[base])}
        elif s.kind == "if":
            out |= _collect_index_targets(s.then_branch, callee, arrays, constants)
            out |= _collect_index_targets(s.else_branch, callee, arrays, constants)
        elif s.kind == "for":
            lo = _const_value(s.range_start, constants)
            hi = _const_value(s.range_end, constants)
            if lo is not None and hi is not None and int(hi) - int(lo) <= 4096:
                for i in range(int(lo), int(hi)):
                    out |= _collect_index_targets(
                        s.body, callee, arrays, {**constants, s.binding: float(i)}
                    )
            else:
                out |= _collect_index_targets(s.body, callee, arrays, constants)
    return out


def _resolve_index_sugar(stmts: List[Stmt], arrays: Dict[str, int], c) -> None:
    """Resolve `dx[i] = ...` sugar to the model's sole array state.

    Mutates statements in place (the parse tree is per-compile). With zero or
    several arrays the sugar is ambiguous and the explicit `dx(x[i])` form is
    required.
    """
    sole = next(iter(arrays)) if len(arrays) == 1 else None
    for s in stmts:
        if s.kind == "assign" and s.target_kind == "index" and s.index_base is None:
            if sole is None:
                c.err(
                    "DSL2037",
                    f"`{s.target}[i]` requires exactly one array state",
                    s.span,
                    help=f"name the array explicitly: `{s.target}(arr[i]) = ...`",
                )
            else:
                s.index_base = sole
        elif s.kind == "if":
            _resolve_index_sugar(s.then_branch, arrays, c)
            _resolve_index_sugar(s.else_branch, arrays, c)
        elif s.kind == "for":
            _resolve_index_sugar(s.body, arrays, c)


def _const_value(expr: Expr, constants: Dict[str, float]) -> Optional[float]:
    """Constant folding for constants blocks."""
    if expr.kind in ("number", "bool"):
        return expr.value
    if expr.kind == "name" and expr.name in constants:
        return constants[expr.name]
    if expr.kind == "unary":
        v = _const_value(expr.args[0], constants)
        if v is None:
            return None
        return {"-": -v, "+": v, "!": float(not v)}[expr.name]
    if expr.kind == "binary":
        a = _const_value(expr.args[0], constants)
        b = _const_value(expr.args[1], constants)
        if a is None or b is None:
            return None
        import math

        ops = {
            "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
            "/": lambda: a / b, "^": lambda: a**b,
        }
        fn = ops.get(expr.name)
        return fn() if fn else None
    return None


class _Checker:
    def __init__(self, model: DslModel):
        self.model = model
        self.arrays = dict(model.state_arrays)
        self.constants: Dict[str, float] = {}
        self.diagnostics: List[Diagnostic] = []

    def err(self, code, message, span=Span.empty(), help=None, suggestion=None):
        self.diagnostics.append(Diagnostic.error(code, message, span, help, suggestion))

    def check_expr(self, expr: Expr, scope: Set[str], role: str):
        if expr.kind == "index":
            base, idx = expr.args
            if base.kind == "name" and base.name in self.arrays:
                n = self.arrays[base.name]
                cv = _const_value(idx, self.constants)
                if cv is not None and not (0 <= int(cv) < n):
                    self.err(
                        "DSL2033",
                        f"index {int(cv)} out of bounds for array state "
                        f"`{base.name}[{n}]` in {role}",
                        expr.span,
                    )
                self.check_expr(idx, scope, role)
                return
            self.err(
                "DSL2034",
                f"only array states can be indexed in {role}",
                expr.span,
                suggestion=best_suggestion(
                    base.name if base.kind == "name" else "", set(self.arrays)
                ),
            )
            return
        if expr.kind == "name":
            if expr.name not in scope:
                self.err(
                    "DSL2001",
                    f"unknown name `{expr.name}` in {role}",
                    expr.span,
                    suggestion=best_suggestion(expr.name, scope),
                )
            return
        if expr.kind == "call":
            if expr.name not in MATH_FUNCTIONS:
                self.err(
                    "DSL2002",
                    f"unknown function `{expr.name}` in {role}",
                    expr.span,
                    suggestion=best_suggestion(expr.name, MATH_FUNCTIONS),
                )
            else:
                want = _ARITY.get(expr.name)
                if want is not None and len(expr.args) != want:
                    self.err(
                        "DSL2003",
                        f"`{expr.name}` takes {want} argument(s), got {len(expr.args)} in {role}",
                        expr.span,
                    )
        for a in expr.args:
            self.check_expr(a, scope, role)

    def check_stmts(self, stmts: List[Stmt], scope: Set[str], role: str,
                    assignable: Optional[Set[str]] = None, call_target: Optional[str] = None,
                    call_args: Optional[Set[str]] = None):
        local = set(scope)
        for s in stmts:
            if s.kind == "let":
                self.check_expr(s.value, local, role)
                local.add(s.target)
            elif s.kind == "assign":
                if s.target_kind == "call":
                    if call_target is not None and s.target != call_target:
                        self.err(
                            "DSL2004",
                            f"only `{call_target}(...)` assignments are allowed in {role}, "
                            f"got `{s.target}(...)`",
                            s.span,
                        )
                    if call_args is not None:
                        for a in s.target_args:
                            if a not in call_args:
                                self.err(
                                    "DSL2005",
                                    f"unknown {role} target `{a}`",
                                    s.span,
                                    suggestion=best_suggestion(a, call_args),
                                )
                elif s.target_kind == "index":
                    if call_target is None or s.target != call_target:
                        self.err(
                            "DSL2035",
                            f"indexed assignment `{s.target}[...]` is not allowed "
                            f"in {role}",
                            s.span,
                        )
                    elif s.index_base is None:
                        pass  # unresolved sugar; diagnosed by the resolution pass
                    elif s.index_base not in self.arrays:
                        self.err(
                            "DSL2036",
                            f"`{s.index_base}` is not an array state",
                            s.span,
                            suggestion=best_suggestion(s.index_base, set(self.arrays)),
                        )
                    else:
                        n = self.arrays[s.index_base]
                        cv = _const_value(s.index_expr, self.constants)
                        if cv is not None and not (0 <= int(cv) < n):
                            self.err(
                                "DSL2033",
                                f"index {int(cv)} out of bounds for array state "
                                f"`{s.index_base}[{n}]` in {role}",
                                s.span,
                            )
                    if s.index_expr is not None:
                        self.check_expr(s.index_expr, local, role)
                else:
                    if assignable is not None and s.target not in assignable:
                        self.err(
                            "DSL2006",
                            f"`{s.target}` is not assignable in {role}",
                            s.span,
                            suggestion=best_suggestion(s.target, assignable),
                            help=f"declare it (e.g. in `derived`) before assigning in {role}",
                        )
                    local.add(s.target)
                self.check_expr(s.value, local, role)
            elif s.kind == "if":
                self.check_expr(s.condition, local, role)
                self.check_stmts(s.then_branch, local, role, assignable, call_target, call_args)
                self.check_stmts(s.else_branch, local, role, assignable, call_target, call_args)
            elif s.kind == "for":
                self.check_expr(s.range_start, local, role)
                self.check_expr(s.range_end, local, role)
                self.check_stmts(
                    s.body, local | {s.binding}, role, assignable, call_target, call_args
                )


def analyze_model(model: DslModel) -> AnalyzedModel:
    c = _Checker(model)

    constants: Dict[str, float] = {}
    for name, expr in model.constants:
        v = _const_value(expr, constants)
        if v is None:
            c.err("DSL2007", f"constant `{name}` must be a literal expression", expr.span)
        else:
            constants[name] = v
    c.constants = constants

    params = list(model.parameters)
    states = list(model.states)
    arrays = dict(model.state_arrays)
    for stmts in (model.dynamics_stmts, model.drift_stmts,
                  model.diffusion_stmts, model.init_stmts):
        _resolve_index_sugar(stmts, arrays, c)
    covs = [(d.name, d.interpolation) for d in model.covariates]
    cov_names = [n for n, _ in covs]

    for _, interp in covs:
        if interp is not None and interp not in ("linear", "locf", "carryforward"):
            c.err("DSL2008", f"unknown covariate interpolation `@{interp}`",
                  help="use @linear or @locf")

    # derived: declared or inferred from derive statements (in order)
    derived = list(model.derived)
    for s in model.derive_stmts:
        if s.kind == "assign" and s.target_kind == "name" and s.target not in derived:
            if model.derived:
                c.err(
                    "DSL2009",
                    f"`{s.target}` assigned in derive but not declared in `derived`",
                    s.span,
                    suggestion=best_suggestion(s.target, model.derived),
                )
            else:
                derived.append(s.target)

    # outputs: declared or inferred from out() statements
    outputs = list(model.outputs)
    for s in model.output_stmts:
        if s.kind == "assign" and s.target_kind == "call" and s.target == "out":
            for a in s.target_args:
                if a not in outputs:
                    if model.outputs:
                        c.err(
                            "DSL2010",
                            f"out(`{a}`) not declared in `outputs`",
                            s.span,
                            suggestion=best_suggestion(a, model.outputs),
                        )
                    else:
                        outputs.append(a)

    # duplicate / cross-domain name checks: the full NameDomain matrix
    # (metadata.rs:79-109 + validate_unique_names at :560-564). Within-domain
    # repeats are DSL2040; collisions across value namespaces are DSL2011.
    # Outputs live in their own namespace (out(...) targets), so they are
    # checked for internal duplicates but may coincide with, e.g., a state.
    seen: Dict[str, str] = {}
    for domain, names in (
        ("parameter", params),
        ("covariate", cov_names),
        ("state", states + list(arrays)),
        ("derived", derived),
        ("constant", list(constants)),
    ):
        for n in names:
            if n in seen:
                if seen[n] == domain:
                    c.err("DSL2040", f"duplicate {domain} name `{n}`")
                else:
                    c.err("DSL2011", f"`{n}` declared as both {seen[n]} and {domain}")
            else:
                seen[n] = domain
    out_seen: Set[str] = set()
    for n in outputs:
        if n in out_seen:
            c.err("DSL2040", f"duplicate output name `{n}`")
        out_seen.add(n)

    # routes
    route_lag: Dict[str, Stmt] = {}
    route_fa: Dict[str, Stmt] = {}
    route_inputs = set()
    for r in model.routes:
        if (r.input, r.kind) in {(x.input, x.kind) for x in model.routes if x is not r}:
            c.err("DSL2012", f"duplicate route `{r.input}`", r.span)
        if r.destination not in states:
            c.err(
                "DSL2013",
                f"route `{r.input}` targets unknown state `{r.destination}`",
                r.span,
                suggestion=best_suggestion(r.destination, states),
            )
        route_inputs.add(r.input)

    def bind_route_stmt(stmts: List[Stmt], table: Dict[str, Stmt], kind: str):
        for s in stmts:
            if s.target_kind != "call" or len(s.target_args) != 1:
                c.err("DSL2014", f"{kind}() must name exactly one route", s.span)
                continue
            label = s.target_args[0]
            route = next((r for r in model.routes if r.input == label), None)
            if route is None:
                c.err(
                    "DSL2015",
                    f"{kind}(`{label}`) names an undeclared route",
                    s.span,
                    suggestion=best_suggestion(label, route_inputs),
                )
                continue
            if route.kind is DslRouteKind.INFUSION:
                c.err("DSL2016", f"{kind}() is not allowed on infusion route `{label}`", s.span)
                continue
            table[label] = s

    # canonical route properties `{ lag = expr, fa = expr }` desugar to the
    # same statements as the flat `lag(route) = expr` form
    lag_stmts = list(model.lag_stmts)
    fa_stmts = list(model.fa_stmts)
    for r in model.routes:
        for pname, pexpr in r.properties:
            if pname in ("lag", "fa"):
                stmt = Stmt(
                    "assign", r.span, target=pname, target_kind="call",
                    target_args=[r.input], value=pexpr,
                )
                (lag_stmts if pname == "lag" else fa_stmts).append(stmt)
            else:
                c.err(
                    "DSL2038",
                    f"unknown route property `{pname}`",
                    r.span,
                    help="route properties are `lag` and `fa`",
                )

    bind_route_stmt(lag_stmts, route_lag, "lag")
    bind_route_stmt(fa_stmts, route_fa, "fa")

    base_scope = set(params) | set(cov_names) | set(constants) | {"t"}
    derive_scope = set(base_scope)
    c.check_stmts(model.derive_stmts, derive_scope, "derive", assignable=set(derived))
    full_scope = base_scope | set(derived)
    state_scope = full_scope | set(states)

    kind = model.kind
    dynamics = list(model.dynamics_stmts)
    if kind is DslModelKind.ODE:
        if not dynamics:
            c.err("DSL2017", "ODE models require dx(...) dynamics")
        c.check_stmts(dynamics, state_scope, "dynamics", call_target="dx",
                      call_args=set(states))
        dyn_targets = _collect_call_targets(dynamics, "dx")
        dyn_targets |= _collect_index_targets(dynamics, "dx", arrays, constants)
        for st in states:
            if st not in dyn_targets:
                c.err("DSL2018", f"state `{st}` has no dx() equation")
        if model.analytical_structure:
            c.err("DSL2019", "ODE models may not declare `structure`")
        if model.particles is not None:
            c.err("DSL2020", "ODE models may not declare `particles`")
    elif kind is DslModelKind.SDE:
        drift = dynamics or model.drift_stmts
        if not drift:
            c.err("DSL2021", "SDE models require dx(...) drift dynamics")
        c.check_stmts(drift, state_scope, "drift", call_target="dx", call_args=set(states))
        c.check_stmts(model.diffusion_stmts, state_scope, "noise",
                      call_target="noise", call_args=set(states))
        if model.particles is None:
            c.err("DSL2022", "SDE models require `particles`")
        if model.analytical_structure:
            c.err("DSL2023", "SDE models may not declare `structure`")
    else:  # analytical
        if dynamics:
            c.err("DSL2024", "analytical models may not declare dx() dynamics")
        if model.particles is not None:
            c.err("DSL2025", "analytical models may not declare `particles`")
        if not model.analytical_structure:
            c.err("DSL2026", "analytical models require `structure = <kernel>`")

    kernel_plan = None
    if kind is DslModelKind.ANALYTICAL and model.analytical_structure:
        kname = model.analytical_structure
        if kname not in KERNELS:
            c.err(
                "DSL2027",
                f"unknown analytical structure `{kname}`",
                suggestion=best_suggestion(kname, KERNELS),
            )
        else:
            _, nstates_k, _ = KERNELS[kname]
            if len(states) != nstates_k:
                c.err(
                    "DSL2028",
                    f"structure `{kname}` has {nstates_k} states but model declares "
                    f"{len(states)}",
                )
            bindings: List[Tuple[str, int]] = []
            required = _KERNEL_REQUIRED[kname]
            for req in required:
                in_p = req in params
                in_d = req in derived
                in_c = req in cov_names
                if in_p and in_d:
                    c.err("DSL2029", f"`{req}` is declared in both `params` and `derived`")
                elif in_p:
                    bindings.append(("primary", params.index(req)))
                elif in_d:
                    bindings.append(("derived", derived.index(req)))
                elif in_c:
                    # covariate-sourced kernel input (superset of the
                    # reference plan, which requires routing covariates
                    # through a derive statement — analysis.rs:345-375)
                    bindings.append(("covariate", cov_names.index(req)))
                else:
                    c.err(
                        "DSL2030",
                        f"structure `{kname}` requires parameter `{req}`",
                        suggestion=best_suggestion(
                            req, set(params) | set(derived) | set(cov_names)
                        ),
                    )
            if not c.diagnostics:
                kernel_plan = KernelPlan(kernel=kname, bindings=bindings)
            elif all(d.code not in ("DSL2028", "DSL2029", "DSL2030", "DSL2027")
                     for d in c.diagnostics):
                kernel_plan = KernelPlan(kernel=kname, bindings=bindings)

    # outputs: every declared output must be produced
    c.check_stmts(model.output_stmts, state_scope, "outputs", call_target="out",
                  call_args=set(outputs))
    produced = _collect_call_targets(model.output_stmts, "out")
    for o in outputs:
        if o not in produced:
            c.err("DSL2031", f"output `{o}` has no out() equation")
    if not outputs:
        c.err("DSL2032", "model declares no outputs")

    # init / lag / fa expression scopes
    c.check_stmts(model.init_stmts, full_scope, "init", call_target="init",
                  call_args=set(states))
    for s in list(route_lag.values()) + list(route_fa.values()):
        c.check_expr(s.value, full_scope, "lag/fa")

    annotations = {}
    for s in model.output_stmts:
        if s.kind == "assign" and s.target_kind == "call" and s.annotation:
            annotations[s.target_args[0]] = s.annotation

    if c.diagnostics:
        raise DslError(*c.diagnostics)

    return AnalyzedModel(
        name=model.name,
        kind=kind,
        parameters=params,
        covariates=covs,
        states=states,
        state_arrays=arrays,
        derived=derived,
        outputs=outputs,
        constants=constants,
        routes=list(model.routes),
        route_lag=route_lag,
        route_fa=route_fa,
        derive_stmts=list(model.derive_stmts),
        dynamics_stmts=dynamics if kind is not DslModelKind.SDE else (dynamics or model.drift_stmts),
        output_stmts=list(model.output_stmts),
        init_stmts=list(model.init_stmts),
        diffusion_stmts=list(model.diffusion_stmts),
        output_annotations=annotations,
        analytical_kernel=model.analytical_structure,
        kernel_plan=kernel_plan,
        particles=model.particles,
    )


# kernel name -> required parameter names (analysis.rs:242-257)
_KERNEL_REQUIRED = {
    "one_compartment": ["ke"],
    "one_compartment_cl": ["cl", "v"],
    "one_compartment_cl_with_absorption": ["ka", "cl", "v"],
    "one_compartment_with_absorption": ["ka", "ke"],
    "two_compartments": ["ke", "kcp", "kpc"],
    "two_compartments_cl": ["cl", "q", "vc", "vp"],
    "two_compartments_cl_with_absorption": ["ka", "cl", "q", "vc", "vp"],
    "two_compartments_with_absorption": ["ke", "ka", "kcp", "kpc"],
    "three_compartments": ["k10", "k12", "k13", "k21", "k31"],
    "three_compartments_cl": ["cl", "q2", "q3", "vc", "v2", "v3"],
    "three_compartments_cl_with_absorption": ["ka", "cl", "q2", "q3", "vc", "v2", "v3"],
    "three_compartments_with_absorption": ["ka", "k10", "k12", "k13", "k21", "k31"],
}

# The reference's CL-kernel delegations expect their p-vector in kernel
# order; map required names to the engine kernels' own parameter order.
KERNEL_REQUIRED_NAMES = _KERNEL_REQUIRED


def analyze_module(module: DslModule) -> List[AnalyzedModel]:
    return [analyze_model(m) for m in module.models]
