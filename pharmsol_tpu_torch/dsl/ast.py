"""DSL syntax tree (parity with pharmsol-dsl/src/syntax.rs).

Expressions serialize to/from nested JSON lists so ExecutionModel artifacts
round-trip without Python pickling.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .diagnostic import Span


class DslModelKind(enum.Enum):
    ODE = "ode"
    ANALYTICAL = "analytical"
    SDE = "sde"


class DslRouteKind(enum.Enum):
    BOLUS = "bolus"
    INFUSION = "infusion"


@dataclass
class Ident:
    text: str
    span: Span = field(default_factory=Span.empty)


# -- expressions -------------------------------------------------------------


@dataclass
class Expr:
    kind: str  # number|bool|name|unary|binary|call|index
    span: Span = field(default_factory=Span.empty)
    value: Optional[float] = None  # number/bool
    name: Optional[str] = None  # name / call callee / unary+binary op symbol
    args: List["Expr"] = field(default_factory=list)  # call args / operands

    # -- constructors -----------------------------------------------------
    @staticmethod
    def number(v: float, span=Span.empty()) -> "Expr":
        return Expr("number", span, value=float(v))

    @staticmethod
    def boolean(v: bool, span=Span.empty()) -> "Expr":
        return Expr("bool", span, value=1.0 if v else 0.0)

    @staticmethod
    def name_ref(name: str, span=Span.empty()) -> "Expr":
        return Expr("name", span, name=name)

    @staticmethod
    def unary(op: str, expr: "Expr", span=Span.empty()) -> "Expr":
        return Expr("unary", span, name=op, args=[expr])

    @staticmethod
    def binary(op: str, lhs: "Expr", rhs: "Expr", span=Span.empty()) -> "Expr":
        return Expr("binary", span, name=op, args=[lhs, rhs])

    @staticmethod
    def call(callee: str, args: List["Expr"], span=Span.empty()) -> "Expr":
        return Expr("call", span, name=callee, args=list(args))

    @staticmethod
    def index(target: "Expr", idx: "Expr", span=Span.empty()) -> "Expr":
        return Expr("index", span, args=[target, idx])

    # -- serialization ------------------------------------------------------
    def to_json(self):
        if self.kind in ("number", "bool"):
            return [self.kind, self.value]
        if self.kind == "name":
            return ["name", self.name]
        return [self.kind, self.name, [a.to_json() for a in self.args]]

    @staticmethod
    def from_json(data) -> "Expr":
        kind = data[0]
        if kind in ("number", "bool"):
            return Expr(kind, value=float(data[1]))
        if kind == "name":
            return Expr("name", name=data[1])
        return Expr(kind, name=data[1], args=[Expr.from_json(a) for a in data[2]])

    def free_names(self) -> set:
        if self.kind == "name":
            return {self.name}
        out = set()
        for a in self.args:
            out |= a.free_names()
        return out


# -- statements ---------------------------------------------------------------


@dataclass
class Stmt:
    kind: str  # let|assign|if|for
    span: Span = field(default_factory=Span.empty)
    # let / assign
    target: Optional[str] = None  # variable or call-target name
    target_kind: str = "name"  # name | call (dx/out/init/lag/fa/noise) | index
    target_args: List[str] = field(default_factory=list)  # call args (idents)
    # index targets: dx[i] / dx(x[i]) — base array name + index expression.
    # index_base is None for the `dx[i]` sugar until the analyzer resolves it
    # to the model's sole array state.
    index_base: Optional[str] = None
    index_expr: Optional[Expr] = None
    value: Optional[Expr] = None
    annotation: Optional[Tuple[str, List[Expr]]] = None  # e.g. ('continuous', [])
    # if
    condition: Optional[Expr] = None
    then_branch: List["Stmt"] = field(default_factory=list)
    else_branch: List["Stmt"] = field(default_factory=list)
    # for
    binding: Optional[str] = None
    range_start: Optional[Expr] = None
    range_end: Optional[Expr] = None
    body: List["Stmt"] = field(default_factory=list)

    def to_json(self):
        if self.kind in ("let", "assign"):
            out = {
                "kind": self.kind,
                "target": self.target,
                "target_kind": self.target_kind,
                "target_args": self.target_args,
                "value": self.value.to_json() if self.value else None,
                "annotation": (
                    [self.annotation[0], [e.to_json() for e in self.annotation[1]]]
                    if self.annotation
                    else None
                ),
            }
            if self.target_kind == "index":
                out["index_base"] = self.index_base
                out["index"] = self.index_expr.to_json()
            return out
        if self.kind == "if":
            return {
                "kind": "if",
                "condition": self.condition.to_json(),
                "then": [s.to_json() for s in self.then_branch],
                "else": [s.to_json() for s in self.else_branch],
            }
        return {
            "kind": "for",
            "binding": self.binding,
            "start": self.range_start.to_json(),
            "end": self.range_end.to_json(),
            "body": [s.to_json() for s in self.body],
        }

    @staticmethod
    def from_json(data) -> "Stmt":
        kind = data["kind"]
        if kind in ("let", "assign"):
            ann = data.get("annotation")
            return Stmt(
                kind,
                target=data["target"],
                target_kind=data["target_kind"],
                target_args=data.get("target_args", []),
                index_base=data.get("index_base"),
                index_expr=(
                    Expr.from_json(data["index"]) if data.get("index") else None
                ),
                value=Expr.from_json(data["value"]) if data.get("value") else None,
                annotation=(
                    (ann[0], [Expr.from_json(e) for e in ann[1]]) if ann else None
                ),
            )
        if kind == "if":
            return Stmt(
                "if",
                condition=Expr.from_json(data["condition"]),
                then_branch=[Stmt.from_json(s) for s in data["then"]],
                else_branch=[Stmt.from_json(s) for s in data["else"]],
            )
        return Stmt(
            "for",
            binding=data["binding"],
            range_start=Expr.from_json(data["start"]),
            range_end=Expr.from_json(data["end"]),
            body=[Stmt.from_json(s) for s in data["body"]],
        )


# -- model-level declarations -----------------------------------------------------


@dataclass
class CovariateDeclAst:
    name: str
    interpolation: Optional[str] = None  # 'linear' | 'carryforward'/'locf'
    span: Span = field(default_factory=Span.empty)


@dataclass
class RouteDeclAst:
    input: str
    destination: str
    kind: Optional[DslRouteKind] = None
    properties: List[Tuple[str, Expr]] = field(default_factory=list)
    span: Span = field(default_factory=Span.empty)


@dataclass
class DslModel:
    name: str
    kind: DslModelKind
    parameters: List[str] = field(default_factory=list)
    constants: List[Tuple[str, Expr]] = field(default_factory=list)
    covariates: List[CovariateDeclAst] = field(default_factory=list)
    states: List[str] = field(default_factory=list)
    # array-state declarations (`states { x[3] }`): base name -> size.
    # `states` holds the expanded element names (`x[0]`, `x[1]`, `x[2]`).
    state_arrays: Dict[str, int] = field(default_factory=dict)
    derived: List[str] = field(default_factory=list)  # shorthand `derived =`
    outputs: List[str] = field(default_factory=list)  # shorthand `outputs =`
    routes: List[RouteDeclAst] = field(default_factory=list)
    derive_stmts: List[Stmt] = field(default_factory=list)
    dynamics_stmts: List[Stmt] = field(default_factory=list)
    output_stmts: List[Stmt] = field(default_factory=list)
    init_stmts: List[Stmt] = field(default_factory=list)
    drift_stmts: List[Stmt] = field(default_factory=list)
    diffusion_stmts: List[Stmt] = field(default_factory=list)
    lag_stmts: List[Stmt] = field(default_factory=list)  # lag(route) = expr
    fa_stmts: List[Stmt] = field(default_factory=list)
    analytical_structure: Optional[str] = None
    particles: Optional[int] = None
    span: Span = field(default_factory=Span.empty)


@dataclass
class DslModule:
    models: List[DslModel] = field(default_factory=list)
    span: Span = field(default_factory=Span.empty)
