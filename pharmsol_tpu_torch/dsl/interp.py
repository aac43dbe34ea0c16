"""Trace-time interpreter: DSL statements -> torch values.

The counterpart of the JAX package's ``dsl/interp.py`` (itself the
replacement of the reference's Cranelift JIT, src/dsl/jit.rs). The IR is
walked every time a role closure runs; the closures are written for one
(state, parameter) pair, so the general engine evaluates them through
``torch.func.vmap`` and the CUDA generator (``ops/rhs_codegen.py``) traces
them with symbolic scalars into the fused kernels' device code. Every
operation therefore maps onto what that generator can trace:

- call-target assignments (``dx(s) = ...``, ``out(o) = ...``) write keyed
  env slots (``dx:s``) so they participate in if-branch merging;
- ``if`` evaluates both branches and merges every modified slot with
  ``torch.where`` (no data-dependent control flow); a condition that is a
  Python bool (constants only) picks its branch;
- ``for`` requires constant bounds and unrolls;
- ``^`` and ``pow`` are ``**``, ``min``/``max`` are ``torch.minimum``/
  ``torch.maximum``, ``&&``/``||`` are ``&``/``|`` on comparisons, ``!`` is
  ``~``; the other intrinsics are the torch functions of the same name.

Operands that are plain Python numbers (literals, constants, unrolled loop
variables) are folded with numpy float64 scalars, so ``1.0 / 0.0`` is inf and
``log(-1.0)`` is nan, as ``jnp`` gives them.
"""

from __future__ import annotations

from numbers import Number
from typing import Dict, List

import numpy as np
import torch

from ..config import float_dtype
from .ast import Expr, Stmt
from .diagnostic import Diagnostic, DslError


def _is_number(v) -> bool:
    """A value known at trace time (a Python or numpy number)."""
    return isinstance(v, (Number, np.number)) and not isinstance(v, torch.Tensor)


def _folded(np_fn, *args) -> float:
    with np.errstate(all="ignore"):
        return float(np_fn(*(np.float64(a) for a in args)))


def _unary(torch_fn, np_fn):
    def fn(a):
        return _folded(np_fn, a) if _is_number(a) else torch_fn(a)

    return fn


def _like(a, b):
    """``b`` as a tensor like the tensor ``a`` when ``b`` is a number."""
    if isinstance(a, torch.Tensor) and _is_number(b):
        return torch.as_tensor(float(b), dtype=a.dtype, device=a.device)
    return b


def _binary(torch_fn, np_fn):
    def fn(a, b):
        if _is_number(a) and _is_number(b):
            return _folded(np_fn, a, b)
        return torch_fn(_like(b, a), _like(a, b))

    return fn


def _pow(a, b):
    if _is_number(a) and _is_number(b):
        return _folded(np.power, a, b)
    return a ** b


def _abs(a):
    return _folded(np.abs, a) if _is_number(a) else abs(a)


def _logic(py_op, op):
    def fn(a, b):
        if isinstance(a, (bool, np.bool_)) and isinstance(b, (bool, np.bool_)):
            return py_op(bool(a), bool(b))
        return op(a, b)

    return fn


def _not(v):
    if isinstance(v, (bool, np.bool_)):
        return not v
    if isinstance(v, torch.Tensor):
        return torch.logical_not(v)
    return ~v


def _compare(op):
    def fn(a, b):
        if _is_number(a) and _is_number(b):
            return bool(op(np.float64(a), np.float64(b)))
        return op(a, b)

    return fn


_INTRINSICS = {
    "abs": _abs,
    "min": _binary(torch.minimum, np.minimum),
    "max": _binary(torch.maximum, np.maximum),
    "floor": _unary(torch.floor, np.floor),
    "ceil": _unary(torch.ceil, np.ceil),
    "exp": _unary(torch.exp, np.exp),
    "ln": _unary(torch.log, np.log),
    "log": _unary(torch.log, np.log),
    "log10": _unary(torch.log10, np.log10),
    "log2": _unary(torch.log2, np.log2),
    "pow": _pow,
    "round": _unary(torch.round, np.round),
    "sin": _unary(torch.sin, np.sin),
    "cos": _unary(torch.cos, np.cos),
    "tan": _unary(torch.tan, np.tan),
    "sqrt": _unary(torch.sqrt, np.sqrt),
}

_BINOPS = {
    "+": _binary(lambda a, b: a + b, np.add),
    "-": _binary(lambda a, b: a - b, np.subtract),
    "*": _binary(lambda a, b: a * b, np.multiply),
    "/": _binary(lambda a, b: a / b, np.divide),
    "^": _pow,
    "==": _compare(lambda a, b: a == b),
    "!=": _compare(lambda a, b: a != b),
    "<": _compare(lambda a, b: a < b),
    "<=": _compare(lambda a, b: a <= b),
    ">": _compare(lambda a, b: a > b),
    ">=": _compare(lambda a, b: a >= b),
    "&&": _logic(lambda a, b: a and b, lambda a, b: a & b),
    "||": _logic(lambda a, b: a or b, lambda a, b: a | b),
}


def _where(cond, a, b):
    """``torch.where`` for the if-merge: a Python-bool condition picks its
    branch; numbers become tensors of the other branch's dtype (the working
    dtype when both are numbers)."""
    if isinstance(cond, (bool, np.bool_)):
        return a if cond else b
    if isinstance(cond, torch.Tensor):
        if _is_number(a) and _is_number(b):
            a = torch.as_tensor(float(a), dtype=float_dtype(), device=cond.device)
        a, b = _like(b, a), _like(a, b)
    return torch.where(cond, a, b)


def eval_expr(expr: Expr, env: Dict[str, object]):
    if expr.kind == "number":
        return expr.value
    if expr.kind == "bool":
        return bool(expr.value)
    if expr.kind == "name":
        try:
            return env[expr.name]
        except KeyError:
            raise DslError(
                Diagnostic.error("DSL3001", f"unbound name `{expr.name}` at runtime", expr.span)
            )
    if expr.kind == "unary":
        v = eval_expr(expr.args[0], env)
        if expr.name == "-":
            return -v
        if expr.name == "+":
            return v
        return _not(v)
    if expr.kind == "binary":
        a = eval_expr(expr.args[0], env)
        b = eval_expr(expr.args[1], env)
        return _BINOPS[expr.name](a, b)
    if expr.kind == "call":
        fn = _INTRINSICS.get(expr.name)
        if fn is None:
            raise DslError(
                Diagnostic.error("DSL3002", f"unknown function `{expr.name}`", expr.span)
            )
        return fn(*(eval_expr(a, env) for a in expr.args))
    if expr.kind == "index":
        base, idx_expr = expr.args
        idx = eval_expr(idx_expr, env)
        if not _is_number(idx):  # a runtime value: indices must resolve here
            raise DslError(
                Diagnostic.error(
                    "DSL3006",
                    "state index must be a constant (loop variables and literals "
                    "are allowed; runtime values are not)",
                    idx_expr.span,
                )
            )
        i = int(idx)
        if base.kind == "name":
            # array-state element: env binds expanded names like `x[0]`
            key = f"{base.name}[{i}]"
            if key in env:
                return env[key]
            if base.name not in env:
                raise DslError(
                    Diagnostic.error(
                        "DSL3007",
                        f"index {i} out of range for array state `{base.name}`",
                        expr.span,
                    )
                )
        return eval_expr(base, env)[i]
    raise DslError(Diagnostic.error("DSL3003", f"bad expression kind `{expr.kind}`", expr.span))


def _const_int(expr: Expr, env: Dict[str, object], what: str) -> int:
    v = eval_expr(expr, env)
    if not _is_number(v):  # a runtime value is not allowed as a loop bound
        raise DslError(
            Diagnostic.error(
                "DSL3004",
                f"{what} must be a constant (got a runtime value)",
                expr.span,
            )
        )
    return int(v)


def eval_stmts(stmts: List[Stmt], env: Dict[str, object]) -> Dict[str, object]:
    """Execute statements, mutating a copy of env; returns the final env."""
    env = dict(env)
    for s in stmts:
        if s.kind == "let":
            env[s.target] = eval_expr(s.value, env)
        elif s.kind == "assign":
            value = eval_expr(s.value, env)
            if s.target_kind == "call":
                for arg in s.target_args:
                    env[f"{s.target}:{arg}"] = value
            elif s.target_kind == "index":
                # dx(x[i]) / dx[i]: keyed slot on the expanded element name so
                # it participates in if-branch merging like scalar dx targets
                i = _const_int(s.index_expr, env, "state index")
                env[f"{s.target}:{s.index_base}[{i}]"] = value
            else:
                env[s.target] = value
        elif s.kind == "if":
            cond = eval_expr(s.condition, env)
            then_env = eval_stmts(s.then_branch, env)
            else_env = eval_stmts(s.else_branch, env)
            keys = set(then_env) | set(else_env)
            for k in keys:
                tv = then_env.get(k, env.get(k))
                ev = else_env.get(k, env.get(k))
                if tv is None or ev is None:
                    # assigned in only one branch with no prior value:
                    # visible only when that branch wins; keep branch value,
                    # fall back to 0.0 on the other side (reference IR zeroes
                    # uninitialized buffer slots)
                    tv = 0.0 if tv is None else tv
                    ev = 0.0 if ev is None else ev
                if tv is ev:
                    env[k] = tv
                else:
                    env[k] = _where(cond, tv, ev)
        elif s.kind == "for":
            start = _const_int(s.range_start, env, "for-range start")
            end = _const_int(s.range_end, env, "for-range end")
            for i in range(start, end):
                env[s.binding] = float(i)
                env = eval_stmts(s.body, env)
            env.pop(s.binding, None)
        else:
            raise DslError(Diagnostic.error("DSL3005", f"bad statement kind `{s.kind}`", s.span))
    return env
