"""DSL parsers: canonical ``model name { ... }`` blocks and the flat
authoring shorthand.

Parity targets: pharmsol-dsl/src/parser.rs (canonical) and authoring.rs
(shorthand). ``parse_module`` auto-detects the form; both lower to the same
``DslModule`` AST.

Shorthand surface (authoring.rs / tests/support/runtime_corpus.rs):

    name = one_cmt_oral_iv
    kind = ode
    params = ka, cl, v
    covariates = wt@linear
    states = depot, central
    derived = ke
    outputs = cp
    particles = 16
    structure = one_compartment_with_absorption     (analytical)
    bolus(oral) -> depot
    infusion(iv) -> central
    lag(oral) = tlag
    fa(oral) = f_oral
    ke = cl / v                                      (derived assignment)
    dx(central) = ka * depot - ke * central          (dynamics)
    init(central) = base
    noise(central) = sigma                           (SDE diffusion)
    out(cp) = central / v ~ continuous()
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .ast import (
    CovariateDeclAst,
    DslModel,
    DslModelKind,
    DslModule,
    DslRouteKind,
    Expr,
    RouteDeclAst,
    Stmt,
)
from .diagnostic import Diagnostic, DslError, Span
from .lexer import Token, tokenize

MAX_NESTING_DEPTH = 256

_BIN_PRECEDENCE = [
    ("||",),
    ("&&",),
    ("==", "!="),
    ("<", "<=", ">", ">="),
    ("+", "-"),
    ("*", "/"),
]


class _TokenStream:
    def __init__(self, tokens: List[Token], skip_newlines: bool = False):
        self.tokens = tokens
        self.pos = 0
        self.skip_newlines = skip_newlines
        self.depth = 0

    def peek(self, offset: int = 0) -> Token:
        i = self.pos
        seen = 0
        while i < len(self.tokens):
            t = self.tokens[i]
            if self.skip_newlines and t.kind == "newline":
                i += 1
                continue
            if seen == offset:
                return t
            seen += 1
            i += 1
        return self.tokens[-1]

    def next(self) -> Token:
        while self.pos < len(self.tokens):
            t = self.tokens[self.pos]
            self.pos += 1
            if self.skip_newlines and t.kind == "newline":
                continue
            return t
        return self.tokens[-1]

    def expect_ident(self, *texts) -> Token:
        t = self.next()
        if t.kind != "ident" or (texts and t.text not in texts):
            want = "identifier" if not texts else " or ".join(f"`{x}`" for x in texts)
            raise DslError(
                Diagnostic.error("DSL0100", f"expected {want}, got `{t.text}`", t.span)
            )
        return t

    def expect_punct(self, text) -> Token:
        t = self.next()
        if not t.is_punct(text):
            raise DslError(
                Diagnostic.error("DSL0101", f"expected `{text}`, got `{t.text or 'EOF'}`", t.span)
            )
        return t

    def expect_op(self, text) -> Token:
        t = self.next()
        if not t.is_op(text):
            raise DslError(
                Diagnostic.error("DSL0102", f"expected `{text}`, got `{t.text or 'EOF'}`", t.span)
            )
        return t


# -- expression parsing (shared) --------------------------------------------------


def parse_expr(ts: _TokenStream) -> Expr:
    ts.depth += 1
    if ts.depth >= MAX_NESTING_DEPTH:
        raise DslError(
            Diagnostic.error(
                "DSL0103",
                f"expression nested too deeply (maximum nesting depth is {MAX_NESTING_DEPTH})",
                ts.peek().span,
            )
        )
    try:
        return _parse_binary(ts, 0)
    finally:
        ts.depth -= 1


def _parse_binary(ts: _TokenStream, level: int) -> Expr:
    if level >= len(_BIN_PRECEDENCE):
        return _parse_power(ts)
    lhs = _parse_binary(ts, level + 1)
    while ts.peek().is_op(*_BIN_PRECEDENCE[level]):
        op = ts.next().text
        rhs = _parse_binary(ts, level + 1)
        lhs = Expr.binary(op, lhs, rhs, lhs.span.merge(rhs.span))
    return lhs


def _parse_power(ts: _TokenStream) -> Expr:
    base = _parse_unary(ts)
    if ts.peek().is_op("^"):
        ts.next()
        exponent = _parse_power(ts)  # right-associative
        return Expr.binary("^", base, exponent, base.span.merge(exponent.span))
    return base


def _parse_unary(ts: _TokenStream) -> Expr:
    t = ts.peek()
    if t.is_op("-", "+", "!"):
        ts.next()
        operand = _parse_unary(ts)
        return Expr.unary(t.text, operand, t.span.merge(operand.span))
    return _parse_postfix(ts)


def _parse_postfix(ts: _TokenStream) -> Expr:
    expr = _parse_atom(ts)
    while ts.peek().is_punct("["):
        ts.next()
        idx = parse_expr(ts)
        ts.expect_punct("]")
        expr = Expr.index(expr, idx, expr.span)
    return expr


def _parse_atom(ts: _TokenStream) -> Expr:
    t = ts.next()
    if t.kind == "number":
        return Expr.number(float(t.text), t.span)
    if t.kind == "ident":
        if t.text in ("true", "false"):
            return Expr.boolean(t.text == "true", t.span)
        if ts.peek().is_punct("("):
            ts.next()
            args: List[Expr] = []
            if not ts.peek().is_punct(")"):
                args.append(parse_expr(ts))
                while ts.peek().is_punct(","):
                    ts.next()
                    args.append(parse_expr(ts))
            ts.expect_punct(")")
            return Expr.call(t.text, args, t.span)
        return Expr.name_ref(t.text, t.span)
    if t.is_punct("("):
        inner = parse_expr(ts)
        ts.expect_punct(")")
        return inner
    raise DslError(
        Diagnostic.error("DSL0104", f"expected expression, got `{t.text or 'EOF'}`", t.span)
    )


# -- statements (canonical blocks) -------------------------------------------------


def _parse_stmt(ts: _TokenStream) -> Stmt:
    t = ts.peek()
    if t.is_ident("let"):
        ts.next()
        name = ts.expect_ident()
        ts.expect_op("=")
        value = parse_expr(ts)
        return Stmt("let", t.span, target=name.text, value=value)
    if t.is_ident("if"):
        ts.next()
        cond = parse_expr(ts)
        then_branch = _parse_stmt_block(ts)
        else_branch: List[Stmt] = []
        if ts.peek().is_ident("else"):
            ts.next()
            if ts.peek().is_ident("if"):
                else_branch = [_parse_stmt(ts)]
            else:
                else_branch = _parse_stmt_block(ts)
        return Stmt("if", t.span, condition=cond, then_branch=then_branch,
                    else_branch=else_branch)
    if t.is_ident("for"):
        ts.next()
        binding = ts.expect_ident()
        ts.expect_ident("in")
        start = parse_expr(ts)
        ts.expect_op("..")
        end = parse_expr(ts)
        body = _parse_stmt_block(ts)
        return Stmt("for", t.span, binding=binding.text, range_start=start,
                    range_end=end, body=body)
    # assignment: name = expr | name[expr] = expr | call(args) = expr
    return _parse_assignment(ts)


def _parse_assignment(ts: _TokenStream) -> Stmt:
    name = ts.expect_ident()
    nxt = ts.peek()
    if nxt.is_punct("("):
        ts.next()
        args: List[str] = []
        indexed = None  # (base, index expr) when an arg is `x[i]`
        if not ts.peek().is_punct(")"):
            while True:
                arg = ts.expect_ident()
                if ts.peek().is_punct("["):
                    ts.next()
                    idx = parse_expr(ts)
                    ts.expect_punct("]")
                    if indexed is not None or args:
                        raise DslError(
                            Diagnostic.error(
                                "DSL0114",
                                f"`{name.text}(...)` with an indexed state takes "
                                "exactly one argument",
                                arg.span,
                            )
                        )
                    indexed = (arg.text, idx)
                else:
                    args.append(arg.text)
                if not ts.peek().is_punct(","):
                    break
                ts.next()
        ts.expect_punct(")")
        ts.expect_op("=")
        value = parse_expr(ts)
        annotation = _parse_annotation(ts)
        if indexed is not None:
            if args:
                raise DslError(
                    Diagnostic.error(
                        "DSL0114",
                        f"`{name.text}(...)` with an indexed state takes exactly "
                        "one argument",
                        name.span,
                    )
                )
            return Stmt("assign", name.span, target=name.text, target_kind="index",
                        index_base=indexed[0], index_expr=indexed[1], value=value,
                        annotation=annotation)
        return Stmt("assign", name.span, target=name.text, target_kind="call",
                    target_args=args, value=value, annotation=annotation)
    if nxt.is_punct("["):
        # indexed-target sugar: dx[i] = expr (resolved to the model's sole
        # array state by the analyzer)
        ts.next()
        idx = parse_expr(ts)
        ts.expect_punct("]")
        ts.expect_op("=")
        value = parse_expr(ts)
        annotation = _parse_annotation(ts)
        return Stmt("assign", name.span, target=name.text, target_kind="index",
                    index_base=None, index_expr=idx, value=value,
                    annotation=annotation)
    ts.expect_op("=")
    value = parse_expr(ts)
    annotation = _parse_annotation(ts)
    return Stmt("assign", name.span, target=name.text, target_kind="name",
                value=value, annotation=annotation)


def _parse_annotation(ts: _TokenStream) -> Optional[Tuple[str, List[Expr]]]:
    if not ts.peek().is_op("~"):
        return None
    ts.next()
    name = ts.expect_ident()
    args: List[Expr] = []
    if ts.peek().is_punct("("):
        ts.next()
        if not ts.peek().is_punct(")"):
            args.append(parse_expr(ts))
            while ts.peek().is_punct(","):
                ts.next()
                args.append(parse_expr(ts))
        ts.expect_punct(")")
    return (name.text, args)


def _parse_stmt_block(ts: _TokenStream) -> List[Stmt]:
    ts.expect_punct("{")
    stmts: List[Stmt] = []
    while not ts.peek().is_punct("}"):
        if ts.peek().kind == "eof":
            raise DslError(Diagnostic.error("DSL0105", "unterminated block", ts.peek().span))
        stmts.append(_parse_stmt(ts))
        while ts.peek().is_punct(";", ","):
            ts.next()
    ts.expect_punct("}")
    return stmts


# -- canonical model parsing ----------------------------------------------------------


def _expect_array_size(ts: _TokenStream) -> int:
    """Parse the `[N]` suffix of an array-state declaration (N a positive int)."""
    ts.expect_punct("[")
    size_tok = ts.next()
    if size_tok.kind != "number" or float(size_tok.text) != int(float(size_tok.text)) \
            or int(float(size_tok.text)) < 1:
        raise DslError(
            Diagnostic.error(
                "DSL0113",
                f"array state size must be a positive integer, got `{size_tok.text}`",
                size_tok.span,
            )
        )
    ts.expect_punct("]")
    return int(float(size_tok.text))


def _expect_array_size_index(ts: _TokenStream) -> int:
    """Parse a `[k]` constant element index (zero-based, used in route dests)."""
    ts.expect_punct("[")
    tok = ts.next()
    if tok.kind != "number" or float(tok.text) != int(float(tok.text)) \
            or int(float(tok.text)) < 0:
        raise DslError(
            Diagnostic.error(
                "DSL0115",
                f"state element index must be a non-negative integer, got `{tok.text}`",
                tok.span,
            )
        )
    ts.expect_punct("]")
    return int(float(tok.text))


def _state_items_from(ts: _TokenStream, names: List[str], arrays: dict) -> None:
    """One state declaration: `name` or `name[N]` (expands to name[0..N-1])."""
    t = ts.expect_ident()
    if ts.peek().is_punct("["):
        n = _expect_array_size(ts)
        arrays[t.text] = n
        names.extend(f"{t.text}[{k}]" for k in range(n))
    else:
        names.append(t.text)


def _parse_state_list_block(ts: _TokenStream):
    """Canonical `states { ... }` block with scalar and array declarations."""
    ts.expect_punct("{")
    names: List[str] = []
    arrays: dict = {}
    while not ts.peek().is_punct("}"):
        _state_items_from(ts, names, arrays)
        while ts.peek().is_punct(","):
            ts.next()
    ts.expect_punct("}")
    return names, arrays


def _parse_ident_list_block(ts: _TokenStream) -> List[Token]:
    ts.expect_punct("{")
    items: List[Token] = []
    while not ts.peek().is_punct("}"):
        items.append(ts.expect_ident())
        while ts.peek().is_punct(","):
            ts.next()
    ts.expect_punct("}")
    return items


def _parse_model(ts: _TokenStream) -> DslModel:
    kw = ts.expect_ident("model")
    name = ts.expect_ident()
    ts.expect_punct("{")
    ts.expect_ident("kind")
    kind_tok = ts.expect_ident("ode", "analytical", "sde")
    model = DslModel(name=name.text, kind=DslModelKind(kind_tok.text), span=kw.span)

    while not ts.peek().is_punct("}"):
        item = ts.expect_ident()
        text = item.text
        if text in ("parameters", "params"):
            model.parameters = [t.text for t in _parse_ident_list_block(ts)]
        elif text == "constants":
            ts.expect_punct("{")
            while not ts.peek().is_punct("}"):
                cname = ts.expect_ident()
                ts.expect_op("=")
                model.constants.append((cname.text, parse_expr(ts)))
                while ts.peek().is_punct(",", ";"):
                    ts.next()
            ts.expect_punct("}")
        elif text == "covariates":
            ts.expect_punct("{")
            while not ts.peek().is_punct("}"):
                cname = ts.expect_ident()
                interp = None
                if ts.peek().is_op("@"):
                    ts.next()
                    interp = ts.expect_ident().text
                model.covariates.append(CovariateDeclAst(cname.text, interp, cname.span))
                while ts.peek().is_punct(","):
                    ts.next()
            ts.expect_punct("}")
        elif text == "states":
            model.states, model.state_arrays = _parse_state_list_block(ts)
        elif text == "derived":
            model.derived = [t.text for t in _parse_ident_list_block(ts)]
        elif text == "outputs":
            # canonical outputs is a statement block; shorthand uses a list —
            # detect by first token after `{`
            save = ts.pos
            ts.expect_punct("{")
            first = ts.peek()
            second = ts.peek(1)
            ts.pos = save
            if first.kind == "ident" and (second.is_punct(",") or second.is_punct("}")):
                model.outputs = [t.text for t in _parse_ident_list_block(ts)]
            else:
                model.output_stmts = _parse_stmt_block(ts)
        elif text == "routes":
            ts.expect_punct("{")
            while not ts.peek().is_punct("}"):
                model.routes.append(_parse_route(ts))
                while ts.peek().is_punct(",", ";"):
                    ts.next()
            ts.expect_punct("}")
        elif text == "derive":
            model.derive_stmts = _parse_stmt_block(ts)
        elif text == "dynamics":
            model.dynamics_stmts = _parse_stmt_block(ts)
        elif text == "init":
            model.init_stmts = _parse_stmt_block(ts)
        elif text == "drift":
            model.drift_stmts = _parse_stmt_block(ts)
        elif text == "diffusion":
            model.diffusion_stmts = _parse_stmt_block(ts)
        elif text == "lag":
            model.lag_stmts.extend(_parse_stmt_block(ts))
        elif text == "fa":
            model.fa_stmts.extend(_parse_stmt_block(ts))
        elif text == "analytical":
            ts.expect_punct("{")
            ts.expect_ident("structure")
            structure = ts.expect_ident()
            model.analytical_structure = structure.text
            ts.expect_punct("}")
        elif text == "structure":
            # allow `structure name` at model level too
            model.analytical_structure = ts.expect_ident().text
        elif text == "particles":
            v = parse_expr(ts)
            if v.kind != "number":
                raise DslError(
                    Diagnostic.error("DSL0106", "particles must be a number literal", item.span)
                )
            model.particles = int(v.value)
        else:
            raise DslError(
                Diagnostic.error(
                    "DSL0107",
                    f"unknown model item `{text}`",
                    item.span,
                    help="expected one of parameters, constants, covariates, states, "
                    "routes, derive, dynamics, outputs, init, drift, diffusion, "
                    "analytical, particles",
                )
            )
    ts.expect_punct("}")
    _split_shorthand_blocks(model)
    return model


def _parse_route(ts: _TokenStream) -> RouteDeclAst:
    t = ts.peek()
    kind = None
    if t.is_ident("bolus", "infusion"):
        ts.next()
        kind = DslRouteKind(t.text)
    input_tok = ts.expect_ident()
    ts.expect_op("->")
    dest = ts.expect_ident()
    dest_name = dest.text
    if ts.peek().is_punct("["):
        dest_name = f"{dest.text}[{_expect_array_size_index(ts)}]"
    props: List[Tuple[str, Expr]] = []
    if ts.peek().is_punct("{"):
        ts.next()
        while not ts.peek().is_punct("}"):
            pname = ts.expect_ident()
            ts.expect_op("=")
            props.append((pname.text, parse_expr(ts)))
            while ts.peek().is_punct(",", ";"):
                ts.next()
        ts.expect_punct("}")
    return RouteDeclAst(input_tok.text, dest_name, kind, props, input_tok.span)


def parse_canonical(src: str) -> DslModule:
    ts = _TokenStream(tokenize(src), skip_newlines=True)
    module = DslModule()
    while ts.peek().kind != "eof":
        module.models.append(_parse_model(ts))
    if not module.models:
        raise DslError(
            Diagnostic.error("DSL0108", "source contains no models", Span.empty())
        )
    return module


# -- authoring shorthand ---------------------------------------------------------------


def parse_shorthand(src: str) -> DslModule:
    """Flat line-per-declaration surface (authoring.rs)."""
    tokens = tokenize(src)
    # group into logical lines
    lines: List[List[Token]] = []
    cur: List[Token] = []
    for t in tokens:
        if t.kind in ("newline", "eof"):
            if cur:
                lines.append(cur)
                cur = []
        else:
            cur.append(t)

    model = DslModel(name="model", kind=DslModelKind.ODE)
    kind_seen = False
    for line in lines:
        ts = _TokenStream(line + [Token("eof", "", line[-1].span)], skip_newlines=True)
        head = ts.peek()
        second = ts.peek(1)
        if head.kind != "ident":
            raise DslError(
                Diagnostic.error("DSL0110", f"unexpected `{head.text}`", head.span)
            )
        # route lines: bolus(x) -> state / infusion(x) -> state, with
        # optional canonical-style properties `{ lag = ..., fa = ... }`
        if head.text in ("bolus", "infusion") and second.is_punct("("):
            ts.next()
            ts.expect_punct("(")
            input_tok = ts.expect_ident()
            ts.expect_punct(")")
            ts.expect_op("->")
            dest = ts.expect_ident()
            dest_name = dest.text
            if ts.peek().is_punct("["):
                dest_name = f"{dest.text}[{_expect_array_size_index(ts)}]"
            props: List[Tuple[str, Expr]] = []
            if ts.peek().is_punct("{"):
                ts.next()
                while not ts.peek().is_punct("}"):
                    pname = ts.expect_ident()
                    ts.expect_op("=")
                    props.append((pname.text, parse_expr(ts)))
                    while ts.peek().is_punct(",", ";"):
                        ts.next()
                ts.expect_punct("}")
            if ts.peek().kind != "eof":
                raise DslError(
                    Diagnostic.error(
                        "DSL0117",
                        f"unexpected `{ts.peek().text}` after route declaration",
                        ts.peek().span,
                    )
                )
            model.routes.append(
                RouteDeclAst(input_tok.text, dest_name, DslRouteKind(head.text),
                             props, head.span)
            )
            continue
        if second.is_op("=") and head.text in (
            "name", "kind", "params", "parameters", "covariates", "states",
            "derived", "outputs", "particles", "structure",
        ):
            ts.next()
            ts.next()  # '='
            if head.text == "name":
                model.name = ts.expect_ident().text
            elif head.text == "kind":
                k = ts.expect_ident("ode", "analytical", "sde")
                model.kind = DslModelKind(k.text)
                kind_seen = True
            elif head.text in ("params", "parameters"):
                model.parameters = _ident_csv(ts)
            elif head.text == "covariates":
                model.covariates = _covariate_csv(ts)
            elif head.text == "states":
                names: List[str] = []
                arrays: dict = {}
                _state_items_from(ts, names, arrays)
                while ts.peek().is_punct(","):
                    ts.next()
                    _state_items_from(ts, names, arrays)
                model.states, model.state_arrays = names, arrays
            elif head.text == "derived":
                model.derived = _ident_csv(ts)
            elif head.text == "outputs":
                model.outputs = _ident_csv(ts)
            elif head.text == "particles":
                v = parse_expr(ts)
                model.particles = int(v.value)
            elif head.text == "structure":
                model.analytical_structure = ts.expect_ident().text
            continue
        # statement lines: dx(s)=, out(o)=, init(s)=, lag(r)=, fa(r)=,
        # noise(s)=, derived assignments name = expr
        stmt = _parse_assignment(ts)
        if stmt.target_kind == "index":
            if stmt.target == "dx":
                model.dynamics_stmts.append(stmt)
            elif stmt.target == "init":
                model.init_stmts.append(stmt)
            elif stmt.target == "noise":
                model.diffusion_stmts.append(stmt)
            else:
                raise DslError(
                    Diagnostic.error(
                        "DSL0116",
                        f"indexed assignment `{stmt.target}[...]` is not a "
                        "declaration",
                        head.span,
                        help="only dx, init, and noise accept indexed state targets",
                    )
                )
        elif stmt.target_kind == "call":
            if stmt.target == "dx":
                model.dynamics_stmts.append(stmt)
            elif stmt.target == "out":
                model.output_stmts.append(stmt)
            elif stmt.target == "init":
                model.init_stmts.append(stmt)
            elif stmt.target == "lag":
                model.lag_stmts.append(stmt)
            elif stmt.target == "fa":
                model.fa_stmts.append(stmt)
            elif stmt.target == "noise":
                model.diffusion_stmts.append(stmt)
            else:
                raise DslError(
                    Diagnostic.error(
                        "DSL0111",
                        f"unknown declaration `{stmt.target}(...)`",
                        head.span,
                        help="expected dx, out, init, lag, fa, or noise",
                    )
                )
        else:
            model.derive_stmts.append(stmt)
    if not kind_seen:
        raise DslError(
            Diagnostic.error("DSL0112", "missing `kind = ode|analytical|sde`", Span.empty())
        )
    return DslModule(models=[model])


def _ident_csv(ts: _TokenStream) -> List[str]:
    items = [ts.expect_ident().text]
    while ts.peek().is_punct(","):
        ts.next()
        items.append(ts.expect_ident().text)
    return items


def _covariate_csv(ts: _TokenStream) -> List[CovariateDeclAst]:
    out = []
    while True:
        name = ts.expect_ident()
        interp = None
        if ts.peek().is_op("@"):
            ts.next()
            interp = ts.expect_ident().text
        out.append(CovariateDeclAst(name.text, interp, name.span))
        if not ts.peek().is_punct(","):
            break
        ts.next()
    return out


def _split_shorthand_blocks(model: DslModel) -> None:
    """In canonical form, dynamics/outputs blocks may also carry
    dx()/out()-style call targets; nothing to split today, kept for parity
    hooks."""


def parse_module(src: str) -> DslModule:
    """Auto-detect canonical vs shorthand (pharmsol-dsl lib.rs:119-135)."""
    import sys

    stripped = "\n".join(
        line for line in src.splitlines() if line.strip() and not line.strip().startswith("#")
    ).strip()
    # The recursive-descent parser needs ~10 Python frames per DSL nesting
    # level; make sure the DSL's own MAX_NESTING_DEPTH guard (DSL0103) fires
    # before Python's recursion limit does.
    limit = sys.getrecursionlimit()
    need = MAX_NESTING_DEPTH * 16 + 1000
    if limit < need:
        sys.setrecursionlimit(need)
    try:
        if stripped.startswith("model"):
            return parse_canonical(src)
        return parse_shorthand(src)
    finally:
        if limit < need:
            sys.setrecursionlimit(limit)


def parse_model(src: str) -> DslModel:
    module = parse_module(src)
    if len(module.models) != 1:
        raise DslError(
            Diagnostic.error(
                "DSL0109",
                f"expected exactly one model, found {len(module.models)}",
                Span.empty(),
            )
        )
    return module.models[0]
