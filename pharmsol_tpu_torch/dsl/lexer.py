"""DSL lexer: tokens with source spans.

Parity with pharmsol-dsl/src/lexer.rs: identifiers, numbers, operators
(incl. ``->``, ``~``, ``@``, comparisons, ``&&``/``||``, ``^`` power),
punctuation, ``#`` and ``//`` line comments, newline tokens (significant for
the authoring shorthand).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .diagnostic import Diagnostic, DslError, Span


@dataclass(frozen=True)
class Token:
    kind: str  # 'ident' | 'number' | 'op' | 'punct' | 'newline' | 'eof'
    text: str
    span: Span

    def is_op(self, *texts) -> bool:
        return self.kind == "op" and self.text in texts

    def is_punct(self, *texts) -> bool:
        return self.kind == "punct" and self.text in texts

    def is_ident(self, *texts) -> bool:
        return self.kind == "ident" and (not texts or self.text in texts)


_TWO_CHAR_OPS = ("->", "==", "!=", "<=", ">=", "&&", "||")
_ONE_CHAR_OPS = "+-*/^<>=!~@"
_PUNCT = "{}()[],;:"


def tokenize(src: str) -> List[Token]:
    tokens: List[Token] = []
    i = 0
    n = len(src)
    line = 1
    col = 1

    def span(start_i, start_line, start_col, end_i):
        return Span(start_i, end_i, start_line, start_col)

    while i < n:
        c = src[i]
        start_i, start_line, start_col = i, line, col
        if c == "\n":
            tokens.append(Token("newline", "\n", span(i, line, col, i + 1)))
            i += 1
            line += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if c == "#" or src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
                col += 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            text = src[i:j]
            tokens.append(Token("ident", text, span(i, line, col, j)))
            col += j - i
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = src[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    # don't swallow `1..2` range dots
                    if j + 1 < n and src[j + 1] == ".":
                        break
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    src[j + 1].isdigit() or src[j + 1] in "+-"
                ):
                    seen_exp = True
                    j += 1
                    if src[j] in "+-":
                        j += 1
                else:
                    break
            text = src[i:j]
            tokens.append(Token("number", text, span(i, line, col, j)))
            col += j - i
            i = j
            continue
        matched = False
        for op in _TWO_CHAR_OPS:
            if src.startswith(op, i):
                tokens.append(Token("op", op, span(i, line, col, i + len(op))))
                i += len(op)
                col += len(op)
                matched = True
                break
        if matched:
            continue
        if src.startswith("..", i):
            tokens.append(Token("op", "..", span(i, line, col, i + 2)))
            i += 2
            col += 2
            continue
        if c in _ONE_CHAR_OPS:
            tokens.append(Token("op", c, span(i, line, col, i + 1)))
            i += 1
            col += 1
            continue
        if c in _PUNCT:
            tokens.append(Token("punct", c, span(i, line, col, i + 1)))
            i += 1
            col += 1
            continue
        raise DslError(
            Diagnostic.error(
                "DSL0001",
                f"unexpected character `{c}`",
                Span(i, i + 1, line, col),
            )
        )
    tokens.append(Token("eof", "", Span(n, n, line, col)))
    return tokens
