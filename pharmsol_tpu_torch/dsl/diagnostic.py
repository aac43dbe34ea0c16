"""DSL diagnostics: spans, coded messages, suggestions.

Parity with pharmsol-dsl/src/diagnostic.rs: each diagnostic carries a code
(``DSLxxxx``), a primary span, optional notes/help/suggestions, and can be
rendered with a source excerpt. ``DiagnosticReport`` aggregates and
serializes to JSON.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..errors import PharmsolError


@dataclass(frozen=True)
class Span:
    start: int
    end: int
    line: int = 0
    column: int = 0

    @staticmethod
    def empty() -> "Span":
        return Span(0, 0, 0, 0)

    def merge(self, other: "Span") -> "Span":
        return Span(min(self.start, other.start), max(self.end, other.end), self.line, self.column)


@dataclass
class Diagnostic:
    severity: str  # 'error' | 'warning'
    code: str
    message: str
    span: Span
    notes: List[str] = field(default_factory=list)
    help: Optional[str] = None
    suggestion: Optional[str] = None

    @staticmethod
    def error(code: str, message: str, span: Span, help: Optional[str] = None,
              suggestion: Optional[str] = None) -> "Diagnostic":
        return Diagnostic("error", code, message, span, help=help, suggestion=suggestion)

    @staticmethod
    def warning(code: str, message: str, span: Span) -> "Diagnostic":
        return Diagnostic("warning", code, message, span)

    def render(self, source: Optional[str] = None) -> str:
        loc = f"{self.span.line}:{self.span.column}" if self.span.line else "?"
        out = [f"{self.severity}[{self.code}]: {self.message} (at {loc})"]
        if source is not None and self.span.line:
            lines = source.splitlines()
            if 0 < self.span.line <= len(lines):
                src_line = lines[self.span.line - 1]
                out.append(f"    {src_line}")
                out.append("    " + " " * max(self.span.column - 1, 0) + "^")
        for note in self.notes:
            out.append(f"  note: {note}")
        if self.help:
            out.append(f"  help: {self.help}")
        if self.suggestion:
            out.append(f"  suggestion: did you mean `{self.suggestion}`?")
        return "\n".join(out)

    def to_dict(self) -> dict:
        return {
            "severity": self.severity,
            "code": self.code,
            "message": self.message,
            "span": {"start": self.span.start, "end": self.span.end,
                     "line": self.span.line, "column": self.span.column},
            "notes": self.notes,
            "help": self.help,
            "suggestion": self.suggestion,
        }


@dataclass
class DiagnosticReport:
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, d: Diagnostic) -> None:
        self.diagnostics.append(d)

    def has_errors(self) -> bool:
        return any(d.severity == "error" for d in self.diagnostics)

    def to_json(self) -> str:
        return json.dumps([d.to_dict() for d in self.diagnostics], indent=2)


class DslError(PharmsolError):
    """Raised with one or more diagnostics attached."""

    def __init__(self, *diagnostics: Diagnostic, source: Optional[str] = None):
        self.diagnostics = list(diagnostics)
        self.source = source
        super().__init__("\n".join(d.render(source) for d in self.diagnostics))


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (name_match.rs parity for typo suggestions)."""
    if a == b:
        return 0
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def best_suggestion(name: str, candidates) -> Optional[str]:
    """Closest candidate within an edit-distance budget (<= 1 + len/3).

    Ties break lexicographically: callers often pass sets, and set
    iteration order varies with the hash seed — an unsorted walk made
    the suggestion text nondeterministic across processes.
    """
    best = None
    best_d = None
    for c in sorted(candidates):
        d = edit_distance(name.lower(), c.lower())
        if best_d is None or d < best_d:
            best, best_d = c, d
    if best is not None and best_d is not None and best_d <= max(1, len(name) // 3):
        return best
    return None
