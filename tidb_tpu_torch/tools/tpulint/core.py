"""Rule registry + Finding model.

A Rule inspects one file through its FileContext (built by a single AST
walk) and yields Findings. Rules register at import time into a
process-global registry (guarded by a lock — tpulint lints itself, and
the shared-state-race rule would rightly flag an unlocked registry).

Finding identity for waiver/baseline matching is line-INDEPENDENT:
(rule, file, context, detail), where `context` is the enclosing
function's qualname and `detail` a stable slug — so a baseline survives
unrelated edits that shift line numbers.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

SEVERITIES = ("error", "warning", "note")


@dataclass
class Finding:
    rule: str
    path: str                  # repo-relative, forward slashes
    line: int
    col: int
    severity: str
    message: str
    context: str = "<module>"  # enclosing function qualname
    detail: str = ""           # stable identity slug (no line numbers)
    baselined: bool = False
    reason: str = ""           # baseline justification, when baselined

    def key(self):
        return (self.rule, self.path, self.context, self.detail)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "severity": self.severity,
            "message": self.message, "context": self.context,
            "detail": self.detail, "baselined": self.baselined,
        }


class Rule:
    """Base rule. Subclasses set `name`, `severity`, `doc` and
    implement run(ctx) -> iterable[Finding]."""

    name = ""
    severity = "warning"
    doc = ""
    scope = "file"                 # "file" | "program"

    def run(self, ctx):
        raise NotImplementedError

    def finding(self, ctx, node, message, detail, severity=None):
        return Finding(
            rule=self.name, path=ctx.relpath,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            severity=severity or self.severity, message=message,
            context=ctx.qualname(node), detail=detail)


class ProgramRule(Rule):
    """Whole-program rule: sees every file's inventory at once through
    a callgraph.Program. Program rules apply their OWN waivers (via
    program.waived) — there is no FileContext at report time. run(ctx)
    is a no-op so the per-file engine loop can skip them uniformly."""

    scope = "program"

    def run(self, ctx):
        return ()

    def run_program(self, program):
        raise NotImplementedError

    def finding_at(self, path, line, context, message, detail,
                   severity=None):
        return Finding(
            rule=self.name, path=path, line=line, col=0,
            severity=severity or self.severity, message=message,
            context=context, detail=detail)


_RULES: dict = {}
_RULES_MU = threading.Lock()


def register_rule(cls):
    """Class decorator: instantiate + register. Later registration of
    the same name wins (tests override rules with tweaked configs)."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    with _RULES_MU:
        _RULES[inst.name] = inst
    return cls


def all_rules() -> dict:
    with _RULES_MU:
        return dict(_RULES)


def get_rule(name: str):
    with _RULES_MU:
        return _RULES.get(name)
