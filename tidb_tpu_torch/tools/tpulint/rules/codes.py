"""error-code-validity: referenced error attrs and sysvar names exist.

Two registries anchor statement-level compatibility:
  * tidb_tpu_torch/errors.py — the MySQL-compatible error catalog (analog of
    pkg/errno + errors.toml). A typo'd `errors.DupKeyError` or a stale
    `from ..errors import X` import raises AttributeError at the worst
    time: inside an error path, masking the real failure.
  * session/sysvars.py — the system-variable registry. A sysvar string
    that isn't registered raises ER 1193 at runtime (`sv.get("tidb_…")`
    misspelled in a device-guard knob would silently disable
    supervision limits).

Checks (catalogs parsed from the package under lint, never imported):
  * `errors.X` attribute reads and `from …errors import X` names must
    exist in the catalog;
  * duplicate error CODES inside errors.py itself (catalog uniqueness
    is part of the information_schema.tidb_errors contract);
  * string literals passed to sysvar lookups — get_sysvar("…"),
    `_knob(sv, "…", …)`, and `.get("…")`/`.set("…", …)` on a receiver
    whose terminal name is sv/sysvars/vars — must be registered.
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule

SV_RECEIVERS = {"sv", "sysvars", "vars", "sessvars", "session_vars"}


def parse_error_catalog(src: str):
    """-> (names, duplicate_code_findings_raw). Parses errors.py:
    top-level classes, functions, plain assignments, and `X = _err(
    "X", code)` entries (code collisions reported as raw tuples)."""
    names, codes = set(), {}
    dups = []
    tree = ast.parse(src)
    for stmt in tree.body:
        if isinstance(stmt, (ast.ClassDef, ast.FunctionDef)):
            names.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if not isinstance(t, ast.Name):
                    continue
                names.add(t.id)
                v = stmt.value
                if isinstance(v, ast.Call) and \
                        isinstance(v.func, ast.Name) and \
                        v.func.id == "_err" and len(v.args) >= 2 and \
                        isinstance(v.args[1], ast.Constant):
                    code = v.args[1].value
                    if code in codes:
                        dups.append((t.id, codes[code], code,
                                     stmt.lineno))
                    else:
                        codes[code] = t.id
    return names, dups


def parse_sysvar_catalog(src: str) -> set:
    """Every `SysVar("name", …)` first-argument literal in sysvars.py."""
    out = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "SysVar" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.add(node.args[0].value.lower())
    return out


@register_rule
class ErrorCodeValidity(Rule):
    name = "error-code-validity"
    severity = "error"
    doc = ("reference to an error attr / sysvar name absent from its "
           "registry, or duplicate error code in the catalog")

    def run(self, ctx):
        cfg = getattr(ctx, "config", None)
        known_errors = getattr(cfg, "known_errors", None)
        known_sysvars = getattr(cfg, "known_sysvars", None)

        if ctx.relpath.endswith("errors.py") and cfg is not None and \
                getattr(cfg, "error_dups", None):
            for name, other, code, lineno in cfg.error_dups:
                from ..core import Finding
                yield Finding(
                    rule=self.name, path=ctx.relpath, line=lineno,
                    col=0, severity=self.severity,
                    message=(f"error code {code} registered twice: "
                             f"'{name}' and '{other}' — "
                             f"information_schema.tidb_errors requires "
                             f"unique codes"),
                    context="<module>", detail=f"codes:dup:{code}")

        if known_errors:
            yield from self._check_errors(ctx, known_errors)
        if known_sysvars:
            yield from self._check_sysvars(ctx, known_sysvars)

    def _check_errors(self, ctx, known):
        # stale `from …errors import X`
        for alias, dotted, node in ctx.import_nodes:
            mod, _, leaf = dotted.rpartition(".")
            if mod.endswith("errors") and leaf not in known and \
                    not ctx.relpath.endswith("errors.py"):
                yield self.finding(
                    ctx, node,
                    f"'{leaf}' imported from the error catalog but "
                    f"not defined there (AttributeError at import)",
                    detail=f"codes:import:{leaf}")
        # errors.X attribute reads
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            if isinstance(base, ast.Name):
                resolved = ctx.imports.get(base.id, "")
                if resolved == "errors" or resolved.endswith(".errors"):
                    if node.attr not in known:
                        yield self.finding(
                            ctx, node,
                            f"errors.{node.attr} is not in the error "
                            f"catalog (tidb_tpu_torch/errors.py): "
                            f"AttributeError inside an error path",
                            detail=f"codes:attr:{node.attr}")

    def _check_sysvars(self, ctx, known):
        for call in ctx.calls:
            lit = self._sysvar_literal(ctx, call)
            if lit is not None and lit.value.lower() not in known:
                yield self.finding(
                    ctx, lit,
                    f"sysvar '{lit.value}' is not registered in "
                    f"session/sysvars.py: ER 1193 Unknown system "
                    f"variable at runtime",
                    detail=f"codes:sysvar:{lit.value}")

    @staticmethod
    def _sysvar_literal(ctx, call):
        """The string-literal sysvar name this call references, or
        None when the call is not a sysvar lookup."""
        f = call.func
        if isinstance(f, ast.Name):
            if f.id == "get_sysvar" and call.args and \
                    isinstance(call.args[0], ast.Constant) and \
                    isinstance(call.args[0].value, str):
                return call.args[0]
            if f.id == "_knob" and len(call.args) >= 2 and \
                    isinstance(call.args[1], ast.Constant) and \
                    isinstance(call.args[1].value, str):
                return call.args[1]
            return None
        if isinstance(f, ast.Attribute) and f.attr in ("get", "set"):
            recv = f.value
            term = recv.attr if isinstance(recv, ast.Attribute) else (
                recv.id if isinstance(recv, ast.Name) else None)
            if term in SV_RECEIVERS and call.args and \
                    isinstance(call.args[0], ast.Constant) and \
                    isinstance(call.args[0].value, str):
                return call.args[0]
        return None
