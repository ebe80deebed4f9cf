"""failpoint-site-registry: every `failpoint.inject("…")` literal in
tidb_tpu_torch/ must appear in utils/failpoint_sites.SITES.

The chaos gates (crash_smoke, ddl_smoke, cdc_smoke, mem_smoke)
enumerate their kill/error seams from the registry — an inject site
added to the package without a registry row is a crash seam the gates
can never reach, which is exactly how recovery coverage silently
drifts. The registry row also forces the author to write down what a
kill -9 at that point must recover to.

Scope: package files only (tests/ arm ad-hoc fixture failpoints by
design). The registry is parsed from source like the error/sysvar
catalogs — tpulint never imports the code under analysis.
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule

REGISTRY_RELPATH = "utils/failpoint_sites.py"


def parse_failpoint_registry(src: str) -> set:
    """Every string key of the module-level `SITES = {...}` dict."""
    out = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names = [node.target.id]      # SITES: dict[str, str] = {…}
        else:
            continue
        if "SITES" in names and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str):
                    out.add(k.value)
    return out


@register_rule
class FailpointSiteRegistry(Rule):
    name = "failpoint-site-registry"
    severity = "error"
    doc = ("failpoint.inject site name absent from "
           "utils/failpoint_sites.SITES — the chaos/smoke gates "
           "enumerate seams from the registry, so this crash seam "
           "would silently drift out of coverage")

    def run(self, ctx):
        cfg = getattr(ctx, "config", None)
        known = getattr(cfg, "known_failpoints", None)
        if not known:
            return
        rel = ctx.relpath.replace("\\", "/")
        if "tidb_tpu_torch/" not in "/" + rel:
            return                  # tests/scripts arm ad-hoc fixtures
        for call in ctx.calls:
            f = call.func
            if not (isinstance(f, ast.Attribute) and
                    f.attr == "inject"):
                continue
            recv = f.value
            term = recv.id if isinstance(recv, ast.Name) else (
                recv.attr if isinstance(recv, ast.Attribute) else None)
            if term != "failpoint":
                continue
            if not (call.args and
                    isinstance(call.args[0], ast.Constant) and
                    isinstance(call.args[0].value, str)):
                continue
            site = call.args[0].value
            if site not in known:
                yield self.finding(
                    ctx, call,
                    f"failpoint site '{site}' is not registered in "
                    f"{REGISTRY_RELPATH} (SITES): the smoke gates "
                    f"enumerate crash seams from the registry and can "
                    f"never reach this one",
                    detail=f"failpoint:site:{site}")
