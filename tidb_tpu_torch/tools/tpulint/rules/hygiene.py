"""metrics-hygiene: instruments are born documented and bounded.

The exposition contract (utils/metrics.py): every Counter/Gauge/
Histogram surfaces on /metrics with # HELP text, and label SETS are
static — label VALUES drawn from user data (statement text, table
names, free-form error strings) explode series cardinality and leak
query contents into the scrape (the reason reason_code() exists for
decline reasons).

Flags:
  * REGISTRY.counter/gauge/histogram(...) where the metric name or the
    HELP text is not a non-empty string literal, or labelnames is not
    a literal tuple/list of string constants;
  * .labels(...) arguments built by interpolation — f-strings, string
    concatenation/%-formatting, .format(...), str(...) — the
    cardinality/leak shape. Plain names, attributes, literals, and
    bounded derivations (site.split(...)[0], reason_code(msg)) pass.
  * span(...) call sites (utils/tracing: tracer.span / the module-level
    helper) whose span NAME is not a string literal — span names are
    the trace vocabulary TRACE renders and tests grep for; a computed
    name is the same unbounded-cardinality shape as a dynamic label
    (attributes exist for the variable part).
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule

CTOR_ATTRS = {"counter", "gauge", "histogram"}
REGISTRY_BASES = {"REGISTRY", "registry"}


def _is_str_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _interpolated(node) -> str:
    """Non-empty reason string when the expr smells like string
    interpolation; '' when it looks bounded."""
    if isinstance(node, ast.JoinedStr):
        return "f-string"
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.Add, ast.Mod)):
        return "string concatenation/%-format"
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "format":
            return ".format()"
        if isinstance(f, ast.Name) and f.id in ("str", "repr"):
            return f"{f.id}()"
    return ""


@register_rule
class MetricsHygiene(Rule):
    name = "metrics-hygiene"
    severity = "error"
    doc = ("metric instrument without literal HELP text / static label "
           "set, or label value built by string interpolation")

    def run(self, ctx):
        for call in ctx.calls:
            f = call.func
            if isinstance(f, ast.Name):
                if f.id == "span":
                    yield from self._check_span(ctx, call, None)
                continue
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr == "span":
                yield from self._check_span(ctx, call, f)
            elif f.attr in CTOR_ATTRS:
                base = ctx.root_name(f.value)
                if base in REGISTRY_BASES or (
                        isinstance(f.value, ast.Name)
                        and "registry" in f.value.id.lower()):
                    yield from self._check_ctor(ctx, call, f.attr)
            elif f.attr == "labels":
                yield from self._check_labels(ctx, call)

    def _check_ctor(self, ctx, call, kind):
        args = list(call.args)
        kwargs = {kw.arg: kw.value for kw in call.keywords}
        name = args[0] if args else kwargs.get("name")
        help_text = args[1] if len(args) > 1 else kwargs.get("help_text")
        labels = args[2] if len(args) > 2 else kwargs.get("labelnames")
        slug = "?"
        if _is_str_const(name):
            slug = name.value
        else:
            yield self.finding(
                ctx, call,
                f"{kind}() metric name is not a string literal: the "
                f"instrument namespace must be enumerable statically",
                detail=f"hygiene:name:{kind}")
        if not _is_str_const(help_text) or not help_text.value.strip():
            yield self.finding(
                ctx, call,
                f"{kind}('{slug}') constructed without literal, "
                f"non-empty HELP text (# HELP is part of the "
                f"exposition contract)",
                detail=f"hygiene:help:{slug}")
        if labels is not None:
            ok = isinstance(labels, (ast.Tuple, ast.List)) and \
                all(_is_str_const(e) for e in labels.elts)
            if not ok:
                yield self.finding(
                    ctx, call,
                    f"{kind}('{slug}') labelnames is not a literal "
                    f"tuple of string constants: label sets must be "
                    f"static",
                    detail=f"hygiene:labelnames:{slug}")

    def _check_span(self, ctx, call, f):
        """Flag span(...) with a non-literal name. Attribute form only
        fires on tracer-like receivers (tracer.span, _tracing.span,
        domain.tracer.span) — not arbitrary objects with a .span
        method; the bare-name form is the tracing module helper."""
        if f is not None:
            d = (ctx.dotted(f.value) or "").lower()
            root = (ctx.root_name(f.value) or "").lower()
            if "tracer" not in d and "tracing" not in d \
                    and "tracer" not in root and "tracing" not in root:
                return
        name = call.args[0] if call.args else next(
            (kw.value for kw in call.keywords if kw.arg == "name"), None)
        if not _is_str_const(name):
            yield self.finding(
                ctx, call,
                "span() name is not a string literal: span names are "
                "the trace vocabulary (TRACE trees, tests, dashboards) "
                "— keep the name static and put the variable part in "
                "an attribute",
                detail=f"hygiene:spanname:{ctx.qualname(call)}")

    def _check_labels(self, ctx, call):
        # only flag .labels() on metric-looking receivers: ALL_CAPS
        # module instruments (DEVICE_FALLBACKS) or *metrics* modules —
        # not arbitrary objects that happen to have a .labels attr
        base = call.func.value
        root = ctx.root_name(base)
        looks_metric = False
        if isinstance(base, ast.Name) and base.id.isupper():
            looks_metric = True
        elif isinstance(base, ast.Attribute) and base.attr.isupper():
            looks_metric = True
        d = ctx.dotted(base)
        if d is not None and ("metrics." in d or d.startswith("metrics")):
            looks_metric = True
        if not looks_metric and root not in REGISTRY_BASES:
            return
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            why = _interpolated(arg)
            if why:
                yield self.finding(
                    ctx, call,
                    f"label value built by {why}: unbounded series "
                    f"cardinality / user data in label values — fold "
                    f"through a bounded slug (metrics.reason_code) "
                    f"instead",
                    detail=f"hygiene:labelvalue:{ctx.qualname(call)}")
