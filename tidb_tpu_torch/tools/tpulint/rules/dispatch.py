"""unguarded-dispatch: every device dispatch goes through
device_guard.guarded_dispatch.

The supervision contract (utils/device_guard.py): running a fragment on
the card is a call against a device that can fail — an out-of-memory,
a lost context, a kernel that faults. A naked call turns any of those
into an unclassified statement error instead of a supervised
retry / evict / degrade (on the CPU) or a classified failure (on the
card).

What counts as a dispatch (per file, alias-tracked; the sources of the
host-sync rule):
  * a call of `run_fragment(...)` (copr/dag_exec.py, the seam every
    fragment goes through);
  * a call of a name bound to a kernel callable: from
    `<x>._kernel_cache.put(...)` (also `kc.get(k) or kc.put(k, ...)`),
    `phase.timed_kernel(...)`, or a builder (`build_*_kernel`,
    `_build_*`, `_make_pipeline_body`);
  * a call of an ops/scan_kernels wrapper (masked_sums,
    dense_group_sums, range_filter_sums).

A dispatch is GUARDED when
  * it sits (lexically) inside a lambda/def that is an argument of a
    guarded_dispatch(...) call (or of a same-file or named guard
    wrapper: a function that hands its own callable parameter to
    guarded_dispatch, such as vector/ivf.py `guarded`), or
  * its enclosing function is referenced by name anywhere inside such
    a call's supervised arguments (the `lambda: self._run(...)`
    idiom), or
  * its enclosing function is itself a fragment body (a builder's
    returned callable, or a def named in a builder): a kernel inside a
    fragment is part of that fragment's one dispatch.

Cross-FILE supervision (a module whose only callers guard) is invisible
to a per-file walk by design: such sites carry an inline waiver naming
the guarding caller, so the contract stays auditable.
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule
from .hostsync import (RUN_FRAGMENT, _leaf, is_builder_name,
                       is_kernel_maker, is_scan_kernel_call)

GUARD = ("guarded_dispatch",)
# guard wrappers defined in another file of the package
GUARD_WRAPPERS = ("ivf.guarded", "vector.ivf.guarded")


def guard_wrappers(ctx) -> set:
    """Same-file functions that hand their own callable parameter to
    guarded_dispatch as the supervised callable."""
    out = set()
    for fn in ctx.functions:
        params = {a.arg for a in fn.args.posonlyargs + fn.args.args}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    ctx.matches(node.func, GUARD) and node.args and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in params:
                out.add(fn.name)
    return out


def is_guard_call(ctx, call, wrappers) -> bool:
    f = call.func
    if ctx.matches(f, GUARD + GUARD_WRAPPERS):
        return True
    return isinstance(f, ast.Name) and f.id in wrappers


def kernel_names(ctx) -> set:
    """Names bound (anywhere in the file) to kernel callables."""
    out = set()
    for a in ctx.assigns:
        if not isinstance(a, ast.Assign) or not is_kernel_maker(ctx,
                                                                a.value):
            continue
        for t in a.targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def builder_bodies(ctx) -> set:
    """Names of defs nested in a builder (build_*_kernel, _build_*,
    _make_pipeline_body): the fragment bodies it builds."""
    out = set()
    for fn in ctx.functions:
        if not is_builder_name(fn.name):
            continue
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef)):
                out.add(node.name)
    return out


def caller_guarded_names(ctx, wrappers) -> set:
    """Function names INVOKED (or passed as a bare callable) inside the
    supervised arguments of a guard call — the callable (first
    positional) and `host_fallback=` — their bodies are supervised by
    that call. Only call-position names count: a data argument that
    happens to share a function's name must NOT exempt it."""
    out: set = set()
    for call in ctx.calls:
        if not is_guard_call(ctx, call, wrappers):
            continue
        supervised = list(call.args[:2]) + [
            kw.value for kw in call.keywords
            if kw.arg in ("host_fallback", "fn")]
        for sub in supervised:
            if isinstance(sub, ast.Name):
                out.add(sub.id)
            elif isinstance(sub, ast.Attribute):
                out.add(sub.attr)
            for node in ast.walk(sub):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name):
                    out.add(f.id)
                elif isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    # only self-method calls name a same-file function;
                    # `cache.put(...)` is another object's method and
                    # must not exempt a local `def put`
                    out.add(f.attr)
    return out


@register_rule
class UnguardedDispatch(Rule):
    name = "unguarded-dispatch"
    severity = "error"
    doc = ("device dispatch (run_fragment, a kernel callable or a scan "
           "kernel wrapper) not routed through "
           "device_guard.guarded_dispatch")

    def run(self, ctx):
        kernels = kernel_names(ctx)
        wrappers = guard_wrappers(ctx)
        guarded_fns = caller_guarded_names(ctx, wrappers)
        bodies = builder_bodies(ctx)
        for call in ctx.calls:
            callee = None
            if ctx.matches(call.func, RUN_FRAGMENT):
                callee = "run_fragment"
            elif isinstance(call.func, ast.Name) and \
                    call.func.id in kernels:
                callee = call.func.id
            elif is_scan_kernel_call(ctx, call):
                callee = _leaf(call.func)
            if callee is None:
                continue
            if self._guarded(ctx, call, guarded_fns, bodies, wrappers):
                continue
            yield self.finding(
                ctx, call,
                f"device dispatch '{callee}' is not routed through "
                f"device_guard.guarded_dispatch (the supervision "
                f"contract: classify/retry/degrade instead of a naked "
                f"statement error)",
                detail=f"dispatch:{callee}")

    def _guarded(self, ctx, call, guarded_fns, bodies, wrappers) -> bool:
        # `crossed` gates the guard-call check on having passed a
        # function boundary first: `guarded_dispatch(kern(x))` evaluates
        # the dispatch EAGERLY (before supervision starts) and must
        # still be flagged; `guarded_dispatch(lambda: kern(x))` is the
        # supervised form.
        crossed = False
        for anc in ctx.ancestors(call):
            if crossed and isinstance(anc, ast.Call) and \
                    is_guard_call(ctx, anc, wrappers):
                return True
            if isinstance(anc, (ast.Lambda, ast.FunctionDef,
                                ast.AsyncFunctionDef)):
                crossed = True
                if isinstance(anc, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    if anc.name in guarded_fns or anc.name in bodies \
                            or is_builder_name(anc.name):
                        return True
        return False
