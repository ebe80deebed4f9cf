"""jit-purity: a fragment body must not read the card on the host, nor
mutate state outside itself.

The port has no trace: a fragment body is Python that runs on every
call and enqueues tensor operations on the device. What the reference's
rule guards against inside a jax trace is two things here:

  * a host read of a device value inside the body (`.item()`,
    `.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")`, `float()` /
    `int()` / `bool()` of a parameter, `np.asarray` / `np.array` /
    `np.nonzero` of one, `torch.cuda.synchronize()`): each waits on the
    card in the middle of the fragment, where the statement's one wait
    is the fetch of its result (utils/fetch.py);
  * `global` / `nonlocal` statements and assignments into names that
    are not the body's own: a cached fragment body is shared by every
    connection thread of a Domain, so such a write is a race, not a
    once-per-compile side effect.

Host effects — metrics, phase counters, failpoints, log lines — are
NOT flagged. In the reference they fire once per compile and vanish
from steady state; in the port they run on every call of the body, so a
counter bumped there counts each execution (ml/lowering.py counts each
fragment call of predict() so) and a failpoint fires each time.

Fragment bodies (per file):
  * a def or lambda handed to `run_fragment(...)`, to
    `phase.timed_kernel(kind, fn)` or to `parallel.mesh.shard_map(mesh,
    body_for, merge)` (the body `body_for` returns, and `merge`);
  * the defs and lambdas a builder returns (`build_*_kernel`,
    `_build_*`, `_make_pipeline_body`).
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule
from .hostsync import (HOST_NUMPY, RUN_FRAGMENT, SCALAR_BUILTINS, SYNC,
                       SYNC_METHODS, is_builder_name)

TIMED = ("phase.timed_kernel", "timed_kernel")
SHARD_MAP = ("shard_map", "mesh.shard_map", "parallel.mesh.shard_map")
# host-numpy materializers, matched by PREFIX on the resolved dotted
# name ("numpy.asarray"), never by suffix: hostsync's, and the leaves
# that only a parameter of a fragment body can reach
HOST_SYNC_LEAVES = {d.split(".")[-1] for d in HOST_NUMPY} | {
    "nonzero", "copyto", "frombuffer"}


def _returned_callables(fn, by_name, depth=2):
    """Defs/lambdas that fn returns: directly, by the name of a def
    (nested in it or of the file), or as the result of a call of a def
    of the file that returns one (a body_for that returns
    `_reader_fragment(...)`)."""
    out = []
    nested = {n.name: n for n in ast.walk(fn)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and n is not fn}
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            v = node.value
            if isinstance(v, ast.Lambda):
                out.append(v)
            elif isinstance(v, ast.Name):
                tgt = nested.get(v.id) or by_name.get(v.id)
                if tgt is not None:
                    out.append(tgt)
            elif isinstance(v, ast.Call) and depth and \
                    isinstance(v.func, ast.Name):
                tgt = nested.get(v.func.id) or by_name.get(v.func.id)
                if tgt is not None and tgt is not fn:
                    out.extend(_returned_callables(tgt, by_name,
                                                   depth - 1))
        stack.extend(ast.iter_child_nodes(node))
    return out


def traced_functions(ctx) -> list:
    """[(fn_node, how)] — every def/lambda that runs as a fragment
    body."""
    out = []
    seen = set()
    by_name = {}
    for fn in ctx.functions:
        by_name.setdefault(fn.name, fn)

    def add(node, how):
        if node is not None and node not in seen:
            out.append((node, how))
            seen.add(node)

    def resolve(arg):
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Name):
            return by_name.get(arg.id)
        return None

    for fn in ctx.functions:
        if is_builder_name(fn.name):
            for body in _returned_callables(fn, by_name):
                add(body, "built")
    for call in ctx.calls:
        if ctx.matches(call.func, RUN_FRAGMENT) and call.args:
            add(resolve(call.args[0]), "run_fragment")
        elif ctx.matches(call.func, TIMED) and len(call.args) >= 2:
            add(resolve(call.args[1]), "timed_kernel")
        elif ctx.matches(call.func, SHARD_MAP) and len(call.args) >= 3:
            body_for = resolve(call.args[1])
            if isinstance(body_for, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                for body in _returned_callables(body_for, by_name):
                    add(body, "shard_map")
            add(resolve(call.args[2]), "shard_map merge")
    return out


@register_rule
class JitPurity(Rule):
    name = "jit-purity"
    severity = "error"
    doc = ("host read of the card or non-local mutation inside a "
           "fragment body (run_fragment / timed_kernel / shard_map / "
           "a builder's callable)")

    def run(self, ctx):
        for fn, _how in traced_functions(ctx):
            yield from self._check(ctx, fn)

    def _check(self, ctx, fn):
        fname = getattr(fn, "name", "<lambda>")
        locals_ = ctx.local_names(fn)
        params = set()
        for a in (fn.args.posonlyargs + fn.args.args
                  + fn.args.kwonlyargs):
            params.add(a.arg)
        if fn.args.vararg:
            params.add(fn.args.vararg.arg)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        stack = list(body)
        while stack:
            node = stack.pop()
            stack.extend(ast.iter_child_nodes(node))
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                yield self.finding(
                    ctx, node,
                    f"'{type(node).__name__.lower()}' inside fragment "
                    f"body '{fname}': it writes an enclosing scope that "
                    f"every connection thread's call shares",
                    detail=f"purity:scope:{fname}")
            elif isinstance(node, ast.Call):
                yield from self._check_call(ctx, node, fname, params)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if not isinstance(t, (ast.Subscript, ast.Attribute)):
                        continue
                    root = ctx.root_name(t)
                    if root is not None and root not in locals_ and \
                            root not in ctx.imports:
                        yield self.finding(
                            ctx, node,
                            f"fragment body '{fname}' mutates non-local "
                            f"'{root}': every call (and every thread "
                            f"sharing the cached body) writes it",
                            detail=f"purity:mutate:{fname}:{root}")

    def _check_call(self, ctx, node, fname, params):
        func = node.func
        d = ctx.dotted(func)
        if d is not None:
            if ctx.matches(func, SYNC):
                yield self.finding(
                    ctx, node,
                    f"torch.cuda.synchronize inside fragment body "
                    f"'{fname}': a wait on the card mid-fragment",
                    detail=f"purity:sync:{fname}:synchronize")
                return
            if d.startswith("numpy.") and \
                    d.split(".")[-1] in HOST_SYNC_LEAVES and node.args \
                    and isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in params:
                yield self.finding(
                    ctx, node,
                    f"host materialization '{d}' of parameter "
                    f"'{node.args[0].id}' inside fragment body "
                    f"'{fname}': a blocking read of the card",
                    detail=f"purity:sync:{fname}:{d}")
                return
        if isinstance(func, ast.Attribute) and (
                func.attr in SYNC_METHODS or (
                    func.attr == "to" and any(
                        isinstance(a, ast.Constant) and a.value == "cpu"
                        for a in node.args))):
            yield self.finding(
                ctx, node,
                f".{func.attr}() inside fragment body '{fname}': a "
                f"blocking read of the card",
                detail=f"purity:sync:{fname}:{func.attr}")
        elif isinstance(func, ast.Name) and func.id in SCALAR_BUILTINS \
                and func.id not in ctx.imports and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Name) \
                and node.args[0].id in params:
            yield self.finding(
                ctx, node,
                f"{func.id}() on parameter '{node.args[0].id}' inside "
                f"fragment body '{fname}': a blocking scalar read of "
                f"the card when it is a device tensor",
                detail=f"purity:sync:{fname}:{func.id}")
