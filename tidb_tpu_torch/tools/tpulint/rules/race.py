"""shared-state-race: module-level mutable state mutated without a lock.

The phase.py bug class: a module-level dict accumulated by
concurrent connection threads blurred per-statement device-time
attribution across digests; the fix was threading.local. The same shape
recurs anywhere a module-global container is mutated from function
bodies that multiple threads enter — failpoint registries, kernel
caches, compat counter maps.

Detection (per-file):
  * module-level `NAME = {} / [] / set() / dict() / deque() /
    defaultdict() / WeakSet() / ...` registers NAME as shared mutable;
    `NAME = threading.local()` is exempt by construction;
  * module-level `NAME = threading.Lock()/RLock()/Condition()` registers
    NAME as a lock;
  * inside any function: subscript assignment/deletion on NAME, or a
    mutating method call (.append/.add/.update/.pop/.setdefault/
    .clear/...) whose root is NAME, FLAGS unless some enclosing `with`
    statement's context expression references a registered lock.

Module-level (import-time) mutations are single-threaded and exempt.
A container that is genuinely confined to one thread takes an inline
waiver stating the confinement argument.
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule

MUTABLE_CTORS = ("dict", "list", "set", "collections.defaultdict",
                 "collections.OrderedDict", "collections.deque",
                 "defaultdict", "OrderedDict", "deque",
                 "weakref.WeakSet", "weakref.WeakValueDictionary",
                 "WeakSet", "WeakValueDictionary")
LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
              "threading.Semaphore", "threading.BoundedSemaphore",
              # the runtime lock-rank sanitizer's constructors return
              # (wrapped) locks — utils/lockrank.py
              "lockrank.ranked_lock", "lockrank.ranked_rlock",
              "lockrank.ranked_condition", "ranked_lock",
              "ranked_rlock", "ranked_condition")
TLOCAL_CTORS = ("threading.local",)
MUTATING_METHODS = {"append", "add", "update", "pop", "setdefault",
                    "clear", "extend", "remove", "discard", "popitem",
                    "insert", "appendleft", "popleft"}


def classify_module_state(ctx):
    """-> (mutable_names, lock_names). threading.local containers are
    dropped (thread-confined by construction)."""
    mutable, locks = set(), set()
    for name, value in ctx.module_assigns.items():
        if isinstance(value, (ast.Dict, ast.List, ast.Set)):
            mutable.add(name)
        elif isinstance(value, ast.Call):
            if ctx.matches(value.func, LOCK_CTORS):
                locks.add(name)
            elif ctx.matches(value.func, TLOCAL_CTORS):
                continue
            elif ctx.matches(value.func, MUTABLE_CTORS):
                mutable.add(name)
    return mutable, locks


def _lock_aliases(func, locks) -> set:
    """Local names bound to a lock inside `func`: `mu = _MU` or
    `mu = mod._MU` (a module attribute aliased into a local is a lock
    handle, not a fresh object — the `with mu:` that follows guards
    exactly like `with mod._MU:` would)."""
    aliases: set = set()
    for sub in ast.walk(func):
        if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
            continue
        t = sub.targets[0]
        if not isinstance(t, ast.Name):
            continue
        v = sub.value
        if isinstance(v, ast.Name) and v.id in locks:
            aliases.add(t.id)
        elif isinstance(v, ast.Attribute) and not isinstance(
                v.value, ast.Call):
            aliases.add(t.id)
    return aliases


def _under_lock(ctx, node, locks) -> bool:
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return False                  # a lock taken by our caller
            # is invisible here; cross-function locking needs a waiver
        if isinstance(anc, ast.With):
            for item in anc.items:
                expr = item.context_expr
                # `with self._store._mu:` — a bare attribute chain in a
                # with is a lock handle held elsewhere (an object's own
                # mutex guarding the module map it manages); only a
                # CALL result (`with open(...)`) stays a non-lock
                if isinstance(expr, ast.Attribute):
                    return True
                for sub in ast.walk(expr):
                    if isinstance(sub, ast.Name):
                        if sub.id in locks:
                            return True
                        fn = ctx.enclosing_function(node)
                        if fn is not None and \
                                sub.id in _lock_aliases(fn, locks):
                            return True
    return False


@register_rule
class SharedStateRace(Rule):
    name = "shared-state-race"
    severity = "error"
    doc = ("module-level mutable container mutated from a function "
           "body without a module-level threading.Lock held")

    def run(self, ctx):
        mutable, locks = classify_module_state(ctx)
        if not mutable:
            return
        for a in ctx.assigns:
            targets = a.targets if isinstance(a, ast.Assign) else \
                [getattr(a, "target", None)]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    root = ctx.root_name(t)
                    if root in mutable:
                        yield from self._flag(ctx, a, root, locks,
                                              "subscript write")
        for d in ctx.deletes:
            for t in d.targets:
                if isinstance(t, ast.Subscript):
                    root = ctx.root_name(t)
                    if root in mutable:
                        yield from self._flag(ctx, d, root, locks,
                                              "subscript delete")
        for call in ctx.calls:
            f = call.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in MUTATING_METHODS:
                # root through Subscript/Attribute chains too:
                # `_QUEUES[name].append(x)` mutates _QUEUES's value
                # graph exactly like a subscript write does
                root = ctx.root_name(f.value)
                if root in mutable:
                    yield from self._flag(ctx, call, root, locks,
                                          f".{f.attr}()")

    def _flag(self, ctx, node, root, locks, how):
        if ctx.enclosing_function(node) is None:
            return                         # import-time: single-threaded
        if _under_lock(ctx, node, locks):
            return
        hint = "no module-level lock exists" if not locks else \
            f"locks available: {', '.join(sorted(locks))}"
        yield self.finding(
            ctx, node,
            f"module-level mutable '{root}' mutated ({how}) outside "
            f"any `with <lock>:` block ({hint}); the phase.py race "
            f"class — add a lock, use threading.local, or waive with "
            f"the thread-confinement argument",
            detail=f"race:{root}:{ctx.qualname(node)}")
