"""Whole-program pass: call graph + lock inventory.

Two layers, split so the incremental cache can hold one of them:

* `build_inventory(ctx)` — PER FILE, pure function of the source, fully
  JSON-serializable.  One walk over the already-built FileContext
  collects: module-level / instance lock sites (threading.Lock / RLock
  / Condition and the lockrank.ranked_* constructors, keyed by
  (module, owner, attr)); every function's outgoing calls in a
  conservative normal form (module-level name, `self.` method, member
  `self.<attr>.m()` with the attr's constructor-inferred class, import-
  alias-resolved dotted, or opaque); every `with <lock>` region with
  the acquisitions, calls, and blocking operations lexically inside
  it; and the file's waiver tables (program rules apply their own
  waivers — they have no FileContext at report time).

* `Program` — PACKAGE-WIDE, rebuilt every run from the inventories
  (cheap dict work; the expensive AST walks are what the cache skips).
  Links calls across files, resolves lock references to global lock
  nodes, and computes the transitive acquisition / blocking closure of
  every function to a bounded call depth.  Unresolvable calls stay
  opaque: the analysis is a conservative under-approximation — it
  never invents an edge, so every reported cycle is a real static
  acquisition order.

Identity: lock nodes are named `rank:<name>` for ranked locks (the
lockrank_ranks registry name IS the identity, shared across instances)
and `<relpath>:<owner>.<attr>` otherwise.  Functions are
`<relpath>::<qualname>`.
"""
from __future__ import annotations

import ast

INVENTORY_VERSION = 3

LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "cond",
}
RANKED_CTORS = {
    "lockrank.ranked_lock": "lock",
    "lockrank.ranked_rlock": "rlock",
    "lockrank.ranked_condition": "cond",
    "ranked_lock": "lock",
    "ranked_rlock": "rlock",
    "ranked_condition": "cond",
}

# blocking-op classification -------------------------------------------

_SOCKET_METHODS = {"sendall", "recv", "recvfrom", "accept"}
_WAIT_METHODS = {"wait"}


def _terminal(node):
    """Last component of a Name/Attribute chain ('' when neither)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _call_has_timeout(call) -> bool:
    if call.args:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def classify_blocking(ctx, call):
    """-> (op, what, recv_terminal) or None.  `recv_terminal` is the
    receiver's last name component (used to exempt a condition waiting
    on ITSELF inside its own `with cv:` region)."""
    f = call.func
    d = ctx.dotted(f)
    if d == "os.fsync" or (isinstance(f, ast.Attribute) and
                           f.attr == "fsync"):
        return ("fsync", d or "fsync()", _terminal(getattr(f, "value", f)))
    if d == "time.sleep":
        return ("sleep", "time.sleep()", "")
    if ctx.matches(f, ("device_guard.guarded_dispatch",
                       "guarded_dispatch")):
        return ("dispatch", "guarded_dispatch()", "")
    if isinstance(f, ast.Attribute):
        recv = _terminal(f.value)
        if f.attr == "synchronize":
            # torch.cuda.synchronize(), an event's or a stream's: a
            # wait on the card
            return ("dispatch", f"{recv}.synchronize()", recv)
        if f.attr == "flush" and not call.args and not call.keywords:
            return ("flush", f"{recv}.flush()", recv)
        if f.attr in _SOCKET_METHODS:
            return ("socket", f"{recv}.{f.attr}()", recv)
        if f.attr in _WAIT_METHODS and not _call_has_timeout(call):
            return ("wait", f"{recv}.wait() [untimed]", recv)
        if f.attr == "join" and not call.args and not call.keywords \
                and isinstance(f.value, (ast.Name, ast.Attribute)):
            return ("thread-join", f"{recv}.join()", recv)
    return None


# per-file inventory ----------------------------------------------------

def _enclosing_class(ctx, node):
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc.name
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # keep climbing: methods sit inside the class
            continue
    return None


def _lock_ctor(ctx, value):
    """value node -> (kind, ranked_name, rank_literal) or None."""
    if not isinstance(value, ast.Call):
        return None
    for suffix, kind in RANKED_CTORS.items():
        if ctx.matches(value.func, (suffix,)):
            name = None
            rank = None
            if value.args and isinstance(value.args[0], ast.Constant) \
                    and isinstance(value.args[0].value, str):
                name = value.args[0].value
            if len(value.args) > 1 and \
                    isinstance(value.args[1], ast.Constant) and \
                    isinstance(value.args[1].value, int):
                rank = value.args[1].value
            for kw in value.keywords:
                if kw.arg == "rank" and \
                        isinstance(kw.value, ast.Constant) and \
                        isinstance(kw.value.value, int):
                    rank = kw.value.value
            return (kind, name, rank)
    for suffix, kind in LOCK_CTORS.items():
        if ctx.matches(value.func, (suffix,)):
            return (kind, None, None)
    return None


def _lockref(ctx, expr, cls):
    """with-item context expr -> serializable lock reference or None
    (None: cannot be a lock acquisition we can name)."""
    if isinstance(expr, ast.Name):
        return {"kind": "name", "name": expr.id}
    if isinstance(expr, ast.Attribute):
        parts = []
        cur = expr
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        parts.reverse()
        if isinstance(cur, ast.Name) and cur.id == "self":
            if len(parts) == 1:
                return {"kind": "self", "cls": cls or "",
                        "attr": parts[0]}
            if len(parts) == 2:
                return {"kind": "selfchain", "cls": cls or "",
                        "attrs": parts}
            return None
        d = ctx.dotted(expr)
        if d:
            return {"kind": "dotted", "name": d}
    return None


def _calldesc(ctx, call, caller_cls):
    """Normalize one call site for cross-file linking."""
    f = call.func
    line = getattr(call, "lineno", 0)
    if isinstance(f, ast.Name):
        # imported names resolve through the alias table (`from .rpc
        # import send_msg` -> 'rpc.send_msg'), locals stay local
        dotted = ctx.imports.get(f.id)
        if dotted and "." in dotted:
            return {"kind": "dotted", "name": dotted, "line": line}
        return {"kind": "local", "name": f.id, "line": line}
    if isinstance(f, ast.Attribute):
        parts = []
        cur = f
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        parts.reverse()
        if isinstance(cur, ast.Name) and cur.id == "self":
            if len(parts) == 1:
                return {"kind": "self", "cls": caller_cls or "",
                        "name": parts[0], "line": line}
            if len(parts) == 2:
                return {"kind": "member", "cls": caller_cls or "",
                        "attr": parts[0], "name": parts[1],
                        "line": line}
            return {"kind": "opaque", "name": ".".join(parts),
                    "line": line}
        d = ctx.dotted(f)
        if d:
            return {"kind": "dotted", "name": d, "line": line}
    return {"kind": "opaque", "name": "<dynamic>", "line": line}


def build_inventory(ctx) -> dict:
    """One serializable inventory per file (see module docstring)."""
    locks = []
    attr_types: dict = {}
    defs = set()
    classes = set()

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            classes.add(node.name)
    for fn in ctx.functions:
        defs.add(ctx.qualname(fn))

    # lock sites: module-level NAME = ctor(), class-body NAME = ctor(),
    # and self.X = ctor() inside methods
    for a in ctx.assigns:
        if not isinstance(a, (ast.Assign, ast.AnnAssign)):
            continue
        value = a.value
        if value is None:
            continue
        got = _lock_ctor(ctx, value)
        targets = a.targets if isinstance(a, ast.Assign) else [a.target]
        for t in targets:
            owner = attr = None
            if isinstance(t, ast.Name):
                cls = _enclosing_class(ctx, a)
                if ctx.enclosing_function(a) is not None:
                    continue            # function-local lock: skip
                owner, attr = (cls or "<module>"), t.id
            elif isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self":
                cls = _enclosing_class(ctx, a)
                owner, attr = (cls or "<module>"), t.attr
                # constructor-inferred member types for member-call
                # resolution (self._wal = WAL(...))
                if got is None and isinstance(value, ast.Call):
                    d = ctx.dotted(value.func)
                    if d:
                        attr_types.setdefault(owner, {})[t.attr] = d
            if owner is None or got is None:
                continue
            kind, ranked, rank = got
            locks.append({
                "owner": owner, "attr": attr, "kind": kind,
                "ranked": ranked, "rank": rank,
                "line": getattr(a, "lineno", 0)})

    # per-function: calls, blocking ops, with-lock regions
    funcs: dict = {}

    def finfo(q):
        return funcs.setdefault(
            q, {"calls": [], "blocking": [], "regions": []})

    for call in ctx.calls:
        q = ctx.qualname(call)
        cls = _enclosing_class(ctx, call)
        finfo(q)["calls"].append(_calldesc(ctx, call, cls))
        b = classify_blocking(ctx, call)
        if b:
            finfo(q)["blocking"].append(
                {"op": b[0], "what": b[1], "recv": b[2],
                 "line": getattr(call, "lineno", 0)})

    for w in ctx.withs:
        q = ctx.qualname(w)
        cls = _enclosing_class(ctx, w)
        for item in w.items:
            ref = _lockref(ctx, item.context_expr, cls)
            if ref is None:
                continue
            region = {"lock": ref, "line": w.lineno,
                      "acquires": [], "calls": [], "blocking": []}
            for sub in w.body:
                for node in ast.walk(sub):
                    if isinstance(node, ast.With):
                        for it2 in node.items:
                            r2 = _lockref(ctx, it2.context_expr,
                                          _enclosing_class(ctx, node)
                                          or cls)
                            if r2 is not None:
                                region["acquires"].append(
                                    {"ref": r2,
                                     "line": node.lineno})
                    elif isinstance(node, ast.Call):
                        region["calls"].append(
                            _calldesc(ctx, node,
                                      _enclosing_class(ctx, node)
                                      or cls))
                        b = classify_blocking(ctx, node)
                        if b:
                            region["blocking"].append(
                                {"op": b[0], "what": b[1],
                                 "recv": b[2],
                                 "line": getattr(node, "lineno", 0)})
            finfo(q)["regions"].append(region)

    return {
        "version": INVENTORY_VERSION,
        "path": ctx.relpath,
        "defs": sorted(defs),
        "classes": sorted(classes),
        "attr_types": attr_types,
        "locks": locks,
        "funcs": funcs,
        "file_waivers": sorted(ctx.file_waivers),
        "line_waivers": {str(k): sorted(v)
                         for k, v in ctx.line_waivers.items()},
    }


# program layer ---------------------------------------------------------

class LockNode:
    __slots__ = ("id", "path", "owner", "attr", "kind", "ranked",
                 "rank", "line", "hot")

    def __init__(self, id, path, owner, attr, kind, ranked, rank,
                 line, hot):
        self.id = id
        self.path = path
        self.owner = owner
        self.attr = attr
        self.kind = kind
        self.ranked = ranked
        self.rank = rank
        self.line = line
        self.hot = hot

    def __repr__(self):
        return f"<LockNode {self.id}>"


class Program:
    """Cross-file linker over per-file inventories + transitive
    acquisition/blocking closures (bounded call depth)."""

    MAX_DEPTH = 8

    def __init__(self, inventories, config=None):
        self.inv = {inv["path"]: inv for inv in inventories}
        self.config = config
        ranks = getattr(config, "lock_ranks", None) or {}
        hot = getattr(config, "hot_locks", None) or set()
        self.ranks = ranks
        self.hot = set(hot)

        # module suffix index: path -> component tuple (minus .py)
        self._mod_comps = {}
        for path in self.inv:
            comps = path.replace("\\", "/")
            if comps.endswith(".py"):
                comps = comps[:-3]
            parts = tuple(c for c in comps.split("/") if c)
            if parts and parts[-1] == "__init__":
                parts = parts[:-1]
            self._mod_comps[path] = parts

        # global lock table
        self.locks = {}                # (path, owner, attr) -> LockNode
        self.nodes = {}                # id -> LockNode
        for path, inv in self.inv.items():
            for lk in inv["locks"]:
                ranked = lk.get("ranked")
                if ranked:
                    nid = f"rank:{ranked}"
                else:
                    nid = f"{path}:{lk['owner']}.{lk['attr']}"
                node = self.nodes.get(nid)
                if node is None:
                    node = LockNode(
                        nid, path, lk["owner"], lk["attr"],
                        lk["kind"], ranked,
                        ranks.get(ranked) if ranked else None,
                        lk["line"], bool(ranked and ranked in hot))
                    self.nodes[nid] = node
                self.locks[(path, lk["owner"], lk["attr"])] = node

        # function table
        self.funcs = {}                # (path, qualname) -> info
        for path, inv in self.inv.items():
            for q, info in inv["funcs"].items():
                self.funcs[(path, q)] = info

        self._closure_cache = {}

    # -- waivers (program rules apply their own) ------------------------

    def waived(self, path, line, rule) -> bool:
        inv = self.inv.get(path)
        if inv is None:
            return False
        if rule in inv.get("file_waivers", ()):
            return True
        return rule in inv.get("line_waivers", {}).get(str(line), ())

    # -- resolution ------------------------------------------------------

    def resolve_module(self, comps):
        """dotted-prefix components -> unique matching file path."""
        comps = tuple(comps)
        hits = [p for p, mc in self._mod_comps.items()
                if mc[-len(comps):] == comps]
        return hits[0] if len(hits) == 1 else None

    def _resolve_classref(self, path, dotted):
        """'storage.wal.WAL' or locally-imported 'WAL' -> (path, cls)."""
        comps = dotted.split(".")
        if len(comps) == 1:
            if comps[0] in self.inv.get(path, {}).get("classes", ()):
                return (path, comps[0])
            return None
        mpath = self.resolve_module(comps[:-1])
        if mpath and comps[-1] in self.inv[mpath]["classes"]:
            return (mpath, comps[-1])
        return None

    def resolve_call(self, path, desc):
        """calldesc -> (path, qualname) or None (opaque)."""
        kind = desc["kind"]
        inv = self.inv.get(path)
        if inv is None:
            return None
        defs = inv["defs"]
        if kind == "local":
            if desc["name"] in defs:
                return (path, desc["name"])
            # locally-imported class constructor: Cls() -> Cls.__init__
            cref = self._resolve_classref(path, desc["name"])
            if cref:
                p2, cls = cref
                q = f"{cls}.__init__"
                if q in self.inv[p2]["defs"]:
                    return (p2, q)
            return None
        if kind == "self":
            q = f"{desc['cls']}.{desc['name']}"
            return (path, q) if q in defs else None
        if kind == "member":
            t = inv["attr_types"].get(desc["cls"], {}).get(desc["attr"])
            if not t:
                return None
            cref = self._resolve_classref(path, t)
            if not cref:
                return None
            p2, cls = cref
            q = f"{cls}.{desc['name']}"
            return (p2, q) if q in self.inv[p2]["defs"] else None
        if kind == "dotted":
            comps = desc["name"].split(".")
            # longest module prefix wins: try to bind the tail as a
            # function (or Class.method / Class.__init__) in that file
            for i in range(len(comps) - 1, 0, -1):
                mpath = self.resolve_module(comps[:i])
                if mpath is None:
                    continue
                tail = ".".join(comps[i:])
                tdefs = self.inv[mpath]["defs"]
                if tail in tdefs:
                    return (mpath, tail)
                if tail in self.inv[mpath]["classes"]:
                    q = f"{tail}.__init__"
                    if q in tdefs:
                        return (mpath, q)
                return None
        return None

    def resolve_lockref(self, path, ref):
        """lockref -> LockNode or None."""
        if ref is None:
            return None
        kind = ref["kind"]
        if kind == "name":
            return self.locks.get((path, "<module>", ref["name"]))
        if kind == "self":
            node = self.locks.get((path, ref["cls"], ref["attr"]))
            if node:
                return node
            # helper classes in the same file (mixins): any unique
            # same-file owner with that attr
            cands = [n for (p, o, a), n in self.locks.items()
                     if p == path and a == ref["attr"]]
            return cands[0] if len(cands) == 1 else None
        if kind == "selfchain":
            attrs = ref["attrs"]
            if len(attrs) != 2:
                return None
            inv = self.inv.get(path, {})
            t = inv.get("attr_types", {}).get(ref["cls"], {}) \
                .get(attrs[0])
            if not t:
                return None
            cref = self._resolve_classref(path, t)
            if not cref:
                return None
            p2, cls = cref
            return self.locks.get((p2, cls, attrs[1]))
        if kind == "dotted":
            comps = ref["name"].split(".")
            if len(comps) < 2:
                return None
            mpath = self.resolve_module(comps[:-1])
            if mpath is None:
                return None
            return self.locks.get((mpath, "<module>", comps[-1]))
        return None

    # -- transitive closures ---------------------------------------------

    def closure(self, path, qualname):
        """-> (acquires, blocking) reachable by CALLING this function.

        acquires: {node_id: (via, line)} — via is a 'f -> g -> h' call
        chain (first hop inside this function). blocking: list of
        (op, what, via, path, line).  Bounded at MAX_DEPTH."""
        return self._closure(path, qualname, 0, ())

    def _closure(self, path, qualname, depth, seen):
        key = (path, qualname)
        cached = self._closure_cache.get(key)
        if cached is not None:
            return cached
        if key in seen or depth > self.MAX_DEPTH:
            return ({}, [])
        info = self.funcs.get(key)
        if info is None:
            return ({}, [])
        acquires: dict = {}
        blocking: list = []
        label = f"{path}::{qualname}"
        for region in info["regions"]:
            node = self.resolve_lockref(path, region["lock"])
            if node is not None and node.id not in acquires:
                acquires[node.id] = (label, region["line"])
            for acq in region["acquires"]:
                n2 = self.resolve_lockref(path, acq["ref"])
                if n2 is not None and n2.id not in acquires:
                    acquires[n2.id] = (label, acq["line"])
        for b in info["blocking"]:
            blocking.append((b["op"], b["what"], label, path,
                             b["line"]))
        for desc in info["calls"]:
            target = self.resolve_call(path, desc)
            if target is None:
                continue
            sub_acq, sub_blk = self._closure(
                target[0], target[1], depth + 1, seen + (key,))
            hop = f"{label} -> "
            for nid, (via, line) in sub_acq.items():
                if nid not in acquires:
                    acquires[nid] = (hop + via, line)
            # guarded_dispatch is ITSELF a blocking op (classified as
            # 'dispatch' at the call site); its internals (retry
            # backoff sleeps) would only duplicate that one finding —
            # but its lock acquisitions above are real edges
            if desc.get("name", "").split(".")[-1] == \
                    "guarded_dispatch":
                continue
            for (op, what, via, bpath, line) in sub_blk:
                blocking.append((op, what, hop + via, bpath, line))
        result = (acquires, blocking)
        # memoize only top-level computations (seen == ()) so partial
        # cycle-guarded results never poison the cache
        if not seen:
            self._closure_cache[key] = result
        return result

    # -- the lock-acquisition digraph ------------------------------------

    def lock_edges(self):
        """[(holder LockNode, acquired LockNode, edge_info)] for every
        `with L` region: direct nested acquisitions plus acquisitions
        reachable through calls made while L is held.  edge_info:
        {path, line, func, via}."""
        edges = []
        for (path, q), info in sorted(self.funcs.items()):
            for region in info["regions"]:
                holder = self.resolve_lockref(path, region["lock"])
                if holder is None:
                    continue
                base = {"path": path, "func": q,
                        "line": region["line"]}
                for acq in region["acquires"]:
                    node = self.resolve_lockref(path, acq["ref"])
                    if node is None or node.id == holder.id:
                        continue
                    edges.append((holder, node,
                                  dict(base, line=acq["line"],
                                       via="direct nesting")))
                for desc in region["calls"]:
                    target = self.resolve_call(path, desc)
                    if target is None:
                        continue
                    sub_acq, _ = self.closure(*target)
                    for nid, (via, line) in sub_acq.items():
                        node = self.nodes[nid]
                        if node.id == holder.id:
                            continue
                        edges.append(
                            (holder, node,
                             dict(base, line=desc["line"],
                                  via=f"call {via}")))
        return edges

    def region_blocking(self):
        """[(holder LockNode, op, what, via, report_path, report_line,
        region)] — blocking operations executed while holder is held
        (direct or through calls)."""
        out = []
        for (path, q), info in sorted(self.funcs.items()):
            for region in info["regions"]:
                holder = self.resolve_lockref(path, region["lock"])
                if holder is None:
                    continue
                own = _terminal_of_ref(region["lock"])
                for b in region["blocking"]:
                    if b["op"] == "wait" and b["recv"] == own:
                        continue       # cv.wait() on its OWN lock
                    out.append((holder, b["op"], b["what"],
                                f"{path}::{q}", path, b["line"],
                                region))
                for desc in region["calls"]:
                    target = self.resolve_call(path, desc)
                    if target is None:
                        continue
                    if desc.get("name", "").split(".")[-1] == \
                            "guarded_dispatch":
                        continue       # flagged as 'dispatch' directly
                    _, sub_blk = self.closure(*target)
                    for (op, what, via, bpath, bline) in sub_blk:
                        out.append((holder, op, what,
                                    f"{path}::{q} -> {via}",
                                    path, desc["line"], region))
        return out


def _terminal_of_ref(ref):
    if ref is None:
        return ""
    k = ref["kind"]
    if k == "name":
        return ref["name"]
    if k == "self":
        return ref["attr"]
    if k == "selfchain":
        return ref["attrs"][-1]
    if k == "dotted":
        return ref["name"].split(".")[-1]
    return ""


def find_cycles(edges):
    """SCC over the lock digraph -> [ [edge, edge, ...] one cycle per
    SCC ], each cycle a closed edge path (deterministic order)."""
    adj: dict = {}
    for holder, node, info in edges:
        adj.setdefault(holder.id, {}).setdefault(node.id, (holder,
                                                           node, info))
        adj.setdefault(node.id, {})

    # Tarjan
    index: dict = {}
    low: dict = {}
    onstack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        onstack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in onstack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    cycles = []
    for comp in sccs:
        comp_set = set(comp)
        if len(comp) == 1:
            v = comp[0]
            if v not in adj.get(v, {}):
                continue               # no self-loop: not a cycle
        # walk one closed path through the SCC
        start = sorted(comp)[0]
        path_edges = []
        visited = {start}
        cur = start
        while True:
            nxts = [w for w in sorted(adj.get(cur, ()))
                    if w in comp_set]
            if not nxts:
                break
            nxt = next((w for w in nxts if w not in visited),
                       nxts[0])
            path_edges.append(adj[cur][nxt])
            if nxt in visited:
                # close the loop: trim the prefix before nxt
                ids = [e[0].id for e in path_edges]
                if nxt in ids:
                    path_edges = path_edges[ids.index(nxt):]
                break
            visited.add(nxt)
            cur = nxt
        if path_edges:
            cycles.append(path_edges)
    return cycles
