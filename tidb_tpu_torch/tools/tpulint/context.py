"""FileContext: ONE AST walk per file, shared by every rule.

The walk builds:
  * parent pointers (ancestor queries for "am I inside a guarded
    lambda / a `with lock:` block / a traced function");
  * an import alias table (`import torch`, `from ..utils import
    device_guard`, `from ..parallel.mesh import shard_map as sm`) so
    rules match *resolved* dotted names, not spellings;
  * node indexes (calls, function defs, module-level assignments,
    global/nonlocal statements) so each rule iterates a pre-filtered
    list instead of re-walking the tree;
  * per-function local-name sets (lazy, memoized) for closure-mutation
    and scope checks;
  * inline waivers: `# tpulint: disable=<rule>[,<rule>]` applies to its
    own line, or — on a standalone comment line — to the next code
    line; `# tpulint: disable-file=<rule>` waives the whole file.

Relative imports are canonicalized by stripping leading dots:
`from ..utils import device_guard` binds alias `device_guard` to
"utils.device_guard", so `ctx.matches(node, ("guarded_dispatch",))`
matches `device_guard.guarded_dispatch` regardless of depth.
"""
from __future__ import annotations

import ast
import re

_WAIVER_RE = re.compile(
    r"#\s*tpulint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+)")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _parse_waivers(src: str):
    """-> (file_rules, {lineno: rules}). A waiver on a standalone
    comment line covers the next non-blank, non-comment line too."""
    file_rules: set = set()
    line_rules: dict = {}
    lines = src.splitlines()
    for i, text in enumerate(lines, start=1):
        m = _WAIVER_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        if m.group(1) == "disable-file":
            file_rules |= rules
            continue
        line_rules.setdefault(i, set()).update(rules)
        if text.lstrip().startswith("#"):
            j = i
            while j < len(lines):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    line_rules.setdefault(j + 1, set()).update(rules)
                    break
                j += 1
    return file_rules, line_rules


class FileContext:
    def __init__(self, path: str, relpath: str, src: str,
                 tree: ast.Module):
        self.path = path
        self.relpath = relpath.replace("\\", "/")
        self.src = src
        self.tree = tree
        self.is_init = relpath.endswith("__init__.py")
        self.file_waivers, self.line_waivers = _parse_waivers(src)
        self.noqa_lines = {
            i for i, t in enumerate(src.splitlines(), start=1)
            if "# noqa" in t or "#noqa" in t}

        self.parents: dict = {}
        self.calls: list = []
        self.functions: list = []      # FunctionDef/AsyncFunctionDef
        self.lambdas: list = []
        self.assigns: list = []        # every Assign/AugAssign/AnnAssign
        self.module_assigns: dict = {} # name -> value node (module level)
        self.imports: dict = {}        # alias -> canonical dotted path
        self.import_nodes: list = []   # (alias, dotted, node)
        self.scope_stmts: list = []    # Global/Nonlocal nodes
        self.raises: list = []
        self.withs: list = []
        self.deletes: list = []
        self._locals_cache: dict = {}
        self._qualname_cache: dict = {}
        self._walk()

    # ---- the single walk ----------------------------------------------

    def _walk(self):
        stack = [self.tree]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                stack.append(child)
            if isinstance(node, ast.Call):
                self.calls.append(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(node)
            elif isinstance(node, ast.Lambda):
                self.lambdas.append(node)
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)):
                self.assigns.append(node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    dotted = a.name if a.asname else a.name.split(".")[0]
                    self.imports[alias] = dotted
                    self.import_nodes.append((alias, dotted, node))
            elif isinstance(node, ast.ImportFrom):
                mod = (node.module or "")
                for a in node.names:
                    if a.name == "*":
                        continue
                    alias = a.asname or a.name
                    dotted = f"{mod}.{a.name}" if mod else a.name
                    self.imports[alias] = dotted
                    self.import_nodes.append((alias, dotted, node))
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                self.scope_stmts.append(node)
            elif isinstance(node, ast.Raise):
                self.raises.append(node)
            elif isinstance(node, ast.With):
                self.withs.append(node)
            elif isinstance(node, ast.Delete):
                self.deletes.append(node)
        # module-level assignments (direct children of Module)
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.module_assigns[t.id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                    and isinstance(stmt.target, ast.Name):
                self.module_assigns[stmt.target.id] = stmt.value

    # ---- ancestry ------------------------------------------------------

    def parent(self, node):
        return self.parents.get(node)

    def ancestors(self, node):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node):
        for anc in self.ancestors(node):
            if isinstance(anc, _FUNC_NODES):
                return anc
        return None

    def qualname(self, node) -> str:
        fn = node if isinstance(node, _FUNC_NODES) \
            else self.enclosing_function(node)
        if fn is None:
            return "<module>"
        if fn in self._qualname_cache:
            return self._qualname_cache[fn]
        parts = []
        cur = fn
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            elif isinstance(cur, ast.ClassDef):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        q = ".".join(reversed(parts)) or "<module>"
        self._qualname_cache[fn] = q
        return q

    # ---- alias-resolved dotted names -----------------------------------

    def dotted(self, node):
        """Name/Attribute chain -> resolved dotted string, else None.
        The root name goes through the import alias table; a leading
        relative-import path is canonical (dots stripped)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.imports.get(node.id, node.id))
        return ".".join(reversed(parts))

    def matches(self, node, suffixes) -> bool:
        """True when node's resolved dotted name equals or ends with one
        of the given dotted suffixes (component-aligned)."""
        d = self.dotted(node)
        if d is None:
            return False
        for s in suffixes:
            if d == s or d.endswith("." + s):
                return True
        return False

    # ---- scopes --------------------------------------------------------

    def local_names(self, fn) -> set:
        """Names bound in fn's own scope: params, assignment/for/with
        targets, local imports, nested def/class names. Nested function
        BODIES are excluded (they are their own scope)."""
        cached = self._locals_cache.get(fn)
        if cached is not None:
            return cached
        names: set = set()
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_NODES):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    names.add(node.name)
                continue                # nested scope: name only
            if isinstance(node, ast.ClassDef):
                names.add(node.name)
                continue
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    names.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                for n in node.names:
                    names.discard(n)
            stack.extend(ast.iter_child_nodes(node))
        self._locals_cache[fn] = names
        return names

    @staticmethod
    def root_name(node):
        """Root Name of a Name/Attribute/Subscript chain, else None."""
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    # ---- waivers -------------------------------------------------------

    def waived(self, finding) -> bool:
        if finding.rule in self.file_waivers:
            return True
        rules = self.line_waivers.get(finding.line)
        return bool(rules and finding.rule in rules)
