"""unused-import: the F401 sweep of the gate.

Unused imports in this codebase are not just noise: importing torch's
heavier submodules (or anything that transitively imports them) pays
their start-up cost in every worker process, and a stale
`from ..errors import X` hides the
moment X leaves the catalog. Conservative by design:

  * `__init__.py` files are skipped wholesale (re-export surface);
  * lines carrying `# noqa` are skipped (the `from ..utils import
    torchcfg  # noqa: F401` import-for-side-effect idiom);
  * names in `__all__`, and `from __future__ import …`, are exempt;
  * usage counts Name loads anywhere, including decorators, type
    annotations, and nested scopes.
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule


@register_rule
class UnusedImport(Rule):
    name = "unused-import"
    severity = "warning"
    doc = "imported name is never referenced"

    def run(self, ctx):
        if ctx.is_init:
            return
        used: set = set()
        exported: set = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load):
                used.add(node.id)
        # string annotations (`x: "Changefeed"`, Optional["Session"])
        # reference names without an ast.Name Load — an import (often
        # under `if TYPE_CHECKING:`) consumed ONLY there is still used
        used |= self._string_annotation_names(ctx.tree)
        all_node = ctx.module_assigns.get("__all__")
        if isinstance(all_node, (ast.List, ast.Tuple)):
            for e in all_node.elts:
                if isinstance(e, ast.Constant) and \
                        isinstance(e.value, str):
                    exported.add(e.value)
        for alias, dotted, node in ctx.import_nodes:
            if dotted.startswith("__future__"):
                continue
            if getattr(node, "lineno", 0) in ctx.noqa_lines:
                continue
            root = alias.split(".")[0]
            if root in used or root in exported:
                continue
            # only module-level and function-level imports of THIS
            # file's scope; conditional (try/except ImportError)
            # imports often exist purely to probe availability
            if self._in_try(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                f"'{alias}' imported but unused (gate runs the "
                f"compileall + F401 sweep; delete it or mark the "
                f"side-effect import with # noqa)",
                detail=f"import:{alias}")

    @staticmethod
    def _string_annotation_names(tree) -> set:
        """Identifiers referenced from string annotations: every str
        Constant inside an annotation expression is parsed as an
        expression and its Name/Attribute roots collected. Unparsable
        strings (a Literal["a", "b"] member) contribute nothing."""
        names: set = set()
        anns = []
        for node in ast.walk(tree):
            if isinstance(node, ast.AnnAssign) and node.annotation:
                anns.append(node.annotation)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                if node.returns:
                    anns.append(node.returns)
                a = node.args
                for arg in (a.posonlyargs + a.args + a.kwonlyargs
                            + [a.vararg, a.kwarg]):
                    if arg is not None and arg.annotation:
                        anns.append(arg.annotation)
        for ann in anns:
            for sub in ast.walk(ann):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str):
                    try:
                        expr = ast.parse(sub.value, mode="eval")
                    except SyntaxError:
                        continue
                    for n in ast.walk(expr):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
        return names

    @staticmethod
    def _in_try(ctx, node):
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.Try):
                return True
        return False
