"""host-sync-in-device-path: fragment results in the device path reach
the host through the fetch seam, never through a tensor's own host
reads.

The port's contract (utils/fetch.py, copr/dag_exec.py run_fragment): a
statement waits on the card once per fragment, in one pinned
non-blocking fetch of its whole result tree (`prefetch`), read through
`host_array` / `host_scalar` / `host_int`. Every `.item()`, `.tolist()`,
`.cpu()`, `.numpy()`, `.to("cpu")`, `int(t)` / `float(t)` / `bool(t)`
or bare `np.asarray(t)` on a CUDA tensor is a wait of its own, often
one that `torch.cuda.set_sync_debug_mode("error")` does not see (a
copy to pageable memory, a read of a pinned copy) and that shows only
in the counted `syncs` of a card run. This rule finds such sites before
a card run does.

Detection is taint-based, so host-side numpy stays unflagged:

  * SOURCES — values returned by `run_fragment(...)` and `prefetch(...)`
    and by calls to kernel callables: names bound from
    `<anything>._kernel_cache.put(...)` / `.kernel_cache.put(...)`
    (also as the right side of `kc.get(key) or kc.put(key, ...)`),
    `phase.timed_kernel(...)`, a builder (`build_*_kernel`,
    `_build_*`, `_make_pipeline_body`), and calls of the scan kernels'
    wrappers (`ops/scan_kernels`: masked_sums, dense_group_sums,
    range_filter_sums).
  * PROPAGATION — assignment, tuple unpack, subscript/attribute reads
    of a tainted name (res["states"], res.keys) stay tainted, as do
    method calls on a tainted root. Rebinding a name to any OTHER call
    result (a host helper) clears its taint. Analysis is
    flow-insensitive per function: the LAST binding of a name decides
    its taint for the whole body.
  * SINKS (flagged) — `.item()` / `.tolist()` / `.cpu()` / `.numpy()`
    / `.to("cpu")` on a tainted root, `int()` / `float()` / `bool()` on
    a tainted expression, `numpy.asarray` / `numpy.array` on a tainted
    root, and `torch.cuda.synchronize()` anywhere in a scoped file.
  * SEAM — `host_array` / `host_scalar` / `host_int` consume taint;
    their results are host data.

Scope: files under `tidb_tpu_torch/copr/` and `tidb_tpu_torch/mpp/`
(the fragment and mesh paths: a wait there serializes every shard of a
mesh statement) and `tidb_tpu_torch/vector/` and `tidb_tpu_torch/ml/`.
As in the reference, copr/ and mpp/ take no baseline entry for this
rule: a finding there is repaired, or waived inline with the reason it
is no wait on a warm statement. The seam module itself lives in utils/
and is out of scope by construction.
"""
from __future__ import annotations

import ast

from ..core import Rule, register_rule

PKG = "tidb_tpu_torch/"
SCOPE_PREFIXES = tuple(PKG + d + "/" for d in ("copr", "mpp", "vector",
                                                "ml"))

PREFETCH = ("prefetch", "fetch.prefetch", "utils.fetch.prefetch")
RUN_FRAGMENT = ("run_fragment", "dag_exec.run_fragment")
SEAM = ("host_array", "host_scalar", "host_int",
        "fetch.host_array", "fetch.host_scalar", "fetch.host_int")
# calls whose result is a kernel callable
KERNEL_MAKERS = ("phase.timed_kernel", "timed_kernel")
# the scan kernels' wrappers (a call launches the kernel)
SCAN_KERNELS = ("masked_sums", "dense_group_sums", "range_filter_sums")
SCAN_MODULES = ("scan_kernels", "ops.scan_kernels", "sk")
HOST_NUMPY = ("numpy.asarray", "numpy.array")
SCALAR_BUILTINS = {"int", "float", "bool"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNC = ("torch.cuda.synchronize", "cuda.synchronize")


def _root_name(node):
    """Expression -> its root ast.Name id (through Subscript/Attribute/
    Call-on-attribute chains), else None."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def _leaf(node):
    """The last component of a Name/Attribute callee, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def is_builder_name(name) -> bool:
    """A fragment builder by the port's naming: build_*_kernel,
    _build_*, _make_pipeline_body."""
    return bool(name) and (
        (name.startswith("build_") and name.endswith("_kernel"))
        or name.startswith("_build_") or name == "_make_pipeline_body")


def _is_kcache_put(call) -> bool:
    """`<recv>._kernel_cache.put(...)` / `<recv>.kernel_cache.put(...)`
    / `kc.put(...)` where kc names a kernel cache: the memoized-kernel
    seam — its return value is a kernel callable."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "put"):
        return False
    v = f.value
    if isinstance(v, ast.Attribute):
        return v.attr in ("_kernel_cache", "kernel_cache")
    return isinstance(v, ast.Name) and v.id in ("kc", "kcache")


def is_kernel_maker(ctx, v) -> bool:
    """Does expression v evaluate to a kernel callable?"""
    if isinstance(v, ast.BoolOp):
        return any(is_kernel_maker(ctx, x) for x in v.values)
    if not isinstance(v, ast.Call):
        return False
    if ctx.matches(v.func, KERNEL_MAKERS) or _is_kcache_put(v):
        return True
    return is_builder_name(_leaf(v.func))


def is_scan_kernel_call(ctx, call) -> bool:
    """A call of an ops/scan_kernels wrapper (bare, when imported by
    name from that module, or through the module)."""
    f = call.func
    if isinstance(f, ast.Name):
        d = ctx.imports.get(f.id, "")
        return f.id in SCAN_KERNELS and "scan_kernels" in d
    if isinstance(f, ast.Attribute) and f.attr in SCAN_KERNELS:
        d = ctx.dotted(f.value) or ""
        return d.split(".")[-1] in SCAN_MODULES or \
            d.endswith("scan_kernels")
    return False


@register_rule
class HostSyncInDevicePath(Rule):
    name = "host-sync-in-device-path"
    severity = "error"
    doc = ("blocking device->host read (.item / .tolist / .cpu / "
           ".numpy / .to('cpu') / scalar dunder / bare np.asarray / "
           "torch.cuda.synchronize) on a fragment result in the device "
           "path; use the utils.fetch seam")

    def run(self, ctx):
        if not ctx.relpath.startswith(SCOPE_PREFIXES):
            return
        for call in ctx.calls:
            if ctx.matches(call.func, SYNC):
                yield self.finding(
                    ctx, call,
                    "torch.cuda.synchronize in the device path: the "
                    "statement's one wait is the fetch seam's "
                    "(utils.fetch prefetch + host_array)",
                    detail=f"hostsync:synchronize:{ctx.qualname(call)}")
        for fn in ctx.functions:
            yield from self._check_fn(ctx, fn)

    # ---- taint computation ---------------------------------------------

    def _source_call(self, ctx, v, kernels) -> bool:
        if ctx.matches(v.func, PREFETCH + RUN_FRAGMENT):
            return True
        if is_scan_kernel_call(ctx, v):
            return True
        return isinstance(v.func, ast.Name) and v.func.id in kernels

    def _tainted_names(self, ctx, fn):
        """(tainted names, kernel-callable names) in fn's body.
        Fixed-point over the function's assignments: sources taint,
        propagation keeps taint, a seam call or any other call result
        clears it."""
        kernels = set()          # names bound to kernel callables
        tainted = set()
        body = fn.body if isinstance(fn.body, list) else [fn.body]

        def expr_tainted(v) -> bool:
            if isinstance(v, ast.Call):
                if ctx.matches(v.func, SEAM):
                    return False          # seam output is host data
                if self._source_call(ctx, v, kernels):
                    return True
                root = _root_name(v.func)
                if isinstance(v.func, ast.Attribute) and root in tainted:
                    return True           # method on a kernel result
                return False
            if isinstance(v, (ast.Subscript, ast.Attribute)):
                return _root_name(v) in tainted
            if isinstance(v, ast.Name):
                return v.id in tainted
            if isinstance(v, (ast.Tuple, ast.List)):
                return any(expr_tainted(e) for e in v.elts)
            return False

        for _ in range(3):                # tiny fixed point
            changed = False
            for node in ast.walk(ast.Module(body=body,
                                            type_ignores=[])):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                is_kernel = is_kernel_maker(ctx, v)
                is_taint = not is_kernel and expr_tainted(v)
                # rebinding to any other call result (a host helper,
                # the seam) clears taint — the LAST binding wins, so a
                # name recycled for host data can't keep flagging
                is_clear = (isinstance(v, ast.Call)
                            and not is_kernel and not is_taint)
                for t in node.targets:
                    names = [t] if not isinstance(t, (ast.Tuple,
                                                      ast.List)) \
                        else list(t.elts)
                    for el in names:
                        if not isinstance(el, ast.Name):
                            continue
                        if is_kernel and el.id not in kernels:
                            kernels.add(el.id)
                            changed = True
                        elif is_taint and el.id not in tainted:
                            tainted.add(el.id)
                            changed = True
                        elif is_clear and el.id in tainted:
                            tainted.discard(el.id)
                            changed = True
            if not changed:
                break
        return tainted, kernels

    # ---- sinks ---------------------------------------------------------

    def _check_fn(self, ctx, fn):
        tainted, kernels = self._tainted_names(ctx, fn)

        def is_device_expr(v) -> bool:
            if isinstance(v, ast.Call):
                return self._source_call(ctx, v, kernels)
            root = _root_name(v)
            return root is not None and root in tainted

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for node in ast.walk(ast.Module(body=body, type_ignores=[])):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and is_device_expr(f.value):
                host_to = f.attr == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in list(node.args) + [k.value for k in
                                                node.keywords])
                if f.attr in SYNC_METHODS or host_to:
                    what = "to('cpu')" if host_to else f.attr + "()"
                    yield self.finding(
                        ctx, node,
                        f".{what} on a fragment result is a blocking "
                        "read of the card: use the utils.fetch seam "
                        "(prefetch + host_array)",
                        detail=f"hostsync:{f.attr}:{ctx.qualname(node)}:"
                               f"{_root_name(f.value)}")
                    continue
            arg = node.args[0] if node.args else None
            if arg is None:
                continue
            if isinstance(f, ast.Name) and f.id in SCALAR_BUILTINS \
                    and f.id not in ctx.imports and is_device_expr(arg):
                yield self.finding(
                    ctx, node,
                    f"{f.id}() on a fragment result is a blocking "
                    "scalar read: use utils.fetch.host_int/"
                    "host_scalar after prefetch()",
                    detail=f"hostsync:{f.id}:{ctx.qualname(node)}:"
                           f"{_root_name(arg)}")
                continue
            if ctx.matches(f, HOST_NUMPY) and is_device_expr(arg):
                yield self.finding(
                    ctx, node,
                    "bare np.asarray on a fragment result: use "
                    "utils.fetch.host_array (the designated seam) "
                    "so the copy is accounted and prefetch-overlapped",
                    detail=f"hostsync:asarray:{ctx.qualname(node)}:"
                           f"{_root_name(arg)}")
