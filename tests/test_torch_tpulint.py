"""The port's lint (tidb_tpu_torch/tools/tpulint): twins of
tests/test_tpulint.py, per-rule positive/negative fixtures written in
torch terms, waiver and baseline semantics, reporters, the incremental
cache, and the whole-package strict gate over tidb_tpu_torch/. ~75 s on
the CPU (six strict CLI runs over the package, 10-20 s each).

Fixtures are SOURCE SNIPPETS linted in memory (lint_source) — tpulint
never imports analyzed code, so fixtures need not be runnable.

Every test of tests/test_tpulint.py has its twin here under the same
name, but one: test_purity_host_effects_flagged. In the reference a
metrics bump, failpoint or log line inside a jax trace fires once per
compile and vanishes from steady state; a fragment body of the port
runs on every call, so such host effects are per-execution and the
rule no longer flags them. test_purity_host_effects_not_flagged holds
that instead. The device rules are redesigned for torch (their module
docs): the kernel callables are run_fragment, kernel-cache entries,
phase.timed_kernel, the builders and the scan kernel wrappers; the
host-sync sinks add .cpu(), .numpy(), .to("cpu") and
torch.cuda.synchronize(); a fragment body is a callable handed to
run_fragment / timed_kernel / shard_map or built by a builder."""
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tidb_tpu_torch")
BASELINE = os.path.join(PKG, "tools", "tpulint", "baseline.json")
sys.path.insert(0, REPO)

from tidb_tpu_torch.tools.tpulint import (          # noqa: E402
    Baseline, LintConfig, lint_paths, lint_source)
from tidb_tpu_torch.tools.tpulint.reporters import (  # noqa: E402
    report_json, report_text)


def run_lint(src, rules=None, **cfg_kw):
    config = LintConfig(root=REPO, enabled=rules, **cfg_kw)
    return lint_source(textwrap.dedent(src), "fixture.py", config)


def rule_hits(findings, rule):
    return [f for f in findings if f.rule == rule]


def _cli(args, cwd=REPO, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = cwd
    return subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.tools.tpulint", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


# ---- unguarded-dispatch ----------------------------------------------

DISPATCH_POS = """
    def build_add_kernel():
        def kern(x):
            return x + 1
        return kern

    def run(x):
        kern = build_add_kernel()
        return kern(x)                       # naked dispatch
"""

DISPATCH_NEG = """
    from ..utils import device_guard

    def build_add_kernel():
        def kern(x):
            return x + 1
        return kern

    def run(x, ectx):
        kern = build_add_kernel()
        return device_guard.guarded_dispatch(
            lambda: kern(x), site="fixture/run", ectx=ectx)
"""


def test_dispatch_positive():
    hits = rule_hits(run_lint(DISPATCH_POS), "unguarded-dispatch")
    assert len(hits) == 1 and hits[0].context == "run"
    assert hits[0].severity == "error"


def test_dispatch_negative():
    assert not rule_hits(run_lint(DISPATCH_NEG), "unguarded-dispatch")


def test_dispatch_immediate_invocation_and_assignment():
    src = """
        from ..copr.dag_exec import run_fragment
        from ..utils import phase
        def a(kern, x):
            return run_fragment(kern, x)     # the fragment seam
        def b(copr, key, fn, x):
            k = copr._kernel_cache.put(key, fn)
            return k(x)                      # via assignment alias
        def c(fn, x):
            t = phase.timed_kernel("fused", fn)
            return t(x)
    """
    hits = rule_hits(run_lint(src), "unguarded-dispatch")
    assert len(hits) == 3
    assert {h.context for h in hits} == {"a", "b", "c"}


def test_dispatch_builder_taint():
    # `kc.get(key) or kc.put(key, ...)` binds a kernel callable, as a
    # builder's result does
    src = """
        def make():
            def kern(x):
                return x
            return kern
        def run(copr, key, x):
            kc = copr._kernel_cache
            kern = kc.get(key) or kc.put(key, make())
            return kern(x)
    """
    hits = rule_hits(run_lint(src), "unguarded-dispatch")
    assert len(hits) == 1 and hits[0].context == "run"


def test_dispatch_guarded_by_name_reference():
    # `lambda: self._run(...)` inside guarded_dispatch supervises the
    # dispatches INSIDE _run (the dag_exec idiom)
    src = """
        from ..ops import scan_kernels
        from ..utils import device_guard

        class C:
            def _run(self, cols, m):
                return scan_kernels.masked_sums(cols, m)
            def outer(self, cols, m):
                return device_guard.guarded_dispatch(
                    lambda: self._run(cols, m), site="c/run")
    """
    assert not rule_hits(run_lint(src), "unguarded-dispatch")


def test_dispatch_eager_argument_still_flagged():
    # guarded_dispatch(run_fragment(...)) evaluates BEFORE supervision
    src = """
        from ..copr.dag_exec import run_fragment
        from ..utils import device_guard

        def run(kern, x):
            return device_guard.guarded_dispatch(run_fragment(kern, x),
                                                 site="s")
    """
    assert len(rule_hits(run_lint(src), "unguarded-dispatch")) == 1


def test_dispatch_kernel_composition_not_flagged():
    src = """
        from ..ops import scan_kernels

        def _build_sum_body():
            def body(cols, mask):
                # a kernel inside a fragment body is part of its dispatch
                return scan_kernels.masked_sums(cols, mask)
            return body
    """
    assert not rule_hits(run_lint(src), "unguarded-dispatch")


def test_dispatch_data_arg_name_does_not_exempt():
    # a guarded call passing `kern` as DATA must not exempt a function
    # named `put` elsewhere in the file (only call-position names and
    # bare callable references in fn/host_fallback are supervised)
    src = """
        from ..ops.scan_kernels import masked_sums
        from ..utils import device_guard

        def other(cache, key, kern):
            return device_guard.guarded_dispatch(
                lambda: cache.put(key, kern), site="s")

        def put(cols, m):
            return masked_sums(cols, m)      # NOT supervised anywhere
    """
    hits = rule_hits(run_lint(src), "unguarded-dispatch")
    assert len(hits) == 1 and hits[0].context == "put"


def test_dispatch_bare_callable_and_host_fallback_references():
    src = """
        from ..ops import scan_kernels as sk
        from ..utils import device_guard

        def primary(cols, m):
            return sk.masked_sums(cols, m)

        def twin(cols, m):
            return sk.dense_group_sums(cols, m, 4, m)

        def run(cols, m):
            return device_guard.guarded_dispatch(
                primary, site="s", host_fallback=twin)
    """
    assert not rule_hits(run_lint(src), "unguarded-dispatch")


def test_dispatch_guard_wrapper_supervises():
    """A function handing its callable parameter to guarded_dispatch (the
    vector runtime's `guarded`) supervises what it is handed, in its
    own file and imported from vector/ivf."""
    src = """
        from ..copr.dag_exec import run_fragment
        from ..utils import device_guard
        from .ivf import guarded

        def local_guard(copr, fn, site):
            return device_guard.guarded_dispatch(fn, site=site)

        def search(copr, kern, x):
            def dev():
                return run_fragment(kern, x)
            return guarded(copr, dev, "vector/topk", None, None, None)

        def train(copr, kern, x):
            def dev():
                return run_fragment(kern, x)
            return local_guard(copr, dev, "vector/train")

        def naked(kern, x):
            return run_fragment(kern, x)
    """
    hits = rule_hits(run_lint(src), "unguarded-dispatch")
    assert [h.context for h in hits] == ["naked"]


# ---- jit-purity (fragment bodies) --------------------------------------

def test_purity_host_effects_not_flagged():
    """Host effects run on every call of a port fragment body: a
    counter there counts executions, so they are not findings."""
    src = """
        from ..utils import failpoint, phase
        from ..utils import metrics as _metrics

        def _build_body():
            def body(x):
                failpoint.inject("site")
                _metrics.FOO.labels("a").inc()
                phase.inc("rows")
                return x
            return body
    """
    assert not rule_hits(run_lint(src), "jit-purity")


def test_purity_host_sync_flagged():
    src = """
        import numpy as np
        import torch
        from ..copr.dag_exec import run_fragment

        def body(x, n):
            y = np.asarray(x)                # host materialization
            z = float(x)                     # scalar read
            torch.cuda.synchronize()         # a wait on the card
            return y, z, x.item(), x.cpu(), x.numpy(), x.to("cpu")

        def run(x, n):
            return run_fragment(body, x, n)
    """
    hits = rule_hits(run_lint(src), "jit-purity")
    assert len(hits) == 7, [h.detail for h in hits]
    assert all(h.context == "body" for h in hits)


def test_purity_scope_and_closure_mutation():
    src = """
        STATE = {}

        def build_count_kernel():
            def kern(x):
                global STATE
                STATE["k"] = 1
                return x
            return kern
    """
    hits = rule_hits(run_lint(src), "jit-purity")
    kinds = {h.detail.split(":")[1] for h in hits}
    assert "scope" in kinds and "mutate" in kinds


def test_purity_clean_kernel_and_shard_map():
    src = """
        import torch
        from ..parallel.mesh import psum, shard_map

        def launch(mesh, a, b):
            def body_for(dev):
                def body(x, y):
                    local = {}
                    local["s"] = torch.sum(torch.as_tensor(x))
                    return local["s"] + y
                return body
            return shard_map(mesh, body_for, lambda outs: psum(outs, mesh))
    """
    assert not rule_hits(run_lint(src), "jit-purity")


def test_purity_shard_map_target_checked():
    src = """
        from ..parallel.mesh import shard_map

        def launch(mesh, a):
            def body_for(dev):
                def frag(x):
                    return x.sum().item()
                return frag
            return shard_map(mesh, body_for, lambda outs: outs)
    """
    hits = rule_hits(run_lint(src), "jit-purity")
    assert len(hits) == 1 and hits[0].context == "launch.body_for.frag"


def test_purity_body_reached_through_a_call_in_body_for():
    """body_for returning `_reader_fragment(...)` (dag_exec's idiom): the
    def that call returns is the body."""
    src = """
        from ..parallel.mesh import shard_map

        def _reader_fragment(filters):
            def body(cols, valid):
                return valid.sum().item()
            return body

        def launch(mesh, filters):
            def body_for(dev):
                return _reader_fragment(filters)
            return shard_map(mesh, body_for, lambda outs: outs)
    """
    hits = rule_hits(run_lint(src), "jit-purity")
    assert len(hits) == 1 and hits[0].context == "_reader_fragment.body"


def test_purity_timed_kernel_and_merge_checked():
    src = """
        from ..parallel.mesh import shard_map
        from ..utils import phase

        def body(x):
            return int(x)

        def run(fn, mesh):
            t = phase.timed_kernel("k", body)
            return shard_map(mesh, lambda d: fn, lambda outs: outs[0].tolist())
    """
    hits = rule_hits(run_lint(src), "jit-purity")
    assert sorted(h.detail.split(":")[-1] for h in hits) == ["int",
                                                            "tolist"]


# ---- shared-state-race ------------------------------------------------

def test_race_unlocked_mutation_flagged():
    src = """
        _CACHE = {}

        def put(k, v):
            _CACHE[k] = v
    """
    hits = rule_hits(run_lint(src), "shared-state-race")
    assert len(hits) == 1 and "_CACHE" in hits[0].message


def test_race_locked_mutation_passes():
    src = """
        import threading
        _CACHE = {}
        _MU = threading.Lock()

        def put(k, v):
            with _MU:
                _CACHE[k] = v
    """
    assert not rule_hits(run_lint(src), "shared-state-race")


def test_race_threading_local_exempt():
    src = """
        import threading
        _TLS = threading.local()

        def put(v):
            _TLS.stats = v
    """
    assert not rule_hits(run_lint(src), "shared-state-race")


def test_race_import_time_mutation_exempt():
    src = """
        _REG = {}
        _REG["a"] = 1                        # module level: fine
    """
    assert not rule_hits(run_lint(src), "shared-state-race")


def test_race_method_mutations_flagged():
    src = """
        _SEEN = set()
        _ORDER = []

        def note(x):
            _SEEN.add(x)
            _ORDER.append(x)
    """
    assert len(rule_hits(run_lint(src), "shared-state-race")) == 2


def test_race_chained_receiver_mutation_flagged():
    src = """
        _QUEUES = {}

        def push(name, x):
            _QUEUES[name].append(x)
    """
    assert len(rule_hits(run_lint(src), "shared-state-race")) == 1


# ---- metrics-hygiene --------------------------------------------------

def test_hygiene_missing_help_and_dynamic_labels():
    src = """
        REGISTRY = object()

        C1 = REGISTRY.counter("tidb_tpu_good_total", "documented", ("a",))
        C2 = REGISTRY.counter("tidb_tpu_bad_total")
        C3 = REGISTRY.counter("tidb_tpu_worse_total", "", ("a",))

        def bump(site, err):
            C1.labels(site, err).inc()               # fine
            C1.labels(f"{site}/x", err).inc()        # f-string
            C1.labels(str(err)).inc()                # str()
    """
    hits = rule_hits(run_lint(src), "metrics-hygiene")
    details = sorted(h.detail for h in hits)
    assert any("help:tidb_tpu_bad_total" in d for d in details)
    assert any("help:tidb_tpu_worse_total" in d for d in details)
    assert sum("labelvalue" in d for d in details) == 2


def test_hygiene_nonliteral_labelnames():
    src = """
        REGISTRY = object()
        NAMES = ("a", "b")
        C = REGISTRY.histogram("tidb_tpu_h_seconds", "help text", NAMES)
    """
    hits = rule_hits(run_lint(src), "metrics-hygiene")
    assert any("labelnames" in h.detail for h in hits)


def test_hygiene_span_name_must_be_literal():
    src = """
        from ..utils import tracing as _tracing

        def work(tracer, op, widget):
            with _tracing.span(f"op_{op}"):          # f-string name
                pass
            with tracer.span("worker_" + op):        # concatenation
                pass
            with tracer.span("worker_op", op=op):    # fine: attr varies
                pass
            with widget.span(op):                    # not tracer-like
                pass
    """
    hits = rule_hits(run_lint(src), "metrics-hygiene")
    assert len([h for h in hits if "spanname" in h.detail]) == 2, hits


def test_hygiene_bare_span_helper_checked():
    src = """
        from ..utils.tracing import span

        def work(name):
            with span(name):                         # computed name
                pass
            with span("wal_group_commit", role="x"):  # fine
                pass
    """
    hits = rule_hits(run_lint(src), "metrics-hygiene")
    assert sum("spanname" in h.detail for h in hits) == 1


# ---- error-code-validity ---------------------------------------------

ERRCAT = {"TiDBError", "DuplicateKeyError", "ParseError", "catalog"}
SYSVARS = {"tidb_enable_tpu_exec", "max_execution_time"}


def test_codes_unknown_error_attr():
    src = """
        from .. import errors

        def boom():
            raise errors.DupKeyError("x")    # typo: DuplicateKeyError
    """
    hits = rule_hits(run_lint(src, known_errors=ERRCAT),
                     "error-code-validity")
    assert len(hits) == 1 and "DupKeyError" in hits[0].message


def test_codes_known_error_attr_passes():
    src = """
        from .. import errors

        def boom():
            raise errors.DuplicateKeyError("x")
    """
    assert not rule_hits(run_lint(src, known_errors=ERRCAT),
                         "error-code-validity")


def test_codes_stale_from_import():
    src = "from ..errors import DuplicateKeyError, NotARealError\n"
    hits = rule_hits(run_lint(src, known_errors=ERRCAT),
                     "error-code-validity")
    assert len(hits) == 1 and "NotARealError" in hits[0].message


def test_codes_unknown_sysvar():
    src = """
        def knobs(sv):
            a = sv.get("tidb_enable_tpu_exec")       # registered
            b = sv.get("tidb_tpu_no_such_knob")      # not registered
            c = sv.get(compute_name())               # non-literal: skip
            d = {"tidb_fake": 1}.get("tidb_fake")    # not a sv receiver
            return a, b, c, d
    """
    hits = rule_hits(run_lint(src, known_sysvars=SYSVARS),
                     "error-code-validity")
    assert len(hits) == 1 and "tidb_tpu_no_such_knob" in hits[0].message


# ---- failpoint-site-registry -----------------------------------------

FPSITES = {"cdc-poll", "2pc-prewrite-done"}

FP_SRC = """
    from ..utils import failpoint

    def seams():
        failpoint.inject("cdc-poll")             # registered
        failpoint.inject("totally-new-seam")     # NOT registered
        failpoint.inject(dynamic_name())         # non-literal: skip
"""


def _lint_at(src, relpath, **cfg_kw):
    config = LintConfig(root=REPO, enabled=None, **cfg_kw)
    return lint_source(textwrap.dedent(src), relpath, config)


def test_failpoint_unregistered_site_flagged():
    hits = rule_hits(
        _lint_at(FP_SRC, "tidb_tpu_torch/storage/fixture.py",
                 known_failpoints=FPSITES),
        "failpoint-site-registry")
    assert len(hits) == 1 and "totally-new-seam" in hits[0].message


def test_failpoint_rule_scoped_to_package():
    """tests/ arm ad-hoc fixture failpoints by design — out of scope."""
    assert not rule_hits(
        _lint_at(FP_SRC, "tests/test_fixture.py",
                 known_failpoints=FPSITES),
        "failpoint-site-registry")


def test_failpoint_registry_parses_annassign():
    from tidb_tpu_torch.tools.tpulint.rules.failpoints import \
        parse_failpoint_registry
    got = parse_failpoint_registry(textwrap.dedent("""
        SITES: dict[str, str] = {"a-seam": "desc", "b-seam": "desc"}
    """))
    assert got == {"a-seam", "b-seam"}
    got2 = parse_failpoint_registry('SITES = {"c-seam": "d"}\n')
    assert got2 == {"c-seam"}


def test_failpoint_registry_covers_every_package_site():
    """The port's registry covers every inject literal in the port."""
    import re
    from tidb_tpu_torch.tools.tpulint.rules.failpoints import \
        parse_failpoint_registry
    with open(os.path.join(PKG, "utils", "failpoint_sites.py")) as f:
        known = parse_failpoint_registry(f.read())
    pat = re.compile(r'failpoint\.inject\(\s*"([^"]+)"')
    missing = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "tpulint")]
        for fn in filenames:
            if not fn.endswith(".py") or fn in ("failpoint_sites.py",
                                                "failpoint.py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                for site in pat.findall(f.read()):
                    if site not in known:
                        missing.append((fn, site))
    assert not missing, f"unregistered failpoint sites: {missing}"


def test_codes_duplicate_error_code():
    from tidb_tpu_torch.tools.tpulint.rules.codes import parse_error_catalog
    names, dups = parse_error_catalog(textwrap.dedent("""
        A = _err("A", 1062)
        B = _err("B", 1062)
        C = _err("C", 1063)
    """))
    assert {"A", "B", "C"} <= names
    assert len(dups) == 1 and dups[0][2] == 1062


# ---- unused-import ----------------------------------------------------

def test_unused_import_flagged_and_noqa_respected():
    src = """
        import os
        import sys                            # noqa: F401
        from ..utils import torchcfg  # noqa: F401
        import json

        def f():
            return json.dumps({})
    """
    hits = rule_hits(run_lint(src), "unused-import")
    assert len(hits) == 1 and "'os'" in hits[0].message


def test_unused_import_all_export_exempt():
    src = """
        from .exec import mpp_global_sum

        __all__ = ["mpp_global_sum"]
    """
    assert not rule_hits(run_lint(src), "unused-import")


# ---- host-sync-in-device-path ----------------------------------------

def run_lint_copr(src, rules=None, sub="copr", **cfg_kw):
    """Lint a fixture AS a file of the device path (the rule's scope)."""
    config = LintConfig(root=REPO, enabled=rules, **cfg_kw)
    return lint_source(textwrap.dedent(src),
                       f"tidb_tpu_torch/{sub}/fixture.py", config)


HOSTSYNC_FIXTURE = """
    import numpy as np
    import torch
    from ..ops import scan_kernels
    from ..utils.fetch import prefetch, host_array, host_int
    from .dag_exec import run_fragment

    def run_part(body, jc, vv, key, copr, cols, m):
        kc = copr._kernel_cache
        kern = kc.get(key) or kc.put(key, body)
        res = prefetch(run_fragment(kern, jc, vv))
        ngroups = int(res["ngroups"])          # scalar read
        keys = np.asarray(res["keys"])         # bare asarray
        cnt = res["cnt"].item()                # .item()
        torch.cuda.synchronize()               # a wait on the card
        direct = np.asarray(kern(jc, vv))      # asarray on dispatch
        raw = run_fragment(kern, jc, vv)
        rows = raw["rows"].tolist()            # .tolist()
        back = raw["keys"].cpu()               # .cpu()
        arr = raw["vals"].numpy()              # .numpy()
        moved = raw["vals"].to("cpu")          # .to("cpu")
        sums, count = scan_kernels.masked_sums(cols, m)
        return (ngroups, keys, cnt, direct, rows, back, arr, moved,
                bool(count))
"""


def test_hostsync_sinks_flagged_in_copr_scope():
    hits = rule_hits(run_lint_copr(HOSTSYNC_FIXTURE),
                     "host-sync-in-device-path")
    details = {h.detail.split(":")[1] for h in hits}
    assert details == {"int", "asarray", "item", "synchronize", "tolist",
                       "cpu", "numpy", "to", "bool"}
    assert len(hits) == 10                      # asarray twice


def test_hostsync_seam_and_host_data_unflagged():
    src = """
        import numpy as np
        from ..utils.fetch import prefetch, host_array, host_int
        from .dag_exec import run_fragment

        def run_part(kern, jc, vv, dag, cols, m):
            res = prefetch(run_fragment(kern, jc, vv))
            ngroups = host_int(res["ngroups"])      # seam scalar
            keys = host_array(res["keys"])          # seam bulk
            hostmask = np.asarray([1, 2, 3])        # host data
            n = int(m)                              # host scalar
            trimmed = keys[:ngroups]                # host after seam
            k2 = np.asarray(trimmed)                # host after seam
            lst = trimmed.tolist()                  # host after seam
            return ngroups, keys, hostmask, n, k2, lst
    """
    assert not rule_hits(run_lint_copr(src), "host-sync-in-device-path")


def test_hostsync_rebind_clears_taint():
    src = """
        from ..utils.fetch import prefetch, host_int
        from .dag_exec import run_fragment

        def host_rows(res):
            return list(res)

        def run_part(kern, jc, vv):
            res = prefetch(run_fragment(kern, jc, vv))
            n = host_int(res["ngroups"])            # seam use
            res = host_rows(n)                      # name recycled for
            k = int(res[0])                         # host data — clean
            return k

        def still_tainted(kern, jc, vv):
            res = run_fragment(kern, jc, vv)
            res = res.contiguous()                  # method on result
            return int(res[0])                      # stays a sync
    """
    hits = rule_hits(run_lint_copr(src), "host-sync-in-device-path")
    # only the second function's int(): a rebind to a host-helper call
    # clears taint, a method call on the tainted root keeps it
    assert len(hits) == 1
    assert "still_tainted" in hits[0].detail


def test_hostsync_out_of_scope_file_skipped():
    # same violating fixture outside the device path: not in scope
    assert not rule_hits(run_lint(HOSTSYNC_FIXTURE),
                         "host-sync-in-device-path")
    assert not rule_hits(run_lint_copr(HOSTSYNC_FIXTURE, sub="executor"),
                         "host-sync-in-device-path")


def test_hostsync_scope_covers_mpp_vector_ml():
    for sub in ("mpp", "vector", "ml"):
        assert len(rule_hits(run_lint_copr(HOSTSYNC_FIXTURE, sub=sub),
                             "host-sync-in-device-path")) == 10, sub


def test_hostsync_waiver_respected():
    src = """
        from ..utils.fetch import prefetch

        def run_part(kern, jc, vv):
            res = prefetch(kern(jc, vv))
            # tpulint: disable=host-sync-in-device-path
            return int(res["ngroups"])
    """
    # kern is a parameter, not a tracked kernel name — taint flows from
    # prefetch() only; the sink is waived by the standalone comment
    assert not rule_hits(run_lint_copr(src), "host-sync-in-device-path")


def test_hostsync_package_is_clean():
    """The port's device path itself carries zero findings, and the
    baseline holds no entry of this rule in copr/ or mpp/."""
    config = LintConfig(root=REPO,
                        enabled=["host-sync-in-device-path"])
    findings = lint_paths([os.path.join(PKG, d) for d in
                           ("copr", "mpp", "vector", "ml")], config)
    assert [f for f in findings if not f.baselined] == []
    bl = Baseline.load(BASELINE)
    assert not [e for e in bl.entries
                if e["rule"] == "host-sync-in-device-path" and
                e["file"].startswith(("tidb_tpu_torch/copr/",
                                      "tidb_tpu_torch/mpp/"))]


# ---- waiver semantics -------------------------------------------------

def test_waiver_same_line():
    src = """
        _CACHE = {}

        def put(k, v):
            _CACHE[k] = v  # tpulint: disable=shared-state-race
    """
    assert not rule_hits(run_lint(src), "shared-state-race")


def test_waiver_standalone_comment_covers_next_code_line():
    src = """
        _CACHE = {}

        def put(k, v):
            # single-threaded by construction (import-time only)
            # tpulint: disable=shared-state-race
            # (second explanatory line)
            _CACHE[k] = v
    """
    assert not rule_hits(run_lint(src), "shared-state-race")


def test_waiver_is_rule_scoped():
    src = """
        _CACHE = {}

        def put(k, v):
            _CACHE[k] = v  # tpulint: disable=unused-import
    """
    assert len(rule_hits(run_lint(src), "shared-state-race")) == 1


def test_waiver_file_level():
    src = """
        # tpulint: disable-file=shared-state-race
        _A = {}
        _B = []

        def f(x):
            _A[x] = 1
            _B.append(x)
    """
    assert not rule_hits(run_lint(src), "shared-state-race")


# ---- baseline semantics ----------------------------------------------

def test_baseline_absorbs_matching_finding_line_independent():
    findings = run_lint(DISPATCH_POS)
    f = rule_hits(findings, "unguarded-dispatch")[0]
    entry = {"rule": f.rule, "file": f.path, "context": f.context,
             "detail": f.detail, "reason": "fixture"}
    bl = Baseline(entries=[entry])
    cfg = LintConfig(root=REPO, baseline=bl)
    shifted = "\n\n\n" + textwrap.dedent(DISPATCH_POS)
    out = lint_source(shifted, "fixture.py", cfg)
    hit = rule_hits(out, "unguarded-dispatch")[0]
    assert hit.baselined and hit.reason == "fixture"
    assert not bl.stale_entries()


def test_baseline_unmatched_entry_is_stale():
    bl = Baseline(entries=[{"rule": "unguarded-dispatch",
                            "file": "fixture.py", "context": "gone",
                            "detail": "dispatch:gone"}])
    cfg = LintConfig(root=REPO, baseline=bl)
    lint_source("x = 1\n", "fixture.py", cfg)
    assert len(bl.stale_entries()) == 1


def test_baseline_write_and_load_roundtrip(tmp_path):
    findings = run_lint(DISPATCH_POS)
    path = str(tmp_path / "bl.json")
    n = Baseline.write(path, findings)
    assert n == 1
    bl = Baseline.load(path)
    cfg = LintConfig(root=REPO, baseline=bl)
    out = lint_source(textwrap.dedent(DISPATCH_POS), "fixture.py", cfg)
    assert all(f.baselined for f in out)


def test_baseline_rewrite_preserves_matched_entries(tmp_path):
    findings = run_lint(DISPATCH_POS)
    f = rule_hits(findings, "unguarded-dispatch")[0]
    kept = {"rule": f.rule, "file": f.path, "context": f.context,
            "detail": f.detail, "reason": "justified"}
    bl = Baseline(entries=[kept])
    cfg = LintConfig(root=REPO, baseline=bl)
    out = lint_source(textwrap.dedent(DISPATCH_POS), "fixture.py", cfg)
    assert all(x.baselined for x in out)
    path = str(tmp_path / "bl.json")
    n = Baseline.write(path, [x for x in out if not x.baselined],
                       keep_entries=bl.matched_entries())
    assert n == 1
    assert Baseline.load(path).entries[0]["reason"] == "justified"


def test_baseline_stale_scoped_to_run_paths():
    bl = Baseline(entries=[
        {"rule": "unguarded-dispatch", "file": "other/file.py",
         "context": "f", "detail": "dispatch:k"},
        {"rule": "unguarded-dispatch", "file": "pkg/deleted.py",
         "context": "g", "detail": "dispatch:j"}])
    cfg = LintConfig(root=REPO, baseline=bl)
    lint_source("x = 1\n", "pkg/fixture.py", cfg)
    under_pkg = lambda f: f == "pkg" or f.startswith("pkg/")  # noqa: E731
    stale = bl.stale_entries(in_scope=under_pkg)
    assert [e["file"] for e in stale] == ["pkg/deleted.py"]
    assert len(bl.stale_entries()) == 2


# ---- reporters --------------------------------------------------------

def test_reporters_text_and_json():
    findings = run_lint(DISPATCH_POS)
    buf = io.StringIO()
    report_text(findings, buf)
    assert "unguarded-dispatch" in buf.getvalue()
    assert "1 finding(s)" in buf.getvalue()
    jbuf = io.StringIO()
    report_json(findings, jbuf)
    doc = json.loads(jbuf.getvalue())
    assert doc["summary"]["new"] == 1
    assert doc["findings"][0]["rule"] == "unguarded-dispatch"
    assert doc["summary"]["by_rule"]["unguarded-dispatch"] == 1


def test_syntax_error_is_a_finding():
    out = run_lint("def broken(:\n")
    assert out and out[0].rule == "syntax-error"


# ---- the whole-package gate ------------------------------------------

def test_whole_package_zero_nonbaselined_findings():
    """tpulint over the whole tidb_tpu_torch package, with the port's
    baseline, reports ZERO new findings; every baseline entry carries
    its reason, and none is stale."""
    bl = Baseline.load(BASELINE)
    assert all(e.get("reason") and "TODO" not in e["reason"]
               for e in bl.entries)
    cfg = LintConfig.for_package(PKG, root=REPO, baseline=bl)
    findings = lint_paths([PKG], cfg)
    new = [f for f in findings if not f.baselined]
    assert new == [], "\n".join(
        f"{f.path}:{f.line} [{f.rule}] {f.message}" for f in new)
    assert not bl.stale_entries()


def test_package_catalogs_parsed():
    cfg = LintConfig.for_package(PKG, root=REPO)
    assert "DuplicateKeyError" in cfg.known_errors
    assert "tidb_tpu_device_retry_limit" in cfg.known_sysvars
    assert not cfg.error_dups, "duplicate error codes in errors.py"
    assert cfg.known_failpoints and cfg.lock_ranks


def _package_copy(tmp_path):
    """A copy of the port's package to inject into (the repo's own tree
    is never written)."""
    root = tmp_path / "repo"
    shutil.copytree(PKG, root / "tidb_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return root


def test_strict_cli_catches_injected_violation(tmp_path):
    """`python -m tidb_tpu_torch.tools.tpulint --strict` exits 0 on the
    package and nonzero once a violation lands inside it."""
    root = _package_copy(tmp_path)
    r = _cli(["--strict", "--no-compile"], cwd=str(root))
    assert r.returncode == 0, r.stdout + r.stderr
    with open(root / "tidb_tpu_torch" / "_tpulint_fixture_inj.py",
              "w") as f:
        f.write(textwrap.dedent(DISPATCH_POS))
    r = _cli(["--strict", "--no-compile"], cwd=str(root))
    assert r.returncode != 0, r.stdout + r.stderr
    assert "unguarded-dispatch" in r.stdout


def test_strict_cli_catches_injected_item_in_copr(tmp_path):
    """An `.item()` on a fragment result in copr/ fails the strict run
    (host-sync-in-device-path takes no baseline there)."""
    root = _package_copy(tmp_path)
    path = root / "tidb_tpu_torch" / "copr" / "dag_exec.py"
    src = path.read_text()
    anchor = "        res = run_fragment(kern, jc, vv)\n"
    assert src.count(anchor) == 1
    path.write_text(src.replace(
        anchor, anchor + "        _n = res['present'].item()\n"))
    r = _cli(["--strict", "--no-compile", "--json"], cwd=str(root))
    assert r.returncode != 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    hits = [f for f in doc["findings"]
            if f["rule"] == "host-sync-in-device-path"]
    assert len(hits) == 1 and hits[0]["path"] == \
        "tidb_tpu_torch/copr/dag_exec.py"
    assert hits[0]["context"] == "CoprExecutor._try_execute_mpp"


def test_strict_cli_rules_subset_ignores_other_rules_baseline(tmp_path):
    """`--rules <subset> --strict` must not report baseline rows of
    DISABLED rules as stale — the spot run never re-checked them."""
    bl = str(tmp_path / "bl.json")
    with open(bl, "w") as f:
        json.dump({"version": 1, "entries": [{
            "rule": "unguarded-dispatch", "file": "tidb_tpu_torch/x.py",
            "context": "f", "detail": "dispatch:k",
            "reason": "r"}]}, f)
    r = _cli(["--strict", "--no-compile", "--baseline", bl,
              "--rules", "jit-purity"])
    assert r.returncode == 0, r.stdout + r.stderr
    # the full run DOES treat that row as stale (file gone)
    r = _cli(["--strict", "--no-compile", "--baseline", bl])
    assert r.returncode != 0 and "stale" in r.stdout


def test_strict_cli_clean_tree_exits_zero():
    """The gate itself: the strict run over the port, its compile sweep
    included, exits 0."""
    r = _cli(["--strict"], timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout


def test_clear_cache_needs_cache_dir(tmp_path):
    """There is no default cache directory: --clear-cache alone is a
    usage error; with --cache-dir it empties that directory."""
    r = _cli(["--clear-cache"])
    assert r.returncode == 2 and "--cache-dir" in r.stderr, r.stderr
    cachedir = tmp_path / "c"
    r = _cli(["--no-compile", "--cache-dir", str(cachedir),
              os.path.join(REPO, "tidb_tpu_torch", "utils", "fetch.py")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert list(cachedir.rglob("*.json"))
    r = _cli(["--clear-cache", "--cache-dir", str(cachedir)])
    assert r.returncode == 0 and "cleared" in r.stdout, r.stdout
    assert not list(cachedir.rglob("*.json"))


# ---- lock-order (program rule) ---------------------------------------

from tidb_tpu_torch.tools.tpulint import lint_sources  # noqa: E402

CYCLE_A = """
import threading
from fixpkg import b

MU_A = threading.Lock()


def grab_a():
    with MU_A:
        pass


def path_ab():
    with MU_A:
        b.grab_b()
"""

CYCLE_B = """
import threading
from fixpkg import a

MU_B = threading.Lock()


def grab_b():
    with MU_B:
        pass


def path_ba():
    with MU_B:
        a.grab_a()
"""


def run_lint_program(sources, rules, **cfg_kw):
    config = LintConfig(root=REPO, enabled=set(rules), **cfg_kw)
    return lint_sources(
        {rel: textwrap.dedent(src) for rel, src in sources.items()},
        config)


def test_lock_order_two_lock_cycle_via_call_edge():
    fs = run_lint_program(
        {"fixpkg/a.py": CYCLE_A, "fixpkg/b.py": CYCLE_B},
        rules={"lock-order"})
    hits = rule_hits(fs, "lock-order")
    assert len(hits) == 1, [f.message for f in fs]
    f = hits[0]
    assert f.detail.startswith("cycle:")
    assert "MU_A" in f.message and "MU_B" in f.message
    assert "fixpkg/a.py" in f.message and "fixpkg/b.py" in f.message


def test_lock_order_cycle_waived_with_external_ordering_comment():
    a_waived = CYCLE_A.replace(
        "        b.grab_b()",
        "        # tpulint: disable=lock-order — external ordering:\n"
        "        # path_ab only runs in the bootstrap thread, before\n"
        "        # path_ba's worker pool exists\n"
        "        b.grab_b()")
    fs = run_lint_program(
        {"fixpkg/a.py": a_waived, "fixpkg/b.py": CYCLE_B},
        rules={"lock-order"})
    assert rule_hits(fs, "lock-order") == []


def test_lock_order_no_cycle_no_finding():
    fs = run_lint_program({"fixpkg/a.py": CYCLE_A}, rules={"lock-order"})
    assert rule_hits(fs, "lock-order") == []


RANKED_USE = """
import threading
from tidb_tpu_torch.utils import lockrank

MU = lockrank.ranked_lock("fix.low")
MU2 = lockrank.ranked_lock("fix.high")


def nested():
    with MU:
        with MU2:
            pass
"""


def test_lock_order_rank_registry_unknown_name():
    fs = run_lint_program(
        {"fixpkg/m.py": RANKED_USE}, rules={"lock-order"},
        lock_ranks={"fix.low": 10})          # fix.high missing
    hits = rule_hits(fs, "lock-order")
    assert any(f.detail == "rank-registry:unknown:fix.high"
               for f in hits), [f.detail for f in hits]


def test_lock_order_rank_registry_call_site_drift():
    src = RANKED_USE.replace('lockrank.ranked_lock("fix.low")',
                             'lockrank.ranked_lock("fix.low", 99)')
    fs = run_lint_program(
        {"fixpkg/m.py": src}, rules={"lock-order"},
        lock_ranks={"fix.low": 10, "fix.high": 20})
    hits = rule_hits(fs, "lock-order")
    assert any(f.detail == "rank-registry:drift:fix.low"
               for f in hits), [f.detail for f in hits]


def test_lock_order_rank_drift_on_edge():
    fs = run_lint_program(
        {"fixpkg/m.py": RANKED_USE}, rules={"lock-order"},
        lock_ranks={"fix.low": 20, "fix.high": 10})  # inverted
    hits = rule_hits(fs, "lock-order")
    assert any(f.detail.startswith("rank-drift:") for f in hits), \
        [f.detail for f in hits]


def test_lock_order_rank_consistent_edge_clean():
    fs = run_lint_program(
        {"fixpkg/m.py": RANKED_USE}, rules={"lock-order"},
        lock_ranks={"fix.low": 10, "fix.high": 20})
    assert rule_hits(fs, "lock-order") == []


# ---- blocking-under-lock (program rule) ------------------------------

FSYNC_UNDER_LOCK = """
import os
import threading

MU = threading.Lock()


def flush(f):
    with MU:
        f.flush()
        os.fsync(f.fileno())
"""


def test_blocking_fsync_under_mutex_flagged():
    fs = run_lint_program({"fixpkg/w.py": FSYNC_UNDER_LOCK},
                          rules={"blocking-under-lock"})
    dets = [f.detail for f in rule_hits(fs, "blocking-under-lock")]
    assert any(":fsync:" in d for d in dets) and \
        any(":flush:" in d for d in dets), dets


DISPATCH_UNDER_LOCK = """
import threading
import torch
from tidb_tpu_torch.utils import device_guard

MU = threading.Lock()


def run(x, ectx):
    with MU:
        return device_guard.guarded_dispatch(
            lambda: x, site="fix/run", ectx=ectx)


def wait(ev):
    with MU:
        torch.cuda.synchronize()
        ev.synchronize()
"""


def test_blocking_dispatch_under_lock_flagged():
    fs = run_lint_program({"fixpkg/d.py": DISPATCH_UNDER_LOCK},
                          rules={"blocking-under-lock"})
    hits = rule_hits(fs, "blocking-under-lock")
    assert sum(":dispatch:" in f.detail for f in hits) == 3, \
        [f.detail for f in hits]


def test_blocking_transitive_through_call_edge():
    src = """
    import os
    import threading

    MU = threading.Lock()


    def _sync(f):
        os.fsync(f.fileno())


    def flush(f):
        with MU:
            _sync(f)
    """
    fs = run_lint_program({"fixpkg/t.py": src},
                          rules={"blocking-under-lock"})
    hits = rule_hits(fs, "blocking-under-lock")
    assert any(":fsync:" in f.detail for f in hits)
    assert any("_sync" in f.message for f in hits)


WAIT_FIXTURE = """
import threading

MU = threading.Lock()
DONE = threading.Condition(threading.Lock())


def bad():
    with MU:
        with DONE:
            DONE.wait()          # untimed, under a FOREIGN lock


def good():
    with DONE:
        DONE.wait(0.05)          # timed wait on its own lock
"""


def test_blocking_untimed_wait_flagged_timed_wait_clean():
    fs = run_lint_program({"fixpkg/c.py": WAIT_FIXTURE},
                          rules={"blocking-under-lock"})
    hits = rule_hits(fs, "blocking-under-lock")
    assert any(":wait:" in f.detail for f in hits), \
        [f.detail for f in hits]
    assert all("MU" in f.detail for f in hits), [f.detail for f in hits]


def test_blocking_hot_lock_wait_while_lock_held():
    src = """
    import threading
    from tidb_tpu_torch.utils import lockrank

    MU = threading.Lock()
    HOT = lockrank.ranked_lock("fix.hot")


    def f():
        with MU:
            with HOT:
                pass
    """
    fs = run_lint_program({"fixpkg/h.py": src},
                          rules={"blocking-under-lock"},
                          lock_ranks={"fix.hot": 10},
                          hot_locks={"fix.hot"})
    hits = rule_hits(fs, "blocking-under-lock")
    assert any(f.detail.startswith("hot-wait:") for f in hits), \
        [f.detail for f in hits]


def test_blocking_waiver_respected():
    waived = FSYNC_UNDER_LOCK.replace(
        "        os.fsync(f.fileno())",
        "        # tpulint: disable=blocking-under-lock — fixture\n"
        "        os.fsync(f.fileno())").replace(
        "        f.flush()",
        "        # tpulint: disable=blocking-under-lock — fixture\n"
        "        f.flush()")
    fs = run_lint_program({"fixpkg/w.py": waived},
                          rules={"blocking-under-lock"})
    assert rule_hits(fs, "blocking-under-lock") == []


def test_package_lock_graph_acyclic_and_rank_clean():
    cfg = LintConfig.for_package(PKG, root=REPO)
    assert cfg.lock_ranks, "utils/lockrank_ranks.py not parsed"
    findings = lint_paths([PKG], cfg)
    bad = [f for f in findings
           if f.rule in ("lock-order", "blocking-under-lock")
           and not f.baselined]
    assert bad == [], "\n".join(f"{f.path}:{f.line} {f.detail}"
                                for f in bad)


# ---- incremental cache + --jobs --------------------------------------

def test_cache_hit_on_unchanged_source(tmp_path):
    from tidb_tpu_torch.tools.tpulint import LintCache
    cache = LintCache(directory=str(tmp_path / "c"))
    cfg = LintConfig.for_package(PKG, root=REPO)
    target = os.path.join(PKG, "utils", "lockrank.py")
    lint_paths([target], cfg, cache=cache)
    assert cache.misses >= 1 and cache.hits == 0
    cache2 = LintCache(directory=str(tmp_path / "c"))
    cfg2 = LintConfig.for_package(PKG, root=REPO)
    lint_paths([target], cfg2, cache=cache2)
    assert cache2.hits >= 1, (cache2.hits, cache2.misses)


def test_cache_invalidated_by_rule_set_and_source_change(tmp_path):
    from tidb_tpu_torch.tools.tpulint.cache import (LintCache,
                                                    config_fingerprint)
    cfg = LintConfig(root=REPO)
    fp_all = config_fingerprint(cfg, ["a", "b"])
    fp_sub = config_fingerprint(cfg, ["a"])
    assert fp_all != fp_sub
    cache = LintCache(directory=str(tmp_path / "c"))
    assert cache.key("src1", fp_all) != cache.key("src2", fp_all)
    assert cache.key("src1", fp_all) != cache.key("src1", fp_sub)


def test_cached_findings_reabsorb_against_live_baseline(tmp_path):
    from tidb_tpu_torch.tools.tpulint import LintCache
    fixture = tmp_path / "pkg" / "f.py"
    fixture.parent.mkdir()
    fixture.write_text(textwrap.dedent(DISPATCH_POS))
    cachedir = str(tmp_path / "c")
    cfg = LintConfig(root=str(tmp_path))
    fs = lint_paths([str(fixture)], cfg,
                    cache=LintCache(directory=cachedir))
    new = [f for f in fs if not f.baselined]
    assert len(new) == 1
    bl = Baseline(entries=[{
        "rule": new[0].rule, "file": new[0].path,
        "context": new[0].context, "detail": new[0].detail,
        "reason": "fixture"}])
    cfg2 = LintConfig(root=str(tmp_path), baseline=bl)
    fs2 = lint_paths([str(fixture)], cfg2,
                     cache=LintCache(directory=cachedir))
    assert all(f.baselined for f in fs2
               if f.rule == "unguarded-dispatch")


def test_jobs_parallel_matches_serial():
    cfg1 = LintConfig.for_package(PKG, root=REPO)
    target = os.path.join(PKG, "cluster")
    serial = lint_paths([target], cfg1, jobs=1)
    cfg2 = LintConfig.for_package(PKG, root=REPO)
    parallel = lint_paths([target], cfg2, jobs=4)
    key = lambda f: (f.path, f.line, f.rule, f.detail)  # noqa: E731
    assert sorted(map(key, serial)) == sorted(map(key, parallel))


# ---- the lint stands alone ----------------------------------------------

def test_lint_imports_neither_jax_nor_the_reference():
    """The port's lint runs where jax and tidb_tpu cannot be imported."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['tidb_tpu'] = None; sys.modules['torch'] = None; "
            "from tidb_tpu_torch.tools.tpulint.cli import main; "
            "sys.exit(main(['--strict', '--no-compile', "
            "'tidb_tpu_torch/vector']))")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
