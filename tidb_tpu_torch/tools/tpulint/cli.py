"""tpulint CLI — the port's lint gate.

    python -m tidb_tpu_torch.tools.tpulint --strict

runs, over the whole tidb_tpu_torch package:
  1. the tpulint rule set (baseline-aware, waiver-aware);
  2. a `compileall` sweep (syntax/bytecode over tidb_tpu_torch and the
     port's tests, tests/test_torch_*.py);
and exits nonzero on any NEW finding, stale baseline entry, or compile
failure. `--json` emits machine output; `--write-baseline` snapshots
current findings as the new baseline (reasons must then be filled in).
The baseline is the port's own (baseline.json beside this module), and
the incremental cache is used only when --cache-dir names a directory.
"""
from __future__ import annotations

import argparse
import os
import sys

from .baseline import Baseline
from .cache import LintCache
from .core import all_rules
from .engine import LintConfig, lint_paths
from .reporters import report_json, report_text

_PKG_DIR = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))     # …/tidb_tpu_torch
_REPO = os.path.dirname(_PKG_DIR)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def _run_compileall(paths, stream) -> bool:
    import compileall
    ok = True
    for p in paths:
        if not os.path.exists(p[0] if isinstance(p, tuple) else p):
            continue
        if isinstance(p, tuple):            # (dir, file-name pattern)
            import re
            r = compileall.compile_dir(p[0], quiet=2, force=False,
                                       maxlevels=0, rx=re.compile(p[1]))
        elif os.path.isdir(p):
            r = compileall.compile_dir(p, quiet=2, force=False)
        else:
            r = compileall.compile_file(p, quiet=2, force=False)
        if not r:
            stream.write(f"tpulint: compileall FAILED under {p}\n")
            ok = False
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpulint",
        description="AST invariant analyzer for tidb_tpu_torch "
                    "(dispatch-guard, host-sync, fragment purity, "
                    "concurrency, metrics and registry contracts)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the "
                         "tidb_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any new finding, stale baseline "
                         "entry, or compile failure")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: the port's "
                         "tools/tpulint/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="snapshot current non-baselined findings as "
                         "the new baseline and exit")
    ap.add_argument("--rules",
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the compileall sweep")
    ap.add_argument("--jobs", "-j", type=int,
                    default=min(8, os.cpu_count() or 1),
                    help="parallel per-file walks (default: min(8, "
                         "cpus); program rules always run once, "
                         "single-threaded, over the merged "
                         "inventories)")
    ap.add_argument("--cache-dir", default=None,
                    help="keep per-file results in this directory "
                         "(default: no cache)")
    ap.add_argument("--clear-cache", action="store_true",
                    help="drop every cached per-file result under "
                         "--cache-dir and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print baselined findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name:22s} {rule.severity:8s} {rule.doc}")
        return 0

    if args.clear_cache and args.cache_dir is None:
        ap.error("--clear-cache needs --cache-dir")
    cache = None if args.cache_dir is None else LintCache(args.cache_dir)
    if args.clear_cache:
        n = cache.clear()
        print(f"tpulint: cleared {n} cached result(s) from "
              f"{cache.dir}")
        return 0

    paths = args.paths or [_PKG_DIR]
    baseline = Baseline() if args.no_baseline else \
        Baseline.load(args.baseline)
    enabled = set(args.rules.split(",")) if args.rules else None
    config = LintConfig.for_package(_PKG_DIR, root=_REPO,
                                    baseline=baseline, enabled=enabled)
    findings = lint_paths(paths, config, jobs=max(1, args.jobs),
                          cache=cache)
    # stale = unmatched baseline rows UNDER the requested paths; a spot
    # run over a subset must not flag rows it never re-verified, but a
    # row whose file was deleted still goes stale on a full run
    prefixes = []
    for p in paths:
        rel = os.path.relpath(os.path.abspath(p), _REPO).replace(
            "\\", "/")
        prefixes.append((rel, os.path.isdir(p)))

    def _in_scope(file):
        return any(file == rel or (is_dir and
                                   file.startswith(rel + "/"))
                   for rel, is_dir in prefixes)

    stale = [e for e in baseline.stale_entries(in_scope=_in_scope)
             # a --rules spot run never re-checks other rules' rows
             if enabled is None or e.get("rule") in enabled]

    if args.write_baseline:
        n = Baseline.write(args.baseline,
                           [f for f in findings if not f.baselined],
                           keep_entries=baseline.matched_entries())
        print(f"tpulint: wrote {n} baseline entr"
              f"{'y' if n == 1 else 'ies'} to {args.baseline}")
        return 0

    out = sys.stdout
    if args.as_json:
        report_json(findings, out, stale=stale)
    else:
        report_text(findings, out, stale=stale, verbose=args.verbose)

    compile_ok = True
    if not args.no_compile and args.strict:
        compile_ok = _run_compileall(
            [_PKG_DIR, (os.path.join(_REPO, "tests"),
                        r"test_torch_[^/]*\.py$")], sys.stderr)

    new = [f for f in findings if not f.baselined]
    if args.strict and (new or stale or not compile_ok):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
