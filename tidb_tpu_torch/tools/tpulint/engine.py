"""Engine: file discovery, per-file lint, program pass, waiver/baseline
application, incremental cache, parallel walks.

The engine never imports the code under analysis — catalogs (error
names, sysvar names, failpoint sites, lock ranks) are themselves parsed
from source, so tpulint runs without torch, without a card, and without
executing package import-time side effects.

Two rule scopes:
  * file rules see one FileContext at a time (one AST walk per file);
    their findings are cacheable per (source sha, config fingerprint);
  * program rules (lock-order, blocking-under-lock) see every file's
    callgraph inventory at once through a callgraph.Program.  The
    graph build is never cached, but it consumes the cached per-file
    inventories — which is where the AST time goes, so a warm
    whole-package run does no parsing at all.
"""
from __future__ import annotations

import ast
import os

from . import rules as _rules  # noqa: F401 — rule registration
from .baseline import Baseline
from .callgraph import Program, build_inventory
from .cache import LintCache, config_fingerprint
from .context import FileContext
from .core import Finding, all_rules
from .rules.codes import parse_error_catalog, parse_sysvar_catalog
from .rules.failpoints import parse_failpoint_registry
from .rules.locks import parse_rank_registry


class LintConfig:
    def __init__(self, root=None, enabled=None, baseline=None,
                 known_errors=None, known_sysvars=None, error_dups=None,
                 known_failpoints=None, lock_ranks=None,
                 hot_locks=None):
        self.root = root or os.getcwd()
        self.enabled = set(enabled) if enabled is not None else None
        self.baseline = baseline or Baseline()
        self.known_errors = known_errors
        self.known_sysvars = known_sysvars
        self.error_dups = error_dups
        self.known_failpoints = known_failpoints
        self.lock_ranks = lock_ranks
        self.hot_locks = hot_locks

    @classmethod
    def for_package(cls, pkg_dir: str, root: str = None,
                    baseline: Baseline = None,
                    enabled=None) -> "LintConfig":
        """Build catalogs by PARSING the package's registries."""
        root = root or os.path.dirname(os.path.abspath(pkg_dir))
        known_errors = known_sysvars = error_dups = None
        known_failpoints = None
        lock_ranks = hot_locks = None
        epath = os.path.join(pkg_dir, "errors.py")
        if os.path.exists(epath):
            with open(epath, "r", encoding="utf-8") as f:
                known_errors, error_dups = parse_error_catalog(f.read())
        spath = os.path.join(pkg_dir, "session", "sysvars.py")
        if os.path.exists(spath):
            with open(spath, "r", encoding="utf-8") as f:
                known_sysvars = parse_sysvar_catalog(f.read())
        fpath = os.path.join(pkg_dir, "utils", "failpoint_sites.py")
        if os.path.exists(fpath):
            with open(fpath, "r", encoding="utf-8") as f:
                known_failpoints = parse_failpoint_registry(f.read())
        rpath = os.path.join(pkg_dir, "utils", "lockrank_ranks.py")
        if os.path.exists(rpath):
            with open(rpath, "r", encoding="utf-8") as f:
                lock_ranks, hot_locks = parse_rank_registry(f.read())
        return cls(root=root, baseline=baseline, enabled=enabled,
                   known_errors=known_errors,
                   known_sysvars=known_sysvars, error_dups=error_dups,
                   known_failpoints=known_failpoints,
                   lock_ranks=lock_ranks, hot_locks=hot_locks)

    def rules(self):
        out = []
        for name, rule in sorted(all_rules().items()):
            if self.enabled is None or name in self.enabled:
                out.append(rule)
        return out

    def file_rules(self):
        return [r for r in self.rules() if r.scope == "file"]

    def program_rules(self):
        return [r for r in self.rules() if r.scope == "program"]


def _parse(src: str, relpath: str):
    """-> (tree, None) or (None, syntax Finding)."""
    try:
        return ast.parse(src), None
    except SyntaxError as e:
        return None, Finding(
            rule="syntax-error", path=relpath, line=e.lineno or 0,
            col=e.offset or 0, severity="error",
            message=f"syntax error: {e.msg}", context="<module>",
            detail=f"syntax:{e.msg}")


def _lint_ctx(ctx, config) -> list:
    """Run the per-file rules over one FileContext (waivers applied,
    NO baseline absorb — callers absorb so cached findings re-absorb
    against the live baseline)."""
    findings = []
    for rule in config.file_rules():
        for f in rule.run(ctx):
            if ctx.waived(f):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


_FINDING_FIELDS = ("rule", "path", "line", "col", "severity",
                   "message", "context", "detail")


def _finding_from_dict(d) -> Finding:
    return Finding(**{k: d[k] for k in _FINDING_FIELDS})


def _run_program_rules(inventories, config) -> list:
    """Program pass over the given inventories. Program rules apply
    their own waivers; baseline absorb happens here."""
    prules = config.program_rules()
    if not prules or not inventories:
        return []
    program = Program(inventories, config)
    findings = []
    for rule in prules:
        for f in rule.run_program(program):
            config.baseline.absorb(f)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_source(src: str, relpath: str, config: LintConfig,
                path: str = "", program: bool = True) -> list:
    """Lint one file's source -> [Finding] (waivers applied; findings
    matching the baseline are KEPT but marked .baselined). With
    `program` (the default), the whole-program rules run over the
    single-file graph — fixtures and spot runs see lock-order /
    blocking-under-lock findings whose evidence is entirely in-file."""
    tree, err = _parse(src, relpath)
    if err is not None:
        return [err]
    ctx = FileContext(path or relpath, relpath, src, tree)
    ctx.config = config
    findings = _lint_ctx(ctx, config)
    for f in findings:
        config.baseline.absorb(f)
    if program:
        findings.extend(
            _run_program_rules([build_inventory(ctx)], config))
    return findings


def lint_sources(sources: dict, config: LintConfig) -> list:
    """Lint an in-memory {relpath: src} set as ONE program — the
    multi-file fixture entry point (tests build 2-file cycles without
    touching disk)."""
    findings = []
    inventories = []
    for relpath in sorted(sources):
        tree, err = _parse(sources[relpath], relpath)
        if err is not None:
            findings.append(err)
            continue
        ctx = FileContext(relpath, relpath, sources[relpath], tree)
        ctx.config = config
        per = _lint_ctx(ctx, config)
        for f in per:
            config.baseline.absorb(f)
        findings.extend(per)
        inventories.append(build_inventory(ctx))
    findings.extend(_run_program_rules(inventories, config))
    return findings


def lint_file(path: str, config: LintConfig) -> list:
    rel = os.path.relpath(path, config.root)
    if rel.startswith(".."):
        rel = os.path.basename(path)
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, rel, config, path=path)


def discover(paths) -> list:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and
                           not d.startswith(".")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def _relpath(path, root):
    rel = os.path.relpath(path, root)
    if rel.startswith(".."):
        rel = os.path.basename(path)
    return rel.replace("\\", "/")


def _lint_one_file(path, config, cache, fingerprint):
    """-> (findings, inventory). Cache-aware per-file unit; safe to run
    from worker threads (touches no shared mutable state)."""
    rel = _relpath(path, config.root)
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    key = LintCache.key(src, fingerprint) if cache else None
    if cache is not None:
        blob = cache.get(key)
        if blob is not None:
            return ([_finding_from_dict(d) for d in blob["findings"]],
                    blob["inventory"])
    tree, err = _parse(src, rel)
    if err is not None:
        return [err], None
    ctx = FileContext(path, rel, src, tree)
    ctx.config = config
    findings = _lint_ctx(ctx, config)
    inventory = build_inventory(ctx)
    if cache is not None:
        cache.put(key, [f.to_dict() for f in findings], inventory)
    return findings, inventory


def lint_paths(paths, config: LintConfig, jobs: int = 1,
               cache: LintCache = None) -> list:
    """Lint files/dirs -> [Finding]: per-file rules (cached, optionally
    parallel) then the whole-program pass over every inventory."""
    files = discover(paths)
    fingerprint = config_fingerprint(
        config, [r.name for r in config.file_rules()]) \
        if cache is not None else None

    results = [None] * len(files)
    if jobs and jobs > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            futs = {pool.submit(_lint_one_file, p, config, cache,
                                fingerprint): i
                    for i, p in enumerate(files)}
            for fut, i in futs.items():
                results[i] = fut.result()
    else:
        for i, p in enumerate(files):
            results[i] = _lint_one_file(p, config, cache, fingerprint)

    findings = []
    inventories = []
    for per, inv in results:
        for f in per:
            f.baselined = False
            f.reason = ""
            config.baseline.absorb(f)
        findings.extend(per)
        if inv is not None:
            inventories.append(inv)
    findings.extend(_run_program_rules(inventories, config))
    return findings
