"""tpulint — AST-based invariant analyzer for the tidb_tpu_torch engine
(reference tidb_tpu/tools/tpulint, its machinery copied and its device
rules redesigned for torch).

Locks in, as machine-checked rules, the contracts of device-failure
supervision, the fetch seam and thread-local phase accounting with the
unified metrics registry:

  unguarded-dispatch   every device dispatch (run_fragment, a kernel
                       callable, a scan kernel wrapper) routes through
                       device_guard.guarded_dispatch
  host-sync-in-device-path
                       fragment results reach the host only through
                       utils.fetch (no .item / .tolist / .cpu / .numpy
                       / scalar dunders / torch.cuda.synchronize) in
                       copr/, mpp/, vector/ and ml/
  jit-purity           fragment bodies do not read the card on the host
                       and mutate nothing outside themselves
  shared-state-race    module-level mutable state is mutated only
                       under a lock (or lives in threading.local)
  metrics-hygiene      instruments carry HELP text + static label
                       sets; no interpolated label values
  error-code-validity  referenced error attrs / sysvar names exist in
                       their registries
  unused-import        imports are referenced (the compileall + F401
                       sweep of the gate)
  failpoint-site / lock-order / blocking-under-lock
                       failpoint sites are registered, locks keep their
                       ranks, nothing blocks under a hot lock

One AST walk per file (context.FileContext) feeds every rule; inline
`# tpulint: disable=<rule>` waivers and a checked-in baseline file keep
pre-existing, justified findings from blocking the strict gate.

Usage:  python -m tidb_tpu_torch.tools.tpulint [--strict] [--json] [paths]
API:    from tidb_tpu_torch.tools.tpulint import lint_paths, lint_source
"""
from .core import (Finding, ProgramRule, Rule, all_rules, get_rule,
                   register_rule)
from .engine import (LintConfig, lint_file, lint_paths, lint_source,
                     lint_sources)
from .baseline import Baseline
from .cache import LintCache

__all__ = [
    "Finding", "Rule", "ProgramRule", "all_rules", "get_rule",
    "register_rule", "LintConfig", "lint_file", "lint_paths",
    "lint_source", "lint_sources", "Baseline", "LintCache",
]
