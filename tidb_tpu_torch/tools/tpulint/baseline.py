"""Checked-in baseline: pre-existing findings that don't block --strict.

Entries match on line-INDEPENDENT identity (rule, file, context,
detail) so the baseline survives unrelated edits. Every entry carries a
`reason` — the policy is a near-empty baseline where each
survivor is justified; prefer fixing the code or an inline waiver with
a rationale comment next to the finding.
"""
from __future__ import annotations

import json
import os

VERSION = 1


class Baseline:
    def __init__(self, entries=None, path=None):
        self.path = path
        self.entries = list(entries or [])
        self._index = {self._key(e): e for e in self.entries}
        self.matched: set = set()

    @staticmethod
    def _key(entry: dict):
        return (entry.get("rule", ""), entry.get("file", ""),
                entry.get("context", ""), entry.get("detail", ""))

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not path or not os.path.exists(path):
            return cls(path=path)
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return cls(entries=data.get("entries", []), path=path)

    def absorb(self, finding) -> bool:
        """Mark finding baselined when a matching entry exists."""
        entry = self._index.get(finding.key())
        if entry is None:
            return False
        self.matched.add(finding.key())
        finding.baselined = True
        finding.reason = entry.get("reason", "")
        return True

    def stale_entries(self, in_scope=None) -> list:
        """Entries that matched nothing this run — fixed findings whose
        baseline row should be deleted. `in_scope` (a predicate over
        the entry's repo-relative path) restricts staleness to the
        paths this run actually covered: a `--strict
        tidb_tpu_torch/utils` spot run must not fail the gate over rows it
        never re-checked. Scope is by PATH PREFIX, not by file
        existence, so an entry whose file was deleted still goes stale
        on a full run."""
        out = []
        for e in self.entries:
            if self._key(e) in self.matched:
                continue
            if in_scope is not None and not in_scope(e.get("file", "")):
                continue
            out.append(e)
        return out

    def matched_entries(self) -> list:
        """Entries whose finding still exists (absorbed this run) — a
        baseline rewrite must carry these forward with their reasons."""
        return [e for e in self.entries if self._key(e) in self.matched]

    @staticmethod
    def write(path: str, findings, keep_entries=()) -> int:
        """Serialize current NON-baselined findings as baseline entries
        (reasons default to a fix-me marker the reviewer must replace),
        carrying forward `keep_entries` — the still-matched rows of the
        previous baseline — so a rewrite never erases a justified,
        still-live entry."""
        entries = []
        seen = set()
        for e in keep_entries:
            k = Baseline._key(e)
            if k in seen:
                continue
            seen.add(k)
            entries.append(dict(e))
        for f in sorted(findings,
                        key=lambda f: (f.rule, f.path, f.context,
                                       f.detail)):
            if f.key() in seen:
                continue
            seen.add(f.key())
            entries.append({
                "rule": f.rule, "file": f.path, "context": f.context,
                "detail": f.detail,
                "reason": f.reason or "TODO: justify or fix",
            })
        # (rule, file, context, detail) — the finding identity tuple —
        # so a rewritten baseline diffs stably against the previous one
        entries.sort(key=lambda e: (e.get("rule", ""),
                                    e.get("file", ""),
                                    e.get("context", ""),
                                    e.get("detail", "")))
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"version": VERSION, "entries": entries}, fh,
                      indent=2, sort_keys=False)
            fh.write("\n")
        return len(entries)
