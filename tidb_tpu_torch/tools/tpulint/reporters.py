"""Text + JSON reporters."""
from __future__ import annotations

import json


def report_text(findings, stream, stale=(), verbose=False) -> None:
    new = [f for f in findings if not f.baselined]
    base = [f for f in findings if f.baselined]
    for f in new:
        stream.write(f"{f.path}:{f.line}:{f.col}: "
                     f"[{f.rule}] {f.severity}: {f.message}"
                     f"  ({f.context})\n")
    if base and verbose:
        for f in base:
            why = f" — baselined: {f.reason}" if f.reason else " — baselined"
            stream.write(f"{f.path}:{f.line}:{f.col}: "
                         f"[{f.rule}] {f.severity} (baselined): "
                         f"{f.message}{why}\n")
    for e in stale:
        stream.write(f"stale baseline entry (finding fixed — delete "
                     f"it): {e.get('rule')} {e.get('file')} "
                     f"{e.get('detail')}\n")
    by_rule: dict = {}
    for f in new:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    stream.write(
        f"tpulint: {len(new)} finding(s)"
        + (f" [{summary}]" if summary else "")
        + (f", {len(base)} baselined" if base else "")
        + (f", {len(stale)} stale baseline entr"
           f"{'y' if len(stale) == 1 else 'ies'}" if stale else "")
        + "\n")


def report_json(findings, stream, stale=()) -> None:
    new = [f for f in findings if not f.baselined]
    doc = {
        "findings": [f.to_dict() for f in findings],
        "summary": {
            "total": len(findings),
            "new": len(new),
            "baselined": len(findings) - len(new),
            "by_rule": {},
            "stale_baseline_entries": list(stale),
        },
    }
    for f in new:
        br = doc["summary"]["by_rule"]
        br[f.rule] = br.get(f.rule, 0) + 1
    json.dump(doc, stream, indent=2)
    stream.write("\n")
