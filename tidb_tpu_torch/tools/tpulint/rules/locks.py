"""lock-order + blocking-under-lock: the interprocedural concurrency
rules.

The concurrency bugs this engine's reference shipped — an
epoch-rebroadcast fence TOCTOU, a lock-holder convoy, a tracker race —
were found late, by a chaos gate or a soak.  These two rules pin the
invariants statically, over the WHOLE package:

lock-order
    The global lock-acquisition digraph (built from every `with <lock>`
    region, following calls through the conservative call graph) must
    be ACYCLIC, and must agree with the rank registry in
    utils/lockrank_ranks.py: for every edge "L held while acquiring M",
    rank(L) < rank(M).  A cycle finding names both acquisition paths.
    Waivable only with an inline comment naming the external ordering
    argument (`# tpulint: disable=lock-order — <why>` on the
    acquisition line).  The registry cross-check (unknown rank name,
    call-site literal contradicting the registry, edge contradicting
    rank order) keeps the static graph and the runtime sanitizer from
    drifting apart.

blocking-under-lock
    Nothing slow runs while a mutex is held: fsync/flush, socket
    send/recv, guarded_dispatch (device dispatch = milliseconds),
    time.sleep, untimed Event.wait/Condition.wait (a condition waiting
    on its OWN lock is exempt — wait releases it), bare thread joins,
    and lock-waits on a second lock flagged HOT in the registry.  This
    is the convoy invariant (append under the store mutex,
    `wait_durable` outside it) as a machine check.
"""
from __future__ import annotations

import ast

from ..callgraph import find_cycles
from ..core import ProgramRule, register_rule

RANKS_RELPATH = "utils/lockrank_ranks.py"


def parse_rank_registry(src: str):
    """-> (ranks: {name: rank}, hot: {name}) parsed from the literal
    RANKS dict / HOT set — tpulint never imports analyzed code."""
    ranks: dict = {}
    hot: set = set()
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        value = node.value
        if "RANKS" in names and isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str) and \
                        isinstance(v, ast.Constant) and \
                        isinstance(v.value, int):
                    ranks[k.value] = v.value
        elif "HOT" in names and isinstance(value, (ast.Set, ast.List,
                                                   ast.Tuple)):
            for e in value.elts:
                if isinstance(e, ast.Constant) and \
                        isinstance(e.value, str):
                    hot.add(e.value)
    return ranks, hot


def _label(node):
    """Human name for a lock node."""
    if node.ranked:
        return f"'{node.ranked}'"
    return f"{node.path}:{node.owner}.{node.attr}"


@register_rule
class LockOrder(ProgramRule):
    name = "lock-order"
    severity = "error"
    doc = ("global lock-acquisition digraph must be acyclic and agree "
           "with the utils/lockrank_ranks.py rank registry")

    def run_program(self, program):
        seen: set = set()

        # 1. registry consistency per ranked-lock site
        if program.ranks or program.hot:
            for (path, owner, attr), node in sorted(
                    program.locks.items()):
                if not node.ranked or node.path != path:
                    continue
                key = ("site", node.id)
                if key in seen:
                    continue
                seen.add(key)
                if node.ranked not in program.ranks:
                    if program.waived(path, node.line, self.name):
                        continue
                    yield self.finding_at(
                        path, node.line, f"{owner}.{attr}",
                        f"ranked lock '{node.ranked}' is not in "
                        f"{RANKS_RELPATH} RANKS — the runtime "
                        f"sanitizer and the static graph must share "
                        f"one registry",
                        detail=f"rank-registry:unknown:{node.ranked}")
                # call-site literal contradicting the registry
                inv = program.inv[path]
                for lk in inv["locks"]:
                    if lk.get("ranked") == node.ranked and \
                            lk.get("rank") is not None and \
                            program.ranks.get(node.ranked) is not None \
                            and lk["rank"] != \
                            program.ranks[node.ranked]:
                        if program.waived(path, lk["line"], self.name):
                            continue
                        yield self.finding_at(
                            path, lk["line"], f"{owner}.{attr}",
                            f"ranked lock '{node.ranked}': call-site "
                            f"rank {lk['rank']} contradicts registry "
                            f"rank {program.ranks[node.ranked]} "
                            f"({RANKS_RELPATH} is the single source "
                            f"of truth)",
                            detail=f"rank-registry:drift:"
                                   f"{node.ranked}")

        edges = program.lock_edges()

        # 2. cycles
        cycle_edge_ids: set = set()
        for cycle in find_cycles(edges):
            ids = sorted({e[0].id for e in cycle} |
                         {e[1].id for e in cycle})
            detail = "cycle:" + "->".join(ids)
            if ("cycle", detail) in seen:
                continue
            seen.add(("cycle", detail))
            for holder, node, info in cycle:
                cycle_edge_ids.add((holder.id, node.id))
            if any(program.waived(info["path"], info["line"],
                                  self.name)
                   for _, _, info in cycle):
                continue
            paths = "; ".join(
                f"{_label(h)} -> {_label(n)} at {i['path']}:"
                f"{i['line']} in {i['func']} ({i['via']})"
                for h, n, i in cycle)
            first = cycle[0][2]
            yield self.finding_at(
                first["path"], first["line"], first["func"],
                f"lock-acquisition cycle ({len(cycle)} edge"
                f"{'s' if len(cycle) != 1 else ''}): {paths} — a "
                f"deadlock is one unlucky interleaving away; break "
                f"the cycle or waive each edge with the external "
                f"ordering argument",
                detail=detail)

        # 3. rank drift on acyclic edges (cycles already reported)
        for holder, node, info in edges:
            if holder.rank is None or node.rank is None:
                continue
            if holder.rank < node.rank:
                continue
            if (holder.id, node.id) in cycle_edge_ids:
                continue
            detail = f"rank-drift:{holder.id}->{node.id}"
            if ("drift", detail) in seen:
                continue
            seen.add(("drift", detail))
            if program.waived(info["path"], info["line"], self.name):
                continue
            yield self.finding_at(
                info["path"], info["line"], info["func"],
                f"acquisition order contradicts the rank registry: "
                f"{_label(holder)} (rank {holder.rank}) is held while "
                f"acquiring {_label(node)} (rank {node.rank}) at "
                f"{info['path']}:{info['line']} ({info['via']}); "
                f"ranks must be strictly increasing — reorder the "
                f"acquisitions or renumber {RANKS_RELPATH}",
                detail=detail)


@register_rule
class BlockingUnderLock(ProgramRule):
    name = "blocking-under-lock"
    severity = "error"
    doc = ("no fsync/flush, socket I/O, device dispatch, sleep, "
           "untimed wait, or hot-lock wait while a mutex is held "
           "(transitively, through the call graph)")

    _OP_WHY = {
        "fsync": "an fsync is milliseconds of wall time",
        "flush": "a buffered flush can hit the disk",
        "socket": "socket I/O blocks on the peer",
        "dispatch": "a device dispatch is milliseconds and can "
                    "retry/fail over",
        "sleep": "a sleep serializes every waiter behind this thread",
        "wait": "an untimed wait can park the holder forever",
        "thread-join": "a join waits on another thread's lifetime",
    }

    def run_program(self, program):
        seen: set = set()
        for (holder, op, what, via, path, line,
             region) in program.region_blocking():
            detail = f"blocking:{holder.id}:{op}:{what}"
            key = (detail, via.split(" -> ")[0])
            if key in seen:
                continue
            seen.add(key)
            if program.waived(path, line, self.name):
                continue
            ctxname = via.split("::", 1)[-1].split(" -> ")[0]
            why = self._OP_WHY.get(op, "this operation blocks")
            yield self.finding_at(
                path, line, ctxname,
                f"{op} under lock {_label(holder)}: {what} runs while "
                f"the lock is held (via {via}); {why} — every other "
                f"acquirer convoys behind it (the lock-holder "
                f"convoy class); move it outside the critical section "
                f"or waive with the justification",
                detail=detail)

        # hot-lock waits: acquiring a HOT lock while holding any lock
        if program.hot:
            for holder, node, info in program.lock_edges():
                if not node.hot:
                    continue
                detail = f"hot-wait:{holder.id}->{node.id}"
                if detail in seen:
                    continue
                seen.add(detail)
                if program.waived(info["path"], info["line"],
                                  self.name):
                    continue
                yield self.finding_at(
                    info["path"], info["line"], info["func"],
                    f"lock-wait on HOT lock {_label(node)} while "
                    f"holding {_label(holder)} at {info['path']}:"
                    f"{info['line']} ({info['via']}): waiting on a "
                    f"convoy-sensitive mutex inside another critical "
                    f"section stalls both lock domains — take "
                    f"{_label(node)} first, or drop "
                    f"{_label(holder)} before this call",
                    detail=detail)
