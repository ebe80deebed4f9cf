"""Chaos smoke: an injected device error at EVERY device dispatch site,
all 22 TPC-H queries at SF0.05 (reference scripts/chaos_smoke.py).

On the CPU (--cpu) the port degrades as the reference does: with
grant loss injected at every site at once, every query must return
rows identical to the pure-host path — no stall, no rc=124.

On the card the port fails the statement instead of degrading (no host
twin serves a fragment there: copr/dag_exec.py `degrade_to_host`). The
gate sweeps one site at a time over the 22 queries, and per query and
site the outcome must be one of:

  * the query never reached the site: rows == the host rows (and ==
    `expected`, the reference's rows, when given);
  * a clean DeviceUnavailableError (9013) naming the site's family, the
    statement's implicit transaction rolled back (no open txn, no lock
    left), and the same session returning the reference's rows once
    the failpoint is cleared.

Every statement stays inside the per-query wall budget. One write per
site (INSERT ... SELECT over lineitem) shows the rollback on data: a
failed statement leaves the sink empty. The sweep raises the session's
breaker threshold: on the card an open breaker fails every statement of
its family until its cooldown ends, since no host twin serves it, and
the gate is about each statement's own outcome.

The failpoint spec rides TIDB_TPU_FAILPOINTS when run as a module (the
channel a chaos harness would use against a live server), installed
before the engine imports; in-process callers get the same spec through
failpoint.enable.

Usage:  python -m tidb_tpu_torch.tools.chaos_smoke [--cpu]
        [--error-class C]
Env:    CHAOS_SF (0.05), CHAOS_QUERY_BUDGET_S (120), CHAOS_ERROR
        (grant_lost)
Exit:   0 every query host-identical (CPU) or per-site clean (card);
        1 mismatch/stall/error.
"""
from __future__ import annotations

import os
import sys
import time

from .gates import device_of, txn_open

SITES = ("copr/agg", "copr/filter", "copr/topn", "copr/mpp",
         "fused/kernel", "sort", "window", "join")
SINK = ("insert into chaos_sink select l_returnflag, count(*) from "
        "lineitem group by l_returnflag")


def _prepare(tk):
    # drag the small-input device paths into the blast radius too
    os.environ.setdefault("TIDB_TPU_SORT_MIN", "1")
    os.environ.setdefault("TIDB_TPU_WINDOW_MIN", "1")
    tk.must_exec("set @@tidb_tpu_fragment_min_rows = 0")


def run(device="cuda", sf=None, err=None, budget=None, tk=None,
        expected=None, queries=None, out=sys.stderr, report=None):
    """-> list of failure strings. tk: a TestKit with TPC-H loaded
    (else one is made on `device`, seed 42). expected: {query: rows in
    TestKit's string form} from the reference, held on the card.
    report, when a dict, receives per site the queries that failed
    with 9013 and those that never reached it."""
    err = err or os.environ.get("CHAOS_ERROR", "grant_lost")
    sf = float(os.environ.get("CHAOS_SF", "0.05")) if sf is None else sf
    budget = float(os.environ.get("CHAOS_QUERY_BUDGET_S", "120")) \
        if budget is None else budget
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.bench.tpch import load_tpch, ALL_QUERIES
    if queries is None:
        queries = sorted(ALL_QUERIES, key=lambda q: int(q[1:]))
    if tk is None:
        tk = TestKit(device=device)
        load_tpch(tk, sf=sf, seed=42)
    _prepare(tk)
    card = tk.domain.copr.device.type == "cuda"
    print(f"# chaos_smoke: sf={sf} error={err} sites={len(SITES)} "
          f"device={tk.domain.copr.device}", file=out)
    host = {}
    tk.domain.copr.use_device = False
    try:
        for q in queries:
            host[q] = tk.must_query(ALL_QUERIES[q]).rows
    finally:
        tk.domain.copr.use_device = True
    if card:
        return _run_card(tk, queries, host, err, budget, expected, out,
                         report)
    return _run_cpu(tk, queries, host, err, budget, out)


def _run_cpu(tk, queries, host, err, budget, out):
    from tidb_tpu_torch.bench.tpch import ALL_QUERIES
    from tidb_tpu_torch.utils import failpoint
    for s in SITES:
        failpoint.enable("device_guard/" + s, f"error:{err}")
    chaos, failures = {}, []
    try:
        for q in queries:
            t0 = time.time()
            try:
                chaos[q] = tk.must_query(ALL_QUERIES[q]).rows
            except Exception as e:              # noqa: BLE001
                failures.append(f"{q}: chaos run error "
                                f"{type(e).__name__}: {str(e)[:120]}")
                continue
            dt = time.time() - t0
            if dt > budget:
                failures.append(f"{q}: exceeded {budget:.0f}s budget "
                                f"({dt:.1f}s) — supervision did not "
                                "preempt the stall")
            print(f"# {q}: chaos {dt*1000:.0f}ms "
                  f"retries={tk.domain.metrics.get('device_retry', 0)} "
                  f"fallbacks="
                  f"{tk.domain.metrics.get('device_fallback', 0)}",
                  file=out)
    finally:
        failpoint.disable_all()
        os.environ.pop("TIDB_TPU_FAILPOINTS", None)
    for q, rows in chaos.items():
        if rows != host[q]:
            failures.append(f"{q}: chaos rows != host rows "
                            f"({len(rows)} vs {len(host[q])})")
    m = tk.domain.metrics
    print(f"# metrics: device_retry={m.get('device_retry', 0)} "
          f"device_fallback={m.get('device_fallback', 0)} "
          f"breaker_open={m.get('device_breaker_open', 0)} "
          f"short_circuit={m.get('device_breaker_short_circuit', 0)}",
          file=out)
    if not failures and not m.get("device_fallback", 0):
        failures.append("no dispatch degraded: the injection reached "
                        "no guarded site")
    return failures


def _run_card(tk, queries, host, err, budget, expected, out, report):
    from tidb_tpu_torch.bench.tpch import ALL_QUERIES
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.utils import failpoint
    from .gates import norm
    failures = []
    tk.must_exec("set @@tidb_tpu_device_breaker_threshold = 1000000")
    tk.must_exec("create table if not exists chaos_sink "
                 "(f varchar(1), n bigint)")
    mvcc = tk.domain.storage.mvcc
    if expected is not None:
        for q in queries:
            if norm(host[q]) != expected[q]:
                failures.append(f"{q}: host rows != the reference's")
    failed_total = 0
    for site in SITES:
        failpoint.enable("device_guard/" + site, f"error:{err}")
        failed, clean = [], []
        try:
            for q in queries:
                t0 = time.time()
                try:
                    rows = tk.must_query(ALL_QUERIES[q]).rows
                except DeviceUnavailableError as e:
                    # the message names the guard's site, whose family
                    # is the injected site's (fused/kernel fails "fused")
                    if e.code != 9013 or \
                            f"at {site.split('/')[0]}" not in e.msg:
                        failures.append(f"{site} {q}: {e.code} "
                                        f"{e.msg[:120]}")
                    failed.append(q)
                except Exception as e:          # noqa: BLE001
                    failures.append(f"{site} {q}: unclean "
                                    f"{type(e).__name__}: "
                                    f"{str(e)[:120]}")
                    failed.append(q)
                else:
                    clean.append(q)
                    if rows != host[q]:
                        failures.append(f"{site} {q}: rows != host rows")
                dt = time.time() - t0
                if dt > budget:
                    failures.append(f"{site} {q}: {dt:.1f}s > "
                                    f"{budget:.0f}s budget")
                if txn_open(tk):
                    failures.append(f"{site} {q}: the statement's "
                                    "transaction is still open")
                if mvcc._locks:
                    failures.append(f"{site} {q}: {len(mvcc._locks)} "
                                    "locks left")
            sink = None
            try:
                tk.must_exec(SINK)
            except DeviceUnavailableError as e:
                sink = e.code
        finally:
            failpoint.disable("device_guard/" + site)
        n = tk.must_query("select count(*) from chaos_sink").rows
        if sink == 9013 and n != [(0,)]:
            failures.append(f"{site}: a failed INSERT ... SELECT left "
                            f"{n[0][0]} rows")
        tk.must_exec("delete from chaos_sink")
        # the same session, failpoint cleared: the reference's rows
        for q in failed:
            try:
                rows = tk.must_query(ALL_QUERIES[q]).rows
            except Exception as e:              # noqa: BLE001
                failures.append(f"{site} {q}: after clearing: "
                                f"{type(e).__name__}: {str(e)[:120]}")
                continue
            if rows != host[q]:
                failures.append(f"{site} {q}: after clearing, rows != "
                                "host rows")
        failed_total += len(failed)
        print(f"# {site}: 9013 in {len(failed)} "
              f"({','.join(failed) or '-'}), not reached in "
              f"{len(clean)}; sink {'9013' if sink else 'written'}",
              file=out)
        if report is not None:
            report[site] = {"9013": failed, "not_reached": clean,
                            "sink": sink}
    if failed_total == 0:
        failures.append("no statement met an injected error on the "
                        "card: the sweep reached no guarded site")
    return failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    err = os.environ.get("CHAOS_ERROR", "grant_lost")
    if "--error-class" in argv:
        err = argv[argv.index("--error-class") + 1]
    device = device_of(argv)
    if device == "cpu":
        os.environ["TIDB_TPU_FAILPOINTS"] = ";".join(
            f"device_guard/{s}=error:{err}" for s in SITES)
    failures = run(device=device, err=err)
    if failures:
        print("CHAOS SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    how = "host-identical under an injected device failure at every " \
        "dispatch site" if device == "cpu" else \
        "clean 9013 or host-identical per site, rows back once cleared"
    print(f"CHAOS SMOKE OK: 22 queries {how}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
