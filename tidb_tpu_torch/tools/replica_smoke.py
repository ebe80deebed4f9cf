"""Replica-fabric smoke: the read-replica chaos gate (reference
scripts/replica_smoke.py). The leader's coprocessor runs on the device
the command line names (the card by default, the host with --cpu);
the mirrors are provisioned on the leader's device.

HTAP-style load — point ops + an insert stream with analyst threads
whose olap statements are replica-pinned (resolved read mode + the
replica router) — must hold, under kills of every serving replica in
rotation AND error bursts at every REPLICA_SITES seam:

  1. ZERO QUERY ERRORS — degradation to the leader is transparent:
     no analyst or OLTP statement ever surfaces a fabric error.
  2. REPLICA == LEADER AT QUIESCE — after the load drains and the
     feeds catch up, every replica's mirror rows equal the leader's,
     and a resolved analytic equals a leader-path analytic.
  3. FRESHNESS SLA — no replica-served statement's snapshot was ever
     staler than tidb_tpu_replica_max_lag_ms at route time
     (domain.metrics[replica_served_max_lag_ms] audit).
  4. OLTP ISOLATION — point-op throughput with analytics replica-
     pinned holds REPLICA_SMOKE_RATIO of the isolated rate (default
     0.9 on >= 4 cores; 0.5 on smaller boxes, the oltp_smoke
     bracketing rationale).
  5. ELASTICITY (anti-vacuity) — the replica-routed counter is > 0
     before AND after each kill: killed replicas reprovision from
     their checkpoint and resume serving.

Usage:  python -m tidb_tpu_torch.tools.replica_smoke [--cpu] [--quick]
Env:    REPLICA_SMOKE_SECONDS (4; --quick 1.5), REPLICA_SMOKE_RATIO
        (0.9 if cores>=4 else 0.5), REPLICA_SMOKE_MAX_LAG_MS (5000),
        REPLICA_SMOKE_WRITE_ARTIFACT (path)
Exit:   0 all gates pass; 1 otherwise.
"""
from __future__ import annotations

import itertools
import json
import os
import random
import sys
import threading
import time

from .gates import device_of

ANALYTIC = ("select k, count(*), sum(v) from lines "
            "group by k order by k")


def _route_counts():
    from tidb_tpu_torch.utils import metrics as mu
    return {o: mu.REPLICA_ROUTE.labels(o).value
            for o in ("replica", "leader_fallback",
                      "degraded_midstmt")}


# ids for the insert streams; itertools.count.__next__ is atomic
# under the GIL, so threads never collide across bracket phases
_SEQ = itertools.count(10_000_000)


def oltp_cell(tk, n_orders, nthreads, seconds, stop_extra=None,
              out=sys.stderr):
    """Point-select + insert mix -> (ops_s, errors)."""
    stop = threading.Event()
    counts = [0] * nthreads
    errs = [0] * nthreads

    def worker(i):
        s = tk.new_session()
        r = random.Random(i)
        while not stop.is_set():
            try:
                if r.random() < 0.2:
                    seq = next(_SEQ)
                    s.must_exec(
                        f"insert into lines values ({seq}, "
                        f"{seq % 7}, {seq % 1000}, 'w{i}')")
                else:
                    s.must_query(
                        "select total from orders where id = "
                        f"{r.randrange(n_orders)}")
                counts[i] += 1
            except Exception as e:              # noqa: BLE001
                errs[i] += 1
                if errs[i] == 1:
                    print(f"# oltp thread {i}: {type(e).__name__}: "
                          f"{str(e)[:160]}", file=out)
    ths = [threading.Thread(target=worker, args=(i,), daemon=True)
           for i in range(nthreads)]
    for t in ths:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in ths:
        t.join(timeout=30)
    if stop_extra is not None:
        stop_extra.set()
    return sum(counts) / seconds, sum(errs)


def _wait(pred, timeout=15.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _wait_routed_above(base, tk, timeout=15.0):
    """Drive analytics until the replica-routed counter passes base."""
    s = tk.new_session()
    deadline = time.time() + timeout
    while time.time() < deadline:
        s.must_query(ANALYTIC)
        if _route_counts()["replica"] > base:
            return True
    return False


def run(device="cuda", quick=False, out=sys.stderr, report=None):
    """-> list of failure strings. report, when a dict, receives the
    run's figures."""
    seconds = 1.5 if quick else float(
        os.environ.get("REPLICA_SMOKE_SECONDS", "4"))
    cores = os.cpu_count() or 2
    ratio = float(os.environ.get(
        "REPLICA_SMOKE_RATIO", "0.9" if cores >= 4 else "0.5"))
    max_lag = int(os.environ.get("REPLICA_SMOKE_MAX_LAG_MS", "5000"))

    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import failpoint
    from tidb_tpu_torch.utils.failpoint_sites import REPLICA_SITES

    failures = []
    tk = TestKit(device=device)
    tk.must_exec("use test")
    tk.must_exec("create table orders (id int primary key, "
                 "total int)")
    tk.must_exec("create table lines (id int primary key, k int, "
                 "v int, s varchar(16))")
    n_orders = 200
    for i in range(n_orders):
        tk.must_exec(f"insert into orders values ({i}, {i * 3})")
    for i in range(300):
        tk.must_exec(f"insert into lines values ({i}, {i % 7}, "
                     f"{i * 10}, 's{i}')")
    dom = tk.domain

    tk.must_exec(
        "set @@global.tidb_tpu_analytic_read_mode = 'resolved'")
    tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
    tk.must_exec(
        f"set @@global.tidb_tpu_replica_max_lag_ms = {max_lag}")
    tk.must_exec(f"set @@tidb_tpu_replica_max_lag_ms = {max_lag}")

    # --- provision the fabric -----------------------------------------
    reps = dom.replicas.provision(2)
    if not _wait(lambda: all(r.state == "serving" for r in reps)):
        failures.append("replicas never reached serving: " +
                        str([(r.rid, r.state) for r in reps]))
    tk.must_query(ANALYTIC)                  # warm compile

    # --- anti-vacuity: analytics ARE replica-pinned -------------------
    if not _wait_routed_above(_route_counts()["replica"] - 1, tk):
        failures.append("no analytic statement was replica-routed "
                        "(gate would be vacuous)")

    # --- analyst threads (run through every chaos phase) --------------
    an_stop = threading.Event()
    an_runs = [0]
    an_errs = []

    def analyst(i):
        s = tk.new_session()
        while not an_stop.is_set():
            try:
                s.must_query(ANALYTIC)
                an_runs[0] += 1
            except Exception as e:            # noqa: BLE001
                an_errs.append(f"{type(e).__name__}: {str(e)[:160]}")
                return
    analysts = [threading.Thread(target=analyst, args=(i,),
                                 daemon=True) for i in range(2)]
    for t in analysts:
        t.start()

    # background write stream during chaos phases
    chaos_stop = threading.Event()
    chaos_errs = [0]

    def chaos_writer():
        s = tk.new_session()
        seq = 50_000_000
        while not chaos_stop.is_set():
            seq += 1
            try:
                s.must_exec(f"insert into lines values ({seq}, "
                            f"{seq % 7}, {seq % 1000}, 'c')")
            except Exception:                 # noqa: BLE001
                chaos_errs[0] += 1
            chaos_stop.wait(0.002)
    cw = threading.Thread(target=chaos_writer, daemon=True)
    cw.start()

    # --- feed error bursts at EVERY registered replica seam -----------
    burst_s = 0.3 if quick else 0.6
    for site in REPLICA_SITES:
        failpoint.enable(site, "prob:0.3->error")
        time.sleep(burst_s)
        failpoint.disable(site)
        # the fabric must recover to serving-and-routed after the burst
        if not _wait(lambda: any(r.state == "serving" for r in reps)):
            failures.append(f"no serving replica after burst at "
                            f"{site}")
        if not _wait_routed_above(_route_counts()["replica"], tk):
            failures.append(f"no replica-routed statement after "
                            f"burst at {site}")
    print(f"# bursts: {len(REPLICA_SITES)} seams x {burst_s}s, "
          f"routes={_route_counts()}", file=out)

    # --- kill each serving replica in rotation ------------------------
    kills = 0
    for rep in list(reps):
        if not _wait(lambda: rep.state == "serving"):
            failures.append(f"replica {rep.rid} not serving before "
                            "kill")
            continue
        if not _wait_routed_above(_route_counts()["replica"], tk):
            failures.append(f"anti-vacuity: no replica-routed "
                            f"statement before killing {rep.rid}")
        pre = rep.reprovisions
        dom.replicas.kill(rep.rid)
        kills += 1
        if not _wait(lambda: rep.state == "serving" and
                     rep.reprovisions > pre):
            failures.append(
                f"replica {rep.rid} never reprovisioned to serving "
                f"(state={rep.state} reprovisions={rep.reprovisions})")
        if not _wait_routed_above(_route_counts()["replica"], tk):
            failures.append(f"anti-vacuity: no replica-routed "
                            f"statement after killing {rep.rid}")
    print(f"# kills: {kills} rotations, "
          f"reprovisions={[r.reprovisions for r in reps]}, "
          f"routes={_route_counts()}", file=out)
    chaos_stop.set()
    cw.join(timeout=30)

    # --- isolation bracket: isolated OLTP, OLTP+analysts, isolated ----
    iso_threads = 8
    an_stop.set()
    for t in analysts:
        t.join(timeout=120)
    ops_iso1, e1 = oltp_cell(tk, n_orders, iso_threads, seconds,
                          out=out)
    an_stop = threading.Event()
    mixed_runs = [0]

    def mixed_analyst():
        s = tk.new_session()
        while not an_stop.is_set():
            try:
                s.must_query(ANALYTIC)
                mixed_runs[0] += 1
            except Exception as e:            # noqa: BLE001
                an_errs.append(f"{type(e).__name__}: {str(e)[:160]}")
                return
    ma = threading.Thread(target=mixed_analyst, daemon=True)
    ma.start()
    ops_mixed, e2 = oltp_cell(tk, n_orders, iso_threads, seconds,
                              stop_extra=an_stop, out=out)
    ma.join(timeout=120)
    ops_iso2, e3 = oltp_cell(tk, n_orders, iso_threads, seconds,
                          out=out)
    ops_iso = min(ops_iso1, ops_iso2)
    print(f"# isolation: [{ops_iso1:.0f}, {ops_iso2:.0f}] -> "
          f"{ops_mixed:.0f} ops/s under {mixed_runs[0]} replica-"
          f"pinned analytics ({an_runs[0]} during chaos)",
          file=out)
    if e1 or e2 or e3 or chaos_errs[0]:
        failures.append(f"query errors in workload: oltp {e1}+{e2}+"
                        f"{e3}, chaos writer {chaos_errs[0]}")
    if an_errs:
        failures.append(f"analyst errors (degradation must be "
                        f"transparent): {an_errs[:3]}")
    if (an_runs[0] == 0 or mixed_runs[0] == 0) and not quick:
        failures.append("an analyst thread never completed a run")
    if ops_mixed < ratio * ops_iso:
        failures.append(
            f"OLTP under replica-pinned analytics {ops_mixed:.0f} "
            f"ops/s < {ratio} x isolated {ops_iso:.0f} ops/s")

    # --- freshness SLA audit ------------------------------------------
    served_max = dom.metrics.get("replica_served_max_lag_ms", 0.0)
    if served_max > max_lag:
        failures.append(
            f"freshness SLA violated: a replica-served statement's "
            f"snapshot was {served_max:.0f}ms stale (> {max_lag}ms)")

    # --- quiesce: replica rows == leader rows -------------------------
    # the leader's committed rows, read on the leader: tk's session is
    # in resolved mode, where this select is replica-routed at a
    # watermark up to tidb_tpu_replica_max_lag_ms old (the reference's
    # gate reads it there, right after the writes stop, and then waits
    # for every mirror to equal that stale snapshot, which they have
    # already passed)
    leader_sess = tk.new_session()
    leader_sess.must_exec(
        "set @@tidb_tpu_analytic_read_mode = 'leader'")
    leader_rows = leader_sess.must_query(
        "select id, k, v, s from lines order by id").rows
    for rep in reps:
        ok = _wait(lambda: rep.sink.mirror_rows("test", "lines") ==
                   leader_rows)
        if not ok:
            failures.append(
                f"replica {rep.rid} rows != leader rows at quiesce "
                f"({len(rep.sink.mirror_rows('test', 'lines'))} vs "
                f"{len(leader_rows)})")
    resolved_rows = tk.must_query(ANALYTIC).rows
    if resolved_rows != leader_sess.must_query(ANALYTIC).rows:
        failures.append("resolved analytic rows != leader rows at "
                        "quiesce")

    # --- graceful close: no leaked workers ----------------------------
    dom.close()
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith(("cdc-__replica", "replica-"))]
    if leaked:
        failures.append(f"leaked fabric threads after close: {leaked}")

    routes = _route_counts()
    figures = {
        "device": str(dom.copr.device), "oltp_ops_mixed": ops_mixed,
        "oltp_ops_isolated": [ops_iso1, ops_iso2],
        "vs_isolated": ops_mixed / max(ops_iso, 1), "ratio_bound": ratio,
        "routes": routes, "kills": kills,
        "reprovisions": [r.reprovisions for r in reps],
        "served_max_lag_ms": served_max, "max_lag_ms": max_lag,
        "analyst_runs": an_runs[0] + mixed_runs[0],
        "sites": len(REPLICA_SITES)}
    if report is not None:
        report.update(figures)
    artifact_path = os.environ.get("REPLICA_SMOKE_WRITE_ARTIFACT")
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(figures, f, indent=1)
            f.write("\n")
        print(f"# artifact -> {artifact_path}", file=out)
    return failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    os.environ.setdefault("TIDB_TPU_MUTATION_CHECK", "0")
    os.environ.setdefault("TIDB_TPU_FRAGMENT_MIN_ROWS", "0")
    rep = {}
    failures = run(device=device_of(argv), quick="--quick" in argv,
                   report=rep)
    if failures:
        print("REPLICA SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    routes = rep["routes"]
    print(f"REPLICA SMOKE OK: {routes['replica']:.0f} replica-routed "
          f"/ {routes['leader_fallback']:.0f} fallback / "
          f"{routes['degraded_midstmt']:.0f} mid-stmt degrades, "
          f"0 query errors across {rep['kills']} kills + "
          f"{rep['sites']} seam bursts, served lag <= "
          f"{rep['served_max_lag_ms']:.0f}ms (SLA {rep['max_lag_ms']}ms), "
          f"replicas == leader at quiesce, OLTP holds "
          f"{100 * rep['vs_isolated']:.0f}% (floor {rep['ratio_bound']})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
