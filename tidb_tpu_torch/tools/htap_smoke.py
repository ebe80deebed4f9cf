"""HTAP smoke: the incremental-HTAP gate (reference
scripts/htap_smoke.py).

A CH-benchmark-shaped slice — TPC-H tables under a concurrent OLTP
write stream (lineitem inserts + orders point selects) with Q1
analysts, all analytic statements in resolved read mode
(tidb_tpu_analytic_read_mode='resolved') — must hold four properties:

  1. ZERO DIRTY-OVERLAY ROUTINGS — committed-data analytic reads
     snapshot at the resolved-ts floor and never take the
     fused_pipeline_dirty_overlay rescan path, even when issued
     inside an open write transaction. A leader-mode control phase
     first proves the instrument still fires (anti-vacuity), and its
     routings are excluded from the gate.
  2. OLTP ISOLATION — point-op throughput with concurrent Q1 analysts
     holds HTAP_SMOKE_RATIO of the isolated rate (default 0.8 on
     >= 4 cores; 0.5 on smaller boxes where one analyst is
     legitimately half the machine — same bracketing + floor rationale
     as tools/oltp_smoke.py). The bound is the reference's on either
     device.
  3. REPLICA == LEADER AT QUIESCE — after the load drains, a
     resolved-mode Q1 returns rows identical to a leader-path Q1 (the
     floor is current once nothing holds it down).
  4. DELTA MAINTENANCE ENGAGED — the write stream was folded into the
     device-resident buffers incrementally (delta_apply applied > 0),
     not served by invalidate-and-reupload.

With HTAP_SMOKE_WRITE_ARTIFACT set, writes the run's figures (routing
+ delta stats) as JSON to that path.

Usage:  python -m tidb_tpu_torch.tools.htap_smoke [--cpu] [--quick]
Env:    HTAP_SMOKE_SECONDS (4; --quick forces 1.5), HTAP_SMOKE_SF
        (0.05; --quick 0.02), HTAP_SMOKE_RATIO (0.8 if cores>=4 else
        0.5), HTAP_SMOKE_WRITE_ARTIFACT (path)
Exit:   0 all gates pass; 1 otherwise.
"""
from __future__ import annotations

import json
import os
import random
import sys
import threading
import time

from .gates import device_of


def _routing(dom):
    keys = ("fused_pipeline_hit", "fused_pipeline_mpp_hit",
            "fused_pipeline_dirty_overlay", "fused_pipeline_fallback",
            "copr_device_exec", "copr_host_exec")
    return {k: dom.metrics.get(k, 0) for k in keys}


def _delta_stats():
    from tidb_tpu_torch.utils import metrics as mu
    return {
        "applied": mu.DELTA_APPLY.labels("applied").value,
        "advanced": mu.DELTA_APPLY.labels("advanced").value,
        "compacted": mu.DELTA_APPLY.labels("compacted").value,
        "fell_back_full_upload":
            mu.DELTA_APPLY.labels("fell_back_full_upload").value,
        "delta_apply_bytes": mu.DELTA_APPLY_BYTES.labels().value,
        "reupload_avoided_bytes":
            mu.DELTA_REUPLOAD_AVOIDED_BYTES.labels().value,
    }


def _insert_sql(base):
    """One committed lineitem append (a synthetic CH new-order line)."""
    return ("insert into lineitem values "
            f"({base % 150000 + 1}, {base % 2000 + 1}, "
            f"{base % 100 + 1}, 7, {base % 40 + 1}, "
            f"{(base % 900) + 100}.00, 0.0{base % 9}, 0.0{base % 7}, "
            "'N', 'O', date '1998-06-02', date '1998-06-10', "
            "date '1998-06-20', 'DELIVER IN PERSON', 'TRUCK', 'smoke')")


def oltp_cell(tk, n_orders, nthreads, seconds, stop_extra=None,
              out=sys.stderr):
    """Mixed point-select + lineitem-insert cell -> (ops_s, errors)."""
    stop = threading.Event()
    counts = [0] * nthreads
    errs = [0] * nthreads

    def worker(i):
        s = tk.new_session()
        r = random.Random(i)
        seq = i * 1_000_000
        while not stop.is_set():
            try:
                if r.random() < 0.15:
                    seq += 1
                    s.must_exec(_insert_sql(seq))
                else:
                    s.must_query(
                        "select o_totalprice from orders where "
                        f"o_orderkey = {r.randrange(n_orders) + 1}")
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


def run(device="cuda", quick=False, out=sys.stderr, report=None):
    """-> list of failure strings. report, when a dict, receives the
    run's figures."""
    seconds = 1.5 if quick else float(
        os.environ.get("HTAP_SMOKE_SECONDS", "4"))
    sf = float(os.environ.get("HTAP_SMOKE_SF",
                              "0.02" if quick else "0.05"))
    cores = os.cpu_count() or 2
    ratio = float(os.environ.get(
        "HTAP_SMOKE_RATIO", "0.8" if cores >= 4 else "0.5"))

    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.bench.tpch import load_tpch, ALL_QUERIES

    failures = []
    tk = TestKit(device=device)
    load_tpch(tk, sf=sf, seed=42)
    n_orders = tk.must_query(
        "select count(*) from orders").rows[0][0]
    q1 = ALL_QUERIES["q1"]
    tk.must_query(q1)                       # warm compile, leader path

    # --- anti-vacuity control: leader mode still takes the overlay ----
    ctrl = tk.new_session()
    ctrl.must_exec("begin")
    ctrl.must_exec(_insert_sql(99_000_000))
    ctrl.must_query(q1)                     # in-txn leader analytic
    ctrl.must_exec("commit")
    overlay_ctrl = _routing(tk.domain)["fused_pipeline_dirty_overlay"]
    if overlay_ctrl <= 0:
        failures.append("leader-mode control never routed "
                        "dirty_overlay — the gate would be vacuous")
    print(f"# control: leader in-txn Q1 -> {overlay_ctrl} "
          "dirty_overlay routings", file=out)

    # --- resolved mode for every analytic statement from here on ------
    tk.must_exec(
        "set @@global.tidb_tpu_analytic_read_mode = 'resolved'")
    tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
    overlay_base = _routing(tk.domain)["fused_pipeline_dirty_overlay"]

    # --- isolation bracket: isolated OLTP, OLTP+Q1, isolated again ----
    iso_threads = 8
    iso_secs = 3 * seconds
    ops_iso1, e1 = oltp_cell(tk, n_orders, iso_threads, iso_secs,
                          out=out)
    q1_stop = threading.Event()
    q1_runs = [0]
    mixed_runs = [0]

    def analyst():
        s = tk.new_session()
        while not q1_stop.is_set():
            s.must_query(q1)
            q1_runs[0] += 1

    def mixed_writer():
        # the CH shape that used to force the dirty-overlay rescan:
        # analytics INSIDE an open write transaction. Throttled to a
        # background cadence — the isolation gate is "under ONE
        # concurrent Q1" (the analyst above); this thread exists to
        # prove the in-txn shape routes resolved, not to double the
        # analytic load on a 2-core box
        s = tk.new_session()
        seq = 50_000_000
        while not q1_stop.is_set():
            seq += 1
            s.must_exec("begin")
            s.must_exec(_insert_sql(seq))
            s.must_query(q1)
            s.must_exec("commit")
            mixed_runs[0] += 1
            q1_stop.wait(1.0)
    at = threading.Thread(target=analyst, daemon=True)
    mt = threading.Thread(target=mixed_writer, daemon=True)
    at.start()
    mt.start()
    ops_htap, e2 = oltp_cell(tk, n_orders, iso_threads, iso_secs,
                             stop_extra=q1_stop, out=out)
    at.join(timeout=120)
    mt.join(timeout=120)
    ops_iso2, e3 = oltp_cell(tk, n_orders, iso_threads, iso_secs,
                          out=out)
    ops_iso = min(ops_iso1, ops_iso2)
    print(f"# isolation: [{ops_iso1:.0f}, {ops_iso2:.0f}] -> "
          f"{ops_htap:.0f} ops/s under {q1_runs[0]} Q1 + "
          f"{mixed_runs[0]} in-txn Q1 runs", file=out)
    if e1 or e2 or e3:
        failures.append(f"errors in workload: {e1}+{e2}+{e3}")
    if (q1_runs[0] == 0 or mixed_runs[0] == 0) and not quick:
        failures.append("an analyst thread never completed a run")
    if ops_htap < ratio * ops_iso:
        failures.append(
            f"OLTP under Q1 {ops_htap:.0f} ops/s < {ratio} x "
            f"isolated {ops_iso:.0f} ops/s")

    # --- gate 1: zero dirty-overlay routings in resolved mode ---------
    routing = _routing(tk.domain)
    overlay_resolved = routing["fused_pipeline_dirty_overlay"] - \
        overlay_base
    if overlay_resolved != 0:
        failures.append(
            f"{overlay_resolved} dirty_overlay routings in resolved "
            "mode (committed-data reads must snapshot the resolved "
            "floor)")

    # --- gate 3: replica == leader at quiesce -------------------------
    resolved_rows = tk.must_query(q1).rows
    leader = tk.new_session()
    leader.must_exec("set @@tidb_tpu_analytic_read_mode = 'leader'")
    leader_rows = leader.must_query(q1).rows
    if resolved_rows != leader_rows:
        failures.append("resolved-mode Q1 rows != leader-path rows "
                        "at quiesce")

    # --- gate 4: delta maintenance actually served the stream ---------
    delta = _delta_stats()
    if delta["applied"] <= 0:
        failures.append("delta_apply_total{outcome=applied} == 0: "
                        "the write stream was never folded "
                        "incrementally")
    print(f"# delta: {delta}", file=out)
    print(f"# routing: {routing}", file=out)

    figures = {
        "device": str(tk.domain.copr.device), "sf": sf,
        "oltp_ops_under_q1": ops_htap, "oltp_ops_isolated":
        [ops_iso1, ops_iso2], "vs_isolated": ops_htap / max(ops_iso, 1),
        "ratio_bound": ratio, "analytic_read_mode": "resolved",
        "routing": routing, "dirty_overlay_control": overlay_ctrl,
        "dirty_overlay_resolved_mode": overlay_resolved,
        "q1_runs": q1_runs[0], "in_txn_q1_runs": mixed_runs[0],
        "delta": delta}
    if report is not None:
        report.update(figures)
    artifact_path = os.environ.get("HTAP_SMOKE_WRITE_ARTIFACT")
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
    # analytics on the device path regardless of table size (the
    # oltp_smoke rationale)
    os.environ.setdefault("TIDB_TPU_FRAGMENT_MIN_ROWS", "0")
    rep = {}
    failures = run(device=device_of(argv), quick="--quick" in argv,
                   report=rep)
    if failures:
        print("HTAP SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    delta = rep["delta"]
    print(f"HTAP SMOKE OK: 0 dirty_overlay routings in resolved mode "
          f"({rep['dirty_overlay_control']} in the leader control), OLTP "
          f"holds {100 * rep['vs_isolated']:.0f}% under concurrent "
          f"Q1 (floor {rep['ratio_bound']}), replica == leader at "
          f"quiesce, {delta['applied']:.0f} delta folds "
          f"({delta['delta_apply_bytes']:.0f} B applied, "
          f"{delta['reupload_avoided_bytes']:.0f} B re-upload "
          "avoided)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
