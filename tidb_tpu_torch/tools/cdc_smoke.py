"""CDC smoke: OLTP write load x failpoint-injected kills/restarts of
the changefeed worker, then the table-sink mirror must equal the source
row-for-row, with a monotonic resolved-ts, checkpoint-ts resume losing
no event, and no event emitted above resolved-ts (reference
scripts/cdc_smoke.py). The store's coprocessor runs on the device the
command line names: the card by default, the host with --cpu.

Chaos applied while 2 writer threads hammer the store (inserts,
updates, deletes, multi-statement txns, all three commit modes, plus a
mid-load CREATE TABLE to exercise the DDL barrier):

  * error-injection rounds: the ``cdc-emit``/``cdc-poll`` failpoints
    fire probabilistically inside the worker loop — the feed must ride
    them through the classified-backoff error state and recover;
  * hard worker kills: the worker thread is stopped without a final
    flush and the feed object dropped, then re-created from the
    PERSISTED checkpoint file (the domain-restart resume path: fresh
    mirror, fresh contract checker, full catch-up + exactly-once
    re-apply).

Correctness gates:

  * every sink delivery runs the in-sink contract checker (ordering,
    emission <= next resolved, monotonic resolved) — a violation fails
    the feed, which fails the smoke;
  * resolved-ts samples per worker incarnation must be non-decreasing;
  * after drain, ``SELECT *`` of every table matches the mirror
    row-for-row.

Usage:  python -m tidb_tpu_torch.tools.cdc_smoke [--cpu] [--quick]
Env:    CDC_SMOKE_SECONDS (load duration per phase, default 4)
Exit:   0 clean; 1 any violation.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

from .gates import device_of

TABLES = ("bank", "orders")


def _writer(dom, wid: int, stop: threading.Event, errors: list,
            counter: list):
    from tidb_tpu_torch.session import Session
    s = Session(dom)
    s.vars.current_db = "test"
    if wid % 2 == 0:
        s.execute("set @@tidb_txn_mode = 'pessimistic'")
    modes = [("set @@tidb_enable_1pc = 1", ""),
             ("set @@tidb_enable_1pc = 0",
              "set @@tidb_enable_async_commit = 1"),
             ("set @@tidb_enable_1pc = 0",
              "set @@tidb_enable_async_commit = 0")]
    i = 0
    base = wid * 1_000_000
    try:
        while not stop.is_set():
            i += 1
            for stmt in modes[i % 3]:
                if stmt:
                    s.execute(stmt)
            tbl = TABLES[i % len(TABLES)]
            k = base + i
            s.execute(f"insert into {tbl} values ({k}, {i}, 'w{wid}')")
            if i % 3 == 0:
                s.execute(f"update {tbl} set b = b + 1 "
                          f"where a = {base + max(1, i - 2)}")
            if i % 7 == 0:
                s.execute(f"delete from {tbl} "
                          f"where a = {base + max(1, i - 5)}")
            if i % 11 == 0:
                s.execute("begin")
                s.execute(f"insert into bank values ({k + 500000}, "
                          f"{i}, 'txn')")
                s.execute(f"insert into orders values ({k + 500000}, "
                          f"{i}, 'txn')")
                s.execute("commit")
            counter[wid] += 1
    except Exception as e:                      # noqa: BLE001
        errors.append(f"writer{wid}: {type(e).__name__}: {e}")


def _sample_resolved(feed, samples: list, violations: list,
                     stop: threading.Event):
    last = -1
    while not stop.is_set():
        r = feed.resolved
        if r < last:
            violations.append(
                f"resolved-ts went backwards within an incarnation: "
                f"{r} < {last}")
        last = r
        samples.append(r)
        time.sleep(0.02)


def _wait_mirror_equal(dom, sess, feed, timeout_s: float):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if feed.state == "failed":
            return f"feed failed: {feed.error}"
        try:
            ok = True
            for tbl in TABLES + ("late",):
                src = sess.execute(
                    f"select * from {tbl} order by 1").rows
                mir = feed.sink.mirror_rows("test", tbl)
                if src != mir:
                    ok = False
                    break
            if ok:
                return None
        except Exception:                       # noqa: BLE001
            pass                                # mirror mid-catchup
        time.sleep(0.1)
    return f"mirror never converged on {tbl}: " \
           f"src={len(src)} rows, mirror={len(mir)} rows"


def run(device="cuda", quick=False, out=sys.stderr, report=None):
    """-> list of failure strings. report, when a dict, receives the
    run's figures."""
    from tidb_tpu_torch.session import Session, new_store
    from tidb_tpu_torch.utils import failpoint
    load_s = float(os.environ.get("CDC_SMOKE_SECONDS", "4"))
    if quick:
        load_s = min(load_s, 2.0)
    failures: list = []
    violations: list = []
    with tempfile.TemporaryDirectory(prefix="cdc_smoke_") as dd:
        dom = new_store(dd, device=device)
        s = Session(dom)
        s.vars.current_db = "test"
        for tbl in TABLES:
            s.execute(f"create table {tbl} "
                      "(a bigint primary key, b bigint, c varchar(32))")
        s.execute("admin changefeed create smoke sink 'mirror://'")
        feed = dom.cdc.get("smoke")

        stop = threading.Event()
        werrs: list = []
        counts = [0, 0]
        writers = [threading.Thread(target=_writer,
                                    args=(dom, w, stop, werrs, counts),
                                    daemon=True) for w in (0, 1)]
        for w in writers:
            w.start()
        sample_stop = threading.Event()
        samples: list = []
        sampler = threading.Thread(
            target=_sample_resolved,
            args=(feed, samples, violations, sample_stop), daemon=True)
        sampler.start()
        restarts = 0

        # ---- phase 1: worker error bursts under load -----------------
        # deterministic bursts (nth:K = the next K hits fail) with a
        # recovery window after each: the feed must enter the error
        # state, back off, and return to normal with checkpoint
        # progress — a sustained per-emit failure rate would just pin
        # every poll into the retry budget
        bursts = 2 if quick else 4
        for b in range(bursts):
            failpoint.enable("cdc-emit", "nth:4->error")
            failpoint.enable("cdc-poll", "nth:2->error:generic")
            time.sleep(load_s / bursts / 2)
            failpoint.disable("cdc-emit")
            failpoint.disable("cdc-poll")
            time.sleep(load_s / bursts / 2)
        deadline = time.time() + 30
        while feed.state != "normal" and time.time() < deadline:
            time.sleep(0.05)
        if feed.state != "normal":
            failures.append(
                f"feed did not recover from error bursts: "
                f"state={feed.state} err={feed.error}")
        if feed.checkpoint_ts <= 0:
            failures.append("checkpoint made no progress in phase 1")

        # ---- phase 2: hard worker kills + checkpoint resume ----------
        kills = 1 if quick else 3
        for _ in range(kills):
            time.sleep(load_s / (kills + 1))
            sample_stop.set()
            sampler.join(2)
            # kill: stop the thread with NO final poll/flush, drop the
            # feed object entirely (its mirror dies with it)
            feed._stop.set()
            w = feed._worker
            if w is not None:
                w.join(5)
            feed._detach()
            dom.cdc.feeds.pop("smoke", None)
            restarts += 1
            # resurrect from the persisted checkpoint file
            dom.cdc.resume_persisted()
            feed = dom.cdc.get("smoke")
            if feed.checkpoint_ts <= 0:
                failures.append("restarted feed lost its checkpoint")
            sample_stop = threading.Event()
            samples = []
            sampler = threading.Thread(
                target=_sample_resolved,
                args=(feed, samples, violations, sample_stop),
                daemon=True)
            sampler.start()

        # mid-load DDL barrier: a table created while the feed runs
        s.execute("create table late "
                  "(a bigint primary key, b bigint, c varchar(32))")
        s.execute("insert into late values (1, 1, 'ddl')")
        time.sleep(load_s / 2)

        # ---- drain + verify ------------------------------------------
        stop.set()
        for w in writers:
            w.join(10)
        if werrs:
            failures.extend(werrs[:5])
        s.execute("insert into late values (2, 2, 'drain-marker')")
        err = _wait_mirror_equal(dom, s, feed, timeout_s=60)
        if err:
            failures.append(err)
        sample_stop.set()
        sampler.join(2)
        failures.extend(violations)
        if feed.state == "failed":
            failures.append(f"feed ended failed: {feed.error}")
        if feed.consecutive_errors and feed.state != "normal":
            failures.append(
                f"feed did not recover: state={feed.state} "
                f"err={feed.error}")
        # checkpoint persisted and consistent (stop the worker first so
        # it cannot advance between the file read and the compare)
        feed.stop()
        with open(os.path.join(dd, "cdc", "smoke.json"),
                  encoding="utf-8") as f:
            ckpt = json.load(f)
        if ckpt["checkpoint_ts"] != feed.checkpoint_ts:
            failures.append(
                f"persisted checkpoint {ckpt['checkpoint_ts']} != live "
                f"{feed.checkpoint_ts}")
        n_rows = sum(len(s.execute(f"select a from {t}").rows)
                     for t in TABLES + ("late",))
        dom.cdc.shutdown()
        dom.storage.mvcc.wal.close()

    print(f"# cdc_smoke: device={device} writer iterations="
          f"{sum(counts)} rows={n_rows} restarts={restarts}", file=out)
    if report is not None:
        report.update(device=device, writer_iterations=sum(counts),
                      rows=n_rows, restarts=restarts)
    return failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    rep = {}
    failures = run(device=device_of(argv), quick="--quick" in argv,
                   report=rep)
    if failures:
        print("CDC SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"CDC SMOKE OK: {rep['writer_iterations']} writer iterations, "
          f"{rep['rows']} source rows mirrored row-identically through "
          f"{rep['restarts']} hard worker kills + error-injection rounds; "
          "resolved-ts monotonic, checkpoint resume lossless, "
          "no emission above resolved-ts", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
