"""Backup smoke: kill -9 (failpoint CRASH) at EVERY registered BR seam
× concurrent write load, then resume and assert the restored domain is
row-identical to the source at the target ts (reference
scripts/backup_smoke.py). Every store — the parent's, and each child's
in its `python -c` — runs its coprocessor on the device the command
line names: the card by default, the host with --cpu.

The crash seams come from the failpoint-site registry
(tidb_tpu_torch/utils/failpoint_sites.BR_SITES — tpulint's
failpoint-site-registry rule keeps inject sites and this gate in
lock-step). Backup-side seams kill a child mid-BACKUP while writer
threads commit; re-running BACKUP against the same target resumes from
the manifest checkpoint and the finished artifact restores clean.
Restore-side seams kill a child mid-RESTORE into a durable target;
reopening the target re-enters the parked TYPE_RESTORE job
(resume_pending) and finishes it. Every recovered domain is checked:

  * LEDGER-verified row identity: the source's MVCC record ledger
    scanned AT the target ts (record KV decoded row by row) equals the
    restored domain's SQL-visible rows — snapshot restores at
    backup_ts, PITR at the exact UNTIL TS, full restores at the final
    resolved ts;
  * ``ADMIN CHECK TABLE`` passes on every restored table;
  * the restore job history reaches a TERMINAL synced state — never a
    live queue row;
  * a backup taken under a concurrent DDL storm restores a consistent
    schema (data matches the captured column set);
  * a truncated or bit-flipped chunk fails with the typed
    BackupChecksumMismatchError and the failed restore rolls back —
    the target keeps none of the job's tables.

Usage:  python -m tidb_tpu_torch.tools.backup_smoke [--cpu] [--quick]
Env:    BACKUP_SMOKE_TIMEOUT_S (240), BACKUP_SMOKE_ROWS (300)
Exit:   0 every seam recovered clean; 1 any violation.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from .gates import device_of

# the checkout's root: the children import the package from it
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ROWS = int(os.environ.get("BACKUP_SMOKE_ROWS", "300"))

# Backup-side seams: the child dies exporting; the parent reopens the
# SOURCE and re-runs BACKUP to the same target (checkpoint resume).
BACKUP_CASES = [
    ("backup-chunk", "br-backup-chunk"),
    ("manifest-write", "br-manifest-write"),
]
# Restore-side seams: the child dies importing/replaying; the parent
# reopens the TARGET and restart recovery finishes the job.
RESTORE_CASES = [
    ("restore-pre-swap", "br-restore-pre-swap"),
    ("restore-checkpoint", "br-restore-checkpoint"),
    ("restore-replay", "br-restore-replay"),
]

_BACKUP_CHILD = r"""
import os, sys, threading, time
sys.path.insert(0, {repo!r})
os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # lock-rank sanitizer armed
os.environ["TIDB_TPU_BR_CHUNK_ROWS"] = "64"
from tidb_tpu_torch.session import new_store, Session
from tidb_tpu_torch.utils import failpoint
dom = new_store({dd!r}, wal_sync=True, device={device!r})
s = Session(dom)
s.vars.current_db = "test"
s.execute("create table t (a int primary key, b int)")
s.execute("create table u (a int primary key, b int)")
vals = ",".join("(%d, %d)" % (i, i * 10) for i in range({rows}))
s.execute("insert into t values " + vals)
s.execute("insert into u values " + vals)
print("ACK-SETUP", flush=True)
stop = threading.Event()
def dml(tid):
    w = Session(dom)
    w.vars.current_db = "test"
    k = {rows} + 1000 * (tid + 1)
    while not stop.is_set():
        k += 1
        try:
            w.execute("insert into t values (%d, %d)" % (k, k * 10))
            w.execute("update t set b = b + 1 where a = %d" % (k,))
        except SystemExit:
            raise
        except Exception:
            pass        # txn conflict: retried next round
threads = [threading.Thread(target=dml, args=(i,), daemon=True)
           for i in range(2)]
for t in threads:
    t.start()
time.sleep(0.1)
failpoint.enable({fp!r}, "crash")
try:
    s.execute("backup database test to " + repr({bd!r}))
except SystemExit:
    raise
except Exception as e:
    print("ERR " + type(e).__name__ + ": " + str(e)[:200], flush=True)
stop.set()
print("SURVIVED", flush=True)
"""

_RESTORE_CHILD = r"""
import os, sys, threading, time
sys.path.insert(0, {repo!r})
os.environ["TIDB_TPU_BR_CHUNK_ROWS"] = "64"
from tidb_tpu_torch.session import new_store, Session
from tidb_tpu_torch.utils import failpoint
dom = new_store({dd!r}, wal_sync=True, device={device!r})
s = Session(dom)
s.vars.current_db = "test"
s.execute("create table w (a int primary key, b int)")
print("ACK-SETUP", flush=True)
stop = threading.Event()
def dml():
    w = Session(dom)
    w.vars.current_db = "test"
    k = 0
    while not stop.is_set():
        k += 1
        try:
            w.execute("insert into w values (%d, %d)" % (k, k))
        except SystemExit:
            raise
        except Exception:
            pass
t = threading.Thread(target=dml, daemon=True)
t.start()
time.sleep(0.05)
failpoint.enable({fp!r}, "crash")
try:
    s.execute("restore database test from " + repr({bd!r}))
except SystemExit:
    raise
except Exception as e:
    print("ERR " + type(e).__name__ + ": " + str(e)[:200], flush=True)
stop.set()
print("SURVIVED", flush=True)
"""


def _run_child(template, dd, bd, fp, timeout, device):
    script = template.format(repo=_REPO, dd=dd, bd=bd, fp=fp, rows=ROWS,
                             device=device)
    env = dict(os.environ)
    env["TIDB_TPU_BR_CHUNK_ROWS"] = "64"
    return subprocess.run([sys.executable, "-c", script],
                          capture_output=True, timeout=timeout, env=env)


def ledger_rows(dom, table_id, ncols, ts):
    """The MVCC record ledger AT ts, decoded row by row — the source
    of truth a restore must reproduce."""
    from tidb_tpu_torch.codec import decode_row_value
    from tidb_tpu_torch.codec.tablecodec import record_prefix
    pref = record_prefix(table_id)
    out = []
    for _k, raw in dom.storage.mvcc.scan(pref, pref + b"\xff" * 9, ts):
        if raw:
            out.append(tuple(d.val for d in
                             decode_row_value(raw)[:ncols]))
    return sorted(out)


def sql_rows(sess, table):
    return sorted(tuple(r) for r in
                  sess.execute(f"select * from {table}").rows)


def _check_restored(sess, dom, failures, label, expected_by_table):
    for tname, expected in expected_by_table.items():
        got = sql_rows(sess, tname)
        if got != expected:
            failures.append(
                f"{label}: table {tname} diverged from the source "
                f"ledger ({len(got)} vs {len(expected)} rows; first "
                f"diff {next((a, b) for a, b in zip(got, expected) if a != b) if got and expected else 'n/a'})")
        try:
            sess.execute(f"admin check table {tname}")
        except Exception as e:                      # noqa: BLE001
            failures.append(f"{label}: ADMIN CHECK TABLE {tname}: {e}")
    live = [j for j in dom.ddl_jobs.list_jobs()
            if j.state not in ("synced", "cancelled")]
    if live:
        failures.append(f"{label}: live jobs after restart: "
                        f"{[(j.id, j.state) for j in live]}")


def backup_seam_case(label, fp, tmp, timeout, failures, device):
    """Kill mid-BACKUP; the rerun resumes from the manifest checkpoint
    and the finished artifact restores ledger-identical at backup_ts."""
    from tidb_tpu_torch.session import Session, new_store
    dd = os.path.join(tmp, f"src_{label}")
    bd = os.path.join(tmp, f"bk_{label}")
    os.makedirs(bd, exist_ok=True)
    r = _run_child(_BACKUP_CHILD, dd, bd, fp, timeout, device)
    out = r.stdout.decode()
    if "ACK-SETUP" not in out:
        failures.append(f"{label}: child setup failed: "
                        f"{r.stderr.decode()[-300:]}")
        return
    if r.returncode != 137 or "SURVIVED" in out:
        failures.append(f"{label}: crash failpoint did not fire "
                        f"(rc={r.returncode}, out={out[-200:]!r})")
        return
    src = new_store(dd, device=device)
    s = Session(src)
    s.vars.current_db = "test"
    s.execute(f"backup database test to '{bd}'")     # checkpoint resume
    with open(os.path.join(bd, "backupmeta.json")) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        failures.append(f"{label}: resumed backup left an incomplete "
                        f"manifest")
        return
    bts = int(manifest["backup_ts"])
    ischema = src.infoschema()
    expected = {
        t: ledger_rows(src, ischema.table_by_name("test", t).id, 2, bts)
        for t in ("t", "u")}
    dst = new_store(device=device)
    d = Session(dst)
    d.vars.current_db = "test"
    d.execute(f"restore database test from '{bd}'")
    _check_restored(d, dst, failures, label, expected)
    src.storage.mvcc.wal.close()


def make_backup_with_log(tmp, device):
    """A durable source with snapshot + log backup + post-snapshot
    writes: returns (bd, mid_ts, expected_mid, expected_full)."""
    from tidb_tpu_torch.session import Session, new_store
    src = new_store(device=device)
    s = Session(src)
    # pad the global id sequence: restore preserves SOURCE table ids
    # (log replay keys embed them), and the restore-seam children
    # allocate low ids for their own writer tables first
    s.vars.current_db = "test"
    s.execute("create database pad")
    s.execute("use pad")
    for i in range(8):
        s.execute(f"create table p{i} (a int primary key)")
    s.execute("use test")
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values " + ",".join(
        "(%d, %d)" % (i, i * 10) for i in range(ROWS)))
    bd = os.path.join(tmp, "bk_log")
    os.makedirs(bd, exist_ok=True)
    feed = src.cdc.create(
        "lb", f"logbackup://{bd}/log/backup.log", auto_start=False)
    feed._attach()
    feed.poll_once()
    s.execute(f"backup database test to '{bd}'")
    for i in range(ROWS, ROWS + 100):
        s.execute("insert into t values (%d, %d)" % (i, i * 10))
    s.execute("delete from t where a < 10")
    feed.poll_once()
    mid_ts = src.storage.oracle.get_ts()
    for i in range(ROWS + 100, ROWS + 150):
        s.execute("insert into t values (%d, %d)" % (i, i * 10))
    s.execute("update t set b = -1 where a = %d" % (ROWS,))
    feed.poll_once()
    feed.sink.close()
    tid = src.infoschema().table_by_name("test", "t").id
    expected_mid = ledger_rows(src, tid, 2, mid_ts)
    expected_full = ledger_rows(src, tid, 2,
                                src.storage.current_ts())
    return bd, mid_ts, expected_mid, expected_full


def restore_seam_case(label, fp, bd, expected_full, tmp, timeout,
                      failures, device):
    """Kill mid-RESTORE into a durable target; reopening the target
    resumes the parked job to completion."""
    from tidb_tpu_torch.session import Session, new_store
    dd = os.path.join(tmp, f"dst_{label}")
    r = _run_child(_RESTORE_CHILD, dd, bd, fp, timeout, device)
    out = r.stdout.decode()
    if "ACK-SETUP" not in out:
        failures.append(f"{label}: child setup failed: "
                        f"{r.stderr.decode()[-300:]}")
        return
    if r.returncode != 137 or "SURVIVED" in out:
        failures.append(f"{label}: crash failpoint did not fire "
                        f"(rc={r.returncode}, out={out[-200:]!r})")
        return
    os.environ["TIDB_TPU_BR_CHUNK_ROWS"] = "64"
    try:
        dst = new_store(dd, device=device)  # resume_pending finishes it
    finally:
        os.environ.pop("TIDB_TPU_BR_CHUNK_ROWS", None)
    d = Session(dst)
    d.vars.current_db = "test"
    _check_restored(d, dst, failures, label, {"t": expected_full})
    jobs = [(j.type, j.state) for j in dst.ddl_jobs.list_jobs()
            if j.type == "restore"]
    if ("restore", "synced") not in jobs:
        failures.append(f"{label}: no synced restore job after "
                        f"restart: {jobs}")
    dst.storage.mvcc.wal.close()


def pitr_case(bd, mid_ts, expected_mid, failures, device):
    """UNTIL TS lands on the exact commit prefix of the log."""
    from tidb_tpu_torch.session import Session, new_store
    dst = new_store(device=device)
    d = Session(dst)
    d.vars.current_db = "test"
    d.execute(f"restore database test from '{bd}' until ts {mid_ts}")
    _check_restored(d, dst, failures, "pitr", {"t": expected_mid})


def ddl_storm_case(tmp, failures, device):
    """BACKUP racing a DDL storm + writers: whatever schema the export
    captured, the restore is self-consistent and ADMIN CHECK clean."""
    from tidb_tpu_torch.session import Session, new_store
    src = new_store(device=device)
    s = Session(src)
    s.vars.current_db = "test"
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values " + ",".join(
        "(%d, %d)" % (i, i * 10) for i in range(ROWS)))
    stop = threading.Event()

    def storm():
        w = Session(src)
        w.vars.current_db = "test"
        i = 0
        while not stop.is_set():
            i += 1
            try:
                w.execute(f"alter table t add column c{i} int")
                w.execute(f"create table storm{i} (a int primary key)")
                w.execute(f"insert into storm{i} values (1)")
                w.execute(f"alter table t drop column c{i}")
                if i % 2 == 0:
                    w.execute(f"drop table storm{i}")
            except SystemExit:
                raise
            except Exception:
                pass

    th = threading.Thread(target=storm, daemon=True)
    th.start()
    bd = os.path.join(tmp, "bk_storm")
    os.makedirs(bd, exist_ok=True)
    try:
        s.execute(f"backup database test to '{bd}'")
    finally:
        stop.set()
        th.join(timeout=10)
    dst = new_store(device=device)
    d = Session(dst)
    d.vars.current_db = "test"
    d.execute(f"restore database test from '{bd}'")
    with open(os.path.join(bd, "backupmeta.json")) as f:
        manifest = json.load(f)
    from tidb_tpu_torch.models.schema import TableInfo
    for e in manifest["tables"]:
        tname = e["table"]["name"]
        ncols = len(TableInfo.from_json(e["table"]).public_columns())
        rows = d.execute(f"select * from {tname}").rows
        if rows and len(rows[0]) != ncols:
            failures.append(f"ddl-storm: {tname} width {len(rows[0])} "
                            f"!= manifest schema width {ncols}")
        try:
            d.execute(f"admin check table {tname}")
        except Exception as ex:                     # noqa: BLE001
            failures.append(f"ddl-storm: ADMIN CHECK {tname}: {ex}")
    # the snapshot rows survived whatever the storm did to the schema
    n = d.execute("select count(*) from t").rows[0][0]
    if n != ROWS:
        failures.append(f"ddl-storm: t has {n} rows, expected {ROWS}")


def corruption_case(tmp, failures, device):
    """Typed rejection: bit-flip and truncation both fail with
    BackupChecksumMismatchError and roll the restore back."""
    from tidb_tpu_torch.errors import BackupChecksumMismatchError
    from tidb_tpu_torch.session import Session, new_store
    src = new_store(device=device)
    s = Session(src)
    s.vars.current_db = "test"
    s.execute("create table t (a int primary key, b varchar(8))")
    s.execute("insert into t values (1,'a'),(2,'b')")
    bd = os.path.join(tmp, "bk_corrupt")
    os.makedirs(bd, exist_ok=True)
    s.execute(f"backup database test to '{bd}'")
    chunk = glob.glob(os.path.join(bd, "*.chunk000.npz"))[0]
    with open(chunk, "rb") as f:
        raw = f.read()
    for kind, mutant in (("bit-flip", raw[:40] + bytes([raw[40] ^ 1])
                          + raw[41:]),
                         ("truncate", raw[:len(raw) // 2])):
        with open(chunk, "wb") as f:
            f.write(mutant)
        dst = new_store(device=device)
        d = Session(dst)
        d.vars.current_db = "test"
        try:
            d.execute(f"restore database test from '{bd}'")
            failures.append(f"corruption/{kind}: restore of a damaged "
                            f"chunk succeeded")
        except BackupChecksumMismatchError:
            pass
        except Exception as e:                      # noqa: BLE001
            failures.append(f"corruption/{kind}: wrong error type "
                            f"{type(e).__name__}: {e}")
        left = dst.infoschema().tables_in_schema("test")
        if left:
            failures.append(f"corruption/{kind}: rollback left tables "
                            f"{[t.name for t in left]}")
    with open(chunk, "wb") as f:
        f.write(raw)


def run(device="cuda", quick=False, out=sys.stderr, report=None):
    """-> list of failure strings. report, when a dict, receives the
    seams killed and each case's seconds."""
    timeout = float(os.environ.get("BACKUP_SMOKE_TIMEOUT_S", "240"))
    failures: list = []

    # the registry is the seam source of truth: every BR seam this
    # gate kills must be registered, and every registered BR seam must
    # be killed (tpulint enforces the inject-site side)
    from tidb_tpu_torch.utils.failpoint_sites import BR_SITES, known_sites
    killed = [fp for _l, fp in BACKUP_CASES + RESTORE_CASES]
    missing = [fp for fp in killed if fp not in known_sites()]
    if missing:
        return [f"unregistered seams {missing}"]
    uncovered = [s for s in BR_SITES if s not in killed]
    if uncovered:
        return [f"registry BR seams never killed: {uncovered}"]

    backup_cases = BACKUP_CASES[:1] if quick else BACKUP_CASES
    restore_cases = RESTORE_CASES[:2] if quick else RESTORE_CASES

    with tempfile.TemporaryDirectory(prefix="backup_smoke_") as tmp:
        for label, fp in backup_cases:
            t0 = time.time()
            backup_seam_case(label, fp, tmp, timeout, failures, device)
            print(f"# {label}: crashed rc=137, resumed backup, "
                  f"restore ledger-identical "
                  f"({time.time() - t0:.1f}s)", file=out)

        t0 = time.time()
        bd, mid_ts, expected_mid, expected_full = make_backup_with_log(
            tmp, device)
        print(f"# log-backup artifact built ({time.time() - t0:.1f}s)",
              file=out)
        for label, fp in restore_cases:
            t0 = time.time()
            restore_seam_case(label, fp, bd, expected_full, tmp,
                              timeout, failures, device)
            print(f"# {label}: crashed rc=137, resume_pending finished "
                  f"the restore ({time.time() - t0:.1f}s)",
                  file=out)

        t0 = time.time()
        pitr_case(bd, mid_ts, expected_mid, failures, device)
        print(f"# pitr: UNTIL TS {mid_ts} ledger-identical "
              f"({time.time() - t0:.1f}s)", file=out)

        if not quick:
            t0 = time.time()
            ddl_storm_case(tmp, failures, device)
            print(f"# ddl-storm: consistent schema restored "
                  f"({time.time() - t0:.1f}s)", file=out)

        t0 = time.time()
        corruption_case(tmp, failures, device)
        print(f"# corruption: typed rejection + rollback "
              f"({time.time() - t0:.1f}s)", file=out)

    if report is not None:
        report.update(device=device, backup_seams=[fp for _l, fp in
                                                   backup_cases],
                      restore_seams=[fp for _l, fp in restore_cases])
    return failures


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ.setdefault("TIDB_TPU_LOCKRANK", "1")   # sanitizer armed
    rep = {}
    failures = run(device=device_of(argv), quick="--quick" in argv,
                   report=rep)
    if failures:
        print("BACKUP SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    n = len(rep["backup_seams"]) + len(rep["restore_seams"])
    print(f"BACKUP SMOKE OK: {n} kill-9 seams × concurrent writes — "
          "every backup resumed from its manifest checkpoint, every "
          "restore job finished at restart, snapshot/PITR/full targets "
          "ledger-identical to the source at the target ts, ADMIN "
          "CHECK TABLE clean, corrupt chunks rejected with the typed "
          "error", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
