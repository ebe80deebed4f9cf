"""Backup/restore, PITR and the dump tool on tidb_tpu_torch, on the CPU:
the twins of tests/test_backup_restore.py (resolved-ts chunked
snapshots, the logbackup:// changefeed sink, RESTORE as a resumable
DDL job, the typed corruption surface) and tests/test_tools.py (the
object-storage seam, the legacy WAL-copy PITR, the CSV dump). Beside
them, the same SQL on the reference's TestKit and the port's: a backup
round trip whose manifests agree in tables, row counts and chunk
contents, and a PITR at a mid-stream ts, with equal rows."""
import glob
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from tidb_tpu_torch.session import new_store
from tidb_tpu_torch.testkit import TestKit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, failpoint, phase
    from tidb_tpu_torch.utils import metrics as mu
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


@pytest.fixture()
def tk():
    return TestKit(device="cpu")


def _bdir(tmp_path, name="bk"):
    d = str(tmp_path / name)
    os.makedirs(d, exist_ok=True)
    return d


def test_round_trip_identity_multichunk(tmp_path, monkeypatch):
    """Multi-chunk export (chunk_rows=128 over 500 rows) with dict
    strings + NULLs round-trips bit-exact; reruns against a complete
    target are no-ops; the vtable and metrics record the run."""
    monkeypatch.setenv("TIDB_TPU_BR_CHUNK_ROWS", "128")
    tk = TestKit(device="cpu")
    tk.must_exec("create table rt (id int primary key, v int, "
                 "s varchar(32), d decimal(10,2))")
    tk.must_exec("insert into rt values " + ",".join(
        f"({i},{i * 2},'s{i % 5}',{i}.25)" for i in range(1, 401)))
    tk.must_exec("insert into rt values (401,null,null,null)")
    tk.must_exec("create table rt2 (a int primary key, b varchar(8))")
    tk.must_exec("insert into rt2 values (1,'x'),(2,null)")
    d = _bdir(tmp_path)
    rs = tk.must_exec(f"backup database test to '{d}'")
    assert rs.affected == 2            # two tables exported
    chunks = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(d, "test.rt.chunk*.npz")))
    assert len(chunks) == 4            # 401 rows / 128 per chunk
    # re-run against the complete target: checkpointed, zero work
    assert tk.must_exec(f"backup database test to '{d}'").affected == 0
    from tidb_tpu_torch.utils.metrics import REGISTRY
    snap = REGISTRY.snapshot()
    assert snap['tidb_tpu_backup_total'
                '{phase="snapshot_run",outcome="ok"}'] == 2
    assert snap['tidb_tpu_backup_total'
                '{phase="snapshot_table",outcome="ok"}'] == 2
    assert snap['tidb_tpu_backup_total'
                '{phase="snapshot_table",outcome="skipped"}'] == 2
    # the source vtable shows the backup runs
    rows = tk.must_query(
        "select kind, phase, state from "
        "information_schema.tidb_backup_jobs").rows
    assert ("backup", "complete", "done") in rows

    tk2 = TestKit(device="cpu")
    rs = tk2.must_exec(f"restore database test from '{d}'")
    assert rs.affected == 403
    assert tk2.must_query("select count(*), sum(v) from rt").rows == \
        tk.must_query("select count(*), sum(v) from rt").rows
    assert tk2.must_query("select * from rt where id in (4,401) "
                          "order by id").rows == \
        [(4, 8, "s4", "4.25"), (401, None, None, None)]
    assert tk2.must_query("select * from rt2 order by a").rows == \
        [(1, "x"), (2, None)]
    tk2.must_exec("admin check table rt")
    # restored tables accept writes (id allocators fast-forwarded)
    tk2.must_exec("insert into rt2 values (3,'z')")
    assert tk2.must_query("select count(*) from rt2").rows == [(3,)]
    snap = REGISTRY.snapshot()
    assert snap['tidb_tpu_restore_rows{stat="imported"}'] == 403
    assert snap['tidb_tpu_backup_total'
                '{phase="restore_run",outcome="ok"}'] == 1
    rows = tk2.must_query(
        "select kind, phase, state, backup_ts from "
        "information_schema.tidb_backup_jobs").rows
    assert any(k == "restore" and p == "done" and s == "synced"
               and ts > 0 for k, p, s, ts in rows), rows


def test_pitr_restores_exact_mid_stream_ts(tmp_path):
    """Snapshot + logbackup:// changefeed; RESTORE ... UNTIL TS n lands
    on the exact commit prefix — later inserts/updates/deletes absent,
    earlier ones present — and a full restore replays everything."""
    tk = TestKit(device="cpu")
    tk.must_exec("create table t (id int primary key, v int)")
    tk.must_exec("insert into t values (1,10),(2,20)")
    d = _bdir(tmp_path)
    feed = tk.domain.cdc.create(
        "lb", f"logbackup://{d}/log/backup.log", auto_start=False)
    feed._attach()
    feed.poll_once()
    tk.must_exec(f"backup database test to '{d}'")
    tk.must_exec("insert into t values (3,30)")
    feed.poll_once()
    mid = tk.domain.storage.oracle.get_ts()
    tk.must_exec("insert into t values (4,40)")
    tk.must_exec("update t set v = 999 where id = 1")
    tk.must_exec("delete from t where id = 2")
    feed.poll_once()
    feed.sink.close()

    full = TestKit(device="cpu")
    full.must_exec(f"restore database test from '{d}'")
    assert full.must_query("select * from t order by id").rows == \
        tk.must_query("select * from t order by id").rows
    full.must_exec("admin check table t")

    pitr = TestKit(device="cpu")
    pitr.must_exec(f"restore database test from '{d}' until ts {mid}")
    assert pitr.must_query("select * from t order by id").rows == \
        [(1, 10), (2, 20), (3, 30)]
    pitr.must_exec("admin check table t")
    # replayed rows are index-consistent: point lookup via PK works
    assert pitr.must_query("select v from t where id = 3").rows == \
        [(30,)]


_CRASH_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
os.environ["TIDB_TPU_FAILPOINTS"] = "br-restore-checkpoint=crash"
os.environ["TIDB_TPU_BR_CHUNK_ROWS"] = "256"
from tidb_tpu_torch.session import new_store
from tidb_tpu_torch.testkit import TestKit
dom = new_store({dd!r}, device="cpu")
tk = TestKit(dom)
tk.must_exec("create table big (id int primary key, v int)")
for b in range(4):
    tk.must_exec("insert into big values " + ",".join(
        "(%d,%d)" % (i, i * 3) for i in range(b * 250, b * 250 + 250)))
tk.must_exec("backup database test to {bd!r}")
tk.must_exec("drop table big")
tk.must_exec("restore database test from {bd!r}")
print("UNREACHED", flush=True)
"""


def test_restore_resumes_after_kill9(tmp_path):
    """kill -9 at the first durable restore checkpoint: reopening the
    store re-enters the parked TYPE_RESTORE job (resume_pending) and
    finishes it — exact row count, no duplicates, job synced."""
    dd = str(tmp_path / "dd")
    bd = _bdir(tmp_path)
    script = _CRASH_CHILD.format(repo=REPO, dd=dd, bd=bd)
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, timeout=180)
    assert r.returncode == 137, r.stderr[-800:]
    assert b"UNREACHED" not in r.stdout
    os.environ["TIDB_TPU_BR_CHUNK_ROWS"] = "256"
    try:
        dom = new_store(dd, device="cpu")
    finally:
        os.environ.pop("TIDB_TPU_BR_CHUNK_ROWS", None)
    tk = TestKit(dom)
    assert tk.must_query(
        "select count(*), count(distinct id), sum(v) from big").rows \
        == [(1000, 1000, str(3 * sum(range(1000))))]
    tk.must_exec("admin check table big")
    rows = tk.must_query(
        "select phase, state from information_schema.tidb_backup_jobs "
        "where kind = 'restore'").rows
    assert ("done", "synced") in rows, rows


def test_corrupt_chunk_rejected_and_rolled_back(tmp_path):
    """A bit-flipped or truncated chunk fails with the typed
    BackupChecksumMismatchError — and the failed restore's rollback
    drops every table the job created (target left as it was)."""
    from tidb_tpu_torch.errors import BackupChecksumMismatchError
    tk = TestKit(device="cpu")
    tk.must_exec("create table c (id int primary key, v varchar(8))")
    tk.must_exec("insert into c values (1,'a'),(2,'b')")
    d = _bdir(tmp_path)
    tk.must_exec(f"backup database test to '{d}'")
    chunk = glob.glob(os.path.join(d, "*.chunk000.npz"))[0]
    raw = open(chunk, "rb").read()
    with open(chunk, "wb") as f:       # single flipped byte
        f.write(raw[:100] + bytes([raw[100] ^ 0xFF]) + raw[101:])
    tk2 = TestKit(device="cpu")
    e = tk2.exec_err(f"restore database test from '{d}'")
    assert isinstance(e, BackupChecksumMismatchError)
    assert e.code == 8161
    assert tk2.must_query("show tables").rows == []
    with open(chunk, "wb") as f:       # torn mid-object
        f.write(raw[:len(raw) // 2])
    e = tk2.exec_err(f"restore database test from '{d}'")
    assert isinstance(e, BackupChecksumMismatchError)
    assert tk2.must_query("show tables").rows == []
    # repaired artifact restores fine afterwards
    with open(chunk, "wb") as f:
        f.write(raw)
    tk2.must_exec(f"restore database test from '{d}'")
    assert tk2.must_query("select * from c order by id").rows == \
        [(1, "a"), (2, "b")]


def test_restore_typed_error_surface(tmp_path):
    """RestoreTargetNotEmptyError on a name collision;
    RestoreTsBelowBackupError when UNTIL TS predates the snapshot."""
    from tidb_tpu_torch.errors import (RestoreTargetNotEmptyError,
                                       RestoreTsBelowBackupError)
    tk = TestKit(device="cpu")
    tk.must_exec("create table e1 (id int primary key)")
    tk.must_exec("insert into e1 values (1)")
    d = _bdir(tmp_path)
    tk.must_exec(f"backup database test to '{d}'")
    busy = TestKit(device="cpu")
    busy.must_exec("create table e1 (id int primary key)")
    e = busy.exec_err(f"restore database test from '{d}'")
    assert isinstance(e, RestoreTargetNotEmptyError) and e.code == 8162
    fresh = TestKit(device="cpu")
    e = fresh.exec_err(f"restore database test from '{d}' until ts 1")
    assert isinstance(e, RestoreTsBelowBackupError) and e.code == 8163


def test_backup_during_ddl_storm_restores_consistent_schema(tmp_path):
    """Schema captured once at backup time: columns dropped before the
    export never leak into the manifest, and adds that postdate the
    captured plan surface as NULL — the restore target's schema always
    matches its data."""
    tk = TestKit(device="cpu")
    tk.must_exec("create table s1 (id int primary key, a int, b int)")
    tk.must_exec("insert into s1 values (1,10,100),(2,20,200)")
    tk.must_exec("alter table s1 drop column a")
    tk.must_exec("alter table s1 add column c varchar(8)")
    tk.must_exec("insert into s1 values (3,300,'x')")
    d = _bdir(tmp_path)
    tk.must_exec(f"backup database test to '{d}'")
    tk2 = TestKit(device="cpu")
    tk2.must_exec(f"restore database test from '{d}'")
    assert tk2.must_query("select * from s1 order by id").rows == \
        [(1, 100, None), (2, 200, None), (3, 300, "x")]
    tk2.must_exec("admin check table s1")
    # the restored table's live schema has the post-DDL column set
    cols = [r[0] for r in tk2.must_query("show columns from s1").rows]
    assert cols == ["id", "b", "c"]


def test_log_backup_torn_tail_replays_to_last_whole_txn(tmp_path):
    """Satellite (b): the log-backup file reuses the WAL2 frame format
    and WalWriter.valid_prefix() torn-tail discipline — a crash-torn
    tail is truncated on reopen and replay stops at the last whole
    txn, never a partial one."""
    from tidb_tpu_torch.br import logformat
    tk = TestKit(device="cpu")
    tk.must_exec("create table lt (id int primary key, v int)")
    d = _bdir(tmp_path)
    log = os.path.join(d, "log", "backup.log")
    feed = tk.domain.cdc.create(
        "lb", f"logbackup://{log}", auto_start=False)
    feed._attach()
    feed.poll_once()
    tk.must_exec(f"backup database test to '{d}'")
    tk.must_exec("insert into lt values (1,10)")
    tk.must_exec("insert into lt values (2,20)")
    feed.poll_once()
    feed.sink.close()
    whole = [r for r in logformat.scan(log) if r[0] == "txn"]
    assert len(whole) >= 2
    # simulate a crash mid-append: garbage + half a frame at the tail
    with open(log, "ab") as f:
        f.write(b"\x21\x00\x00\x00\xde\xad\xbe\xefWAL2torn")
    torn = [r for r in logformat.scan(log) if r[0] == "txn"]
    assert torn == whole               # scan stops at the torn tail
    # restore replays exactly the whole txns
    tk2 = TestKit(device="cpu")
    tk2.must_exec(f"restore database test from '{d}'")
    assert tk2.must_query("select * from lt order by id").rows == \
        [(1, 10), (2, 20)]
    # a reopened sink truncates the torn tail (valid_prefix) and
    # appends cleanly after it
    from tidb_tpu_torch.cdc.sinks import LogBackupSink
    s2 = LogBackupSink(log)
    assert s2.resume_ts() == feed.sink.check.last_resolved
    s2.flush_resolved(s2.resume_ts() + 1)
    s2.close()
    again = [r for r in logformat.scan(log) if r[0] == "txn"]
    assert again == whole


def test_backup_incomplete_target_and_mixed_dbset(tmp_path):
    """Restoring an incomplete backup fails cleanly; backing up a
    DIFFERENT database set into a finished target is refused with the
    typed BackupTargetExistsError."""
    from tidb_tpu_torch.errors import BackupTargetExistsError, TiDBError
    tk = TestKit(device="cpu")
    tk.must_exec("create table i1 (id int primary key)")
    d = _bdir(tmp_path)
    tk.must_exec(f"backup database test to '{d}'")
    mpath = os.path.join(d, "backupmeta.json")
    m = json.load(open(mpath))
    assert m["complete"] and int(m["version"]) >= 2
    assert m["backup_ts"] > 0
    # different-dbset reuse refused
    tk.must_exec("create database other")
    tk.must_exec("use other")
    tk.must_exec("create table o1 (id int primary key)")
    e = tk.exec_err(f"backup database other to '{d}'")
    assert isinstance(e, BackupTargetExistsError) and e.code == 8160
    # incomplete manifest -> restore refuses with a clear message
    m["complete"] = False
    json.dump(m, open(mpath, "w"))
    tk2 = TestKit(device="cpu")
    e = tk2.exec_err(f"restore database test from '{d}'")
    assert isinstance(e, TiDBError) and "incomplete" in str(e)


# ---- twins of tests/test_tools.py ---------------------------------------

def test_backup_restore_roundtrip(tk, tmp_path):
    tk.must_exec("create table br1 (id int primary key, v varchar(10), "
                 "d decimal(8,2))")
    tk.must_exec("insert into br1 values (1,'a',1.50),(2,'b',2.25),"
                 "(3,null,null)")
    tk.must_exec("delete from br1 where id = 2")
    tk.must_exec("create table br2 (x int)")
    tk.must_exec("insert into br2 values (42)")
    bpath = str(tmp_path / "bk")
    r = tk.must_exec(f"backup database test to '{bpath}'")
    assert r.affected >= 2
    assert os.path.exists(os.path.join(bpath, "backupmeta.json"))
    # destroy and restore
    tk.must_exec("drop table br1, br2")
    tk.must_exec(f"restore database test from '{bpath}'")
    tk.must_query("select * from br1 order by id").check([
        (1, "a", "1.50"), (3, None, None)])
    tk.must_query("select * from br2").check([(42,)])
    # restored tables accept writes (allocators, indexes intact)
    tk.must_exec("insert into br1 values (9,'z',9.99)")
    tk.must_query("select count(*) from br1").check([(3,)])


def test_backup_restore_via_object_storage(tk):
    """The objstore seam (reference pkg/objstore): BACKUP/RESTORE
    round-trip through an S3-style bucket — no filesystem path
    involved; every artifact is a whole-object put."""
    from tidb_tpu_torch.tools.objstore import _MEM_BUCKETS
    _MEM_BUCKETS.pop("brbkt", None)
    tk.must_exec("create table os1 (id int primary key, v varchar(10))")
    tk.must_exec("insert into os1 values (1,'a'),(2,'b')")
    tk.must_exec("backup database test to 's3://brbkt/snap'")
    objs = sorted(_MEM_BUCKETS["brbkt"])
    assert "snap/backupmeta.json" in objs, objs
    assert "snap/test.os1.chunk000.npz" in objs, objs
    tk2 = TestKit(device="cpu")
    tk2.must_exec("restore database test from 's3://brbkt/snap'")
    tk2.must_query("select * from os1 order by id").check(
        [(1, "a"), (2, "b")])


def test_objstore_backends_contract(tmp_path):
    """LocalStorage and MemS3Storage honor the same contract."""
    from tidb_tpu_torch.tools.objstore import open_storage
    for uri in (str(tmp_path / "loc"), "s3://contract/px"):
        st = open_storage(uri)
        st.write("a/b.bin", b"\x00\x01")
        st.write("a/c.txt", b"hey")
        assert st.exists("a/b.bin") and not st.exists("a/nope")
        assert st.read("a/b.bin") == b"\x00\x01"
        assert st.list("a/") == ["a/b.bin", "a/c.txt"]
        st.delete("a/c.txt")
        assert st.list("a/") == ["a/b.bin"]


def test_backup_checkpoint_skips_done(tk, tmp_path):
    tk.must_exec("create table ck (a int)")
    tk.must_exec("insert into ck values (1)")
    bpath = str(tmp_path / "bk2")
    r1 = tk.must_exec(f"backup database test to '{bpath}'")
    # second run: everything already in done-list
    r2 = tk.must_exec(f"backup database test to '{bpath}'")
    assert r2.affected == 0


def test_dump_csv(tk, tmp_path):
    from tidb_tpu_torch.tools.dump import export_table
    tk.must_exec("create table dmp (a int, s varchar(5))")
    tk.must_exec("insert into dmp values (1,'x'),(2,null)")
    out = str(tmp_path / "dump")
    n = export_table(tk.domain, "test", "dmp", out)
    assert n == 2
    files = os.listdir(out)
    assert any(f.endswith(".csv") for f in files)
    content = open(os.path.join(out, sorted(files)[0])).read()
    assert "a,s" in content and "1,x" in content


def test_pitr_log_backup_restore(tmp_path):
    """BACKUP LOG + RESTORE ... UNTIL TIMESTAMP (reference br/pkg/stream
    PITR): the commit WAL is the log; restore replays frames whose commit
    wallclock <= the target into a fresh store."""
    import time
    from tidb_tpu_torch.session import new_store, Session
    from tidb_tpu_torch.types.time_types import micros_to_str

    d1 = str(tmp_path / "src")
    bdir = str(tmp_path / "bk")
    dom = new_store(d1, device="cpu")
    s = Session(dom)
    s.vars.current_db = "test"
    s.execute("create table p (id int primary key, v varchar(8))")
    s.execute("insert into p values (1,'a')")
    time.sleep(0.05)
    mid = micros_to_str(int(time.time() * 1e6), 6)
    time.sleep(0.05)
    s.execute("insert into p values (2,'b')")
    s.execute("update p set v = 'aa' where id = 1")
    assert s.execute(f"backup log to '{bdir}'").affected > 0

    dom2 = new_store(str(tmp_path / "pitr"), device="cpu")
    s2 = Session(dom2)
    s2.vars.current_db = "test"
    s2.execute(f"restore database * from '{bdir}' "
               f"until timestamp '{mid}'")
    assert s2.execute("select * from p order by id").rows == [(1, "a")]

    dom3 = new_store(str(tmp_path / "full"), device="cpu")
    s3 = Session(dom3)
    s3.vars.current_db = "test"
    s3.execute(f"restore database * from '{bdir}' "
               f"until timestamp '2099-01-01'")
    assert s3.execute("select * from p order by id").rows == [
        (1, "aa"), (2, "b")]


# ---- the same SQL on the reference and the port -------------------------

def _kits():
    from tidb_tpu.testkit import TestKit as RefKit
    return [("ref", RefKit()), ("port", TestKit(device="cpu"))]


def _chunk_sums(d, entry):
    """Per chunk: its name, rows and the crc32 of every array in it but
    the insert timestamps (the two stores' oracles may differ)."""
    out = []
    for c in entry["chunks"]:
        with np.load(os.path.join(d, c["name"])) as z:
            sums = {k: zlib.crc32(np.ascontiguousarray(z[k]).tobytes())
                    for k in sorted(z.files) if k != "__insert_ts"}
        out.append((c["name"], c["rows"], sums))
    return out


def test_backup_round_trip_matches_reference(tmp_path, monkeypatch):
    """One workload, one backup each: the manifests agree in tables,
    row counts and chunk contents (paths and timestamps apart), and a
    restore of each into a fresh store gives equal rows."""
    monkeypatch.setenv("TIDB_TPU_BR_CHUNK_ROWS", "100")
    got = {}
    for name, kit in _kits():
        kit.must_exec("create table p (id int primary key, v int, "
                      "s varchar(16), d decimal(10,2))")
        kit.must_exec("insert into p values " + ",".join(
            f"({i},{i * 7 % 23},'s{i % 13}',{i}.5)" for i in range(350)))
        kit.must_exec("insert into p values (350, null, null, null)")
        kit.must_exec("delete from p where id % 9 = 0")
        kit.must_exec("update p set v = v + 100 where id % 4 = 1")
        kit.must_exec("create table q (a int primary key, b varchar(4))")
        kit.must_exec("insert into q values (1, 'x'), (2, null)")
        d = _bdir(tmp_path, f"bk_{name}")
        assert kit.must_exec(f"backup database test to '{d}'").affected \
            == 2
        m = json.load(open(os.path.join(d, "backupmeta.json")))
        tables = {(e["db"], e["table"]["name"]):
                  ([c["name"] for c in e["table"]["columns"]],
                   sum(c["rows"] for c in e["chunks"]),
                   _chunk_sums(d, e)) for e in m["tables"]}
        if name == "ref":
            from tidb_tpu.testkit import TestKit as RefKit
            fresh = RefKit()
        else:
            fresh = TestKit(device="cpu")
        fresh.must_exec(f"restore database test from '{d}'")
        rows = [fresh.must_query(f"select * from {t} order by 1").rows
                for t in ("p", "q")]
        got[name] = (m["dbs"], m["done"], m["complete"], tables, rows)
    assert got["ref"] == got["port"]
    assert got["port"][3][("test", "p")][1] == 351 - 39


def test_pitr_mid_stream_matches_reference(tmp_path):
    """Snapshot, then a logbackup:// feed over a stream of writes; a
    RESTORE ... UNTIL TS at the same point of the stream gives equal
    rows on the reference and the port, and so does a full restore."""
    got = {}
    for name, kit in _kits():
        kit.must_exec("create table t (id int primary key, v int)")
        kit.must_exec("insert into t values (1,10),(2,20),(3,30)")
        d = _bdir(tmp_path, f"bk_{name}")
        feed = kit.domain.cdc.create(
            "lb", f"logbackup://{d}/log/backup.log", auto_start=False)
        feed._attach()
        feed.poll_once()
        kit.must_exec(f"backup database test to '{d}'")
        mid = None
        for r in range(6):
            kit.must_exec(f"insert into t values ({10 + r}, {r})")
            kit.must_exec(f"update t set v = v + 1 where id = {1 + r % 3}")
            if r == 2:
                kit.must_exec("delete from t where id = 2")
                feed.poll_once()
                mid = kit.domain.storage.oracle.get_ts()
        feed.poll_once()
        feed.sink.close()
        rows = []
        for until in (f" until ts {mid}", ""):
            if name == "ref":
                from tidb_tpu.testkit import TestKit as RefKit
                fresh = RefKit()
            else:
                fresh = TestKit(device="cpu")
            fresh.must_exec(f"restore database test from '{d}'{until}")
            rows.append(fresh.must_query(
                "select * from t order by id").rows)
        got[name] = rows
    assert got["ref"] == got["port"]
    assert (2, 20) not in got["port"][0] and (13, 3) not in got["port"][0]


def test_pitr_replays_deletes_of_bulk_loaded_rows(tmp_path):
    """A snapshot restores its rows in bulk (no row KV); deletes of
    such rows after the snapshot reach the log backup and a restore
    UNTIL TS between them replays exactly the deletes at or below it."""
    tk = TestKit(device="cpu")
    tk.must_exec("create table t (id int primary key, v int)")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i * 10})" for i in range(1, 9)))
    d = _bdir(tmp_path)
    tk.must_exec(f"backup database test to '{d}'")
    src = TestKit(device="cpu")            # its rows: restored in bulk
    src.must_exec(f"restore database test from '{d}'")
    d2 = _bdir(tmp_path, "bk2")
    feed = src.domain.cdc.create(
        "lb", f"logbackup://{d2}/log/backup.log", auto_start=False)
    feed._attach()
    feed.poll_once()
    src.must_exec(f"backup database test to '{d2}'")
    src.must_exec("delete from t where id in (2, 3)")
    src.must_exec("update t set v = 7 where id = 4")
    feed.poll_once()
    mid = src.domain.storage.oracle.get_ts()
    src.must_exec("delete from t where id = 5")
    feed.poll_once()
    feed.sink.close()
    for until, want in ((f" until ts {mid}", [1, 4, 5, 6, 7, 8]),
                        ("", [1, 4, 6, 7, 8])):
        out = TestKit(device="cpu")
        out.must_exec(f"restore database test from '{d2}'{until}")
        rows = out.must_query("select id, v from t order by id").rows
        assert [r[0] for r in rows] == want
        assert dict(rows)[4] == 7

