"""CDC on tidb_tpu_torch (tidb_tpu_torch/cdc), on the CPU: the twin of
tests/test_cdc.py. Changefeed capture, commit-ts ordering, the
resolved-ts watermark, sinks, lifecycle and checkpoint resume.

Deterministic slice: feeds are created with auto_start=False and driven
via poll_once() so no worker thread races the assertions; the threaded
path is exercised by test_worker_*.
"""
import json
import os
import time

import pytest

from tidb_tpu_torch.cdc import current_resolved_ts
from tidb_tpu_torch.cdc.events import DDLEvent
from tidb_tpu_torch.session import Session, new_store
from tidb_tpu_torch.utils import failpoint


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, phase
    from tidb_tpu_torch.utils import metrics as mu
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


class CollectSink:
    """Test sink recording every delivery in order."""

    name = "collect"

    def __init__(self):
        self.txns = []         # [(commit_ts, [RowEvent])]
        self.ddls = []
        self.resolved = []

    def emit_txn(self, events):
        self.txns.append((events[0].commit_ts, events))

    def emit_ddl(self, event):
        self.ddls.append(event)

    def flush_resolved(self, ts):
        self.resolved.append(ts)

    def resume_ts(self):
        return None

    def close(self):
        pass


def _sess(dom):
    s = Session(dom)
    s.vars.current_db = "test"
    return s


def _feed(dom, name="f", sink=None, start_ts=0):
    feed = dom.cdc.create(name, "blackhole://", start_ts=start_ts,
                          auto_start=False)
    if sink is not None:
        feed.sink = sink
    feed._attach()
    feed.poll_once()
    return feed


def test_row_events_and_old_value_capture():
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    sink = CollectSink()
    feed = _feed(dom, sink=sink)
    sink.txns.clear()
    s.execute("insert into t values (1, 10)")
    s.execute("update t set b = 11 where a = 1")
    s.execute("delete from t where a = 1")
    feed.poll_once()
    ops = [(e.op, e.handle) for _, evs in sink.txns for e in evs]
    assert ops == [("insert", 1), ("update", 1), ("delete", 1)]
    ins, upd, dele = [evs[0] for _, evs in sink.txns]
    assert ins.before is None and ins.after is not None
    assert [d.to_py() for d in upd.before] == [1, 10]
    assert [d.to_py() for d in upd.after] == [1, 11]
    assert dele.after is None and [d.to_py() for d in dele.before] == [1, 11]
    assert ins.db == "test" and ins.table == "t"
    # whole-txn grouping: one multi-statement txn = one emit_txn call
    sink.txns.clear()
    s.execute("begin")
    s.execute("insert into t values (2, 20)")
    s.execute("insert into t values (3, 30)")
    s.execute("commit")
    feed.poll_once()
    assert len(sink.txns) == 1 and len(sink.txns[0][1]) == 2


def test_commit_ts_order_and_resolved_monotonic():
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    sink = CollectSink()
    feed = _feed(dom, sink=sink)
    for i in range(30):
        s.execute(f"insert into t values ({i}, {i})")
        if i % 7 == 0:
            feed.poll_once()
    feed.poll_once()
    ts_seen = [ts for ts, _ in sink.txns]
    assert ts_seen == sorted(ts_seen)
    assert sink.resolved == sorted(sink.resolved)
    # no txn was emitted above a previously-published resolved ts
    hi = 0
    for ts, _ in sink.txns:
        assert ts > hi or not sink.resolved
    assert feed.resolved >= ts_seen[-1]


def test_catchup_from_earlier_start_ts():
    """A feed created at ts T streams history from start_ts < T (hook +
    WAL/version-scan catch-up)."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values (1, 10), (2, 20)")
    s.execute("update t set b = 21 where a = 2")
    sink = CollectSink()
    _feed(dom, sink=sink)      # start_ts=0: full history
    ops = [(e.op, e.handle) for _, evs in sink.txns for e in evs]
    assert ("insert", 1) in ops and ("update", 2) in ops
    # old value captured even through catch-up
    upd = [e for _, evs in sink.txns for e in evs if e.op == "update"][0]
    assert [d.to_py() for d in upd.before] == [2, 20]


def test_catchup_respects_start_ts():
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values (1, 10)")
    mid_ts = current_resolved_ts(dom)
    s.execute("insert into t values (2, 20)")
    sink = CollectSink()
    _feed(dom, sink=sink, start_ts=mid_ts)
    handles = [e.handle for _, evs in sink.txns for e in evs]
    assert handles == [2]      # history at/below start_ts excluded


def test_catchup_merges_frames_at_same_commit_ts(tmp_path):
    """The lock resolver appends one WAL frame PER committed secondary
    key at the same commit_ts; the catch-up scan must merge them all
    (a first-frame-wins dedup silently dropped every secondary after
    the first, leaving the mirror missing rows forever)."""
    dom = new_store(str(tmp_path), device="cpu")
    try:
        wal = dom.storage.mvcc.wal
        ts = dom.storage.oracle.get_ts()
        wal.append(ts, [(b"k1", b"v1")])
        wal.append(ts, [(b"k2", b"v2")])
        batches = dict(dom.cdc.capture.catchup_batches(0, ts))
        assert [tuple(m) for m in batches[ts]] == \
            [(b"k1", b"v1"), (b"k2", b"v2")]
    finally:
        dom.storage.mvcc.wal.close()


def test_resolved_ts_held_by_open_pessimistic_txn():
    """Satellite: an open pessimistic txn holds the watermark at its
    start_ts — the sink must emit nothing past it until commit."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values (1, 10)")
    s.execute("set @@tidb_txn_mode = 'pessimistic'")
    s.execute("begin")
    s.execute("update t set b = 11 where a = 1")
    start_ts = s._txn.start_ts
    sink = CollectSink()
    feed = _feed(dom, sink=sink)
    # a second session commits while the pessimistic txn stays open
    s2 = _sess(dom)
    s2.execute("insert into t values (5, 50)")
    feed.poll_once()
    assert feed.resolved <= start_ts
    for ts, _ in sink.txns:
        assert ts <= start_ts, "sink emitted past an open txn's start_ts"
    assert not any(e.handle == 5 for _, evs in sink.txns for e in evs)
    s.execute("commit")
    feed.poll_once()
    assert feed.resolved > start_ts
    emitted = [(e.op, e.handle) for _, evs in sink.txns for e in evs]
    assert ("update", 1) in emitted and ("insert", 5) in emitted


def test_resolved_ts_advances_on_lock_resolver_rollback():
    """Satellite: the watermark held by an EXPIRED txn's lock advances
    once the lock resolver rolls it back (no commit ever arrives)."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values (1, 10)")
    mvcc = dom.storage.mvcc
    # plant a pessimistic lock with a tiny TTL, then abandon the txn
    start_ts = dom.storage.oracle.get_ts()
    fut = dom.storage.oracle.get_ts()
    from tidb_tpu_torch.storage.lock_resolver import LockCtx
    mvcc.acquire_pessimistic_lock(b"t_zombie", b"t_zombie", start_ts,
                                  fut, ctx=LockCtx(ttl_ms=50))
    assert current_resolved_ts(dom) <= start_ts
    time.sleep(0.08)           # let the TTL expire
    # check_txn_status rolls the expired primary back; the secondary
    # pass then reports it stale/rolled_back — either way the lock is
    # gone and the watermark is free
    swept = mvcc.resolver.sweep()
    assert sum(swept.values()) >= 1 and "alive" not in swept
    assert current_resolved_ts(dom) > start_ts
    # the rolled-back txn can never commit late below the watermark
    from tidb_tpu_torch.errors import WriteConflictError
    with pytest.raises(WriteConflictError):
        mvcc.prewrite([(b"t_zombie", b"v")], b"t_zombie", start_ts)


def test_commit_intent_holds_resolved_floor():
    """Unit: the 1PC/async pre-allocation window (intent registered
    before the commit_ts exists) pins the floor at start_ts."""
    dom = new_store(None, device="cpu")
    start_ts = dom.storage.oracle.get_ts()
    token = dom.storage.mvcc.begin_commit_intent(start_ts)
    assert current_resolved_ts(dom) == start_ts
    dom.storage.mvcc.end_commit_intent(token)
    assert current_resolved_ts(dom) > start_ts


def test_ddl_barrier_event():
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    sink = CollectSink()
    feed = _feed(dom, "f", sink)
    n0 = len(sink.ddls)
    s.execute("create table d1 (a int primary key, b int)")
    s.execute("insert into d1 values (1, 1)")
    feed.poll_once()
    assert len(sink.ddls) > n0
    assert all(isinstance(e, DDLEvent) for e in sink.ddls)
    # the barrier precedes the first row event of the new table
    assert any(d.commit_ts < sink.txns[-1][0] for d in sink.ddls)


def test_mirror_table_sink_replicates_and_is_idempotent():
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values (1, 10), (2, 20)")
    feed = dom.cdc.create("m", "mirror://", auto_start=False)
    feed._attach()
    feed.poll_once()
    sink = feed.sink
    s.execute("update t set b = 99 where a = 1")
    s.execute("delete from t where a = 2")
    s.execute("create table u (a int primary key, c varchar(16))")
    s.execute("insert into u values (7, 'x')")
    feed.poll_once()
    assert sink.mirror_rows("test", "t") == \
        s.execute("select * from t order by 1").rows
    assert sink.mirror_rows("test", "u") == [(7, "x")]
    # exactly-once apply: a restarted feed incarnation (fresh contract
    # checker, warm mirror + applied_ts) redelivers at-least-once; the
    # applied_ts skip must make the re-apply a no-op
    from tidb_tpu_torch.cdc.sinks import TableSink
    applied = sink.applied_ts
    rows_before = sink.mirror_rows("test", "t")
    sink2 = TableSink(dom, mirror_domain=sink.mirror)
    sink2.applied_ts = applied
    from tidb_tpu_torch.cdc.events import RowEvent
    ev = RowEvent(commit_ts=applied, db="test", table="t", table_id=0,
                  handle=1, op="insert", col_names=["a", "b"],
                  before=None, after=None, key=b"", value=b"")
    sink2.emit_txn([ev])
    assert sink2.mirror_rows("test", "t") == rows_before
    assert sink2.applied_ts == applied


def test_ndjson_sink_format_and_resume(tmp_path):
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    path = os.path.join(str(tmp_path), "feed.ndjson")
    feed = dom.cdc.create("j", f"file://{path}", auto_start=False)
    feed._attach()
    feed.poll_once()
    s.execute("insert into t values (1, 10)")
    s.execute("update t set b = 11 where a = 1")
    feed.poll_once()
    feed.sink.close()
    lines = [json.loads(x) for x in open(path, encoding="utf-8")]
    kinds = [x["type"] for x in lines]
    assert "insert" in kinds and "update" in kinds and "resolved" in kinds
    upd = [x for x in lines if x["type"] == "update"][0]
    assert upd["old"] == {"a": 1, "b": 10}
    assert upd["data"] == {"a": 1, "b": 11}
    assert upd["db"] == "test" and upd["table"] == "t"
    # resume_ts = the largest durable resolved marker
    from tidb_tpu_torch.cdc.sinks import NdjsonSink
    s2 = NdjsonSink(path)
    assert s2.resume_ts() == max(x["ts"] for x in lines
                                 if x["type"] == "resolved")
    s2.close()


def test_admin_changefeed_sql_lifecycle():
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    r = s.execute("admin changefeed create cf sink 'blackhole://'")
    assert r.rows[0][0] == "cf" and r.rows[0][1] == "normal"
    from tidb_tpu_torch.errors import TiDBError
    with pytest.raises(TiDBError):
        s.execute("admin changefeed create cf sink 'blackhole://'")
    s.execute("insert into t values (1, 1)")
    deadline = time.time() + 5
    while time.time() < deadline:
        rows = s.execute(
            "select state, emitted_rows from "
            "information_schema.tidb_changefeeds "
            "where changefeed = 'cf'").rows
        if rows and rows[0][1] >= 1:
            break
        time.sleep(0.02)
    assert rows[0][0] == "normal" and rows[0][1] >= 1
    assert s.execute("admin changefeed pause cf").rows[0][1] == "paused"
    assert s.execute("admin changefeed resume cf").rows[0][1] == "normal"
    s.execute("admin changefeed remove cf")
    assert s.execute(
        "select * from information_schema.tidb_changefeeds").rows == []
    with pytest.raises(TiDBError):
        s.execute("admin changefeed pause cf")
    dom.cdc.shutdown()


def test_worker_error_state_classified_backoff():
    """A failing poll moves the feed to 'error', backs off, and
    recovers to 'normal' without losing events."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    feed = dom.cdc.create("e", "mirror://", auto_start=False)
    failpoint.enable("cdc-emit", "nth:2->error")
    try:
        feed.start(poll_interval_s=0.01)
        for i in range(10):
            s.execute(f"insert into t values ({i}, {i})")
        src = s.execute("select * from t order by 1").rows
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if feed.sink.mirror_rows("test", "t") == src and \
                        feed.state == "normal":
                    break
            except Exception:          # mirror table not created yet
                pass
            time.sleep(0.05)
        assert feed.sink.mirror_rows("test", "t") == src
        assert feed.state == "normal" and feed.consecutive_errors == 0
    finally:
        failpoint.disable("cdc-emit")
        dom.cdc.shutdown()


def test_checkpoint_persisted_and_restart_resume(tmp_path):
    """Satellite acceptance: restarted domain resumes feeds
    at-least-once from the persisted checkpoint; the mirror table sink
    re-applies exactly-once to row-identical state."""
    dd = os.path.join(str(tmp_path), "dd")
    dom = new_store(dd, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    feed = dom.cdc.create("m", "mirror://", auto_start=False)
    feed._attach()
    for i in range(8):
        s.execute(f"insert into t values ({i}, {i})")
    feed.poll_once()
    assert feed.checkpoint_ts > 0
    ckpt_file = os.path.join(dd, "cdc", "m.json")
    assert os.path.exists(ckpt_file)
    saved = json.load(open(ckpt_file, encoding="utf-8"))
    assert saved["checkpoint_ts"] == feed.checkpoint_ts
    feed.stop()
    dom.cdc.shutdown()
    dom.storage.mvcc.wal.close()
    # restart: the persisted feed comes back and catches up the mirror
    dom2 = new_store(dd, device="cpu")
    try:
        s2 = _sess(dom2)
        s2.execute("insert into t values (100, 100)")
        src = s2.execute("select * from t order by 1").rows
        feed2 = dom2.cdc.get("m")
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if feed2.sink.mirror_rows("test", "t") == src:
                    break
            except Exception:          # mirror still catching up
                pass
            time.sleep(0.05)
        assert feed2.sink.mirror_rows("test", "t") == src
        assert feed2.checkpoint_ts >= saved["checkpoint_ts"]
    finally:
        dom2.cdc.shutdown()
        dom2.storage.mvcc.wal.close()


def test_pause_resume_catchup_gap():
    """Events committed while a feed is paused arrive after resume
    (catch-up from checkpoint), in order, exactly once to the mirror."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    feed = dom.cdc.create("p", "mirror://", auto_start=False)
    feed._attach()
    s.execute("insert into t values (1, 1)")
    feed.poll_once()
    feed._detach()             # the pause path's capture detach
    s.execute("insert into t values (2, 2)")
    s.execute("update t set b = 9 where a = 1")
    feed._attach()             # resume re-attaches + catch-up
    feed.poll_once()
    assert feed.sink.mirror_rows("test", "t") == \
        s.execute("select * from t order by 1").rows


def test_show_master_status_reports_wal_and_resolved(tmp_path):
    """Satellite: SHOW MASTER STATUS reports the real WAL position and
    current resolved-ts instead of an empty placeholder set."""
    dd = os.path.join(str(tmp_path), "dd")
    dom = new_store(dd, device="cpu")
    try:
        s = _sess(dom)
        s.execute("create table t (a int primary key, b int)")
        rows = s.execute("show master status").rows
        assert len(rows) == 1
        fname, pos0, _, _, gtid = rows[0]
        assert fname == "commit.wal"
        assert gtid.startswith("resolved_ts:")
        r0 = int(gtid.split(":")[1])
        s.execute("insert into t values (1, 1)")
        rows2 = s.execute("show master status").rows
        assert int(rows2[0][1]) > int(pos0)       # position advanced
        assert int(rows2[0][4].split(":")[1]) > r0  # resolved advanced
    finally:
        dom.cdc.shutdown()
        dom.storage.mvcc.wal.close()


def test_async_and_1pc_commits_are_captured():
    """Every commit mode publishes through the same capture seam."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    feed = dom.cdc.create("m", "mirror://", auto_start=False)
    feed._attach()
    s.execute("set @@tidb_enable_1pc = 0")
    s.execute("set @@tidb_enable_async_commit = 1")
    s.execute("insert into t values (1, 1)")       # async path
    s.execute("set @@tidb_enable_async_commit = 0")
    s.execute("insert into t values (2, 2)")       # classic 2PC
    s.execute("set @@tidb_enable_1pc = 1")
    s.execute("insert into t values (3, 3)")       # 1PC
    feed.poll_once()
    assert feed.sink.mirror_rows("test", "t") == [(1, 1), (2, 2), (3, 3)]


def test_failed_feed_detaches_and_resume_recovers(monkeypatch):
    """A feed that exhausts its retry budget must release its capture
    subscription (no unbounded dead-feed queue) and come back losslessly
    on ADMIN CHANGEFEED RESUME."""
    from tidb_tpu_torch.cdc import changefeed as cf
    monkeypatch.setattr(cf, "_BACKOFF_CAP_S", 0.02)
    monkeypatch.setattr(cf, "_MAX_CONSECUTIVE_ERRORS", 3)
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    feed = dom.cdc.create("f", "mirror://", auto_start=False)
    failpoint.enable("cdc-poll", "error:generic")
    try:
        feed.start(poll_interval_s=0.005)
        deadline = time.time() + 20
        while feed.state != "failed" and time.time() < deadline:
            time.sleep(0.02)
        assert feed.state == "failed"
        assert feed._sub is None      # fan-out subscription released
    finally:
        failpoint.disable("cdc-poll")
    s.execute("insert into t values (1, 1)")
    s.execute("admin changefeed resume f")
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            if feed.sink.mirror_rows("test", "t") == [(1, 1)]:
                break
        except Exception:
            pass
        time.sleep(0.05)
    assert feed.state == "normal"
    assert feed.sink.mirror_rows("test", "t") == [(1, 1)]
    dom.cdc.shutdown()


def test_resume_persists_running_state(tmp_path):
    """Regression: PAUSE persisted 'paused' but RESUME only persisted
    on failed feeds — a paused->resumed feed came back PAUSED (and
    silently stopped streaming) after a domain restart."""
    dd = os.path.join(str(tmp_path), "dd")
    dom = new_store(dd, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("admin changefeed create r sink 'blackhole://'")
    s.execute("admin changefeed pause r")
    path = os.path.join(dd, "cdc", "r.json")
    assert json.load(open(path, encoding="utf-8"))["state"] == "paused"
    s.execute("admin changefeed resume r")
    assert json.load(open(path, encoding="utf-8"))["state"] == "normal"
    dom.cdc.shutdown()
    dom.storage.mvcc.wal.close()
    dom2 = new_store(dd, device="cpu")
    try:
        feed2 = dom2.cdc.get("r")
        assert feed2.state == "normal"
        assert feed2._worker is not None and feed2._worker.is_alive()
    finally:
        dom2.cdc.shutdown()
        dom2.storage.mvcc.wal.close()


def test_table_sink_column_sync_on_ddl():
    """ALTER TABLE ADD/DROP COLUMN must propagate to a table-backed
    mirror (sync_schemas diffs public columns) — otherwise replayed
    direct-KV rows decode against a stale mirror schema."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    s.execute("insert into t values (1, 10)")
    feed = dom.cdc.create("m", "mirror://", auto_start=False)
    feed._attach()
    feed.poll_once()
    s.execute("alter table t add column c int not null default 0")
    s.execute("insert into t values (2, 20, 7)")
    feed.poll_once()
    assert feed.sink.mirror_rows("test", "t") == \
        s.execute("select * from t order by 1").rows
    s.execute("alter table t drop column b")
    s.execute("insert into t values (3, 8)")
    feed.poll_once()
    assert feed.sink.mirror_rows("test", "t") == \
        s.execute("select * from t order by 1").rows
    dom.cdc.shutdown()


def test_drain_flushes_buffer_before_detach():
    """Changefeed.drain() (the Domain.close() path) must deliver
    everything already committed — stop() alone may drop events that
    are captured but not yet polled through to the sink."""
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table t (a int primary key, b int)")
    feed = dom.cdc.create("m", "mirror://", auto_start=False)
    feed._attach()
    feed.poll_once()
    for i in range(20):
        s.execute(f"insert into t values ({i}, {i})")
    # anti-vacuity: the mirror is genuinely behind before the drain
    assert len(feed.sink.mirror_rows("test", "t")) < 20
    feed.drain()
    assert feed.sink.mirror_rows("test", "t") == \
        s.execute("select * from t order by 1").rows
    assert feed._sub is None          # detached
    assert feed.pending_rows() == 0
    dom.cdc.shutdown()


def test_delete_of_bulk_loaded_row_is_captured():
    """A row appended in bulk (IMPORT INTO, RESTORE) has no row KV, so
    MVCC holds no old value for its delete; the delete is still an
    event (old value unknown), or a log backup would bring the row back
    at a point-in-time restore. A delete of a never-present key stays
    silent."""
    import numpy as np
    dom = new_store(None, device="cpu")
    s = _sess(dom)
    s.execute("create table b (id int primary key, v int)")
    ctab = dom.columnar.table(dom.infoschema().table_by_name("test", "b"))
    ctab.bulk_append({"id": np.arange(5), "v": np.arange(5) * 10}, 5,
                     handles=np.arange(5))
    sink = CollectSink()
    feed = _feed(dom, sink=sink)
    s.execute("delete from b where id = 3")
    s.execute("delete from b where id = 77")
    s.execute("insert into b values (9, 90)")
    feed.poll_once()
    evs = [e for _, es in sink.txns for e in es]
    assert [(e.op, e.handle) for e in evs] == [("delete", 3), ("insert", 9)]
    assert evs[0].before is None and evs[0].value is None
    assert s.execute("select id from b order by id").rows == \
        [(0,), (1,), (2,), (4,), (9,)]
