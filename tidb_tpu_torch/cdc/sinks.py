"""Changefeed sinks (reference TiCDC sink API: blackhole / storage /
MySQL sink, collapsed to the in-process engine's three shapes).

Sink contract (docs/CDC.md):

  * ``emit_txn(events)`` — one WHOLE transaction: row events sharing a
    single commit_ts, delivered in commit_ts order across calls. The
    feed guarantees commit_ts <= the next ``flush_resolved`` ts.
  * ``emit_ddl(event)`` — schema-change barrier, delivered before any
    row event with a later (or equal) commit_ts.
  * ``flush_resolved(ts)`` — watermark: every transaction at/below
    ``ts`` has been emitted; ts is monotonic. Sinks that buffer must
    make emitted data durable here.
  * ``resume_ts()`` — the sink's own applied watermark: a restarted
    feed replays from min(checkpoint, max(resume_ts, start_ts)). A
    volatile sink (fresh mirror) returns 0 to request full catch-up;
    None means "no sink-side state, trust the feed checkpoint".
  * ``close()`` — release resources; idempotent.

Delivery is at-least-once: after a crash between sink apply and
checkpoint persistence, events at/below the old checkpoint are
re-delivered. The table sink turns that into exactly-once APPLY by
skipping transactions at/below its ``applied_ts``.
"""
from __future__ import annotations

import json
import os
import threading

from ..codec.tablecodec import record_key
from ..utils import metrics as metrics_util


class SinkContractError(AssertionError):
    """A feed violated the ordering/watermark contract (emission above
    resolved-ts, non-monotonic resolved-ts, out-of-order txns)."""


class _ContractChecker:
    """Shared ordering assertions every sink runs (cheap; the chaos
    smoke counts on them): txns arrive in commit_ts order, resolved-ts
    is monotonic, and no txn is emitted above the NEXT resolved-ts."""

    def __init__(self):
        self.last_txn_ts = 0
        self.last_resolved = 0
        self._unflushed_max = 0

    def on_txn(self, commit_ts: int):
        # emission below a PUBLISHED resolved-ts is the fatal contract
        # breach (a consumer already took ts<=resolved as final). Plain
        # non-monotonic emission is NOT checked: a re-attached feed
        # (pause/resume, error retry) legitimately redelivers
        # emitted-but-unflushed transactions — at-least-once.
        if commit_ts <= self.last_resolved:
            raise SinkContractError(
                f"txn commit_ts {commit_ts} at/below already-published "
                f"resolved ts {self.last_resolved}")
        self.last_txn_ts = commit_ts
        self._unflushed_max = max(self._unflushed_max, commit_ts)

    def on_resolved(self, ts: int):
        if ts < self.last_resolved:
            raise SinkContractError(
                f"resolved ts went backwards: {ts} < {self.last_resolved}")
        if self._unflushed_max > ts:
            raise SinkContractError(
                f"resolved ts {ts} below an already-emitted txn "
                f"{self._unflushed_max}")
        self.last_resolved = ts


class BlackholeSink:
    """Counts and drops (reference blackhole sink; perf floor +
    lifecycle tests)."""

    name = "blackhole"

    def __init__(self):
        self.txns = 0
        self.rows = 0
        self.ddls = 0
        self.check = _ContractChecker()

    def emit_txn(self, events):
        self.check.on_txn(events[0].commit_ts)
        self.txns += 1
        self.rows += len(events)

    def emit_ddl(self, event):
        self.ddls += 1

    def flush_resolved(self, ts: int):
        self.check.on_resolved(ts)

    def resume_ts(self):
        return None             # stateless: trust the feed checkpoint

    def close(self):
        pass


class NdjsonSink:
    """Canal-like newline-delimited JSON file sink: one object per row
    event (old + new value), DDL barriers, and resolved-ts markers.
    Append-only; at-least-once across feed restarts (consumers dedup on
    (ts, db, table, handle))."""

    name = "file"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self.check = _ContractChecker()

    def emit_txn(self, events):
        self.check.on_txn(events[0].commit_ts)
        for ev in events:
            self._f.write(json.dumps(ev.to_wire(), default=str) + "\n")

    def emit_ddl(self, event):
        self._f.write(json.dumps(event.to_wire()) + "\n")

    def flush_resolved(self, ts: int):
        self.check.on_resolved(ts)
        self._f.write(json.dumps({"type": "resolved", "ts": ts}) + "\n")
        self._f.flush()

    def resume_ts(self) -> int:
        """Largest resolved marker already in the file: everything at or
        below it was durably written by a previous incarnation."""
        try:
            last = 0
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue
                    if obj.get("type") == "resolved":
                        last = max(last, int(obj.get("ts", 0)))
            return last
        except OSError:
            return 0

    def close(self):
        try:
            self._f.close()
        except OSError:
            pass


class TableSink:
    """In-process mirror replication (reference TiCDC MySQL sink +
    syncpoint, collapsed): applies row events into a second Domain at
    the SOURCE commit_ts via direct KV ingest, so handles, row
    encodings and version order are preserved bit-for-bit and the
    mirror is SQL-queryable (`SELECT ... FROM mirror`). Exactly-once
    apply: transactions at/below ``applied_ts`` are skipped, which
    makes at-least-once redelivery after a checkpoint-resume a no-op.

    Mirror tables are created on demand (and at every DDL barrier) from
    the source TableInfo — columns + clustered PK only, no secondary
    indexes (the mirror serves row-level reads; index maintenance would
    need SQL-level apply)."""

    name = "mirror"

    def __init__(self, source_domain, mirror_domain=None):
        from ..session import Session, new_store
        self.source = source_domain
        # a mirror runs on its source's device (new_store's default is
        # the card)
        self.mirror = mirror_domain or new_store(
            None, device=source_domain.copr.device)
        self._sess = Session(self.mirror)
        self._mu = threading.Lock()
        self._mirror_tids: dict = {}    # (db, table) -> mirror table id
        self.applied_ts = 0
        self.check = _ContractChecker()

    # ---- schema sync --------------------------------------------------
    def _mirror_tid(self, db: str, table: str, info):
        key = (db, table)
        tid = self._mirror_tids.get(key)
        if tid is not None:
            return tid
        isch = self.mirror.infoschema()
        if not any(d.name.lower() == db.lower()
                   for d in isch.all_schemas()):
            self._sess.execute(f"create database `{db}`")
        isch = self.mirror.infoschema()
        if not isch.has_table(db, table):
            self._sess.execute(self._create_sql(db, info))
        tid = self.mirror.infoschema().table_by_name(db, table).id
        self._mirror_tids[key] = tid
        return tid

    @staticmethod
    def _create_sql(db: str, info) -> str:
        cols = []
        for c in info.public_columns():
            s = f"`{c.name}` {c.ft.sql_string()}"
            if c.ft.not_null:
                s += " NOT NULL"
            if info.pk_is_handle and c.name == info.pk_col_name:
                s += " PRIMARY KEY"
            cols.append(s)
        return f"create table `{db}`.`{info.name}` ({', '.join(cols)})"

    def sync_schemas(self):
        """DDL barrier: make every capturable source table exist in the
        mirror with the source's column set (drops are left in place —
        the mirror is a replica, not a GC target). Column-level diff:
        added/dropped columns replay as ALTERs in source order, so the
        mirror's sequential column-id allocation tracks the source's
        and the direct-KV row encodings keep decoding identically."""
        from .capture import SYSTEM_DBS
        isch = self.source.infoschema()
        for dbi in isch.all_schemas():
            if dbi.name.lower() in SYSTEM_DBS:
                continue
            for t in isch.tables_in_schema(dbi.name):
                if t.view_select or t.sequence:
                    continue
                with self._mu:
                    self._mirror_tid(dbi.name, t.name, t)
                    self._sync_columns(dbi.name, t)

    def _sync_columns(self, db: str, info):
        """Replay column add/drop onto an existing mirror table (held
        under self._mu by sync_schemas)."""
        mt = self.mirror.infoschema().table_by_name(db, info.name)
        want = {c.name.lower(): c for c in info.public_columns()}
        have = {c.name.lower() for c in mt.public_columns()}
        for c in info.public_columns():
            if c.name.lower() not in have:
                spec = f"`{c.name}` {c.ft.sql_string()}"
                if c.ft.not_null:
                    spec += " NOT NULL"
                self._sess.execute(
                    f"alter table `{db}`.`{info.name}` add column {spec}")
        for name in sorted(have - set(want)):
            self._sess.execute(
                f"alter table `{db}`.`{info.name}` drop column `{name}`")

    # ---- sink contract ------------------------------------------------
    def emit_txn(self, events):
        commit_ts = events[0].commit_ts
        self.check.on_txn(commit_ts)
        with self._mu:
            if commit_ts <= self.applied_ts:
                return                 # exactly-once: already applied
            muts = []
            for ev in events:
                tid = self._mirror_tid(ev.db, ev.table, ev.table_info)
                muts.append((record_key(tid, ev.handle), ev.value))
            storage = self.mirror.storage
            storage.oracle.fast_forward(commit_ts)
            storage.mvcc.ingest(muts, commit_ts)
            self.applied_ts = commit_ts

    def emit_ddl(self, event):
        self.sync_schemas()

    def flush_resolved(self, ts: int):
        self.check.on_resolved(ts)

    def resume_ts(self) -> int:
        """The mirror is in-process state: a fresh mirror must ask for
        full history, a warm one resumes where it applied."""
        return self.applied_ts

    def close(self):
        pass

    # ---- verification helpers (tests / cdc_smoke) ---------------------
    def mirror_rows(self, db: str, table: str) -> list:
        rs = self._sess.execute(
            f"select * from `{db}`.`{table}` order by 1")
        return rs.rows


class LogBackupSink:
    """Continuous log backup (reference br/pkg/stream log files +
    TiCDC storage sink): every transaction's RECORD mutations append as
    a WAL-framed entry to one durable log file, resolved-ts watermarks
    interleave as marker frames, and `flush_resolved` is the
    durability point (data frames fsync BEFORE the marker that vouches
    for them). Opening the sink truncates a crash-torn tail with
    `wal.valid_prefix` — the WalWriter contract reused — and resumes
    from the largest marker in the valid prefix, so the feed
    re-delivers anything the tail lost (PITR replay dedups on
    commit_ts order: br/restore.py).

    Pointing the path INSIDE a snapshot-backup directory
    (`<backup>/log/backup.log`) is what arms `RESTORE ... UNTIL TS`."""

    name = "logbackup"

    def __init__(self, path: str, source_domain=None):
        from ..br import logformat
        self._fmt = logformat
        self.path = path
        self.source = source_domain
        self._resume = logformat.last_resolved(path) \
            if os.path.exists(path) else 0
        self._f = logformat.open_for_append(path)
        self.check = _ContractChecker()
        self.check.last_resolved = self._resume

    def _wall(self, commit_ts: int) -> float:
        try:
            return self.source.storage.oracle.wall_for_ts(commit_ts)
        except Exception:
            import time
            return time.time()

    def emit_txn(self, events):
        from ..storage import wal as walmod
        commit_ts = events[0].commit_ts
        self.check.on_txn(commit_ts)
        muts = [(ev.key, ev.value) for ev in events]
        self._f.write(self._fmt.frame(walmod.encode_frame_payload(
            commit_ts, muts, self._wall(commit_ts))))

    def emit_ddl(self, event):
        self._f.write(self._fmt.frame(self._fmt.encode_ddl(
            event.commit_ts, event.schema_version)))

    def flush_resolved(self, ts: int):
        self.check.on_resolved(ts)
        # data first, marker second, both under fsync: the marker may
        # only ever vouch for frames that are already durable
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.write(self._fmt.frame(self._fmt.encode_resolved(ts)))
        self._f.flush()
        os.fsync(self._f.fileno())
        metrics_util.BACKUP_TOTAL.labels("log_flush", "ok").inc()

    def resume_ts(self) -> int:
        """Largest resolved marker that survived in the valid prefix:
        everything above it must be re-delivered (at-least-once; the
        replay side dedups)."""
        return self._resume

    def close(self):
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        except (OSError, ValueError):
            pass


def make_sink(uri: str, source_domain):
    """Sink factory for ADMIN CHANGEFEED CREATE ... SINK '<uri>':
    blackhole:// | file://<path> | mirror:// | logbackup://<path> |
    replica://<rid> (internal: the replica fabric's persistent sink —
    reused across feed restarts so its applied_ts survives)"""
    from ..errors import TiDBError
    u = uri.strip()
    if u.startswith("replica://"):
        rid = u[len("replica://"):]
        try:
            return source_domain.replicas.sink_for(int(rid))
        except (TypeError, ValueError):
            raise TiDBError("replica sink needs a numeric id: "
                            "replica://0") from None
    if u in ("blackhole", "blackhole://"):
        return BlackholeSink()
    if u.startswith("file://"):
        path = u[len("file://"):]
        if not path:
            raise TiDBError("file sink needs a path: file:///x.ndjson")
        return NdjsonSink(path)
    if u in ("mirror", "mirror://"):
        return TableSink(source_domain)
    if u.startswith("logbackup://"):
        path = u[len("logbackup://"):]
        if not path:
            raise TiDBError(
                "log-backup sink needs a path: logbackup:///bk/log/"
                "backup.log")
        return LogBackupSink(path, source_domain)
    raise TiDBError("unknown changefeed sink uri '%s' (expected "
                    "blackhole://, file://<path>, mirror:// or "
                    "logbackup://<path>)", uri)


def observe_sink_delivery(feed_name: str, sink_name: str, n_rows: int):
    metrics_util.CDC_SINK_TXNS.labels(feed_name, sink_name).inc()
    metrics_util.CDC_SINK_ROWS.labels(feed_name, sink_name).inc(n_rows)
