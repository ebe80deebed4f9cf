"""CDC capture: commit-hook subscription + catch-up scan + resolved-ts.

Reference shape: TiCDC's kv client tails TiKV change logs per region
and the puller computes a per-region resolved ts from the region's lock
table. Here the "region" is the one in-process MVCC store, so capture
collapses to:

  * a commit hook (``MVCCStore.commit_hooks``, the columnar raft-learner
    analog) fanning raw ``(commit_ts, mutations)`` batches into every
    subscribed changefeed's pending queue;
  * a catch-up scan so a feed created at ts T can start from an earlier
    ``start_ts``: the WAL is replayed for the suffix it covers (it is
    always a contiguous suffix of commit history — checkpoint/flush
    truncate it whole), and any older gap comes from an MVCC version
    scan (versions are append-only, so the scan is complete);
  * ``resolved_ts()`` — the watermark: ``MVCCStore.resolved_floor`` over
    a fresh oracle ts, held down by live locks (oldest uncommitted txn
    ``start_ts``), commit intents, and in-flight hook publications. Every
    commit at/below the returned ts has already reached the hooks, and
    no future commit can land at/below it.

Decoding raw batches into events (old-value lookup, schema resolution)
happens on the changefeed worker thread, never inside the hook.
"""
from __future__ import annotations

from collections import deque

from ..codec.codec import decode_row_value
from ..codec.tablecodec import (META_PREFIX, RECORD_PREFIX_SEP,
                                TABLE_PREFIX, decode_record_key)
from .events import OP_DELETE, OP_INSERT, OP_UPDATE, DDLEvent, RowEvent
from ..utils import lockrank

# databases never captured: bootstrap/system churn (sysvar persistence,
# stats) is engine-internal, like TiCDC's default filter
SYSTEM_DBS = frozenset({"mysql", "information_schema"})


def _is_record_key(key: bytes) -> bool:
    return key.startswith(TABLE_PREFIX) and key[9:11] == RECORD_PREFIX_SEP


class Capture:
    """One per Domain; installs a single commit hook and fans batches
    out to subscribers (changefeeds)."""

    def __init__(self, domain):
        self.domain = domain
        self._mu = lockrank.ranked_lock("cdc.capture")
        self._subs: dict[int, deque] = {}
        self._inline: list = []
        self._next_sub = 0
        self._hooked = False
        # table_id -> (db_name, TableInfo), invalidated per infoschema
        self._meta_cache = (None, {})

    # ---- subscription -------------------------------------------------
    def _hook_locked(self):
        if not self._hooked:
            # the hook stays installed for the domain's lifetime
            # (a no-op fan-out when no feeds are live)
            self.domain.storage.mvcc.commit_hooks.append(self._on_commit)
            self._hooked = True

    def subscribe(self) -> int:
        with self._mu:
            self._hook_locked()
            self._next_sub += 1
            sid = self._next_sub
            self._subs[sid] = deque()
            return sid

    def subscribe_inline(self, fn):
        """Second-consumer seam (copr/delta.py, docs/CDC.md): ``fn``
        is called with every raw ``(commit_ts, mutations)`` batch ON
        THE COMMITTING THREAD, outside the capture mutex — unlike a
        queued subscription it cannot grow a backlog while nothing
        drains it (the delta maintainer is pull-based at bind time, so
        a pure-OLTP phase must not buffer batches it will fold from
        the columnar arrays anyway). Consumers must be O(batch) and
        must not raise."""
        with self._mu:
            self._hook_locked()
            self._inline.append(fn)

    def unsubscribe(self, sid: int):
        with self._mu:
            self._subs.pop(sid, None)

    def _on_commit(self, commit_ts: int, mutations: list):
        # commit-hook context: append raw refs only — decoding, schema
        # lookups and old-value reads all happen on the feed worker
        with self._mu:
            for q in self._subs.values():
                q.append((commit_ts, mutations))
            inline = list(self._inline) if self._inline else ()
        for fn in inline:
            fn(commit_ts, mutations)

    def drain(self, sid: int) -> list:
        """Pending raw batches for one subscriber (fan-out order, not
        necessarily commit_ts order — the sorter orders them)."""
        with self._mu:
            q = self._subs.get(sid)
            if not q:
                return []
            out = list(q)
            q.clear()
            return out

    # ---- watermark ----------------------------------------------------
    def resolved_ts(self) -> int:
        storage = self.domain.storage
        now_ts = storage.oracle.get_ts()
        return storage.mvcc.resolved_floor(now_ts)

    def scan_barrier(self) -> int:
        """Upper bound for a catch-up scan: a FRESH oracle ts. Any
        commit published before the caller subscribed was applied (and
        WAL-appended) before publication, so the scan sees it; commits
        the scan may see that are NOT yet published (applied or
        prewritten-durable, hooks pending) are safe to buffer early —
        emission is gated on resolved_ts() anyway, which cannot pass
        them until their publication completes. Deliberately NOT the
        resolved floor: an event published while nobody was subscribed
        can sit ABOVE the floor (held down by an unrelated open txn),
        and a floor-bounded scan would miss it forever."""
        return self.domain.storage.oracle.get_ts()

    # ---- catch-up scan -------------------------------------------------
    def catchup_batches(self, after_ts: int, upto_ts: int) -> list:
        """[(commit_ts, mutations)] for every commit in
        (after_ts, upto_ts], ascending. Call with upto_ts from
        ``scan_barrier()`` after subscribing."""
        if upto_ts <= after_ts:
            return []
        mvcc = self.domain.storage.mvcc
        frames = []
        wal = mvcc.wal
        if wal is not None:
            from ..storage.wal import replay
            wal.flush()
            frames = [(ts, muts) for ts, muts, _wall in replay(wal.path)]
        first_wal_ts = min((ts for ts, _ in frames), default=None)
        batches: dict[int, list] = {}
        if first_wal_ts is None or first_wal_ts > after_ts + 1:
            # the WAL does not reach back to after_ts (truncated by a
            # checkpoint/flush, or no WAL at all): version-scan the gap
            gap_hi = upto_ts if first_wal_ts is None else first_wal_ts - 1
            for ts, key, value in mvcc.version_scan(after_ts, gap_hi):
                batches.setdefault(ts, []).append((key, value))
        for ts, muts in frames:
            # merge EVERY frame at a given commit_ts: the lock resolver
            # appends one frame per committed secondary key at the same
            # commit_ts, and keeping only the first would silently drop
            # the rest (the version-scan gap ends at first_wal_ts - 1,
            # so scan and WAL ts ranges never overlap)
            if after_ts < ts <= upto_ts:
                batches.setdefault(ts, []).extend(muts)
        return sorted(batches.items())

    # ---- decoding ------------------------------------------------------
    def _table_meta(self, table_id: int):
        isch = self.domain.infoschema()
        if self._meta_cache[0] is not isch:
            self._meta_cache = (isch, {})
        cache = self._meta_cache[1]
        hit = cache.get(table_id)
        if hit is None:
            hit = (None, None)
            for db in isch.all_schemas():
                for t in isch.tables_in_schema(db.name):
                    if t.id == table_id:
                        hit = (db.name, t)
                    elif t.partitions:
                        for p in t.partitions["parts"]:
                            if p["pid"] == table_id:
                                info = self.domain._table_info_by_id(
                                    table_id)
                                hit = (db.name, info)
                    if hit[0] is not None:
                        break
                if hit[0] is not None:
                    break
            cache[table_id] = hit
        return hit

    def decode_batch(self, commit_ts: int, mutations: list) -> list:
        """Raw mutation batch -> ordered events: at most one DDL barrier
        (meta-namespace writes) first, then row events with old-value
        capture from MVCC."""
        mvcc = self.domain.storage.mvcc
        events = []
        ddl = None
        for key, value in mutations:
            if key.startswith(META_PREFIX):
                if ddl is None:
                    ddl = DDLEvent(commit_ts=commit_ts)
                continue
            if not _is_record_key(key):
                continue              # index/meta-adjacent keys
            table_id, handle = decode_record_key(key)
            db_name, info = self._table_meta(table_id)
            if info is None or db_name.lower() in SYSTEM_DBS:
                continue
            before_raw = mvcc.value_before(key, commit_ts)
            before = (decode_row_value(before_raw)
                      if before_raw is not None else None)
            after = decode_row_value(value) if value is not None else None
            if before is None and after is None and \
                    not self._bulk_row_deleted(table_id, handle, commit_ts):
                continue              # delete of a never-present row
            op = (OP_DELETE if after is None
                  else OP_INSERT if before is None else OP_UPDATE)
            events.append(RowEvent(
                commit_ts=commit_ts, db=db_name, table=info.name,
                table_id=table_id, handle=handle, op=op,
                col_names=[c.name for c in info.columns],
                before=before, after=after, key=key, value=value,
                table_info=info))
        if ddl is not None:
            ddl.schema_version = self._schema_version_of(mutations)
            events.insert(0, ddl)
        return events

    def _bulk_row_deleted(self, table_id, handle, commit_ts) -> bool:
        """Whether a delete of a key with no row KV history removed a
        bulk-loaded row (IMPORT INTO, RESTORE and bulk_append write no
        row KV, so MVCC has no old value for it): the columnar table
        holds the handle, deleted by this very commit. Such a delete
        is an event (old value unknown): a log backup that dropped it
        would bring the row back at a point-in-time restore."""
        ctab = self.domain.columnar.tables.get(table_id)
        if ctab is None or not ctab.bulk_rows:
            return False
        pos = ctab.handle_pos.get(handle)
        return pos is not None and int(ctab.delete_ts[pos]) == commit_ts

    @staticmethod
    def _schema_version_of(mutations) -> int:
        from ..meta.meta import _K_SCHEMA_VER
        for key, value in mutations:
            if key == _K_SCHEMA_VER and value is not None:
                try:
                    return int(value)
                except ValueError:
                    return 0
        return 0
