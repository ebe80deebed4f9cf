"""PITR restore as a durable DDL job (reference br/pkg/restore +
br/pkg/stream restore, riding the PR-13 online-DDL job runner so a
kill -9 anywhere mid-restore resumes from the persisted checkpoint).

Three phases, recorded in ``job.args["phase"]``:

  * ``schema`` — recreate every backed-up database/table from the
    manifest's TableInfo JSON with the ORIGINAL table ids (one meta
    txn; the id allocator is bumped past them). Original ids are what
    make log replay possible: the log's raw record keys encode source
    table ids. Only PUBLIC indexes are kept — an index caught
    mid-ladder by the backup has no complete backfill in the snapshot.
  * ``import`` — columnar-direct bulk load of every chunk (crc32
    verified against the manifest; a truncated or bit-flipped chunk
    raises BackupChecksumMismatchError before any row of it lands),
    bypassing DML entirely: rows enter via ``ctab.bulk_append`` at
    commit_ts = backup_ts and are made durable per chunk with
    ``persist_bulk_segment``. The DURABLE ROW COUNT is the resume
    truth (the IMPORT INTO idiom): a crash between a segment persist
    and the job checkpoint re-runs nothing and duplicates nothing.
  * ``replay`` — the log backup (br/logformat.py) is applied through
    the replay seam up to UNTIL TS (or its end): each transaction's
    record mutations are re-applied at their ORIGINAL commit_ts via
    ``mvcc.ingest`` (the WAL-framed, commit-hook-running sibling of
    ``apply_replay`` — frames must be durable so a crash mid-replay
    recovers them), with index mutations synthesized from the row
    bytes so ADMIN CHECK TABLE holds afterwards. ``replay_ts``
    checkpoints make the resume skip already-applied transactions;
    re-applying a frame at the same commit_ts converges to the same
    versions, so the crash window between apply and checkpoint is
    harmless.

Failure rolls the job back: tables THIS job created are dropped again
(meta + columnar + index delete-ranges), so a corrupt artifact leaves
the target as it was — never a silently wrong table.
"""
from __future__ import annotations

import io
import json
import os
import zlib

import numpy as np

from ..codec.codec import decode_row_value
from ..codec.tablecodec import decode_record_key, index_key
from ..errors import (TiDBError, BackupChecksumMismatchError,
                      RestoreTargetNotEmptyError,
                      RestoreTsBelowBackupError)
from ..models import TableInfo, SchemaState
from ..models.schema import DBInfo
from ..models.job import DDLJob, TYPE_RESTORE, STATE_SYNCED
from ..tools.objstore import open_storage, LocalStorage
from ..utils import failpoint
from ..utils import metrics as metrics_util
from . import logformat
from .snapshot import read_manifest

LOG_OBJECT = "log/backup.log"
_REPLAY_CKPT_EVERY = 64


# ---- submission ---------------------------------------------------------

def submit_restore(domain, db_name: str, path: str,
                   until_ts=None) -> int:
    """RESTORE DATABASE {db|*} FROM '<path>' [UNTIL TS n] — validate,
    enqueue the durable job, drive it, return rows restored."""
    store = open_storage(path)
    manifest = read_manifest(store)
    if manifest is None:
        raise TiDBError("backupmeta.json not found in %s", path)
    if int(manifest.get("version", 1)) < 2:
        # pre-chunked layout: the legacy engine still reads it
        from ..tools import br as legacy
        return legacy.restore(domain, db_name, path)
    if not manifest.get("complete"):
        raise TiDBError(
            "backup at %s is incomplete — re-run BACKUP DATABASE to "
            "the same target to finish it first", path)
    backup_ts = int(manifest["backup_ts"])
    if until_ts is not None and int(until_ts) < backup_ts:
        raise RestoreTsBelowBackupError(
            "UNTIL TS %d is below the snapshot backup_ts %d — the log "
            "backup only covers commits after the snapshot",
            int(until_ts), backup_ts)
    entries = _entries_for(manifest, db_name)
    if not entries:
        return 0
    ischema = domain.infoschema()
    ids_in_use = {t.id for d in ischema.all_schemas()
                  for t in ischema.tables_in_schema(d.name)}
    for e in entries:
        tname = e["table"]["name"]
        if ischema.has_schema(e["db"]) and \
                ischema.has_table(e["db"], tname):
            raise RestoreTargetNotEmptyError(
                "restore target already has table `%s`.`%s` — drop it "
                "(or restore into a fresh store) first", e["db"], tname)
        if int(e["table"]["id"]) in ids_in_use:
            raise RestoreTargetNotEmptyError(
                "restore target already uses table id %d (held by "
                "another table) — restore into a fresh store",
                int(e["table"]["id"]))
    row_total = sum(int(c["rows"]) for e in entries
                    for c in e["chunks"])
    job = DDLJob(
        type=TYPE_RESTORE, db_name=db_name or "*", table_name="*",
        row_total=row_total,
        args={"path": path, "db": db_name, "phase": "schema",
              "backup_ts": backup_ts,
              "until_ts": None if until_ts is None else int(until_ts),
              "created": [], "tables_done": [], "base_n": {},
              "bytes": 0, "imported": 0, "replayed": 0,
              "replay_ts": backup_ts})
    final = domain.ddl_jobs.submit(job)
    return int(final.row_done)


def _entries_for(manifest, db_name):
    return [e for e in manifest.get("tables", [])
            if not db_name or e["db"].lower() == db_name.lower()]


# ---- job handler (called from DDLJobRunner._run_job) --------------------

def run_restore_job(runner, job, cancel_check):
    dom = runner.domain
    store = open_storage(job.args["path"])
    manifest = read_manifest(store)
    if manifest is None or not manifest.get("complete"):
        raise TiDBError("backup at %s vanished or is incomplete",
                        job.args["path"])
    entries = _entries_for(manifest, job.args.get("db") or "")
    from ..utils import tracing as _tracing
    try:
        # one span per restore phase, under the job's durable trace
        # (ddljob-<id>) — a restore resumed after a crash keeps
        # correlating with its pre-crash phase spans
        if job.args.get("phase") == "schema":
            with _tracing.span("restore_schema", job=job.id):
                _phase_schema(runner, job, entries)
        if job.args.get("phase") == "import":
            with _tracing.span("restore_import", job=job.id):
                _phase_import(runner, job, store, entries, cancel_check)
        if job.args.get("phase") == "replay":
            with _tracing.span("restore_replay", job=job.id):
                _phase_replay(runner, job, store, entries, cancel_check)
    except BaseException:
        metrics_util.BACKUP_TOTAL.labels("restore_run", "error").inc()
        raise
    job.args["phase"] = "done"
    job.state = STATE_SYNCED
    runner._terminal_txn(job, lambda m: m.finish_ddl_job(job))
    runner._mark(job, STATE_SYNCED)
    dom.invalidate_plan_cache()
    metrics_util.BACKUP_TOTAL.labels("restore_run", "ok").inc()


def _gauge(job):
    imp = int(job.args.get("imported", 0))
    rep = int(job.args.get("replayed", 0))
    metrics_util.RESTORE_ROWS.labels("imported").set(imp)
    metrics_util.RESTORE_ROWS.labels("replayed").set(rep)
    metrics_util.RESTORE_ROWS.labels("total").set(imp + rep)
    job.row_done = imp + rep


def _phase_schema(runner, job, entries):
    dom = runner.domain
    backup_ts = int(job.args["backup_ts"])
    # every post-restore commit (and the bulk rows themselves) must
    # land at/above the snapshot point
    dom.storage.oracle.fast_forward(backup_ts)
    prior_created = [list(x) for x in job.args.get("created", [])]

    def fn(m):
        created = []
        dbs = {d.name.lower(): d for d in m.list_databases()}
        used_ids = {t.id for d in m.list_databases()
                    for t in m.list_tables(d.id)}
        max_id = 0
        for e in entries:
            tinfo = TableInfo.from_json(e["table"])
            # mid-ladder indexes have no complete backfill in the
            # snapshot: restore the consistent subset (PUBLIC only)
            tinfo.indexes = [i for i in tinfo.indexes
                             if i.state == SchemaState.PUBLIC]
            dbi = dbs.get(e["db"].lower())
            if dbi is None:
                dbi = DBInfo(id=m.gen_global_id(), name=e["db"])
                m.create_database(dbi)
                dbs[dbi.name.lower()] = dbi
            max_id = max(max_id, tinfo.id,
                         *[int(p["pid"]) for p in
                           (tinfo.partitions or {}).get("parts", [])]
                         or [0])
            if m.get_table(dbi.id, tinfo.id) is not None:
                continue       # resume re-entry: already created by us
            if tinfo.id in used_ids:
                raise RestoreTargetNotEmptyError(
                    "restore target already uses table id %d", tinfo.id)
            m.create_table(dbi.id, tinfo)
            used_ids.add(tinfo.id)
            created.append([e["db"], int(tinfo.id)])
        m.ensure_global_id_above(max_id)
        job.args["created"] = prior_created + created
    runner._step_txn(job, fn, bump_version=True)
    # crash here: schema durable, phase flip not — restart re-enters
    # the schema txn, which skips every already-created table
    failpoint.inject("br-restore-pre-swap")
    job.args["phase"] = "import"
    runner._step_txn(job, lambda m: None, bump_version=False)


def _read_chunk(store, ch):
    """Chunk bytes, crc32-verified against the manifest; any way the
    artifact can be wrong (missing, short, flipped, undecodable)
    surfaces as the SAME typed error."""
    try:
        data = store.read(ch["name"])
    except (OSError, KeyError):
        raise BackupChecksumMismatchError(
            "backup chunk %s is missing from the target", ch["name"])
    if zlib.crc32(data) & 0xFFFFFFFF != int(ch["crc32"]) or \
            len(data) != int(ch["bytes"]):
        raise BackupChecksumMismatchError(
            "backup chunk %s failed its checksum (%d bytes on store, "
            "%d expected) — truncated or bit-flipped artifact",
            ch["name"], len(data), int(ch["bytes"]))
    try:
        return np.load(io.BytesIO(data), allow_pickle=False)
    except Exception:
        raise BackupChecksumMismatchError(
            "backup chunk %s is undecodable despite a matching "
            "checksum", ch["name"])


def _phase_import(runner, job, store, entries, cancel_check):
    dom = runner.domain
    backup_ts = int(job.args["backup_ts"])
    done = {tuple(x) for x in job.args.get("tables_done", [])}
    for e in entries:
        key = (e["db"], e["table"]["name"])
        if key in done:
            continue
        runner._check_cancel(job, cancel_check)
        tinfo = dom.infoschema().table_by_name(*key)
        if tinfo is None:
            raise TiDBError("restored table `%s`.`%s` vanished "
                            "mid-job", *key)
        ctab = dom.columnar.table(tinfo)
        bkey = "%s.%s" % key
        base_map = job.args.setdefault("base_n", {})
        if bkey not in base_map:
            # pin the pre-import durable row count: after a crash,
            # (ctab.n - base) rows of this table provably survived as
            # bulk segments — the resume point, checkpoint or not
            base_map[bkey] = int(ctab.n)
            runner._step_txn(job, lambda m: None, bump_version=False)
        done_rows = max(int(ctab.n) - int(base_map[bkey]), 0)
        try:
            dicts = json.loads(store.read(f"{key[0]}.{key[1]}"
                                          ".dicts.json"))
        except (OSError, KeyError, ValueError):
            raise BackupChecksumMismatchError(
                "dictionary file for `%s`.`%s` is missing or "
                "unreadable", *key)
        cum = 0
        for ch in e["chunks"]:
            rows = int(ch["rows"])
            cum += rows
            if cum <= done_rows:
                continue               # durable from a prior attempt
            z = _read_chunk(store, ch)
            columns, nulls = {}, {}
            for ci in tinfo.columns:
                dk = f"d_{ci.id}"
                if dk not in z:
                    continue
                arr = z[dk]
                if str(ci.id) in dicts:
                    arr = ctab.dicts[ci.id].translate_codes(
                        dicts[str(ci.id)], arr)
                columns[ci.name] = arr
                nk = f"n_{ci.id}"
                if nk in z and z[nk].any():
                    nulls[ci.name] = z[nk]
            ctab.bulk_append(columns, rows, handles=z["__handles"],
                             commit_ts=backup_ts, nulls=nulls or None)
            dom.persist_bulk_segment(tinfo, ctab, ctab.n - rows, rows)
            job.args["imported"] = int(job.args.get("imported", 0)) \
                + rows
            job.args["bytes"] = int(job.args.get("bytes", 0)) \
                + int(ch["bytes"])
            _gauge(job)
            runner._step_txn(job, lambda m: None, bump_version=False)
            # crash here: segment + checkpoint both durable — resume
            # continues at the next chunk
            failpoint.inject("br-restore-checkpoint")
        done.add(key)
        job.args["tables_done"] = sorted([list(k) for k in done])
        runner._step_txn(job, lambda m: None, bump_version=False)
        metrics_util.BACKUP_TOTAL.labels("restore_table", "ok").inc()
        failpoint.inject("br-restore-checkpoint")
    dom.invalidate_plan_cache()
    job.args["phase"] = "replay"
    runner._step_txn(job, lambda m: None, bump_version=False)


def log_file_path(store):
    """Local filesystem path of the backup's log file, spooling it out
    of a non-local object store; None when the backup has no log."""
    if isinstance(store, LocalStorage):
        p = os.path.join(store.root, *LOG_OBJECT.split("/"))
        return p if os.path.exists(p) else None
    if not store.exists(LOG_OBJECT):
        return None
    import tempfile
    fd, p = tempfile.mkstemp(prefix="br_log_", suffix=".log")
    with os.fdopen(fd, "wb") as f:
        f.write(store.read(LOG_OBJECT))
    return p


def _phase_replay(runner, job, store, entries, cancel_check):
    dom = runner.domain
    until = job.args.get("until_ts")
    backup_ts = int(job.args["backup_ts"])
    path = log_file_path(store)
    if path is None:
        if until is not None and int(until) > backup_ts:
            raise TiDBError(
                "UNTIL TS %d needs a log backup, but the target has "
                "no %s", int(until), LOG_OBJECT)
        return
    # restored physical ids -> TableInfo (replay only touches tables
    # this job restored; foreign txns in a shared log are skipped)
    tmap = {}
    for e in entries:
        tinfo = dom.infoschema().table_by_name(e["db"],
                                               e["table"]["name"])
        if tinfo is None:
            continue
        tmap[tinfo.id] = tinfo
        for p in (tinfo.partitions or {}).get("parts", []):
            tmap[int(p["pid"])] = tinfo
    applied_floor = int(job.args.get("replay_ts") or backup_ts)
    last_applied = applied_floor
    since_ckpt = 0
    for rec in logformat.scan(path):
        if rec[0] != "txn":
            continue           # resolved/ddl markers carry no rows
        _, commit_ts, muts, _wall = rec
        # <= last_applied covers three skips at once: pre-snapshot
        # commits, the durable resume point, and at-least-once sink
        # redelivery (a feed resume rewrites frames already in the file)
        if commit_ts <= last_applied or commit_ts <= backup_ts:
            continue
        if until is not None and commit_ts > int(until):
            continue
        full, nrows = _txn_mutations(dom, tmap, muts, commit_ts)
        if full:
            runner._check_cancel(job, cancel_check)
            dom.storage.oracle.fast_forward(commit_ts)
            dom.storage.mvcc.ingest(full, commit_ts)
            job.args["replayed"] = int(job.args.get("replayed", 0)) \
                + nrows
            _gauge(job)
            failpoint.inject("br-restore-replay")
        last_applied = commit_ts
        since_ckpt += 1
        if since_ckpt >= _REPLAY_CKPT_EVERY:
            since_ckpt = 0
            job.args["replay_ts"] = last_applied
            runner._step_txn(job, lambda m: None, bump_version=False)
            failpoint.inject("br-restore-checkpoint")
    job.args["replay_ts"] = last_applied
    _gauge(job)
    runner._step_txn(job, lambda m: None, bump_version=False)


def _txn_mutations(dom, tmap, muts, commit_ts):
    """One log transaction -> record mutations on restored tables plus
    the index mutations their row bytes imply. Synthesized (the log
    carries record KV only — capture drops index keys) against the
    RESTORED store's pre-apply state: ``value_before`` is exact because
    replay runs in commit_ts order. Later writes win on key collisions
    (an update's delete-old/put-new on an unchanged index key)."""
    from ..executor.table_rt import _index_datums, _handle_bytes
    merged = {}
    nrows = 0
    for key, value in muts:
        try:
            pid, handle = decode_record_key(key)
        except Exception:
            continue
        tinfo = tmap.get(pid)
        if tinfo is None:
            continue
        nrows += 1
        old_raw = dom.storage.mvcc.value_before(key, commit_ts)
        ncols = len(tinfo.columns)
        for row, is_new in ((old_raw, False), (value, True)):
            if row is None:
                continue
            datums = decode_row_value(row)[:ncols]
            for idx in tinfo.public_indexes():
                d = _index_datums(tinfo, idx, datums)
                if idx.unique and not any(x.is_null for x in d):
                    ik = index_key(tinfo.id, idx.id, d)
                    merged[ik] = _handle_bytes(handle) if is_new \
                        else None
                else:
                    ik = index_key(tinfo.id, idx.id, d, handle)
                    merged[ik] = b"" if is_new else None
        merged[key] = value
    return list(merged.items()), nrows


# ---- rollback (called from DDLJobRunner._rollback) ----------------------

def rollback_restore(runner, job):
    """Undo a failed restore: drop every table THIS job created (meta
    + columnar + index delete-ranges). Leftover record-KV versions of
    a partially replayed table die with the table id — a later restore
    of the same backup recreates the id and replays the same frames,
    which converges."""
    created = [tuple(x) for x in job.args.get("created", [])]
    if not created:
        return

    def fn(m):
        dbs = {d.name.lower(): d for d in m.list_databases()}
        for dbn, tid in created:
            dbi = dbs.get(str(dbn).lower())
            if dbi is None:
                continue
            t = m.get_table(dbi.id, int(tid))
            if t is None:
                continue
            m.drop_table(dbi.id, int(tid))
            for idx in t.indexes:
                m.add_delete_range(int(tid), idx.id)
    runner._retry_txn(fn, bump_version=True,
                      what="restore rollback %d" % job.id)
    for _dbn, tid in created:
        runner.domain.columnar.drop_table(int(tid))
    runner.domain.invalidate_plan_cache()
