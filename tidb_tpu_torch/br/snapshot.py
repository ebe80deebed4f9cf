"""Snapshot backup (reference br/pkg/backup + br/pkg/checkpoint,
re-designed for the columnar engine: a table backs up columnar-direct
— its consolidated arrays sliced into checksummed chunk objects — not
row-at-a-time KV scans).

Consistency point: ONE ``mvcc.resolved_floor`` ts for the whole run.
The floor is the largest ts R such that every commit at/below R has
been published to the commit hooks (columnar apply included) and no
future commit can land at/below R — so filtering every table's arrays
with ``valid_at(backup_ts)`` under the apply lock yields a cross-table
consistent snapshot even under a concurrent OLTP write load, without
blocking writers.

Backup directory layout (v2; `tools/objstore.open_storage` backends):

    backupmeta.json                     manifest (below)
    {db}.{table}.chunk{NNN}.npz         per-chunk arrays + crc32'd
    {db}.{table}.dicts.json             string dictionaries
    log/backup.log                      (optional) log-backup file

Manifest: ``{"version": 2, "backup_ts", "schema_epoch",
"cluster_epoch", "dbs": [names], "tables": [{"db", "table": <TableInfo
JSON>, "chunks": [{"name", "rows", "bytes", "crc32"}], "dict_bytes"}],
"done": [[db, table]…], "complete": bool}``. ``done`` is the
per-table checkpoint (reference br/pkg/checkpoint): a re-run of the
same backup skips completed tables at the SAME backup_ts; a COMPLETE
target only accepts a re-run of the same database set
(BackupTargetExistsError otherwise).
"""
from __future__ import annotations

import io
import json
import zlib

import numpy as np

from ..errors import BackupTargetExistsError, TiDBError
from ..tools.objstore import open_storage
from ..utils import failpoint
from ..utils import metrics as metrics_util

MANIFEST = "backupmeta.json"
# rows per chunk object; small enough that a kill -9 between chunks
# loses bounded work, large enough that npz framing stays cheap
DEFAULT_CHUNK_ROWS = 4096


def chunk_rows_setting() -> int:
    import os
    try:
        return max(int(os.environ.get("TIDB_TPU_BR_CHUNK_ROWS",
                                      DEFAULT_CHUNK_ROWS)), 1)
    except ValueError:
        return DEFAULT_CHUNK_ROWS


def read_manifest(store):
    """Parse the manifest or None when absent; a present-but-unparsable
    object means the target is not (or no longer) a backup directory."""
    if not store.exists(MANIFEST):
        return None
    try:
        return json.loads(store.read(MANIFEST))
    except (ValueError, OSError):
        raise BackupTargetExistsError(
            "backup target holds an unreadable %s — not a backup "
            "directory (or a corrupted one)", MANIFEST)


def _new_run(domain, kind, path):
    rec = {"id": len(domain._br_runs) + 1, "kind": kind, "path": path,
           "phase": "init", "state": "running", "backup_ts": 0,
           "bytes": 0, "checkpoint": "", "error": ""}
    domain._br_runs.append(rec)
    return rec


def run_backup(domain, db_name: str, path: str) -> int:
    """BACKUP DATABASE {db|*} TO '<path>' — returns the number of
    tables exported this run (0 = everything was already in the
    done-list: the checkpoint-skip re-run)."""
    store = open_storage(path)
    run = _new_run(domain, "backup", path)
    try:
        n = _run_backup(domain, db_name, store, run)
        run["state"] = "done"
        run["phase"] = "complete"
        metrics_util.BACKUP_TOTAL.labels("snapshot_run", "ok").inc()
        return n
    except BaseException as e:
        run["state"] = "error"
        run["error"] = "%s: %s" % (type(e).__name__,
                                   getattr(e, "msg", str(e)))
        metrics_util.BACKUP_TOTAL.labels("snapshot_run", "error").inc()
        raise


def _run_backup(domain, db_name, store, run) -> int:
    ischema = domain.infoschema()
    if db_name:
        db = ischema.schema_by_name(db_name)
        if db is None:
            raise TiDBError("Unknown database '%s'", db_name)
        dbs = [db]
    else:
        dbs = [d for d in ischema.all_schemas()
               if d.name.lower() not in ("mysql", "information_schema")]
    db_set = sorted(d.name.lower() for d in dbs)

    manifest = read_manifest(store)
    if manifest is None:
        manifest = {"version": 2, "dbs": [], "tables": [], "done": [],
                    "complete": False}
    elif int(manifest.get("version", 1)) < 2:
        raise BackupTargetExistsError(
            "backup target holds a v%s backup — point the new backup "
            "at an empty directory", manifest.get("version", 1))
    elif manifest.get("complete") and \
            sorted(manifest.get("dbs", [])) != db_set:
        raise BackupTargetExistsError(
            "backup target already holds a complete backup of %s",
            ",".join(manifest.get("dbs", [])) or "<nothing>")

    # ONE ts for the whole run — resumed runs keep the original floor
    # so every table (first run or re-run) reflects the same moment
    backup_ts = manifest.get("backup_ts")
    if not backup_ts:
        backup_ts = domain.storage.mvcc.resolved_floor(
            domain.storage.oracle.get_ts())
    manifest["backup_ts"] = int(backup_ts)
    manifest["dbs"] = db_set
    manifest["schema_epoch"] = int(getattr(domain, "schema_epoch", 0))
    manifest["cluster_epoch"] = int(getattr(domain, "cluster_epoch", 0))
    run["backup_ts"] = int(backup_ts)
    run["phase"] = "snapshot"

    # schema captured once, up front: a DDL landing mid-run changes
    # neither the manifest's table JSON nor the backup_ts-filtered
    # arrays (see docs/BACKUP.md on DDL-storm consistency)
    plan = []
    for d in dbs:
        for t in ischema.tables_in_schema(d.name):
            if t.view_select or t.sequence:
                continue
            plan.append((d.name, t))
    done = {tuple(x) for x in manifest.get("done", [])}
    tables_meta = list(manifest.get("tables", []))
    count = 0
    for dbn, t in plan:
        key = (dbn, t.name)
        if key in done:
            metrics_util.BACKUP_TOTAL.labels(
                "snapshot_table", "skipped").inc()
            continue
        run["checkpoint"] = "%s.%s" % key
        try:
            entry = _backup_table(domain, dbn, t, store, backup_ts, run)
        except BaseException:
            metrics_util.BACKUP_TOTAL.labels(
                "snapshot_table", "error").inc()
            raise
        # drop a stale entry from a crashed earlier attempt, then
        # checkpoint: chunks durable FIRST, manifest row second
        tables_meta = [e for e in tables_meta
                       if (e["db"], e["table"]["name"]) != key]
        tables_meta.append(entry)
        manifest["tables"] = tables_meta
        manifest["done"] = sorted([list(k) for k in (done | {key})])
        done.add(key)
        count += 1
        # crash here: chunks exist, manifest doesn't know — the re-run
        # re-exports this table at the same backup_ts (idempotent puts)
        failpoint.inject("br-manifest-write")
        store.write(MANIFEST, json.dumps(manifest).encode())
        metrics_util.BACKUP_TOTAL.labels("snapshot_table", "ok").inc()
    manifest["complete"] = True
    store.write(MANIFEST, json.dumps(manifest).encode())
    return count


def _backup_table(domain, dbn, t, store, backup_ts, run) -> dict:
    """Export one table's valid-at-backup_ts rows into chunk objects;
    returns its manifest entry."""
    ctab = domain.columnar.tables.get(t.id)
    arrays = {}
    dicts = {}
    nrows = 0
    if ctab is not None and ctab.n:
        # the apply lock keeps a concurrent commit's half-applied
        # mutation batch out of the captured arrays; the filter keeps
        # post-backup_ts commits out of the backup
        with domain.columnar._apply_mu:
            idx = np.nonzero(ctab.valid_at(backup_ts))[0]
            nrows = len(idx)
            arrays["__handles"] = ctab.handles[idx].copy()
            arrays["__insert_ts"] = ctab.insert_ts[idx].copy()
            for ci in t.columns:
                if ci.id not in ctab.data:
                    # column dropped since the schema was captured:
                    # back up explicit NULLs for it
                    arrays[f"d_{ci.id}"] = np.zeros(nrows, dtype=np.int64)
                    arrays[f"n_{ci.id}"] = np.ones(nrows, dtype=bool)
                    continue
                arrays[f"d_{ci.id}"] = ctab.data[ci.id][idx].copy()
                arrays[f"n_{ci.id}"] = ctab.nulls[ci.id][idx].copy()
                if ci.id in ctab.dicts:
                    dicts[str(ci.id)] = list(ctab.dicts[ci.id].values)
    base = f"{dbn}.{t.name}"
    step = chunk_rows_setting()
    chunks = []
    for cno, start in enumerate(range(0, nrows, step)):
        end = min(start + step, nrows)
        sl = {k: v[start:end] for k, v in arrays.items()}
        buf = io.BytesIO()
        np.savez_compressed(buf, **sl)
        data = buf.getvalue()
        name = f"{base}.chunk{cno:03d}.npz"
        store.write(name, data)
        chunks.append({"name": name, "rows": int(end - start),
                       "bytes": len(data),
                       "crc32": zlib.crc32(data) & 0xFFFFFFFF})
        run["bytes"] += len(data)
        # crash here: this table never reached the done-list — the
        # re-run re-exports all of its chunks (atomic puts overwrite)
        failpoint.inject("br-backup-chunk")
    dict_bytes = json.dumps(dicts).encode()
    store.write(base + ".dicts.json", dict_bytes)
    run["bytes"] += len(dict_bytes)
    return {"db": dbn, "table": t.to_json(), "chunks": chunks,
            "dict_bytes": len(dict_bytes)}
