"""Backup & Restore engine (reference br/ — snapshot backup/restore with
manifest + per-table checkpoints; re-designed around the columnar engine:
a table backs up as its consolidated arrays, not SSTs).

Layout of a backup directory:
    backupmeta.json                manifest: dbs, tables, versions, done-list
    {db}.{table}.npz               column arrays + handles + MVCC ts arrays
    {db}.{table}.dicts.json        string dictionaries

Checkpointing (reference br/pkg/checkpoint): each completed table is
recorded in the manifest's `done` list; a re-run of the same backup skips
completed tables, a restore skips already-restored ones."""
from __future__ import annotations

import io
import json
import os

import numpy as np

from ..errors import TiDBError
from ..models import TableInfo
from .objstore import open_storage, LocalStorage


def backup(domain, db_name: str, path: str) -> int:
    store = open_storage(path)
    ischema = domain.infoschema()
    dbs = ([ischema.schema_by_name(db_name)] if db_name
           else [d for d in ischema.all_schemas()
                 if d.name.lower() not in ("mysql", "information_schema")])
    manifest = {"version": 1, "dbs": [], "tables": [], "done": []}
    if store.exists("backupmeta.json"):
        manifest = json.loads(store.read("backupmeta.json"))
    done = set(tuple(x) for x in manifest.get("done", []))
    manifest["dbs"] = [{"name": d.name} for d in dbs]
    # one backup_ts for the whole run: every table filters to versions
    # visible at this ts, so concurrent writes can't produce a backup
    # where table A and table B reflect different moments
    backup_ts = manifest.get("backup_ts") or domain.storage.current_ts()
    manifest["backup_ts"] = backup_ts
    tables_meta = []
    count = 0
    for d in dbs:
        for t in ischema.tables_in_schema(d.name):
            tables_meta.append({"db": d.name, "table": t.to_json()})
            key = (d.name, t.name)
            if key in [tuple(k) for k in done]:
                continue
            _backup_table(domain, d.name, t, store, backup_ts)
            manifest.setdefault("done", []).append([d.name, t.name])
            count += 1
            manifest["tables"] = tables_meta
            # checkpoint after each table
            store.write("backupmeta.json",
                        json.dumps(manifest).encode())
    manifest["tables"] = tables_meta
    store.write("backupmeta.json", json.dumps(manifest).encode())
    return count


def _backup_table(domain, db_name, t, store, backup_ts=None):
    ctab = domain.columnar.tables.get(t.id)
    base = f"{db_name}.{t.name}"
    arrays = {}
    dicts = {}
    if ctab is not None and ctab.n:
        # hold the apply lock so a concurrent commit can't interleave
        # a half-applied mutation batch into the captured arrays
        with domain.columnar._apply_mu:
            idx = np.nonzero(ctab.valid_at(backup_ts))[0]
            arrays["__handles"] = ctab.handles[idx].copy()
            arrays["__insert_ts"] = ctab.insert_ts[idx].copy()
            arrays["__delete_ts"] = np.zeros(len(idx), dtype=np.int64)
            for ci in t.columns:
                arrays[f"d_{ci.id}"] = ctab.data[ci.id][idx].copy()
                arrays[f"n_{ci.id}"] = ctab.nulls[ci.id][idx].copy()
                if ci.id in ctab.dicts:
                    dicts[str(ci.id)] = list(ctab.dicts[ci.id].values)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    store.write(base + ".npz", buf.getvalue())
    store.write(base + ".dicts.json", json.dumps(dicts).encode())


def restore(domain, db_name: str, path: str) -> int:
    store = open_storage(path)
    if not store.exists("backupmeta.json"):
        raise TiDBError("backupmeta.json not found in %s", path)
    manifest = json.loads(store.read("backupmeta.json"))
    from ..session import Session
    sess = Session(domain)
    count = 0
    for entry in manifest["tables"]:
        src_db = entry["db"]
        if db_name and src_db.lower() != db_name.lower():
            continue
        t = TableInfo.from_json(entry["table"])
        sess.execute(f"create database if not exists `{src_db}`")
        sess.vars.current_db = src_db
        # recreate the table (fresh id) from the backed-up definition
        sess.execute(f"drop table if exists `{src_db}`.`{t.name}`")
        _create_from_info(sess, src_db, t)
        new_t = domain.infoschema().table_by_name(src_db, t.name)
        ctab = domain.columnar.table(new_t)
        base = f"{src_db}.{t.name}"
        if not store.exists(base + ".npz"):
            continue
        z = np.load(io.BytesIO(store.read(base + ".npz")),
                    allow_pickle=False)
        dicts = json.loads(store.read(base + ".dicts.json"))
        if "__handles" in z:
            n = len(z["__handles"])
            ctab._ensure(n)
            ctab.handles[:n] = z["__handles"]
            ctab.insert_ts[:n] = 1
            ctab.delete_ts[:n] = np.where(z["__delete_ts"] > 0, 1, 0)
            # map old column ids -> new by offset (same column order)
            for old_ci, new_ci in zip(t.columns, new_t.columns):
                ctab.data[new_ci.id][:n] = z[f"d_{old_ci.id}"]
                ctab.nulls[new_ci.id][:n] = z[f"n_{old_ci.id}"]
                if str(old_ci.id) in dicts:
                    d = ctab.dicts[new_ci.id]
                    for v in dicts[str(old_ci.id)]:
                        d.encode_one(v)
            ctab.n = n
            ctab.handle_pos = {int(h): i
                               for i, h in enumerate(z["__handles"].tolist())}
            # restored rows have no row/index KV backing — flag them so
            # index-driven read paths aren't chosen for this table
            ctab.bulk_rows = n
            ctab.version += 1
        count += 1
    domain.invalidate_plan_cache()
    return count


def _create_from_info(sess, db, t: TableInfo):
    cols = []
    for c in t.columns:
        line = f"`{c.name}` {c.ft.sql_string()}"
        if c.ft.not_null:
            line += " NOT NULL"
        if c.ft.auto_increment:
            line += " AUTO_INCREMENT"
        if c.ft.has_default and c.ft.default_value is not None:
            line += f" DEFAULT '{c.ft.default_value}'"
        cols.append(line)
    if t.pk_is_handle:
        cols.append(f"PRIMARY KEY (`{t.pk_col_name}`)")
    for idx in t.indexes:
        colstr = ", ".join(f"`{c}`" for c in idx.columns)
        if idx.primary:
            cols.append(f"PRIMARY KEY ({colstr})")
        elif idx.unique:
            cols.append(f"UNIQUE KEY `{idx.name}` ({colstr})")
        else:
            cols.append(f"KEY `{idx.name}` ({colstr})")
    sess.execute(f"create table `{db}`.`{t.name}` ({', '.join(cols)})")


# ---- PITR (reference br/pkg/stream — log backup + point-in-time
# restore; here the commit WAL is the log: BACKUP LOG copies it, RESTORE
# ... UNTIL TIMESTAMP replays frames whose commit wallclock <= target
# into a fresh store) -----------------------------------------------------

def backup_log(domain, path: str) -> int:
    """Copy the WAL (and checkpoint snapshot, if any) to <store>/log/."""
    import time
    if not domain.data_dir:
        from ..errors import TiDBError
        raise TiDBError("BACKUP LOG requires a --data-dir store")
    store = open_storage(path)

    def put_file(src, name):
        with open(src, "rb") as f:
            store.write("log/" + name, f.read())
    wal = os.path.join(domain.data_dir, "commit.wal")
    n = 0
    w = domain.storage.mvcc.wal
    if w is not None:
        w._f.flush()
    # flushed LSM runs hold commits the WAL no longer does — they are
    # part of the log backup (each entry carries its commit wallclock)
    from ..storage import sst
    for rp in sst.run_files(domain.data_dir):
        put_file(rp, os.path.basename(rp))
        n += 1
    if os.path.exists(wal):
        put_file(wal, "commit.wal")
        from ..storage.wal import replay as _replay
        n += sum(1 for _ in _replay(wal))
    ckpt = os.path.join(domain.data_dir, "checkpoint.snap")
    meta = {"backup_wall": time.time(), "has_checkpoint": False}
    if os.path.exists(ckpt):
        put_file(ckpt, "checkpoint.snap")
        meta["has_checkpoint"] = True
        meta["checkpoint_mtime"] = os.path.getmtime(ckpt)
    store.write("log/pitr_meta.json", json.dumps(meta).encode())
    return n


def restore_pitr(domain, path: str, until_wall: float) -> int:
    """Replay the log backup into `domain` up to `until_wall` (intended
    for a fresh store — the reference restores PITR into a new cluster).
    Non-local object stores spool to a temp dir first: WAL/run replay
    reads files, and a log restore is a rare, whole-artifact download
    anyway (reference br restores pull the log segments down too)."""
    store = open_storage(path)
    spool = None
    if isinstance(store, LocalStorage):
        dst = os.path.join(store.root, "log")
    else:
        import tempfile
        spool = tempfile.mkdtemp(prefix="pitr_spool_")
        dst = os.path.join(spool, "log")
        os.makedirs(dst, exist_ok=True)
        for name in store.list("log/"):
            with open(os.path.join(dst, name.split("/", 1)[1]),
                      "wb") as f:
                f.write(store.read(name))
    try:
        return _restore_pitr_dir(domain, dst, until_wall)
    finally:
        if spool is not None:
            import shutil
            shutil.rmtree(spool, ignore_errors=True)


def _restore_pitr_dir(domain, dst: str, until_wall: float) -> int:
    from ..errors import TiDBError
    from ..storage.wal import decode_checkpoint
    meta_path = os.path.join(dst, "pitr_meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    ckpt = os.path.join(dst, "checkpoint.snap")
    applied = 0
    if meta.get("has_checkpoint"):
        if until_wall < meta.get("checkpoint_mtime", 0):
            raise TiDBError(
                "PITR target predates the checkpoint in this log backup")
        with open(ckpt, "rb") as f:
            ckpt_ts, triples = decode_checkpoint(f.read())
        triples.sort(key=lambda t: t[0])
        i = 0
        while i < len(triples):
            ts = triples[i][0]
            muts = []
            while i < len(triples) and triples[i][0] == ts:
                muts.append((triples[i][1], triples[i][2]))
                i += 1
            domain.storage.oracle.fast_forward(ts)
            domain.storage.mvcc.apply_replay(ts, muts)
            applied += 1
    # flushed runs first (older commits), then the WAL tail; both filter
    # by commit wallclock. Skip (not break on) out-of-range entries:
    # wallclocks are not guaranteed monotonic
    from ..storage import sst
    for rp in sst.run_files(dst):
        by_ts: dict = {}
        for ts, k, v, wall in sst.read_run(rp):
            if wall > until_wall:
                continue
            by_ts.setdefault(ts, []).append((k, v))
        for ts in sorted(by_ts):
            domain.storage.oracle.fast_forward(ts)
            domain.storage.mvcc.apply_replay(ts, by_ts[ts])
            applied += 1
    from ..storage.wal import replay as _replay
    for commit_ts, mutations, wall in _replay(
            os.path.join(dst, "commit.wal")):
        if wall > until_wall:
            continue
        domain.storage.oracle.fast_forward(commit_ts)
        domain.storage.mvcc.apply_replay(commit_ts, mutations)
        applied += 1
    domain.is_cache._cached = None
    return applied
