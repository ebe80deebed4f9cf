"""SHOW / DESCRIBE statements (reference pkg/executor/show.go)."""
from __future__ import annotations

import time

import fnmatch

import numpy as np

from ..chunk.chunk import Chunk
from ..chunk.column import Column
from ..types.field_type import new_string_type
from .sysvars import all_sysvars


def _str_chunk(names, rows):
    cols = []
    for j in range(len(names)):
        arr = np.empty(len(rows), dtype=object)
        nulls = np.zeros(len(rows), dtype=bool)
        for i, r in enumerate(rows):
            v = r[j]
            if v is None:
                nulls[i] = True
                arr[i] = ""
            else:
                arr[i] = str(v)
        cols.append(Column(new_string_type(), arr,
                           nulls if nulls.any() else None))
    from .session import ResultSet
    return ResultSet(names=names, chunks=[Chunk(cols)])


def _like_filter(rows, like, col=0):
    if not like:
        return rows
    pat = like.replace("%", "*").replace("_", "?")
    return [r for r in rows if fnmatch.fnmatch(str(r[col]).lower(),
                                               pat.lower())]


def exec_show(sess, stmt):
    kind = stmt.kind
    ischema = sess.domain.infoschema()
    if kind == "databases":
        rows = sorted([(db.name,) for db in ischema.all_schemas()])
        return _str_chunk(["Database"], _like_filter(rows, stmt.like))
    if kind == "tables":
        db = stmt.db or sess.vars.current_db
        from ..errors import NoDatabaseSelectedError
        if not db:
            raise NoDatabaseSelectedError("No database selected")
        rows = sorted([(t.name,) for t in ischema.tables_in_schema(db)])
        return _str_chunk([f"Tables_in_{db}"], _like_filter(rows, stmt.like))
    if kind == "columns":
        db = stmt.db or stmt.table.db or sess.vars.current_db
        tbl = ischema.table_by_name(db, stmt.table.name)
        rows = []
        for c in tbl.public_columns():
            key = ""
            if tbl.pk_is_handle and c.name.lower() == tbl.pk_col_name.lower():
                key = "PRI"
            else:
                for idx in tbl.indexes:
                    if idx.columns and idx.columns[0].lower() == c.name.lower():
                        key = "PRI" if idx.primary else (
                            "UNI" if idx.unique else "MUL")
                        break
            rows.append((c.name, c.ft.sql_string(),
                         "NO" if c.ft.not_null else "YES", key,
                         c.ft.default_value if c.ft.has_default else None,
                         "auto_increment" if c.ft.auto_increment else ""))
        return _str_chunk(["Field", "Type", "Null", "Key", "Default", "Extra"],
                          _like_filter(rows, stmt.like))
    if kind == "models":
        rows = sorted(
            [(h.name, h.kind, h.info.uri, h.info.nbytes, h.version)
             for h in sess.domain.ml.handles()])
        return _str_chunk(["Model", "Kind", "Uri", "Bytes", "Version"],
                          _like_filter(rows, stmt.like))
    if kind == "variables":
        seen = {}
        for name, var in sorted(all_sysvars().items()):
            seen[name] = sess.vars.get(name)
        rows = [(k, "ON" if v is True else "OFF" if v is False else str(v))
                for k, v in sorted(seen.items())]
        return _str_chunk(["Variable_name", "Value"],
                          _like_filter(rows, stmt.like))
    if kind == "create_table":
        db = stmt.table.db or sess.vars.current_db
        tbl = ischema.table_by_name(db, stmt.table.name)
        lines = []
        for c in tbl.public_columns():
            line = f"  `{c.name}` {c.ft.sql_string()}"
            if c.ft.not_null:
                line += " NOT NULL"
            if c.ft.has_default and c.ft.default_value is not None:
                line += f" DEFAULT '{c.ft.default_value}'"
            if c.ft.auto_increment:
                line += " AUTO_INCREMENT"
            lines.append(line)
        if tbl.pk_is_handle:
            lines.append(f"  PRIMARY KEY (`{tbl.pk_col_name}`)")
        for idx in tbl.indexes:
            colstr = ", ".join(f"`{c}`" for c in idx.columns)
            if idx.primary:
                lines.append(f"  PRIMARY KEY ({colstr})")
            elif idx.unique:
                lines.append(f"  UNIQUE KEY `{idx.name}` ({colstr})")
            elif getattr(idx, "vector", False):
                lines.append(f"  VECTOR KEY `{idx.name}` ({colstr}) "
                             "USING IVF")
            else:
                lines.append(f"  KEY `{idx.name}` ({colstr})")
        ddl = (f"CREATE TABLE `{tbl.name}` (\n" + ",\n".join(lines) +
               "\n) ENGINE=InnoDB DEFAULT CHARSET=utf8mb4")
        return _str_chunk(["Table", "Create Table"], [(tbl.name, ddl)])
    if kind == "status":
        rows = [(k, str(v)) for k, v in sorted(sess.domain.metrics.items())]
        rows.append(("Uptime", str(int(time.time() -
                                       getattr(sess.domain, "_start_time",
                                               time.time())))))
        return _str_chunk(["Variable_name", "Value"], rows)
    if kind == "errors" or kind == "profiles":
        return _str_chunk(["Level", "Code", "Message"] if kind == "errors"
                          else ["Query_ID", "Duration", "Query"], [])
    if kind == "engines":
        from ..infoschema.virtual import _gen_engines
        return _str_chunk(["Engine", "Support", "Comment", "Transactions",
                           "XA", "Savepoints"],
                          list(_gen_engines(sess.domain)))
    if kind == "charset":
        from ..infoschema.virtual import _gen_character_sets
        return _str_chunk(["Charset", "Default collation", "Description",
                           "Maxlen"],
                          list(_gen_character_sets(sess.domain)))
    if kind == "collation":
        from ..infoschema.virtual import _gen_collations
        return _str_chunk(["Collation", "Charset", "Id", "Default",
                           "Compiled", "Sortlen"],
                          list(_gen_collations(sess.domain)))
    if kind == "create_database":
        db = stmt.db or sess.vars.current_db
        sess.domain.infoschema().schema_by_name(db)
        return _str_chunk(["Database", "Create Database"], [(
            db, f"CREATE DATABASE `{db}` /*!40100 DEFAULT CHARACTER SET "
            "utf8mb4 */")])
    if kind == "table_regions":
        db = stmt.table.db or sess.vars.current_db
        tbl = ischema.table_by_name(db, stmt.table.name)
        # single-node: one region spanning the table's key range
        return _str_chunk(
            ["REGION_ID", "START_KEY", "END_KEY", "LEADER_ID",
             "LEADER_STORE_ID", "PEERS", "SCATTERING"],
            [(1, f"t_{tbl.id}_", f"t_{tbl.id + 1}_", 1, 1, "1", 0)])
    if kind == "plugins":
        return _str_chunk(["Name", "Status", "Type", "Library", "License",
                           "Version"],
                          [(n, st, k, "", "", v)
                           for n, k, v, st in sess.domain.plugins.list()])
    if kind == "bindings":
        h = sess.domain.bind_handle if stmt.is_global \
            else sess.session_binds
        rows = []
        for rec in h.list():
            hint_txt = ", ".join(
                n.upper() + ("(" + ", ".join(a) + ")" if a else "")
                for n, a in rec.hints)
            rows.append((rec.original_sql, rec.bind_sql, "", rec.status,
                         rec.source, rec.digest[:16], hint_txt))
        return _str_chunk(["Original_sql", "Bind_sql", "Default_db",
                           "Status", "Source", "Sql_digest", "Hints"], rows)
    if kind == "index":
        db = stmt.table.db or sess.vars.current_db
        tbl = ischema.table_by_name(db, stmt.table.name)
        rows = []
        if tbl.pk_is_handle:
            rows.append((tbl.name, 0, "PRIMARY", 1, tbl.pk_col_name))
        for idx in tbl.indexes:
            for seq, c in enumerate(idx.columns):
                rows.append((tbl.name, 0 if idx.unique else 1,
                             idx.name, seq + 1, c))
        return _str_chunk(["Table", "Non_unique", "Key_name", "Seq_in_index",
                           "Column_name"], rows)
    if kind == "table_status":
        db = stmt.db or sess.vars.current_db
        rows = []
        for t in sorted(ischema.tables_in_schema(db), key=lambda x: x.name):
            ctab = sess.domain.columnar.tables.get(t.id)
            nrows = ctab.live_count() if ctab else 0
            rows.append((t.name, "InnoDB", "Dynamic", nrows,
                         "VIEW" if t.view_select else "BASE TABLE",
                         t.comment))
        return _str_chunk(["Name", "Engine", "Row_format", "Rows", "Type",
                           "Comment"], _like_filter(rows, stmt.like))
    if kind == "grants":
        pm = sess.domain.priv
        if stmt.like:
            user, host = stmt.like.rsplit("@", 1)
        else:
            user, host = sess.user, sess.host
        k = (user.lower(), host)
        rows = []
        g = pm.global_privs.get(k) or pm.global_privs.get((user.lower(), "%"))
        if g:
            privs = "ALL PRIVILEGES" if g >= set(
                __import__("tidb_tpu_torch.privilege.privileges",
                           fromlist=["ALL_PRIVS"]).ALL_PRIVS) else \
                ", ".join(sorted(p.upper() for p in g))
            rows.append((f"GRANT {privs} ON *.* TO '{user}'@'{host}'",))
        for key, privs in pm.db_privs.items():
            if key[0] == user.lower():
                rows.append((f"GRANT {', '.join(sorted(p.upper() for p in privs))} "
                             f"ON {key[2]}.* TO '{user}'@'{host}'",))
        for key, privs in pm.table_privs.items():
            if key[0] == user.lower():
                rows.append((f"GRANT {', '.join(sorted(p.upper() for p in privs))} "
                             f"ON {key[2]}.{key[3]} TO '{user}'@'{host}'",))
        if not rows:
            rows.append((f"GRANT USAGE ON *.* TO '{user}'@'{host}'",))
        return _str_chunk([f"Grants for {user}@{host}"], rows)
    if kind == "warnings":
        rows = [(w.get("level", "Warning"), w.get("code", 1105),
                 w.get("msg", "")) for w in sess.vars.warnings]
        return _str_chunk(["Level", "Code", "Message"], rows)
    if kind == "processlist":
        rows = []
        for cid, ref in sorted(sess.domain.sessions.items()):
            s = ref()
            if s is None:
                continue
            busy = bool(sess.domain._live_execs.get(cid))
            rows.append((cid, s.user, "localhost",
                         s.vars.current_db or None,
                         "Query" if busy else "Sleep", 0, "", None))
        return _str_chunk(["Id", "User", "Host", "db", "Command", "Time",
                           "State", "Info"], rows)
    if kind == "master_status":
        # the commit log IS the binlog here: report the real WAL
        # append position and the current resolved-ts so an external
        # consumer can bootstrap a changefeed (ADMIN CHANGEFEED CREATE
        # ... FROM <resolved_ts>) with a consistent starting point
        from ..cdc import current_resolved_ts
        import os as _os
        wal = sess.domain.storage.mvcc.wal
        fname, pos = "", 0
        if wal is not None:
            fname = _os.path.basename(wal.path)
            pos = wal.position()
        resolved = current_resolved_ts(sess.domain)
        return _str_chunk(
            ["File", "Position", "Binlog_Do_DB", "Binlog_Ignore_DB",
             "Executed_Gtid_Set"],
            [(fname, pos, "", "", f"resolved_ts:{resolved}")])
    if kind == "slave_status":
        return _str_chunk(["Slave_IO_State", "Master_Host",
                           "Master_User", "Slave_IO_Running",
                           "Slave_SQL_Running",
                           "Seconds_Behind_Master"], [])
    if kind == "open_tables":
        return _str_chunk(["Database", "Table", "In_use",
                           "Name_locked"], [])
    if kind == "triggers":
        return _str_chunk(["Trigger", "Event", "Table", "Statement",
                           "Timing", "Created"], [])
    if kind == "events":
        return _str_chunk(["Db", "Name", "Definer", "Time zone",
                           "Type", "Status"], [])
    if kind == "routine_status":
        return _str_chunk(["Db", "Name", "Type", "Definer",
                           "Modified", "Created"], [])
    if kind == "privileges":
        from ..privilege.privileges import ALL_PRIVS
        rows = sorted((p.capitalize(), "Databases,Tables", "")
                      for p in ALL_PRIVS)
        return _str_chunk(["Privilege", "Context", "Comment"],
                          _like_filter(rows, stmt.like))
    if kind in ("stats_meta", "stats_histograms", "analyze_status"):
        rows = []
        for db in ischema.all_schemas():
            if db.name in ("information_schema",):
                continue
            for t in ischema.tables_in_schema(db.name):
                st = sess.domain.stats.get(t.id)
                if st is None:
                    continue
                if kind == "stats_meta":
                    rows.append((db.name, t.name, "", st.version, 0,
                                 st.row_count))
                elif kind == "analyze_status":
                    rows.append((db.name, t.name, "",
                                 "analyze table all columns",
                                 st.row_count, "finished"))
                else:
                    for cname, cs in sorted(st.columns.items()):
                        rows.append((db.name, t.name, cname,
                                     cs.ndv, cs.null_count))
        rows = _like_filter(rows, stmt.like, col=1)   # by table name
        if kind == "stats_meta":
            return _str_chunk(["Db_name", "Table_name",
                               "Partition_name", "Version",
                               "Modify_count", "Row_count"], rows)
        if kind == "analyze_status":
            return _str_chunk(["Table_schema", "Table_name",
                               "Partition_name", "Job_info",
                               "Processed_rows", "State"], rows)
        return _str_chunk(["Db_name", "Table_name", "Column_name",
                           "Distinct_count", "Null_count"], rows)
    if kind == "config":
        rows = [("tidb", "localhost", "store.data-dir",
                 str(getattr(sess.domain, "data_dir", "") or
                     "<in-memory>")),
                ("tidb", "localhost", "enable-table-lock",
                 str(bool(sess.vars.get("tidb_enable_table_lock")))
                 .lower())]
        return _str_chunk(["Type", "Instance", "Name", "Value"],
                          _like_filter(rows, stmt.like, col=2))
    if kind == "placement_labels":
        return _str_chunk(["Key", "Values"], [])
    if kind == "placement":
        rows = []
        if ischema.has_table("mysql", "placement_policies"):
            pt = ischema.table_by_name("mysql", "placement_policies")
            ctab = sess.domain.columnar.tables.get(pt.id)
            if ctab is not None:
                valid = ctab.valid_at()
                cols = pt.columns
                for i in np.nonzero(valid)[0].tolist():
                    name = ctab.column_for(cols[0]).get_datum(i).to_py()
                    setting = ctab.column_for(
                        cols[1]).get_datum(i).to_py()
                    rows.append((f"POLICY {name}", str(setting),
                                 "SCHEDULED"))
        return _str_chunk(["Target", "Placement",
                           "Scheduling_State"],
                          _like_filter(rows, stmt.like))
    if kind == "table_next_row_id":
        tn = stmt.table
        db = tn.db or sess.vars.current_db
        tbl = ischema.table_by_name(db, tn.name)
        alloc = sess.domain.allocator(tbl)
        nxt = alloc._next
        ctab = sess.domain.columnar.tables.get(tbl.id)
        if ctab is not None and ctab.n:
            # ALL version rows, incl. deleted-not-yet-GC'd: a deleted
            # max handle was still allocated and must not be reissued
            hmax = int(np.asarray(ctab.handles[:ctab.n]).max())
            nxt = max(nxt, hmax + 1)
        rows = [(db, tbl.name, tbl.pk_col_name or "_tidb_rowid",
                 nxt, "_TIDB_ROWID" if not tbl.pk_col_name
                 else "AUTO_INCREMENT")]
        return _str_chunk(["DB_NAME", "TABLE_NAME", "COLUMN_NAME",
                           "NEXT_GLOBAL_ROW_ID", "ID_TYPE"], rows)
    from ..errors import UnsupportedError
    raise UnsupportedError("SHOW %s not supported", kind)


def exec_desc(sess, table_name):
    from ..parser import ast
    return exec_show(sess, ast.ShowStmt(kind="columns", table=table_name))
