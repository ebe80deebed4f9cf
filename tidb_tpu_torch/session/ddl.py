"""DDL execution (reference pkg/ddl). Single-transaction DDLs (CREATE/
DROP TABLE, ADD/DROP COLUMN, renames) commit one meta txn and are
crash-atomic by construction. Multi-step DDLs — ADD INDEX, DROP INDEX,
EXCHANGE PARTITION, cross-class MODIFY COLUMN — run through the durable
job framework (owner/ddl_runner.py): a persisted DDLJob walks the F1
state ladder with every transition WAL-framed, backfill checkpointed by
handle range, and restart recovery resuming or rolling back in-flight
jobs. The ladder/backfill PRIMITIVES (add_index_prepare,
_set_index_state, backfill_index_shard, purge_index_range) stay here —
the distributed reorg (cluster/coordinator + dxf/remote) drives them
per worker while the coordinator owns the job record."""
from __future__ import annotations

import copy
import hashlib

import numpy as np

from ..parser import ast
from ..meta import Mutator
from ..models import (DBInfo, TableInfo, ColumnInfo, IndexInfo,
                      SchemaState, DDLJob)
from ..models.job import (TYPE_ADD_INDEX, TYPE_DROP_INDEX,
                          TYPE_EXCHANGE_PARTITION, TYPE_MODIFY_COLUMN,
                          STATE_SYNCED)
from ..types import FieldType
from ..types.field_type import MYSQL_TYPE_NAMES, TypeClass
from ..errors import (DatabaseExistsError, DatabaseNotExistsError,
                      TableExistsError, TableNotExistsError,
                      DuplicateColumnError, ColumnNotExistsError,
                      IndexExistsError, IndexNotExistsError,
                      UnsupportedError, TiDBError)
from ..executor import table_rt


def column_def_to_info(cd: ast.ColumnDef, col_id: int, offset: int) -> ColumnInfo:
    tname = cd.type_name.lower()
    tclass = MYSQL_TYPE_NAMES.get(tname)
    if tclass is None:
        raise UnsupportedError("unsupported column type %s", tname)
    if tclass in (TypeClass.ENUM, TypeClass.SET):
        # store as dictionary-encoded strings validated against elems
        tclass = TypeClass.STRING
    ft = FieldType(tp=tname, tclass=tclass)
    ft.flen = cd.flen
    ft.decimal = cd.decimal
    if tname == "vector":
        from ..types.field_type import VECTOR_MAX_DIM
        if cd.flen == 0 or cd.flen > VECTOR_MAX_DIM:
            from ..errors import VectorDimensionError
            raise VectorDimensionError(
                "invalid VECTOR dimension %d for column '%s' "
                "(1..%d)", cd.flen, cd.name, VECTOR_MAX_DIM)
    if tclass == TypeClass.DECIMAL:
        if ft.flen <= 0:
            ft.flen = 10
        if ft.decimal < 0:
            ft.decimal = 0
    ft.unsigned = cd.unsigned
    ft.not_null = cd.not_null or cd.primary_key
    ft.auto_increment = cd.auto_increment
    ft.primary_key = cd.primary_key
    ft.elems = cd.enum_vals
    if cd.collate:
        ft.collate = cd.collate
    if cd.has_default:
        ft.has_default = True
        dv = cd.default_value
        from ..parser import ast as _ast
        if (isinstance(dv, _ast.FuncCall) and dv.name in (
                "now", "current_timestamp")) or \
                (isinstance(dv, _ast.ColumnRef) and
                 dv.name.lower() in ("current_timestamp", "now")):
            dv = "__CURRENT_TIMESTAMP__"
        elif isinstance(dv, _ast.ExprNode):
            raise UnsupportedError(
                "only literal / CURRENT_TIMESTAMP defaults supported")
        ft.default_value = dv
    return ColumnInfo(id=col_id, name=cd.name, offset=offset, ft=ft,
                      comment=cd.comment,
                      generated=getattr(cd, "generated", ""))


class DDLExecutor:
    def __init__(self, sess):
        self.sess = sess
        self.domain = sess.domain

    def _with_meta(self, fn):
        """Run fn(mutator) in its own txn and bump schema version."""
        txn = self.domain.storage.begin()
        try:
            m = Mutator(txn)
            result = fn(m)
            m.gen_schema_version()
            txn.commit()
            return result
        except BaseException:
            txn.rollback()
            raise

    # ---- databases ----------------------------------------------------
    def create_database(self, stmt: ast.CreateDatabaseStmt):
        def fn(m):
            for db in m.list_databases():
                if db.name.lower() == stmt.name.lower():
                    if stmt.if_not_exists:
                        return
                    raise DatabaseExistsError(
                        "Can't create database '%s'; database exists", stmt.name)
            m.create_database(DBInfo(id=m.gen_global_id(), name=stmt.name))
        self._with_meta(fn)

    def drop_database(self, stmt: ast.DropDatabaseStmt):
        def fn(m):
            target = None
            for db in m.list_databases():
                if db.name.lower() == stmt.name.lower():
                    target = db
                    break
            if target is None:
                if stmt.if_exists:
                    return
                raise DatabaseNotExistsError(
                    "Can't drop database '%s'; database doesn't exist", stmt.name)
            for t in m.list_tables(target.id):
                self.domain.columnar.drop_table(t.id)
            m.drop_database(target.id)
        self._with_meta(fn)
        if self.sess.vars.current_db.lower() == stmt.name.lower():
            self.sess.vars.current_db = ""

    # ---- tables -------------------------------------------------------
    def create_table(self, stmt: ast.CreateTableStmt):
        db_name = stmt.table.db or self.sess.vars.current_db
        if "like" in stmt.options:
            return self._create_table_like(stmt, db_name)
        if "as_select" in stmt.options:
            return self._create_table_as(stmt, db_name)

        # table-level CHARSET default collation flows to string columns
        # without their own charset OR collation (reference ddl: column
        # charset resolution; gbk/gb18030 must not silently sort as
        # utf8 — but an explicit column CHARACTER SET wins)
        from ..utils.charsets import CHARSET_DEFAULT_COLLATE
        tbl_cs = str(stmt.options.get("charset", "")).lower()
        tbl_coll = CHARSET_DEFAULT_COLLATE.get(tbl_cs)
        tbl_coll = str(stmt.options.get("collate", "") or tbl_coll or "")
        if tbl_coll:
            for cd in stmt.columns:
                if not cd.collate and not cd.charset and \
                        cd.type_name.lower() in (
                            "char", "varchar", "text", "tinytext",
                            "mediumtext", "longtext", "enum", "set"):
                    cd.collate = tbl_coll

        def fn(m):
            db = self._db_by_name(m, db_name)
            for t in m.list_tables(db.id):
                if t.name.lower() == stmt.table.name.lower():
                    if stmt.if_not_exists:
                        return None
                    raise TableExistsError("Table '%s' already exists",
                                           stmt.table.name)
            tid = m.gen_global_id()
            cols = []
            seen = set()
            for i, cd in enumerate(stmt.columns):
                if cd.name.lower() in seen:
                    raise DuplicateColumnError("Duplicate column name '%s'",
                                               cd.name)
                seen.add(cd.name.lower())
                cols.append(column_def_to_info(cd, i + 1, i))
            tbl = TableInfo(id=tid, name=stmt.table.name, columns=cols)
            next_idx_id = 1
            # column-level PK/unique
            for i, cd in enumerate(stmt.columns):
                if cd.primary_key:
                    tbl.indexes.append(IndexInfo(
                        id=next_idx_id, name="PRIMARY", columns=[cd.name],
                        unique=True, primary=True))
                    next_idx_id += 1
                if cd.unique:
                    tbl.indexes.append(IndexInfo(
                        id=next_idx_id, name=f"uk_{cd.name}",
                        columns=[cd.name], unique=True))
                    next_idx_id += 1
            for idx in stmt.indexes:
                for cn in idx.columns:
                    if tbl.find_column(cn) is None:
                        raise ColumnNotExistsError(
                            "Key column '%s' doesn't exist in table", cn)
                if idx.primary:
                    for cn in idx.columns:
                        tbl.find_column(cn).ft.not_null = True
                tbl.indexes.append(IndexInfo(
                    id=next_idx_id, name=idx.name, columns=list(idx.columns),
                    unique=idx.unique, primary=idx.primary))
                next_idx_id += 1
            # clustered integer PK -> handle (reference pk_is_handle)
            pk = next((i for i in tbl.indexes if i.primary), None)
            if pk is not None and len(pk.columns) == 1:
                ci = tbl.find_column(pk.columns[0])
                if ci is not None and ci.ft.tclass in (TypeClass.INT,
                                                       TypeClass.UINT):
                    tbl.pk_is_handle = True
                    tbl.pk_col_name = ci.name
                    tbl.indexes = [i for i in tbl.indexes if not i.primary]
            for chk in stmt.options.get("checks", []):
                tbl.checks.append(chk)
            for fk in stmt.foreign_keys:
                ref_db_name = fk.ref_table.db or db_name
                ref_db = self._db_by_name(m, ref_db_name)
                parent = None
                for t in m.list_tables(ref_db.id):
                    if t.name.lower() == fk.ref_table.name.lower():
                        parent = t
                        break
                if parent is None:
                    raise TableNotExistsError(
                        "Failed to open the referenced table '%s'",
                        fk.ref_table.name)
                # referenced cols must be the parent PK or a unique index
                refs = [c.lower() for c in fk.ref_columns]
                ok = (parent.pk_is_handle and
                      refs == [parent.pk_col_name.lower()]) or any(
                    i.unique and [c.lower() for c in i.columns] == refs
                    for i in parent.indexes)
                if not ok:
                    raise UnsupportedError(
                        "FK must reference the parent PRIMARY/UNIQUE key")
                for cn in fk.columns:
                    if tbl.find_column(cn) is None:
                        raise ColumnNotExistsError(
                            "Unknown column '%s' in foreign key", cn)
                # auto-create the child index (MySQL behavior)
                have = any([c.lower() for c in i.columns[:len(fk.columns)]]
                           == [c.lower() for c in fk.columns]
                           for i in tbl.indexes)
                if not have:
                    tbl.indexes.append(IndexInfo(
                        id=max((i.id for i in tbl.indexes), default=0) + 1,
                        name=fk.name or f"fk_{'_'.join(fk.columns)}",
                        columns=list(fk.columns)))
                tbl.foreign_keys.append({
                    "name": fk.name, "cols": [c.lower() for c in fk.columns],
                    "ref_db": ref_db_name, "ref_table": parent.name,
                    "ref_cols": refs, "on_delete": fk.on_delete})
            if "partition_by" in stmt.options:
                pdef = dict(stmt.options["partition_by"])
                pcol = tbl.find_column(pdef["col"])
                if pcol is None:
                    raise ColumnNotExistsError(
                        "Unknown partition column '%s'", pdef["col"])
                pdef["col"] = pcol.name
                parts = []
                if pdef["type"] == "hash":
                    for i in range(int(pdef.get("num", 4))):
                        parts.append({"name": f"p{i}",
                                      "pid": m.gen_global_id(),
                                      "less_than": None})
                elif pdef["type"] == "range":
                    from ..chunk.column import py_to_datum_fast
                    for pd in pdef["parts"]:
                        lt = pd["less_than"]
                        if lt is not None:
                            lt = py_to_datum_fast(lt, pcol.ft).val
                        parts.append({"name": pd["name"],
                                      "pid": m.gen_global_id(),
                                      "less_than": lt})
                else:
                    raise UnsupportedError("PARTITION BY %s not supported",
                                           pdef["type"])
                pdef["parts"] = parts
                tbl.partitions = pdef
            if "ttl" in stmt.options:
                col, nval, unit = stmt.options["ttl"]
                ci = tbl.find_column(col)
                if ci is None:
                    raise ColumnNotExistsError(
                        "Unknown TTL column '%s'", col)
                if not ci.ft.is_temporal:
                    raise UnsupportedError("TTL column must be a time type")
                tbl.ttl = {"col": ci.name, "value": nval, "unit": unit,
                           "enable": True}
            m.create_table(db.id, tbl)
            return tbl
        self._with_meta(fn)

    def create_sequence(self, stmt: ast.CreateSequenceStmt):
        db_name = stmt.name.db or self.sess.vars.current_db

        def fn(m):
            db = self._db_by_name(m, db_name)
            for t in m.list_tables(db.id):
                if t.name.lower() == stmt.name.name.lower():
                    if stmt.if_not_exists:
                        return
                    raise TableExistsError("Table '%s' already exists",
                                           stmt.name.name)
            tbl = TableInfo(id=m.gen_global_id(), name=stmt.name.name,
                            sequence={"start": stmt.start,
                                      "increment": stmt.increment,
                                      "cache": max(stmt.cache, 1),
                                      "value": stmt.start})
            m.create_table(db.id, tbl)
        self._with_meta(fn)

    def drop_sequence(self, stmt: ast.DropSequenceStmt):
        def fn(m):
            db = self._db_by_name(m, stmt.name.db or
                                  self.sess.vars.current_db)
            for t in m.list_tables(db.id):
                if t.name.lower() == stmt.name.name.lower() and t.sequence:
                    m.drop_table(db.id, t.id)
                    return
            if not stmt.if_exists:
                raise TableNotExistsError("Unknown SEQUENCE '%s'",
                                          stmt.name.name)
        self._with_meta(fn)

    # ---- models (tidb_tpu/ml/) ----------------------------------------
    def create_model(self, stmt: ast.CreateModelStmt):
        """CREATE MODEL name FROM '<uri>'. Fail-fast validation (name
        collision, uri readable, npz layout parseable) happens on the
        session thread; the durable writes run as a TYPE_CREATE_MODEL
        job through the owner runner so kill -9 mid-create resumes to
        PUBLIC or rolls back with zero orphaned weight rows."""
        from ..ml import parse_npz
        from ..ml.ddl import read_model_uri
        if self.domain.ml.lookup(stmt.name) is not None:
            if stmt.if_not_exists:
                return
            raise TiDBError("Model '%s' already exists", stmt.name)
        parse_npz(read_model_uri(stmt.uri))   # layout errors fail here
        from ..models.job import TYPE_CREATE_MODEL
        job = DDLJob(type=TYPE_CREATE_MODEL, table_name=stmt.name,
                     args={"model": {"name": stmt.name,
                                     "uri": stmt.uri}})
        self._submit_job(job)

    def drop_model(self, stmt: ast.DropModelStmt):
        """DROP MODEL: one meta txn removes the registry row + weight
        blob (like dropping a vector index — no reorg ladder needed),
        then the device-resident weight buffers are evicted."""
        def fn(m):
            for info in m.list_models():
                if info.name.lower() == stmt.name.lower() and \
                        info.public:
                    m.drop_model(info.id)
                    return info.id
            if not stmt.if_exists:
                raise TiDBError("Model '%s' doesn't exist", stmt.name)
            return None
        mid = self._with_meta(fn)
        if mid is not None:
            self.domain.ml.invalidate(mid)

    def create_view(self, stmt: ast.CreateViewStmt):
        db_name = stmt.view.db or self.sess.vars.current_db
        # validate the definition by planning it now
        from ..parser import parse_one
        from ..planner import optimize
        sel = parse_one(stmt.select_text)
        optimize(sel, self.sess._plan_ctx())

        def fn(m):
            db = self._db_by_name(m, db_name)
            for t in m.list_tables(db.id):
                if t.name.lower() == stmt.view.name.lower():
                    if stmt.or_replace:
                        m.drop_table(db.id, t.id)
                        break
                    raise TableExistsError("Table '%s' already exists",
                                           stmt.view.name)
            tbl = TableInfo(id=m.gen_global_id(), name=stmt.view.name,
                            view_select=stmt.select_text,
                            view_cols=list(stmt.columns))
            m.create_table(db.id, tbl)
        self._with_meta(fn)

    def _create_table_like(self, stmt, db_name):
        src_tn = stmt.options["like"]
        src_db = src_tn.db or db_name
        src_tbl = self.domain.infoschema().table_by_name(src_db, src_tn.name)

        def fn(m):
            db = self._db_by_name(m, db_name)
            for t in m.list_tables(db.id):
                if t.name.lower() == stmt.table.name.lower():
                    if stmt.if_not_exists:
                        return
                    raise TableExistsError("Table '%s' already exists",
                                           stmt.table.name)
            import copy
            tbl = copy.deepcopy(src_tbl)
            tbl.id = m.gen_global_id()
            tbl.name = stmt.table.name
            tbl.foreign_keys = []
            m.create_table(db.id, tbl)
        self._with_meta(fn)

    def _create_table_as(self, stmt, db_name):
        """CTAS: infer columns from the select's output schema, create,
        then INSERT...SELECT the rows."""
        from ..planner import optimize
        sel = stmt.options["as_select"]
        pctx = self.sess._plan_ctx()
        plan = optimize(sel, pctx)
        vis = [sc for sc in plan.schema.cols if not sc.hidden]

        def fn(m):
            db = self._db_by_name(m, db_name)
            for t in m.list_tables(db.id):
                if t.name.lower() == stmt.table.name.lower():
                    if stmt.if_not_exists:
                        return None
                    raise TableExistsError("Table '%s' already exists",
                                           stmt.table.name)
            cols = []
            for i, sc in enumerate(vis):
                ft = sc.col.ft.clone()
                ft.auto_increment = False
                ft.primary_key = False
                name = sc.name or f"c{i}"
                cols.append(ColumnInfo(id=i + 1, name=name, offset=i,
                                       ft=ft))
            tbl = TableInfo(id=m.gen_global_id(), name=stmt.table.name,
                            columns=cols)
            m.create_table(db.id, tbl)
            return tbl
        created = self._with_meta(fn)
        if created is None:
            return
        # populate via the executor (fresh plan context/schema version)
        from ..executor import ExecContext
        from ..executor.dml import InsertExec
        from ..planner.builder import InsertPlan
        new_tbl = self.domain.infoschema().table_by_name(db_name,
                                                         stmt.table.name)
        iplan = InsertPlan(table_info=new_tbl, db_name=db_name,
                           col_offsets=list(range(len(new_tbl.columns))),
                           select_plan=plan)
        ectx = ExecContext(self.sess)
        try:
            self.sess.txn()
            InsertExec(ectx, iplan, self.sess).execute()
            self.sess.commit()
        finally:
            ectx.finish()

    def drop_table(self, stmt: ast.DropTableStmt):
        def fn(m):
            for tn in stmt.tables:
                db_name = tn.db or self.sess.vars.current_db
                db = self._db_by_name(m, db_name)
                target = None
                for t in m.list_tables(db.id):
                    if t.name.lower() == tn.name.lower():
                        target = t
                        break
                if target is None:
                    if stmt.if_exists:
                        continue
                    raise TableNotExistsError("Unknown table '%s'", tn.name)
                m.drop_table(db.id, target.id)
                self.domain.columnar.drop_table(target.id)
        self._with_meta(fn)

    def truncate_table(self, stmt: ast.TruncateTableStmt):
        tn = stmt.table

        def fn(m):
            db = self._db_by_name(m, tn.db or self.sess.vars.current_db)
            target = None
            for t in m.list_tables(db.id):
                if t.name.lower() == tn.name.lower():
                    target = t
                    break
            if target is None:
                raise TableNotExistsError("Unknown table '%s'", tn.name)
            m.drop_table(db.id, target.id)
            self.domain.columnar.drop_table(target.id)
            target.id = m.gen_global_id()
            m.create_table(db.id, target)
        self._with_meta(fn)

    def rename_table(self, stmt: ast.RenameTableStmt):
        def fn(m):
            for old, new in stmt.pairs:
                db = self._db_by_name(m, old.db or self.sess.vars.current_db)
                ndb = self._db_by_name(m, new.db or self.sess.vars.current_db)
                target = None
                for t in m.list_tables(db.id):
                    if t.name.lower() == old.name.lower():
                        target = t
                        break
                if target is None:
                    raise TableNotExistsError("Unknown table '%s'", old.name)
                m.drop_table(db.id, target.id)
                target.name = new.name
                m.create_table(ndb.id, target)
        self._with_meta(fn)

    # ---- indexes / alter ---------------------------------------------
    def create_index(self, stmt: ast.CreateIndexStmt):
        tn = stmt.table
        if getattr(stmt, "vector", False):
            return self.create_vector_index(stmt)
        idx_def = ast.IndexDef(name=stmt.index_name, columns=stmt.columns,
                               unique=stmt.unique)
        self._alter_add_index(tn, idx_def)

    def create_vector_index(self, stmt: ast.CreateIndexStmt):
        """CREATE VECTOR INDEX name ON t (col) USING IVF [LISTS = n]
        (tidb_tpu/vector/, docs/VECTOR.md). The index is DERIVED state
        — centroids + posting lists rebuilt on demand from the
        columnar store, maintained incrementally through the capture
        seam — so the durable change is meta-only (one IndexInfo row;
        crash-safe by the meta txn, no backfill ladder: the first
        search after a restart trains lazily)."""
        from ..errors import UnsupportedError, VectorDimensionError
        tn = stmt.table
        using = (stmt.using or "ivf").lower()
        if using != "ivf":
            raise UnsupportedError(
                "vector index algorithm %s not supported (USING IVF)",
                using.upper())
        if len(stmt.columns) != 1:
            raise UnsupportedError(
                "a vector index covers exactly one VECTOR column")
        if stmt.unique:
            raise UnsupportedError("vector indexes cannot be UNIQUE")
        db_name = tn.db or self.sess.vars.current_db
        tbl0 = self.domain.infoschema().table_by_name(db_name, tn.name)
        ci = tbl0.find_column(stmt.columns[0])
        if ci is None:
            raise ColumnNotExistsError(
                "Key column '%s' doesn't exist in table",
                stmt.columns[0])
        if not getattr(ci.ft, "is_vector", False):
            raise UnsupportedError(
                "vector index column '%s' must be a VECTOR type",
                ci.name)
        if ci.ft.flen <= 0:
            raise VectorDimensionError(
                "vector index needs a declared dimension: column "
                "'%s' is VECTOR without (k)", ci.name)
        if tbl0.find_index(stmt.index_name) is not None:
            raise IndexExistsError("Duplicate key name '%s'",
                                   stmt.index_name)
        params = {"using": "ivf"}
        if stmt.params.get("lists"):
            params["lists"] = int(stmt.params["lists"])
        col_name = ci.name

        def fn(m):
            db, tbl = self._get_table(m, tn)
            if tbl.find_index(stmt.index_name) is not None:
                raise IndexExistsError("Duplicate key name '%s'",
                                       stmt.index_name)
            tbl.indexes.append(IndexInfo(
                id=max((i.id for i in tbl.indexes), default=0) + 1,
                name=stmt.index_name, columns=[col_name],
                vector=True, params=params))
            m.update_table(db.id, tbl)
        self._with_meta(fn)
        # the runtime subscribes to the capture seam from here on
        self.domain.vector.attach()

    def _submit_job(self, job: DDLJob) -> DDLJob:
        """Drive a durable DDL job synchronously (the session's thread
        doubles as the owner worker in-process). An ExecContext is
        registered so KILL of this connection reaches a running reorg —
        the runner observes it at the next ladder step / backfill
        checkpoint and rolls back through ``rollingback`` instead of a
        best-effort exception unwind."""
        from ..executor.exec_base import ExecContext
        runner = self.domain.ddl_jobs
        sess = self.sess
        if sess is None or getattr(sess, "conn_id", None) is None:
            return runner.submit(job)
        ectx = ExecContext(sess)
        self.domain.register_exec(sess.conn_id, ectx)
        try:
            return runner.submit(
                job, cancel_check=lambda: bool(ectx.killed))
        finally:
            self.domain.unregister_exec(sess.conn_id, ectx)
            ectx.finish()

    def _reorg_batch(self) -> int:
        try:
            return int(self.sess.vars.get("tidb_tpu_ddl_reorg_batch_size"))
        except Exception:               # noqa: BLE001
            from .sysvars import get_sysvar
            return int(get_sysvar("tidb_tpu_ddl_reorg_batch_size").default)

    def drop_index(self, stmt: ast.DropIndexStmt):
        """Drop through the reverse F1 ladder (reference ddl/index.go
        onDropIndex): public -> write-only (reads stop) -> delete-only
        (writes stop) -> absent, then delete-range purges the index key
        range. Runs as a durable job so a crash mid-ladder resumes
        toward absence at restart instead of stranding a half state."""
        tn = stmt.table
        db_name = tn.db or self.sess.vars.current_db
        tbl = self.domain.infoschema().table_by_name(db_name, tn.name)
        idx = tbl.find_index(stmt.index_name)
        if idx is None:
            raise IndexNotExistsError("index %s doesn't exist",
                                      stmt.index_name)
        if getattr(idx, "vector", False):
            # derived state, no KV to delete-range: meta-only removal
            # + drop the runtime instance
            name = idx.name

            def fn(m):
                db, t = self._get_table(m, tn)
                t.indexes = [i for i in t.indexes
                             if i.name.lower() != name.lower()]
                m.update_table(db.id, t)
            self._with_meta(fn)
            self.domain.vector.drop_index(tbl.id, name)
            return
        job = DDLJob(type=TYPE_DROP_INDEX, db_name=db_name,
                     table_name=tbl.name, table_id=tbl.id,
                     schema_state=idx.state,
                     args={"index": {"name": idx.name}})
        self._submit_job(job)

    def alter_table(self, stmt: ast.AlterTableStmt):
        for action, payload in stmt.actions:
            if action == "add_column":
                self._alter_add_column(stmt.table, payload)
            elif action == "drop_column":
                self._alter_drop_column(stmt.table, payload)
            elif action == "add_index":
                self._alter_add_index(stmt.table, payload)
            elif action == "drop_index":
                self.drop_index(ast.DropIndexStmt(index_name=payload,
                                                  table=stmt.table))
            elif action == "modify_column":
                self._alter_modify_column(stmt.table, payload)
            elif action == "change_column":
                old, cd = payload
                if old.lower() != cd.name.lower():
                    self._alter_rename_column(stmt.table, old, cd.name)
                self._alter_modify_column(stmt.table, cd)
            elif action == "rename_column":
                self._alter_rename_column(stmt.table, *payload)
            elif action == "rename_index":
                self._alter_rename_index(stmt.table, *payload)
            elif action == "alter_index_visibility":
                self._alter_index_visibility(stmt.table, *payload)
            elif action == "ignore_fulltext":
                # reference behavior: FULLTEXT syntax accepted, no
                # index created (warning 1214)
                if self.sess is not None:
                    self.sess.vars.warnings.append({
                        "level": "Warning", "code": 1214,
                        "msg": "FULLTEXT index is not supported; "
                               "the clause was parsed and ignored"})
            elif action == "set_default":
                self._alter_set_default(stmt.table, *payload)
            elif action == "table_option":
                self._alter_table_option(stmt.table, *payload)
            elif action == "rename":
                self.rename_table(ast.RenameTableStmt(
                    pairs=[(stmt.table, payload)]))
            elif action == "exchange_partition":
                self._alter_exchange_partition(stmt.table, payload)
            elif action == "reorganize_partition":
                self._alter_reorganize_partition(stmt.table, payload)
            elif action == "placement_policy":
                self._alter_table_placement(stmt.table, payload)
            else:
                raise UnsupportedError("unsupported ALTER action %s", action)

    def _alter_add_column(self, tn, cd: ast.ColumnDef):
        pos = getattr(cd, "position", None)

        def fn(m):
            db, tbl = self._get_table(m, tn)
            if tbl.find_column(cd.name) is not None:
                raise DuplicateColumnError("Duplicate column name '%s'", cd.name)
            if isinstance(pos, tuple) and \
                    tbl.find_column(pos[1]) is None:
                # validate AFTER's target BEFORE committing the append
                raise ColumnNotExistsError(
                    "Unknown column '%s' in AFTER", pos[1])
            col_id = max((c.id for c in tbl.columns), default=0) + 1
            ci = column_def_to_info(cd, col_id, len(tbl.columns))
            if ci.ft.not_null and not ci.ft.has_default:
                ci.ft.default_value = _zero_default(ci.ft)
                ci.ft.has_default = True
            tbl.columns.append(ci)
            m.update_table(db.id, tbl)
            return tbl, ci
        _tbl, ci = self._with_meta(fn)
        if pos is not None:
            # FIRST / AFTER col: rows are stored positionally, so a
            # display-order change is a row rewrite (reference TiDB
            # keeps offsets separate; this build's row codec is
            # positional, and embedded scale makes the rewrite cheap)
            if pos == "first":
                at = 0
            else:
                ref = pos[1].lower()
                names = [c.name.lower() for c in _tbl.columns]
                if ref not in names:
                    raise ColumnNotExistsError(
                        "Unknown column '%s' in AFTER", pos[1])
                at = names.index(ref) + 1
            self._rewrite_column_order(tn, ci.name, at)

    def _rewrite_column_order(self, tn, col_name, at):
        """Move column `col_name` to offset `at`: meta reorder + full
        row rewrite in ONE transaction (same crash contract as
        REORGANIZE PARTITION)."""
        from ..storage.partition import partition_table_info
        pt = self.domain.infoschema().table_by_name(
            tn.db or self.sess.vars.current_db, tn.name)
        phys = [partition_table_info(pt, p["pid"])
                for p in pt.partitions["parts"]] if pt.partitions \
            else [pt]
        rows = []
        for ph in phys:
            rows.extend(self._snapshot_rows(ph, pt.columns))
        old_off = next(i for i, c in enumerate(pt.columns)
                       if c.name.lower() == col_name.lower())
        txn = self.domain.storage.begin()
        try:
            m = Mutator(txn)
            db, tbl = self._get_table(m, tn)
            old_view = copy.copy(tbl)
            old_view.columns = list(tbl.columns)
            cols = list(tbl.columns)
            moved = cols.pop(old_off)
            cols.insert(min(at, len(cols)), moved)
            for i, c in enumerate(cols):
                c.offset = i       # offsets are positional everywhere
            tbl.columns = cols
            m.update_table(db.id, tbl)
            m.gen_schema_version()
            for h, row in rows:
                table_rt.remove_record(txn, old_view, h, row)
            for h, row in rows:
                r = list(row)
                d = r.pop(old_off)
                r.insert(min(at, len(r)), d)
                table_rt.add_record(txn, tbl, h, r, skip_check=True)
            txn.commit()
        except BaseException:
            txn.rollback()
            raise

    def _alter_rename_column(self, tn, old, new):
        """Rename a column and every meta reference to it: this
        table's indexes/FKs/partition key/pk name, AND child tables'
        FK ref_cols pointing here (reference ddl/column.go
        renameColumn). Refuses when a stored generated column's
        expression references the old name (MySQL does too — the
        expression text is evaluated by name at DML time)."""
        import re as _re

        def fn(m):
            db, tbl = self._get_table(m, tn)
            ci = tbl.find_column(old)
            if ci is None:
                raise ColumnNotExistsError("Unknown column '%s'", old)
            if tbl.find_column(new) is not None:
                raise DuplicateColumnError(
                    "Duplicate column name '%s'", new)
            lo = old.lower()
            pat = _re.compile(r"\b%s\b" % _re.escape(lo))
            for c in tbl.columns:
                if c.generated and pat.search(c.generated.lower()):
                    raise UnsupportedError(
                        "cannot rename column '%s': generated column "
                        "'%s' depends on it", old, c.name)
            ci.name = new
            for idx in tbl.indexes:
                idx.columns = [new if c.lower() == lo else c
                               for c in idx.columns]
            if tbl.pk_col_name.lower() == lo:
                tbl.pk_col_name = new
            if tbl.partitions and \
                    tbl.partitions["col"].lower() == lo:
                tbl.partitions["col"] = new
            for fk in tbl.foreign_keys:
                fk["cols"] = [new.lower() if c == lo else c
                              for c in fk["cols"]]
            m.update_table(db.id, tbl)
            # child tables referencing this column via FK
            for cdb in m.list_databases():
                for ct in m.list_tables(cdb.id):
                    changed = False
                    for fk in ct.foreign_keys:
                        if fk["ref_table"].lower() == \
                                tbl.name.lower() and \
                                fk.get("ref_db", "").lower() == \
                                db.name.lower() and \
                                lo in [c.lower()
                                       for c in fk["ref_cols"]]:
                            fk["ref_cols"] = [
                                new if c.lower() == lo else c
                                for c in fk["ref_cols"]]
                            changed = True
                    if changed:
                        m.update_table(cdb.id, ct)
        self._with_meta(fn)

    def _alter_rename_index(self, tn, old, new):
        def fn(m):
            db, tbl = self._get_table(m, tn)
            idx = tbl.find_index(old)
            if idx is None:
                raise IndexNotExistsError("index %s doesn't exist", old)
            if tbl.find_index(new) is not None:
                raise IndexExistsError("Duplicate key name '%s'", new)
            idx.name = new
            m.update_table(db.id, tbl)
        self._with_meta(fn)

    def _alter_index_visibility(self, tn, iname, visible):
        """ALTER INDEX i VISIBLE|INVISIBLE — meta-only flip; writes
        keep maintaining the index, the planner's access-path search
        skips it (reference ddl AlterIndexVisibility,
        planner invisible-index pruning)."""
        def fn(m):
            db, tbl = self._get_table(m, tn)
            idx = tbl.find_index(iname)
            if idx is None:
                raise IndexNotExistsError("index %s doesn't exist",
                                          iname)
            idx.invisible = not visible
            m.update_table(db.id, tbl)
        self._with_meta(fn)

    def _alter_set_default(self, tn, cname, dv):
        """ALTER COLUMN c SET DEFAULT v / DROP DEFAULT ("\\0DROP"
        sentinel) — meta-only (reference ddl/column.go
        AlterColumn)."""
        def fn(m):
            db, tbl = self._get_table(m, tn)
            ci = tbl.find_column(cname)
            if ci is None:
                raise ColumnNotExistsError("Unknown column '%s'", cname)
            if dv == "\0DROP":
                ci.ft.has_default = False
                ci.ft.default_value = None
            else:
                ci.ft.default_value = dv
                ci.ft.has_default = True
            m.update_table(db.id, tbl)
        self._with_meta(fn)

    def _alter_table_option(self, tn, opt, val):
        def fn(m):
            db, tbl = self._get_table(m, tn)
            if opt == "comment":
                tbl.comment = str(val)
            elif opt == "auto_increment":
                tbl.auto_inc_id = max(tbl.auto_inc_id, int(val))
                m.update_table(db.id, tbl)
                return tbl
            # engine/charset: accepted, recorded nowhere (single
            # engine, utf8mb4-only build)
            m.update_table(db.id, tbl)
            return tbl
        tbl = self._with_meta(fn)
        if opt == "auto_increment":
            self.domain.allocator(tbl).rebase(int(val) - 1)

    def _alter_drop_column(self, tn, name):
        # MySQL drops SINGLE-column indexes on the dropped column
        # automatically; multi-column indexes refuse (reference
        # ddl/column.go checkDropColumnWithIndex). ALL validation runs
        # BEFORE the index drops: a failing ALTER must not leave
        # committed schema mutations behind.
        db_name = tn.db or self.sess.vars.current_db
        tbl0 = self.domain.infoschema().table_by_name(db_name, tn.name)
        if tbl0.find_column(name) is None:
            raise ColumnNotExistsError("Unknown column '%s'", name)
        if tbl0.pk_is_handle and tbl0.pk_col_name.lower() == name.lower():
            raise UnsupportedError("cannot drop the primary key column")
        for idx in tbl0.indexes:
            cols = [c.lower() for c in idx.columns]
            if name.lower() in cols and len(cols) > 1:
                raise UnsupportedError(
                    "cannot drop column '%s' covered by multi-column "
                    "index '%s'", name, idx.name)

        def fn(m):
            db, tbl = self._get_table(m, tn)
            ci = tbl.find_column(name)
            if ci is None:
                raise ColumnNotExistsError("Unknown column '%s'", name)
            if tbl.pk_is_handle and tbl.pk_col_name.lower() == name.lower():
                raise UnsupportedError("cannot drop the primary key column")
            # ONE meta mutation drops the column AND its single-column
            # indexes — a crash can never observe one without the other
            tbl.indexes = [idx for idx in tbl.indexes
                           if name.lower() not in
                           [c.lower() for c in idx.columns]]
            tbl.columns = [c for c in tbl.columns if c is not ci]
            for i, c in enumerate(tbl.columns):
                c.offset = i
            m.update_table(db.id, tbl)
        self._with_meta(fn)

    def _alter_modify_column(self, tn, cd: ast.ColumnDef):
        """Same storage class: meta-only flip in one txn. Cross-class
        (INT -> VARCHAR, VARCHAR -> INT, ...): a reorg job — full row
        rewrite with value conversion, the modified column re-allocated
        under a fresh column id (the columnar engine's arrays are typed
        per id; reference: the hidden 'changing column' of
        ddl/column.go modify-column reorg), committed atomically with
        the job record (owner/ddl_runner.py)."""
        db_name = tn.db or self.sess.vars.current_db
        tbl = self.domain.infoschema().table_by_name(db_name, tn.name)
        ci = tbl.find_column(cd.name)
        if ci is None:
            raise ColumnNotExistsError("Unknown column '%s'", cd.name)
        new_ci = column_def_to_info(cd, ci.id, ci.offset)
        if new_ci.ft.tclass == ci.ft.tclass:
            def fn(m):
                db, tbl2 = self._get_table(m, tn)
                cur = tbl2.find_column(cd.name)
                if cur is None:
                    raise ColumnNotExistsError("Unknown column '%s'",
                                               cd.name)
                tbl2.columns[cur.offset] = column_def_to_info(
                    cd, cur.id, cur.offset)
                m.update_table(db.id, tbl2)
            self._with_meta(fn)
            return
        lo = cd.name.lower()
        if tbl.pk_is_handle and tbl.pk_col_name.lower() == lo:
            raise UnsupportedError(
                "cannot change the clustered primary key column's "
                "storage class")
        if tbl.partitions and tbl.partitions["col"].lower() == lo:
            raise UnsupportedError(
                "cannot change the partition column's storage class")
        job = DDLJob(type=TYPE_MODIFY_COLUMN, db_name=db_name,
                     table_name=tbl.name, table_id=tbl.id,
                     args={"column": new_ci.to_json()})
        self._submit_job(job)

    def _set_index_state(self, tn, idx_name, state):
        """One F1 state transition = one meta txn = one schema version
        bump (reference ddl/index.go onCreateIndex state ladder)."""
        def fn(m):
            db, tbl = self._get_table(m, tn)
            idx = tbl.find_index(idx_name)
            if idx is not None:
                idx.state = state
                m.update_table(db.id, tbl)
            return db, tbl, idx
        return self._with_meta(fn)

    def add_index_prepare(self, tn, idx_def):
        """First F1 step: create the index meta in DELETE_ONLY (one
        schema version). Shared by the local ladder and the
        distributed reorg driver (cluster add_index)."""
        from ..models.schema import SchemaState

        def fn(m):
            db, tbl = self._get_table(m, tn)
            if tbl.find_index(idx_def.name) is not None:
                raise IndexExistsError("Duplicate key name '%s'", idx_def.name)
            for cn in idx_def.columns:
                if tbl.find_column(cn) is None:
                    raise ColumnNotExistsError(
                        "Key column '%s' doesn't exist in table", cn)
            idx = IndexInfo(
                id=max((i.id for i in tbl.indexes), default=0) + 1,
                name=idx_def.name, columns=list(idx_def.columns),
                unique=idx_def.unique, primary=idx_def.primary,
                state=SchemaState.DELETE_ONLY)
            tbl.indexes.append(idx)
            m.update_table(db.id, tbl)
            return db, tbl, idx
        return self._with_meta(fn)

    def drop_index_meta(self, tn, idx_name):
        """Remove an index's meta entirely (abort path of a reorg)."""
        def undo(m):
            db2, tbl2 = self._get_table(m, tn)
            tbl2.indexes = [i for i in tbl2.indexes
                            if i.name.lower() != idx_name.lower()]
            m.update_table(db2.id, tbl2)
        self._with_meta(undo)

    def _alter_add_index(self, tn, idx_def):
        """Add index through the F1 online states (reference
        ddl/index.go onCreateIndex + backfilling*.go): none ->
        delete-only -> write-only -> write-reorg (checkpointed backfill
        while concurrent DML maintains the index) -> public. Each
        transition is its own schema version AND its own WAL-framed job
        record (owner/ddl_runner.py), so concurrent sessions never skip
        a state and a kill -9 at any seam resumes from the recorded
        state — backfill from the checkpointed handle range — or rolls
        back to clean absence with the backfilled KVs delete-ranged."""
        db_name = tn.db or self.sess.vars.current_db
        tbl = self.domain.infoschema().table_by_name(db_name, tn.name)
        # fast-fail validation (no job row for a statement that could
        # never start); the runner re-validates inside the first txn
        if tbl.find_index(idx_def.name) is not None:
            raise IndexExistsError("Duplicate key name '%s'",
                                   idx_def.name)
        for cn in idx_def.columns:
            if tbl.find_column(cn) is None:
                raise ColumnNotExistsError(
                    "Key column '%s' doesn't exist in table", cn)
        job = DDLJob(
            type=TYPE_ADD_INDEX, db_name=db_name, table_name=tbl.name,
            table_id=tbl.id,
            args={"index": {"name": idx_def.name,
                            "columns": list(idx_def.columns),
                            "unique": bool(idx_def.unique),
                            "primary": bool(getattr(idx_def, "primary",
                                                    False))},
                  "batch": self._reorg_batch()})
        self._submit_job(job)

    # ---- partition maintenance DDL ------------------------------------
    def _snapshot_rows(self, phys_tbl, cols):
        return _snapshot_rows(self.domain, phys_tbl, cols)

    def _new_handle(self, tbl, row, alloc):
        return _new_handle(tbl, row, alloc)

    def _alter_exchange_partition(self, tn, payload):
        """ALTER TABLE pt EXCHANGE PARTITION p WITH TABLE nt
        (reference ddl/partition.go onExchangeTablePartition). The
        reference swaps physical table ids in meta (O(1)); here
        indexes live under the LOGICAL table id, so the swap moves the
        rows through the normal write path — same observable contract
        (schemas must match, rows must fit the partition unless
        WITHOUT VALIDATION), row counts bounded by the two sides.
        Runs as a durable job: the swap, the schema-version bump and
        the job completion commit as ONE transaction
        (exchange_partition_apply), so a crash re-runs or finds it
        done — never half-exchanged."""
        db_name = tn.db or self.sess.vars.current_db
        pt = self.domain.infoschema().table_by_name(db_name, tn.name)
        nt_tn = payload["table"]
        job = DDLJob(
            type=TYPE_EXCHANGE_PARTITION, db_name=db_name,
            table_name=pt.name, table_id=pt.id,
            args={"partition": payload["partition"],
                  "nt_db": nt_tn.db or db_name,
                  "nt_table": nt_tn.name,
                  "validation": bool(payload.get("validation", True))})
        exchange_precheck(self.domain, job)   # fast-fail, no job row
        self._submit_job(job)

    def _alter_reorganize_partition(self, tn, payload):
        """ALTER TABLE pt REORGANIZE PARTITION p1[,p2..] INTO (...)
        (reference ddl/partition.go onReorganizePartition): the named
        partitions must be consecutive; the new ones must cover
        exactly the same bound interval. Rows of the old partitions
        re-route through the normal write path into the new layout."""
        from ..storage.partition import partition_table_info
        from ..chunk.column import py_to_datum_fast
        db_name = tn.db or self.sess.vars.current_db
        pt = self.domain.infoschema().table_by_name(db_name, tn.name)
        if not pt.partitions or pt.partitions["type"] != "range":
            raise UnsupportedError(
                "REORGANIZE PARTITION requires a RANGE-partitioned table")
        parts = pt.partitions["parts"]
        names = [n.lower() for n in payload["from"]]
        offs = [i for i, p in enumerate(parts)
                if p["name"].lower() in names]
        if len(offs) != len(names):
            raise TiDBError("Unknown partition in REORGANIZE")
        if offs != list(range(offs[0], offs[0] + len(offs))):
            raise TiDBError(
                "REORGANIZE PARTITION source partitions must be "
                "consecutive")
        pcol = pt.find_column(pt.partitions["col"])
        new_defs = []
        for pd in payload["parts"]:
            lt = pd["less_than"]
            if lt is not None:
                lt = py_to_datum_fast(lt, pcol.ft).val
            new_defs.append({"name": pd["name"], "less_than": lt})
        for i in range(1, len(new_defs)):
            a, b = new_defs[i - 1]["less_than"], new_defs[i]["less_than"]
            if a is None or (b is not None and b <= a):
                raise TiDBError(
                    "Partition bounds must be strictly ascending")
        if new_defs[-1]["less_than"] != parts[offs[-1]]["less_than"]:
            raise TiDBError(
                "REORGANIZE must keep the covered range: last new "
                "bound must equal the last old bound")
        # name/bound validation against the UNTOUCHED partitions
        # (MySQL rejects duplicate names and non-monotonic bounds,
        # and prune_partitions assumes ascending bounds)
        kept_names = {p["name"].lower() for j, p in enumerate(parts)
                      if j not in offs}
        new_names = [d["name"].lower() for d in new_defs]
        if len(set(new_names)) != len(new_names) or \
                kept_names & set(new_names):
            raise TiDBError("Duplicate partition name in REORGANIZE")
        if offs[0]:
            prev_bound = parts[offs[0] - 1]["less_than"]
            first = new_defs[0]["less_than"]
            if first is not None and first <= prev_bound:
                raise TiDBError(
                    "Partition bounds must be strictly ascending")
        rows = []
        for i in offs:
            rows.extend(self._snapshot_rows(
                partition_table_info(pt, parts[i]["pid"]), pt.columns))
        old_pids = [parts[i]["pid"] for i in offs]
        # ONE transaction for meta + data: a crash either keeps the
        # old layout with every row, or lands the new one — the
        # removed rows are never durable without their re-inserts
        # (meta rows live in the same KV store as data)
        txn = self.domain.storage.begin()
        try:
            m = Mutator(txn)
            db, tbl = self._get_table(m, tn)
            old_view = copy.copy(tbl)
            old_view.partitions = dict(tbl.partitions)
            old_view.partitions["parts"] = list(parts)
            newp = [{"name": d["name"], "pid": m.gen_global_id(),
                     "less_than": d["less_than"]} for d in new_defs]
            tbl.partitions = dict(tbl.partitions)
            tbl.partitions["parts"] = \
                parts[:offs[0]] + newp + parts[offs[-1] + 1:]
            m.update_table(db.id, tbl)
            m.gen_schema_version()
            for h, row in rows:
                table_rt.remove_record(txn, old_view, h, row)
            alloc = self.domain.allocator(tbl)
            for _h, row in rows:
                table_rt.add_record(
                    txn, tbl, self._new_handle(tbl, row, alloc), row)
            txn.commit()
        except BaseException:
            txn.rollback()
            raise
        for pid in old_pids:
            self.domain.columnar.tables.pop(pid, None)

    # ---- placement policies -------------------------------------------
    def _policy_table(self):
        """One internal session per domain, with the backing system
        table bootstrapped on first use."""
        s = getattr(self.domain, "_placement_sess", None)
        if s is None:
            from . import Session
            s = Session(self.domain)
            s.vars.current_db = "mysql"
            s.execute(
                "create table if not exists placement_policies ("
                "name varchar(64) primary key, settings varchar(512))")
            self.domain._placement_sess = s
        return s

    def placement_policy(self, stmt):
        """CREATE/ALTER/DROP PLACEMENT POLICY (reference
        pkg/ddl/placement_policy.go). Policies are named option bags
        persisted in mysql.placement_policies; attachment via ALTER
        TABLE ... PLACEMENT POLICY=. Single-host build: placement is
        recorded and queryable (information_schema), enforcement is
        the cluster layer's round-robin until multi-region exists."""
        import json as _json
        s = self._policy_table()
        esc = stmt.name.replace("'", "''")
        rs = s.execute("select settings from placement_policies "
                       f"where name = '{esc}'")
        exists = bool(rs.rows)
        if stmt.action == "create":
            if exists:
                if stmt.if_not_exists:
                    return
                raise TiDBError("Placement policy '%s' exists",
                                stmt.name)
            opts = _json.dumps(stmt.options).replace("'", "''")
            s.execute(f"insert into placement_policies values "
                      f"('{esc}', '{opts}')")
        elif stmt.action == "alter":
            if not exists:
                raise TiDBError("Unknown placement policy '%s'",
                                stmt.name)
            old = _json.loads(rs.rows[0][0])
            old.update(stmt.options)
            opts = _json.dumps(old).replace("'", "''")
            s.execute(f"update placement_policies set settings = "
                      f"'{opts}' where name = '{esc}'")
        else:
            if not exists and not stmt.if_exists:
                raise TiDBError("Unknown placement policy '%s'",
                                stmt.name)
            # refuse while referenced (reference: ErrPlacementPolicyInUse)
            isc = self.domain.infoschema()
            for db in isc.all_schemas():
                for t in isc.tables_in_schema(db.name):
                    if t.placement_policy.lower() == stmt.name.lower():
                        raise TiDBError(
                            "Placement policy '%s' is still in use by "
                            "table %s", stmt.name, t.name)
            s.execute(f"delete from placement_policies "
                      f"where name = '{esc}'")

    def _alter_table_placement(self, tn, policy_name):
        esc = policy_name.replace("'", "''").lower()
        if esc == "default":
            esc = ""        # PLACEMENT POLICY = DEFAULT detaches
        else:
            s = self._policy_table()
            rs = s.execute("select 1 from placement_policies "
                           f"where name = '{esc}'")
            if not rs.rows:
                raise TiDBError("Unknown placement policy '%s'",
                                policy_name)

        def fn(m):
            db, tbl = self._get_table(m, tn)
            tbl.placement_policy = esc
            m.update_table(db.id, tbl)
        self._with_meta(fn)

    # ---- helpers ------------------------------------------------------
    def _db_by_name(self, m, name):
        if not name:
            raise NoDatabaseSelectedError("No database selected")
        for db in m.list_databases():
            if db.name.lower() == name.lower():
                return db
        raise DatabaseNotExistsError("Unknown database '%s'", name)

    def _get_table(self, m, tn):
        db = self._db_by_name(m, tn.db or self.sess.vars.current_db)
        for t in m.list_tables(db.id):
            if t.name.lower() == tn.name.lower():
                return db, t
        raise TableNotExistsError("Unknown table '%s'", tn.name)


def schema_state_name(state) -> str:
    """Display name for a SchemaState (reference model.SchemaState
    String(): the names ADMIN SHOW DDL JOBS / ddl_jobs print)."""
    return {
        SchemaState.NONE: "none",
        SchemaState.DELETE_ONLY: "delete only",
        SchemaState.WRITE_ONLY: "write only",
        SchemaState.WRITE_REORG: "write reorganization",
        SchemaState.PUBLIC: "public",
    }.get(state, str(int(state)))


def _wait_hooks_drained(domain, start_ts, timeout=5.0):
    """Wait until every commit <= start_ts has reached the hook-fed
    engines (storage/mvcc hooks_drained): the columnar apply runs
    after durability, so a columnar snapshot taken inside a txn could
    otherwise trail the KV state by a whole group-commit fsync —
    commits the snapshot then misses are NOT the ones the txn's
    writes conflict with. Bounded: on a wedged hook the caller
    proceeds under conflict-detection alone rather than stalling the
    DDL job."""
    import time as _time
    mvcc = domain.storage.mvcc
    deadline = _time.time() + timeout
    while not mvcc.hooks_drained(start_ts):
        if _time.time() > deadline:
            break
        _time.sleep(0.0005)


def _snapshot_rows(domain, phys_tbl, cols):
    """[(handle, [Datum per column])] for the live rows of one
    PHYSICAL table (a partition pid or a plain table id)."""
    if domain.columnar.tables.get(phys_tbl.id) is None:
        return []
    # route through the engine so a just-changed schema (added
    # column) refreshes the ctab's arrays before we read
    ctab = domain.columnar.table(phys_tbl)
    if ctab.live_count() == 0:
        return []
    valid = ctab.valid_at()
    out = []
    for i in np.nonzero(valid)[0].tolist():
        row = [ctab.column_for(ci).get_datum(i) for ci in cols]
        out.append((int(ctab.handles[i]), row))
    return out


def _new_handle(tbl, row, alloc):
    if tbl.pk_is_handle:
        off = next(i for i, c in enumerate(tbl.columns)
                   if c.name.lower() == tbl.pk_col_name.lower())
        return int(row[off].val)
    return alloc.next_handle()


def exchange_precheck(domain, job):
    """EXCHANGE PARTITION static validation from the durable job args
    (shared by the fast-fail path pre-enqueue and the runner handler
    at apply/resume time). Returns (pt, nt, part)."""
    a = job.args
    isc = domain.infoschema()
    pt = isc.table_by_name(job.db_name, job.table_name)
    nt = isc.table_by_name(a["nt_db"], a["nt_table"])
    if not pt.partitions:
        raise UnsupportedError("%s is not partitioned", pt.name)
    if nt.partitions:
        raise UnsupportedError(
            "EXCHANGE target %s must not be partitioned", nt.name)
    part = next((p for p in pt.partitions["parts"]
                 if p["name"].lower() == a["partition"].lower()), None)
    if part is None:
        raise TiDBError("Unknown partition '%s'", a["partition"])
    sig = lambda t: [(c.name.lower(), c.ft.tclass, c.ft.flen,  # noqa: E731
                      c.ft.decimal) for c in t.columns]
    if sig(pt) != sig(nt):
        raise UnsupportedError("Tables have different definitions")
    return pt, nt, part


def exchange_partition_apply(runner, job):
    """Runner handler: snapshot, validate and swap INSIDE the terminal
    txn body, so a WriteConflict retry (concurrent DML landed between
    snapshot and commit) re-snapshots instead of writing stale rows.
    The txn carries rows + schema-version bump + job completion — a
    crash either re-runs the whole handler at resume (nothing applied)
    or finds the job synced in history."""
    from ..storage.partition import partition_table_info, route_partition
    domain = runner.domain

    def fn(m):
        _wait_hooks_drained(domain, m.txn.start_ts)
        pt, nt, part = exchange_precheck(domain, job)
        rows_p = _snapshot_rows(
            domain, partition_table_info(pt, part["pid"]), pt.columns)
        rows_n = _snapshot_rows(domain, nt, nt.columns)
        if job.args.get("validation", True):
            pcol_off = next(i for i, c in enumerate(pt.columns)
                            if c.name.lower() ==
                            pt.partitions["col"].lower())
            for _h, row in rows_n:
                d = row[pcol_off]
                pid = route_partition(
                    pt, None if d.is_null else int(d.val))
                if pid != part["pid"]:
                    raise TiDBError(
                        "Found a row that does not match the partition")
        txn = m.txn
        for h, row in rows_p:
            table_rt.remove_record(txn, pt, h, row)
        for h, row in rows_n:
            table_rt.remove_record(txn, nt, h, row)
        pt_alloc = domain.allocator(pt)
        nt_alloc = domain.allocator(nt)
        for _h, row in rows_n:
            table_rt.add_record(
                txn, pt, _new_handle(pt, row, pt_alloc), row)
        for _h, row in rows_p:
            table_rt.add_record(
                txn, nt, _new_handle(nt, row, nt_alloc), row)
        job.schema_state = SchemaState.PUBLIC
        job.state = STATE_SYNCED
        m.finish_ddl_job(job)
    runner._terminal_txn(job, fn)


def modify_column_apply(runner, job):
    """Runner handler for the cross-class MODIFY COLUMN reorg: rewrite
    every row converting the column's datums to the new type, with the
    column re-created under a FRESH column id (the columnar engine
    types its arrays per id — reference: the hidden 'changing column').
    Snapshot + conversion live inside the terminal txn body for the
    same retry-correctness as exchange_partition_apply. A conversion
    failure aborts the whole txn — the job rolls back with nothing
    applied."""
    from ..storage.partition import partition_table_info
    from ..chunk.column import py_to_datum_fast
    from ..types.datum import NULL
    from ..errors import TruncatedWrongValueError
    domain = runner.domain

    def fn(m):
        _wait_hooks_drained(domain, m.txn.start_ts)
        db, t2 = runner._get_tbl(m, job)
        want = ColumnInfo.from_json(job.args["column"])
        cur = t2.find_column(want.name)
        if cur is None:
            raise ColumnNotExistsError("Unknown column '%s'", want.name)
        off = cur.offset
        phys = [partition_table_info(t2, p["pid"])
                for p in t2.partitions["parts"]] if t2.partitions \
            else [t2]
        rows = []
        for ph in phys:
            rows.extend(_snapshot_rows(domain, ph, t2.columns))
        new_rows = []
        for h, row in rows:
            d = row[off]
            if d.is_null:
                nd = NULL
            else:
                try:
                    nd = py_to_datum_fast(d.to_py(), want.ft)
                except TiDBError:
                    raise
                except Exception:               # noqa: BLE001
                    raise TruncatedWrongValueError(
                        "Incorrect %s value: '%s' for column '%s' at "
                        "row with handle %d", want.ft.tp,
                        d.to_py(), want.name, h)
            r = list(row)
            r[off] = nd
            new_rows.append((h, r))
        old_view = copy.copy(t2)
        old_view.columns = list(t2.columns)
        new_ci = ColumnInfo.from_json(job.args["column"])
        new_ci.id = max(c.id for c in t2.columns) + 1
        new_ci.offset = off
        t2.columns = list(t2.columns)
        t2.columns[off] = new_ci
        m.update_table(db.id, t2)
        txn = m.txn
        for h, row in rows:
            table_rt.remove_record(txn, old_view, h, row)
        for h, r in new_rows:
            table_rt.add_record(txn, t2, h, r)
        job.schema_state = SchemaState.PUBLIC
        job.state = STATE_SYNCED
        m.finish_ddl_job(job)
    runner._terminal_txn(job, fn)


def backfill_index_batch(domain, tbl, phys_tbl_id, idx, start_after=None,
                         limit=2048):
    """One handle-ordered backfill batch for the durable job runner
    (owner/ddl_runner.py): index entries for up to ``limit`` live rows
    of physical table ``phys_tbl_id`` with handle > ``start_after``,
    committed through the NORMAL transactional write path — a
    concurrent DML commit touching the same index keys surfaces as
    WriteConflict and the caller retries with a fresh snapshot, so a
    stale entry can never be resurrected the way a blind bulk ingest
    could. Returns (rows_written, last_handle)."""
    from ..codec.tablecodec import index_key
    from ..executor.table_rt import fold_ci_datums
    if domain.columnar.tables.get(phys_tbl_id) is None:
        return 0, start_after
    # route through the engine so a just-changed schema (ADD COLUMN
    # followed by ADD INDEX on it) refreshes the ctab's arrays before
    # we read — the raw tables.get ctab would KeyError on the new
    # column id (same contract as _snapshot_rows)
    if phys_tbl_id == tbl.id:
        phys_info = tbl
    else:
        from ..storage.partition import partition_table_info
        phys_info = partition_table_info(tbl, phys_tbl_id)
    ctab = domain.columnar.table(phys_info)
    if ctab.live_count() == 0:
        return 0, start_after
    floor = -(1 << 63) if start_after is None else int(start_after)
    # begin BEFORE snapshotting: a row deleted/updated by a commit
    # between the snapshot and our start_ts would not conflict at
    # commit time, resurrecting its stale entry (caught by ddl_smoke's
    # pre-public × concurrent-DML case — the 501-entries-for-500-rows
    # dangling key). With begin first, any overlapping commit after
    # start_ts trips WriteConflict and the batch retries fresh.
    txn = domain.storage.begin()
    try:
        # ... and wait out in-flight hook publications <= start_ts:
        # once drained, the snapshot is at least as fresh as start_ts
        # and every commit it can't see is one our index-key writes
        # conflict with. (Values must come from the columnar engine,
        # not a positional row-KV decode — rows written before a
        # column-set DDL keep their old layout until next touched.)
        _wait_hooks_drained(domain, txn.start_ts)
        mvcc = domain.storage.mvcc
        valid = ctab.valid_at()
        pos = np.nonzero(valid)[0]
        handles = ctab.handles[pos]
        keep = handles > floor
        pos, handles = pos[keep], handles[keep]
        if len(pos) == 0:
            txn.rollback()
            return 0, start_after
        order = np.argsort(handles, kind="stable")[:limit]
        pos, handles = pos[order], handles[order]
        cols = [tbl.find_column(c) for c in idx.columns]
        col_views = [ctab.column_for(ci, pos) for ci in cols]
        from ..codec.tablecodec import record_key
        last = floor
        for j in range(len(pos)):
            handle = int(handles[j])
            if mvcc.absent_at(record_key(phys_tbl_id, handle),
                              txn.start_ts):
                # freshly deleted (or not yet visible) in the row KV:
                # its own DML maintenance owns the entry — skipping
                # here just saves a guaranteed conflict-retry
                last = handle
                continue
            datums = fold_ci_datums(
                tbl, idx, [cv.get_datum(j) for cv in col_views])
            if idx.unique and not any(d.is_null for d in datums):
                ik = index_key(tbl.id, idx.id, datums)
                existing = txn.get(ik)
                if existing is not None and \
                        existing not in (str(handle).encode(), b""):
                    # concurrent WRITE_ONLY maintenance may have
                    # written this very row's entry; only a different
                    # handle is a duplicate
                    raise DuplicateKeyError(
                        "Duplicate entry for key '%s'", idx.name)
                txn.set(ik, str(handle).encode())
            else:
                txn.set(index_key(tbl.id, idx.id, datums, handle), b"")
            last = handle
        txn.commit()
        return len(pos), last
    except BaseException:
        txn.rollback()
        raise


def purge_index_range(domain, table_id, index_id):
    """Delete every KV in an index's key range (reference
    delete-range worker; used by DROP INDEX and by the abort path of
    a distributed reorg, which must erase already-committed backfill
    KVs so a recycled index id never inherits ghost entries)."""
    from ..codec.tablecodec import index_prefix
    pref = index_prefix(table_id, index_id)
    txn = domain.storage.begin()
    try:
        for k, _v in txn.scan(pref, pref + b"\xff" * 9):
            txn.delete(k)
        txn.commit()
    except BaseException:
        txn.rollback()
        raise


def backfill_index_shard(domain, tbl, idx, collect_keys=False,
                         ingest=True):
    """Snapshot backfill of THIS node's rows into index KVs (reference
    ddl/backfilling*.go read-index step; dispatched per shard by the
    distributed reorg, pkg/ddl/backfilling_dist_scheduler.go). The
    index must already be in WRITE_REORG so concurrent DML maintains
    it. Returns (rows_backfilled, key_hashes): key_hashes is non-None
    only for collect_keys — the coordinator merges per-shard hashes of
    UNIQUE index keys to detect cross-shard duplicates (shard-local
    dups are caught here against the store view).

    Default path is INGEST (reference fast path: lightning engine
    builds SSTs, pkg/ingestor ships them into TiKV): the shard's index
    entries are built in memory, sorted by key, and applied as ONE
    bulk ingest — one WAL frame, no prewrite/lock round, no per-batch
    2PC. `ingest=False` keeps the transactional path (used when the
    caller needs conflict semantics against concurrent writers)."""
    from ..codec.tablecodec import index_key
    from ..executor.table_rt import fold_ci_datums
    ctab = domain.columnar.tables.get(tbl.id)
    if ctab is None or ctab.live_count() == 0:
        return 0, ([] if collect_keys else None)
    mvcc = domain.storage.mvcc
    read_ts = domain.storage.current_ts()
    txn = None if ingest else domain.storage.begin()
    try:
        valid = ctab.valid_at()
        idxs = np.nonzero(valid)[0]
        cols = [tbl.find_column(c) for c in idx.columns]
        key_hashes = [] if collect_keys else None
        muts = []
        for i in idxs.tolist():
            handle = int(ctab.handles[i])
            datums = []
            for ci in cols:
                col = ctab.column_for(ci)
                datums.append(col.get_datum(i))
            datums = fold_ci_datums(tbl, idx, datums)
            if idx.unique and not any(d.is_null for d in datums):
                ik = index_key(tbl.id, idx.id, datums)
                existing = txn.get(ik) if txn is not None else \
                    mvcc.get(ik, read_ts)
                if existing is not None and \
                        existing not in (str(handle).encode(), b""):
                    # a concurrent write-only writer may have written
                    # this very row's entry already; only a different
                    # handle is a duplicate
                    raise DuplicateKeyError(
                        "Duplicate entry for key '%s'", idx.name)
                if txn is not None:
                    txn.set(ik, str(handle).encode())
                else:
                    muts.append((ik, str(handle).encode()))
                if collect_keys:
                    # 128-bit digest: cross-shard dup detection must
                    # never false-positive on hash collisions
                    key_hashes.append(
                        hashlib.blake2b(ik, digest_size=16).hexdigest())
            else:
                ik = index_key(tbl.id, idx.id, datums, handle)
                if txn is not None:
                    txn.set(ik, b"")
                else:
                    muts.append((ik, b""))
        if txn is not None:
            txn.commit()
        elif muts:
            # shard-local duplicates surface as repeated keys in the
            # sorted artifact (unique index: same key, two handles)
            muts.sort(key=lambda kv: kv[0])
            if idx.unique:
                for (ka, va), (kb, vb) in zip(muts, muts[1:]):
                    if ka == kb and va != vb:
                        raise DuplicateKeyError(
                            "Duplicate entry for key '%s'", idx.name)
            # commit-intent bracket around the ts allocation: the CDC
            # resolved-ts floor must not pass the ingest frame's ts
            # before the frame publishes (storage/mvcc resolved_floor)
            pre_ts = domain.storage.current_ts()
            intent = mvcc.begin_commit_intent(pre_ts)
            try:
                mvcc.ingest(muts, domain.storage.current_ts())
            finally:
                mvcc.end_commit_intent(intent)
        return len(idxs), key_hashes
    except BaseException:
        if txn is not None:
            txn.rollback()
        raise


def _zero_default(ft):
    if ft.tclass in (TypeClass.STRING, TypeClass.JSON):
        return ""
    if ft.tclass == TypeClass.FLOAT:
        return 0.0
    return 0


from ..errors import NoDatabaseSelectedError, DuplicateKeyError  # noqa: E402
