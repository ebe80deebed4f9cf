"""Session: statement lifecycle (reference pkg/session/session.go:2416
ExecuteStmt / runStmt:2940). Parse -> plan -> execute, transaction begin /
commit-on-autocommit, DDL and utility statement dispatch."""
from __future__ import annotations

import time

from ..parser import parse, ast
from ..planner import optimize, PlanContext
from ..planner.builder import InsertPlan, UpdatePlan, DeletePlan
from ..planner.physical import explain_text
from ..executor import build_executor, ExecContext
from ..executor.dml import InsertExec, UpdateExec, DeleteExec
from ..errors import TiDBError, UnsupportedError
from .sysvars import SessionVars
from .domain import Domain
from .ddl import DDLExecutor
from . import fastpath as _fastpath


class ResultSet:
    def __init__(self, names=None, chunks=None, affected=0, last_insert_id=0):
        self.names = names or []
        self.chunks = chunks or []
        self.affected = affected
        self.last_insert_id = last_insert_id

    @property
    def rows(self):
        out = []
        for ch in self.chunks:
            out.extend(ch.rows_py())
        return out

    def __repr__(self):
        return f"ResultSet({self.names}, {len(self.rows)} rows)"


class Session:
    _next_conn_id = [0]

    def __init__(self, domain: Domain):
        self.domain = domain
        self.vars = SessionVars(domain.global_vars)
        self._txn = None
        self._explicit_txn = False
        Session._next_conn_id[0] += 1
        self.conn_id = Session._next_conn_id[0]
        self.ddl = DDLExecutor(self)
        self.user = "root"
        self.host = "%"
        # internal SQL (bootstrap, sysvar persistence, auto-analyze,
        # TTL) tags its slow-log rows so operator queries can filter it
        # (information_schema.slow_query.is_internal)
        self.is_internal = False
        self.prepared: dict = {}     # name -> (stmt_ast, sql_text)
        # session-level memory tracker: statement trackers (ExecContext)
        # child off it, so domain.mem_root sees session->statement->
        # operator consumption and the global memory controller can
        # attribute bytes to connections (utils/memory.py)
        self.mem_tracker = domain.mem_root.child(f"conn {self.conn_id}")
        self._stmt_mem_max = 0   # per-statement tracker peak (_observe)
        import weakref
        domain.sessions[self.conn_id] = weakref.ref(self)
        self.stmt_handles: dict = {}  # stmt_id -> (ast, n_params, sql)
        self._next_stmt_id = 0
        self.temp_tables: dict = {}  # name -> TableInfo (negative id)
        self._next_temp_id = [-2]
        from ..bindinfo import BindHandle
        self.session_binds = BindHandle()
        self.active_roles = None     # None = defaults not applied yet
        self.resource_group = "default"

    # ---- txn lifecycle ------------------------------------------------
    def txn(self):
        if self._txn is None or self._txn.committed or self._txn.aborted:
            self._txn = self.domain.storage.begin(
                pessimistic=self.vars.get("tidb_txn_mode") == "pessimistic")
            self._txn.set_lock_ctx(self._lock_ctx())
        return self._txn

    def _lock_ctx(self):
        """Lock-lifecycle knobs for this session's transactions
        (storage/lock_resolver.LockCtx from the tidb_tpu_lock_* sysvars)."""
        from ..storage.lock_resolver import LockCtx
        return LockCtx(
            ttl_ms=int(self.vars.get("tidb_tpu_lock_ttl_ms")),
            wait_timeout_ms=int(self.vars.get(
                "tidb_tpu_lock_wait_timeout_ms")),
            backoff_ms=int(self.vars.get("tidb_tpu_lock_wait_backoff_ms")))

    def _stmt_lock_guard(self, txn, ectx):
        """Scope the txn's lock waits to THIS statement: its deadline
        and KILL flag (ectx=None clears a previous statement's — a new
        statement must never inherit an already-expired clock)."""
        from dataclasses import replace as _replace
        txn.set_lock_ctx(_replace(
            txn.lock_ctx,
            deadline=ectx.deadline if ectx is not None else None,
            check_interrupt=ectx.check_killed if ectx is not None
            else None))

    def _commit_txn(self):
        """Commit with the session's fast-path policy (reference
        twoPhaseCommitter mode selection): 1PC > async commit > 2PC,
        gated by sysvars and the async-commit size caps; the taken
        path lands in metrics (txn_1pc / txn_async_commit / txn_2pc)."""
        t = self._txn
        # no guard reset here: an autocommit DML commit runs inside its
        # statement's still-current guard; the explicit COMMIT statement
        # installs a fresh one in _dispatch, and every statement start
        # clears stale guards (_execute_stmt)
        cts = t.commit(
            async_commit=bool(self.vars.get("tidb_enable_async_commit")),
            one_pc=bool(self.vars.get("tidb_enable_1pc")),
            keys_limit=int(self.vars.get("tidb_async_commit_keys_limit")),
            size_limit=int(self.vars.get(
                "tidb_async_commit_total_key_size_limit")))
        if cts:
            # read-your-writes floor for the replica router: a replica
            # only qualifies for this session once its watermark covers
            # the session's own last commit
            self._last_commit_ts = cts
        if t.commit_mode == "1pc":
            self.domain.inc_metric("txn_1pc")
        elif t.commit_mode == "async":
            self.domain.inc_metric("txn_async_commit")
        elif t.commit_mode == "2pc":
            self.domain.inc_metric("txn_2pc")

    def _finish_stmt(self, error=False):
        if self._explicit_txn:
            if error and self._txn is not None:
                pass  # MySQL keeps txn open on statement error
            return
        if self._txn is not None and not self._txn.committed and \
                not self._txn.aborted:
            if error:
                self._txn.rollback()
            else:
                self._commit_txn()
        self._txn = None

    def commit(self):
        try:
            if self._txn is not None and not self._txn.committed and \
                    not self._txn.aborted:
                self._commit_txn()
        finally:
            # a failed COMMIT still ENDS the transaction (MySQL
            # semantics): roll back the leftover state so its locks are
            # released/tombstoned instead of dangling on the session
            if self._txn is not None and not self._txn.committed and \
                    not self._txn.aborted:
                self._txn.rollback()
            self._txn = None
            self._explicit_txn = False

    def rollback(self):
        if self._txn is not None and not self._txn.committed and \
                not self._txn.aborted:
            self._txn.rollback()
        self._txn = None
        self._explicit_txn = False

    # ---- public entry --------------------------------------------------
    def execute(self, sql: str, params=None) -> ResultSet:
        # point-op fast path FIRST (session/fastpath.py): a recognized
        # PK lookup is served from a cached plan template without
        # parse/optimize/executor build; None = not that shape (or a
        # state the template can't serve) -> full pipeline below
        rs = _fastpath.try_execute(self, sql, params)
        if rs is not None:
            return rs
        # AST cache: same reuse contract as prepared statements (the
        # planner treats parsed trees as read-only); bounded LRU
        dom = self.domain
        stmts = dom.ast_cache.get(sql)
        if stmts is None:
            stmts = parse(sql)
            dom.ast_cache.put(sql, stmts)
        result = ResultSet()
        cache_key_ok = len(stmts) == 1   # multi-stmt text can't key the cache
        for stmt in stmts:
            result = self._execute_stmt(stmt, params, sql,
                                        cacheable=cache_key_ok)
        return result

    def _execute_stmt(self, stmt, params=None, sql="",
                      cacheable=True) -> ResultSet:
        for tname in [t for t in self.temp_tables
                      if t.startswith("__cte_final_")]:
            self.drop_temp_table(tname)
        self._cur_sql = sql if cacheable else ""
        from ..expression.builtins_ext import (reset_rand_states,
                                               set_encryption_mode)
        reset_rand_states()     # RAND(N) restarts per statement
        set_encryption_mode(self.vars.get("block_encryption_mode"))
        from ..utils import phase as _phase
        adm_wait_s = 0.0
        rg = self.domain.resource_groups.groups.get(self.resource_group)
        if rg is not None:
            # token-bucket admission control (RU throttle)
            adm_wait_s += rg.admit() or 0.0
        # OLAP-vs-OLTP dispatch split: analytic statements take a
        # bounded per-group admission slot so a burst of them can
        # never occupy every interpreter thread while point ops
        # queue behind. Outermost user statements only — internal
        # SQL (TTL, stats) and nested statements must not deadlock
        # on a slot their parent holds.
        adm_rg = self._maybe_admit_olap(stmt, at_depth=0)
        adm_wait_s += getattr(self, "_olap_wait_s", 0.0)
        self._olap_wait_s = 0.0
        # per-statement backend phase counters: reset at the OUTERMOST
        # statement only (internal SQL fired mid-statement — stats sync
        # load, TTL — accumulates into its triggering statement)
        _phase.stmt_enter()
        if adm_wait_s > 0.0:
            # attributed AFTER stmt_enter: admission ran before the
            # phase reset, but the wait belongs to THIS statement
            _phase.add("admission_wait_s", adm_wait_s)
        if _phase.depth() == 1:
            # per-statement memory high-water mark: nested internal SQL
            # folds its peaks into the outer statement's, like phases
            self._stmt_mem_max = 0
            # replica-routing outcome for this statement ("", "replica-
            # <rid>", "leader_fallback", "degraded_midstmt") — consumed
            # by _observe for the slow log + Top SQL fold
            self._stmt_route = ""
        # MySQL diagnostics-area lifecycle: each statement RESETS the
        # area; SHOW WARNINGS/ERRORS and GET DIAGNOSTICS read the
        # PREVIOUS statement's area so they are exempt
        if not (isinstance(stmt, ast.GetDiagnosticsStmt) or
                (isinstance(stmt, ast.ShowStmt) and
                 stmt.kind in ("warnings", "errors"))):
            self.vars.warnings = []
        # session-driven TTL heartbeat: every statement inside an
        # explicit txn extends its locks' wall deadline, so a long
        # interactive transaction isn't resolved out from under the
        # session (reference client-go txnHeartBeat); an IDLE txn still
        # expires after tidb_tpu_lock_ttl_ms by design. The PREVIOUS
        # statement's deadline/kill hook is dropped here — each
        # statement that can block installs its own (_stmt_lock_guard)
        if self._explicit_txn and self._txn is not None and \
                not self._txn.committed and not self._txn.aborted:
            self._txn.heartbeat()
            self._stmt_lock_guard(self._txn, None)
        start = time.time()
        # sampling decision for the trace this statement roots (honored
        # only when this IS the root — nested statements ride the outer
        # trace): TRACE always samples; slow statements upgrade
        # retroactively via mark_sampled() in _observe; everything else
        # rolls tidb_tpu_trace_sample_rate (default 0 — the OLTP fast
        # path never touches the recorder ring)
        samp = isinstance(stmt, ast.TraceStmt)
        if not samp:
            try:
                rate = float(self.vars.get("tidb_tpu_trace_sample_rate"))
            except (TypeError, ValueError):
                rate = 0.0
            if rate >= 1.0:
                samp = True
            elif rate > 0.0:
                import random
                samp = random.random() < rate
        with self.domain.tracer.span("statement", conn_id=self.conn_id,
                                     sampled=samp,
                                     stmt=type(stmt).__name__):
            try:
                rs = self._dispatch(stmt, params)
                self._observe(stmt, sql, start, ok=True, rgroup=rg)
                return rs
            except TiDBError as e:
                # the error becomes the statement's diagnostics area
                # (SHOW WARNINGS / GET DIAGNOSTICS after a failed
                # statement see it, like MySQL)
                self.vars.warnings = [{
                    "level": "Error",
                    "code": getattr(e, "code", 1105),
                    "sqlstate": getattr(e, "sqlstate", "HY000"),
                    "msg": e.msg}]
                self._observe(stmt, sql, start, ok=False, rgroup=rg)
                from ..errors import DeadlockError
                if isinstance(e, DeadlockError):
                    # InnoDB semantics: the deadlock victim's WHOLE
                    # transaction rolls back (not just the statement),
                    # releasing its locks so the survivor can proceed
                    self.rollback()
                else:
                    self._finish_stmt(error=True)
                raise
            finally:
                _phase.stmt_leave()
                if adm_rg is not None:
                    adm_rg.release_olap()

    def _maybe_admit_olap(self, stmt, at_depth):
        """Take an OLAP admission slot when ``stmt`` classifies olap
        at the expected nesting depth (0 = plain dispatch, 1 = the
        inner statement of a textual EXECUTE, whose wrapper is the
        outermost statement). Returns the group to release_olap() in a
        finally, or None. The wait registers a kill sentinel in
        _live_execs — a queued statement has no ExecContext yet, and
        KILL <conn> must still reach it."""
        from ..utils import phase as _phase
        if self.is_internal or _phase.depth() != at_depth or \
                _stmt_class(stmt) != "olap":
            return None
        rg = self.domain.resource_groups.groups.get(self.resource_group)
        if rg is None:
            return None
        slots = rg.olap_slots
        if slots is None:
            slots = int(self.vars.get("tidb_tpu_olap_admission_slots"))
        if not slots or slots <= 0:
            return None
        waiter = _AdmissionWaiter()
        self.domain.register_exec(self.conn_id, waiter)
        try:
            # stashed for the caller: the slot wait happens before the
            # statement's phase counters reset, so _execute_stmt folds
            # it in as admission_wait_s right after stmt_enter
            self._olap_wait_s = rg.acquire_olap(slots,
                                                waiter.check_killed) or 0.0
        finally:
            self.domain.unregister_exec(self.conn_id, waiter)
        return rg

    def _observe(self, stmt, sql, start, ok, rgroup=None):
        """Slow log + statement summary (reference slow_log.go:373 +
        pkg/util/stmtsummary) + RU settlement + registry instruments +
        Top SQL phase-snapshot fold (utils/metrics)."""
        dur_ms = (time.time() - start) * 1000.0
        from ..utils import metrics as metrics_util
        from ..utils import phase as _phase
        # nested internal SQL (depth > 1) is a subset of the outer
        # statement's wall time — observing it too would make the
        # histogram sum exceed real elapsed time. Top-level system
        # sessions (TTL, sysvar persistence) are real load but not user
        # traffic: recorded under internal="1" so dashboards can filter.
        if _phase.depth() <= 1:
            stmt_type = type(stmt).__name__
            if stmt_type.endswith("Stmt"):
                stmt_type = stmt_type[:-4]
            stmt_type = stmt_type.lower()
            internal = "1" if self.is_internal else "0"
            metrics_util.QUERY_DURATION.labels(stmt_type, internal) \
                .observe(dur_ms / 1000.0)
            if not ok:
                metrics_util.QUERY_ERRORS.labels(stmt_type,
                                                 internal).inc()
        if rgroup is not None:
            # request-unit blend: ~1 RU per 3ms of statement time + a
            # per-request base (reference resource_control RU model)
            rgroup.settle(dur_ms / 3.0 + 0.125)
        nd = self.domain.digest_cache.get(sql)
        if nd is None:
            try:
                from ..parser import normalize_digest
                nd = normalize_digest(sql) if sql else ("", "")
            except Exception:
                nd = ("", "")
            self.domain.digest_cache.put(sql, nd)
        norm, digest = nd
        threshold = int(self.vars.get("tidb_slow_log_threshold"))
        if threshold >= 0 and dur_ms > threshold:
            # flight-recorder trigger (reference session.go:2417-2423
            # dumps the traceevent ring on slow statements): tag the
            # open statement span AND reach back for its already-closed
            # stage spans (plan/execute/copr finished before the
            # statement knew it was slow)
            self.domain.tracer.tag(slow=1)
            # slow statements are always-on regardless of the sample
            # rate: upgrade the open trace so its buffered spans flush
            # at root close, tagged like the statement span
            self.domain.tracer.tag_buffered("slow=1")
            self.domain.tracer.mark_sampled()
            self.domain.flight_recorder.tag_recent(self.conn_id, start)
            # backend phase counters (utils/phase.py) ride along: a slow
            # statement's record says WHERE its time went (dispatch/
            # compile/upload/host) without a rerun — reference
            # execdetails in the slow log (slow_log.go:373)
            self.domain.slow_log.append({
                "time": time.time(), "time_ms": dur_ms, "sql": sql[:4096],
                "stmt": type(stmt).__name__, "conn": self.conn_id,
                "db": self.vars.current_db, "success": ok,
                # digest joins slow rows against statements_summary;
                # is_internal marks nested/system-session SQL
                "digest": digest,
                "is_internal": int(self.is_internal or
                                   _phase.depth() > 1),
                "mem_max": int(getattr(self, "_stmt_mem_max", 0)),
                "replica": getattr(self, "_stmt_route", ""),
                "phases": _phase.snap()})
            from ..utils import logutil
            # the digest normalization IS the redaction (one parse,
            # shared with the statement summary below)
            logutil.warn("slow_query", conn=self.conn_id,
                         ms=round(dur_ms, 1), ok=ok, sql=norm[:2048])
        summ = self.domain.stmt_summary_map.setdefault(digest, {
            "digest": digest, "normalized": norm[:1024],
            "exec_count": 0, "sum_ms": 0.0, "max_ms": 0.0, "errors": 0,
            "sum_device_ms": 0.0, "fallback_count": 0, "mem_max": 0,
            "sum_commit_wait_ms": 0.0, "sum_admission_wait_ms": 0.0})
        summ["exec_count"] += 1
        summ["sum_ms"] += dur_ms
        summ["max_ms"] = max(summ["max_ms"], dur_ms)
        if _phase.depth() <= 1:
            summ["mem_max"] = max(summ.get("mem_max", 0),
                                  int(getattr(self, "_stmt_mem_max", 0)))
        if not ok:
            summ["errors"] += 1
        # phase counters are statement-scoped but reset only at the
        # OUTERMOST statement: fold them at depth 1 exactly once, so
        # internal SQL never re-attributes the outer statement's device
        # time to its own digest
        if _phase.depth() == 1:
            ph = _phase.snap()
            summ["sum_device_ms"] += metrics_util.phase_device_ms(ph)
            summ["fallback_count"] += ph.get("device_fallbacks", 0)
            # wait attribution (satellite): time parked in WAL
            # group-commit and admission queues, per digest (snap()
            # already rendered the *_s keys to ms)
            summ["sum_commit_wait_ms"] = summ.get(
                "sum_commit_wait_ms", 0.0) + ph.get("commit_wait_s", 0.0)
            summ["sum_admission_wait_ms"] = summ.get(
                "sum_admission_wait_ms", 0.0) + \
                ph.get("admission_wait_s", 0.0)
            # plan feedback: fold the statement's runtime-stats tree
            # (stashed by _exec_select) into the per-digest store and
            # the drift histogram; hand the digest's running drift to
            # Top SQL so planner misses sit next to their cost
            drift = None
            fb = getattr(self, "_stmt_feedback", None)
            self._stmt_feedback = None
            if fb:
                from ..executor.plan_feedback import qerror
                routes = {b for _op, _e, _a, b, _ms in fb if b}
                route = routes.pop() if len(routes) == 1 else \
                    ("mixed" if routes else "")
                self.domain.plan_feedback.record(
                    digest, norm[:1024], fb, route,
                    device_ms=metrics_util.phase_device_ms(ph),
                    host_ms=ph.get("host_exec_s", 0.0))
                for opname, est, act, _backend, _ms in fb:
                    metrics_util.CARDINALITY_DRIFT.labels(opname) \
                        .observe(qerror(est, act))
                drift = self.domain.plan_feedback.digest_drift(digest)
            self.domain.top_sql.record(digest, norm[:1024], dur_ms, ph,
                                       ok=ok, drift=drift,
                                       route=getattr(self, "_stmt_route",
                                                     ""))
        self.domain.plugins.fire("audit", self, {
            "sql": sql, "digest": digest, "ok": ok, "duration_ms": dur_ms,
            "user": self.user, "db": self.vars.current_db,
            "conn_id": self.conn_id})

    def _plan_ctx(self, params=None) -> PlanContext:
        return PlanContext(
            infoschema=self.domain.infoschema(),
            sess_vars=self.vars,
            current_db=self.vars.current_db,
            run_subquery=self._run_subquery,
            table_rows=self.domain.table_rows,
            user_vars=self.domain.user_vars,
            now_micros=int(time.time() * 1_000_000),
            conn_id=self.conn_id,
            params=params,
            table_stats=self.domain.stats_or_syncload,
            check_read=self._check_read,
            temp_tables=self.temp_tables,
            make_temp_table=self.make_temp_table,
            drop_temp_table=self.drop_temp_table,
            seq_nextval=self.domain.seq_nextval,
            seq_lastval=self.domain.seq_lastval,
            ts_for_time=self.domain.storage.oracle.ts_for_time,
            table_bulk_rows=self._table_bulk_rows,
            user=f"{self.user}@{self.host}",
            model_lookup=self.domain.ml.lookup,
            device_type=self.domain.device.type,
        )

    def _table_bulk_rows(self, table_id: int) -> int:
        t = self.domain.columnar.tables.get(table_id)
        return t.bulk_rows if t is not None else 0

    def make_temp_table(self, name: str, fts, col_names, rows):
        """Materialize rows into a session temp table backed by the
        columnar engine (negative table id; read-latest)."""
        from ..models import TableInfo, ColumnInfo
        tid = self._next_temp_id[0]
        self._next_temp_id[0] -= 1
        cols = [ColumnInfo(id=i + 1, name=cn, offset=i, ft=ft.clone())
                for i, (cn, ft) in enumerate(zip(col_names, fts))]
        info = TableInfo(id=tid, name=name, columns=cols)
        from ..storage.columnar import ColumnarTable
        ctab = ColumnarTable(info)
        for h, row in enumerate(rows, start=1):
            ctab.put_row(h, list(row))
        self.domain.columnar.tables[tid] = ctab
        self.temp_tables[name.lower()] = info
        return info

    def drop_temp_table(self, name: str):
        info = self.temp_tables.pop(name.lower(), None)
        if info is not None:
            self.domain.columnar.tables.pop(info.id, None)

    def prepare_wire(self, sql: str):
        """Server-side PREPARE (COM_STMT_PREPARE): -> (stmt_id, n_params).
        The statement TEXT is kept on the handle: COM_STMT_EXECUTE
        routes it through the point fast path (parameterized plan-cache
        templates) before falling back to the prepared AST."""
        from ..parser.parser import Parser
        p = Parser(sql)
        stmts = p.parse_stmts()
        if len(stmts) != 1:
            raise UnsupportedError("can only prepare a single statement")
        self._next_stmt_id += 1
        self.stmt_handles[self._next_stmt_id] = (stmts[0], p.n_params,
                                                 sql)
        return self._next_stmt_id, p.n_params

    def execute_wire(self, stmt_id: int, params):
        entry = self.stmt_handles.get(stmt_id)
        if entry is None:
            raise UnsupportedError("unknown statement handle %d", stmt_id)
        stmt, _n, text = entry
        params = params or None
        rs = _fastpath.try_execute(self, text, params)
        if rs is not None:
            return rs
        # full statement lifecycle (admission, diagnostics area,
        # metrics, slow log) — the wire path used to bypass it entirely
        return self._execute_stmt(stmt, params, text, cacheable=False)

    def close_wire(self, stmt_id: int):
        self.stmt_handles.pop(stmt_id, None)

    def check_priv(self, priv, db="", tbl=""):
        if self.active_roles is None:
            self.active_roles = self.domain.priv.default_roles_of(
                self.user, self.host)
        self.domain.priv.check(self.user, self.host, priv, db, tbl,
                               roles=self.active_roles)

    def _check_read(self, db, tbl):
        if db.lower() == "information_schema":
            return
        self.check_priv("select", db, tbl)

    def _run_subquery(self, select_stmt, limit_one=False):
        plan = optimize(select_stmt, self._plan_ctx())
        # plan-time subquery results are data-dependent (they make the
        # enclosing plan uncacheable), but the RESULT itself is
        # deterministic over the base tables: cache it keyed by the
        # subplan's structural fingerprint + base-table versions, the
        # same soundness rule as the fused pipeline's materialized-dim
        # cache. q20-class queries re-execute a multi-join subquery on
        # every statement execution without this.
        from ..copr.pipeline import (_plan_fp, _plan_base_tables,
                                     _VOLATILE_RE)
        ck = None
        txn = self._txn
        dirty = txn is not None and not txn.committed \
            and not txn.aborted and txn.is_dirty()
        if not dirty:
            fp = _plan_fp(plan)
            if fp is not None and not _VOLATILE_RE.search(fp):
                base = _plan_base_tables(self.domain.copr.engine, plan)
                if base:
                    vers = tuple((t.uid, t.version) for t in base)
                    maxts = max(t.max_commit_ts for t in base)
                    try:
                        tz = (str(self.vars.get("time_zone")),
                              str(self.vars.get("sql_mode")))
                    except Exception:       # noqa: BLE001
                        tz = ()
                    ck = ("subq", fp, bool(limit_one), tz)
                    cache = getattr(self.domain, "_subq_cache", None)
                    if cache is None:
                        from collections import OrderedDict
                        cache = self.domain._subq_cache = OrderedDict()
                    ent = cache.get(ck)
                    if ent is not None:
                        evers, ets, cached = ent
                        # current snapshot must ALSO see every row the
                        # cached result saw (a txn that started before
                        # those commits must re-execute)
                        rts = ExecContext(self).read_ts()
                        if evers == vers and maxts <= ets and \
                                (rts is None or maxts <= rts):
                            cache.move_to_end(ck)
                            return cached
        ectx = ExecContext(self)
        ex = build_executor(ectx, plan)
        ex.open()
        try:
            chunks = ex.all_chunks()
        finally:
            ex.close()
            ectx.finish()
        rows = []
        fts = [sc.col.ft for sc in plan.schema.visible()]
        vis = [i for i, sc in enumerate(plan.schema.cols) if not sc.hidden]
        done = False
        for ch in chunks:
            for i in range(len(ch)):
                rows.append(tuple(ch.columns[j].get_datum(i) for j in vis))
                if limit_one and rows:
                    done = True
                    break
            if done:
                break
        if ck is not None and len(rows) <= 2_000_000:
            # ets = the snapshot the result was computed at (a stale
            # reader must not poison the cache for fresh readers); the
            # budget is byte-estimated like the matdim cache
            ets = ectx.read_ts()
            if ets is None:
                ets = self.domain.storage.current_ts()
            nb = 64 * (1 + len(rows)) * max(1, len(fts))
            cache[ck] = (vers, ets, (rows, fts))
            total = getattr(self.domain, "_subq_cache_bytes", 0) + nb
            self.domain._subq_cache_bytes = total
            while (total > (1 << 28) or len(cache) > 64) and \
                    len(cache) > 1:
                _k, (_v, _t, (orows, ofts)) = cache.popitem(last=False)
                total -= 64 * (1 + len(orows)) * max(1, len(ofts))
                self.domain._subq_cache_bytes = total
        return rows, fts

    # ---- dispatch -------------------------------------------------------
    def _dispatch(self, stmt, params=None) -> ResultSet:
        if isinstance(stmt, ast.SelectStmt):
            return self._exec_select(stmt, params, sql_key=self._cur_sql)
        if isinstance(stmt, (ast.InsertStmt, ast.UpdateStmt, ast.DeleteStmt)):
            return self._exec_dml(stmt, params)
        if isinstance(stmt, ast.ExplainStmt):
            return self._exec_explain(stmt)
        if isinstance(stmt, ast.AdminStmt):
            if stmt.kind == "checkpoint":
                ts = self.domain.checkpoint()
                return ResultSet(affected=ts)
            if stmt.kind == "check_table":
                from ..executor.admin import check_table
                total = 0
                for tn in stmt.tables:
                    db = tn.db or self.vars.current_db
                    tbl = self.domain.infoschema().table_by_name(db, tn.name)
                    total += check_table(self, tbl, db)
                return ResultSet(affected=total)
            if stmt.kind == "show_ddl":
                from .show import _str_chunk
                from .ddl import schema_state_name
                rows = []
                for j in self.domain.ddl_jobs.list_jobs():
                    rows.append((
                        j.id, j.db_name, j.table_name, j.type,
                        schema_state_name(j.schema_state), j.table_id,
                        j.row_done, j.row_total,
                        j.checkpoint_handle,
                        time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(
                            j.start_wall)) if j.start_wall else None,
                        j.state, j.error or None))
                return _str_chunk(
                    ["JOB_ID", "DB_NAME", "TABLE_NAME", "JOB_TYPE",
                     "SCHEMA_STATE", "TABLE_ID", "ROW_COUNT",
                     "TOTAL_ROWS", "CHECKPOINT_HANDLE", "START_TIME",
                     "STATE", "ERROR"], rows)
            if stmt.kind == "cancel_ddl":
                from .show import _str_chunk
                self.check_priv("super")
                result = self.domain.ddl_jobs.cancel(stmt.job_id)
                return _str_chunk(["JOB_ID", "RESULT"],
                                  [(str(stmt.job_id), result)])
            return ResultSet()
        if isinstance(stmt, ast.ChangefeedStmt):
            return self._exec_changefeed(stmt)
        if isinstance(stmt, ast.TraceStmt):
            # span-style trace (reference executor/trace.go): run the
            # wrapped statement under this forced-sampled trace and
            # render the cross-worker span tree from the live buffer
            return self._exec_trace(stmt)
        if isinstance(stmt, ast.HandlerStmt):
            from ..executor.handler_stmt import exec_handler
            return exec_handler(self, stmt)
        if isinstance(stmt, ast.UseStmt):
            self.domain.infoschema().schema_by_name(stmt.db)
            self.vars.current_db = stmt.db
            return ResultSet()
        if isinstance(stmt, ast.SetStmt):
            return self._exec_set(stmt)
        if isinstance(stmt, ast.ChecksumTableStmt):
            import zlib
            from .show import _str_chunk
            rows = []
            for tn in stmt.tables:
                db = tn.db or self.vars.current_db
                tbl = self.domain.infoschema().table_by_name(db, tn.name)
                rs = self._exec_select(self._parse_one_cached(
                    f"select * from `{db}`.`{tn.name}`"), None)
                crc = 0
                for row in rs.rows:
                    crc = zlib.crc32(repr(row).encode(), crc)
                rows.append((f"{db}.{tn.name}", crc))
            return _str_chunk(["Table", "Checksum"], rows)
        if isinstance(stmt, ast.HelpStmt):
            from .show import _str_chunk
            return _str_chunk(["name", "description", "example"], [])
        if isinstance(stmt, ast.PlanReplayerStmt):
            from .show import _str_chunk
            path = self._plan_replayer_dump(stmt)
            return _str_chunk(["File_token"], [(path,)])
        if isinstance(stmt, ast.RecommendIndexStmt):
            from ..planner.advisor import recommend_indexes
            rows = recommend_indexes(self, stmt.sql or None)
            from .show import _str_chunk
            return _str_chunk(
                ["Database", "Table", "Index_name", "Index_columns",
                 "Reason", "Score"], rows)
        if isinstance(stmt, ast.LockTablesStmt):
            return self._exec_lock_tables(stmt)
        if isinstance(stmt, ast.UnlockTablesStmt):
            self._release_table_locks()
            return ResultSet()
        if isinstance(stmt, ast.MaintainTableStmt):
            from .show import _str_chunk
            rows = []
            for tn in stmt.tables:
                db = tn.db or self.vars.current_db
                tbl = self.domain.infoschema().table_by_name(db, tn.name)
                name = f"{db}.{tbl.name}"
                if stmt.kind == "check":
                    from ..executor.admin import check_table, \
                        AdminCheckError
                    try:
                        check_table(self, tbl, db)
                        rows.append((name, "check", "status", "OK"))
                    except AdminCheckError as e:
                        rows.append((name, "check", "error", str(e)))
                elif stmt.kind == "optimize":
                    # embedded engine: GC closed versions — the
                    # closest analog of OPTIMIZE's space reclaim
                    self.domain.run_gc()
                    rows.append((name, "optimize", "status", "OK"))
                else:          # repair: WAL-first engine, nothing to do
                    rows.append((name, "repair", "status", "OK"))
            return _str_chunk(["Table", "Op", "Msg_type", "Msg_text"],
                              rows)
        if isinstance(stmt, ast.RenameUserStmt):
            self.check_priv("create_user")
            self.domain.priv.rename_user(
                [((f.user, f.host), (t.user, t.host))
                 for f, t in stmt.pairs])
            return ResultSet()
        if isinstance(stmt, ast.AlterDatabaseStmt):
            self.check_priv("alter", stmt.name or self.vars.current_db)
            name = stmt.name or self.vars.current_db
            self.commit()
            txn = self.domain.storage.begin()
            try:
                from ..meta import Mutator
                m = Mutator(txn)
                db = next((d for d in m.list_databases()
                           if d.name.lower() == name.lower()), None)
                if db is None:
                    from ..errors import DatabaseNotExistsError
                    raise DatabaseNotExistsError(
                        "Unknown database '%s'", name)
                if "charset" in stmt.options:
                    db.charset = stmt.options["charset"]
                if "collate" in stmt.options:
                    db.collate = stmt.options["collate"]
                m.update_database(db)
                m.gen_schema_version()
                txn.commit()
            except BaseException:
                txn.rollback()
                raise
            return ResultSet()
        if isinstance(stmt, ast.PlacementPolicyStmt):
            self.check_priv("super")
            self.commit()
            self.ddl.placement_policy(stmt)
            return ResultSet()
        if isinstance(stmt, ast.ResourceGroupStmt):
            mgr = self.domain.resource_groups
            if stmt.action == "create":
                self.check_priv("super")
                mgr.create(stmt)
            elif stmt.action == "alter":
                self.check_priv("super")
                mgr.alter(stmt)
            else:
                self.check_priv("super")
                mgr.drop(stmt)
            return ResultSet()
        if isinstance(stmt, ast.SetResourceGroupStmt):
            self.domain.resource_groups.get(stmt.name)   # must exist
            self.resource_group = stmt.name
            return ResultSet()
        if isinstance(stmt, ast.CreateRoleStmt):
            self.check_priv("create_user")
            for sp in stmt.roles:
                self.domain.priv.create_role(sp.user, sp.host,
                                             stmt.if_not_exists)
            return ResultSet()
        if isinstance(stmt, ast.DropRoleStmt):
            self.check_priv("create_user")
            for sp in stmt.roles:
                self.domain.priv.drop_role(sp.user, sp.host,
                                           stmt.if_exists)
            return ResultSet()
        if isinstance(stmt, ast.GrantRoleStmt):
            self.check_priv("grant")
            roles = [(sp.user, sp.host) for sp in stmt.roles]
            users = [(sp.user, sp.host) for sp in stmt.users]
            if stmt.is_revoke:
                self.domain.priv.revoke_role(roles, users)
            else:
                self.domain.priv.grant_role(roles, users)
            return ResultSet()
        if isinstance(stmt, ast.SetRoleStmt):
            priv = self.domain.priv
            if stmt.mode == "all":
                self.active_roles = priv.roles_of(self.user, self.host)
            elif stmt.mode == "none":
                self.active_roles = []
            elif stmt.mode == "default":
                self.active_roles = priv.default_roles_of(self.user,
                                                          self.host)
            else:
                granted = set(priv.roles_of(self.user, self.host))
                want = []
                for sp in stmt.roles:
                    k = (sp.user.lower(), sp.host)
                    if k not in granted:
                        raise TiDBError(
                            "Role '%s'@'%s' has not been granted to %s",
                            sp.user, sp.host, self.user)
                    want.append(k)
                self.active_roles = want
            return ResultSet()
        if isinstance(stmt, ast.SetDefaultRoleStmt):
            self.domain.priv.set_default_roles(
                stmt.mode, [(sp.user, sp.host) for sp in stmt.roles],
                [(sp.user, sp.host) for sp in stmt.users])
            return ResultSet()
        if isinstance(stmt, ast.CreateBindingStmt):
            h = self.domain.bind_handle if stmt.is_global \
                else self.session_binds
            h.create(stmt.for_sql, stmt.using_sql, stmt.hints)
            return ResultSet()
        if isinstance(stmt, ast.DropBindingStmt):
            h = self.domain.bind_handle if stmt.is_global \
                else self.session_binds
            h.drop(stmt.for_sql)
            return ResultSet()
        if isinstance(stmt, ast.ShowStmt):
            from .show import exec_show
            return exec_show(self, stmt)
        if isinstance(stmt, ast.DescTableStmt):
            from .show import exec_desc
            return exec_desc(self, stmt.table)
        if isinstance(stmt, ast.BeginStmt):
            self.commit()
            self._explicit_txn = True
            self.txn()
            return ResultSet()
        if isinstance(stmt, ast.CommitStmt):
            txn = self._txn
            if txn is not None and not txn.committed and \
                    not txn.aborted:
                # COMMIT is a statement: its lock waits get their own
                # fresh deadline (max_execution_time from NOW) and a
                # registered ExecContext so KILL reaches a commit
                # blocked on a foreign lock
                ectx = ExecContext(self)
                self._stmt_lock_guard(txn, ectx)
                self.domain.register_exec(self.conn_id, ectx)
                try:
                    self.commit()
                finally:
                    self.domain.unregister_exec(self.conn_id, ectx)
                    ectx.finish()
            else:
                self.commit()
            return ResultSet()
        if isinstance(stmt, ast.RollbackStmt):
            if stmt.to_savepoint:
                txn = self._txn
                if txn is None or not txn.rollback_to_savepoint(
                        stmt.to_savepoint):
                    raise TiDBError("SAVEPOINT %s does not exist",
                                    stmt.to_savepoint)
                return ResultSet()
            self.rollback()
            return ResultSet()
        if isinstance(stmt, ast.SavepointStmt):
            txn = self.txn()
            if stmt.release:
                if not txn.release_savepoint(stmt.name):
                    raise TiDBError("SAVEPOINT %s does not exist", stmt.name)
            else:
                txn.savepoint(stmt.name)
            return ResultSet()
        if isinstance(stmt, ast.AnalyzeTableStmt):
            from ..stats.analyze import analyze_tables
            analyze_tables(self, stmt.tables)
            return ResultSet()
        if isinstance(stmt, ast.ImportStmt):
            from ..executor.importer import exec_import
            return exec_import(self, stmt)
        if isinstance(stmt, ast.SignalStmt):
            # reference pkg/parser signal grammar; standalone RESIGNAL
            # has no active handler -> 1645; SIGNAL raises the
            # user-defined condition (1644 unless MYSQL_ERRNO given)
            if stmt.is_resignal:
                e = TiDBError("RESIGNAL when handler not active")
                e.code = 1645
                e.sqlstate = "0K000"
                raise e
            msg = stmt.items.get(
                "message_text",
                "Unhandled user-defined exception condition")
            e = TiDBError("%s", str(msg))
            e.code = int(stmt.items.get("mysql_errno", 1644))
            e.sqlstate = stmt.sqlstate
            raise e
        if isinstance(stmt, ast.GetDiagnosticsStmt):
            warns = list(self.vars.warnings)
            if stmt.condition is not None:
                from ..planner.rewriter import Rewriter
                from ..planner.schema import Schema
                ce = Rewriter(self._plan_ctx(), Schema()).rewrite(
                    stmt.condition)
                from ..expression import EvalCtx as _ECtx, \
                    eval_expr as _eval
                import numpy as _np
                cv, _n, _s = _eval(_ECtx(_np, 1, {}, host=True), ce)
                ci = int(cv if _np.isscalar(cv) else _np.asarray(cv)[0])
                if ci < 1 or ci > len(warns):
                    raise TiDBError("Invalid condition number")
                w = warns[ci - 1]
                for var, what in stmt.items:
                    val = {"message_text": w.get("msg", ""),
                           "mysql_errno": w.get("code", 0),
                           "returned_sqlstate":
                               w.get("sqlstate", "HY000"),
                           "class_origin": "ISO 9075",
                           "condition_number": ci}.get(what)
                    if val is None:
                        raise UnsupportedError(
                            "unknown diagnostics item %s", what)
                    self.domain.user_vars[var] = val
            else:
                for var, what in stmt.items:
                    val = {"number": len(warns),
                           "row_count": self.vars.last_affected}.get(
                               what)
                    if val is None:
                        raise UnsupportedError(
                            "unknown diagnostics item %s", what)
                    self.domain.user_vars[var] = val
            return ResultSet()
        if isinstance(stmt, ast.DoStmt):
            from ..planner.rewriter import Rewriter
            from ..planner.schema import Schema
            pctx = self._plan_ctx()
            for e in stmt.exprs:
                Rewriter(pctx, Schema()).rewrite(e)   # evaluate, discard
            return ResultSet()
        if isinstance(stmt, ast.FlushStmt):
            if stmt.what == "privileges":
                pass      # privilege cache is always live
            return ResultSet()
        if isinstance(stmt, ast.AlterUserStmt):
            self.check_priv("create_user")
            for u in stmt.users:
                k = (u.user.lower(), u.host)
                info = self.domain.priv.users.get(k) or \
                    self.domain.priv.users.get((u.user.lower(), "%"))
                if info is None:
                    raise TiDBError("Unknown user '%s'", u.user)
                info["password"] = u.password
            return ResultSet()
        if isinstance(stmt, ast.KillStmt):
            self.check_priv("super")
            self.domain.kill_conn(stmt.conn_id)
            return ResultSet()
        if isinstance(stmt, ast.PrepareStmt):
            inner = parse(stmt.sql_text)
            if len(inner) != 1:
                raise UnsupportedError("PREPARE expects one statement")
            self.prepared[stmt.name.lower()] = (inner[0], stmt.sql_text)
            return ResultSet()
        if isinstance(stmt, ast.ExecuteStmt):
            entry = self.prepared.get(stmt.name.lower())
            if entry is None:
                raise UnsupportedError("Unknown prepared statement handler %s",
                                       stmt.name)
            inner, text = entry
            exec_params = [self.domain.user_vars.get(v.lower())
                           for v in stmt.using]
            # parameterized plan-cache fast path on the prepared TEXT
            # (nested: the EXECUTE statement itself is already being
            # observed/admitted by the enclosing lifecycle)
            rs = _fastpath.try_execute(self, text, exec_params or None,
                                       nested=True)
            if rs is not None:
                return rs
            # the EXECUTE wrapper classified "oltp" at dispatch — the
            # admission decision belongs to the INNER statement, or a
            # prepared analytic loop bypasses the OLAP queue entirely
            adm_rg = self._maybe_admit_olap(inner, at_depth=1)
            try:
                return self._dispatch(inner, exec_params or None)
            finally:
                if adm_rg is not None:
                    adm_rg.release_olap()
        if isinstance(stmt, ast.DeallocateStmt):
            self.prepared.pop(stmt.name.lower(), None)
            return ResultSet()
        if isinstance(stmt, ast.CreateUserStmt):
            self.check_priv("create_user")
            for u in stmt.users:
                self.domain.priv.create_user(u.user, u.host, u.password,
                                             stmt.if_not_exists)
            return ResultSet()
        if isinstance(stmt, ast.DropUserStmt):
            self.check_priv("create_user")
            for u in stmt.users:
                self.domain.priv.drop_user(u.user, u.host, stmt.if_exists)
            return ResultSet()
        if isinstance(stmt, ast.GrantStmt):
            self.check_priv("grant")
            db = stmt.db or (self.vars.current_db if stmt.table else "")
            for u in stmt.users:
                if stmt.is_revoke:
                    self.domain.priv.revoke(stmt.privs, db, stmt.table,
                                            u.user, u.host)
                else:
                    self.domain.priv.grant(stmt.privs, db, stmt.table,
                                           u.user, u.host)
            return ResultSet()
        if isinstance(stmt, ast.BRStmt):
            self.commit()
            if stmt.kind == "backup_log":
                # legacy one-shot WAL copy (wallclock PITR); the
                # continuous log backup is the logbackup:// changefeed
                # sink (tidb_tpu/br)
                from ..tools import br as legacy_br
                n = legacy_br.backup_log(self.domain, stmt.path)
            elif stmt.kind == "backup":
                from .. import br
                n = br.run_backup(self.domain, stmt.db, stmt.path)
            elif stmt.until:
                from ..tools import br as legacy_br
                from ..types.time_types import parse_datetime
                n = legacy_br.restore_pitr(
                    self.domain, stmt.path,
                    parse_datetime(stmt.until) / 1e6)
            else:
                from .. import br
                n = br.submit_restore(self.domain, stmt.db, stmt.path,
                                      until_ts=stmt.until_ts or None)
            return ResultSet(affected=n)
        # DDL: implicit commit first (MySQL semantics)
        ddl_map = {
            ast.CreateDatabaseStmt: self.ddl.create_database,
            ast.DropDatabaseStmt: self.ddl.drop_database,
            ast.CreateTableStmt: self.ddl.create_table,
            ast.CreateViewStmt: self.ddl.create_view,
            ast.CreateSequenceStmt: self.ddl.create_sequence,
            ast.DropSequenceStmt: self.ddl.drop_sequence,
            ast.DropTableStmt: self.ddl.drop_table,
            ast.TruncateTableStmt: self.ddl.truncate_table,
            ast.RenameTableStmt: self.ddl.rename_table,
            ast.CreateIndexStmt: self.ddl.create_index,
            ast.DropIndexStmt: self.ddl.drop_index,
            ast.AlterTableStmt: self.ddl.alter_table,
            ast.CreateModelStmt: self.ddl.create_model,
            ast.DropModelStmt: self.ddl.drop_model,
        }
        fn = ddl_map.get(type(stmt))
        if fn is not None:
            self._check_ddl_priv(stmt)
            if self.domain.table_locks:
                # DDL respects table locks too (the reference's table
                # locks live IN pkg/ddl)
                self._check_table_locks(
                    [(db, tbl) for _p, db, tbl in
                     self._ddl_targets(stmt) if tbl], write=True)
            self.commit()
            fn(stmt)
            if self.domain.table_locks and isinstance(
                    stmt, (ast.DropTableStmt, ast.RenameTableStmt)):
                # purge registry entries for names that no longer exist
                gone = stmt.tables if isinstance(
                    stmt, ast.DropTableStmt) else \
                    [old for old, _new in stmt.pairs]
                with self.domain.table_locks_mu:
                    for tn in gone:
                        self.domain.table_locks.pop(
                            ((tn.db or self.vars.current_db).lower(),
                             tn.name.lower()), None)
            return ResultSet()
        raise UnsupportedError("statement %s not supported",
                               type(stmt).__name__)

    def _exec_changefeed(self, stmt) -> ResultSet:
        """ADMIN CHANGEFEED ... (tidb_tpu/cdc lifecycle; SUPER-class
        surface like the reference's cdc cli, so gate on a admin-ish
        privilege)."""
        from .show import _str_chunk
        self.check_priv("super")
        mgr = self.domain.cdc
        if stmt.action == "create":
            feed = mgr.create(stmt.name, stmt.sink_uri,
                              start_ts=stmt.start_ts)
            feeds = [feed]
        elif stmt.action == "pause":
            mgr.pause(stmt.name)
            feeds = [mgr.get(stmt.name)]
        elif stmt.action == "resume":
            mgr.resume(stmt.name)
            feeds = [mgr.get(stmt.name)]
        elif stmt.action == "remove":
            mgr.remove(stmt.name)
            feeds = []
        else:                       # list
            feeds = sorted(mgr.feeds.values(), key=lambda f: f.name)
        rows = [(f.name, f.state, f.sink_uri, f.start_ts,
                 f.checkpoint_ts, f.resolved, f.error or None)
                for f in feeds if f.state != "removed"]
        return _str_chunk(["Changefeed", "State", "Sink", "Start_ts",
                           "Checkpoint_ts", "Resolved_ts", "Error"],
                          rows)

    def _check_ddl_priv(self, stmt):
        """DDL privilege gate (reference pkg/planner/core/planbuilder.go
        visitInfo for DDL)."""
        for priv, db, tbl in self._ddl_targets(stmt):
            self.check_priv(priv, db, tbl)

    def _ddl_targets(self, stmt):
        """(priv, db, table) triples a DDL statement touches — shared
        by the privilege gate and the table-lock check."""
        def tn_target(tn):
            return ((tn.db or self.vars.current_db), tn.name)

        targets = []     # (priv, db, tbl)
        if isinstance(stmt, ast.CreateDatabaseStmt):
            targets.append(("create", stmt.name, ""))
        elif isinstance(stmt, ast.DropDatabaseStmt):
            targets.append(("drop", stmt.name, ""))
        elif isinstance(stmt, ast.CreateTableStmt):
            targets.append(("create", *tn_target(stmt.table)))
        elif isinstance(stmt, ast.CreateViewStmt):
            targets.append(("create", *tn_target(stmt.view)))
        elif isinstance(stmt, (ast.CreateSequenceStmt,
                               ast.DropSequenceStmt)):
            priv = "create" if isinstance(stmt, ast.CreateSequenceStmt) \
                else "drop"
            targets.append((priv, *tn_target(stmt.name)))
        elif isinstance(stmt, ast.DropTableStmt):
            for tn in stmt.tables:
                targets.append(("drop", *tn_target(tn)))
        elif isinstance(stmt, ast.TruncateTableStmt):
            targets.append(("drop", *tn_target(stmt.table)))
        elif isinstance(stmt, ast.RenameTableStmt):
            for old, new in stmt.pairs:
                targets.append(("alter", *tn_target(old)))
                targets.append(("create", *tn_target(new)))
        elif isinstance(stmt, (ast.CreateIndexStmt, ast.DropIndexStmt)):
            targets.append(("index", *tn_target(stmt.table)))
        elif isinstance(stmt, ast.AlterTableStmt):
            targets.append(("alter", *tn_target(stmt.table)))
        elif isinstance(stmt, (ast.CreateModelStmt, ast.DropModelStmt)):
            # models are cluster-scoped schema objects; gate on the
            # session's current db like other non-table DDL
            priv = "create" if isinstance(stmt, ast.CreateModelStmt) \
                else "drop"
            targets.append((priv, self.vars.current_db or "test",
                            stmt.name))
        return targets

    def _plan_replayer_dump(self, stmt):
        """PLAN REPLAYER DUMP EXPLAIN <sql> (reference
        pkg/domain/plan_replayer.go): zip of schema DDL, table stats,
        sysvars, the statement, and its plan — everything needed to
        reproduce the plan elsewhere."""
        import io
        import json
        import os
        import time as _time
        import zipfile
        pctx = self._plan_ctx(None)
        plan = optimize(stmt.stmt, pctx)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("sql/sql.sql", stmt.sql)
            z.writestr("explain.txt", "\n".join(
                "\t".join(map(str, row)) for row in explain_text(plan)))
            ddls, stats = [], {}
            for db, tname in sorted(getattr(plan, "read_tables", ())):
                try:
                    rs = self._dispatch(ast.ShowStmt(
                        kind="create_table",
                        table=ast.TableName(name=tname, db=db)), None)
                    ddls.append(rs.rows[0][1] + ";")
                except Exception:       # noqa: BLE001
                    continue
                tbl = self.domain.infoschema().table_by_name(db, tname)
                ts = self.domain.stats.get(tbl.id)
                if ts is not None:
                    stats[f"{db}.{tname}"] = {
                        "row_count": ts.row_count,
                        "columns": {n: {"ndv": cs.ndv,
                                        "nulls": cs.null_count,
                                        "topn": dict(list(
                                            cs.topn.items())[:5])}
                                    for n, cs in ts.columns.items()}}
            z.writestr("schema/schema.sql", "\n".join(ddls))
            z.writestr("stats/stats.json", json.dumps(stats, default=str))
            z.writestr("variables.json", json.dumps({
                v: str(self.vars.get(v)) for v in
                ("tidb_enable_mpp", "tidb_mpp_min_rows",
                 "tidb_join_exec", "max_execution_time")}))
        import tempfile
        out_dir = os.path.join(tempfile.gettempdir(), "plan_replayer")
        os.makedirs(out_dir, exist_ok=True)
        token = f"replayer_{int(_time.time() * 1000)}.zip"
        path = os.path.join(out_dir, token)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return path

    def _parse_one_cached(self, sql):
        from ..parser import parse
        stmts = self.domain.ast_cache.get(sql)
        if stmts is None:
            stmts = parse(sql)
            self.domain.ast_cache.put(sql, stmts)
        return stmts[0]

    def _plan_cache_key(self, sql_key):
        # any session var that changes plan SHAPE or semantics must key
        # the cache (VERDICT r1: stale plans served across var changes)
        return (sql_key, self.vars.current_db,
                self.domain.infoschema().version, self.vars.tpu_exec,
                self.domain.bind_handle.version, self.session_binds.version,
                bool(self.vars.get("tidb_enable_mpp")),
                str(self.vars.get("div_precision_increment")),
                str(self.vars.get("tidb_join_exec")),
                bool(self.vars.get("tidb_enable_cascades_planner")))

    def _apply_binding(self, stmt, sql_text):
        """Session-then-global binding match by normalized digest
        (reference pkg/bindinfo matching); on hit the binding's hint set
        replaces the statement's own."""
        if not sql_text or (not len(self.session_binds) and
                            not len(self.domain.bind_handle)):
            return
        from ..parser.digester import normalize_digest
        _, digest = normalize_digest(sql_text)
        rec = self.session_binds.match(digest) or \
            self.domain.bind_handle.match(digest)
        if rec is not None:
            stmt.hints = list(rec.hints)
            stmt._hints_from_binding = True
            self.vars.set("last_plan_from_binding", 1)
            self.domain.inc_metric("plan_from_binding")
        elif getattr(stmt, "_hints_from_binding", False):
            # cached AST carries hints from a since-dropped binding
            stmt.hints = []
            stmt._hints_from_binding = False
            self.vars.set("last_plan_from_binding", 0)
        elif getattr(stmt, "from_clause", True) is not None:
            # table-less probes (`select @@last_plan_from_binding`) keep
            # the previous statement's flag
            self.vars.set("last_plan_from_binding", 0)

    def _write_outfile(self, path, names, chunks):
        import csv as _csv
        with open(path, "w", newline="") as f:
            w = _csv.writer(f, delimiter="\t")
            for ch in chunks:
                for i in range(len(ch)):
                    w.writerow(["\\N" if v is None else v
                                for v in ch.row_py(i)])

    def _exec_select(self, stmt, params=None, sql_key=None) -> ResultSet:
        """sql_key: full statement text for the instance plan cache
        (reference plan_cache.go:205 — here keyed by exact text since
        constants fold into the plan)."""
        plan = None
        ck = None
        dom = self.domain
        self._apply_binding(stmt, sql_key or self._cur_sql)
        from ..utils import metrics as metrics_util
        if sql_key and params is None:
            ck = self._plan_cache_key(sql_key)
            plan = dom.plan_cache.get(ck)
            if plan is not None:
                # labeled registry is the primary instrument; inc_metric
                # keeps the flat counter AND its /metrics compat mirror
                # counting for existing readers
                dom.inc_metric("plan_cache_hit")
                metrics_util.PLAN_CACHE.labels("hit").inc()
                for rdb, rtbl in getattr(plan, "read_tables", ()):
                    self._check_read(rdb, rtbl)
        if plan is None:
            pctx = self._plan_ctx(params)
            with dom.tracer.span("plan", conn_id=self.conn_id):
                plan = optimize(stmt, pctx)
            if ck is not None and pctx.cacheable:
                dom.plan_cache.put(ck, plan)   # O(1) LRU eviction
                metrics_util.PLAN_CACHE.labels("miss").inc()
            elif ck is not None:
                metrics_util.PLAN_CACHE.labels("uncacheable").inc()
        if dom.table_locks:
            # before register_exec: a raise here must not leak an
            # ExecContext into _live_execs
            self._check_table_locks(
                list(getattr(plan, "read_tables", ())), write=False)
        ectx = ExecContext(self, getattr(plan, "exec_hints", None))
        # per-operator runtime stats on every select (reference
        # tidb_enable_collect_execution_info): the TimedExec tree feeds
        # the statement-end plan-feedback fold. Point gets bypass
        # _exec_select via the fast path, so OLTP stays unwrapped.
        ectx.collect_stats = bool(
            self.vars.get("tidb_enable_collect_execution_info"))
        ectx.stale_read_ts = getattr(plan, "stale_read_ts", 0)
        if not ectx.stale_read_ts:
            pin = getattr(self, "pinned_read_ts", 0)
            if pin:
                # replica-domain session: every read is pinned at the
                # replica's applied watermark (set by execute_pinned;
                # checked BEFORE _maybe_resolved_read so an env-seeded
                # resolved mode on the mirror cannot override the pin)
                ectx.stale_read_ts = pin
                ectx.analytic_resolved = True
            else:
                # incremental HTAP read routing: analytic statements
                # under tidb_tpu_analytic_read_mode='resolved' snapshot
                # at the resolved-ts floor (AS OF keeps its own ts) —
                # and, when the replica fabric has a qualifying
                # replica, execute on it instead of the leader
                self._maybe_resolved_read(stmt, plan, ectx)
                if getattr(ectx, "replica_eligible", False):
                    rs = self._try_replica_read(stmt, plan, ectx,
                                                params=params)
                    if rs is not None:
                        return rs
        if self._txn is not None and not self._txn.committed and \
                not self._txn.aborted:
            # snapshot reads through the open txn that trip on a
            # foreign lock wait under THIS statement's clock and KILL
            self._stmt_lock_guard(self._txn, ectx)
        self.domain.register_exec(self.conn_id, ectx)
        ex = build_executor(ectx, plan)
        with dom.tracer.span("execute", conn_id=self.conn_id):
            ex.open()
            try:
                chunks = ex.all_chunks()
            finally:
                ex.close()
                self.domain.unregister_exec(self.conn_id, ectx)
                ectx.finish()
        if ectx.collect_stats:
            from ..utils import phase as _phase
            if _phase.depth() == 1:
                # stash est-vs-actual per operator for _observe's
                # plan-feedback fold (outermost statements only — a
                # nested internal select must not overwrite the user
                # statement's feedback with its own)
                from ..executor import plan_feedback as _pf
                try:
                    self._stmt_feedback = _pf.collect(plan, ex)
                except Exception:       # noqa: BLE001 — never fail a query
                    self._stmt_feedback = None
        if getattr(plan, "for_update", False) and self._explicit_txn:
            chunks = self._lock_for_update(plan, chunks, ectx)
        vis = [i for i, sc in enumerate(plan.schema.cols) if not sc.hidden]
        names = [plan.schema.cols[i].name for i in vis]
        out_chunks = []
        from ..chunk.chunk import Chunk
        for ch in chunks:
            out_chunks.append(Chunk([ch.columns[i] for i in vis]))
        self._finish_stmt()
        if getattr(stmt, "into_vars", None):
            total = sum(len(c) for c in out_chunks)
            if total > 1:
                raise TiDBError(
                    "Result consisted of more than one row")   # 1172
            if len(stmt.into_vars) != len(names):
                raise TiDBError(
                    "The used SELECT statements have a different "
                    "number of columns")
            if total:
                ch = next(c for c in out_chunks if len(c))
                for i, v in enumerate(stmt.into_vars):
                    self.domain.user_vars[v] = \
                        ch.columns[i].get_datum(0).to_py()
            return ResultSet(affected=total)
        if getattr(stmt, "into_outfile", ""):
            import os as _os
            if _os.path.exists(stmt.into_outfile):
                raise TiDBError("File '%s' already exists",
                                stmt.into_outfile)
            self._write_outfile(stmt.into_outfile, names, out_chunks)
            total = sum(len(c) for c in out_chunks)
            return ResultSet(affected=total)
        return ResultSet(names=names, chunks=out_chunks)

    def _maybe_resolved_read(self, stmt, plan, ectx):
        """Resolved-ts analytic read view (docs/PERFORMANCE.md
        "Incremental HTAP"; the TiFlash learner/stale-read shape):
        when the session opted into tidb_tpu_analytic_read_mode =
        'resolved', an olap-classified SELECT snapshots at the exact
        ``storage/mvcc.resolved_floor`` watermark — every commit
        at/below it has reached the columnar hooks and nothing can
        commit at/below it later, so the MVCC validity mask built at
        that ts is a consistent committed-data view that never waits
        on OLTP write locks. The statement also skips the session's
        dirty-overlay rescan (executors honor ``analytic_resolved``):
        resolved mode is an explicit staleness opt-in and does NOT
        read the transaction's own uncommitted writes. FOR UPDATE
        stays strict; a floor older than
        tidb_tpu_analytic_max_staleness_ms falls back to the leader
        path rather than serve unboundedly stale rows."""
        if self.is_internal:
            return
        if self.vars.get("tidb_tpu_analytic_read_mode") != "resolved":
            return
        if _stmt_class(stmt) != "olap":
            return
        from ..utils import metrics as metrics_util
        if getattr(plan, "for_update", False):
            metrics_util.ANALYTIC_READS.labels("strict").inc()
            return
        delta = self.domain.copr.delta
        floor = delta.resolved_ts()
        txn = self._txn if (self._explicit_txn and self._txn is not None
                            and not self._txn.committed
                            and not self._txn.aborted) else None
        clamped = txn is not None and txn.start_ts < floor
        if clamped:
            # REPEATABLE READ: inside an explicit transaction the view
            # must never be FRESHER than the txn snapshot — a floor
            # past start_ts would let two statements of one txn see
            # different committed states. Clamping keeps the resolved
            # contract's one difference (own uncommitted writes stay
            # invisible: the dirty-overlay rescan is still skipped)
            # while reads stay at the txn's own snapshot.
            floor = txn.start_ts
        lag_ms = delta.lag_ms(floor)
        metrics_util.REPLICA_LAG_SECONDS.set(lag_ms / 1000.0)
        if not clamped:
            # the bound guards against serving arbitrarily OLD data;
            # a clamped read is the txn's own snapshot — the leader
            # path would read at the same ts, so falling back there
            # gains nothing
            bound = int(self.vars.get(
                "tidb_tpu_analytic_max_staleness_ms"))
            if bound and lag_ms > bound:
                metrics_util.ANALYTIC_READS.labels(
                    "staleness_fallback").inc()
                return
        ectx.stale_read_ts = floor
        ectx.analytic_resolved = True
        # a clamped read is the explicit txn's own snapshot — replica
        # routing would break read-your-writes/REPEATABLE READ, so only
        # unclamped resolved reads are replica-eligible
        ectx.replica_eligible = not clamped
        metrics_util.ANALYTIC_READS.labels("resolved").inc()

    def _try_replica_read(self, stmt, plan, ectx, params=None):
        """Route an olap resolved read to the freshest qualifying
        replica domain (docs/ROBUSTNESS.md "Read replica fabric").
        Returns the replica's ResultSet, or None to degrade to the
        leader — this path NEVER raises for fabric reasons:

          * no replica within tidb_tpu_replica_max_lag_ms (or none
            past the DDL barrier / the session's last commit) ->
            leader_fallback, run on the leader at the resolved floor
          * the chosen replica dies mid-statement (classified through
            device_guard, reported to supervision) -> degraded_midstmt,
            one transparent leader retry via the normal leader path
        """
        from ..utils import metrics as metrics_util
        from ..utils import phase as _phase
        rm = getattr(self.domain, "replicas", None)
        if rm is None or not rm.replicas:
            return None
        sql = self._cur_sql
        if not sql or params is not None or _phase.depth() != 1 or \
                getattr(stmt, "into_vars", None) or \
                getattr(stmt, "into_outfile", ""):
            return None         # leader handles the exotic shapes
        from ..cdc.capture import SYSTEM_DBS
        for rdb, _rtbl in getattr(plan, "read_tables", ()):
            if (rdb or "").lower() in SYSTEM_DBS or \
                    _rtbl in self.temp_tables:
                # system schemas are not replicated and a temp table
                # exists only in THIS session — leader serves both
                return None
        if self._reads_bulk_rows(plan):
            # bulk-loaded rows (IMPORT, RESTORE, bulk_append) write no
            # row KV, so no changefeed carries them: a mirror lacks them
            self.domain.inc_metric("replica_bulk_table_leader")
            return None
        try:
            max_lag = int(self.vars.get("tidb_tpu_replica_max_lag_ms"))
            picked = rm.pick(max_lag,
                             min_ts=getattr(self, "_last_commit_ts", 0))
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException:   # noqa: BLE001 — route-pick seam: degrade
            picked = None
        if picked is None:
            metrics_util.REPLICA_ROUTE.labels("leader_fallback").inc()
            self._stmt_route = "leader_fallback"
            return None
        rep, pin_ts = picked
        # served-read SLA audit, measured at route time (the moment the
        # pin is fixed): re-verify the bound pick saw, and keep the
        # worst served staleness for the chaos gate's SLA assert
        served_lag = 0.0
        wall = self.domain.storage.oracle.wall_for_ts(pin_ts)
        if wall is not None:
            import time as _time
            served_lag = max(0.0, (_time.time() - wall) * 1000.0)
        if max_lag > 0 and served_lag > max_lag:
            metrics_util.REPLICA_ROUTE.labels("leader_fallback").inc()
            self._stmt_route = "leader_fallback"
            return None
        try:
            rs = rep.execute_pinned(sql, self.vars.current_db)
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException as exc:   # noqa: BLE001 — degrade, never err
            rm.report_failure(rep, exc)
            metrics_util.REPLICA_ROUTE.labels("degraded_midstmt").inc()
            self._stmt_route = "degraded_midstmt"
            return None
        rep.routed_queries += 1
        metrics_util.REPLICA_ROUTE.labels("replica").inc()
        self._stmt_route = f"replica-{rep.rid}"
        ectx.stale_read_ts = pin_ts
        m = self.domain.metrics
        if served_lag > m.get("replica_served_max_lag_ms", 0.0):
            m["replica_served_max_lag_ms"] = served_lag
        ectx.finish()
        self._finish_stmt()
        return rs

    def _reads_bulk_rows(self, plan) -> bool:
        """True when a table the plan reads holds rows appended in bulk
        on the leader."""
        dom = self.domain
        isch = dom.infoschema()
        for rdb, rtbl in getattr(plan, "read_tables", ()):
            try:
                info = isch.table_by_name(rdb, rtbl)
            except Exception:           # noqa: BLE001 — view, dropped
                continue
            ctab = dom.columnar.tables.get(info.id)
            if ctab is not None and ctab.bulk_rows:
                return True
        return False

    def _exec_lock_tables(self, stmt):
        """LOCK TABLES (reference pkg/ddl table locks + the
        enable-table-lock config gate): when the gate is off the
        statement parses and no-ops, like the reference. Acquiring
        releases this session's previous set first (MySQL
        semantics); conflicts error immediately (no wait queue)."""
        if not bool(self.vars.get("tidb_enable_table_lock")):
            return ResultSet()
        dom = self.domain
        want = []
        for tn, mode in stmt.locks:
            db = tn.db or self.vars.current_db
            dom.infoschema().table_by_name(db, tn.name)  # must exist
            want.append(((db.lower(), tn.name.lower()), mode))
        with dom.table_locks_mu:
            self._release_table_locks_locked()
            for key, mode in want:
                held = dom.table_locks.get(key)
                if held is not None and held[1] != self.conn_id and \
                        ("write" in (mode, held[0])):
                    raise TiDBError(
                        "Table '%s' was locked in %s by connection %d",
                        key[1], held[0].upper(), held[1])
            for key, mode in want:
                dom.table_locks[key] = (mode, self.conn_id)
        return ResultSet()

    def _release_table_locks_locked(self):
        dom = self.domain
        for key in [k for k, v in dom.table_locks.items()
                    if v[1] == self.conn_id]:
            del dom.table_locks[key]

    def _release_table_locks(self):
        with self.domain.table_locks_mu:
            self._release_table_locks_locked()

    def _check_table_locks(self, targets, write):
        """Error when another connection's table lock forbids this
        access: WRITE locks block everything, READ locks block writes
        (reference ErrTableLocked 8020)."""
        dom = self.domain
        if not dom.table_locks:
            return
        with dom.table_locks_mu:
            for db, tname in targets:
                held = dom.table_locks.get(
                    ((db or self.vars.current_db).lower(),
                     tname.lower()))
                if held is None:
                    continue
                if held[1] == self.conn_id:
                    if write and held[0] == "read":
                        # MySQL 1099: own READ lock forbids writing
                        raise TiDBError(
                            "Table '%s' was locked with a READ lock "
                            "and can't be updated", tname)
                    continue
                if held[0] == "write" or write:
                    raise TiDBError(
                        "Table '%s' was locked in %s by connection %d",
                        tname, held[0].upper(), held[1])

    def _lock_for_update(self, plan, chunks, ectx=None):
        """SELECT ... FOR UPDATE: acquire pessimistic locks on the result
        rows' record keys. PointGet plans lock the computed handle; reader
        plans lock via the hidden _tidb_rowid column when present.
        Lock conflicts surface immediately (this engine has no lock
        WAIT queue, so plain FOR UPDATE already behaves like NOWAIT);
        SKIP LOCKED instead drops the conflicting rows from the
        result (reference executor point_get/lock with
        tidb_lock_wait_policy). Returns the (possibly filtered)
        chunks."""
        if ectx is not None:
            # FOR UPDATE lock waits get THIS statement's deadline and
            # KILL hook (the txn may have been created just now, or
            # carry a previous write statement's guard)
            self._stmt_lock_guard(self.txn(), ectx)
        from ..codec.tablecodec import record_key
        from ..planner.physical import PhysPointGet
        from ..executor.exec_base import expr_to_datum
        keys = []
        key_handles = []       # handle per key (PointGet path)

        def walk(p):
            if isinstance(p, PhysPointGet):
                if p.handle_expr is not None:
                    d = expr_to_datum(p.handle_expr)
                    if not d.is_null:
                        keys.append(record_key(p.table_info.id, int(d.val)))
                        key_handles.append(int(d.val))
                else:
                    # lock via the row just read (chunks carry it if found)
                    for ch in chunks:
                        pass
            for c in p.children:
                walk(c)
        walk(plan)
        tables = list(getattr(plan, "read_tables", ()))
        skip = getattr(plan, "lock_wait", "") == "skip locked"
        nowait = getattr(plan, "lock_wait", "") == "nowait"
        if keys and skip:
            return self._skip_locked_point(plan, chunks, keys,
                                           key_handles, tables)
        hidx = None
        if not keys and len(tables) == 1:
            db, tname = tables[0]
            tbl = self.domain.infoschema().table_by_name(db, tname)
            if tbl.id > 0 and not tbl.partitions:
                for i, sc in enumerate(plan.schema.cols):
                    if sc.name == "_tidb_rowid":
                        hidx = i
                if hidx is not None and skip:
                    # per-row locks; conflicting rows drop out
                    from ..errors import LockWaitTimeoutError
                    out = []
                    for ch in chunks:
                        keep = []
                        for i in range(len(ch)):
                            k = record_key(
                                tbl.id, int(ch.columns[hidx].data[i]))
                            try:
                                self.txn().lock_keys([k], nowait=True)
                                keep.append(i)
                            except LockWaitTimeoutError:
                                pass
                        if len(keep) == len(ch):
                            out.append(ch)
                        elif keep:
                            import numpy as _np
                            out.append(ch.take(
                                _np.asarray(keep, dtype=_np.int64)))
                    return out
                if hidx is not None:
                    for ch in chunks:
                        for i in range(len(ch)):
                            keys.append(record_key(
                                tbl.id, int(ch.columns[hidx].data[i])))
        if keys:
            # NOWAIT fails fast; plain FOR UPDATE enters the lock-wait
            # queue (bounded by tidb_tpu_lock_wait_timeout_ms -> ER 1205)
            self.txn().lock_keys(keys, nowait=nowait)
        return chunks

    def _skip_locked_point(self, plan, chunks, keys, key_handles,
                           tables):
        """SKIP LOCKED for PointGet-shaped plans: lock per key; rows
        of keys another txn holds drop out of the result."""
        from ..errors import LockWaitTimeoutError
        failed = set()
        first_err = None
        for k, h in zip(keys, key_handles):
            try:
                self.txn().lock_keys([k], nowait=True)
            except LockWaitTimeoutError as e:
                failed.add(h)
                first_err = e
        if not failed:
            return chunks
        if len(failed) == len(keys):
            return []
        # partial failure: filter rows via the pk-as-handle column
        if len(tables) == 1:
            db, tname = tables[0]
            tbl = self.domain.infoschema().table_by_name(db, tname)
            if tbl.pk_is_handle:
                pidx = next(
                    (i for i, sc in enumerate(plan.schema.cols)
                     if sc.name == tbl.pk_col_name.lower()), None)
                if pidx is not None:
                    import numpy as _np
                    out = []
                    for ch in chunks:
                        keep = [i for i in range(len(ch))
                                if int(ch.columns[pidx].data[i])
                                not in failed]
                        if len(keep) == len(ch):
                            out.append(ch)
                        elif keep:
                            out.append(ch.take(
                                _np.asarray(keep, dtype=_np.int64)))
                    return out
        raise first_err       # rows can't be mapped to keys: surface it

    def _exec_dml(self, stmt, params=None) -> ResultSet:
        """DML with autocommit retry on write conflict (reference
        session.go retry loop under tidb_retry_limit)."""
        from ..errors import WriteConflictError, TxnRetryableError
        retries = int(self.vars.get("tidb_retry_limit"))
        attempt = 0
        while True:
            try:
                rs = self._exec_dml_once(stmt, params)
                self.vars.last_affected = rs.affected
                return rs
            except (WriteConflictError, TxnRetryableError):
                attempt += 1
                if self._explicit_txn or attempt > retries:
                    raise
                self._txn = None    # fresh snapshot, re-plan, re-execute
                self.domain.inc_metric("txn_retry")

    def _exec_dml_once(self, stmt, params=None) -> ResultSet:
        plan = optimize(stmt, self._plan_ctx(params))
        ectx = ExecContext(self)
        txn = self.txn()   # ensure txn exists before write
        # lock waits inside this statement (pessimistic DML, commit
        # conflicts) are clamped to the statement deadline and observe
        # KILL, like every other blocking site
        self._stmt_lock_guard(txn, ectx)
        if self.domain.table_locks:
            targets = []
            if isinstance(plan, InsertPlan):
                targets = [(plan.db_name, plan.table_info.name)]
            elif isinstance(plan, (UpdatePlan, DeletePlan)):
                if plan.multi:
                    targets = [(m[1], m[0].name) for m in plan.multi]
                else:
                    targets = [(plan.db_name, plan.table_info.name)]
            self._check_table_locks(targets, write=True)
            # reads inside DML (INSERT...SELECT, joined UPDATE) honor
            # other sessions' WRITE locks too
            self._check_table_locks(
                list(getattr(plan, "read_tables", ())), write=False)
        # implicit statement savepoint (reference statement-level
        # atomicity over the memBuffer's staging): a DML statement that
        # fails mid-way — FK/CHECK violation, lock-wait timeout on a
        # later chunk — must not leave its earlier rows buffered in an
        # open explicit transaction for COMMIT to persist
        txn.savepoint("__stmt_atomic__")
        # registered like the SELECT path: KILL <conn> reaches the DML's
        # read side, and the global memory controller can see (and
        # shed) a giant INSERT..SELECT as the largest consumer
        self.domain.register_exec(self.conn_id, ectx)
        try:
            if isinstance(plan, InsertPlan):
                self.check_priv("insert", plan.db_name, plan.table_info.name)
                affected = InsertExec(ectx, plan, self).execute()
            elif isinstance(plan, UpdatePlan):
                if plan.multi:
                    for tbl, db, _offs, _h, _a in plan.multi:
                        self.check_priv("update", db, tbl.name)
                else:
                    self.check_priv("update", plan.db_name,
                                    plan.table_info.name)
                affected = UpdateExec(ectx, plan, self).execute()
            elif isinstance(plan, DeletePlan):
                if plan.multi:
                    for tbl, db, _, _ in plan.multi:
                        self.check_priv("delete", db, tbl.name)
                else:
                    self.check_priv("delete", plan.db_name,
                                    plan.table_info.name)
                affected = DeleteExec(ectx, plan, self).execute()
            else:
                raise UnsupportedError("bad DML plan")
        except TiDBError:
            txn.rollback_to_savepoint("__stmt_atomic__")
            txn.release_savepoint("__stmt_atomic__")
            self._finish_stmt(error=True)
            raise
        finally:
            self.domain.unregister_exec(self.conn_id, ectx)
            ectx.finish()
        txn.release_savepoint("__stmt_atomic__")
        self.vars.affected_rows = affected
        self._finish_stmt()
        return ResultSet(affected=affected,
                         last_insert_id=self.vars.last_insert_id)

    def _exec_set(self, stmt: ast.SetStmt) -> ResultSet:
        from ..executor.exec_base import expr_to_datum
        from ..planner.rewriter import Rewriter
        from ..planner.schema import Schema
        pctx = self._plan_ctx()
        for name, expr_node, is_global, is_system in stmt.assignments:
            if isinstance(expr_node, ast.ColumnRef) and not expr_node.table:
                v = expr_node.name      # bare enum word: SET x = pessimistic
            else:
                rw = Rewriter(pctx, Schema())
                e = rw.rewrite(expr_node)
                d = expr_to_datum(e)
                v = d.to_py()
            if is_system:
                self.vars.set(name, v, is_global=is_global)
                if is_global:
                    self._persist_global_var(name, v)
            else:
                self.domain.user_vars[name.lower()] = v
        return ResultSet()

    def _persist_global_var(self, name, v):
        """GLOBAL sysvars persist to mysql.global_variables (reference
        domain/sysvar_cache.go)."""
        try:
            s = Session(self.domain)
            s.is_internal = True
            s.vars.current_db = "mysql"
            val = str(int(v)) if isinstance(v, bool) else str(v)
            s.execute(
                "insert into global_variables values "
                f"('{name.lower()}', '{val}') on duplicate key update "
                f"variable_value = '{val}'")
        except TiDBError:
            pass

    def _exec_trace(self, stmt) -> ResultSet:
        """TRACE <stmt>: execute the inner statement as children of this
        statement's (forced-sampled) trace root, then render the span
        tree — including spans piggybacked from remote workers — from
        the still-open trace buffer. Columns: operation (indented),
        start_ms (relative to the earliest span), duration_ms, worker,
        attrs."""
        from .show import _str_chunk
        tr = self.domain.tracer
        self._dispatch(stmt.stmt, None)
        events = tr.current_events()
        root = tr.current_root()
        rows = []
        if root is None:
            # no open trace (direct _exec_trace call outside
            # _execute_stmt): nothing buffered to render
            return _str_chunk(
                ["operation", "start_ms", "duration_ms", "worker",
                 "attrs"], rows)
        trace_id, root_sp = root
        ids = {e.span_id for e in events}
        by_parent: dict = {}
        for e in events:
            # orphans (parent still open, or a remote parent whose
            # event was lost) attach to the statement root
            pid = e.parent_id if e.parent_id in ids else root_sp.span_id
            by_parent.setdefault(pid, []).append(e)
        t0 = min((e.start_ts for e in events), default=time.time())

        def emit(pid, depth):
            for e in sorted(by_parent.get(pid, []),
                            key=lambda ev: ev.start_ts):
                label = "  " * depth + "└─" + e.name
                rows.append((label,
                             f"{max(0.0, (e.start_ts - t0) * 1000):.3f}",
                             f"{e.dur_ms:.3f}",
                             e.worker or "coordinator", e.attrs))
                emit(e.span_id, depth + 1)

        rows.append((f"statement (trace_id={trace_id})", "0.000", "-",
                     "coordinator", ""))
        emit(root_sp.span_id, 1)
        self._finish_stmt()
        return _str_chunk(
            ["operation", "start_ms", "duration_ms", "worker", "attrs"],
            rows)

    def _exec_explain(self, stmt: ast.ExplainStmt) -> ResultSet:
        inner = stmt.stmt
        plan = optimize(inner, self._plan_ctx())
        from ..chunk.chunk import Chunk
        from ..chunk.column import Column
        from ..types.field_type import new_string_type
        import numpy as np
        is_dml = isinstance(plan, (InsertPlan, UpdatePlan, DeletePlan))
        if stmt.analyze and not is_dml:
            # the reason is per-statement diagnostics: clear it so a
            # statement with no fused pipeline can't inherit the
            # previous query's fallback note
            self.domain.last_fused_reason = None
            ectx = ExecContext(self)
            ectx.collect_stats = True
            ex = build_executor(ectx, plan)
            ex.open()
            try:
                ex.all_chunks()
            finally:
                ex.close()
                ectx.finish()
            from ..executor.runtime_stats import (pair_plan_stats,
                                                  wrapped_children_stats)
            stats = wrapped_children_stats(ex)
            rows = []
            base = explain_text(plan)

            # tree-aware pairing (runtime_stats.pair_plan_stats, shared
            # with the plan-feedback fold). Plan rows without an
            # executor ran inside their parent's kernel and show "-".
            stats_by_row = [st for _p, st in pair_plan_stats(plan, stats)]
            for (pid, est, info), st in zip(base, stats_by_row):
                if st is not None:
                    arows, ms, backend, _ = st
                    rows.append((pid, est, str(arows), f"{ms:.2f}ms",
                                 backend, info))
                else:
                    rows.append((pid, est, "-", "-", "", info))
            reason = self.domain.last_fused_reason
            if reason:
                # why the device pipeline declined this execution
                # (reference pkg/util/execdetails runtime stats notes)
                rows.append(("note", "-", "-", "-", "",
                             f"fused fallback: {reason}"))
            names = ["id", "estRows", "actRows", "time", "backend",
                     "operator info"]
            cols = []
            for j in range(6):
                arr = np.array([r[j] for r in rows], dtype=object)
                cols.append(Column(new_string_type(), arr))
            self._finish_stmt()
            return ResultSet(names=names, chunks=[Chunk(cols)])
        if is_dml:
            rows = [(type(plan).__name__, "N/A", "")]
            if plan.select_plan is not None:
                rows += [(f"└─{r[0]}", r[1], r[2])
                         for r in explain_text(plan.select_plan)]
        else:
            rows = explain_text(plan)
        if stmt.format == "json" and not is_dml:
            import json as _json

            def tree(p):
                return {"id": p.name(), "estRows": round(p.stats_rows, 2),
                        "info": p.explain_info(),
                        "children": [tree(c) for c in p.children]}
            from ..chunk.chunk import Chunk as _Ck
            from ..chunk.column import Column as _Cl
            from ..types.field_type import new_string_type as _st
            arr = np.array([_json.dumps(tree(plan), indent=2)], dtype=object)
            self._finish_stmt()
            return ResultSet(names=["EXPLAIN"],
                             chunks=[_Ck([_Cl(_st(), arr)])])
        names = ["id", "estRows", "operator info"]
        cols = []
        for j in range(3):
            arr = np.array([r[j] for r in rows], dtype=object)
            cols.append(Column(new_string_type(), arr))
        self._finish_stmt()
        return ResultSet(names=names, chunks=[Chunk(cols)])


class _AdmissionWaiter:
    """Kill sentinel for a statement parked in the OLAP admission
    queue: registered in domain._live_execs so KILL <conn> reaches it
    before any ExecContext exists (kill_conn just sets .killed)."""

    __slots__ = ("killed",)

    def __init__(self):
        self.killed = False

    def check_killed(self):
        if self.killed:
            from ..errors import QueryKilledError
            raise QueryKilledError("Query execution was interrupted")


_AGG_FUNCS = frozenset((
    "sum", "count", "avg", "min", "max", "group_concat", "std",
    "stddev", "stddev_pop", "stddev_samp", "var_pop", "var_samp",
    "variance", "bit_and", "bit_or", "bit_xor", "json_arrayagg",
    "json_objectagg", "any_value"))


def _stmt_class(stmt) -> str:
    """Dispatch-time workload classification for admission control
    (docs/PERFORMANCE.md "admission contract"): analytic SELECTs —
    aggregation, multi-table reads, set operations, windowed or
    CTE-bearing queries, unbounded full-table scans (no WHERE, no
    LIMIT) — are "olap" and take a bounded admission slot;
    everything else (point ops, DML, DDL, utility) is "oltp" and never
    queues behind analytics. A cheap AST-surface heuristic by design:
    misclassifying toward "oltp" costs fairness, never correctness."""
    if not isinstance(stmt, ast.SelectStmt):
        return "oltp"
    if stmt.group_by or stmt.having is not None or stmt.setops or \
            stmt.ctes or stmt.distinct or stmt.with_rollup:
        return "olap"
    frm = stmt.from_clause
    if frm is not None and not isinstance(frm, ast.TableName):
        return "olap"                # join tree / subquery source
    if frm is not None and stmt.where is None and stmt.limit is None:
        return "olap"                # unbounded full-table scan
    for f in stmt.fields:
        e = getattr(f, "expr", None)
        if isinstance(e, (ast.AggFunc, ast.WindowFunc)):
            return "olap"
        if isinstance(e, ast.FuncCall) and e.name in _AGG_FUNCS:
            return "olap"
    for ob in stmt.order_by:
        e = getattr(ob, "expr", None)
        if isinstance(e, ast.FuncCall) and e.name.startswith("vec_") \
                and e.name.endswith("_distance"):
            # vector retrieval ranks the whole table no matter how
            # small the LIMIT: analytic by construction, and the
            # resolved-mode hybrid-scan contract (docs/ML.md) depends
            # on the olap classification
            return "olap"
    return "oltp"


def bootstrap(domain: Domain) -> None:
    """Create system databases (reference pkg/session/bootstrap.go:63)."""
    from ..meta import Mutator
    from ..models import DBInfo
    txn = domain.storage.begin()
    try:
        m = Mutator(txn)
        if m.list_databases():
            txn.rollback()
            return
        for name in ("mysql", "test", "information_schema"):
            m.create_database(DBInfo(id=m.gen_global_id(), name=name))
        m.gen_schema_version()
        txn.commit()
    except BaseException:
        txn.rollback()
        raise
    sess = Session(domain)
    sess.vars.current_db = "mysql"
    sess.execute("""
        CREATE TABLE tidb (
          variable_name VARCHAR(64) NOT NULL PRIMARY KEY,
          variable_value VARCHAR(1024),
          comment VARCHAR(1024))""")
    sess.execute("""
        CREATE TABLE user (
          host VARCHAR(255) NOT NULL,
          user VARCHAR(32) NOT NULL,
          authentication_string VARCHAR(256),
          KEY idx_user (user))""")
    sess.execute("""
        CREATE TABLE global_variables (
          variable_name VARCHAR(64) NOT NULL PRIMARY KEY,
          variable_value VARCHAR(1024))""")
    sess.execute("""
        CREATE TABLE tidb_global_task (
          id BIGINT NOT NULL PRIMARY KEY,
          task_key VARCHAR(256),
          type VARCHAR(64),
          state VARCHAR(32),
          meta VARCHAR(4096),
          concurrency INT)""")
    sess.execute("""
        CREATE TABLE tidb_background_subtask (
          id BIGINT NOT NULL PRIMARY KEY,
          task_id BIGINT,
          ordinal INT,
          state VARCHAR(32),
          KEY idx_task (task_id))""")
    sess.execute(
        "INSERT INTO tidb VALUES ('bootstrapped', 'True', 'Bootstrap flag'), "
        "('tidb_server_version', '1', 'Bootstrap version')")


def new_store(data_dir: str | None = None,
              wal_sync: bool = False, device=None, mesh=None) -> Domain:
    """Create a bootstrapped in-process store (reference
    testkit.CreateMockStore). With data_dir, commits persist to a WAL and
    replay on reopen; wal_sync=True fsyncs every commit frame. device:
    the torch device of the coprocessor (default "cuda"; raises when
    there is none). mesh: the MPP mesh (parallel.Mesh, or an int: that
    many shards on `device`; default every visible CUDA device)."""
    domain = Domain(data_dir, wal_sync=wal_sync, device=device, mesh=mesh)
    bootstrap(domain)
    return domain
