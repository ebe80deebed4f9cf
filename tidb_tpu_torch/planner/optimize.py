"""Planner entry (reference pkg/planner/optimize.go:141)."""
from __future__ import annotations

import itertools

from ..parser import ast
from .builder import PlanBuilder
from .rules import optimize_logical
from .physical import to_physical


class PlanContext:
    """Everything the planner needs from the session (reference
    sessionctx.Context seam)."""

    def __init__(self, infoschema, sess_vars, current_db="",
                 run_subquery=None, table_rows=None, user_vars=None,
                 now_micros=0, conn_id=1, params=None, table_stats=None,
                 check_read=None, temp_tables=None, make_temp_table=None,
                 drop_temp_table=None, seq_nextval=None, seq_lastval=None,
                 ts_for_time=None, table_bulk_rows=None, user=None,
                 model_lookup=None, device_type="cpu"):
        self.infoschema = infoschema
        self.sess_vars = sess_vars
        self.current_db = current_db
        self._run_subquery = run_subquery
        self._table_rows = table_rows
        self._table_stats = table_stats
        self._table_bulk_rows = table_bulk_rows
        self.user = user
        self.check_read = check_read
        self.temp_tables = temp_tables or {}
        self.make_temp_table = make_temp_table
        self.drop_temp_table = drop_temp_table
        self.seq_nextval = seq_nextval
        self.seq_lastval = seq_lastval
        # domain ModelRegistry lookup (epoch-fenced): predict()/embed()
        # resolve their model handle through this at rewrite time
        self.model_lookup = model_lookup
        # the domain's torch device type: plan-time routing gates
        # (physical.to_physical) differ between the card and the CPU
        self.device_type = device_type
        self.ts_for_time = ts_for_time
        self.stale_read_ts = 0       # set by AS OF TIMESTAMP table refs
        self.user_vars = user_vars or {}
        self.now_micros = now_micros
        self.conn_id = conn_id
        self.params = params
        self._ids = itertools.count(1)
        # False once plan building consumed statement-time state (subquery
        # results, now()); such plans must not be cached
        self.cacheable = True
        self.read_tables: set = set()   # (db, table) touched by this plan

    def alloc_id(self) -> int:
        return next(self._ids)

    @property
    def div_prec_incr(self) -> int:
        try:
            return int(self.sess_vars.get("div_precision_increment"))
        except Exception:
            return 4

    def run_subquery(self, select_stmt, limit_one=False):
        self.cacheable = False
        if self._run_subquery is None:
            from ..errors import UnsupportedError
            raise UnsupportedError("subqueries not available in this context")
        return self._run_subquery(select_stmt, limit_one)

    def table_rows(self, db, tbl) -> float:
        if self._table_rows is None:
            return 1000.0
        return self._table_rows(db, tbl)

    def table_stats(self, table_id):
        if self._table_stats is None:
            return None
        return self._table_stats(table_id)

    def table_bulk_rows(self, table_id) -> int:
        """Rows without row/index KV (IMPORT INTO / BR restore): index-
        driven access paths would silently miss them."""
        if self._table_bulk_rows is None:
            return 0
        return self._table_bulk_rows(table_id)


def optimize(stmt, pctx: PlanContext):
    """AST statement -> physical plan (SELECT) or DML plan descriptor."""
    builder = PlanBuilder(pctx)
    hints = getattr(stmt, "hints", None) or []
    if isinstance(stmt, ast.SelectStmt):
        logical = builder.build_select(stmt)
        try:
            cascades = bool(pctx.sess_vars.get(
                "tidb_enable_cascades_planner"))
        except Exception:               # noqa: BLE001
            cascades = False
        logical = optimize_logical(
            logical, hints=hints,
            no_reorder=getattr(stmt, "straight_join", False),
            cascades=cascades)
        phys = to_physical(logical, pctx.sess_vars, hints=hints,
                           device_type=pctx.device_type)
        try:
            mpp_on = bool(pctx.sess_vars.get("tidb_enable_mpp"))
        except Exception:
            mpp_on = False
        if mpp_on:
            # exchange boundaries on any device count: without a mesh
            # every receiver runs its child's single-device path
            from ..mpp.fragment import fragment_plan
            phys = fragment_plan(phys)
        from .physical import attach_fused_topn
        phys = attach_fused_topn(phys)
        phys.read_tables = frozenset(pctx.read_tables)
        phys.for_update = stmt.for_update
        phys.lock_wait = getattr(stmt, "lock_wait", "")
        if pctx.stale_read_ts:
            phys.stale_read_ts = pctx.stale_read_ts
        if hints:
            from ..parser.hints import exec_hints
            eh = exec_hints(hints)
            if eh:
                phys.exec_hints = eh
        return phys
    if isinstance(stmt, ast.InsertStmt):
        plan = builder.build_insert(stmt)
        if plan.select_plan is not None:
            nr = getattr(getattr(stmt, "select", None), "straight_join",
                         False)
            plan.select_plan = to_physical(
                optimize_logical(plan.select_plan, no_reorder=nr),
                pctx.sess_vars, device_type=pctx.device_type)
        plan.read_tables = frozenset(pctx.read_tables)
        return plan
    if isinstance(stmt, ast.UpdateStmt):
        plan = builder.build_update(stmt)
        plan.select_plan = to_physical(optimize_logical(plan.select_plan),
                                       pctx.sess_vars,
                                       device_type=pctx.device_type)
        plan.read_tables = frozenset(pctx.read_tables)
        return plan
    if isinstance(stmt, ast.DeleteStmt):
        plan = builder.build_delete(stmt)
        plan.select_plan = to_physical(optimize_logical(plan.select_plan),
                                       pctx.sess_vars,
                                       device_type=pctx.device_type)
        plan.read_tables = frozenset(pctx.read_tables)
        return plan
    return stmt   # DDL / utility statements execute from the AST directly
