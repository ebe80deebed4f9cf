"""Query operators (reference pkg/executor — HashAgg agg_hash_executor.go,
HashJoinV2 hash_join_v2.go, sortexec — re-designed: device kernels via copr
for scans/partial aggs; host numpy vectorized ops above them; no goroutine
pipelines, batch dataflow instead)."""
from __future__ import annotations

import numpy as np

from ..chunk.chunk import Chunk
from ..chunk.column import Column
from ..chunk.device import StringDict
from ..expression import EvalCtx, eval_expr, Column as ExprCol
from ..expression.vec import materialize_nulls, eval_bool_mask
from ..types.field_type import TypeClass, new_bigint_type
from ..types.datum import Datum, Kind
from ..types.decimal import _POW10
from ..errors import UnsupportedError, TiDBError
from .exec_base import Executor, bind_chunk, eval_to_column, spill_quota
from ..utils import metrics as _metrics

_I64_MAX = np.iinfo(np.int64).max


def _chunk_nbytes(ch) -> int:
    return sum(getattr(c.data, "nbytes", 0) for c in ch.columns)


def _tracked_chunks(child, tracker, ctx, can_spill=True) -> list:
    """Drain a child like Executor.all_chunks, consuming each chunk's
    payload bytes into ``tracker``. With can_spill a quota breach
    mid-drain arms the owning operator's spill trigger (the
    memory.Tracker action chain) instead of cancelling — the operator
    polls the trigger and sheds to disk. Without it (the operator has
    no spill path: cross join, ungrouped DISTINCT agg) a breach runs
    the full chain and cancels per tidb_tpu_oom_action."""
    out = []
    while True:
        ctx.check_killed()
        ch = child.next()
        if ch is None:
            break
        if len(ch):
            tracker.consume(_chunk_nbytes(ch), can_spill=can_spill)
            out.append(ch)
    return out


class DualExec(Executor):
    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema)
        self.rows = plan.rows
        self._done = False

    def next(self):
        if self._done:
            return None
        self._done = True
        cols = [Column(sc.col.ft, np.zeros(self.rows, dtype=np.int64))
                for sc in self.schema.cols]
        if not cols:
            # phantom column so the chunk has a row count (SELECT 1)
            cols = [Column(new_bigint_type(), np.zeros(self.rows,
                                                       dtype=np.int64))]
        return Chunk(cols)


class TableReaderExec(Executor):
    """Leaf reader: runs the pushed CoprDAG (device scan/filter[/partial
    agg]) — reference TableReaderExecutor table_reader.go:232."""

    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema)
        self.dag = plan.dag
        self._chunks = None
        self._i = 0
        self._backends: set = set()
        self._kc = [0, 0]       # kernel-cache hits, misses

    def _copr_exec(self, dag, *args, **kw):
        """Run one copr (sub)dag recording which backend served it and
        the kernel-cache hit/miss delta — EXPLAIN ANALYZE's per-operator
        placement observable (reference pkg/util/execdetails)."""
        copr = self.ctx.copr
        kc = copr._kernel_cache
        h0, m0 = kc.hits, kc.misses
        kw.setdefault("ectx", self.ctx)
        res = copr.execute(dag, *args, **kw)
        if copr.last_backend:
            self._backends.add(copr.last_backend)
        self._kc[0] += kc.hits - h0
        self._kc[1] += kc.misses - m0
        return res

    def backend_info(self):
        if not self._backends:
            return ""
        s = "+".join(sorted(self._backends))
        if self._kc[0] or self._kc[1]:
            s += f" kcache:{self._kc[0]}/{self._kc[1]}"
        return s

    def open(self):
        pass

    def _overlay(self, dag=None):
        """UnionScan overlay: uncommitted row mutations for this table from
        the session's dirty transaction."""
        dag = dag or self.dag
        if getattr(self.ctx, "analytic_resolved", False):
            # resolved-ts analytic read: committed-data view at the
            # resolved floor by design — the session's uncommitted
            # writes are invisible to it (docs/PERFORMANCE.md
            # "Incremental HTAP"; the stale-read opt-in contract)
            return None
        sess = self.ctx.sess
        txn = getattr(sess, "_txn", None)
        if txn is None or txn.committed or txn.aborted or not txn.is_dirty():
            return None
        from ..codec.tablecodec import record_prefix, decode_record_key
        from ..codec.codec import decode_row_value
        pref = record_prefix(dag.table_info.id)
        end = pref + b"\xff" * 9
        overlay = {}
        for k, v in txn.mem_buffer.scan(pref, end):
            _, handle = decode_record_key(k)
            overlay[handle] = decode_row_value(v) if v is not None else None
        return overlay or None

    def _part_dags(self):
        """One (sub)dag per physical table: the dag itself, or per-partition
        clones after partition pruning."""
        tbl = self.dag.table_info
        if not tbl.partitions:
            return [self.dag]
        from ..storage.partition import prune_for_dag, partition_table_info
        import dataclasses
        return [dataclasses.replace(self.dag,
                                    table_info=partition_table_info(tbl, pid))
                for pid in prune_for_dag(self.dag)]

    def next(self):
        if self.dag.aggs or self.dag.group_items:
            raise RuntimeError("partial-agg reader must be driven by HashAgg")
        if self._chunks is None:
            self._chunks = []
            for dag in self._part_dags():
                self._chunks.extend(self._copr_exec(
                    dag, self._overlay(dag), self.ctx.read_ts()))
            self._i = 0
        if self._i >= len(self._chunks):
            return None
        ch = self._chunks[self._i]
        self._i += 1
        return ch

    def partials(self):
        sv = self.ctx.sv
        out = []
        for dag in self._part_dags():
            fm = getattr(self.ctx, "force_mpp", None)
            out.extend(self._copr_exec(
                dag, self._overlay(dag), self.ctx.read_ts(),
                use_mpp=bool(sv.get("tidb_enable_mpp")) if fm is None
                else fm,
                mpp_min_rows=0 if fm
                else int(sv.get("tidb_mpp_min_rows"))))
        return out


class ExchangeReceiverExec(Executor):
    """Consumer side of a fragment boundary: forwards to the fragment
    body, which executes on the mesh when one exists (partial results
    returned over the PassThrough exchange) and on one device
    otherwise."""

    def __init__(self, ctx, plan, inner):
        super().__init__(ctx, plan.schema, [inner])
        self.plan = plan

    def open(self):
        self.children[0].open()

    def next(self):
        return self.children[0].next()

    def partials(self):
        return self.children[0].partials()


class FusedPipelineExec(Executor):
    """Drives a PhysFusedPipeline: the whole scan->join->agg subtree as
    one device kernel per fact partition (copr/pipeline.py). Falls back
    to the conventional HashJoin subtree (plan.fallback) + a host partial
    agg when runtime eligibility fails — dirty transactions, non-unique/
    NULL build keys, device errors — so results are always correct."""

    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema)
        self.plan = plan
        self.backend = ""

    def backend_info(self):
        return self.backend

    def open(self):
        pass

    def next(self):
        raise RuntimeError("fused pipeline must be driven by HashAgg")

    def _dirty_state(self):
        """Classify the transaction's uncommitted writes against this
        pipeline (reference UnionScan, builder.go:1473, re-designed as
        a device overlay): -> ("clean", None) |
        ("fact_delta", (rows, dead_handles)) | ("fallback", reason).
        fact_delta = ONLY the fact table is dirty: inserted/updated
        row values mount as one extra device partition and the
        committed versions of updated/deleted handles are masked out
        of the base snapshot's validity array, keeping the fused path
        under concurrent OLTP writes. Dim-table writes and
        subplan-base writes still fall back (correct, slower).

        Resolved-ts analytic reads (ctx.analytic_resolved) are clean
        BY CONTRACT: they snapshot committed data at the resolved
        floor and never consult the session's dirty buffer — this is
        what retires the fused_pipeline_dirty_overlay rescans for
        committed-data freshness."""
        if getattr(self.ctx, "analytic_resolved", False):
            return "clean", None
        sess = self.ctx.sess
        txn = getattr(sess, "_txn", None)
        if txn is None or txn.committed or txn.aborted or \
                not txn.is_dirty():
            return "clean", None
        from ..codec.tablecodec import record_prefix, decode_record_key
        from ..codec.codec import decode_row_value
        fact_info = self.plan.fact_dag.table_info
        others = []
        fact_in_dims = False
        for d in self.plan.dims:
            if d.subplan is not None:
                from ..copr.pipeline import _plan_base_tables
                base = _plan_base_tables(
                    self.ctx.copr.engine, d.subplan)
                if base is None:
                    return "fallback", ("dirty transaction and a dim "
                                        "subplan whose base tables "
                                        "cannot be determined")
                for t in base:
                    if t.table_info.id == fact_info.id:
                        fact_in_dims = True
                    else:
                        others.append(t.table_info)
            if d.dag.table_info.id == fact_info.id:
                fact_in_dims = True
            else:
                others.append(d.dag.table_info)
        for t in others:
            pref = record_prefix(t.id)
            for _k, _v in txn.mem_buffer.scan(pref, pref + b"\xff" * 9):
                return "fallback", (f"transaction has uncommitted "
                                    f"writes to joined table "
                                    f"{t.name!r} (fact-only deltas "
                                    f"stay on device)")
        pref = record_prefix(fact_info.id)
        muts = list(txn.mem_buffer.scan(pref, pref + b"\xff" * 9))
        if not muts:
            return "clean", None
        if fact_in_dims or fact_info.partitions:
            # the fact also feeds a dim/subplan (self-join shapes): an
            # overlay on one side only would be inconsistent
            return "fallback", ("transaction wrote the fact table and "
                                "the fact also feeds a dim/subplan or "
                                "is partitioned — overlay would be "
                                "one-sided")
        ctab = self.ctx.copr.engine.tables.get(fact_info.id)
        if ctab is None:
            return "fallback", "fact table has no columnar image"
        rows = []
        dead = []
        hp = ctab.handle_pos
        for k, v in muts:
            try:
                _tid, handle = decode_record_key(k)
            except Exception:                  # noqa: BLE001
                return "fallback", ("undecodable record key in the "
                                    "transaction buffer")
            if v is None:                      # delete
                if handle in hp:
                    dead.append(handle)
                # else: insert-then-delete within this txn — no-op
                continue
            if handle in hp:
                dead.append(handle)            # update: mask old version
            rows.append((handle, decode_row_value(v)))
        return "fact_delta", (rows, dead)

    def partials(self):
        sess = self.ctx.sess
        sess.domain.last_fused_reason = None
        fused_errored = False
        dkind, drows = ("clean", None)
        if self.ctx.copr.use_device:
            dkind, drows = self._dirty_state()
        if not self.ctx.copr.use_device:
            sess.domain.last_fused_reason = "device execution disabled"
        elif dkind == "fallback":
            sess.domain.last_fused_reason = drows   # the reason string
        else:
            from ..copr.pipeline import fused_partials
            from ..utils import device_guard
            to_host = self.ctx.copr.degrade_to_host
            mesh = None
            if getattr(self.plan, "mpp", False) and drows is None:
                # the delta overlay runs on one device: the extra
                # partition is tiny and not worth a mesh program
                fm = getattr(self.ctx, "force_mpp", None)
                want = bool(self.ctx.sv.get("tidb_enable_mpp")) \
                    if fm is None else fm
                min_rows = 0 if fm else int(
                    self.ctx.sv.get("tidb_mpp_min_rows"))
                fact = sess.domain.columnar.tables.get(
                    self.plan.fact_dag.table_info.id)
                if want and fact is not None and fact.n >= min_rows:
                    mesh = self.ctx.copr._get_mesh()
            bt = int(self.ctx.sv.get("tidb_broadcast_join_threshold_count"))

            def _run_fused(m):
                return fused_partials(
                    self.ctx.copr, self.plan, self.ctx.read_ts(), m,
                    bcast_threshold=bt, ctx=self.ctx,
                    delta_rows=drows[0] if drows else None,
                    dead_handles=drows[1] if drows else None)

            try:
                # supervised dispatch (classified retry/backoff +
                # watchdog). On the CPU a degraded mesh run retries on
                # one device before falling back to the host join, as
                # the reference does; on the card it fails the
                # statement
                used_mesh = mesh is not None
                try:
                    res = device_guard.guarded_dispatch(
                        lambda: _run_fused(mesh),
                        site="fused/mpp" if used_mesh else "fused",
                        ectx=self.ctx,
                        fallback_is_host=to_host and not used_mesh)
                except device_guard.DeviceDegradedError:
                    if not (used_mesh and to_host):
                        raise
                    used_mesh = False
                    res = device_guard.guarded_dispatch(
                        lambda: _run_fused(None), site="fused",
                        ectx=self.ctx, fallback_is_host=to_host)
                if res is not None:
                    from ..utils import metrics as _mtr
                    _mtr.FUSED_PIPELINE.labels(
                        "mpp_hit" if used_mesh else "hit").inc()
                    sess.domain.inc_metric(
                        "fused_pipeline_mpp_hit" if used_mesh
                        else "fused_pipeline_hit")
                    if drows is not None:
                        sess.domain.inc_metric(
                            "fused_pipeline_dirty_overlay")
                    self.backend = ("device(fused-mpp)" if used_mesh
                                    else "device(fused)")
                    sess.domain.last_fused_reason = None
                    return res
            except device_guard.DeviceDegradedError as exc:
                fused_errored = True
                sess.domain.inc_metric("fused_pipeline_error")
                if not to_host:
                    raise                  # the card: the statement fails
                cause = exc.cause if exc.cause is not None else exc
                sess.domain.last_fused_reason = (
                    f"fused kernel error: {type(cause).__name__}: "
                    f"{str(cause)[:200]}")
                from ..utils.logutil import log
                log("warn", "fused_fallback",
                    reason=sess.domain.last_fused_reason)
        from ..utils import metrics as _mtr
        # 'outcome' partitions executions: error_fallback = kernel
        # degraded then host ran; fallback = declined before dispatch
        _mtr.FUSED_PIPELINE.labels(
            "error_fallback" if fused_errored else "fallback").inc()
        sess.domain.inc_metric("fused_pipeline_fallback")
        self.backend = "host(fallback)"
        return self._fallback_partials()

    def _fallback_partials(self):
        import time as _time
        from ..utils import phase
        t0 = _time.perf_counter()
        try:
            return self._fallback_partials_inner()
        finally:
            # wall time of the whole fallback subtree; overlaps the
            # host_exec_s/dispatch_s its children record themselves
            phase.add("fallback_s", _time.perf_counter() - t0)
            phase.inc("fused_fallbacks")

    def _fallback_partials_inner(self):
        from .builder import build_executor
        from ..copr.dag_exec import _host_partial_agg
        from ..copr.pipeline import _AggShim
        fb = build_executor(self.ctx, self.plan.fallback)
        shim = _AggShim(self.plan.group_items, self.plan.aggs)
        out = []
        shared_dicts = {}
        for chunk in fb.all_chunks():        # partial-agg per chunk: no
            if not len(chunk):               # full-join materialization
                continue
            cols = bind_chunk(self.plan.fallback.schema, chunk)
            ectx = EvalCtx(np, len(chunk), cols, host=True)
            out.append(_host_partial_agg(
                ectx, shim, np.ones(len(chunk), dtype=bool),
                shared_dicts=shared_dicts))
        return out


class BatchPointGetExec(Executor):
    """Vectorized multi-handle lookup via the columnar handle index."""

    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema)
        self.plan = plan
        self._done = False

    def open(self):
        pass

    def next(self):
        if self._done:
            return None
        self._done = True
        plan = self.plan
        tbl = plan.table_info
        sess = self.ctx.sess
        from .exec_base import expr_to_datum
        from ..codec.tablecodec import record_key
        from ..codec.codec import decode_row_value
        txn = getattr(sess, "_txn", None)
        dirty = txn is not None and not txn.committed and not txn.aborted \
            and txn.is_dirty() \
            and not getattr(self.ctx, "analytic_resolved", False)
        # analytic_resolved: a resolved-ts read is a committed-data
        # view by contract on EVERY plan shape — point/index paths
        # must not merge the dirty memBuffer either, or the same
        # statement would see different data depending on the plan
        ctab = sess.domain.columnar.tables.get(tbl.id)
        empty = Chunk.empty([sc.col.ft for sc in self.schema.cols])
        handles = []
        for e in plan.handles:
            d = expr_to_datum(e)
            if not d.is_null:
                handles.append(int(d.val))
        buffered = []          # (handle, row datums)
        live_handles = []
        for h in handles:
            if dirty and record_key(tbl.id, h) in txn.mem_buffer:
                rv = txn.mem_buffer.get(record_key(tbl.id, h))
                if rv is not None:
                    buffered.append((h, decode_row_value(rv)))
                continue       # buffered delete: skip
            live_handles.append(h)
        pos = []
        if ctab is not None:
            pos = [ctab.handle_pos.get(h) for h in live_handles]
            pos = [p for p in pos
                   if p is not None and ctab.delete_ts[p] == 0]
        pos = np.array(pos, dtype=np.int64)
        parts = []
        if len(pos):
            cols = []
            for sc in self.schema.cols:
                ci = tbl.find_column(sc.name)
                if ci is None:
                    cols.append(Column(sc.col.ft, ctab.handles[pos].copy()))
                else:
                    cols.append(ctab.column_for(ci, pos))
            parts.append(Chunk(cols))
        if buffered:
            name_off = {c.name.lower(): i for i, c in
                        enumerate(tbl.columns)}
            from ..chunk.column import Column as HostCol
            cols = []
            for sc in self.schema.cols:
                off = name_off.get(sc.name)
                if off is None:
                    cols.append(HostCol(sc.col.ft, np.array(
                        [h for h, _ in buffered], dtype=np.int64)))
                else:
                    cols.append(HostCol.from_datums(
                        sc.col.ft, [r[off] for _, r in buffered]))
            parts.append(Chunk(cols))
        out = Chunk.concat_all(parts)
        return out if out is not None else empty


class IndexRangeExec(Executor):
    """Index range scan: scan index KV range at the read ts, collect
    handles, gather rows from the columnar engine, apply residual filters.
    Only chosen for fully KV-backed tables (bulk rows lack index KV)."""

    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema)
        self.plan = plan
        self._done = False

    def open(self):
        pass

    def _scan_index_handles(self, index, low, high, low_inc, high_inc,
                            eq_prefix=()):
        """Scan one index KV range at the read ts (memBuffer-merged when
        the txn is dirty); -> (handles, dirty, txn). eq_prefix: constant
        values for the index's leading columns; the range (if any)
        applies to the column after them — together they encode to one
        contiguous memcomparable key interval (reference
        ranger/detacher.go point-prefix x interval composition)."""
        from ..codec.tablecodec import index_prefix, index_key_handle
        from ..codec.codec import encode_datums_key
        from .exec_base import expr_to_datum, coerce_datum
        tbl = self.plan.table_info
        sess = self.ctx.sess
        pref = index_prefix(tbl.id, index.id)
        from .table_rt import fold_ci_datums

        def probe_datums(exprs):
            # _ci index KV stores the collation normal form: probe
            # constants must fold the same way or exact matches miss.
            # each value coerces to ITS index column's type
            ds = []
            for off, e in enumerate(exprs):
                ci = tbl.find_column(index.columns[off])
                ds.append(coerce_datum(expr_to_datum(e), ci.ft))
            return fold_ci_datums(tbl, index, ds)
        epfx = b""
        if eq_prefix:
            epfx = encode_datums_key(probe_datums(eq_prefix))
        np_ = len(eq_prefix)

        def range_datum(e):
            # folded at position np_ (the first non-eq index column)
            return probe_datums(list(eq_prefix) + [e])[np_]
        lo = pref + epfx
        if low is not None:
            lo = pref + epfx + encode_datums_key([range_datum(low)])
            if not low_inc:
                lo += b"\xff"
        hi = pref + epfx + b"\xff" * 9
        if high is not None:
            hi = pref + epfx + encode_datums_key([range_datum(high)])
            hi = hi + (b"\xff" * 9 if high_inc else b"")
        txn = getattr(sess, "_txn", None)
        dirty = txn is not None and not txn.committed and not txn.aborted \
            and txn.is_dirty() \
            and not getattr(self.ctx, "analytic_resolved", False)
        # analytic_resolved: a resolved-ts read is a committed-data
        # view by contract on EVERY plan shape — point/index paths
        # must not merge the dirty memBuffer either, or the same
        # statement would see different data depending on the plan
        lim = getattr(self.plan, "scan_limit", -1)
        if dirty:
            entries = txn.scan(lo, hi, limit=lim)  # memBuffer merged
        else:
            read_ts = self.ctx.read_ts() or \
                sess.domain.storage.current_ts()
            entries = sess.domain.storage.mvcc.scan(
                lo, hi, read_ts, limit=lim, ctx=self.ctx.lock_ctx)
        handles = []
        for k, v in entries:
            if index.unique and v not in (b"",):
                handles.append(int(v))
            else:
                handles.append(index_key_handle(k))
        return handles, dirty, txn

    def _collect_handles(self):
        p = self.plan
        return self._scan_index_handles(p.index, p.low, p.high,
                                        p.low_inc, p.high_inc,
                                        getattr(p, "prefix", ()))

    def next(self):
        if self._done:
            return None
        self._done = True
        plan = self.plan
        tbl = plan.table_info
        sess = self.ctx.sess
        ctab = sess.domain.columnar.tables.get(tbl.id)
        empty = Chunk.empty([sc.col.ft for sc in self.schema.cols])
        if ctab is None:
            return empty
        if ctab.bulk_rows:
            # safety net: planner shouldn't pick this path, but fall back
            return self._fallback_scan()
        handles, dirty, txn = self._collect_handles()
        if not handles:
            return empty
        from ..codec.tablecodec import record_key
        from ..codec.codec import decode_row_value
        buffered = []
        resident = []
        for h in handles:
            rk = record_key(tbl.id, h)
            if dirty and rk in txn.mem_buffer:
                rv = txn.mem_buffer.get(rk)
                if rv is not None:
                    buffered.append((h, decode_row_value(rv)))
                continue
            resident.append(h)
        pos = [ctab.handle_pos.get(h) for h in resident]
        pos = np.array([p for p in pos
                        if p is not None and ctab.delete_ts[p] == 0],
                       dtype=np.int64)
        parts = []
        if len(pos):
            cols = []
            for sc in self.schema.cols:
                cinfo = tbl.find_column(sc.name)
                if cinfo is None:
                    cols.append(Column(sc.col.ft, ctab.handles[pos].copy()))
                else:
                    cols.append(ctab.column_for(cinfo, pos))
            parts.append(Chunk(cols))
        if buffered:
            name_off = {c.name.lower(): i for i, c in enumerate(tbl.columns)}
            from ..chunk.column import Column as HostCol
            cols = []
            for sc in self.schema.cols:
                off = name_off.get(sc.name)
                if off is None:
                    cols.append(HostCol(sc.col.ft, np.array(
                        [h for h, _ in buffered], dtype=np.int64)))
                else:
                    cols.append(HostCol.from_datums(
                        sc.col.ft, [r[off] for _, r in buffered]))
            parts.append(Chunk(cols))
        ch = Chunk.concat_all(parts)
        if ch is None:
            return empty
        if plan.residual:
            cols_ctx = bind_chunk(self.schema, ch)
            ectx = EvalCtx(np, len(ch), cols_ctx, host=True)
            mask = np.ones(len(ch), dtype=bool)
            for c in plan.residual:
                mask &= np.asarray(eval_bool_mask(ectx, c))
            ch = ch.filter(mask)
        return ch

    def _fallback_scan(self):
        from ..planner.physical import CoprDAG
        dag = CoprDAG(table_info=self.plan.table_info,
                      db_name=self.plan.db_name, cols=self.plan.cols,
                      host_filters=list(self.plan.residual))
        # a LIMITed index scan falling back (bulk rows carry no index
        # KV) keeps its bound: with zero residual beyond the re-applied
        # range, the post-filter limit equals the scan limit
        sl = getattr(self.plan, "scan_limit", -1)
        if sl > 0 and not self.plan.residual:
            dag.limit = sl
        # re-apply the prefix equalities + range as filters
        from ..expression import ScalarFunc
        from ..types.field_type import new_bigint_type

        def col_at(off):
            return next(sc.col for sc in self.plan.cols
                        if sc.name == self.plan.index.columns[off].lower())
        for off, v in enumerate(getattr(self.plan, "prefix", ())):
            dag.host_filters.append(ScalarFunc(
                "=", [col_at(off), v], new_bigint_type()))
        rng_off = len(getattr(self.plan, "prefix", ()))
        if self.plan.low is not None:
            dag.host_filters.append(ScalarFunc(
                ">=" if self.plan.low_inc else ">",
                [col_at(rng_off), self.plan.low], new_bigint_type()))
        if self.plan.high is not None:
            dag.host_filters.append(ScalarFunc(
                "<=" if self.plan.high_inc else "<",
                [col_at(rng_off), self.plan.high], new_bigint_type()))
        chunks = self.ctx.copr.execute(dag, None, self.ctx.read_ts(),
                                       ectx=self.ctx)
        return Chunk.concat_all(chunks) or Chunk.empty(
            [sc.col.ft for sc in self.schema.cols])


class IndexMergeExec(IndexRangeExec):
    """Union-type index merge (reference index_merge_reader.go): every
    branch scans its own index range; the handle sets union (dedup);
    rows gather once and the original OR predicate re-applies as the
    residual filter."""

    def _collect_handles(self):
        seen = set()
        handles = []
        dirty = False
        txn = None
        for idx, low, high, low_inc, high_inc in self.plan.branches:
            hs, dirty, txn = self._scan_index_handles(
                idx, low, high, low_inc, high_inc)
            for h in hs:
                if h not in seen:
                    seen.add(h)
                    handles.append(h)
        return handles, dirty, txn

    def _fallback_scan(self):
        from ..planner.physical import CoprDAG
        dag = CoprDAG(table_info=self.plan.table_info,
                      db_name=self.plan.db_name, cols=self.plan.cols,
                      host_filters=list(self.plan.residual))
        chunks = self.ctx.copr.execute(dag, None, self.ctx.read_ts(),
                                       ectx=self.ctx)
        return Chunk.concat_all(chunks) or Chunk.empty(
            [sc.col.ft for sc in self.schema.cols])


def _columnar_unique_probe(ctab, tbl, index, datums, read_ts):
    """Handle of the row matching a unique-index key, found by scanning
    the columnar arrays (bulk-loaded rows carry no index KV)."""
    n = ctab.n
    mask = ctab.valid_at(read_ts, n)
    for d, cn in zip(datums, index.columns):
        ci = tbl.find_column(cn)
        arr = ctab.data[ci.id][:n]
        nulls = ctab.nulls[ci.id][:n]
        if d.is_null:
            mask = mask & nulls
            continue
        if ci.id in ctab.dicts:
            from ..expression.vec import _is_ci, _coll_arg
            sd = ctab.dicts[ci.id]
            if _is_ci(ci.ft):
                # the query datum arrives FOLDED (fold_ci_datums):
                # match any stored code sharing the normal form
                codes, fd = sd.ci_fold_codes(_coll_arg(ci.ft))
                target = fd.lookup(str(d.val))
                if target < 0:
                    return None
                mask = mask & (codes[arr] == target) & ~nulls
            else:
                code = sd.lookup(str(d.val))
                if code < 0:
                    return None
                mask = mask & (arr == code) & ~nulls
        else:
            v = float(d.val) if arr.dtype == np.float64 else int(d.val)
            mask = mask & (arr == v) & ~nulls
    idxs = np.nonzero(mask)[0]
    if not len(idxs):
        return None
    return int(ctab.handles[idxs[-1]])


def _row_matches_index(tbl, index, row, datums):
    """Does a decoded row still carry the queried unique-key values?
    (An in-txn UPDATE can move a row off the key the probe found it by.)"""
    name_off = {c.name.lower(): i for i, c in enumerate(tbl.columns)}
    for d, cn in zip(datums, index.columns):
        off = name_off.get(cn.lower())
        if off is None or off >= len(row):
            return False
        rd = row[off]
        if d.is_null or rd.is_null:
            if d.is_null != rd.is_null:
                return False
            continue
        rv = rd.val
        off_ci = tbl.columns[off]
        if isinstance(rv, str):
            from ..expression.vec import _is_ci, _coll_arg
            if _is_ci(off_ci.ft):
                from ..chunk.device import collation_fold
                rv = collation_fold(_coll_arg(off_ci.ft) or True)(rv)
                # probe datums arrive folded
        if rv != d.val and str(rv) != str(d.val):
            return False
    return True


class PointGetExec(Executor):
    """O(1) point read: clustered-PK handle -> columnar handle index (or
    row KV for txn-buffered rows); unique index -> index KV -> handle."""

    def __init__(self, ctx, plan):
        super().__init__(ctx, plan.schema)
        self.plan = plan
        self._done = False

    def open(self):
        pass

    def next(self):
        if self._done:
            return None
        self._done = True
        plan = self.plan
        tbl = plan.table_info
        sess = self.ctx.sess
        from .exec_base import expr_to_datum, coerce_datum
        from ..codec.tablecodec import record_key, index_key
        from ..codec.codec import decode_row_value
        txn = getattr(sess, "_txn", None)
        dirty = txn is not None and not txn.committed and not txn.aborted \
            and txn.is_dirty() \
            and not getattr(self.ctx, "analytic_resolved", False)
        # analytic_resolved: a resolved-ts read is a committed-data
        # view by contract on EVERY plan shape — point/index paths
        # must not merge the dirty memBuffer either, or the same
        # statement would see different data depending on the plan
        handle = None
        if plan.handle_expr is not None:
            d = expr_to_datum(plan.handle_expr)
            if d.is_null:
                return Chunk.empty([sc.col.ft for sc in self.schema.cols])
            handle = int(d.val)
        else:
            datums = []
            for e, cn in zip(plan.index_vals, plan.index.columns):
                ci = tbl.find_column(cn)
                datums.append(coerce_datum(expr_to_datum(e), ci.ft))
            from .table_rt import fold_ci_datums
            datums = fold_ci_datums(tbl, plan.index, datums)
            bctab = sess.domain.columnar.tables.get(tbl.id)
            if bctab is not None and bctab.bulk_rows:
                # safety net (stale cached plan after IMPORT/restore):
                # bulk rows have no index KV — but in-txn writes DO
                # maintain index KV in the mem buffer, so that wins
                ik = index_key(tbl.id, plan.index.id, datums)
                if dirty and ik in txn.mem_buffer:
                    v = txn.mem_buffer.get(ik)
                    if v is None:     # txn removed this unique value
                        return Chunk.empty(
                            [sc.col.ft for sc in self.schema.cols])
                    handle = int(v)
                else:
                    handle = _columnar_unique_probe(
                        bctab, tbl, plan.index, datums, self.ctx.read_ts())
                    if handle is None:
                        return Chunk.empty(
                            [sc.col.ft for sc in self.schema.cols])
                if dirty:
                    rk = record_key(tbl.id, handle)
                    if rk in txn.mem_buffer:
                        rv = txn.mem_buffer.get(rk)
                        if rv is None:
                            return Chunk.empty(
                                [sc.col.ft for sc in self.schema.cols])
                        row = decode_row_value(rv)
                        # the buffered row may have been updated past the
                        # probed (committed) key value — re-verify
                        if not _row_matches_index(tbl, plan.index, row,
                                                  datums):
                            return Chunk.empty(
                                [sc.col.ft for sc in self.schema.cols])
                        return self._from_row(row)
                return self._gather_one(bctab, handle)
            ik = index_key(tbl.id, plan.index.id, datums)
            v = (txn.get(ik) if dirty else
                 sess.domain.storage.mvcc.get(
                     ik, self.ctx.read_ts()
                     or sess.domain.storage.current_ts(),
                     ctx=self.ctx.lock_ctx))
            if v is None:
                return Chunk.empty([sc.col.ft for sc in self.schema.cols])
            handle = int(v)
        # txn-buffered row wins (UnionScan semantics)
        if dirty:
            rv = txn.mem_buffer.get(record_key(tbl.id, handle))
            if record_key(tbl.id, handle) in txn.mem_buffer:
                if rv is None:
                    return Chunk.empty(
                        [sc.col.ft for sc in self.schema.cols])
                row = decode_row_value(rv)
                return self._from_row(row)
        ctab = sess.domain.columnar.tables.get(tbl.id)
        return self._gather_one(ctab, handle)

    def _gather_one(self, ctab, handle):
        tbl = self.plan.table_info
        pos = None if ctab is None else ctab.handle_pos.get(handle)
        rts = self.ctx.read_ts()
        if pos is None or (rts is None and ctab.delete_ts[pos] != 0):
            # deleted-latest still needs the stale-read version rescan
            # below when rts is set (an older version may be visible)
            return Chunk.empty([sc.col.ft for sc in self.schema.cols])
        if rts is not None and not (
                ctab.insert_ts[pos] <= rts and
                (ctab.delete_ts[pos] == 0 or ctab.delete_ts[pos] > rts)):
            # find an older visible version by scanning versions of handle
            mask = (ctab.handles[:ctab.n] == handle) & \
                   (ctab.insert_ts[:ctab.n] <= rts) & \
                   ((ctab.delete_ts[:ctab.n] == 0) |
                    (ctab.delete_ts[:ctab.n] > rts))
            idxs = np.nonzero(mask)[0]
            if not len(idxs):
                return Chunk.empty([sc.col.ft for sc in self.schema.cols])
            pos = int(idxs[-1])
        out = []
        for sc in self.schema.cols:
            ci = tbl.find_column(sc.name)
            if ci is None:   # handle column
                out.append(Column(sc.col.ft,
                                  np.array([handle], dtype=np.int64)))
            else:
                out.append(ctab.column_for(ci, np.array([pos])))
        return Chunk(out)

    def _from_row(self, row):
        tbl = self.plan.table_info
        name_off = {c.name.lower(): i for i, c in enumerate(tbl.columns)}
        cols = []
        for sc in self.schema.cols:
            off = name_off.get(sc.name)
            from ..chunk.column import Column as HostCol
            if off is None:
                cols.append(HostCol(sc.col.ft, np.zeros(1, dtype=np.int64)))
            else:
                cols.append(HostCol.from_datums(sc.col.ft, [row[off]]))
        return Chunk(cols)


class ShellExec(Executor):
    """Subquery-in-FROM renaming shell: aligns the child's output columns to
    the shell schema by column id (the child may carry extra/hidden cols)."""

    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        child_pos = {sc.col.idx: i for i, sc in enumerate(child.schema.cols)}
        self._sel = [child_pos[sc.col.idx] for sc in plan.schema.cols]

    def next(self):
        ch = self.child.next()
        if ch is None:
            return None
        return Chunk([ch.columns[i] for i in self._sel])


class SelectionExec(Executor):
    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.conds = plan.conds

    def next(self):
        while True:
            ch = self.child.next()
            if ch is None:
                return None
            n = len(ch)
            if n == 0:
                continue
            cols = bind_chunk(self.child.schema, ch)
            ectx = EvalCtx(np, n, cols, host=True)
            mask = np.ones(n, dtype=bool)
            for c in self.conds:
                mask &= np.asarray(eval_bool_mask(ectx, c))
            return ch.filter(mask)


class ProjectionExec(Executor):
    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.exprs = plan.exprs

    def next(self):
        ch = self.child.next()
        if ch is None:
            return None
        n = len(ch)
        cols = bind_chunk(self.child.schema, ch)
        ectx = EvalCtx(np, n, cols, host=True)
        out = [eval_to_column(ectx, e, n) for e in self.exprs]
        return Chunk(out)


class LimitExec(Executor):
    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.offset = plan.offset
        self.count = plan.count
        self._skipped = 0
        self._taken = 0

    def next(self):
        while True:
            if self.count >= 0 and self._taken >= self.count:
                return None
            ch = self.child.next()
            if ch is None:
                return None
            n = len(ch)
            if self._skipped < self.offset:
                skip = min(self.offset - self._skipped, n)
                self._skipped += skip
                ch = ch.slice(skip, n)
                n = len(ch)
                if n == 0:
                    continue
            if self.count >= 0:
                take = min(self.count - self._taken, n)
                ch = ch.slice(0, take)
                self._taken += take
            return ch


def _sort_key_arrays(schema, chunk, items):
    """Build lexsort keys (last = primary). MySQL: NULLs first asc."""
    n = len(chunk)
    cols = bind_chunk(schema, chunk)
    ectx = EvalCtx(np, n, cols, host=True)
    keys = []
    for e, desc in items:
        data, nulls, sdict = eval_expr(ectx, e)
        nm = np.asarray(materialize_nulls(ectx, nulls))
        if np.isscalar(data) or getattr(data, "ndim", 1) == 0:
            data = np.full(n, data if not isinstance(data, str) else 0)
        data = np.asarray(data)
        if sdict is not None:
            from ..expression.vec import _needs_fold, _coll_arg
            # folded ranks: collation-equal spellings share a key value
            # (ci case folds; PAD-SPACE _bin folds trailing spaces), so
            # sort order AND equality (window peers/partitions) both
            # follow the collation
            ranks = sdict.ci_fold_ranks(_coll_arg(e.ft)) \
                if _needs_fold(e.ft) else sdict.ranks()
            data = ranks[data]
        elif data.dtype == object:
            if nm.any():
                # raw Nones don't compare; any placeholder works — the
                # null-order sentinel below overrides these positions
                data = data.copy()
                data[nm] = data[~nm][0] if (~nm).any() else 0
            # dense ranks: EQUAL values must share a rank — these keys
            # also drive window partition/peer boundary equality
            _, inv = np.unique(data, return_inverse=True)
            data = inv.astype(np.int64)
        if data.dtype == bool:
            data = data.astype(np.int64)
        if sdict is None and data.dtype.kind in "iu" and \
                getattr(e.ft, "unsigned", False):
            # unsigned BIGINT above 2^63 stores as wrapped int64: flip
            # the sign bit so uint64 order becomes int64 order (exact,
            # no overflow), and carry NULL order as a SEPARATE lexsort
            # key — the in-band ±_I64_MAX sentinels of the signed path
            # collide with real keys here
            key = data.astype(np.int64) ^ np.int64(-(1 << 63))
            if desc:
                key = ~key                    # order-inverting, safe
                flag = np.where(nm, 1, 0)     # NULLs last on desc
            else:
                flag = np.where(nm, 0, 1)     # NULLs first on asc
            keys.append(flag.astype(np.int64))
            keys.append(key)
            continue
        if desc:
            if data.dtype.kind == "f":
                data = -data
                nullv = np.inf
            else:
                data = -(data.astype(np.int64))
                nullv = _I64_MAX
            data = np.where(nm, nullv, data)      # NULLs last on desc
        else:
            if data.dtype.kind == "f":
                data = np.where(nm, -np.inf, data)
            else:
                data = np.where(nm, -_I64_MAX, data.astype(np.int64))
        keys.append(data)
    return keys


class SortExec(Executor):
    """Sort with spill: when accumulated input exceeds the memory quota,
    chunk payloads spill to disk (reference sortexec/sort_spill.go under the
    memory.Tracker action chain). Final ordering is computed over the sort
    KEY arrays only; payload rows stream back from disk per source chunk
    in sorted order (columnar external sort)."""

    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.items = plan.items
        self._out = None
        self.spilled = False

    def next(self):
        if self._out is None:
            self._fill()
        if not self._out:
            return None
        return self._out.pop(0)

    def _fill(self):
        quota = spill_quota(self.ctx)
        stmt_tr = self.ctx.mem_tracker
        trig = stmt_tr.add_spill_trigger("sort")
        op = stmt_tr.child("sort")
        try:
            self._fill_tracked(quota, op, trig)
        finally:
            stmt_tr.remove_spill_trigger(trig)
            op.detach()

    def _fill_tracked(self, quota, op, trig):
        in_mem = []
        spool = None
        key_parts = []          # per chunk: list of key arrays
        consumed = 0
        while True:
            self.ctx.check_killed()
            ch = self.child.next()
            if ch is None:
                break
            if len(ch) == 0:
                continue
            keys = _sort_key_arrays(self.child.schema, ch, self.items)
            key_parts.append(keys)
            nbytes = _chunk_nbytes(ch)
            consumed += nbytes
            if spool is None:
                # spillable: a statement-quota breach here arms `trig`
                # through the action chain; the operator threshold
                # below keeps the historical half-quota spill point
                op.consume(nbytes, can_spill=True)
            if spool is None and (consumed > quota or trig.armed):
                from ..utils.chunk_disk import ChunkSpool
                spool = ChunkSpool("sort")
                self.spilled = True
                self.ctx.sess.domain.inc_metric("sort_spill_count")
                _metrics.SPILLS.labels("sort").inc()
                for prev in in_mem:
                    spool.append(prev)
                in_mem = []
                # payloads are on disk now: hand the bytes back so the
                # chain sees the relief (keys stay in memory by design
                # — the external sort orders over them)
                op.release(op.consumed)
                trig.done = True
            if spool is not None:
                spool.append(ch)
            else:
                in_mem.append(ch)
        if not key_parts:
            self._out = []
            return
        if spool is None:
            merged = Chunk.concat_all(in_mem)
            keys = [np.concatenate([kp[i] for kp in key_parts])
                    for i in range(len(self.items))]
            order = self._order(keys, len(merged))
            self._out = [merged.take(order)]
            return
        # external path: global order over in-memory keys; gather payload
        # from disk chunk by chunk
        keys = [np.concatenate([kp[i] for kp in key_parts])
                for i in range(len(self.items))]
        order = self._order(keys, sum(spool.rows))
        chunk_of = np.concatenate(
            [np.full(n, i, dtype=np.int64)
             for i, n in enumerate(spool.rows)])
        row_of = np.concatenate(
            [np.arange(n, dtype=np.int64) for n in spool.rows])
        out = []
        batch = max(1, (1 << 20) // max(len(self.schema.cols), 1) // 8)
        batch = max(batch, 65536)
        for s in range(0, len(order), batch):
            sel = order[s:s + batch]
            pieces = []
            src_chunks = chunk_of[sel]
            src_rows = row_of[sel]
            # gather from each source chunk, then restore sorted order
            out_cols = None
            perm = np.argsort(src_chunks, kind="stable")
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            gathered = []
            for ci in np.unique(src_chunks):
                mask = src_chunks[perm] == ci
                rows = src_rows[perm][mask]
                gathered.append(spool.load(int(ci)).take(rows))
            part = Chunk.concat_all(gathered)
            out.append(part.take(inv))
        spool.close()
        self._out = out

    def _order(self, keys, n):
        """Sort permutation: the device's chained stable sorts above the
        size floor (executor/sort_device.py), host np.lexsort otherwise.
        Both are stable, so device == host row order for integer-keyed
        sorts (incl. dict/collation ranks). On the card a degraded
        dispatch fails the statement; on the CPU it takes np.lexsort."""
        copr = self.ctx.copr
        if copr.use_device and keys:
            from .sort_device import device_sort_permutation
            from ..utils import device_guard
            try:
                o = device_guard.guarded_dispatch(
                    lambda: device_sort_permutation(keys, n, copr.device),
                    site="sort", ectx=self.ctx,
                    fallback_is_host=copr.degrade_to_host)
                if o is not None:
                    self.ctx.sess.domain.inc_metric("sort_device")
                    return o
            except device_guard.DeviceDegradedError:
                if not copr.degrade_to_host:
                    raise
                self.ctx.sess.domain.inc_metric("sort_device_error")
        return np.lexsort(list(reversed(keys))) if keys \
            else np.arange(n)


class TopNExec(Executor):
    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.items = plan.items
        self.offset = plan.offset
        self.count = plan.count
        self._out = None

    def next(self):
        if self._out is None:
            k = self.offset + self.count
            best = None   # accumulated candidate chunk
            while True:
                ch = self.child.next()
                if ch is None:
                    break
                if len(ch) == 0:
                    continue
                cand = ch if best is None else best.concat(ch)
                if len(cand) > 4 * max(k, 1024):
                    cand = self._prune(cand, k)
                best = cand
            if best is None:
                self._out = []
            else:
                best = self._prune(best, k)
                self._out = [best.slice(self.offset, len(best))]
        if not self._out:
            return None
        return self._out.pop(0)

    def _prune(self, chunk, k):
        keys = _sort_key_arrays(self.child.schema, chunk, self.items)
        order = np.lexsort(list(reversed(keys)))[:k]
        return chunk.take(order)


class UnionExec(Executor):
    def __init__(self, ctx, plan, children):
        super().__init__(ctx, plan.schema, children)
        self._ci = 0

    def next(self):
        while self._ci < len(self.children):
            ch = self.children[self._ci].next()
            if ch is None:
                self._ci += 1
                continue
            if len(ch) == 0:
                continue
            # align column representations to the union output fts
            cols = []
            for sc, col in zip(self.schema.cols, ch.columns):
                cols.append(_cast_column(col, sc.col.ft))
            return Chunk(cols)
        return None


def _cast_column(col: Column, ft) -> Column:
    """Cast a column to the target field type class (for UNION alignment)."""
    src = col.ft
    if src.tclass == ft.tclass:
        if ft.tclass == TypeClass.DECIMAL and \
                max(src.decimal, 0) != max(ft.decimal, 0):
            k = max(ft.decimal, 0) - max(src.decimal, 0)
            data = col.data * _POW10[k] if k > 0 else col.data // _POW10[-k]
            return Column(ft, data, col.nulls)
        return Column(ft, col.data, col.nulls, col.dict)
    if ft.tclass == TypeClass.FLOAT:
        if src.tclass == TypeClass.DECIMAL:
            return Column(ft, col.data / _POW10[max(src.decimal, 0)], col.nulls)
        if col.dict is None and col.data.dtype != object:
            return Column(ft, col.data.astype(np.float64), col.nulls)
    if ft.tclass == TypeClass.STRING:
        vals = np.array([col.get_py(i) for i in range(len(col))], dtype=object)
        return Column(ft, vals, col.nulls)
    if ft.tclass == TypeClass.DECIMAL and src.tclass in (TypeClass.INT,
                                                         TypeClass.UINT):
        return Column(ft, col.data * _POW10[max(ft.decimal, 0)], col.nulls)
    return Column(ft, col.data, col.nulls, col.dict)


# ---------------- aggregation ----------------

class HashAggExec(Executor):
    """Final/complete aggregation. Final mode merges device partials from
    the reader; complete mode aggregates child chunks on host (numpy).
    Reference: aggregate/agg_hash_executor.go partial/final worker split."""

    def __init__(self, ctx, plan, child):
        super().__init__(ctx, plan.schema, [child])
        self.plan = plan
        self._out = None

    def next(self):
        if self._out is None:
            if self.plan.mode == "final":
                partials = self.children[0].partials()
                self._out = [self._merge_partials(partials)]
            else:
                self._out = [self._complete()]
        if not self._out:
            return None
        return self._out.pop(0)

    # ---- final: merge device partials ----
    def _merge_partials(self, partials):
        plan = self.plan
        ngk = len(plan.group_items)
        if not partials:
            if ngk == 0:
                return self._empty_global()
            return Chunk.empty([sc.col.ft for sc in self.schema.cols])
        live = [p for p in partials if p.ngroups > 0]
        if not live:
            if ngk == 0:
                return self._empty_global()
            return Chunk.empty([sc.col.ft for sc in self.schema.cols])
        key_dicts = live[0].key_dicts
        state_dicts = live[0].state_dicts
        keys = [np.concatenate([p.keys[i] for p in live])
                for i in range(ngk)]
        key_nulls = [np.concatenate([p.key_nulls[i] for p in live])
                     for i in range(ngk)]
        starts = None      # run starts when partial keys arrive sorted
        if ngk:
            kvecs = [np.where(kn, -(1 << 62), k)
                     for k, kn in zip(keys, key_nulls)]
            from ..copr.dag_exec import sorted_run_starts
            starts, change = sorted_run_starts(kvecs)
            if starts is not None:
                # partials over range partitions of a clustered key
                # concatenate in key order: merge by runs, no argsort
                g = len(starts)
                inverse = np.cumsum(change) - 1
                firsts = starts
            else:
                kmat = np.stack(kvecs, axis=1)
                uniq, inverse = np.unique(kmat, axis=0,
                                          return_inverse=True)
                g = len(uniq)
        else:
            g = 1
            inverse = np.zeros(sum(p.ngroups for p in live), dtype=np.int64)
        if starts is None:
            firsts = np.full(g, _I64_MAX, dtype=np.int64)
            np.minimum.at(firsts, inverse, np.arange(len(inverse)))
        out_cols = []
        for i, gi in enumerate(plan.group_items):
            data = keys[i][firsts]
            nulls = key_nulls[i][firsts]
            out_cols.append(Column(gi.ft, data,
                                   nulls if nulls.any() else None,
                                   key_dicts[i]))
        for ai, desc in enumerate(plan.aggs):
            st = [np.concatenate([p.states[ai][si] for p in live])
                  for si in range(len(live[0].states[ai]))]
            out_cols.append(self._finalize(desc, st, inverse, g,
                                           state_dicts[ai], starts))
        return Chunk(out_cols)

    def _empty_global(self):
        """Global agg over zero rows: one row of NULLs / COUNT 0."""
        cols = []
        for desc, sc in zip(self.plan.aggs, self.schema.cols):
            if desc.name == "count":
                cols.append(Column(sc.col.ft, np.zeros(1, dtype=np.int64)))
            else:
                cols.append(Column(sc.col.ft, np.zeros(1, dtype=np.int64),
                                   np.ones(1, dtype=bool)))
        return Chunk(cols)

    def _finalize(self, desc, states, inverse, g, sdict, starts=None):
        name = desc.name
        ft = desc.ft

        def seg_add(vals, out_dtype=None):
            if starts is not None:
                return np.add.reduceat(vals, starts)
            o = np.zeros(g, dtype=out_dtype or vals.dtype)
            np.add.at(o, inverse, vals)
            return o

        if name == "count":
            return Column(ft, seg_add(states[0]))
        if name in ("sum", "avg"):
            s = seg_add(states[0])
            cnt = seg_add(states[1])
            if name == "sum":
                arg_ft = desc.args[0].ft if desc.args else ft
                data = self._sum_to_ft(s, arg_ft, ft)
                return Column(ft, data, (cnt == 0) if (cnt == 0).any() else None)
            return self._avg(s, cnt, desc)
        if name in ("min", "max"):
            ident = (np.inf if states[0].dtype.kind == "f" else _I64_MAX)
            if name == "max":
                ident = -ident if states[0].dtype.kind == "f" else -_I64_MAX
            if starts is not None:
                red = np.minimum if name == "min" else np.maximum
                s = red.reduceat(states[0], starts)
            else:
                s = np.full(g, ident, dtype=states[0].dtype)
                if name == "min":
                    np.minimum.at(s, inverse, states[0])
                else:
                    np.maximum.at(s, inverse, states[0])
            cnt = seg_add(states[1])
            if sdict is not None:
                # codes were reduced by rank? no — min/max on raw codes is
                # wrong unless dict is sorted; handled by planner keeping
                # string min/max off the push path. Safety: decode here.
                pass
            return Column(ft, s, (cnt == 0) if (cnt == 0).any() else None,
                          sdict)
        if name == "first_row":
            # only partials that SAW a value (cnt>0) may contribute: a
            # cnt=0 partial's value slot is garbage (runs lowering: a
            # gather past the run's end; scatter: row cap-1) — taking
            # min index over all partials returned another group's value
            firsts = np.full(g, _I64_MAX, dtype=np.int64)
            idx = np.arange(len(inverse))
            has = states[1] > 0
            np.minimum.at(firsts, inverse[has], idx[has])
            cnt = np.zeros(g, dtype=np.int64)
            np.add.at(cnt, inverse, states[1])
            data = states[0][np.minimum(firsts, len(states[0]) - 1)]
            return Column(ft, data, (cnt == 0) if (cnt == 0).any() else None,
                          sdict)
        raise UnsupportedError("agg %s merge unsupported", name)

    def _sum_to_ft(self, s, arg_ft, ft):
        if ft.tclass == TypeClass.DECIMAL:
            src_scale = max(arg_ft.decimal, 0) \
                if arg_ft.tclass == TypeClass.DECIMAL else 0
            tgt = max(ft.decimal, 0)
            if s.dtype.kind == "f":
                return np.round(s * _POW10[tgt]).astype(np.int64)
            return s * _POW10[tgt - src_scale] if tgt >= src_scale else \
                s // _POW10[src_scale - tgt]
        if ft.tclass == TypeClass.FLOAT and s.dtype.kind != "f":
            return s.astype(np.float64)
        return s

    def _avg(self, s, cnt, desc):
        ft = desc.ft
        arg_ft = desc.args[0].ft if desc.args else ft
        g = len(s)
        nulls = cnt == 0
        safe = np.where(nulls, 1, cnt)
        if ft.tclass == TypeClass.DECIMAL:
            tgt = max(ft.decimal, 0)
            src = max(arg_ft.decimal, 0) \
                if arg_ft.tclass == TypeClass.DECIMAL else 0
            out = np.zeros(g, dtype=np.int64)
            for i in range(g):     # groups are few; exact host division
                if nulls[i]:
                    continue
                num = int(s[i]) * _POW10[tgt - src] if tgt >= src \
                    else int(s[i]) // _POW10[src - tgt]
                c = int(safe[i])
                q, r = divmod(abs(num), c)
                if 2 * r >= c:
                    q += 1
                out[i] = q if num >= 0 else -q
            return Column(ft, out, nulls if nulls.any() else None)
        out = s.astype(np.float64) / safe
        return Column(ft, out, nulls if nulls.any() else None)

    # ---- complete: host aggregation over child chunks ----
    _DECOMPOSABLE = frozenset({"count", "sum", "avg", "min", "max",
                               "first_row"})

    def _complete(self):
        from ..copr.dag_exec import _host_partial_agg
        plan = self.plan
        if any(d.distinct or d.name not in self._DECOMPOSABLE
               for d in plan.aggs):
            # non-decomposable aggs (group_concat, stddev family, bit_*,
            # json_*agg, percentiles) need all rows of a group together
            return self._complete_distinct()

        class _FakeDag:
            filters = []
            host_filters = []
            group_items = plan.group_items
            aggs = plan.aggs
        partials = []
        shared_dicts = {}
        while True:
            ch = self.child.next()
            if ch is None:
                break
            n = len(ch)
            if n == 0:
                continue
            cols = bind_chunk(self.child.schema, ch)
            ectx = EvalCtx(np, n, cols, host=True)
            partials.append(_host_partial_agg(ectx, _FakeDag,
                                              np.ones(n, dtype=bool),
                                              shared_dicts=shared_dicts))
        return self._merge_partials(partials)

    def _complete_distinct(self):
        """DISTINCT aggs: materialize (group key, arg) pairs, dedup, then
        aggregate (reference agg fallback path for distinct). Oversized
        grouped inputs grace-partition to disk by group-key hash
        (reference agg_spill.go) — a group never spans partitions, so each
        partition aggregates independently."""
        plan = self.plan
        quota = spill_quota(self.ctx)
        stmt_tr = self.ctx.mem_tracker
        # grace partitioning needs group keys (a group never spans
        # partitions): an ungrouped DISTINCT agg has no spill path, so
        # its consumption is non-spillable — over quota it cancels
        can_spill = bool(plan.group_items)
        trig = stmt_tr.add_spill_trigger("agg") if can_spill else None
        op = stmt_tr.child("agg")
        try:
            chunks = _tracked_chunks(self.child, op, self.ctx,
                                     can_spill=can_spill)
            if can_spill and (op.consumed > quota or trig.armed):
                trig.done = True
                return self._distinct_spill(chunks)
            merged = Chunk.concat_all(chunks)
            return self._distinct_of(merged)
        finally:
            if trig is not None:
                stmt_tr.remove_spill_trigger(trig)
            op.detach()

    def _distinct_spill(self, chunks, nparts=8):
        from ..utils.chunk_disk import ChunkSpool
        self.ctx.sess.domain.inc_metric("agg_spill_count")
        _metrics.SPILLS.labels("agg").inc()
        plan = self.plan
        spools = [ChunkSpool(f"agg_d{i}") for i in range(nparts)]
        for ch in chunks:
            if not len(ch):
                continue
            cols = bind_chunk(self.child.schema, ch)
            ectx = EvalCtx(np, len(ch), cols, host=True)
            h = np.zeros(len(ch), dtype=np.uint64)
            for g in plan.group_items:
                d, nl, sd = eval_expr(ectx, g)
                if np.isscalar(d):
                    d = np.full(len(ch), d)
                nm = np.asarray(materialize_nulls(ectx, nl))
                k = np.where(nm, -(1 << 62),
                             np.asarray(d).astype(np.int64))
                h = h * np.uint64(0x9E3779B97F4A7C15) + k.astype(np.uint64)
            part = (h % np.uint64(nparts)).astype(np.int64)
            for i in range(nparts):
                sub = ch.filter(part == i)
                if len(sub):
                    spools[i].append(sub)
        results = []
        for sp in spools:
            part = Chunk.concat_all([sp.load(j)
                                     for j in range(sp.num_chunks)])
            sp.close()
            if part is not None and len(part):
                results.append(self._distinct_of(part))
        out = Chunk.concat_all(results)
        return out if out is not None else Chunk.empty(
            [sc.col.ft for sc in self.schema.cols])

    def _distinct_of(self, merged):
        plan = self.plan
        ngk = len(plan.group_items)
        if merged is None:
            if ngk == 0:
                return self._empty_global()
            return Chunk.empty([sc.col.ft for sc in self.schema.cols])
        n = len(merged)
        cols = bind_chunk(self.child.schema, merged)
        ectx = EvalCtx(np, n, cols, host=True)
        gkeys = []
        gdicts = []
        for g in plan.group_items:
            d, nl, sd = eval_expr(ectx, g)
            nm = np.asarray(materialize_nulls(ectx, nl))
            if np.isscalar(d):
                d = np.full(n, d)
            gkeys.append(np.where(nm, -(1 << 62), np.asarray(d, dtype=np.int64)))
            gdicts.append(sd)
        if ngk:
            kmat = np.stack(gkeys, axis=1)
            uniq, inverse = np.unique(kmat, axis=0, return_inverse=True)
            g = len(uniq)
        else:
            g = 1
            inverse = np.zeros(n, dtype=np.int64)
        firsts = np.full(g, _I64_MAX, dtype=np.int64)
        np.minimum.at(firsts, inverse, np.arange(n))
        out_cols = []
        for i, gi in enumerate(plan.group_items):
            data, nl, sd = eval_expr(ectx, gi)
            if np.isscalar(data):
                data = np.full(n, data)
            nm = np.asarray(materialize_nulls(ectx, nl))
            out_cols.append(Column(gi.ft, np.asarray(data)[firsts],
                                   nm[firsts] if nm.any() else None, sd))
        for desc in plan.aggs:
            out_cols.append(self._one_agg_complete(desc, ectx, inverse, g, n))
        return Chunk(out_cols)

    def _one_agg_complete(self, desc, ectx, inverse, g, n):
        if desc.args:
            d, nl, sd = eval_expr(ectx, desc.args[0])
            if np.isscalar(d):
                d = np.full(n, d)
            d = np.asarray(d)
            nm = np.asarray(materialize_nulls(ectx, nl))
        else:
            d = np.ones(n, dtype=np.int64)
            nm = np.zeros(n, dtype=bool)
            sd = None
        ok = ~nm
        if desc.distinct:
            if d.dtype == object:
                raise UnsupportedError("DISTINCT over raw strings")
            pairs = np.stack([inverse[ok].astype(np.int64),
                              d[ok].astype(np.int64)], axis=1)
            uniqp = np.unique(pairs, axis=0)
            inv2 = uniqp[:, 0]
            vals = uniqp[:, 1]
        else:
            inv2 = inverse[ok]
            vals = d[ok]
        name = desc.name
        ft = desc.ft
        cnt = np.zeros(g, dtype=np.int64)
        np.add.at(cnt, inv2, 1)
        if name == "count":
            return Column(ft, cnt)
        if name in ("sum", "avg"):
            s = np.zeros(g, dtype=vals.dtype if vals.dtype.kind == "f"
                         else np.int64)
            np.add.at(s, inv2, vals)
            if name == "sum":
                arg_ft = desc.args[0].ft
                return Column(ft, self._sum_to_ft(s, arg_ft, ft),
                              (cnt == 0) if (cnt == 0).any() else None)
            return self._avg(s, cnt, desc)
        if name in ("min", "max"):
            if sd is not None:
                ranks = sd.ranks()
                rv = ranks[vals]
                ident = _I64_MAX if name == "min" else -_I64_MAX
                s = np.full(g, ident, dtype=np.int64)
                if name == "min":
                    np.minimum.at(s, inv2, rv)
                else:
                    np.maximum.at(s, inv2, rv)
                # map rank back to code
                rank_to_code = np.argsort(ranks)
                codes = rank_to_code[np.clip(s, 0, len(ranks) - 1)] \
                    if len(ranks) else np.zeros(g, dtype=np.int64)
                return Column(ft, codes.astype(np.int32),
                              (cnt == 0) if (cnt == 0).any() else None, sd)
            ident = (np.inf if vals.dtype.kind == "f" else _I64_MAX)
            if name == "max":
                ident = -ident
            s = np.full(g, ident, dtype=vals.dtype)
            if name == "min":
                np.minimum.at(s, inv2, vals)
            else:
                np.maximum.at(s, inv2, vals)
            return Column(ft, s, (cnt == 0) if (cnt == 0).any() else None)
        if name == "first_row":
            fi = np.full(g, _I64_MAX, dtype=np.int64)
            np.minimum.at(fi, inv2, np.nonzero(ok)[0] if len(vals) != n
                          else np.arange(n)[ok])
            fi = np.minimum(fi, max(n - 1, 0))
            return Column(ft, d[fi], (cnt == 0) if (cnt == 0).any() else None,
                          sd)
        if name == "group_concat":
            out = np.empty(g, dtype=object)
            sep = desc.separator
            strs = (np.asarray([sd.values[c] for c in vals], dtype=object)
                    if sd is not None else vals.astype(str))
            order_keys = None
            if desc.order_by:
                okeys = []
                for e, dsc in desc.order_by:
                    od, onl, osd = eval_expr(ectx, e)
                    if np.isscalar(od):
                        od = np.full(n, od)
                    od = np.asarray(od)
                    if osd is not None:
                        od = osd.ranks()[od]
                    od = od[np.nonzero(~nm)[0]] if desc.distinct is False \
                        else od[np.nonzero(~nm)[0]]
                    okeys.append(-od if dsc else od)
                order_keys = np.lexsort(list(reversed(okeys)))
                inv_sorted = inv2[order_keys]
                strs_sorted = strs[order_keys]
            else:
                inv_sorted, strs_sorted = inv2, strs
            for gi in range(g):
                out[gi] = sep.join(strs_sorted[inv_sorted == gi])
            return Column(ft, out, (cnt == 0) if (cnt == 0).any() else None)
        if name in ("bit_and", "bit_or", "bit_xor"):
            iv = vals.astype(np.int64)
            if name == "bit_and":
                s = np.full(g, -1, dtype=np.int64)     # ~0 identity
                np.bitwise_and.at(s, inv2, iv)
            elif name == "bit_or":
                s = np.zeros(g, dtype=np.int64)
                np.bitwise_or.at(s, inv2, iv)
            else:
                s = np.zeros(g, dtype=np.int64)
                np.bitwise_xor.at(s, inv2, iv)
            return Column(ft, s)
        if name in ("std", "stddev", "stddev_pop", "var_pop", "variance",
                    "stddev_samp", "var_samp"):
            fv = vals.astype(np.float64)
            s1 = np.zeros(g)
            s2 = np.zeros(g)
            np.add.at(s1, inv2, fv)
            np.add.at(s2, inv2, fv * fv)
            c = np.maximum(cnt, 1).astype(np.float64)
            mean = s1 / c
            if name in ("stddev_samp", "var_samp"):
                denom = np.maximum(cnt - 1, 1).astype(np.float64)
                var = np.maximum(s2 - c * mean * mean, 0) / denom
                nulls = cnt <= 1
            else:
                var = np.maximum(s2 / c - mean * mean, 0)
                nulls = cnt == 0
            out = np.sqrt(var) if name in ("std", "stddev", "stddev_pop",
                                           "stddev_samp") else var
            return Column(ft, out, nulls if nulls.any() else None)
        if name == "approx_count_distinct":
            # exact on a single node (reference: HyperLogLog sketch)
            if vals.dtype.kind == "f":
                iv = vals.view(np.int64)    # bit pattern keeps distinctness
            elif vals.dtype == object:
                raise UnsupportedError(
                    "approx_count_distinct over raw strings")
            else:
                iv = vals.astype(np.int64)
            pairs = np.stack([inv2.astype(np.int64), iv], axis=1)
            uniqp = np.unique(pairs, axis=0)
            s = np.zeros(g, dtype=np.int64)
            np.add.at(s, uniqp[:, 0], 1)
            return Column(ft, s)
        if name == "approx_percentile":
            from ..expression import Constant as _C
            if len(desc.args) > 1 and not isinstance(desc.args[1], _C):
                raise UnsupportedError(
                    "approx_percentile percent must be a constant")
            pct = int(desc.args[1].value.val) if len(desc.args) > 1 else 50
            if not (0 <= pct <= 100):
                raise TiDBError(
                    "Percentage value %d is out of range [0, 100]", pct)
            out = np.zeros(g, dtype=np.float64)
            for gi in range(g):
                gv = vals[inv2 == gi]
                out[gi] = np.percentile(gv.astype(np.float64), pct) \
                    if len(gv) else 0.0
            data = out.astype(np.int64) if ft.tclass != TypeClass.FLOAT \
                else out
            return Column(ft, data,
                          (cnt == 0) if (cnt == 0).any() else None)
        if name in ("json_arrayagg", "json_objectagg"):
            import json as _json
            if desc.distinct:
                raise UnsupportedError("DISTINCT is not supported in %s",
                                       name)

            def render(arr, nulls, sdict):
                out = []
                for i in range(len(arr)):
                    if nulls[i]:
                        out.append(None)
                    elif sdict is not None:
                        out.append(sdict.values[int(arr[i])])
                    elif arr.dtype == object:
                        out.append(str(arr[i]))
                    elif arr.dtype.kind == "f":
                        out.append(float(arr[i]))
                    else:
                        out.append(int(arr[i]))
                return out
            # MySQL includes NULL values: aggregate over ALL group rows
            pv = render(d, nm, sd)
            out = np.empty(g, dtype=object)
            if name == "json_arrayagg":
                for gi in range(g):
                    out[gi] = _json.dumps(
                        [v for v, iv in zip(pv, inverse) if iv == gi])
            else:
                d2, nl2, sd2 = eval_expr(ectx, desc.args[1])
                if np.isscalar(d2):
                    d2 = np.full(n, d2)
                d2 = np.asarray(d2)
                nm2 = np.asarray(materialize_nulls(ectx, nl2))
                pv2 = render(d2, nm2, sd2)
                for gi in range(g):
                    # NULL keys are an error in MySQL; skip them here
                    out[gi] = _json.dumps(
                        {str(k): v for k, v, km, iv in
                         zip(pv, pv2, nm, inverse)
                         if iv == gi and not km})
            gcnt = np.zeros(g, dtype=np.int64)
            np.add.at(gcnt, inverse, 1)
            return Column(ft, out,
                          (gcnt == 0) if (gcnt == 0).any() else None)
        raise UnsupportedError("agg %s unsupported", name)


# ---------------- hash join ----------------

def _void_view(mat: np.ndarray):
    m = np.ascontiguousarray(mat)
    return m.view([("", m.dtype)] * m.shape[1]).ravel()


class HashJoinExec(Executor):
    """Sort/partition-based equi-join on host numpy (reference
    HashJoinV2Exec hash_join_v2.go:608; device radix-partition variant is
    the ops/ roadmap). Build side hashed (sorted), probe side streamed."""

    def __init__(self, ctx, plan, left, right):
        super().__init__(ctx, plan.schema, [left, right])
        self.plan = plan
        self._out = None

    def _keys_of(self, schema, chunk, exprs, shared_dicts,
                 want_col_nulls=False):
        n = len(chunk)
        cols = bind_chunk(schema, chunk)
        ectx = EvalCtx(np, n, cols, host=True)
        keys = np.empty((n, len(exprs)), dtype=np.int64)
        col_nulls = np.zeros((n, len(exprs)), dtype=bool) \
            if want_col_nulls else None
        nulls = np.zeros(n, dtype=bool)
        for j, e in enumerate(exprs):
            d, nl, sd = eval_expr(ectx, e)
            nm = np.asarray(materialize_nulls(ectx, nl))
            if np.isscalar(d):
                d = np.full(n, d)
            d = np.asarray(d)
            if sd is not None:
                if shared_dicts[j] is None:
                    shared_dicts[j] = sd
                if shared_dicts[j] is not sd:
                    trans = np.array(
                        [shared_dicts[j].encode_one(v) for v in sd.values]
                        or [0], dtype=np.int64)
                    d = trans[d]
            elif d.dtype == object:
                if shared_dicts[j] is None:
                    shared_dicts[j] = StringDict()
                d = shared_dicts[j].encode(d).astype(np.int64)
            elif d.dtype.kind == "f":
                d = d.view(np.int64)   # bitwise equality for floats
            elif e.ft.tclass == TypeClass.DECIMAL:
                d = d.astype(np.int64)
            keys[:, j] = d.astype(np.int64)
            if col_nulls is not None:
                col_nulls[:, j] = nm
            nulls |= nm
        if want_col_nulls:
            return keys, nulls, col_nulls
        return keys, nulls

    def _align_key_fts(self):
        """Rescale decimal join keys to a common scale per pair."""
        eq = self.plan.eq_conds
        lex, rex = [], []
        for l, r in eq:
            lft, rft = l.ft, r.ft
            le, re_ = l, r
            if lft.tclass == TypeClass.DECIMAL or rft.tclass == TypeClass.DECIMAL:
                sa = max(lft.decimal, 0) if lft.tclass == TypeClass.DECIMAL else 0
                sb = max(rft.decimal, 0) if rft.tclass == TypeClass.DECIMAL else 0
                s = max(sa, sb)
                from ..types.field_type import new_decimal_type
                from ..expression import ScalarFunc
                if sa != s or lft.tclass != TypeClass.DECIMAL:
                    le = ScalarFunc("cast_decimal", [l], new_decimal_type(38, s))
                if sb != s or rft.tclass != TypeClass.DECIMAL:
                    re_ = ScalarFunc("cast_decimal", [r], new_decimal_type(38, s))
            lex.append(le)
            rex.append(re_)
        return lex, rex

    def next(self):
        if self._out is None:
            self._out = [self._join()]
        if not self._out:
            return None
        return self._out.pop(0)

    @staticmethod
    def _combine_keys(bk, pk):
        """Multi-key: pack into one int64 when combined ranges fit, else
        fall back to structured void compare."""
        k = bk.shape[1]
        los, spans = [], []
        total_bits = 0
        for j in range(k):
            lo = min(bk[:, j].min(initial=0), pk[:, j].min(initial=0))
            hi = max(bk[:, j].max(initial=0), pk[:, j].max(initial=0))
            span = int(hi) - int(lo) + 1
            los.append(int(lo))
            spans.append(span)
            total_bits += max(span, 1).bit_length()
        if total_bits <= 62:
            bv = np.zeros(len(bk), dtype=np.int64)
            pv = np.zeros(len(pk), dtype=np.int64)
            for j in range(k):
                bv = bv * spans[j] + (bk[:, j] - los[j])
                pv = pv * spans[j] + (pk[:, j] - los[j])
            return bv, pv
        return _void_view(bk), _void_view(pk)

    def _push_runtime_filter(self, plan, build_exec, build_chunks,
                             probe_exec):
        """Build-side key bounds pushed into the probe scan (reference
        pkg/planner/core/runtime_filter_generator.go — there planned
        into TiFlash scans; here applied at execution, when the build
        values are KNOWN, onto the probe TableReader's device filters).
        Only join types whose probe side emits nothing without a match
        (inner/semi) can filter the probe; only bare int columns keyed
        on a plain reader qualify — everything else just runs as-is."""
        if plan.join_type not in ("inner", "semi") or not plan.eq_conds \
                or getattr(plan, "null_aware", False):
            return
        reader = probe_exec
        while not isinstance(reader, TableReaderExec):
            inner = getattr(reader, "inner", None)   # TimedExec wrapper
            if inner is not None:
                reader = inner
                continue
            return
        if reader.dag.aggs or reader.dag.group_items:
            return
        from ..expression import ScalarFunc, const_from_py
        Column = ExprCol
        dag_idxs = {sc.col.idx: sc.col for sc in reader.dag.cols}
        build_schema = self.children[plan.build_side].schema
        new_filters = []
        for a, b in plan.eq_conds:
            probe_e, build_e = (a, b) if plan.build_side == 1 else (b, a)
            if not isinstance(probe_e, Column) or \
                    probe_e.idx not in dag_idxs:
                continue
            col = dag_idxs[probe_e.idx]
            # BOTH sides must be plain ints: a DECIMAL build key
            # evaluates to scaled ints (value * 10^scale) on host, and
            # pushing those against an unscaled probe column would
            # filter out every real match
            if col.ft.tclass not in (TypeClass.INT, TypeClass.UINT) or \
                    build_e.ft is None or \
                    build_e.ft.tclass not in (TypeClass.INT,
                                              TypeClass.UINT):
                continue
            vals = []
            for ch in build_chunks:
                cols = bind_chunk(build_schema, ch)
                ectx = EvalCtx(np, len(ch), cols, host=True)
                d, nl, sd = eval_expr(ectx, build_e)
                if sd is not None:
                    vals = None
                    break
                nm = np.asarray(materialize_nulls(ectx, nl))
                arr = np.asarray(d)
                if arr.dtype.kind not in "iu":
                    vals = None
                    break
                vals.append(arr[~nm] if nm.any() else arr)
            if vals is None or not vals:
                continue
            allv = np.concatenate(vals)
            if not len(allv):
                continue
            uniq = np.unique(allv)
            if len(uniq) <= 512:
                new_filters.append(ScalarFunc(
                    "in", [col] + [const_from_py(int(v), col.ft)
                                   for v in uniq.tolist()],
                    new_bigint_type()))
            else:
                new_filters.append(ScalarFunc(
                    ">=", [col, const_from_py(int(allv.min()), col.ft)],
                    new_bigint_type()))
                new_filters.append(ScalarFunc(
                    "<=", [col, const_from_py(int(allv.max()), col.ft)],
                    new_bigint_type()))
        if new_filters:
            import dataclasses
            reader.dag = dataclasses.replace(
                reader.dag, filters=reader.dag.filters + new_filters)
            self.ctx.sess.domain.inc_metric("runtime_filter_pushed")

    def _join(self):
        """Collect inputs; in-memory join, or grace hash partitioning to
        disk when the inputs exceed the memory quota (reference
        hash_join_spill.go recursive-partition spill)."""
        plan = self.plan
        build_exec = self.children[plan.build_side]
        probe_exec = self.children[1 - plan.build_side]
        quota = spill_quota(self.ctx)
        stmt_tr = self.ctx.mem_tracker
        # grace hash partitioning needs equality keys: a cross/NA join
        # has no spill path, so its consumption is non-spillable —
        # over quota it cancels instead of silently overrunning
        can_spill = bool(plan.eq_conds) and \
            not getattr(plan, "null_aware", False)
        trig = stmt_tr.add_spill_trigger("join") if can_spill else None
        op = stmt_tr.child("join")
        try:
            build_chunks = _tracked_chunks(build_exec, op, self.ctx,
                                           can_spill=can_spill)
            # runtime filter (reference runtime_filter_generator.go):
            # the build side ran first — derive key bounds (or a small
            # IN set) and push them into the probe side's device scan
            # BEFORE it runs
            self._push_runtime_filter(plan, build_exec, build_chunks,
                                      probe_exec)
            probe_chunks = _tracked_chunks(probe_exec, op, self.ctx,
                                           can_spill=can_spill)
            if can_spill and (op.consumed > quota or trig.armed):
                trig.done = True
                return self._grace_join(build_chunks, probe_chunks)
            build = Chunk.concat_all(build_chunks)
            probe = Chunk.concat_all(probe_chunks)
            return self._join_pair(build, probe)
        finally:
            if trig is not None:
                stmt_tr.remove_spill_trigger(trig)
            op.detach()

    def _grace_join(self, build_chunks, probe_chunks, nparts=8):
        from ..utils.chunk_disk import ChunkSpool
        plan = self.plan
        self.ctx.sess.domain.inc_metric("join_spill_count")
        _metrics.SPILLS.labels("join").inc()
        build_exec = self.children[plan.build_side]
        probe_exec = self.children[1 - plan.build_side]
        lex, rex = self._align_key_fts()
        build_keys_e = lex if plan.build_side == 0 else rex
        probe_keys_e = rex if plan.build_side == 0 else lex
        shared = [None] * len(plan.eq_conds)
        bspools = [ChunkSpool(f"join_b{i}") for i in range(nparts)]
        pspools = [ChunkSpool(f"join_p{i}") for i in range(nparts)]

        def partition(chunks, schema, key_exprs, spools):
            for ch in chunks:
                if not len(ch):
                    continue
                keys, nulls = self._keys_of(schema, ch, key_exprs, shared)
                h = np.zeros(len(ch), dtype=np.uint64)
                for j in range(keys.shape[1]):
                    h = h * np.uint64(0x9E3779B97F4A7C15) + \
                        keys[:, j].astype(np.uint64)
                part = (h % np.uint64(nparts)).astype(np.int64)
                part[nulls] = 0
                for i in range(nparts):
                    sub = ch.filter(part == i)
                    if len(sub):
                        spools[i].append(sub)
        partition(build_chunks, build_exec.schema, build_keys_e, bspools)
        partition(probe_chunks, probe_exec.schema, probe_keys_e, pspools)
        results = []
        for i in range(nparts):
            b = Chunk.concat_all([bspools[i].load(j)
                                  for j in range(bspools[i].num_chunks)])
            p = Chunk.concat_all([pspools[i].load(j)
                                  for j in range(pspools[i].num_chunks)])
            bspools[i].close()
            pspools[i].close()
            if p is None:
                continue
            results.append(self._join_pair(b, p))
        out = Chunk.concat_all(results)
        return out if out is not None else Chunk.empty(
            [sc.col.ft for sc in self.schema.cols])

    def _join_pair(self, build, probe):
        plan = self.plan
        build_exec = self.children[plan.build_side]
        probe_exec = self.children[1 - plan.build_side]
        out_fts = [sc.col.ft for sc in self.schema.cols]
        lex, rex = self._align_key_fts()
        build_keys_e = lex if plan.build_side == 0 else rex
        probe_keys_e = rex if plan.build_side == 0 else lex

        jt = plan.join_type
        outer = (jt == "left" and plan.build_side == 1) or \
                (jt == "right" and plan.build_side == 0)

        if probe is None:
            return Chunk.empty(out_fts)
        if build is None:
            if outer or jt == "anti":
                return self._emit(probe, np.arange(len(probe)), None, None)
            return Chunk.empty(out_fts)

        if not plan.eq_conds:
            # cartesian: pair every probe row with every build row
            nb, np_ = len(build), len(probe)
            bi = np.tile(np.arange(nb), np_)
            pi = np.repeat(np.arange(np_), nb)
            if plan.other_conds:
                mask = self._pair_conds_mask(probe, pi, build, bi)
                pi, bi = pi[mask], bi[mask]
                if outer:
                    matched = np.zeros(len(probe), dtype=bool)
                    matched[pi] = True
                    un = np.nonzero(~matched)[0]
                    if len(un):
                        inner = self._emit(probe, pi, build, bi)
                        return inner.concat(self._emit(probe, un, None, None))
            if jt in ("semi", "anti"):
                return self._semi_result(probe, pi, jt)
            return self._emit(probe, pi, build, bi)

        naaj = jt == "anti" and getattr(plan, "null_aware", False)
        naaj_corr = getattr(plan, "naaj_corr", 0) if naaj else 0
        if naaj_corr:
            # dispatch BEFORE the generic key pass: the correlated
            # null-aware path needs per-column null masks and its own
            # set tests
            return self._naaj_correlated(
                plan, probe, build, build_exec, probe_exec,
                build_keys_e, probe_keys_e, naaj_corr)
        shared = [None] * len(plan.eq_conds)
        bk, bnull = self._keys_of(build_exec.schema, build, build_keys_e,
                                  shared)
        pk, pnull = self._keys_of(probe_exec.schema, probe, probe_keys_e,
                                  shared)
        if bk.shape[1] == 1:
            # single-key: plain int64 compare (structured/void compares are
            # ~100x slower in searchsorted)
            bv = bk[:, 0]
            pv = pk[:, 0]
        else:
            bv, pv = self._combine_keys(bk, pk)

        if naaj and bnull.any():
            # inner side contains NULL: x NOT IN S is FALSE (match) or
            # NULL (no match) for every x -> empty result
            return Chunk.empty(out_fts)

        mode = str(self.ctx.sv.get("tidb_join_exec"))
        copr = self.ctx.copr
        use_device = (mode == "device" or
                      (mode == "auto" and copr.device.type == "cuda"))
        if use_device and not naaj and bv.dtype == np.int64 \
                and pv.dtype == np.int64 and not plan.other_conds:
            from ..utils import device_guard
            try:
                return device_guard.guarded_dispatch(
                    lambda: self._device_join(jt, outer, probe, build, bv,
                                              bnull, pv, pnull),
                    site="join", ectx=self.ctx,
                    fallback_is_host=copr.degrade_to_host)
            except device_guard.DeviceDegradedError:
                # on the card the statement fails; on the CPU the host
                # join below is always correct
                if not copr.degrade_to_host:
                    raise
                self.ctx.sess.domain.inc_metric("device_join_fallback")
        if len(bv) and bv.dtype.kind != "V" and \
                (len(bv) == 1 or bool(np.all(bv[:-1] <= bv[1:]))):
            # pre-sorted build keys (clustered-PK scans, grouped-agg
            # outputs): O(n) check beats the O(n log n) argsort
            border = np.arange(len(bv))
            sbv = bv
        else:
            border = np.argsort(bv, kind="stable")
            sbv = bv[border]
        if len(sbv) and sbv.dtype.kind != "V" and \
                (len(sbv) == 1 or bool(np.all(sbv[1:] > sbv[:-1]))):
            # (void-packed multi-keys have no ufunc '>': they take the
            # range-expansion path below, whose searchsorted handles
            # structured compares)
            # unique build keys (PK/unique-index side — the common case):
            # one binary search + equality check replaces the second
            # searchsorted and the whole range-expansion machinery
            lo = np.searchsorted(sbv, pv, side="left")
            loc = np.minimum(lo, len(sbv) - 1)
            matched = (sbv[loc] == pv) & ~pnull
            if bnull.any():
                matched &= ~bnull[border[loc]]
            pi = np.nonzero(matched)[0]
            bi = border[loc[matched]]
        else:
            lo = np.searchsorted(sbv, pv, side="left")
            hi = np.searchsorted(sbv, pv, side="right")
            pi, pos = _expand_ranges(lo, hi, pnull)
            bi = border[pos]
            # exclude null build keys (they sit grouped; NULL keys coerce
            # to 0 and may collide with real 0 keys, so filter matches)
            if bnull.any():
                keep = ~bnull[bi]
                pi, bi = pi[keep], bi[keep]

        # other conditions filter matched pairs
        if plan.other_conds:
            mask = self._pair_conds_mask(probe, pi, build, bi)
            pi, bi = pi[mask], bi[mask]

        if jt in ("semi", "anti"):
            return self._semi_result(probe, pi, jt,
                                     pnull if naaj else None)
        if outer:
            matched = np.zeros(len(probe), dtype=bool)
            matched[pi] = True
            un = np.nonzero(~matched)[0]
            if len(un):
                inner = self._emit(probe, pi, build, bi)
                outer_part = self._emit(probe, un, None, None)
                return inner.concat(outer_part)
        return self._emit(probe, pi, build, bi)

    def _device_join(self, jt, outer, probe, build, bv, bnull, pv,
                     pnull):
        """The join through ops/device_join.py on the domain's device;
        rows emitted as the host join emits them."""
        from ..ops.device_join import device_join_index
        dev = self.ctx.copr.device
        if jt in ("semi", "anti"):
            matched, _ = device_join_index(bv, bnull, pv, pnull, dev,
                                           semi_only=True)
            sel = np.nonzero(matched if jt == "semi" else ~matched)[0]
            out = self._emit(probe, sel, None, None)
        else:
            pi, bi = device_join_index(bv, bnull, pv, pnull, dev)
            out = self._emit(probe, pi, build, bi)
            if outer:
                matched = np.zeros(len(probe), dtype=bool)
                matched[pi] = True
                un = np.nonzero(~matched)[0]
                if len(un):
                    out = out.concat(self._emit(probe, un, None, None))
        self.ctx.sess.domain.inc_metric("device_join")
        return out

    def _pair_conds_mask(self, probe, pi, build, bi):
        """Evaluate plan.other_conds over matched (probe, build) row
        pairs -> boolean keep mask (WHERE semantics: NULL excludes)."""
        joined = self._emit(probe, pi, build, bi, raw=True)
        cols = bind_chunk(self._joined_schema(), joined)
        ectx = EvalCtx(np, len(joined), cols, host=True)
        mask = np.ones(len(joined), dtype=bool)
        for c in self.plan.other_conds:
            mask &= np.asarray(eval_bool_mask(ectx, c))
        return mask

    def _naaj_correlated(self, plan, probe, build, build_exec,
                         probe_exec, build_keys_e, probe_keys_e, ncorr):
        """Correlated null-aware anti join — `x NOT IN (SELECT y FROM s
        WHERE s.k = t.k)` with full 3-valued semantics evaluated PER
        correlation group (reference null-aware anti semi join,
        pkg/planner/core): a probe row survives iff its group S_k is
        empty, or x is non-NULL, matches nothing in S_k, and S_k has
        no NULL y. eq_conds order the correlation keys first; the
        value pair is last."""
        shared = [None] * len(plan.eq_conds)
        bk, _bn, bcn = self._keys_of(build_exec.schema, build,
                                     build_keys_e, shared,
                                     want_col_nulls=True)
        pk, _pn, pcn = self._keys_of(probe_exec.schema, probe,
                                     probe_keys_e, shared,
                                     want_col_nulls=True)
        bcorr_null = bcn[:, :ncorr].any(axis=1)
        pcorr_null = pcn[:, :ncorr].any(axis=1)
        bval_null = bcn[:, -1]
        pval_null = pcn[:, -1]

        def combine(mat):
            return mat[:, 0] if mat.shape[1] == 1 else _void_view(mat)
        bcorr = combine(bk[:, :ncorr])
        pcorr = combine(pk[:, :ncorr])
        valid_b = ~bcorr_null          # NULL corr keys join no group
        if plan.other_conds:
            # residual correlated conditions make the set S_k(t)
            # probe-dependent: expand correlation-matching pairs,
            # keep only pairs where every residual evaluates TRUE
            # (WHERE semantics: NULL excludes), then take the same
            # per-probe 3VL verdict over the surviving pairs
            vb_idx = np.nonzero(valid_b)[0]
            order = np.argsort(bcorr[vb_idx], kind="stable")
            vb_idx = vb_idx[order]
            sb = bcorr[vb_idx]
            lo = np.searchsorted(sb, pcorr, side="left")
            hi = np.searchsorted(sb, pcorr, side="right")
            pi, pos = _expand_ranges(lo, hi, pcorr_null)
            bi = vb_idx[pos]
            mask = self._pair_conds_mask(probe, pi, build, bi)
            pi, bi = pi[mask], bi[mask]
            group_exists = np.zeros(len(probe), dtype=bool)
            group_exists[pi] = True
            group_has_null = np.zeros(len(probe), dtype=bool)
            group_has_null[pi[bval_null[bi]]] = True
            val_eq = (bk[bi, -1] == pk[pi, -1]) & \
                ~bval_null[bi] & ~pval_null[pi]
            matched = np.zeros(len(probe), dtype=bool)
            matched[pi[val_eq]] = True
            keep = (~group_exists) | (~pval_null & ~matched &
                                      ~group_has_null)
            return self._emit(probe, np.nonzero(keep)[0], None, None)
        group_exists = np.isin(pcorr, bcorr[valid_b]) & ~pcorr_null
        group_has_null = np.isin(
            pcorr, bcorr[valid_b & bval_null]) & ~pcorr_null
        full_b = combine(bk)
        full_p = combine(pk)
        ok_b = valid_b & ~bval_null
        matched = np.isin(full_p, full_b[ok_b]) & ~pcorr_null & \
            ~pval_null
        keep = (~group_exists) | (~pval_null & ~matched &
                                  ~group_has_null)
        return self._emit(probe, np.nonzero(keep)[0], None, None)

    def _semi_result(self, probe, pi, jt, exclude_null=None):
        matched = np.zeros(len(probe), dtype=bool)
        matched[pi] = True
        keep = matched if jt == "semi" else ~matched
        if exclude_null is not None:
            # null-aware anti: NULL NOT IN <non-empty S> is NULL -> drop
            keep = keep & ~exclude_null
        sel = np.nonzero(keep)[0]
        return self._emit(probe, sel, None, None)

    def _joined_schema(self):
        plan = self.plan
        left_schema = self.children[0].schema
        right_schema = self.children[1].schema
        from ..planner.schema import Schema
        return Schema(list(left_schema.cols) + list(right_schema.cols))

    def _emit(self, probe, pi, build, bi, raw=False):
        """Assemble output columns in schema order (left cols + right cols).
        probe/build map to left/right depending on build_side."""
        plan = self.plan
        left_exec, right_exec = self.children
        if plan.build_side == 0:
            lchunk, lidx = build, bi
            rchunk, ridx = probe, pi
        else:
            lchunk, lidx = probe, pi
            rchunk, ridx = build, bi
        pieces = {}
        for sch, chunk, idx in ((left_exec.schema, lchunk, lidx),
                                (right_exec.schema, rchunk, ridx)):
            if chunk is None:
                for sc in sch.cols:
                    n = len(pi)
                    pieces[sc.col.idx] = _null_column(sc.col.ft, n)
            else:
                if idx is None:
                    idx = np.arange(0)
                for sc, col in zip(sch.cols, chunk.columns):
                    pieces[sc.col.idx] = col.take(idx)
        if raw:
            schema = self._joined_schema()
            return Chunk([pieces[sc.col.idx] for sc in schema.cols])
        out = []
        for sc in self.schema.cols:
            c = pieces.get(sc.col.idx)
            if c is None:
                c = _null_column(sc.col.ft, len(pi))
            out.append(c)
        return Chunk(out)


class IndexLookupJoinExec(Executor):
    """Index-driven join (reference index_lookup_join.go: outer batches
    feed inner point lookups; no inner scan). The inner side resolves
    through the columnar handle index (clustered PK) or unique-index KV;
    dirty transactions, stale reads and bulk tables fall back to the
    conventional hash join (plan.fallback)."""

    def __init__(self, ctx, plan, outer):
        super().__init__(ctx, plan.schema, [outer])
        self.plan = plan
        self._out = None

    def _eligible(self):
        sess = self.ctx.sess
        tbl = self.plan.inner_dag.table_info
        if self.ctx.read_ts() is not None:
            return False                      # stale read: version rescan
        txn = getattr(sess, "_txn", None)
        if txn is not None and not txn.committed and not txn.aborted and \
                txn.is_dirty():
            return False
        ctab = sess.domain.columnar.tables.get(tbl.id)
        if ctab is None:
            return True                       # empty inner
        if ctab.bulk_rows:
            # bulk rows lack index KV AND may carry colliding arange
            # handles — no index-driven path is trustworthy
            return False
        return True

    def next(self):
        if self._out is None:
            if self._eligible():
                self._out = [self._join()]
            else:
                from .builder import build_executor
                fb = build_executor(self.ctx, self.plan.fallback)
                out = Chunk.concat_all(fb.all_chunks())
                self._out = [out if out is not None else Chunk.empty(
                    [sc.col.ft for sc in self.schema.cols])]
                self.ctx.sess.domain.inc_metric("index_join_fallback")
        if not self._out:
            return None
        return self._out.pop(0)

    def _lookup_handles(self, keys, key_nulls):
        """join key values -> inner row positions (-1 = miss)."""
        sess = self.ctx.sess
        plan = self.plan
        tbl = plan.inner_dag.table_info
        ctab = sess.domain.columnar.tables.get(tbl.id)
        pos = np.full(len(keys), -1, dtype=np.int64)
        if ctab is None:
            return pos, ctab
        if plan.inner_index is None:
            hp = ctab.handle_pos
            del_ts = ctab.delete_ts
            for i, k in enumerate(keys.tolist()):
                if key_nulls[i]:
                    continue
                p = hp.get(k)
                if p is not None and del_ts[p] == 0:
                    pos[i] = p
        else:
            from ..codec.tablecodec import index_key
            from .exec_base import coerce_datum
            mvcc = sess.domain.storage.mvcc
            ts = sess.domain.storage.current_ts()
            cache = {}
            # the index key encoding is TYPED (UINT_FLAG/DURATION_FLAG
            # differ from ints): coerce through the column's field type
            ci = tbl.find_column(plan.inner_index.columns[0])
            for i, k in enumerate(keys.tolist()):
                if key_nulls[i]:
                    continue
                h = cache.get(k)
                if h is None:
                    kk = k + (1 << 64) if (k < 0 and ci.ft.unsigned) else k
                    ik = index_key(tbl.id, plan.inner_index.id,
                                   [coerce_datum(Datum(Kind.INT, kk),
                                                 ci.ft)])
                    v = mvcc.get(ik, ts, ctx=self.ctx.lock_ctx)
                    h = int(v) if v is not None else -1
                    cache[k] = h
                if h >= 0:
                    p = ctab.handle_pos.get(h)
                    if p is not None and ctab.delete_ts[p] == 0:
                        pos[i] = p
        return pos, ctab

    def _join(self):
        plan = self.plan
        sess = self.ctx.sess
        outer_exec = self.children[0]
        sess.domain.inc_metric("index_join_exec")
        parts = []
        out_fts = [sc.col.ft for sc in self.schema.cols]
        while True:
            ch = outer_exec.next()
            if ch is None:
                break
            if not len(ch):
                continue
            parts.append(self._join_batch(ch))
        out = Chunk.concat_all(parts)
        return out if out is not None else Chunk.empty(out_fts)

    def _join_batch(self, ch):
        plan = self.plan
        n = len(ch)
        cols = bind_chunk(self.children[0].schema, ch)
        ectx = EvalCtx(np, n, cols, host=True)
        d, nl, sd = eval_expr(ectx, plan.outer_key)
        if np.isscalar(d):
            d = np.full(n, d)
        keys = np.asarray(d).astype(np.int64)
        knull = np.asarray(materialize_nulls(ectx, nl))
        pos, ctab = self._lookup_handles(keys, knull)
        matched = pos >= 0
        oi = np.nonzero(matched)[0]
        ip = pos[matched]
        # gather inner columns for matched rows; apply residual filters
        inner_cols = {}
        tbl = plan.inner_dag.table_info
        for sc in plan.inner_dag.cols:
            if ctab is None:                # never-written inner table
                inner_cols[sc.col.idx] = _null_column(sc.col.ft, 0)
                continue
            ci = tbl.find_column(sc.name)
            if ci is None:
                inner_cols[sc.col.idx] = Column(
                    sc.col.ft, ctab.handles[ip].copy())
            else:
                inner_cols[sc.col.idx] = ctab.column_for(ci, ip)
        if plan.inner_dag.filters or plan.inner_dag.host_filters:
            ictx = EvalCtx(np, len(oi),
                           {k: (c.data, c.nulls, c.dict)
                            for k, c in inner_cols.items()}, host=True)
            keep = np.ones(len(oi), dtype=bool)
            for f in plan.inner_dag.filters + plan.inner_dag.host_filters:
                keep &= np.asarray(eval_bool_mask(ictx, f))
            oi = oi[keep]
            inner_cols = {k: c.take(np.nonzero(keep)[0])
                          for k, c in inner_cols.items()}
        pieces = {}
        for sc, col in zip(self.children[0].schema.cols, ch.columns):
            pieces[sc.col.idx] = col.take(oi)
        pieces.update(inner_cols)
        if plan.other_conds:
            m = len(oi)
            jctx = EvalCtx(np, m,
                           {k: (c.data, c.nulls, c.dict)
                            for k, c in pieces.items()}, host=True)
            keep = np.ones(m, dtype=bool)
            for c in plan.other_conds:
                keep &= np.asarray(eval_bool_mask(jctx, c))
            kidx = np.nonzero(keep)[0]
            oi = oi[kidx]
            pieces = {k: c.take(kidx) for k, c in pieces.items()}
        rows = [Chunk([self._piece(pieces, sc, len(oi))
                       for sc in self.schema.cols])]
        if plan.join_type == "left":
            um = np.ones(n, dtype=bool)
            um[oi] = False
            ui = np.nonzero(um)[0]
            if len(ui):
                outer_pieces = {
                    sc.col.idx: col.take(ui)
                    for sc, col in zip(self.children[0].schema.cols,
                                       ch.columns)}
                rows.append(Chunk([
                    outer_pieces.get(sc.col.idx) if sc.col.idx
                    in outer_pieces else _null_column(sc.col.ft, len(ui))
                    for sc in self.schema.cols]))
        out = Chunk.concat_all(rows)
        return out if out is not None else Chunk.empty(
            [sc.col.ft for sc in self.schema.cols])

    @staticmethod
    def _piece(pieces, sc, n):
        c = pieces.get(sc.col.idx)
        return c if c is not None else _null_column(sc.col.ft, n)


class MergeJoinExec(Executor):
    """Sort-merge join (reference merge_join.go): both inputs ordered by
    the join key, matched by a linear merge; output arrives in key
    order."""

    def __init__(self, ctx, plan, left, right):
        super().__init__(ctx, plan.schema, [left, right])
        self.plan = plan
        self._out = None

    def next(self):
        if self._out is None:
            self._out = [self._join()]
        if not self._out:
            return None
        return self._out.pop(0)

    def _keys(self, schema, chunk, exprs):
        n = len(chunk)
        cols = bind_chunk(schema, chunk)
        ectx = EvalCtx(np, n, cols, host=True)
        d, nl, sd = eval_expr(ectx, exprs[0])
        if np.isscalar(d):
            d = np.full(n, d)
        d = np.asarray(d)
        if sd is not None:
            d = sd.ranks()[d].astype(np.int64)
        elif d.dtype.kind == "f":
            d = d.view(np.int64)
        else:
            d = d.astype(np.int64)
        return d, np.asarray(materialize_nulls(ectx, nl))

    def _join(self):
        plan = self.plan
        lexec, rexec = self.children
        lchunk = Chunk.concat_all(lexec.all_chunks())
        rchunk = Chunk.concat_all(rexec.all_chunks())
        out_fts = [sc.col.ft for sc in self.schema.cols]
        if lchunk is None or (rchunk is None and plan.join_type != "left"):
            if plan.join_type == "left" and lchunk is not None:
                rchunk = Chunk.empty(
                    [sc.col.ft for sc in rexec.schema.cols])
            else:
                return Chunk.empty(out_fts)
        if rchunk is None:
            rchunk = Chunk.empty([sc.col.ft for sc in rexec.schema.cols])
        lk, lnull = self._keys(lexec.schema, lchunk, [plan.eq_conds[0][0]])
        rk, rnull = self._keys(rexec.schema, rchunk, [plan.eq_conds[0][1]])
        lmask = np.where(lnull, _I64_MAX, lk)
        rmask = np.where(rnull, _I64_MAX, rk)
        lorder = np.argsort(lmask, kind="stable")
        rorder = np.argsort(rmask, kind="stable")
        slk = lmask[lorder]        # masked values stay sorted (NULLs last)
        srk = rmask[rorder]
        # linear merge: per left row, matching right run via searchsorted
        lo = np.searchsorted(srk, slk, side="left")
        hi = np.searchsorted(srk, slk, side="right")
        rvalid = ~rnull[rorder]
        li, ri = _expand_ranges(lo, hi, lnull[lorder])
        keep = rvalid[ri]
        li, ri = li[keep], ri[keep]
        lidx = lorder[li]
        ridx = rorder[ri]
        pieces = {}
        for sc, col in zip(lexec.schema.cols, lchunk.columns):
            pieces[sc.col.idx] = col.take(lidx)
        for sc, col in zip(rexec.schema.cols, rchunk.columns):
            pieces[sc.col.idx] = col.take(ridx)
        if plan.other_conds:
            m = len(lidx)
            jctx = EvalCtx(np, m,
                           {k: (c.data, c.nulls, c.dict)
                            for k, c in pieces.items()}, host=True)
            keepm = np.ones(m, dtype=bool)
            for c in plan.other_conds:
                keepm &= np.asarray(eval_bool_mask(jctx, c))
            kidx = np.nonzero(keepm)[0]
            lidx = lidx[kidx]
            pieces = {k: c.take(kidx) for k, c in pieces.items()}
        rows = [Chunk([pieces.get(sc.col.idx,
                                  _null_column(sc.col.ft, len(lidx)))
                       for sc in self.schema.cols])]
        if plan.join_type == "left":
            um = np.ones(len(lchunk), dtype=bool)
            um[lidx] = False
            ui = np.nonzero(um)[0]
            if len(ui):
                op = {sc.col.idx: col.take(ui)
                      for sc, col in zip(lexec.schema.cols,
                                         lchunk.columns)}
                rows.append(Chunk([
                    op.get(sc.col.idx, _null_column(sc.col.ft, len(ui)))
                    for sc in self.schema.cols]))
        out = Chunk.concat_all(rows)
        return out if out is not None else Chunk.empty(out_fts)



def _expand_ranges(lo, hi, null_mask=None):
    """Ragged searchsorted range-expansion shared by the join probe,
    the correlated NAAJ pair builder, and the merge-join: per probe i,
    emit (pi=i, pos=lo[i]..hi[i]-1). null_mask zeroes those probes.
    -> (pi, pos) index arrays."""
    counts = hi - lo
    if null_mask is not None:
        counts[null_mask] = 0
    total = int(counts.sum())
    pi = np.repeat(np.arange(len(lo)), counts)
    starts = np.repeat(lo, counts)
    base = np.repeat(np.cumsum(counts) - counts, counts)
    return pi, starts + (np.arange(total) - base)

def _null_column(ft, n) -> Column:
    if ft.tclass in (TypeClass.STRING, TypeClass.JSON):
        data = np.empty(n, dtype=object)
        data[:] = ""
        return Column(ft, data, np.ones(n, dtype=bool))
    if ft.tclass == TypeClass.FLOAT:
        return Column(ft, np.zeros(n, dtype=np.float64),
                      np.ones(n, dtype=bool))
    return Column(ft, np.zeros(n, dtype=np.int64), np.ones(n, dtype=bool))
