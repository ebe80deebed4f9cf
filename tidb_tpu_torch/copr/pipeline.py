"""Fused scan->agg device pipeline (reference: tidb_tpu's
copr/pipeline.py, which lowers the operator chain
executor/join/hash_join_v2.go:608 build/probe + tipb partial agg into
one device program per partition), ported to PyTorch on one device.

Design: the fact table streams through in bucketed partitions; rows
that fail a filter simply clear a validity mask, and the partial
aggregation at the tail ignores them. One partition is one fragment
call (a Python callable over tensors, counted as one dispatch), its
result tree is fetched with one sync (utils/fetch.py), and partition
i+1 is dispatched before partition i is consumed.

Ported slice: zero-dimension pipelines (no fused joins) with a dense
group layout (agg_kind "dense": global aggregation, or group keys
whose combined domain is small) and expressions of
expression/torch_ns.TORCH_OPS. That is TPC-H Q6 and Q1, whose filters
and aggregation run through the ops/ scan kernels, routed by the plan's
shape when the body is built:

  one slot, range filters     the filters that copr/range_lowering.py
                              turns into column bounds are tested in
                              ops.range_filter_sums (Q6), with a sum
                              of a product of two columns folded in;
                              the others are ANDed into its valid
                              mask first
  one slot, no range filter   filters -> mask -> ops.masked_sums
  a slot domain               filters -> mask -> ops.dense_group_sums
                              (<= 64 slots, Q1) or the torch scatter

(copr/dag_exec.py's header has the aggregate shapes each kernel takes;
any other falls back, by shape, to the evaluator and the plain torch
reductions.) Every other shape —
dimension probes, posdense/one-hot/sort aggregation, MPP — returns
None with last_fused_reason "not yet ported: ...", and the executor
takes its counted host path, the reference's own way of declining a
fused plan.
"""
from __future__ import annotations

import re

import numpy as np

from ..expression import EvalCtx, eval_expr, eval_bool_mask
from ..expression.vec import materialize_nulls
from ..expression.torch_ns import TORCH_OPS, ops_of
from ..chunk.device import shape_bucket
from .dag_exec import (capture_agg_dicts, _dense_strides, dense_agg_body,
                       dense_agg_states_range, fold_pairs, kernel_aggs_fit,
                       _compact_dense)
from .range_lowering import lower_filters
from ..utils.fetch import prefetch
from ..utils import failpoint
from ..utils import memory as _memory


class _AggShim:
    """Duck-typed dag for capture_agg_dicts/_dense_strides/_host_partial_agg."""

    def __init__(self, group_items, aggs):
        self.group_items = group_items
        self.aggs = aggs


def _cid_of(dag, sc):
    ci = dag.table_info.find_column(sc.name)
    return -1 if ci is None else ci.id


def _set_reason(copr, msg):
    """Record why the fused path declined, for EXPLAIN ANALYZE and
    scripts/diag_routing.py (reference: pkg/util/execdetails). Also
    counted by reason class (tidb_tpu_fused_decline_total) so fleet
    dashboards see decline-mix shifts without per-query EXPLAINs."""
    dom = getattr(copr, "domain", None)
    if dom is not None:
        dom.last_fused_reason = msg
    from ..utils import metrics as _metrics
    _metrics.FUSED_DECLINE.labels(_metrics.reason_code(msg)).inc()


# fragments in flight: partition i+1 dispatches before partition i's
# result is consumed
_PIPELINE_DEPTH = 2


_VOLATILE_RE = re.compile(
    r"rand\(|now\(|current_|sysdate\(|uuid|connection_id\(|sleep\(|"
    r"last_insert_id\(|benchmark\(|@", re.IGNORECASE)


# node types whose semantic content is FULLY captured by explain_info
# plus the per-type extras appended in _plan_fp below. Any other node
# kind refuses fingerprinting (-> no caching) rather than risk two
# different subplans aliasing one cache entry.
_FP_SAFE_NODES = frozenset([
    "PhysTableReader", "PhysFusedPipeline", "PhysHashAgg",
    "PhysHashJoin", "PhysMergeJoin", "PhysSelection", "PhysProjection",
    "PhysShell", "PhysSort", "PhysTopN", "PhysLimit", "PhysUnion",
    "PhysDual", "PhysIndexRange", "PhysIndexMerge", "PhysPointGet",
    "PhysBatchPointGet", "PhysIndexLookupJoin",
    # fragment boundaries are pure pass-throughs: Sender prints
    # type/fragment/keys in explain_info, Receiver's content is its child
    "PhysExchangeSender", "PhysExchangeReceiver",
])


def _plan_fp(plan):
    """Structural fingerprint of a physical plan: node type +
    explain_info (filters/aggs/keys print with literal values) + output
    schema, recursively; -> None when any node's content can't be fully
    pinned. Keys the materialized-dim cache, so under-discrimination
    here would serve one subquery's rows to a different subquery —
    node types append every field their explain_info omits."""
    tname = type(plan).__name__
    if tname not in _FP_SAFE_NODES:
        return None
    parts = [tname, plan.explain_info(),
             ",".join(sc.name or "" for sc in plan.schema.cols)]
    oc = getattr(plan, "other_conds", None)
    if oc:
        parts.append("oc:" + ";".join(map(repr, oc)))
    if getattr(plan, "null_aware", False):
        parts.append("naaj")       # NOT IN vs NOT EXISTS anti semantics
    # explain_info gaps, per node kind:
    if tname == "PhysBatchPointGet":       # prints only len(handles)
        parts.append("h:" + ";".join(map(repr, plan.handles)))
    elif tname == "PhysIndexRange":        # omits residual conjuncts
        parts.append("res:" + ";".join(map(repr, plan.residual)))
    elif tname == "PhysIndexMerge":        # omits ranges + residual
        parts.append("br:" + ";".join(
            f"{ix.name}[{lo!r},{hi!r},{li},{hi_i}]"
            for ix, lo, hi, li, hi_i in plan.branches))
        parts.append("res:" + ";".join(map(repr, plan.residual)))
    elif tname == "PhysIndexLookupJoin":   # omits inner residuals
        parts.append("inres:" + ";".join(map(repr, plan.inner_dag.filters +
                                             plan.inner_dag.host_filters)))
        parts.append("incols:" + ",".join(sc.name or ""
                                          for sc in plan.inner_dag.cols))
    elif tname == "PhysHashAgg":
        parts.append("agg:" + ";".join(
            f"{a.name}/{getattr(a, 'distinct', False)}" for a in plan.aggs))
    elif tname == "PhysTableReader":       # omits limit/topn pushdowns
        parts.append(f"lim:{plan.dag.limit},topn:{plan.dag.topn!r},"
                     f"psel:{plan.dag.part_sel!r}")
    elif tname == "PhysFusedPipeline":     # omits fact filters/pushdowns
        parts.append("ff:" + ";".join(map(repr, plan.fact_dag.filters +
                                          plan.fact_dag.host_filters)))
        parts.append(f"lim:{plan.fact_dag.limit},"
                     f"topn:{plan.fact_dag.topn!r},"
                     f"ts:{plan.topn_spec!r}")
    dims = getattr(plan, "dims", None)
    if dims:
        for d in dims:
            parts.append(f"jt:{d.join_type}")
            parts.append(";".join(map(repr, d.dag.filters + d.dag.host_filters)))
            if d.subplan is not None:
                sub = _plan_fp(d.subplan)
                if sub is None:
                    return None
                parts.append(sub)
    fb = getattr(plan, "fallback", None)
    if fb is not None and type(fb).__name__ not in _FP_SAFE_NODES:
        return None
    for c in plan.children:
        sub = _plan_fp(c)
        if sub is None:
            return None
        parts.append(sub)
    return "|".join(parts)


def _plan_base_tables(engine, plan, out=None):
    """Collect the ColumnarTables a plan reads. -> list or None when any
    referenced table can't be pinned (unknown id, partitioned) — the
    caller then skips caching rather than risk a stale reuse."""
    if out is None:
        out = []
    infos = []
    for attr in ("dag", "fact_dag", "inner_dag"):
        dag = getattr(plan, attr, None)
        if dag is not None and getattr(dag, "table_info", None) is not None:
            infos.append(dag.table_info)
    ti = getattr(plan, "table_info", None)
    if ti is not None:
        infos.append(ti)
    for d in getattr(plan, "dims", None) or ():
        if d.dag is not None and d.dag.table_info is not None:
            infos.append(d.dag.table_info)
        if d.subplan is not None and \
                _plan_base_tables(engine, d.subplan, out) is None:
            return None
    for info in infos:
        if getattr(info, "partitions", None):
            return None
        tbl = engine.tables.get(info.id)
        if tbl is None:
            return None
        out.append(tbl)
    for c in plan.children:
        if _plan_base_tables(engine, c, out) is None:
            return None
    return out


def _make_pipeline_body(plan, fact_cap, fact_sdicts, sizes, xp):
    """The fragment callable: filter the fact partition, then the dense
    partial aggregation over the group layout `sizes`. fact_cap is the
    partition capacity, xp the TorchNS of the copr's device. The
    reference's _build_fused_kernel jit-compiles this body; torch runs
    it eagerly, so there is nothing to build. Only zero-dimension plans
    reach it (_decline_reason). A global aggregation (one slot) whose
    filters lower to column bounds runs them in range_filter_sums, with
    its products of two columns folded in (dag_exec.fold_pairs)."""
    fact_filters = list(plan.fact_dag.filters)
    group_items = list(plan.group_items)
    aggs = list(plan.aggs)
    nslots = 1
    for size, _off in sizes:
        nslots *= size
    ranges = lower_filters(fact_filters) \
        if nslots == 1 and kernel_aggs_fit(aggs) else None
    folds = fold_pairs(aggs) if ranges is not None else None

    def body(fjc, fvv):
        cap = fact_cap
        cols = {k: (d, nl, fact_sdicts[k]) for k, (d, nl) in fjc.items()}
        ctx = EvalCtx(xp, cap, cols, host=False)
        mask = fvv
        if ranges is not None:
            for f in ranges.rest:
                mask = mask & eval_bool_mask(ctx, f)
            return dense_agg_states_range(ctx, mask, aggs, ranges, cap,
                                          folds)
        for f in fact_filters:
            mask = mask & eval_bool_mask(ctx, f)
        return dense_agg_body(ctx, mask, group_items, aggs, sizes, cap)
    return body


def _decline_reason(plan):
    """-> why this plan's shape is not ported to the device yet, or None
    when it is (zero dims, no post-join filters, evaluator ops checked
    under torch)."""
    if plan.dims:
        return "not yet ported: fused dimension joins"
    if plan.post_filters:
        return "not yet ported: post-join filters"
    exprs = list(plan.fact_dag.filters) + list(plan.group_items)
    for a in plan.aggs:
        exprs.extend(a.args)
    used = set()
    for e in exprs:
        ops_of(e, used)
    missing = sorted(used - TORCH_OPS)
    if missing:
        return "not yet ported: device ops " + ",".join(missing)
    return None


def _delta_partition(plan, fact_tbl, fact_arrays, delta_rows):
    """Shape a transaction's uncommitted INSERT rows like one more fact
    partition (reference UnionScan's txn-buffer merge, re-designed as a
    device overlay): {plan col idx -> (data, nulls, sdict)} + valid.
    Null-array presence mirrors the committed snapshot so the fragment
    sees the same column layout as for a committed partition."""
    n = len(delta_rows)
    handles = np.array([h for h, _ in delta_rows], dtype=np.int64)
    info = fact_tbl.table_info
    off_of = {ci.id: off for off, ci in enumerate(info.columns)}
    cols = {}
    for sc in plan.fact_dag.cols:
        cid = _cid_of(plan.fact_dag, sc)
        if cid == -1:
            cols[sc.col.idx] = (handles, None, None)
            continue
        snap_data, snap_nulls, sdict = fact_arrays[cid]
        off = off_of[cid]
        data = np.zeros(n, dtype=snap_data.dtype)
        nulls = np.zeros(n, dtype=bool)
        for r, (_h, datums) in enumerate(delta_rows):
            d = datums[off] if off < len(datums) else None
            if d is None or d.is_null:
                nulls[r] = True
                continue
            if sdict is not None:
                v = d.val
                data[r] = sdict.encode_one(
                    v if isinstance(v, str) else str(v))
            elif data.dtype == np.float64:
                data[r] = float(d.val)
            elif data.dtype == object:
                data[r] = d.val
            else:
                v = int(d.val)
                if v > 0x7FFFFFFFFFFFFFFF:
                    v -= 1 << 64
                data[r] = v
        nl = nulls if snap_nulls is not None else (
            None if not nulls.any() else nulls)
        cols[sc.col.idx] = (data, nl, sdict)
    return cols, np.ones(n, dtype=bool)


def _delta_in_span(shim, sizes, delta_part):
    """Do the delta rows' group keys fall inside the dense layout's
    span? Evaluated on host over the (tiny) delta partition: group item
    i must land in [off, off + size - 2] (dense_agg_body maps value d
    to code d - off + 1, clipped to size - 1; NULLs take slot 0).
    Group items referencing DIM columns can't be checked here — the
    delta probes dims inside the kernel — so only fact-only group
    expressions qualify; anything else keeps the sort lowering."""
    dcols, dv = delta_part
    nd = len(dv)
    if nd == 0:
        return True
    ctx = EvalCtx(np, nd, dcols, host=True)
    for g, (size, off) in zip(shim.group_items, sizes):
        refs = set()
        g.collect_columns(refs)
        if not refs <= set(dcols):
            return False
        try:
            d, nl, sdict = eval_expr(ctx, g)
        except Exception:               # noqa: BLE001
            return False
        if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
            d = np.full(nd, d)
        d = np.asarray(d)
        if d.dtype.kind not in "iu":
            return False
        nm = np.asarray(materialize_nulls(ctx, nl))
        live = d[~nm] if nm.any() else d
        if len(live) and (int(live.min()) < off or
                          int(live.max()) > off + size - 2):
            return False
    return True


def fused_partials(copr, plan, read_ts, ctx=None, delta_rows=None,
                   dead_handles=None):
    """Execute a PhysFusedPipeline -> [PartialAggResult] (one per fact
    partition), or None when the shape is not ported or not eligible at
    run time (caller falls back to the conventional subtree)."""
    # statement memory tracker for the upload seams (same install as
    # CoprExecutor.execute: the fused path uploads through _dev_put*
    # without passing through copr.execute)
    tr = getattr(ctx, "mem_tracker", None) if ctx is not None else None
    if tr is None:
        return _fused_partials_inner(copr, plan, read_ts, ctx, delta_rows,
                                     dead_handles)
    prev = _memory.push_current(tr)
    try:
        return _fused_partials_inner(copr, plan, read_ts, ctx, delta_rows,
                                     dead_handles)
    finally:
        _memory.set_current(prev)


def _fused_partials_inner(copr, plan, read_ts, ctx=None, delta_rows=None,
                          dead_handles=None):
    reason = _decline_reason(plan)
    if reason is not None:
        _set_reason(copr, reason)
        return None
    engine = copr.engine
    fact_tbl = engine.table(plan.fact_dag.table_info)
    # incremental HTAP: fold committed deltas into resident buffers
    # FIRST (patched entries advance their version and survive), then
    # sweep what stayed stale — copr/delta.py
    copr.delta.refresh(fact_tbl, ctx)
    copr._dev_store.invalidate(fact_tbl.uid, fact_tbl.version)
    fact_arrays, fact_valid = fact_tbl.snapshot(
        [cid for cid in (_cid_of(plan.fact_dag, sc)
                         for sc in plan.fact_dag.cols) if cid != -1],
        read_ts)
    n = len(fact_valid)
    if n == 0 and not delta_rows:
        return []
    handles = fact_tbl.handle_array()
    if len(handles) > n:
        handles = handles[:n]
    if dead_handles:
        # txn updated/deleted committed fact rows: mask their old
        # versions out of the base snapshot (new versions, if any,
        # arrive via the delta partition). & makes a fresh array —
        # the snapshot's validity may be cached/shared.
        fact_valid = fact_valid & ~np.isin(
            handles, np.asarray(dead_handles, dtype=np.int64))

    # 1-row host ctx over the pipeline columns: learn output dicts and
    # whether a dense group layout applies
    one = {}
    for sc in plan.fact_dag.cols:
        cid = _cid_of(plan.fact_dag, sc)
        if cid == -1:
            one[sc.col.idx] = (handles[:1] if len(handles)
                               else np.zeros(1, np.int64), None, None)
        else:
            data, nulls, sdict = fact_arrays[cid]
            one[sc.col.idx] = (data[:1] if len(data)
                               else np.zeros(1, data.dtype), None, sdict)
    # the delta partition builds BEFORE layout decisions: its dict
    # encodes extend the shared dicts, so dict-derived dense sizes
    # already cover delta codes
    delta_part = None
    if delta_rows:
        delta_part = _delta_partition(plan, fact_tbl, fact_arrays,
                                      delta_rows)
    shim = _AggShim(plan.group_items, plan.aggs)
    kd, sd = capture_agg_dicts(shim, one)
    fcols = None
    if n:
        # int group keys dense-detect via a host min/max pass over the
        # fact arrays, exactly like the copr reader path
        fcols = {}
        for sc in plan.fact_dag.cols:
            cid = _cid_of(plan.fact_dag, sc)
            fcols[sc.col.idx] = (handles, None, None) if cid == -1 \
                else fact_arrays[cid]
    sizes = _dense_strides(shim, kd, fcols, n)
    if sizes is not None and delta_part is not None and \
            not _delta_in_span(shim, sizes, delta_part):
        # dense layouts clip group codes to the derived span: a delta
        # key OUTSIDE it would silently merge into a boundary group
        sizes = None
    if sizes is None:
        _set_reason(copr, "not yet ported: fused sort/one-hot "
                    "aggregation (group domain is not dense)")
        return None

    fact_sdicts = {k: v[2] for k, v in one.items()}
    out = []
    step = copr.device_rows

    def _partitions():
        for start in range(0, n, step):
            sl = slice(start, min(start + step, n))
            pm = sl.stop - sl.start
            pcols = copr._bind_cols(plan.fact_dag, fact_tbl, fact_arrays,
                                    sl, handles,
                                    cacheable=(n == fact_tbl.n))
            # capture this partition's device-cache keys: the pipelined
            # loop binds the NEXT partition (overwriting copr._bind_keys)
            # before this one is consumed
            yield pcols, fact_valid[sl], pm, dict(copr._bind_keys)
        if delta_part is not None:
            # the transaction's uncommitted inserts as one more fact
            # partition through the SAME fragment (device UnionScan);
            # empty bind keys: never device-cache dirty rows
            dcols, dv = delta_part
            yield dcols, dv, len(dv), {}

    def _dispatch_part(cols, v, m, bind_keys):
        """Upload + dispatch one fact partition; its result tree comes
        back with the device->host copies already in flight."""
        cap = shape_bucket(m)
        key = _fused_cache_key(copr, plan, fact_tbl, cap, tuple(sizes))
        kern = copr._kernel_cache.get(key)
        if kern is None:
            kern = _make_pipeline_body(plan, cap, fact_sdicts, sizes,
                                       copr.xp)
            kern = copr._kernel_cache.put(key, kern)
        fjc_full, fvv = copr._pad_upload(cols, v, m, cap,
                                         bind_keys=bind_keys)
        fjc = {k: (d, nl) for k, (d, nl, _) in fjc_full.items()}
        # chaos hook: per-partition fragment dispatch. The supervised
        # retry lives one level up (executors.FusedPipelineExec wraps
        # the whole fused_partials call in guarded_dispatch site="fused")
        failpoint.inject("device_guard/fused/kernel")
        return prefetch(kern(fjc, fvv))

    # partition pipelining: partition i+1's padding/upload/dispatch is
    # issued BEFORE partition i's results are consumed, so the card
    # computes while the host binds the next partition
    pending = []
    for cols, v, m, bkeys in _partitions():
        pending.append(_dispatch_part(cols, v, m, bkeys))
        if len(pending) >= _PIPELINE_DEPTH:
            out.append(_compact_dense(shim, pending.pop(0), sizes, kd, sd))
    for res in pending:
        out.append(_compact_dense(shim, res, sizes, kd, sd))
    return out


def _fused_cache_key(copr, plan, fact_tbl, cap, sizes):
    dict_vers = tuple(sorted((cid, len(d.values))
                             for cid, d in fact_tbl.dicts.items()))
    fps = tuple(f.fingerprint() for f in plan.fact_dag.filters)
    gfps = tuple(g.fingerprint() for g in plan.group_items)
    afps = tuple(a.fingerprint() for a in plan.aggs)
    colsig = tuple(sorted((sc.col.idx, sc.name)
                          for sc in plan.fact_dag.cols))
    return ("fused", fact_tbl.uid, cap, fps, gfps, afps, dict_vers, colsig,
            sizes)
