"""Fused scan->join->agg device pipeline (reference: tidb_tpu's
copr/pipeline.py, which lowers the operator chain
executor/join/hash_join_v2.go:608 build/probe + tipb partial agg into
one device program per partition), ported to PyTorch on one device.

Design: the fact table streams through in bucketed partitions; rows
that fail a filter or miss a join simply clear a validity mask, and the
partial aggregation at the tail ignores them. One partition is one
fragment call (a Python callable over tensors, counted as one
dispatch), its result tree is fetched with one sync (utils/fetch.py),
and partition i+1 is dispatched before partition i is consumed.

A fragment runs, in order:

  fact filters        evaluator ops (expression/torch_ns.device_form)
  dimension probes    per dim: its filters over the resident dim
                      columns, then the probe of its build-key table —
                      one gather into a dense position table ("direct",
                      dense keys: every TPC-H key) or a left-sided
                      searchsorted into the sorted keys ("sorted"), with
                      composite keys packed by stride first; inner,
                      left, semi and anti semantics. Every gather index
                      is clamped into its table, so a key outside the
                      build side cannot reach memory it does not own
  post filters        conditions over fact and dim columns
  aggregation         dense (group codes in a small domain), posdense
                      (the group is the join position in <= 2^22 dim
                      rows: Q3, Q5, Q10 on the CPU), for a zero-dim
                      global aggregate with range filters
                      range_filter_sums, or the sort kind for any other
                      group domain (Q2, Q7, Q8, Q9, Q11, Q16, Q18, Q20):
                      dag_exec.sort_agg_body over the rows that passed,
                      gathered first into a learned compact capacity
                      when few pass

The dense layouts reach the ops/ scan kernels through
dag_exec.dense_agg_states: one slot -> ops.masked_sums, <= 64 slots ->
ops.dense_group_sums (Q1, Q4, Q5, Q12, Q22), any larger domain the torch
scatter on the CPU. On the card, as on the reference's device, a dense
or posdense domain over dag_exec._BCR_MAX slots takes the sort kind
instead, lowered as runs (Q3's and Q10's join positions inherit
lineitem's order by l_orderkey). copr/dag_exec.py's header has the
aggregate shapes each kernel takes.

The sort kind learns three things per query shape in copr._host_cache,
each with a rerun of the partition that showed it (on a cold statement;
a warm one reuses what was learned): the group bucket (the partials a
fragment returns, at least 1024, regrown when ngroups exceeds it), the
compact capacity (_compact_policy), and a pin from runs to sorted when
the runs are not clustered (ngroups > max(_RUNS_DEGRADE_MIN, rows / 4)).

A dim may be materialized: the result of a subplan (Q13's per-customer
order counts, Q17's per-part average quantity, Q21's per-order supplier
counts), run through the executor, shaped like a dim table keyed by
output position and probed like one (_materialized_dim_meta). Its
result is cached across statements in a byte-bounded LRU, valid while
its base tables are unchanged, so a warm statement runs no subplan and
uploads nothing.

A shape the device rule (expression/torch_ns.device_form) sends to the
host, as the reference's failed trace does, is declined before dispatch
with last_fused_reason "host-bound shape: ..." so the executor takes its
counted host path.

On one device three more programs are learned, as the reference learns
them (each a rerun of a partition whose result shows the learned state
wrong, never a fallback; the mesh takes none of them):

  early compaction    a pipeline with dims whose fact filters keep at
                      most 1/8 of a partition gathers their survivors
                      into a learned ecap-row buffer before the probes
                      (Q4, Q12, Q14, Q19, Q22); res["fnvalid"] reruns a
                      partition that overflowed it (counted as the late
                      compaction's rerun, fused_compact_regrow)
  top-N candidates    ORDER BY ... LIMIT k over a runs-lowered group-by
                      anchored on a clustered fact column (Q3) returns
                      k + 66 candidate partials per partition
                      (_topn_select) instead of every group; a cover
                      proof that fails pins the shape off
                      (fused_topn_off)
  one-hot slots       a group domain that is neither dense nor a join
                      position, under count and int64 sum/avg, learns
                      its slot table from a sort-kind statement
                      (_oh_learn_table) and then adds each row's states
                      into its slot (dag_exec.onehot_agg_body, over the
                      sort kind's compact capacity; Q7, Q8, Q9, Q11,
                      Q15, Q21 at SF1 on the card); a key the table
                      lacks reruns the partition with the sort kind
                      (fused_onehot_miss) and relearns. On the CPU only
                      under TIDB_TPU_ONEHOT_FORCE.

With a mesh (the planner's fragment_plan flagged the pipeline mpp, and
the executor found tidb_enable_mpp on and two or more shards), the
whole fact table runs as ONE mesh program (_run_fused_mpp): fact
columns and the validity mask resident row-sharded over the mesh, dims
replicated to every device (the Broadcast exchange, _upload_dim), the
partition body above on each shard at the shard's rows, and the shards'
dense tables merged by psum, or their sort-kind partials shipped to the
coordinator in one fetch (PassThrough). A single inner dim over
tidb_broadcast_join_threshold_count rows, grouped by one of its columns
under sum / count / avg of fact expressions, takes the Hash exchange
instead (_try_fused_shuffle -> mpp/exec.py mpp_shuffle_join_agg): both
sides all_to_all'd by join key, joined and aggregated per shard, psum.
"""
from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict

import numpy as np

import torch

from ..expression import EvalCtx, eval_expr, eval_bool_mask
from ..expression.expr import Column as ExprColumn
from ..expression.vec import materialize_nulls
from ..expression.torch_ns import device_form
from ..chunk.device import shape_bucket
from ..utils.torchcfg import INT64
from ..types.field_type import TypeClass
from . import dag_exec as _de
from .dag_exec import (PartialAggResult, capture_agg_dicts, _dense_strides,
                       dense_agg_body, dense_agg_states,
                       dense_agg_states_range, fold_pairs, kernel_aggs_fit,
                       sort_agg_body, _compact_dense, _dense_nslots,
                       _segment_impl, _I64_MAX)
from .range_lowering import lower_filters
from ..utils.fetch import prefetch, host_array, host_int
from ..utils import failpoint
from ..utils import phase
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


_DIRECT_SPAN_BUDGET = 1 << 24
# largest posdense slot domain (product of the position dims' rows)
_POS_DENSE_MAX = 1 << 22


def _compact_policy(copr, compk, ccap, nvalid, denom):
    """Learn/regrow rule of the sort kind's compact-then-aggregate
    capacity (reference _compact_policy). -> "retry" when the fragment
    must run again with a larger compact buffer, else None. First sight
    of a shape learns the bucket when the survivors are at most 1/8 of
    the partition and pins compaction off otherwise; an overflow regrows
    it, or pins it off when survivors passed 1/4. A partition seen
    without compaction never shrinks what another partition learned
    (the reference overwrites it, so its next statement reruns the
    larger partition once)."""
    if ccap is not None and nvalid > ccap:
        if nvalid > denom // 4:
            copr._host_cache[compk] = "off"
        else:
            copr._host_cache[compk] = shape_bucket(nvalid)
        return "retry"
    learned = copr._host_cache.get(compk)
    if ccap is None and learned != "off":
        if nvalid <= denom // 8:
            copr._host_cache[compk] = max(
                shape_bucket(max(nvalid, 1)),
                learned if isinstance(learned, int) else 0)
        else:
            copr._host_cache[compk] = "off"
    return None


_MATDIM_MAX_BYTES = 1 << 29     # 512MB of cached subquery results


def _matdim_cache(copr):
    """Per-copr LRU for materialized-dim results, byte-bounded — unlike
    the metadata entries in _host_cache, these hold full result arrays
    (the device pool analog: _dev_put charges a device-memory budget)."""
    c = getattr(copr, "_matdim_lru", None)
    if c is None:
        c = copr._matdim_lru = OrderedDict()
        copr._matdim_bytes = 0
    return c


def _matdim_nbytes(out):
    total = 0
    for d, nl, _sd in out["arrays"].values():
        total += getattr(d, "nbytes", 0)
        total += getattr(nl, "nbytes", 0) if nl is not None else 0
    for k in ("lut", "order", "skeys"):
        if k in out:
            total += getattr(out[k], "nbytes", 0)
    return total


def _matdim_drop(copr, out):
    """Release a materialization that left the cache: its device
    uploads are keyed by its own uid, which nothing reads again."""
    copr._dev_store.invalidate(out["tbl"].uid)


_MAT_SEQ = [0]
_MAT_SEQ_MU = threading.Lock()  # materializations on any conn thread
# the matdim LRUs: statements on connection threads look up and fill
# them at once (the subplan runs outside the lock)
_MATDIM_MU = threading.Lock()


class _MatTbl:
    """Shim standing in for a ColumnarTable for materialized dims: only
    the attributes the upload/caching paths read. A fresh uid per
    materialization means device uploads never alias across results,
    and its arrays never change under that uid."""

    __slots__ = ("uid", "version", "n", "dicts")

    def __init__(self, n):
        with _MAT_SEQ_MU:
            _MAT_SEQ[0] += 1
            self.uid = ("mat", _MAT_SEQ[0])
        self.version = 0
        self.n = n
        self.dicts = {}


def _materialized_dim_meta(copr, ctx, dim, read_ts):
    """Execute dim.subplan (Q17's decorrelated per-key aggregate, Q13's
    per-customer counts, Q21's per-order supplier counts) and shape its
    output like a dim table: arrays keyed by output POSITION, every row
    valid, group keys unique by construction (still verified). -> meta
    dict or None.

    The result is cached across statements under the subplan's
    structural fingerprint, the session's time zone and sql mode, valid
    while its base tables keep their (uid, version) and no row was
    committed after either snapshot (max_commit_ts <= both read_ts): a
    warm statement's subplan is a dict hit (domain metric
    fused_matdim_hit) and does not run. A session with a dirty
    transaction can see uncommitted rows through the subplan's scans
    without bumping any table version, so it neither reads nor fills
    the cache."""
    if ctx is None:
        _set_reason(copr, "materialized dim: no execution context")
        return None
    dom = getattr(copr, "domain", None)
    txn = getattr(getattr(ctx, "sess", None), "_txn", None)
    dirty = txn is not None and not txn.committed and not txn.aborted \
        and txn.is_dirty()
    ck = base = None
    fp = None if dirty else _plan_fp(dim.subplan)
    if fp is not None and not _VOLATILE_RE.search(fp):
        base = _plan_base_tables(copr.engine, dim.subplan)
    if base:
        try:
            tz = (str(ctx.sv.get("time_zone")), str(ctx.sv.get("sql_mode")))
        except Exception:               # noqa: BLE001
            tz = ()
        ck = ("matdim", fp, tz)
        vers = tuple((t.uid, t.version) for t in base)
        maxts = max(t.max_commit_ts for t in base)
        with _MATDIM_MU:
            lru = _matdim_cache(copr)
            ent = lru.get(ck)
            # read_ts None = latest snapshot (sees every committed row)
            hit = ent is not None and ent[0] == vers and \
                (ent[1] is None or maxts <= ent[1]) and \
                (read_ts is None or maxts <= read_ts)
            if hit:
                lru.move_to_end(ck)
        if hit:
            if dom is not None:
                dom.inc_metric("fused_matdim_hit")
            return ent[2]
    from ..executor.builder import build_executor
    ex = build_executor(ctx, dim.subplan)
    ex.open()
    chunks = ex.all_chunks()
    ex.close()
    if dom is not None:
        dom.inc_metric("fused_matdim_build")
    ncols = len(dim.dag.cols)
    n = sum(len(ch) for ch in chunks)
    if n == 0:
        _set_reason(copr, "materialized dim: subplan produced no rows")
        return None                   # caller's empty-dim handling differs
    arrays = {}
    for i in range(ncols):
        parts = [ch.columns[i] for ch in chunks]
        data = np.concatenate([np.asarray(p.data) for p in parts])
        if data.dtype.kind not in "iufb":
            _set_reason(copr, "materialized dim: non-numeric column")
            return None               # object arrays have no device form
        sdicts = {id(p.dict) for p in parts if p.dict is not None}
        if len(sdicts) > 1:
            _set_reason(copr, "materialized dim: inconsistent dicts")
            return None               # inconsistent dicts across chunks
        sdict = next((p.dict for p in parts if p.dict is not None), None)
        nulls = None
        if any(p.nulls is not None for p in parts):
            nulls = np.concatenate(
                [p.nulls if p.nulls is not None
                 else np.zeros(len(p), dtype=bool) for p in parts])
        arrays[i] = (data, nulls, sdict)
    key_cids = [_cid_of(dim.dag, sc) for sc, _ in dim.all_keys()]
    if any(cid == -1 for cid in key_cids):
        _set_reason(copr, "materialized dim: join key not in output")
        return None
    for cid in key_cids:
        kdata, _kn, ksdict = arrays[cid]
        if ksdict is not None or kdata.dtype.kind == "f":
            _set_reason(copr, "materialized dim: non-int64 join key")
            return None
    valid = np.ones(n, dtype=bool)
    vidx = np.arange(n)
    keys_v, pack = _packed_keys(arrays, key_cids, n, vidx)
    if keys_v is None or len(np.unique(keys_v)) != n:
        _set_reason(copr, "materialized dim: non-unique or NULL keys")
        return None
    lo = int(keys_v.min())
    span = int(keys_v.max()) - lo + 1
    out = {"arrays": arrays, "valid": valid, "n": n, "tbl": _MatTbl(n),
           "pack": pack}
    if span <= max(4 * n, 1 << 12) and span <= _DIRECT_SPAN_BUDGET:
        lut = np.full(span, n, dtype=np.int64)
        lut[keys_v - lo] = vidx
        out.update(mode="direct", lo=lo, lut=lut, n_sorted=n)
    else:
        o = np.argsort(keys_v, kind="stable")
        out.update(mode="sorted", lo=None, order=vidx[o],
                   skeys=keys_v[o], n_sorted=n)
    if ck is not None:
        nb = _matdim_nbytes(out)
        dropped = []
        with _MATDIM_MU:
            lru = _matdim_cache(copr)
            old = lru.pop(ck, None)
            if old is not None:
                copr._matdim_bytes -= old[3]
                dropped.append(old[2])
            lru[ck] = (vers, read_ts, out, nb)
            copr._matdim_bytes += nb
            while copr._matdim_bytes > _MATDIM_MAX_BYTES and len(lru) > 1:
                _k, (_v, _t, evicted, onb) = lru.popitem(last=False)
                copr._matdim_bytes -= onb
                dropped.append(evicted)
        for gone in dropped:
            _matdim_drop(copr, gone)
    return out


def _dim_sort_meta(copr, dim, tbl, read_ts):
    """Host-side per-dimension prep: snapshot arrays + the join "hash
    table" for the build-key column (cached per table version) +
    uniqueness check. -> dict or None when ineligible.

    Two table forms, chosen by key density:
    - direct: key span fits the budget -> dense position array, probe is
      ONE gather (pos = lut[key - lo]). TPC-H PKs are dense 1..N, so
      this is the common case.
    - sorted: argsort + binary search (torch.searchsorted) otherwise.

    Composite keys (dim.extra_keys, Q9 partsupp) pack into one int64 by
    per-column stride before either form; the pack layout ships to the
    fragment so the probe packs the same way."""
    col_ids = [cid for cid in (_cid_of(dim.dag, sc) for sc in dim.dag.cols)
               if cid != -1]
    arrays, valid = tbl.snapshot(col_ids, read_ts)
    n = len(valid)
    key_cids = [_cid_of(dim.dag, sc) for sc, _ in dim.all_keys()]
    if any(cid == -1 for cid in key_cids):
        _set_reason(copr, f"dim {dim.dag.table_info.name}: join key is "
                    "not a stored column")
        return None
    if n == 0:
        _set_reason(copr, f"dim {dim.dag.table_info.name}: no visible "
                    "rows at this snapshot")
        return None
    for cid in key_cids:
        kdata, _kn, ksdict = arrays[cid]
        if ksdict is not None or kdata.dtype.kind == "f":
            _set_reason(copr, f"dim {dim.dag.table_info.name}: join key "
                        "is not int64-comparable (string/float)")
            return None                  # int64-comparable keys only
    host_cache = copr._host_cache
    if dim.join_type in ("semi", "anti") and not dim.extra_keys:
        # SEMI/ANTI only test key EXISTENCE: fold the dim's filters on
        # the host and dedup, so duplicate keys and filtered dims (Q4's
        # EXISTS, Q22's NOT EXISTS over orders) still ride the fused
        # probe. The fragment then skips this dim's mask entirely
        # ("pre" mode).
        return _semi_prefiltered_meta(copr, dim, tbl, arrays, valid, n,
                                      key_cids[0], read_ts)
    # built over VALID rows only (old MVCC versions of an updated key
    # would otherwise look like duplicates); visibility depends on
    # read_ts, so it keys the cache; older versions are evicted
    ck = tuple(key_cids)
    hkey = (tbl.uid, ck, "dim", tbl.version, n, read_ts)
    meta = host_cache.get(hkey)
    if meta is None:
        prev = host_cache.pop((tbl.uid, ck, "dimcur"), None)
        if prev is not None:
            host_cache.pop(prev, None)
        host_cache[(tbl.uid, ck, "dimcur")] = hkey
        vidx = np.nonzero(valid)[0]
        keys_v, pack = _packed_keys(arrays, key_cids, n, vidx)
        nv = 0 if keys_v is None else len(keys_v)
        unique = nv > 0 and len(np.unique(keys_v)) == nv
        if keys_v is None or nv == 0 or not unique:
            # dup-key / null-key dims are rejected below on every use:
            # cache a tombstone, don't build the (possibly huge) lut
            meta = (None, None, None, False, 0, None)
        else:
            lo = int(keys_v.min())
            hi = int(keys_v.max())
            span = hi - lo + 1
            if span <= max(4 * nv, 1 << 12) and span <= _DIRECT_SPAN_BUDGET:
                lut = np.full(span, n, dtype=np.int64)   # n == miss
                lut[keys_v - lo] = vidx
                meta = ("direct", lut, lo, unique, nv, pack)
            else:
                o = np.argsort(keys_v, kind="stable")
                skeys = keys_v[o]
                meta = ("sorted", (vidx[o], skeys), None, unique, nv, pack)
        host_cache[hkey] = meta
    mode, payload, lo, unique, n_sorted, pack = meta
    if mode is None or not unique:
        _set_reason(copr, f"dim {dim.dag.table_info.name}: build keys "
                    "are duplicated or NULL (non-unique build side)")
        return None
    out = {"arrays": arrays, "valid": valid, "n": n, "tbl": tbl,
           "mode": mode, "lo": lo, "n_sorted": n_sorted, "pack": pack}
    if mode == "direct":
        out["lut"] = payload
    else:
        out["order"], out["skeys"] = payload
    return out


def _packed_keys(arrays, key_cids, n, vidx):
    """-> (packed int64 key per valid row, pack layout) or (None, None).
    Single keys pass through (pack=None). Composite keys pack as
    sum((k_i - lo_i) * stride_i); the layout is (los, spans, strides),
    rejected when the combined span overflows int63 or any key is
    NULL."""
    if len(key_cids) == 1:
        kdata, knulls, _ = arrays[key_cids[0]]
        if knulls is not None and knulls[:n][vidx].any():
            return None, None
        return kdata[:n][vidx], None
    cols = []
    for cid in key_cids:
        kdata, knulls, _ = arrays[cid]
        if knulls is not None and knulls[:n][vidx].any():
            return None, None
        cols.append(kdata[:n][vidx].astype(np.int64))
    if len(cols[0]) == 0:
        return None, None
    los = [int(c.min()) for c in cols]
    spans = [int(c.max()) - lo + 1 for c, lo in zip(cols, los)]
    total = 1
    for s in spans:
        total *= s
        if total > (1 << 62):
            return None, None
    strides = []
    acc = 1
    for s in reversed(spans):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    packed = np.zeros(len(cols[0]), dtype=np.int64)
    for c, lo, st in zip(cols, los, strides):
        packed += (c - lo) * st
    return packed, (tuple(los), tuple(spans), tuple(strides))


def _semi_prefiltered_meta(copr, dim, tbl, arrays, valid, n, key_cid,
                           read_ts):
    """The existence table of a semi/anti dim without extra keys: its
    filters and visibility folded on the host, keys deduplicated ("pre"
    mode: the fragment reads neither valid nor columns of this dim)."""
    fps = tuple(f.fingerprint() for f in dim.dag.filters)
    hkey = (tbl.uid, key_cid, "semidim", tbl.version, n, read_ts, fps)
    meta = copr._host_cache.get(hkey)
    if meta is None:
        prev = copr._host_cache.pop((tbl.uid, key_cid, "semicur"), None)
        if prev is not None:
            copr._host_cache.pop(prev, None)
        copr._host_cache[(tbl.uid, key_cid, "semicur")] = hkey
        mask = valid.copy()
        if dim.dag.filters:
            cols = {}
            for sc in dim.dag.cols:
                cid = _cid_of(dim.dag, sc)
                if cid == -1:
                    continue
                d, nl, sd = arrays[cid]
                cols[sc.col.idx] = (d, nl, sd)
            ectx = EvalCtx(np, n, cols, host=True)
            for f in dim.dag.filters:
                mask &= np.asarray(eval_bool_mask(ectx, f))
        kdata, knulls, _ = arrays[key_cid]
        if knulls is not None:
            mask &= ~knulls[:n]
        keys = np.unique(kdata[:n][mask])
        nv = len(keys)
        if nv == 0:
            # nothing passes: a 1-slot always-miss lut (the fragment's
            # hit test is lut[idx] < n, so the sentinel must be n itself
            # — any smaller value is a false hit for probe key == lo)
            meta = ("direct", np.array([n], dtype=np.int64), 0, True, 0)
        else:
            lo = int(keys.min())
            span = int(keys.max()) - lo + 1
            if span <= max(4 * nv, 1 << 12) and \
                    span <= _DIRECT_SPAN_BUDGET:
                lut = np.full(span, n, dtype=np.int64)
                lut[keys - lo] = 0       # any representative: hit test
                meta = ("direct", lut, lo, True, nv)
            else:
                meta = ("sorted", (np.zeros(nv, dtype=np.int64), keys),
                        None, True, nv)
        copr._host_cache[hkey] = meta
    mode, payload, lo, _unique, n_sorted = meta
    out = {"arrays": arrays, "valid": valid, "n": n, "tbl": tbl,
           "mode": mode, "lo": lo, "n_sorted": n_sorted, "pre": True,
           "ukey": ("pre",) + fps}
    if mode == "direct":
        out["lut"] = payload
    else:
        out["order"], out["skeys"] = payload
    return out


def _empty_dim_meta(dim, tbl):
    """LEFT/ANTI over an empty dim preserve the fact side (NULL payload /
    all-miss): a 1-row always-miss dim keeps the fragment's shapes."""
    arrays = {}
    for sc in dim.dag.cols:
        cid = _cid_of(dim.dag, sc)
        if cid == -1:
            continue
        arrays[cid] = (np.zeros(1, dtype=tbl.data[cid].dtype), None,
                       tbl.dicts.get(cid))
    return {"arrays": arrays, "valid": np.zeros(1, dtype=bool),
            "n": 1, "tbl": tbl, "mode": "direct",
            "lut": np.array([1], dtype=np.int64), "lo": 0,
            "n_sorted": 0, "pack": None,
            # arrays are fabricated 1-row placeholders, NOT the table's
            # append-only columns: they must never enter the
            # delta-maintained append seam under this uid
            "synthetic": True}


def _upload_dim(copr, dim, meta, cap, read_ts, mesh=None):
    """Pad + upload dim arrays through the device-resident store; -> (the
    fragment's per-dim argument dict, {col idx: (has_nulls, sdict)}).
    The probe's scalars (lo, the composite pack layout) ride as python
    ints, so a new key range reuses the fragment and uploads nothing.
    With a mesh every array replicates to all devices (the Broadcast
    exchange of the dim fragment)."""
    tbl = meta["tbl"]
    n = meta["n"]
    ver = tbl.version
    mk = (() if mesh is None else ("bcast", mesh.fingerprint())) + \
        tuple(meta.get("ukey", ()))
    # plain dim column data is append-only table state: it rides the
    # delta-maintained append seam (copr/delta.py) when the meta wraps
    # a REAL columnar table — the fabricated empty-dim placeholder
    # arrays must not (they are not the table's columns)
    appendable = hasattr(tbl, "gc_epoch") and not meta.get("synthetic")

    # a materialization's arrays are fixed for its uid: nothing of it
    # varies with the snapshot ts, so a cached one uploads nothing in a
    # later transaction either
    ts_free = isinstance(tbl, _MatTbl)

    def put(tag, arr, length, acap, fill=0, ts_keyed=False):
        # plain column data depends only on the table version; only the
        # MVCC-derived arrays (valid mask, lut/sort built over the valid
        # set) vary with the snapshot ts — keying data by ts would
        # re-upload every dim column once per transaction. _dev_put
        # reads the pad capacity from key[-1]: acap stays LAST.
        key = (tbl.uid, tag, ver,
               read_ts if ts_keyed and not ts_free else None,
               length) + mk + (acap,)
        return copr._dev_put(key, arr, pad_fill=fill, uid=tbl.uid,
                             version=ver, mesh=mesh, spec="replicated")

    def put_col(cid, kind, arr, acap, fill=0):
        # append seam for raw dim columns: the whole column [0, n)
        # padded to acap, tail-patched under appends instead of
        # re-uploaded on every dim-table version bump
        from .delta import append_key
        key = append_key(tbl.uid, ("dim",) + mk, cid, kind,
                         tbl.gc_epoch, (), acap)
        return copr._dev_put_append(
            key, arr, n, acap, tbl.uid, ver, tbl.gc_epoch, 0, None,
            pad_fill=fill, mesh=mesh, spec="replicated")

    pre = bool(meta.get("pre"))
    args = {"cols": {}, "pack": meta.get("pack")}
    if not pre:
        # prefiltered semi dims fold visibility+filters into the lut at
        # meta time; the fragment never reads valid/cols for them —
        # don't upload dead copies into the resident store
        args["valid"] = put("valid", meta["valid"], n, cap, False,
                            ts_keyed=True)
    if meta["mode"] == "direct":
        lcap = shape_bucket(len(meta["lut"]))
        args["lut"] = put("lut", meta["lut"], len(meta["lut"]), lcap,
                          fill=n, ts_keyed=True)
        args["lsize"] = len(meta["lut"])
        args["lo"] = int(meta["lo"])
    else:
        ns = meta["n_sorted"]
        scap = shape_bucket(ns)
        args["sk"] = put("sk", meta["skeys"], ns, scap, fill=_I64_MAX,
                         ts_keyed=True)
        args["ord"] = put("ord", meta["order"], ns, scap, ts_keyed=True)
    layout = {}
    if not pre:
        for sc in dim.dag.cols:
            cid = _cid_of(dim.dag, sc)
            if cid == -1:
                continue
            data, nulls, sdict = meta["arrays"][cid]
            if appendable:
                jd = put_col(cid, "d", data, cap)
                jn = None
                if nulls is not None:
                    jn = put_col(cid, "n", nulls, cap, fill=True)
            else:
                jd = put(("fp", cid), data, n, cap)
                jn = None
                if nulls is not None:
                    jn = put(("fpn", cid), nulls, n, cap, fill=True)
            args["cols"][sc.col.idx] = (jd, jn)
            layout[sc.col.idx] = (nulls is not None, sdict)
    return args, layout


def _probe_values(ctx, dim, da, cap):
    """-> (probe key int64 [cap], rows that cannot hit [cap]): the probe
    expression, or the composite pack of every key expression with the
    build side's layout. A NULL key never hits; a composite component
    outside its build-side span forces a miss (a clamped index could
    otherwise alias a live packed key)."""
    dev = ctx.xp.device
    if not dim.extra_keys:
        pv, pnl, _ = eval_expr(ctx, dim.probe_expr)
        if np.isscalar(pv) or getattr(pv, "ndim", 1) == 0:
            pv = ctx.xp.full(cap, pv)
        return pv.to(INT64), materialize_nulls(ctx, pnl)
    los, spans, strides = da["pack"]
    pv = torch.zeros(cap, dtype=INT64, device=dev)
    miss = torch.zeros(cap, dtype=torch.bool, device=dev)
    for ki, (_, pe) in enumerate(dim.all_keys()):
        v, nl, _ = eval_expr(ctx, pe)
        if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
            v = ctx.xp.full(cap, v)
        v = v.to(INT64)
        idx = v - los[ki]
        miss = miss | materialize_nulls(ctx, nl) | (idx < 0) | \
            (idx >= spans[ki])
        pv = pv + torch.clamp(idx, 0, spans[ki] - 1) * strides[ki]
    return pv, miss


def _probe(da, pv, miss, dcap, dn, dsn):
    """-> (position in the dim [cap], hit [cap]) of each probe key. Every
    gather index is clamped into its table: torch raises on an index
    out of range, where the reference's jax gather clamps."""
    if "lut" in da:
        # dense key domain: the join is ONE gather
        lsize = da["lsize"]
        lo = da["lo"]
        # pv - lo wraps only for a key out of range, and lands out of
        # range too: a wrap from below lo at >= lsize, one from above
        # at < 0
        idx = pv - lo
        inb = (idx >= 0) & (idx < lsize)
        at = da["lut"][torch.clamp(idx, 0, lsize - 1)]
        hit = inb & (at < dn) & ~miss
        return torch.clamp(at, max=dcap - 1), hit
    sk = da["sk"]
    loc = torch.searchsorted(sk, pv)             # side left
    locc = torch.clamp(loc, max=sk.shape[0] - 1)
    pos = da["ord"][locc]
    hit = (sk[locc] == pv) & ~miss & (loc < dsn)
    return pos, hit


def _apply_dims(ctx, cols, mask, dims, dargs, dim_caps, dim_ns, dim_sns,
                dim_layouts, dim_pres, cap):
    """The probe stage: every dim in plan order, with inner / left / semi
    / anti semantics. -> (ctx over the fact and gathered dim columns,
    row mask, {dim index: clamped position})."""
    xp = ctx.xp
    dim_pos = {}
    for di, (dim, da, dcap, dn, dsn, layout, pre) in enumerate(zip(
            dims, dargs, dim_caps, dim_ns, dim_sns, dim_layouts, dim_pres)):
        dmask = None          # prefiltered semi dims: folded at meta time
        if not pre:
            dcols = {idx: (jd, jn, layout[idx][1])
                     for idx, (jd, jn) in da["cols"].items()}
            dctx = EvalCtx(xp, dcap, dcols, host=False)
            dmask = da["valid"]
            for f in dim.dag.filters:
                dmask = dmask & eval_bool_mask(dctx, f)
        pv, miss = _probe_values(ctx, dim, da, cap)
        pos, hit = _probe(da, pv, miss, dcap, dn, dsn)
        if dmask is not None:
            hit = hit & dmask[pos]
        if dim.join_type == "left":
            # preserved side: misses keep the row, payload is NULL
            for idx, (jd, jn) in da["cols"].items():
                gn = ~hit if jn is None else (~hit | jn[pos])
                cols[idx] = (jd[pos], gn, layout[idx][1])
        elif dim.join_type == "anti":
            # NOT EXISTS: keep only rows with NO match (NULL probe keys
            # never match, so they survive — EXISTS-derived anti
            # semantics; null-aware NOT IN never plans here)
            mask = mask & ~hit
        else:
            mask = mask & hit
            if dim.join_type != "semi":
                for idx, (jd, jn) in da["cols"].items():
                    cols[idx] = (jd[pos], None if jn is None else jn[pos],
                                 layout[idx][1])
        dim_pos[di] = torch.clamp(pos, max=dn - 1)
        ctx = EvalCtx(xp, cap, cols, host=False)
    return ctx, mask, dim_pos


def _fused_topn_state(copr, plan, fact_tbl, offk, kd, sd):
    """The planner's topn_spec (kind, index, desc, k), checked against
    the data -> the spec, or None. Top-k candidates over per-run
    partials are exact only when each group lives in at most one partial
    per partition, which takes:
    - an anchor group item: a fact column whose storage order is
      verified monotone (ColumnarTable.is_clustered): equal keys are
      adjacent, and a partition edge splits at most one group;
    - every other group item a function of columns reachable from the
      anchor through inner/left dims probed by what is reached already
      (constant within a run);
    - an integer metric without a dictionary (the device's candidates
      and the host's cover proof compare it exactly)."""
    spec = getattr(plan, "topn_spec", None)
    if spec is None or copr._host_cache.get(offk):
        return None
    kind, ai, _desc, _k = spec
    if kind == "agg":
        if ai >= len(plan.aggs):
            return None
        a = plan.aggs[ai]
        if a.name not in ("sum", "count", "min", "max"):
            return None
        if a.args and (a.args[0].ft.tclass == TypeClass.FLOAT or
                       sd[ai] is not None):
            return None
    else:
        if ai >= len(plan.group_items):
            return None
        if kd[ai] is not None or \
                plan.group_items[ai].ft.tclass == TypeClass.FLOAT:
            return None
    cid_by_idx = {}
    for sc in plan.fact_dag.cols:
        cid = _cid_of(plan.fact_dag, sc)
        if cid != -1:
            cid_by_idx[sc.col.idx] = cid
    anchor = next((g.idx for g in plan.group_items
                   if isinstance(g, ExprColumn) and g.idx in cid_by_idx
                   and fact_tbl.is_clustered(cid_by_idx[g.idx])), None)
    if anchor is None:
        return None
    closure = {anchor}
    for _ in range(len(plan.dims) + 1):
        grew = False
        for dim in plan.dims:
            if dim.join_type in ("semi", "anti"):
                continue
            pidx = set()
            for _, pe in dim.all_keys():
                pidx |= _expr_idxs(pe)
            if pidx and pidx <= closure:
                for sc in dim.dag.cols:
                    if sc.col.idx not in closure:
                        closure.add(sc.col.idx)
                        grew = True
        if not grew:
            break
    for g in plan.group_items:
        gi = _expr_idxs(g)
        if not gi or not gi <= closure:
            return None
    return spec


def _topn_metric_host(spec, aggs, keys, key_nulls, states):
    """Numpy twin of _topn_select's metric (larger is better) for the
    cover proof; the formula must stay the same as there."""
    kind, ai, desc, _k = spec
    if kind == "group":
        v = np.asarray(keys[ai]).astype(np.int64)
        nul = np.asarray(key_nulls[ai])
    else:
        st = states[ai]
        v = np.asarray(st[0]).astype(np.int64)
        nul = (np.asarray(st[-1]) == 0) if aggs[ai].name != "count" \
            else np.zeros(len(v), dtype=bool)
    m = v if desc else ~v      # ~v = -v - 1: reverses the order, no wrap
    # the ends of the range are the NULL / empty / forced markers: a
    # metric there clamps, and the tie that makes falls to the cover
    # proof's safe verdict (off), never onto a marker
    m = np.clip(m, -_I64_MAX + 2, _I64_MAX - 2)
    # MySQL's NULL order: first ascending (best), last descending
    return np.where(nul, (-_I64_MAX) if desc else (_I64_MAX - 1), m)


def _topn_select(res, aggs, topn, bucket):
    """Top-N candidates over the sort kind's partials, on the device:
    the int64 metric (larger is better, as _topn_metric_host), empty
    slots last, and runs 0 and ngroups - 1 (whose groups may go on in
    the next or previous partition) forced first, so the host merge
    always sees both halves of a split group. -> the result with every
    key and state gathered to the k' selected partials, plus "sel",
    their run ordinals. The reference selects with lax.top_k, which
    breaks ties by the lower index; torch.topk promises no tie order,
    so the selection is a stable ascending sort of ~m: the same order,
    so the same sel."""
    kind, ai, desc, kprime = topn
    ng = res["ngroups"]
    if kind == "group":
        v = res["keys"][ai].to(INT64)
        nul = res["key_nulls"][ai]
    else:
        st = res["states"][ai]
        v = st[0].to(INT64)
        nul = (st[-1] == 0) if aggs[ai].name != "count" else \
            torch.zeros(v.shape, dtype=torch.bool, device=v.device)
    m = v if desc else torch.bitwise_not(v)
    m = torch.clamp(m, -_I64_MAX + 2, _I64_MAX - 2)
    m = torch.where(nul, -_I64_MAX if desc else _I64_MAX - 1, m)
    iota = torch.arange(bucket, dtype=INT64, device=v.device)
    m = torch.where(iota < ng, m, -_I64_MAX - 1)
    m = torch.where((iota == 0) | (iota == ng - 1), _I64_MAX, m)
    sel = torch.sort(torch.bitwise_not(m), stable=True).indices[:kprime]
    out = {"ngroups": ng, "sel": sel,
           "keys": [k[sel] for k in res["keys"]],
           "key_nulls": [kn[sel] for kn in res["key_nulls"]],
           "states": [[s[sel] for s in st] for st in res["states"]]}
    if "nvalid" in res:
        out["nvalid"] = res["nvalid"]
    return out


def _topn_covered(spec, aggs, keys, key_nulls, states, sel, ngroups):
    """The cover proof of a partition's candidates (host arrays, the
    first min(ngroups, k') of them): at least k complete candidates
    rank strictly above the candidates' lowest metric, so no partial
    left out can reach the top k. Only complete groups count: a forced
    edge run's metric is not its merged total, so it vouches for
    nothing."""
    real_m = _topn_metric_host(spec, aggs, keys, key_nulls, states)
    mnf = real_m[~((sel == 0) | (sel == ngroups - 1))]
    return len(mnf) > 0 and int((mnf > mnf.min()).sum()) >= spec[3]


def _pos_group_map(plan, dim_metas):
    """Group-by-FK detection: when every group item is either a column of
    an (inner, unique) dimension or the probe key of one, the join
    POSITION already identifies the group — aggregation becomes a direct
    scatter-add into dim-position space, no sort, no key packing.
    (Q3's group (l_orderkey, o_orderdate, o_shippriority) is position-
    in-orders.) -> (group_map, pos_dims, nslots) or None."""
    group_map = []
    for g in plan.group_items:
        m = None
        for di, dim in enumerate(plan.dims):
            if dim.join_type != "inner":
                continue       # left-dim pos is garbage on misses
            if isinstance(g, ExprColumn):
                for sc in dim.dag.cols:
                    if sc.col.idx == g.idx:
                        m = ("dimcol", di, _cid_of(dim.dag, sc))
                        break
            if m is None and \
                    g.fingerprint() == dim.probe_expr.fingerprint():
                m = ("probekey", di, _cid_of(dim.dag, dim.build_key))
            if m is not None:
                break
        if m is None:
            return None
        group_map.append(m)
    if not group_map:
        return None
    pos_dims = sorted({di for _, di, _ in group_map})
    nslots = 1
    for di in pos_dims:
        nslots *= dim_metas[di]["n"]
    if nslots > _POS_DENSE_MAX:
        return None
    return group_map, pos_dims, nslots


def _compact_pos_dense(res, group_map, pos_dims, dim_metas, sd):
    """Decode dim positions back into group-key values (host side)."""
    res = prefetch(res)
    present = host_array(res["present"])
    slots = np.nonzero(present > 0)[0]
    rem = slots.copy()
    poses = {}
    for di in reversed(pos_dims):
        dn = dim_metas[di]["n"]
        poses[di] = rem % dn
        rem = rem // dn
    keys, key_nulls, key_dicts = [], [], []
    for kind, di, cid in group_map:
        pos = poses[di]
        data, nulls, sdict = dim_metas[di]["arrays"][cid]
        keys.append(data[pos].astype(np.int64))
        key_nulls.append(nulls[pos] if (kind == "dimcol" and
                                        nulls is not None)
                         else np.zeros(len(pos), dtype=bool))
        key_dicts.append(sdict)
    states = [[host_array(s)[slots] for s in st] for st in res["states"]]
    return PartialAggResult(ngroups=len(slots), keys=keys,
                            key_nulls=key_nulls, states=states,
                            key_dicts=key_dicts, state_dicts=sd)


def _compact_cols(cols, csum, cap, ccap):
    """Gather the rows under a mask into a ccap-row buffer, in order:
    `csum` is the mask's cumulative count over the cap rows, so output
    row j is the row where it first reaches j + 1 (searchsorted; rows
    past the count repeat the last row and are masked out by the
    caller). -> the columns {idx: (data, nulls, sdict)} at ccap rows."""
    src = torch.clamp(torch.searchsorted(csum, torch.arange(
        1, ccap + 1, dtype=INT64, device=csum.device)), max=cap - 1)
    return {k: (d[src], nl[src] if isinstance(nl, torch.Tensor) else nl,
                sd) for k, (d, nl, sd) in cols.items()}


def _make_pipeline_body(plan, fact_cap, fact_sdicts, dim_caps, dim_ns,
                        dim_sns, dim_layouts, dim_pres, agg_kind, agg_param,
                        xp, ecap=None, want_fnvalid=True):
    """The fragment callable: filter the fact partition -> dim probes and
    gathers -> post filters -> partial aggregation. fact_cap is the
    partition capacity, xp the TorchNS of the copr's device; dim_ns are
    the dims' row counts, dim_sns their valid sorted-key counts (the
    searchsorted bound). agg_kind "dense" takes the group layout
    `agg_param` (sizes), "posdense" (pos_dims, nslots), "onehot" (slot
    table capacity, compact capacity or None) with the learned slot
    table as the argument after the dims' (dag_exec.onehot_agg_body),
    "sort" (group bucket, lowering, top-N candidates or None, compact
    capacity or None); a result of either with a compact capacity
    carries nvalid, the rows that reached the aggregation, from which
    the caller learns or regrows the capacity (the sort kind's always
    does). The reference's one-hot program runs at the partition's
    rows; here it takes the sort kind's learned compact capacity too,
    as its rows are the sort kind's: Q7's survivors of five probes are
    a few thousand of 4,194,304, and packing and looking up every row's
    keys cost an H100 ~3 ms more device time per SF1 statement than the
    sort kind over the compacted rows (chip_smoke.py phase_programs). A
    top-N tuple (kind, index, desc, k') makes the sort kind return only
    k' candidate partials (_topn_select).

    ecap (early compaction): the rows that pass the fact filters are
    gathered into an ecap-row buffer before the probes, so the probes,
    post filters and aggregation run at ecap rows, not the partition's
    (Q14's and Q19's one-month or few-part filters keep 1-3 % of
    lineitem); want_fnvalid adds res["fnvalid"], the rows that passed
    the fact filters, from which the caller learns ecap and reruns a
    partition whose survivors overflowed it (the mesh program leaves it
    out, as the reference's does). The reference's _build_fused_kernel
    jit-compiles this body; torch runs it eagerly, so there is nothing
    to build. A zero-dim global aggregation (one slot) whose filters
    lower to column bounds runs them in range_filter_sums, with its
    products of two columns folded in (dag_exec.fold_pairs)."""
    fact_filters = list(plan.fact_dag.filters)
    dims = list(plan.dims)
    post = list(plan.post_filters)
    group_items = list(plan.group_items)
    aggs = list(plan.aggs)
    ranges = folds = None
    if agg_kind == "dense" and not dims and \
            all(size == 1 for size, _off in agg_param) and \
            kernel_aggs_fit(aggs):
        ranges = lower_filters(fact_filters)
        folds = fold_pairs(aggs) if ranges is not None else None

    def body(fjc, fvv, dargs):
        cap = fact_cap
        dev = xp.device
        cols = {k: (d, nl, fact_sdicts[k]) for k, (d, nl) in fjc.items()}
        ctx = EvalCtx(xp, cap, cols, host=False)
        mask = fvv
        if ranges is not None:
            for f in ranges.rest:
                mask = mask & eval_bool_mask(ctx, f)
            res = dense_agg_states_range(ctx, mask, aggs, ranges, cap,
                                         folds)
            if want_fnvalid:
                # no dims, no post filters: the kernel's count is the
                # fact filters' survivors
                res["fnvalid"] = res["present"][0]
            return res
        for f in fact_filters:
            mask = mask & eval_bool_mask(ctx, f)
        fnvalid = None
        if ecap is not None:
            csum0 = torch.cumsum(mask.to(INT64), 0)
            fnvalid = csum0[cap - 1]
            cols = _compact_cols(cols, csum0, cap, ecap)
            cap = ecap
            mask = torch.arange(ecap, dtype=INT64, device=dev) < fnvalid
            ctx = EvalCtx(xp, cap, cols, host=False)
        elif want_fnvalid:
            fnvalid = mask.sum(dtype=INT64)
        ctx, mask, dim_pos = _apply_dims(ctx, cols, mask, dims, dargs,
                                         dim_caps, dim_ns, dim_sns,
                                         dim_layouts, dim_pres, cap)
        for f in post:
            mask = mask & eval_bool_mask(ctx, f)
        if agg_kind == "posdense":
            pos_dims, nslots = agg_param
            slot = torch.zeros(cap, dtype=INT64, device=dev)
            for di in pos_dims:
                slot = slot * dim_ns[di] + dim_pos[di]
            slot = torch.where(mask, slot, nslots)
            res = dense_agg_states(ctx, mask, aggs, slot, nslots, cap)
        elif agg_kind == "dense":
            res = dense_agg_body(ctx, mask, group_items, aggs, agg_param,
                                 cap)
        else:
            # the sort kind and the one-hot slots: with a compact
            # capacity the rows that passed are first gathered into a
            # learned ccap-row buffer, so a selective pipeline's
            # aggregation pays for its survivors, not the partition; the
            # caller reruns with a larger ccap when nvalid exceeds it
            ccap = agg_param[-1]
            acap, nvalid = cap, None
            if ccap is not None or agg_kind == "sort":
                csum = torch.cumsum(mask.to(INT64), 0)
                nvalid = csum[cap - 1]
            if ccap is not None:
                ctx = EvalCtx(xp, ccap, _compact_cols(ctx.cols, csum, cap,
                                                      ccap), host=False)
                mask = torch.arange(ccap, dtype=INT64, device=dev) < nvalid
                acap = ccap
            if agg_kind == "onehot":
                res = _de.onehot_agg_body(ctx, mask, group_items, aggs,
                                          acap, agg_param[0],
                                          dargs[len(dims)])
            else:
                gb, agg_impl, topn, _ccap = agg_param
                res = sort_agg_body(ctx, mask, group_items, aggs, acap, gb,
                                    impl=agg_impl)
            if nvalid is not None:
                res["nvalid"] = nvalid
            if agg_kind == "sort" and topn is not None:
                res = _topn_select(res, aggs, topn, gb)
        if fnvalid is not None:
            res["fnvalid"] = fnvalid
        return res
    return body


def _decline_reason(plan, nullable=None):
    """-> why this plan's shape does not run on the device, or None when
    it does: the device rule (torch_ns.device_form) over the fact
    filters, the dims' filters and probe keys, the post filters, the
    group items and the aggregate arguments; `nullable(col_idx)` says
    whether a column may be bound with a NULL mask. Every group domain
    has a layout (dense, posdense or the sort kind, chosen at run time
    in _fused_partials_inner). A materialized dim's subplan is checked
    by its own operators when it runs."""
    exprs = list(plan.fact_dag.filters) + list(plan.post_filters) + \
        list(plan.group_items)
    for a in plan.aggs:
        exprs.extend(a.args)
    for d in plan.dims:
        exprs.extend(pe for _, pe in d.all_keys())
        if d.join_type not in ("semi", "anti") or d.extra_keys:
            # a prefiltered semi/anti dim folds its filters on the host
            exprs.extend(d.dag.filters)
    for e in exprs:
        decline = device_form(e, nullable)
        if decline is not None:
            return decline.reason
    return None


def _fact_nullable(plan, fact_tbl):
    """nullable(col_idx) for the device rule: a fact column is bound
    with a NULL mask when the table holds a NULL in it (the snapshot
    drops an all-false mask); any other column may be."""
    names = {sc.col.idx: sc.name for sc in plan.fact_dag.cols}
    n = fact_tbl.n

    def nullable(idx):
        if idx not in names:
            return True
        ci = fact_tbl.table_info.find_column(names[idx])
        nl = None if ci is None else fact_tbl.nulls.get(ci.id)
        return nl is not None and bool(nl[:n].any())
    return nullable


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


# one-hot slot tables apply to partitions of at most this many rows:
# the reference's guard for its int32 limb sums (cap * 127 < 2^31),
# kept so that both packages pick the same program for a partition
# (the int64 sums here are exact at any size)
_ONEHOT_CAP = 1 << 23


def _oh_eligible(copr, ohk, plan, one, pos_spec, sizes, delta_rows):
    """Does this statement learn and use a one-hot slot table (a group
    domain that is neither dense nor a join position, no uncommitted
    rows, only count and sum/avg of int64 arguments)? On the card as
    the reference's device rule says; on the CPU only when
    TIDB_TPU_ONEHOT_FORCE is set, as the reference's CPU backend."""
    if not plan.group_items or pos_spec is not None or \
            sizes is not None or delta_rows:
        return False
    if copr._host_cache.get(ohk) is False:
        return False
    if copr.device.type != "cuda" and \
            not os.environ.get("TIDB_TPU_ONEHOT_FORCE"):
        return False
    for a in plan.aggs:
        if a.name == "count":
            continue
        if a.name not in ("sum", "avg"):
            return False
        try:
            d1, _nl, _sd = eval_expr(EvalCtx(np, 1, one, host=True),
                                     a.args[0])
        except Exception:                   # noqa: BLE001
            return False
        dt = getattr(d1, "dtype", None)
        if dt is None or dt.kind != "i":
            return False            # the slot sums are int64 only
    return True


def _oh_learn_table(copr, ohk, plan, oh_learn, rows=0, version=None):
    """Learn the one-hot slot table from a sort-kind execution's
    partials (oh_learn: per partition, its key and NULL columns): the
    union of the group keys, packed with offsets and spans chosen here
    (the fragment range-checks each code, so a later out-of-span value
    is a miss, never an alias), as sorted packed keys with the key
    columns of each slot. `rows` and `version` are the fact coverage
    watermark (the snapshot's row count, the version read before it),
    from which _oh_fold_delta extends the table. A shape it cannot
    represent (non-integer keys, keys over int63, a pack of 61 bits or
    more, more than dag_exec._ONEHOT_MAX slots) pins it off."""
    K = len(plan.group_items)
    kcols = [np.concatenate([e[0][i] for e in oh_learn]) for i in range(K)]
    knulls = [np.concatenate([e[1][i] for e in oh_learn]) for i in range(K)]
    # spans first, and refuse before packing: a full-range key would
    # overflow the int64 pack
    los, spans = [], []
    total_bits = 0.0
    for i in range(K):
        vals = kcols[i]
        if vals.dtype.kind not in "iu":
            copr._host_cache[ohk] = False
            return
        nn = vals[~knulls[i]]
        lo = int(nn.min()) if len(nn) else 0
        hi = int(nn.max()) if len(nn) else 0
        if vals.dtype.kind == "u" and (lo > _I64_MAX or hi > _I64_MAX):
            copr._host_cache[ohk] = False
            return
        span = hi - lo + 2
        total_bits += np.log2(max(span, 1))
        los.append(lo)
        spans.append(span)
    if total_bits >= 61.0:
        copr._host_cache[ohk] = False
        return
    packed = np.zeros(len(kcols[0]), dtype=np.int64)
    for i in range(K):
        code = np.where(knulls[i], 0, kcols[i].astype(np.int64) - los[i] + 1)
        packed = packed * spans[i] + code
    uniq, idx = np.unique(packed, return_index=True)
    nslots = len(uniq)
    if nslots == 0 or nslots > _de._ONEHOT_MAX:
        copr._host_cache[ohk] = False
        return
    scap = 128
    while scap < nslots:
        scap <<= 1
    skeys = np.full(scap, _I64_MAX, dtype=np.int64)
    skeys[:nslots] = uniq
    table = {"skeys": skeys, "los": np.asarray(los, dtype=np.int64),
             "spans": np.asarray(spans, dtype=np.int64),
             "nslots": nslots, "scap": scap,
             "key_vals": [kcols[i][idx] for i in range(K)],
             "key_nulls": [knulls[i][idx] for i in range(K)],
             "rows": rows, "version": version}
    # resident from the statement that learned it: the next statement
    # dispatches it without an upload
    _oh_device(copr, table)
    copr._host_cache[ohk] = table


def _oh_device(copr, table):
    """The slot table's device copy ({"skeys", "los", "spans",
    "nslots"}), uploaded on first use and kept in the table (a table is
    replaced whole, never changed in place)."""
    dev = table.get("dev")
    if dev is None:
        arrays = {"skeys": table["skeys"], "los": table["los"],
                  "spans": table["spans"],
                  "nslots": np.asarray([table["nslots"]], dtype=np.int64)}
        dev = {k: copr._upload_padded(a, len(a)) for k, a in arrays.items()}
        table["dev"] = dev
    return dev


def _oh_tail_keys(plan, fact_arrays, lo, hi):
    """The group-key columns of fact rows [lo, hi), evaluated on the
    host: the delta fold's input. None when a group item reaches past
    the fact columns (a dim's keys: the fold cannot see those rows'
    probes; the dispatch-time miss covers them)."""
    cols = {}
    for sc in plan.fact_dag.cols:
        cid = _cid_of(plan.fact_dag, sc)
        if cid == -1:
            continue
        data, nulls, sdict = fact_arrays[cid]
        cols[sc.col.idx] = (data[lo:hi],
                            None if nulls is None else nulls[lo:hi], sdict)
    m = hi - lo
    ectx = EvalCtx(np, m, cols, host=True)
    kcols, knulls = [], []
    try:
        for g in plan.group_items:
            d, nl, _sd = eval_expr(ectx, g)
            if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
                d = np.full(m, d)
            d = np.asarray(d)
            if d.dtype.kind not in "iu":
                return None
            kcols.append(d.astype(np.int64))
            knulls.append(np.asarray(materialize_nulls(ectx, nl)))
    except Exception:                       # noqa: BLE001
        return None
    return kcols, knulls


def _oh_fold_delta(copr, ohk, plan, fact_arrays, n, version):
    """Fold the keys of fact rows appended since a slot table was
    learned (rows [table rows, n)) into it before a dispatch binds it:
    a new key inside the spans becomes a new slot (counted
    fused_onehot_delta_fold), an append of known keys only moves the
    watermark. A key outside the spans, or more slots than
    dag_exec._ONEHOT_MAX, drops the table for a relearn
    (fused_onehot_rebuild)."""
    OH = copr._host_cache.get(ohk)
    if not isinstance(OH, dict) or OH.get("version") == version:
        return
    dom = getattr(copr, "domain", None)
    rows = OH.get("rows", 0)
    if n <= rows:
        # deletes and updates leave tombstones: the slots stand, and a
        # slot without rows drops when the partials are read
        OH["version"] = version
        return
    tail = _oh_tail_keys(plan, fact_arrays, rows, n)
    if tail is None:
        return
    kcols, knulls = tail
    los, spans = OH["los"], OH["spans"]
    packed = np.zeros(n - rows, dtype=np.int64)
    for i in range(len(plan.group_items)):
        v, live = kcols[i], ~knulls[i]
        if live.any() and (int(v[live].min()) < int(los[i]) or
                           int(v[live].max()) > int(los[i]) +
                           int(spans[i]) - 2):
            copr._host_cache.pop(ohk, None)
            if dom is not None:
                dom.inc_metric("fused_onehot_rebuild")
            return
        code = np.where(knulls[i], 0, v - int(los[i]) + 1)
        packed = packed * int(spans[i]) + code
    nslots = OH["nslots"]
    uniq, first = np.unique(packed, return_index=True)
    fresh = ~np.isin(uniq, OH["skeys"][:nslots])
    if not fresh.any():
        OH["rows"], OH["version"] = n, version
        return
    merged = np.concatenate([OH["skeys"][:nslots], uniq[fresh]])
    order = np.argsort(merged, kind="stable")
    nnew = len(merged)
    if nnew > _de._ONEHOT_MAX:
        copr._host_cache[ohk] = False
        if dom is not None:
            dom.inc_metric("fused_onehot_rebuild")
        return
    scap = OH["scap"]
    while scap < nnew:
        scap <<= 1
    skeys = np.full(scap, _I64_MAX, dtype=np.int64)
    skeys[:nnew] = merged[order]
    fidx = first[fresh]
    key_vals, key_nulls = [], []
    for i in range(len(plan.group_items)):
        kv = np.concatenate([OH["key_vals"][i], kcols[i][fidx].astype(
            OH["key_vals"][i].dtype, copy=False)])
        kn = np.concatenate([OH["key_nulls"][i], knulls[i][fidx]])
        key_vals.append(kv[order])
        key_nulls.append(kn[order])
    # a new table, not an edit: a dispatch in flight keeps its own
    copr._host_cache[ohk] = {
        "skeys": skeys, "los": los, "spans": spans, "nslots": nnew,
        "scap": scap, "key_vals": key_vals, "key_nulls": key_nulls,
        "rows": n, "version": version}
    if dom is not None:
        dom.inc_metric("fused_onehot_delta_fold")


def _oh_drop_empty(out, oh_parts):
    """Drop the slots no one-hot partition had a row in (oh_parts: (index
    in out, rows per slot)): a learned key with no row left (deletes, an
    older read ts) must not become a phantom group; a key seen only in a
    sort-kind partial merges as usual."""
    total = np.zeros(len(oh_parts[0][1]), dtype=np.int64)
    for _i, rc in oh_parts:
        total += rc
    if not (total == 0).any():
        return
    keep = np.nonzero(total > 0)[0]
    for i, _rc in oh_parts:
        p0 = out[i]
        out[i] = PartialAggResult(
            ngroups=len(keep), keys=[k[keep] for k in p0.keys],
            key_nulls=[kn[keep] for kn in p0.key_nulls],
            states=[[s[keep] for s in st] for st in p0.states],
            key_dicts=p0.key_dicts, state_dicts=p0.state_dicts)


def fused_partials(copr, plan, read_ts, mesh=None,
                   bcast_threshold=1 << 20, ctx=None, delta_rows=None,
                   dead_handles=None):
    """Execute a PhysFusedPipeline -> [PartialAggResult] (one per fact
    partition; one per mesh shard for the mesh's sort layout), or None
    when the shape is not ported or not eligible at run time (caller
    falls back to the conventional subtree). With a mesh the whole
    pipeline runs as one mesh program: fact sharded, dims broadcast,
    aggregation allreduced (or a single big dim shuffled by key)."""
    # statement memory tracker for the upload seams (same install as
    # CoprExecutor.execute: the fused path uploads through _dev_put*
    # without passing through copr.execute)
    tr = getattr(ctx, "mem_tracker", None) if ctx is not None else None
    if tr is None:
        return _fused_partials_inner(copr, plan, read_ts, mesh,
                                     bcast_threshold, ctx, delta_rows,
                                     dead_handles)
    prev = _memory.push_current(tr)
    try:
        return _fused_partials_inner(copr, plan, read_ts, mesh,
                                     bcast_threshold, ctx, delta_rows,
                                     dead_handles)
    finally:
        _memory.set_current(prev)


def _fused_partials_inner(copr, plan, read_ts, mesh=None,
                          bcast_threshold=1 << 20, ctx=None,
                          delta_rows=None, dead_handles=None):
    engine = copr.engine
    fact_tbl = engine.table(plan.fact_dag.table_info)
    reason = _decline_reason(plan, _fact_nullable(plan, fact_tbl))
    if reason is not None:
        _set_reason(copr, reason)
        return None
    # incremental HTAP: fold committed deltas into resident buffers
    # FIRST (patched entries advance their version and survive), then
    # sweep what stayed stale — copr/delta.py
    copr.delta.refresh(fact_tbl, ctx)
    copr._dev_store.invalidate(fact_tbl.uid, fact_tbl.version)
    dim_metas = []
    for dim in plan.dims:
        if dim.subplan is not None:
            meta = _materialized_dim_meta(copr, ctx, dim, read_ts)
            if meta is None:
                return None
            dim_metas.append(meta)
            continue
        tbl = engine.table(dim.dag.table_info)
        copr.delta.refresh(tbl, ctx)
        copr._dev_store.invalidate(tbl.uid, tbl.version)
        if tbl.n == 0:
            if dim.join_type in ("inner", "semi"):
                return []         # inner/semi with empty dim: no rows
            dim_metas.append(_empty_dim_meta(dim, tbl))
            continue
        meta = _dim_sort_meta(copr, dim, tbl, read_ts)
        if meta is None:
            return None
        dim_metas.append(meta)
    # 1-row host ctx over ALL pipeline columns, read from the tables
    # before any snapshot: learn output dicts and the group layout
    one = {}
    fn = fact_tbl.n
    for sc in plan.fact_dag.cols:
        cid = _cid_of(plan.fact_dag, sc)
        if cid == -1:
            h = fact_tbl.handle_array()[:1]
            one[sc.col.idx] = (h if len(h) else np.zeros(1, np.int64),
                               None, None)
        else:
            data = fact_tbl.data[cid][:min(fn, 1)]
            one[sc.col.idx] = (data if len(data)
                               else np.zeros(1, data.dtype), None,
                               fact_tbl.dicts.get(cid))
    for dim, meta in zip(plan.dims, dim_metas):
        if dim.join_type in ("semi", "anti"):
            continue
        for sc in dim.dag.cols:
            cid = _cid_of(dim.dag, sc)
            if cid == -1:
                continue
            data, nulls, sdict = meta["arrays"][cid]
            one[sc.col.idx] = (data[:1] if len(data)
                               else np.zeros(1, data.dtype), None, sdict)
    shim = _AggShim(plan.group_items, plan.aggs)
    kd, sd = capture_agg_dicts(shim, one)
    pos_spec = _pos_group_map(plan, dim_metas)

    # the version BEFORE the snapshot: the one-hot table's coverage
    # watermark must never claim rows the snapshot did not hold
    fact_version = fact_tbl.version
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

    if mesh is not None:
        # a build side too large to replicate routes through the HASH
        # exchange (all_to_all shuffle) instead of Broadcast
        sh = _try_fused_shuffle(copr, plan, mesh, dim_metas, fact_tbl,
                                fact_arrays, fact_valid, n, handles,
                                bcast_threshold, ectx=ctx)
        if sh is not None:
            return sh

    # the delta partition builds BEFORE the dense sizes: its dict
    # encodes extend the shared dicts, so dict-derived dense sizes
    # (and dicts derived from them, captured again) cover delta codes
    delta_part = None
    if delta_rows:
        delta_part = _delta_partition(plan, fact_tbl, fact_arrays,
                                      delta_rows)
        kd, sd = capture_agg_dicts(shim, one)

    def dense_sizes(fcols):
        sizes = _dense_strides(shim, kd, fcols, n)
        if sizes is not None and delta_part is not None and \
                not _delta_in_span(shim, sizes, delta_part):
            # dense layouts clip group codes to the derived span: a
            # delta key OUTSIDE it would silently merge into a boundary
            # group; those executions take the exact sort kind
            return None
        return sizes
    sizes = None
    if pos_spec is None:
        fcols = None
        if not plan.dims and n:
            # zero-dim pipeline: int group keys dense-detect via a host
            # min/max pass over the fact arrays, exactly like the copr
            # reader path (a dim column's values are known only after
            # the probe, so with dims only dict-coded keys qualify)
            fcols = {}
            for sc in plan.fact_dag.cols:
                cid = _cid_of(plan.fact_dag, sc)
                fcols[sc.col.idx] = (handles, None, None) if cid == -1 \
                    else fact_arrays[cid]
        sizes = dense_sizes(fcols)
    if _segment_impl(copr.device) == "runs":
        # the reference's device rule: a dense or position domain over
        # _BCR_MAX slots takes the sort kind, lowered as runs (join
        # positions inherit the fact table's clustering, so Q3's
        # group-by-FK stays compact) instead of a scatter into slots
        if pos_spec is not None and pos_spec[2] > _de._BCR_MAX:
            pos_spec = None
            sizes = dense_sizes(None)
        if sizes is not None and _dense_nslots(sizes) > _de._BCR_MAX:
            sizes = None

    # upload dims once (shared across fact partitions)
    dim_args, dim_layouts, dim_caps, dim_ns, dim_sns = [], [], [], [], []
    for dim, meta in zip(plan.dims, dim_metas):
        dcap = shape_bucket(meta["n"])
        da, layout = _upload_dim(copr, dim, meta, dcap, read_ts, mesh)
        dim_args.append(da)
        dim_layouts.append(layout)
        dim_caps.append(dcap)
        dim_ns.append(meta["n"])
        dim_sns.append(meta["n_sorted"])
    dim_pres = tuple(bool(m.get("pre")) for m in dim_metas)

    fact_idx = {sc.col.idx for sc in plan.fact_dag.cols}
    fact_sdicts = {k: v[2] for k, v in one.items() if k in fact_idx}
    out = []
    step = copr.device_rows
    # the learned state, per query shape: the sort kind's group bucket;
    # per gc epoch (a compaction that restores clustering lets a pinned
    # shape try again) its lowering pin, its compact capacity, the early
    # compaction capacity, the top-N candidates' off pin and the one-hot
    # slot table
    gbkey = ("gb", fact_tbl.uid,
             tuple(g.fingerprint() for g in plan.group_items),
             tuple(a.fingerprint() for a in plan.aggs))
    implk = ("aggimpl", fact_tbl.gc_epoch) + gbkey
    compk = ("fcompact", fact_tbl.gc_epoch) + gbkey
    ecapk = ("fecompact", fact_tbl.gc_epoch) + gbkey
    offk = ("ftopn_off", fact_tbl.gc_epoch) + gbkey
    ohk = ("onehot", fact_tbl.gc_epoch) + gbkey
    group_bucket = max(1024, copr._host_cache.get(gbkey, 0))
    dom = getattr(copr, "domain", None)
    # appended rows' keys join a learned slot table before any dispatch
    # binds it: an append inside the table's spans extends its slots
    # instead of forcing a miss and a relearn
    _oh_fold_delta(copr, ohk, plan, fact_arrays, n, fact_version)
    if mesh is not None:
        return _run_fused_mpp(
            copr, plan, mesh, fact_tbl, fact_arrays, fact_valid, n,
            handles, dim_args, dim_metas, dim_caps, dim_ns, dim_sns,
            dim_layouts, dim_pres, fact_sdicts, pos_spec, sizes, shim, kd,
            sd, gbkey, implk, compk, group_bucket, read_ts)
    ts = _fused_topn_state(copr, plan, fact_tbl, offk, kd, sd)
    oh_elig = _oh_eligible(copr, ohk, plan, one, pos_spec, sizes,
                           delta_rows)
    oh_learn, oh_parts = [], []

    def _partitions():
        for start in range(0, n, step):
            sl = slice(start, min(start + step, n))
            pm = sl.stop - sl.start
            pcols = copr._bind_cols(plan.fact_dag, fact_tbl, fact_arrays,
                                    sl, handles,
                                    cacheable=(n == fact_tbl.n))
            # capture this partition's device-cache keys: the pipelined
            # loop binds the NEXT partition (overwriting copr._bind_keys)
            # before this one is consumed, and a retry binds it again
            yield pcols, fact_valid[sl], pm, dict(copr._bind_keys)
        if delta_part is not None:
            # the transaction's uncommitted inserts as one more fact
            # partition through the SAME fragment (device UnionScan);
            # empty bind keys: never device-cache dirty rows
            dcols, dv = delta_part
            yield dcols, dv, len(dv), {}

    def _dispatch_part(cols, v, m, bind_keys):
        """Upload + dispatch one fact partition with the programs learned
        so far. -> (result tree with its device->host copies in flight,
        capacity, agg kind, agg param, early compaction capacity or
        None, the one-hot slot table or None)."""
        cap = shape_bucket(m)
        oh_table = None
        ohv = copr._host_cache.get(ohk)
        if pos_spec is not None:
            agg_kind = "posdense"
            agg_param = (tuple(pos_spec[1]), pos_spec[2])
        elif sizes is not None:
            agg_kind, agg_param = "dense", tuple(sizes)
        elif isinstance(ohv, dict) and cap <= _ONEHOT_CAP:
            # the learned slot table travels in the dispatch state: a
            # sibling partition's miss may pop the cache entry before
            # this partition is consumed
            oh_table = ohv
            ccap = copr._host_cache.get(compk)
            agg_kind, agg_param = "onehot", (
                ohv["scap"], ccap if isinstance(ccap, int) else None)
        else:
            agg_kind = "sort"
            agg_param = _sort_kind_param(copr, compk, implk, group_bucket,
                                         ts, offk)
        ec = copr._host_cache.get(ecapk)
        # a zero-dim pipeline never compacts early: after its fact
        # filters comes one aggregation pass, which the gathers would
        # cost more than they save (the reference measured Q6 and Q15)
        ecap = ec if isinstance(ec, int) and ec < cap and plan.dims \
            else None
        if ecap is not None and agg_kind in ("sort", "onehot"):
            # the survivors are compacted already: no late compaction
            agg_param = agg_param[:-1] + (None,)

        def build():
            return _make_pipeline_body(
                plan, cap, fact_sdicts, tuple(dim_caps), tuple(dim_ns),
                tuple(dim_sns), tuple(dim_layouts), dim_pres, agg_kind,
                agg_param, copr.xp, ecap=ecap)
        if plan.dims:
            # an eager body with dims builds nothing worth keeping: it is
            # made for each call, so no cache can hand back a stale one
            kern = phase.timed_kernel("fused", build(), first=False)
        else:
            # a zero-dim body holds its range lowering (lower_filters,
            # fold_pairs), worth caching for warm statements
            key = _fused_cache_key(plan, fact_tbl, cap, agg_kind,
                                   agg_param, ecap)
            kern = copr._kernel_cache.get(key)
            if kern is None:
                kern = copr._kernel_cache.put(key, build())
        fjc_full, fvv = copr._pad_upload(cols, v, m, cap,
                                         bind_keys=bind_keys)
        fjc = {k: (d, nl) for k, (d, nl, _) in fjc_full.items()}
        kargs = dim_args if oh_table is None else \
            list(dim_args) + [_oh_device(copr, oh_table)]
        # chaos hook: per-partition fragment dispatch. The supervised
        # retry lives one level up (executors.FusedPipelineExec wraps
        # the whole fused_partials call in guarded_dispatch site="fused")
        failpoint.inject("device_guard/fused/kernel")
        return (prefetch(run_fragment(kern, fjc, fvv, kargs)), cap,
                agg_kind, agg_param, ecap, oh_table)

    def _relearn(metric, cols, v, m, bind_keys):
        if dom is not None:
            dom.inc_metric(metric)
        return _dispatch_part(cols, v, m, bind_keys)

    def _consume(state, cols, v, m, bind_keys):
        """Read one partition's result into `out`, first rerunning it
        while what it shows changes a learned program: early compaction
        that overflowed, a one-hot miss, the sort kind's regrows and
        pins, top-N candidates that cannot prove their cover. A rule on
        the shape of the data, not a fallback."""
        nonlocal group_bucket
        while True:
            res, cap, agg_kind, agg_param, ecap, oh_table = state
            # fnvalid counts the fact filters' survivors before any
            # compaction lost one: a run that overflowed ecap is wrong
            # and is not read
            if _compact_policy(copr, ecapk, ecap, host_int(res["fnvalid"]),
                               cap) == "retry":
                state = _relearn("fused_compact_regrow", cols, v, m,
                                 bind_keys)
                continue
            if ecap is not None and dom is not None:
                dom.inc_metric("fused_ecap_run")
            if agg_kind == "posdense":
                out.append(_compact_pos_dense(res, pos_spec[0], pos_spec[1],
                                              dim_metas, sd))
                return
            if agg_kind == "dense":
                out.append(_compact_dense(shim, res, sizes, kd, sd))
                return
            if agg_kind == "onehot":
                if agg_param[1] is not None and _compact_policy(
                        copr, compk, agg_param[1], host_int(res["nvalid"]),
                        cap) == "retry":
                    state = _relearn("fused_compact_regrow", cols, v, m,
                                     bind_keys)
                    continue
                if host_int(res["miss"]) > 0:
                    # keys the table lacks (new or changed data): the
                    # sort kind reruns the partition and relearns
                    copr._host_cache.pop(ohk, None)
                    state = _relearn("fused_onehot_miss", cols, v, m,
                                     bind_keys)
                    continue
                if dom is not None:
                    dom.inc_metric("fused_onehot_agg")
                states, rowcnt = _de.onehot_decode_states(
                    host_array(res["oh_acc"]), plan.aggs, oh_table["nslots"])
                oh_parts.append((len(out), rowcnt))
                out.append(PartialAggResult(
                    ngroups=oh_table["nslots"],
                    keys=[k.copy() for k in oh_table["key_vals"]],
                    key_nulls=[kn.copy() for kn in oh_table["key_nulls"]],
                    states=states, key_dicts=kd, state_dicts=sd))
                return
            ngroups = host_int(res["ngroups"])
            if _compact_policy(copr, compk, agg_param[3],
                               host_int(res["nvalid"]), cap) == "retry":
                state = _relearn("fused_compact_regrow", cols, v, m,
                                 bind_keys)
                continue
            # unclustered group keys pin this query shape to the sorted
            # lowering before an inflated bucket is learned; more groups
            # than the bucket THIS fragment ran with dropped groups
            rerun = _de.learn_sort_kind(copr._host_cache, gbkey, implk,
                                        agg_param[1], agg_param[0],
                                        ngroups, m)
            if rerun is not None:
                group_bucket = max(group_bucket,
                                   copr._host_cache.get(gbkey, 0))
                state = _relearn("fused_" + rerun, cols, v, m, bind_keys)
                continue
            topn = agg_param[2]
            nread = ngroups if topn is None else min(ngroups, topn[3])
            ks = [host_array(k)[:nread] for k in res["keys"]]
            kns = [host_array(kn)[:nread] for kn in res["key_nulls"]]
            sts = [[host_array(s)[:nread] for s in st]
                   for st in res["states"]]
            if topn is not None:
                if ngroups > topn[3] and not _topn_covered(
                        ts, plan.aggs, ks, kns, sts,
                        host_array(res["sel"])[:nread], ngroups):
                    # ties at the candidates' edge could hide a true
                    # top-k group: this query shape fetches every
                    # partial from now on
                    copr._host_cache[offk] = True
                    state = _relearn("fused_topn_off", cols, v, m,
                                     bind_keys)
                    continue
                if dom is not None:
                    dom.inc_metric("fused_topn_cand")
            elif oh_elig and copr._host_cache.get(ohk) is None:
                # runs partials may repeat a key once per run, so the
                # slot limit applies after the union dedupes
                # (_oh_learn_table); the cumulative bound caps the
                # staged host copies
                if sum(len(e[0][0]) for e in oh_learn) + ngroups > \
                        (1 << 21):
                    copr._host_cache[ohk] = False
                    oh_learn.clear()
                else:
                    oh_learn.append((ks, kns))
            out.append(PartialAggResult(
                ngroups=nread, keys=ks, key_nulls=kns, states=sts,
                key_dicts=kd, state_dicts=sd))
            return

    # partition pipelining: partition i+1's padding/upload/dispatch is
    # issued BEFORE partition i's results are consumed, so the card
    # computes while the host binds the next partition. A retry at
    # consume time reruns only its own partition, with what was learned
    pending = []
    for part in _partitions():
        pending.append((_dispatch_part(*part), part))
        if len(pending) >= _PIPELINE_DEPTH:
            state, part0 = pending.pop(0)
            _consume(state, *part0)
    for state, part0 in pending:
        _consume(state, *part0)
    if oh_parts:
        _oh_drop_empty(out, oh_parts)
    if oh_elig and oh_learn and len(oh_learn) == len(out) and \
            copr._host_cache.get(ohk) is None:
        _oh_learn_table(copr, ohk, plan, oh_learn, rows=n,
                        version=fact_version)
    return out


def run_fragment(kern, fjc, fvv, dargs):
    """Enqueue one fused fragment call: through dag_exec.run_fragment,
    the seam every device fragment takes (not its uploads nor its
    fetch), which chip_smoke.py runs under
    torch.cuda.set_sync_debug_mode("error")."""
    return _de.run_fragment(kern, fjc, fvv, dargs)


def _sort_kind_param(copr, compk, implk, group_bucket, ts=None,
                     offk=None):
    """The sort kind's parameters as learned so far: (group bucket,
    lowering, top-N candidates or None, compact capacity or None).
    Candidates (ts: _fused_topn_state's spec, k' = k + 66 of them) are
    sound only under the runs lowering, whose partials come in storage
    order, so the groups a partition edge may split are runs 0 and
    ngroups - 1, which _topn_select forces in; and only with a bucket of
    at least k + 2, below which the cover proof can never pass."""
    ccap = copr._host_cache.get(compk)
    impl = copr._host_cache.get(implk) or _segment_impl(copr.device)
    topn = None
    if ts is not None and impl == "runs" and group_bucket >= ts[3] + 2 \
            and not copr._host_cache.get(offk):
        topn = (ts[0], ts[1], ts[2], min(ts[3] + 66, group_bucket))
    return (group_bucket, impl, topn,
            ccap if isinstance(ccap, int) else None)


def _try_fused_shuffle(copr, plan, mesh, dim_metas, fact_tbl, fact_arrays,
                       fact_valid, n, handles, threshold, ectx=None):
    """Hash-exchange path (reference ExchangeType_Hash,
    fragment.go:168): a single big inner dimension + group-by a dim
    column + sum/count/avg over fact expressions -> both sides
    all_to_all by join key, local merge join + dense agg, psum
    (mpp/exec.py mpp_shuffle_join_agg). Returns [PartialAggResult] or
    None when the shape doesn't match (caller broadcasts instead)."""
    from ..mpp.exec import mpp_shuffle_join_agg
    if len(plan.dims) != 1 or plan.post_filters:
        return None
    dim, meta = plan.dims[0], dim_metas[0]
    if dim.join_type != "inner" or dim.extra_keys or \
            dim.subplan is not None or meta["n"] <= threshold:
        return None
    if len(plan.group_items) != 1 or not isinstance(plan.group_items[0],
                                                    ExprColumn):
        return None
    g = plan.group_items[0]
    gcid = None
    for sc in dim.dag.cols:
        if sc.col.idx == g.idx:
            gcid = _cid_of(dim.dag, sc)
    if gcid is None or gcid == -1:
        return None
    nd = meta["n"]
    pdata, pnulls, psdict = meta["arrays"][gcid]
    if pnulls is not None and pnulls[:nd].any():
        return None
    if psdict is not None:
        lo, size = 0, len(psdict.values) + 1
    else:
        if pdata.dtype.kind not in "iu" or nd == 0:
            return None
        lo = int(pdata[:nd].min())
        size = int(pdata[:nd].max()) - lo + 1
    if size > (1 << 18):
        return None
    fact_idxs = {sc.col.idx for sc in plan.fact_dag.cols}
    vals = []
    for a in plan.aggs:
        if a.name not in ("sum", "count", "avg"):
            return None
        if a.args:
            if not (_expr_idxs(a.args[0]) <= fact_idxs):
                return None
            vals.append(a.args[0])
        else:
            vals.append(None)
    # host-side prep: masks + probe keys + agg args (numpy, vectorized)
    key_cid = _cid_of(dim.dag, dim.build_key)
    bk = meta["arrays"][key_cid][0][:nd].astype(np.int64)
    dcols = {}
    for sc in dim.dag.cols:
        cid = _cid_of(dim.dag, sc)
        if cid != -1:
            data, nulls, sdict = meta["arrays"][cid]
            dcols[sc.col.idx] = (data[:nd], nulls, sdict)
    dctx = EvalCtx(np, nd, dcols, host=True)
    dmask = meta["valid"][:nd].copy()
    for f in dim.dag.filters:
        dmask &= np.asarray(eval_bool_mask(dctx, f))
    payload = pdata[:nd].astype(np.int64) - lo
    fcols = copr._bind_cols(plan.fact_dag, fact_tbl, fact_arrays,
                            slice(0, n), handles)
    fctx = EvalCtx(np, n, fcols, host=True)
    fmask = fact_valid[:n].copy()
    for f in plan.fact_dag.filters:
        fmask &= np.asarray(eval_bool_mask(fctx, f))
    pk, pnl, _ = eval_expr(fctx, dim.probe_expr)
    if np.isscalar(pk):
        pk = np.full(n, pk)
    pk = np.asarray(pk).astype(np.int64)
    fmask &= ~np.asarray(materialize_nulls(fctx, pnl))
    val_arrays = []
    for v in vals:
        if v is None:
            val_arrays.append(np.ones(n, dtype=np.int64))
        else:
            d, nl, _ = eval_expr(fctx, v)
            if np.isscalar(d):
                d = np.full(n, d)
            if np.asarray(materialize_nulls(fctx, nl)).any():
                return None               # per-val null masks unsupported
            val_arrays.append(np.asarray(d))
    ndev = mesh.size
    lane = 128 * ndev

    def pad(arr, m, fill=0):
        p = ((m + lane - 1) // lane) * lane
        if p == m:
            return arr
        return np.concatenate([arr, np.full(p - m, fill, dtype=arr.dtype)])

    cap_hint = 0
    if ectx is not None:
        try:
            cap_hint = int(ectx.sv.get("tidb_tpu_mpp_shuffle_cap"))
        except Exception:               # noqa: BLE001
            pass
    # capacity cache key: both tables' uid+version, the probe expression,
    # BOTH sides' filters (a selective query's small learned cap must
    # not leak to an unfiltered one) and the topology
    cap_key = (fact_tbl.uid, fact_tbl.version, meta["tbl"].uid,
               meta["tbl"].version, dim.probe_expr.fingerprint(),
               tuple(f.fingerprint() for f in plan.fact_dag.filters),
               tuple(f.fingerprint() for f in dim.dag.filters),
               key_cid, mesh.fingerprint())
    sums, cnts = mpp_shuffle_join_agg(
        mesh, pad(pk, n), [pad(v, n) for v in val_arrays],
        pad(fmask, n, False), pad(bk, nd), pad(payload, nd),
        pad(dmask, nd, False), n_groups=size, ectx=ectx,
        cap_key=cap_key, cap_hint=cap_hint)
    slots = np.nonzero(cnts > 0)[0]
    keys = [(slots + lo).astype(np.int64)]
    states = []
    for a, s in zip(plan.aggs, sums):
        if a.name == "count":
            states.append([cnts[slots]])
        else:
            states.append([s[slots], cnts[slots]])
    if getattr(copr, "domain", None) is not None:
        copr.domain.inc_metric("fused_shuffle_join")
    return [PartialAggResult(
        ngroups=len(slots), keys=keys,
        key_nulls=[np.zeros(len(slots), dtype=bool)],
        states=states, key_dicts=[psdict], state_dicts=[None] * len(states))]


def _expr_idxs(e):
    s = set()
    e.collect_columns(s)
    return s


def _run_fused_mpp(copr, plan, mesh, fact_tbl, fact_arrays, fact_valid, n,
                   handles, dim_args, dim_metas, dim_caps, dim_ns, dim_sns,
                   dim_layouts, dim_pres, fact_sdicts, pos_spec, sizes,
                   shim, kd, sd, gbkey, implk, compk, group_bucket,
                   read_ts):
    """Mesh execution: ONE mesh program over the whole fact table. Each
    shard runs the partition body at its rows; dense layouts merge by
    psum, the sort kind's per-shard partials reach the coordinator in
    one fetch and learn its bucket, lowering and compact capacity from
    the largest shard, as a partition does."""
    from ..expression.torch_ns import TorchNS
    from ..mpp.exec import exchange_observed, tree_nbytes
    from ..parallel.mesh import shard_map, to_coordinator
    from .delta import append_key
    ndev = mesh.size
    lane = 128 * ndev
    # bucketed lane-multiple padding: the sharded fact buffers and the
    # program shape survive appends within a bucket, so the delta
    # maintainer tail-patches them instead of re-keying every `lane`
    # rows (copr/delta.py)
    padded = ((shape_bucket(n) + lane - 1) // lane) * lane
    local = padded // ndev
    cols = copr._bind_cols(plan.fact_dag, fact_tbl, fact_arrays,
                           slice(0, n), handles)
    fjc = {}
    ver = fact_tbl.version
    epoch = fact_tbl.gc_epoch
    mk = mesh.fingerprint()         # the placement rides in every key
    for sc in plan.fact_dag.cols:
        cid = _cid_of(plan.fact_dag, sc)
        data, nulls, _sd = cols[sc.col.idx]
        jd = copr._dev_put_append(
            append_key(fact_tbl.uid, "mppf", cid,
                       "h" if cid == -1 else "d", epoch, (mk,), padded),
            data, n, padded, fact_tbl.uid, ver, epoch, 0, None,
            mesh=mesh, spec="sharded")
        jn = None
        if nulls is not None:
            jn = copr._dev_put_append(
                append_key(fact_tbl.uid, "mppf", cid, "n", epoch, (mk,),
                           padded),
                nulls, n, padded, fact_tbl.uid, ver, epoch, 0, None,
                pad_fill=True, mesh=mesh, spec="sharded")
        fjc[sc.col.idx] = (jd, jn)
    # the fact validity mask is (version, read_ts)-immutable: resident
    # like the sharded columns
    fvv = copr._dev_put(
        (fact_tbl.uid, "mppfv", ver, read_ts, mk, padded),
        fact_valid[:n], pad_fill=False, uid=fact_tbl.uid, version=ver,
        mesh=mesh, spec="sharded")
    dom = getattr(copr, "domain", None)
    aggs = list(plan.aggs)
    while True:
        if pos_spec is not None:
            agg_kind = "posdense"
            agg_param = (tuple(pos_spec[1]), pos_spec[2])
        elif sizes is not None:
            agg_kind, agg_param = "dense", tuple(sizes)
        else:
            agg_kind = "sort"
            agg_param = _sort_kind_param(copr, compk, implk, group_bucket)
        dense = agg_kind != "sort"

        def build(kind=agg_kind, param=agg_param, dense=dense):
            def body_for(dev):
                return _make_pipeline_body(
                    plan, local, fact_sdicts, tuple(dim_caps),
                    tuple(dim_ns), tuple(dim_sns), tuple(dim_layouts),
                    dim_pres, kind, param, TorchNS(dev),
                    want_fnvalid=False)
            if dense:
                return shard_map(mesh, body_for, lambda outs:
                                 _de.psum_dense_result(outs, aggs, mesh))
            return shard_map(mesh, body_for,
                             lambda outs: to_coordinator(outs, mesh))
        if plan.dims:
            kern = phase.timed_kernel("fused", build(), first=False)
        else:
            key = _fused_cache_key(plan, fact_tbl, local, agg_kind,
                                   agg_param) + \
                ("mpp", mk, padded)
            kern = copr._kernel_cache.get(key)
            if kern is None:
                kern = copr._kernel_cache.put(key, build())
        failpoint.inject("device_guard/fused/kernel")
        res = run_fragment(kern, fjc, fvv, dim_args)
        # PassThrough exchange: dense layouts merged by psum in the
        # program; the sort kind ships per-shard partials in one fetch
        exchange_observed("passthrough", tree_nbytes(res))
        res = prefetch(res)
        if agg_kind == "posdense":
            return [_compact_pos_dense(res, pos_spec[0], pos_spec[1],
                                       dim_metas, sd)]
        if agg_kind == "dense":
            return [_compact_dense(shim, res, sizes, kd, sd)]
        ngs = [host_int(r["ngroups"]) for r in res]
        if _compact_policy(copr, compk, agg_param[3],
                           max(host_int(r["nvalid"]) for r in res),
                           local) == "retry":
            if dom is not None:
                dom.inc_metric("fused_compact_regrow")
            continue
        rerun = _de.learn_sort_kind(copr._host_cache, gbkey, implk,
                                    agg_param[1], agg_param[0], max(ngs),
                                    local)
        if rerun is not None:
            group_bucket = max(group_bucket,
                               copr._host_cache.get(gbkey, 0))
            if dom is not None:
                dom.inc_metric("fused_" + rerun)
            continue
        return [PartialAggResult(
            ngroups=ng,
            keys=[host_array(k)[:ng] for k in r["keys"]],
            key_nulls=[host_array(kn)[:ng] for kn in r["key_nulls"]],
            states=[[host_array(s)[:ng] for s in st]
                    for st in r["states"]],
            key_dicts=kd, state_dicts=sd)
            for ng, r in zip(ngs, res) if ng > 0]


def _fused_cache_key(plan, fact_tbl, cap, agg_kind, agg_param, ecap=None):
    """What a zero-dim fragment bakes in: the plan's expressions, the
    partition capacity, the fact table's dictionary sizes, the
    aggregation kind with its parameters (the dense group layout, the
    one-hot table's capacity, or the sort kind's bucket, lowering,
    top-N candidates and compact capacity: a regrown bucket never reuses
    a fragment built for the old one) and the early compaction capacity
    (None: a zero-dim pipeline never compacts early)."""
    dict_vers = tuple(sorted((cid, len(d.values))
                             for cid, d in fact_tbl.dicts.items()))
    fps = tuple(f.fingerprint() for f in plan.fact_dag.filters)
    gfps = tuple(g.fingerprint() for g in plan.group_items)
    afps = tuple(a.fingerprint() for a in plan.aggs)
    colsig = tuple(sorted((sc.col.idx, sc.name)
                          for sc in plan.fact_dag.cols))
    return ("fused", fact_tbl.uid, cap, fps, gfps, afps, dict_vers, colsig,
            agg_kind, agg_param, ecap)
