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

  fact filters        evaluator ops of expression/torch_ns.TORCH_OPS
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

Not yet ported, each declined before dispatch with last_fused_reason
"not yet ported: ..." so the executor takes its counted host path:
materialized (subplan) dims (Q13, Q17, Q21) and device ops outside
TORCH_OPS. The reference's one-hot aggregation, its device top-N
candidate selection and its early compaction of fact-filter survivors
(ecap) are learned speed-ups that give the same rows and are not ported
either. The MPP mesh path is not ported (one card).
"""
from __future__ import annotations

import re

import numpy as np

import torch

from ..expression import EvalCtx, eval_expr, eval_bool_mask
from ..expression.expr import Column as ExprColumn
from ..expression.vec import materialize_nulls
from ..expression.torch_ns import TORCH_OPS, ops_of
from ..chunk.device import shape_bucket
from ..utils.torchcfg import INT64
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


def _upload_dim(copr, dim, meta, cap, read_ts):
    """Pad + upload dim arrays through the device-resident store; -> (the
    fragment's per-dim argument dict, {col idx: (has_nulls, sdict)}).
    The probe's scalars (lo, the composite pack layout) ride as python
    ints, so a new key range reuses the fragment and uploads nothing."""
    tbl = meta["tbl"]
    n = meta["n"]
    ver = tbl.version
    mk = tuple(meta.get("ukey", ()))
    # plain dim column data is append-only table state: it rides the
    # delta-maintained append seam (copr/delta.py) when the meta wraps
    # a REAL columnar table — the fabricated empty-dim placeholder
    # arrays must not (they are not the table's columns)
    appendable = hasattr(tbl, "gc_epoch") and not meta.get("synthetic")

    def put(tag, arr, length, acap, fill=0, ts_keyed=False):
        # plain column data depends only on the table version; only the
        # MVCC-derived arrays (valid mask, lut/sort built over the valid
        # set) vary with the snapshot ts — keying data by ts would
        # re-upload every dim column once per transaction. _dev_put
        # reads the pad capacity from key[-1]: acap stays LAST.
        key = (tbl.uid, tag, ver, read_ts if ts_keyed else None,
               length) + mk + (acap,)
        return copr._dev_put(key, arr, pad_fill=fill, uid=tbl.uid,
                             version=ver)

    def put_col(cid, kind, arr, acap, fill=0):
        # append seam for raw dim columns: the whole column [0, n)
        # padded to acap, tail-patched under appends instead of
        # re-uploaded on every dim-table version bump
        from .delta import append_key
        key = append_key(tbl.uid, ("dim",) + mk, cid, kind,
                         tbl.gc_epoch, (), acap)
        return copr._dev_put_append(key, arr, n, acap, tbl.uid, ver,
                                    tbl.gc_epoch, 0, None, pad_fill=fill)

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


def _make_pipeline_body(plan, fact_cap, fact_sdicts, dim_caps, dim_ns,
                        dim_sns, dim_layouts, dim_pres, agg_kind, agg_param,
                        xp):
    """The fragment callable: filter the fact partition -> dim probes and
    gathers -> post filters -> partial aggregation. fact_cap is the
    partition capacity, xp the TorchNS of the copr's device; dim_ns are
    the dims' row counts, dim_sns their valid sorted-key counts (the
    searchsorted bound). agg_kind "dense" takes the group layout
    `agg_param` (sizes), "posdense" (pos_dims, nslots), "sort" (group
    bucket, lowering, top-N (always None: not ported), compact capacity
    or None); a sort result also carries nvalid, the rows that reached
    the aggregation, from which the caller learns the capacity. The
    reference's
    _build_fused_kernel jit-compiles this body; torch runs it eagerly,
    so there is nothing to build. A zero-dim global aggregation (one
    slot) whose filters lower to column bounds runs them in
    range_filter_sums, with its products of two columns folded in
    (dag_exec.fold_pairs)."""
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
        ctx, mask, dim_pos = _apply_dims(ctx, cols, mask, dims, dargs,
                                         dim_caps, dim_ns, dim_sns,
                                         dim_layouts, dim_pres, cap)
        for f in post:
            mask = mask & eval_bool_mask(ctx, f)
        if agg_kind == "posdense":
            pos_dims, nslots = agg_param
            slot = torch.zeros(cap, dtype=INT64, device=xp.device)
            for di in pos_dims:
                slot = slot * dim_ns[di] + dim_pos[di]
            slot = torch.where(mask, slot, nslots)
            return dense_agg_states(ctx, mask, aggs, slot, nslots, cap)
        if agg_kind == "dense":
            return dense_agg_body(ctx, mask, group_items, aggs, agg_param,
                                  cap)
        gb, agg_impl, _topn, ccap = agg_param
        csum = torch.cumsum(mask.to(INT64), 0)
        nvalid = csum[cap - 1]
        if ccap is not None:
            # compact, then aggregate: the rows that passed are gathered
            # in order into a learned ccap-row buffer (cumsum +
            # searchsorted + gather), so a selective pipeline's sort or
            # runs pass pays for its survivors, not the partition. The
            # caller reruns with a larger ccap when nvalid exceeds it.
            dev = xp.device
            src = torch.clamp(torch.searchsorted(csum, torch.arange(
                1, ccap + 1, dtype=INT64, device=dev)), max=cap - 1)
            ccols = {k: (d[src], nl[src] if isinstance(nl, torch.Tensor)
                         else nl, sd) for k, (d, nl, sd) in ctx.cols.items()}
            res = sort_agg_body(
                EvalCtx(xp, ccap, ccols, host=False),
                torch.arange(ccap, dtype=INT64, device=dev) < nvalid,
                group_items, aggs, ccap, gb, impl=agg_impl)
        else:
            res = sort_agg_body(ctx, mask, group_items, aggs, cap, gb,
                                impl=agg_impl)
        res["nvalid"] = nvalid
        return res
    return body


def _decline_reason(plan):
    """-> why this plan's shape is not ported to the device yet, or None
    when it is: table dims (no subplan), evaluator ops checked under
    torch in the fact filters, the dims' filters and probe keys, the
    post filters, the group items and the aggregate arguments. Every
    group domain has a layout (dense, posdense or the sort kind,
    chosen at run time in _fused_partials_inner)."""
    if any(d.subplan is not None for d in plan.dims):
        return "not yet ported: materialized (subplan) dimensions"
    exprs = list(plan.fact_dag.filters) + list(plan.post_filters) + \
        list(plan.group_items)
    for a in plan.aggs:
        exprs.extend(a.args)
    for d in plan.dims:
        exprs.extend(pe for _, pe in d.all_keys())
        if d.join_type not in ("semi", "anti") or d.extra_keys:
            # a prefiltered semi/anti dim folds its filters on the host
            exprs.extend(d.dag.filters)
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
    dim_metas = []
    for dim in plan.dims:
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
        da, layout = _upload_dim(copr, dim, meta, dcap, read_ts)
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
    # the sort kind's learned state, per query shape; the lowering pin
    # and the compact capacity per gc epoch (a compaction that restores
    # clustering lets a pinned shape try runs again)
    gbkey = ("gb", fact_tbl.uid,
             tuple(g.fingerprint() for g in plan.group_items),
             tuple(a.fingerprint() for a in plan.aggs))
    implk = ("aggimpl", fact_tbl.gc_epoch) + gbkey
    compk = ("fcompact", fact_tbl.gc_epoch) + gbkey
    group_bucket = max(1024, copr._host_cache.get(gbkey, 0))
    dom = getattr(copr, "domain", None)

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
        """Upload + dispatch one fact partition with the lowering learned
        so far. -> (result tree with its device->host copies in flight,
        capacity, agg kind, agg param)."""
        cap = shape_bucket(m)
        if pos_spec is not None:
            agg_kind = "posdense"
            agg_param = (tuple(pos_spec[1]), pos_spec[2])
        elif sizes is not None:
            agg_kind, agg_param = "dense", tuple(sizes)
        else:
            ccap = copr._host_cache.get(compk)
            agg_kind, agg_param = "sort", (
                group_bucket,
                copr._host_cache.get(implk) or _segment_impl(copr.device),
                None, ccap if isinstance(ccap, int) else None)

        def build():
            return _make_pipeline_body(
                plan, cap, fact_sdicts, tuple(dim_caps), tuple(dim_ns),
                tuple(dim_sns), tuple(dim_layouts), dim_pres, agg_kind,
                agg_param, copr.xp)
        if plan.dims:
            # an eager body with dims builds nothing worth keeping: it is
            # made for each call, so no cache can hand back a stale one
            kern = phase.timed_kernel("fused", build(), first=False)
        else:
            # a zero-dim body holds its range lowering (lower_filters,
            # fold_pairs), worth caching for warm statements
            key = _fused_cache_key(plan, fact_tbl, cap, agg_kind,
                                   agg_param)
            kern = copr._kernel_cache.get(key)
            if kern is None:
                kern = copr._kernel_cache.put(key, build())
        fjc_full, fvv = copr._pad_upload(cols, v, m, cap,
                                         bind_keys=bind_keys)
        fjc = {k: (d, nl) for k, (d, nl, _) in fjc_full.items()}
        # chaos hook: per-partition fragment dispatch. The supervised
        # retry lives one level up (executors.FusedPipelineExec wraps
        # the whole fused_partials call in guarded_dispatch site="fused")
        failpoint.inject("device_guard/fused/kernel")
        return (prefetch(run_fragment(kern, fjc, fvv, dim_args)), cap,
                agg_kind, agg_param)

    def _relearn(metric, cols, v, m, bind_keys):
        if dom is not None:
            dom.inc_metric(metric)
        return _dispatch_part(cols, v, m, bind_keys)

    def _consume(state, cols, v, m, bind_keys):
        nonlocal group_bucket
        while True:
            res, cap, agg_kind, agg_param = state
            if agg_kind == "posdense":
                return _compact_pos_dense(res, pos_spec[0], pos_spec[1],
                                          dim_metas, sd)
            if agg_kind == "dense":
                return _compact_dense(shim, res, sizes, kd, sd)
            ngroups = host_int(res["ngroups"])
            if _compact_policy(copr, compk, agg_param[3],
                               host_int(res["nvalid"]), cap) == "retry":
                state = _relearn("fused_compact_regrow", cols, v, m,
                                 bind_keys)
                continue
            if agg_param[1] == "runs" and \
                    ngroups > max(_de._RUNS_DEGRADE_MIN, m // 4):
                # unclustered group keys: pin this query shape to the
                # sorted lowering before learning an inflated bucket.
                # A rule on the shape of the data, not a fallback
                copr._host_cache[implk] = "sorted"
                state = _relearn("fused_runs_degrade", cols, v, m,
                                 bind_keys)
                continue
            if ngroups > agg_param[0]:
                # compare with the bucket THIS fragment ran with: an
                # overflowed run dropped groups and must run again
                group_bucket = max(group_bucket, shape_bucket(ngroups))
                copr._host_cache[gbkey] = group_bucket
                state = _relearn("fused_bucket_regrow", cols, v, m,
                                 bind_keys)
                continue
            return PartialAggResult(
                ngroups=ngroups,
                keys=[host_array(k)[:ngroups] for k in res["keys"]],
                key_nulls=[host_array(kn)[:ngroups]
                           for kn in res["key_nulls"]],
                states=[[host_array(s)[:ngroups] for s in st]
                        for st in res["states"]],
                key_dicts=kd, state_dicts=sd)

    # partition pipelining: partition i+1's padding/upload/dispatch is
    # issued BEFORE partition i's results are consumed, so the card
    # computes while the host binds the next partition. A retry at
    # consume time reruns only its own partition, with what was learned
    pending = []
    for part in _partitions():
        pending.append((_dispatch_part(*part), part))
        if len(pending) >= _PIPELINE_DEPTH:
            state, part0 = pending.pop(0)
            out.append(_consume(state, *part0))
    for state, part0 in pending:
        out.append(_consume(state, *part0))
    return out


def run_fragment(kern, fjc, fvv, dargs):
    """Enqueue one fragment call on the card: the seam around the
    fragment alone (not its uploads or its fetch), which chip_smoke.py
    runs under torch.cuda.set_sync_debug_mode("error") to show that the
    fragment never waits on the card."""
    return kern(fjc, fvv, dargs)


def _fused_cache_key(plan, fact_tbl, cap, agg_kind, agg_param):
    """What a zero-dim fragment bakes in: the plan's expressions, the
    partition capacity, the fact table's dictionary sizes and the
    aggregation kind with its parameters (the dense group layout, or
    the sort kind's bucket, lowering and compact capacity: a regrown
    bucket never reuses a fragment built for the old one)."""
    dict_vers = tuple(sorted((cid, len(d.values))
                             for cid, d in fact_tbl.dicts.items()))
    fps = tuple(f.fingerprint() for f in plan.fact_dag.filters)
    gfps = tuple(g.fingerprint() for g in plan.group_items)
    afps = tuple(a.fingerprint() for a in plan.aggs)
    colsig = tuple(sorted((sc.col.idx, sc.name)
                          for sc in plan.fact_dag.cols))
    return ("fused", fact_tbl.uid, cap, fps, gfps, afps, dict_vers, colsig,
            agg_kind, agg_param)
