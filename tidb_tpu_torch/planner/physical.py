"""Physical plan (reference pkg/planner/core/operator/physicalop).

The TPU-relevant decision happens here: which part of the tree becomes a
coprocessor DAG executed on device per partition (scan + filter + partial
aggregation — reference tipb.DAGRequest built in
executor/internal/builder/builder_utils.go:64), and which operators run as
host-orchestrated device ops above the readers."""
from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..expression import Column, Constant, ScalarFunc, AggDesc, const_from_py
from ..expression.vec import is_device_safe
from ..types.field_type import new_bigint_type
from .schema import Schema, SchemaCol
from .logical import (LogicalPlan, DataSource, Selection, Projection,
                      Aggregation, LJoin, Sort, LimitOp, TopN, Dual, UnionOp,
                      WindowOp)
from .builder import ProjShell

_PUSHABLE_AGGS = {"sum", "count", "min", "max", "avg", "first_row"}


class PhysPlan:
    def __init__(self, children=None, schema: Schema | None = None):
        self.children = children or []
        self.schema = schema or Schema()
        self.stats_rows = 0.0

    @property
    def child(self):
        return self.children[0]

    def name(self):
        return type(self).__name__.replace("Phys", "")

    def explain_info(self):
        return ""

    def explain_rows(self, out, depth=0, ident=None):
        ident = ident or [0]
        my_id = f"{self.name()}_{ident[0]}"
        ident[0] += 1
        out.append((my_id, depth, f"{self.stats_rows:.2f}",
                    self.explain_info()))
        for c in self.children:
            c.explain_rows(out, depth + 1, ident)
        return out


@dataclass
class CoprDAG:
    """Pushed-down per-partition program: scan -> filter -> partial agg /
    topn / limit, compiled to one jit kernel per shape bucket."""

    table_info: object = None
    db_name: str = ""
    cols: list = field(default_factory=list)        # [SchemaCol] to scan
    filters: list = field(default_factory=list)     # device-safe conjuncts
    host_filters: list = field(default_factory=list)
    group_items: list = field(default_factory=list)
    aggs: list = field(default_factory=list)        # partial AggDescs
    limit: int = -1                                 # scan-level limit
    topn: tuple | None = None                       # ((expr, desc), k)
    part_sel: list | None = None    # explicit PARTITION (p, ...) pids


class PhysTableReader(PhysPlan):
    def __init__(self, dag: CoprDAG, schema: Schema):
        super().__init__([], schema)
        self.dag = dag

    def explain_info(self):
        s = f"table:{self.dag.table_info.name}"
        tbl = self.dag.table_info
        if tbl.partitions:
            # plan-time pruning display (reference
            # rule_partition_processor.go); same prune as execution
            from ..storage.partition import prune_for_dag
            pids = prune_for_dag(self.dag)
            names = {p["pid"]: p["name"] for p in
                     tbl.partitions["parts"]}
            s += ", partition:" + ",".join(names[p] for p in pids)
        if self.dag.filters or self.dag.host_filters:
            s += f", filters:{self.dag.filters + self.dag.host_filters}"
        if self.dag.aggs:
            s += (f", partial_agg:[{', '.join(map(repr, self.dag.aggs))}] "
                  f"group:[{', '.join(map(repr, self.dag.group_items))}]")
        return s


@dataclass
class DimJoin:
    """One dimension join stage of a fused pipeline: probe the (sorted)
    build-key column of `dag`'s table with `probe_expr` evaluated over the
    pipeline columns; gather payload columns on match.

    `extra_keys` widens the join to a composite key (Q9's lineitem ⋈
    partsupp on (l_partkey, l_suppkey)): the runtime packs all key
    columns into one int64 by per-column stride (spans measured from the
    data), so the probe stays ONE searchsorted/gather — uniqueness is
    verified on the packed value."""

    dag: object = None          # CoprDAG: dim scan cols + device filters
    build_key: object = None    # SchemaCol in dag.cols — must be unique
    probe_expr: object = None   # Expression over pipeline columns
    join_type: str = "inner"    # inner | semi
    extra_keys: tuple = ()      # ((SchemaCol, Expression), ...) composite
    subplan: object = None      # PhysPlan: materialized dim (agg leaf)

    def all_keys(self):
        return ((self.build_key, self.probe_expr),) + tuple(self.extra_keys)


class _MatCol:
    __slots__ = ("id",)

    def __init__(self, i):
        self.id = i


class _MatTableInfo:
    """Synthetic table_info for a materialized (subplan) dim: columns
    address by POSITION in the subplan's output schema. Ambiguous
    display names resolve to nothing (the runtime then rejects and the
    query falls back)."""

    def __init__(self, name, cols):
        self.id = -4242
        self.name = name
        self.partitions = []
        self.pk_is_handle = False
        self.pk_col_name = ""
        self.dicts = {}
        by_name = {}
        dropped = set()
        for i, sc in enumerate(cols):
            nm = (sc.name or f"_c{i}").lower()
            if nm in by_name:
                dropped.add(nm)
            by_name[nm] = _MatCol(i)
        for nm in dropped:
            del by_name[nm]
        self._by_name = by_name

    def find_column(self, name):
        return self._by_name.get(name.lower())

    def public_indexes(self):
        return []


class _AggLeaf:
    """Join-tree leaf that is itself an aggregation subtree (Q17's
    decorrelated per-partkey AVG, Q18's IN (... GROUP BY ... HAVING)):
    the runtime executes the subtree, and the group keys — unique by
    construction — become the dim build keys. Reference analog: TiFlash
    executing the subquery fragment and shipping its result as the
    build side (fragment.go Broadcast exchange)."""

    def __init__(self, plan, agg):
        self.plan = plan
        self.agg = agg
        cols = list(plan.schema.cols)
        self.dag = CoprDAG(table_info=_MatTableInfo("subquery", cols),
                           db_name="", cols=cols)
        self.stats_rows = plan.stats_rows
        self.raw_rows = plan.stats_rows

    def unique_on(self, col_idx):
        """Unique iff the column IS the sole group key of the root agg
        (projection-wrapped roots decline; the runtime still verifies)."""
        if self.plan is not self.agg or len(self.agg.group_items) != 1:
            return False
        cols = self.agg.schema.cols
        return bool(cols) and cols[0].col.idx == col_idx


def _try_agg_leaf(p):
    q = p
    while isinstance(q, (PhysShell, PhysSelection, PhysProjection)) \
            and q.children:
        q = q.children[0]
    if isinstance(q, PhysHashAgg):
        return _AggLeaf(p, q)
    return None


import hashlib as _hashlib


def _syn_id(*parts):
    """Content-derived synthesized column id in [2^40, 2^62) — disjoint
    from the builder's allocator AND deterministic across plan rebuilds
    of the same SQL. A global counter here leaked a fresh id into every
    expression fingerprint, so every execution produced a brand-new
    fused-kernel cache key and re-paid the fragment build (q21's
    'warm' runs were one build per run). Identical content hashing to
    identical ids is sound: the columns then carry identical values."""
    s = "\x1f".join(str(p) for p in parts)
    h = int.from_bytes(
        _hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")
    return (1 << 40) | (h >> 2)


def _swap_join_build(root, joinnode, subagg):
    """Clone the path from root down to `joinnode`, replacing that join's
    build (right) side with the pre-agg subtree; the new join's schema is
    left cols + subagg cols. Every cloned ANCESTOR's schema is rebuilt
    from its new children (the original schemas list the removed dim
    payload columns — binding against them would miss the synthetic
    subagg columns). -> new root or None if joinnode not found or an
    ancestor node kind can't be re-schemed."""
    import copy as _copy
    if root is joinnode:
        nj = PhysHashJoin(joinnode.join_type, 1, joinnode.eq_conds, [],
                          Schema(list(joinnode.children[0].schema.cols) +
                                 list(subagg.schema.cols)),
                          joinnode.children[0], subagg)
        nj.stats_rows = joinnode.stats_rows
        return nj
    for i, c in enumerate(root.children):
        r = _swap_join_build(c, joinnode, subagg)
        if r is not None:
            clone = _copy.copy(root)
            clone.children = list(root.children)
            clone.children[i] = r
            if isinstance(clone, (PhysSelection, PhysShell)):
                clone.schema = r.schema
            elif isinstance(clone, PhysHashJoin):
                if clone.join_type in ("semi", "anti"):
                    clone.schema = Schema(
                        list(clone.children[0].schema.cols))
                else:
                    clone.schema = Schema(
                        list(clone.children[0].schema.cols) +
                        list(clone.children[1].schema.cols))
            else:
                return None   # unexpected ancestor: decline the rewrite
            return clone
    return None


def _eager_agg_outer_dims(outer_dims, group_items, aggs, other_refs):
    """Eager aggregation (reference: TiDB's aggregation push-down rule,
    planner/core/rule_aggregation_push_down.go, re-shaped for the fused
    pipeline): a LEFT outer dim with a NON-unique join key (Q13's
    orders-per-customer) pre-aggregates BY the join key, making the dim
    unique so the probe stays one gather. The outer aggs rewrite:
      count(dim e)  -> sum(ifnull(sub_count_e, 0))
      sum(dim e)    -> sum(sub_sum_e)         (miss -> NULL, skipped)
      min/max(dim e)-> min/max(sub_min/max_e)
      count(*)      -> sum(ifnull(sub_count_star, 1))
      min/max(fact) -> unchanged (multiplicity-free)
    -> (new_outer_dims, new_aggs, (joinnode, subagg)) or None when not
    applicable; the caller swaps the join node's build side for the
    pre-agg subtree in the runtime-fallback tree so the rewritten aggs
    stay evaluable there."""
    idx = None
    for i, (leaf, jt, econds, _node) in enumerate(outer_dims):
        if jt != "left" or not isinstance(leaf, PhysTableReader):
            continue
        (l_e, r_e) = econds[0]
        b = None
        leaf_idxs = {sc.col.idx for sc in leaf.dag.cols}
        for cand in (l_e, r_e):
            if isinstance(cand, Column) and cand.idx in leaf_idxs:
                b = cand
                break
        if b is None or _is_unique_col(leaf.dag.table_info,
                                       next(s.name for s in leaf.dag.cols
                                            if s.col.idx == b.idx)):
            continue
        # dim cols may appear ONLY inside agg args (group keys / filters /
        # other probes needing raw dim rows block the transform)
        if other_refs & (leaf_idxs - {b.idx}):
            continue
        if idx is not None:
            return None        # two multiplying dims: k-factors compose,
        idx = i                # out of scope
    if idx is None:
        return None
    leaf, jt, econds, joinnode = outer_dims[idx]
    leaf_idxs = {sc.col.idx for sc in leaf.dag.cols}
    (l_e, r_e) = econds[0]
    b = l_e if isinstance(l_e, Column) and l_e.idx in leaf_idxs else r_e
    ft_i64 = new_bigint_type()
    sub_aggs = []
    sub_cols = []

    def sub_out(name, args, out_ft):
        for j, a in enumerate(sub_aggs):
            if a.name == name and \
                    [x.fingerprint() for x in a.args] == \
                    [x.fingerprint() for x in args]:
                return sub_cols[j]
        c = Column(_syn_id("agg", leaf.dag.table_info.id, b.fingerprint(),
                           name, *(x.fingerprint() for x in args),
                           out_ft.tp, out_ft.decimal),
                   out_ft, f"agg${len(sub_aggs)}")
        sub_aggs.append(AggDesc(name, args, ft=out_ft))
        sub_cols.append(c)
        return c

    new_aggs = []
    for a in aggs:
        arg_idxs = set()
        for x in a.args:
            arg_idxs |= _cols_of(x)
        dim_side = bool(arg_idxs & leaf_idxs)
        if dim_side and not (arg_idxs <= leaf_idxs):
            return None                      # mixed fact*dim arg
        if a.distinct:
            return None
        if not dim_side:
            if a.name == "count" and not a.args:
                cnt = sub_out("count", [], ft_i64)
                one = const_from_py(1, ft_i64)
                new_aggs.append(AggDesc(
                    "sum", [ScalarFunc("ifnull", [cnt, one], ft_i64)],
                    ft=a.ft))
            elif a.name in ("min", "max"):
                new_aggs.append(a)           # multiplicity-free
            else:
                return None
            continue
        if not all(is_device_safe(x) for x in a.args):
            return None
        if a.name == "count":
            cnt = sub_out("count", list(a.args), ft_i64)
            zero = const_from_py(0, ft_i64)
            new_aggs.append(AggDesc(
                "sum", [ScalarFunc("ifnull", [cnt, zero], ft_i64)],
                ft=a.ft))
        elif a.name in ("sum", "min", "max"):
            sc = sub_out(a.name, list(a.args), a.ft)
            new_aggs.append(AggDesc(a.name, [sc], ft=a.ft))
        else:
            return None                      # avg: two-state decompose
    if not sub_aggs:
        return None
    import dataclasses
    key_sc = next(s for s in leaf.dag.cols if s.col.idx == b.idx)
    sub_schema = Schema([SchemaCol(Column(b.idx, b.ft, key_sc.name),
                                   key_sc.name)] +
                        [SchemaCol(c, c.name) for c in sub_cols])
    dag2 = dataclasses.replace(
        leaf.dag, cols=list(leaf.dag.cols),
        filters=list(leaf.dag.filters),
        host_filters=list(leaf.dag.host_filters),
        group_items=[Column(b.idx, b.ft, key_sc.name)],
        aggs=[_to_partial(a) for a in sub_aggs])
    reader2 = PhysTableReader(dag2, leaf.schema)
    reader2.stats_rows = leaf.stats_rows
    subagg = PhysHashAgg([Column(b.idx, b.ft, key_sc.name)], sub_aggs,
                         "final", sub_schema, reader2)
    subagg.stats_rows = max(leaf.stats_rows / 4.0, 1.0)
    wrapper = _AggLeaf(subagg, subagg)
    out = list(outer_dims)
    out[idx] = (wrapper, jt, econds, joinnode)
    return out, new_aggs, (joinnode, subagg)


class PhysFusedPipeline(PhysPlan):
    """Whole-query device pipeline: fact scan -> chain of unique-key
    dimension joins (searchsorted + gather, static shapes at fact
    cardinality) -> residual filters -> partial aggregation, compiled as
    ONE jit kernel per fact partition. The TPU-native re-design of the
    reference's per-operator pipeline (join/hash_join_v2.go:608 build/
    probe stages + tipb partial agg): instead of streaming chunks
    between operators through host memory, the whole subtree fuses into
    a single XLA program; the join "hash table" is the dimension's
    sorted key column, resident in HBM across queries.

    `fallback` keeps the conventional HashAgg-over-HashJoin subtree: the
    executor reverts to it when runtime eligibility fails (non-unique or
    NULL build keys, dirty transaction overlays, partitioned tables)."""

    def __init__(self, fact_dag, dims, post_filters, group_items, aggs,
                 schema, fallback):
        super().__init__([], schema)
        self.fact_dag = fact_dag
        self.dims = dims
        self.post_filters = post_filters
        self.group_items = group_items
        self.aggs = aggs
        self.fallback = fallback
        self.topn_spec = None      # set by attach_fused_topn

    def explain_info(self):
        dims = ", ".join(
            f"{d.dag.table_info.name}["
            + ", ".join(f"{sc.name} = {pe!r}" for sc, pe in d.all_keys())
            + "]" + ("" if d.join_type == "inner" else f" ({d.join_type})")
            for d in self.dims)
        s = (f"fact:{self.fact_dag.table_info.name}, dims:[{dims}], "
             f"group:[{', '.join(map(repr, self.group_items))}], "
             f"aggs:[{', '.join(map(repr, self.aggs))}]")
        if self.post_filters:
            s += f", residual:[{', '.join(map(repr, self.post_filters))}]"
        return s


class PhysIndexRange(PhysPlan):
    """Index range scan -> handle gather (reference IndexReader/IndexLookUp
    executor/distsql.go). Composite ranges compose an equality PREFIX
    over the index's leading columns with one range on the next column
    (reference ranger/detacher.go:1033 DetachCondAndBuildRangeForIndex):
    index (a, b, c) with a=1 AND b=2 AND c>5 scans
    [enc(1,2,5)..enc(1,2,+inf))."""

    def __init__(self, table_info, db_name, cols, index, low, high,
                 low_inc, high_inc, residual, schema, prefix=()):
        super().__init__([], schema)
        self.table_info = table_info
        self.db_name = db_name
        self.cols = cols
        self.index = index
        self.prefix = list(prefix)   # [Constant] leading = values
        self.low = low          # Constant|None (on column len(prefix))
        self.high = high
        self.low_inc = low_inc
        self.high_inc = high_inc
        self.residual = residual   # remaining filter conjuncts (host eval)
        self.scan_limit = -1       # LIMIT pushed into the index KV scan

    def explain_info(self):
        rng = f"{'[' if self.low_inc else '('}{self.low!r}, " \
              f"{self.high!r}{']' if self.high_inc else ')'}"
        if self.prefix:
            eqs = ", ".join(map(repr, self.prefix))
            rng = f"[{eqs}] x {rng}" if (
                self.low is not None or self.high is not None) \
                else f"[{eqs}]"
        return (f"table:{self.table_info.name}, index:{self.index.name}, "
                f"range:{rng}")


class PhysIndexMerge(PhysPlan):
    """Union-type index merge (reference pkg/executor/index_merge_reader.go
    + planner/core/indexmerge_path.go): each OR-disjunct scans its own
    index range; handle sets union; the original predicate re-applies as
    a residual filter over the gathered rows."""

    def __init__(self, table_info, db_name, cols, branches, residual,
                 schema):
        super().__init__([], schema)
        self.table_info = table_info
        self.db_name = db_name
        self.cols = cols
        # [(index, low, high, low_inc, high_inc)]
        self.branches = branches
        self.residual = residual

    def explain_info(self):
        parts = ", ".join(b[0].name for b in self.branches)
        return f"table:{self.table_info.name}, union of: {parts}"


class PhysBatchPointGet(PhysPlan):
    """pk IN (consts) -> batched handle lookups (reference
    batch_point_get.go)."""

    def __init__(self, table_info, db_name, cols, handles, schema):
        super().__init__([], schema)
        self.table_info = table_info
        self.db_name = db_name
        self.cols = cols
        self.handles = handles     # [Constant]
        self.stats_rows = float(len(handles))

    def explain_info(self):
        return f"table:{self.table_info.name}, handles:{len(self.handles)}"


class PhysPointGet(PhysPlan):
    """Point read via clustered PK handle or unique index (reference
    pkg/executor/point_get.go; planner fast path point_get_plan.go)."""

    def __init__(self, table_info, db_name, cols, handle_expr, index,
                 index_vals, schema):
        super().__init__([], schema)
        self.table_info = table_info
        self.db_name = db_name
        self.cols = cols                  # [SchemaCol] to output
        self.handle_expr = handle_expr    # Constant handle (pk_is_handle)
        self.index = index                # IndexInfo for unique-index gets
        self.index_vals = index_vals      # [Constant] index column values
        self.stats_rows = 1.0

    def explain_info(self):
        if self.handle_expr is not None:
            return f"table:{self.table_info.name}, handle:{self.handle_expr!r}"
        return (f"table:{self.table_info.name}, index:{self.index.name}"
                f"({', '.join(map(repr, self.index_vals))})")


class PhysSelection(PhysPlan):
    def __init__(self, conds, child):
        super().__init__([child], child.schema)
        self.conds = conds

    def explain_info(self):
        return ", ".join(map(repr, self.conds))


class PhysProjection(PhysPlan):
    def __init__(self, exprs, schema, child):
        super().__init__([child], schema)
        self.exprs = exprs

    def explain_info(self):
        return ", ".join(map(repr, self.exprs))


class PhysHashAgg(PhysPlan):
    def __init__(self, group_items, aggs, mode, schema, child):
        super().__init__([child], schema)
        self.group_items = group_items
        self.aggs = aggs
        self.mode = mode       # complete | final

    def explain_info(self):
        return (f"mode:{self.mode}, group:[{', '.join(map(repr, self.group_items))}], "
                f"funcs:[{', '.join(map(repr, self.aggs))}]")


class PhysHashJoin(PhysPlan):
    def __init__(self, join_type, build_side, eq_conds, other_conds,
                 schema, left, right):
        super().__init__([left, right], schema)
        self.join_type = join_type
        self.build_side = build_side      # 0 = left child builds, 1 = right
        self.eq_conds = eq_conds
        self.other_conds = other_conds
        self.null_aware = False

    def explain_info(self):
        return (f"{self.join_type}, build:{'left' if self.build_side == 0 else 'right'}, "
                f"eq:{[(repr(a), repr(b)) for a, b in self.eq_conds]}")


class PhysIndexLookupJoin(PhysPlan):
    """Index-driven join (reference executor/join/index_lookup_join.go):
    the outer side streams in batches; each batch's join keys become
    point lookups into the inner table's clustered PK / unique index —
    an OLTP-selective join never scans the inner table. The inner side
    here is a table descriptor, not a child executor (the lookups ARE
    the scan); `fallback` keeps the hash join for runtime ineligibility
    (dirty txn, stale reads, bulk tables)."""

    def __init__(self, join_type, outer, inner_dag, inner_key_sc,
                 inner_index, outer_key, other_conds, schema, fallback):
        super().__init__([outer], schema)
        self.join_type = join_type        # inner | left (outer preserved)
        self.inner_dag = inner_dag        # CoprDAG: cols + residual filters
        self.inner_key_sc = inner_key_sc  # SchemaCol of the inner join key
        self.inner_index = inner_index    # IndexInfo | None (None = PK)
        self.outer_key = outer_key        # Expression over outer schema
        self.other_conds = other_conds
        self.fallback = fallback

    def explain_info(self):
        via = "handle" if self.inner_index is None else \
            f"index:{self.inner_index.name}"
        return (f"{self.join_type}, inner:{self.inner_dag.table_info.name}"
                f"({via}), outer key:{self.outer_key!r}")


class PhysMergeJoin(PhysPlan):
    """Sort-merge join (reference executor/join/merge_join.go): both
    sides ordered by the join key, linear merge; output arrives in key
    order (downstream sorts on the key can elide)."""

    def __init__(self, join_type, eq_conds, other_conds, schema, left,
                 right):
        super().__init__([left, right], schema)
        self.join_type = join_type
        self.eq_conds = eq_conds
        self.other_conds = other_conds

    def explain_info(self):
        return (f"{self.join_type}, "
                f"eq:{[(repr(a), repr(b)) for a, b in self.eq_conds]}")


class PhysSort(PhysPlan):
    def __init__(self, items, child):
        super().__init__([child], child.schema)
        self.items = items

    def explain_info(self):
        return ", ".join(f"{e!r}{' desc' if d else ''}" for e, d in self.items)


class PhysTopN(PhysPlan):
    def __init__(self, items, offset, count, child):
        super().__init__([child], child.schema)
        self.items = items
        self.offset = offset
        self.count = count

    def explain_info(self):
        return (", ".join(f"{e!r}{' desc' if d else ''}" for e, d in self.items)
                + f", offset:{self.offset}, count:{self.count}")


class PhysVectorSearch(PhysPlan):
    """ORDER BY vec_*_distance(col, const) LIMIT k lowered to a
    single-dispatch top-k over the device-resident vector matrix
    (exact brute force) or the IVF index (ANN, tidb_tpu_vector_nprobe
    > 0 and an index exists) — tidb_tpu/vector/, docs/VECTOR.md. The
    wrapped PhysTableReader is the host-parity fallback (dirty-txn
    overlays, device degradation)."""

    def __init__(self, items, offset, count, reader, metric, col_name,
                 query, filters=None):
        super().__init__([reader], reader.schema)
        self.items = items
        self.offset = offset
        self.count = count
        self.reader = reader
        self.metric = metric            # vec_* op name
        self.col_name = col_name        # storage column name
        self.query = query              # np.float32 query vector
        # hybrid search: scalar predicates applied BEFORE top-k (the
        # mask ANDs into MVCC validity — pre-filtered exact scan, or
        # pre-filtered IVF probing with selectivity-widened nprobe).
        # The same exprs stay on the reader dag for the fallback path.
        self.filters = filters or []

    def explain_info(self):
        info = (f"{self.metric}({self.col_name}), k:{self.count}, "
                f"offset:{self.offset}, dim:{len(self.query)}")
        if self.filters:
            info += ", prefilter:" + \
                ", ".join(repr(f) for f in self.filters)
        return info


class PhysMLPredict(PhysPlan):
    """`SELECT ..., predict(m, f...) FROM t [WHERE ...]` lowered to
    ONE batched device forward pass over the streamed scan result
    (tidb_tpu/ml/, docs/ML.md): the executor drains the wrapped
    reader, extracts the feature matrix host-side, and runs the whole
    matmul chain through MLRuntime.predict_rows — resident weights +
    resident padded features, one dispatch, one fetch sync. The
    per-chunk host evaluation of ProjectionExec is the parity twin
    (dirty-txn overlays and device degradation fall back to it)."""

    def __init__(self, exprs, schema, reader):
        super().__init__([reader], schema)
        self.exprs = exprs
        self.reader = reader

    def explain_info(self):
        return "batched, " + ", ".join(map(repr, self.exprs))


class PhysLimit(PhysPlan):
    def __init__(self, offset, count, child):
        super().__init__([child], child.schema)
        self.offset = offset
        self.count = count

    def explain_info(self):
        return f"offset:{self.offset}, count:{self.count}"


class PhysWindow(PhysPlan):
    def __init__(self, descs, schema, child):
        super().__init__([child], schema)
        self.descs = descs

    def explain_info(self):
        return ", ".join(map(repr, self.descs))


class PhysUnion(PhysPlan):
    def __init__(self, children, schema):
        super().__init__(children, schema)


class PhysDual(PhysPlan):
    def __init__(self, schema, rows=1):
        super().__init__([], schema)
        self.rows = rows


class PhysShell(PhysPlan):
    """Schema-renaming passthrough."""

    def __init__(self, child, schema):
        super().__init__([child], schema)


import threading as _threading

_TLS = _threading.local()


def to_physical(plan: LogicalPlan, sess_vars=None, hints=None,
                device_type="cpu") -> PhysPlan:
    """device_type is the domain's torch device type ("cuda" or "cpu"):
    the heavy-dimension gate of _try_fuse_agg keeps such joins fused on
    the card and plans the host alternative on the CPU, as the
    reference does on its accelerator and CPU backends."""
    _TLS.hints = list(hints or ())
    _TLS.device_type = device_type
    try:
        p = _phys(plan)
    finally:
        _TLS.hints = []
        _TLS.device_type = "cpu"
    return p


def _hint_tables(name):
    """Lowercased table args of the first matching join hint."""
    for hname, args in getattr(_TLS, "hints", None) or ():
        if hname in (name, "tidb_inlj" if name == "inl_join" else name,
                     "sm_join" if name == "merge_join" else name):
            return [a.lower() for a in args] or ["*"]
    return None


def _try_point_get(ds: DataSource) -> PhysPlan | None:
    """DataSource whose pushed conds form pk = const / unique-index match."""
    tbl = ds.table_info
    conds = ds.pushed_conds
    if not conds or tbl.id < 0 or tbl.partitions:
        return None
    if tbl.pk_is_handle and len(conds) == 1 and \
            isinstance(conds[0], ScalarFunc) and conds[0].op == "in":
        cols0 = getattr(ds, "used_cols", None) or list(ds.schema.cols)
        c0 = conds[0]
        if isinstance(c0.args[0], Column) and \
                getattr(ds, "col_name_of", {}).get(
                    c0.args[0].idx, "").lower() == \
                tbl.pk_col_name.lower() and \
                all(isinstance(a, Constant) for a in c0.args[1:]) and \
                len(c0.args) <= 1025:
            return PhysBatchPointGet(tbl, ds.db_name, cols0,
                                     list(c0.args[1:]),
                                     Schema(list(cols0)))
    eqs = {}
    for c in conds:
        if not (isinstance(c, ScalarFunc) and c.op == "=" and
                isinstance(c.args[0], Column) and
                isinstance(c.args[1], Constant)):
            return None
        name = getattr(ds, "col_name_of", {}).get(c.args[0].idx)
        if name is None:
            return None
        eqs[name.lower()] = c.args[1]
    cols = getattr(ds, "used_cols", None) or list(ds.schema.cols)
    schema = Schema(list(cols))
    if tbl.pk_is_handle and set(eqs) == {tbl.pk_col_name.lower()}:
        return PhysPointGet(tbl, ds.db_name, cols,
                            eqs[tbl.pk_col_name.lower()], None, None, schema)
    if getattr(ds, "bulk_only", False):
        # bulk-loaded rows have no index KV: unique-index lookups would
        # silently miss them (clustered-PK lookups above are fine — bulk
        # handles ARE the PK values)
        return None
    for idx in _candidate_indexes(ds, tbl):
        if idx.unique and set(eqs) == {c.lower() for c in idx.columns}:
            vals = [eqs[c.lower()] for c in idx.columns]
            return PhysPointGet(tbl, ds.db_name, cols, None, idx, vals,
                                schema)
    return None


def _phys(plan: LogicalPlan) -> PhysPlan:
    if isinstance(plan, DataSource):
        return _mk_reader(plan)
    if isinstance(plan, Selection):
        child = _phys(plan.child)
        if isinstance(child, PhysTableReader) and not child.dag.aggs:
            _absorb_filters(child.dag, plan.conds)
            child.schema = plan.schema if plan.schema.cols else child.schema
            child.stats_rows = plan.stats_rows
            return child
        p = PhysSelection(plan.conds, child)
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, Projection):
        child = _phys(plan.child)
        mlp = _try_ml_predict(plan, child)
        if mlp is not None:
            mlp.stats_rows = plan.stats_rows
            return mlp
        p = PhysProjection(plan.exprs, plan.schema, child)
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, ProjShell):
        child = _phys(plan.child)
        p = PhysShell(child, plan.schema)
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, Aggregation):
        child = _phys(plan.child)
        if isinstance(child, PhysTableReader) and _can_push_agg(plan, child):
            # big single-table aggs (Q1/Q6) prefer the ZERO-dim fused
            # pipeline: same kernels single-chip, but it fragments onto
            # the device mesh (PassThrough exchange) and carries the
            # dirty-txn overlay + early compaction. Small tables keep
            # the simple copr push (system/internal queries: no churn)
            if getattr(child, "raw_rows", 0) >= 4096:
                fused = _try_fuse_agg(plan, child)
                if fused is not None:
                    return fused
            dag = child.dag
            dag.group_items = list(plan.group_items)
            dag.aggs = [_to_partial(a) for a in plan.aggs]
            agg = PhysHashAgg(plan.group_items, plan.aggs, "final",
                              plan.schema, child)
            agg.stats_rows = plan.stats_rows
            child.stats_rows = plan.stats_rows
            return agg
        fused = _try_fuse_agg(plan, child)
        if fused is None:
            fused = _try_fuse_distinct(plan, child)
        if fused is not None:
            return fused
        agg = PhysHashAgg(plan.group_items, plan.aggs, "complete",
                          plan.schema, child)
        agg.stats_rows = plan.stats_rows
        return agg
    if isinstance(plan, LJoin):
        plan.eq_conds = [_ci_join_pair(a, b) for a, b in plan.eq_conds]
        left = _phys(plan.children[0])
        right = _phys(plan.children[1])
        if plan.join_type in ("left", "semi", "anti"):
            build = 1          # semi/anti: the subquery side always builds
        elif plan.join_type == "right":
            build = 0
        else:
            build = 0 if plan.children[0].stats_rows <= plan.children[1].stats_rows else 1
        p = PhysHashJoin(plan.join_type, build, plan.eq_conds,
                         plan.other_conds, plan.schema, left, right)
        p.null_aware = getattr(plan, "null_aware", False)
        p.naaj_corr = getattr(plan, "naaj_corr", 0)
        p.stats_rows = plan.stats_rows
        alt = _try_join_strategy(plan, left, right, p)
        if alt is not None:
            return alt
        return p
    if isinstance(plan, Sort):
        p = PhysSort(plan.items, _phys(plan.child))
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, TopN):
        child = _phys(plan.child)
        vs = _try_vector_search(plan, child)
        if vs is not None:
            vs.stats_rows = plan.stats_rows
            return vs
        if isinstance(child, PhysTableReader) and not child.dag.aggs and \
                child.dag.limit < 0 and len(plan.items) == 1 and \
                plan.offset + plan.count <= 16384 and \
                is_device_safe(plan.items[0][0]) and \
                not getattr(plan.items[0][0].ft, "unsigned", False):
            # unsigned keys above 2^63 wrap negative: the copr top-k
            # kernel's in-band sentinels cannot express them — the
            # host TopN (sentinel-free unsigned keys) owns the shape
            # per-partition device top-k; the root TopN merges partitions
            # (reference: copr-pushed TopN under the root TopN)
            child.dag.topn = (plan.items[0], plan.offset + plan.count)
        p = PhysTopN(plan.items, plan.offset, plan.count, child)
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, LimitOp):
        child = _phys(plan.child)
        if isinstance(child, PhysTableReader) and not child.dag.aggs and \
                not child.dag.filters and not child.dag.host_filters and \
                plan.count >= 0:
            child.dag.limit = plan.offset + plan.count
        # LIMIT without intervening filters bounds the index KV scan
        # itself (sysbench index_range: a half-open range over a big
        # index must stop after offset+count entries, not materialize
        # half the index per statement)
        if plan.count > 0:      # LIMIT 0 must not read as "unlimited"
            holder = None
            ir = child
            while isinstance(ir, (PhysProjection, PhysShell)):
                holder = ir
                ir = ir.children[0]
            if isinstance(ir, PhysIndexRange) and not ir.residual:
                ir.scan_limit = plan.offset + plan.count
            elif isinstance(ir, PhysTableReader):
                # unselective range + LIMIT: the 2% selectivity gate
                # rejected the index path, but a LIMITed index scan
                # reads <= offset+count entries no matter the range
                conv = _limit_to_index_range(
                    ir, plan.offset + plan.count)
                if conv is not None:
                    if holder is not None:
                        holder.children[0] = conv
                    else:
                        child = conv
        p = PhysLimit(plan.offset, plan.count, child)
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, WindowOp):
        p = PhysWindow(plan.descs, plan.schema, _phys(plan.child))
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, UnionOp):
        p = PhysUnion([_phys(c) for c in plan.children], plan.schema)
        p.stats_rows = plan.stats_rows
        return p
    if isinstance(plan, Dual):
        return PhysDual(plan.schema, plan.rows)
    raise NotImplementedError(f"no physical impl for {type(plan).__name__}")


def _try_vector_search(plan: TopN, child) -> PhysVectorSearch | None:
    """Recognize `ORDER BY vec_*_distance(vector_col, const) LIMIT k`
    (ascending = nearest-first) over a bare table scan and lower it to
    PhysVectorSearch (vector/). Anything the vector runtime
    cannot serve bit-identically — filters, DESC, unknown dimension,
    a malformed or dimension-mismatched query constant (the host path
    owns the clean ER there), partitioned/virtual tables — keeps the
    conventional TopN."""
    from ..vector import METRIC_OPS
    if not isinstance(child, PhysTableReader):
        return None
    dag = child.dag
    if dag.aggs or dag.group_items or dag.limit >= 0 \
            or dag.topn is not None:
        return None
    # scalar predicates are welcome: hybrid search applies them as a
    # pre-top-k mask (they also STAY on the dag so the conventional
    # fallback subtree filters identically)
    filters = list(dag.filters) + list(dag.host_filters)
    tbl = dag.table_info
    if tbl.id <= 0 or tbl.partitions or tbl.view_select:
        return None
    if len(plan.items) != 1 or plan.count < 0 or \
            plan.offset + plan.count > 16384:
        return None
    e, desc = plan.items[0]
    if desc or not isinstance(e, ScalarFunc) or e.op not in METRIC_OPS \
            or len(e.args) != 2:
        return None
    a, b = e.args
    col, const = (a, b) if isinstance(a, Column) else (b, a)
    if not isinstance(col, Column) or not isinstance(const, Constant):
        return None
    ft = col.ft
    if ft is None or not getattr(ft, "is_vector", False) or ft.flen <= 0:
        return None
    name = next((sc.name for sc in dag.cols if sc.col.idx == col.idx),
                None)
    if name is None:
        return None
    ci = tbl.find_column(name)
    if ci is None or not getattr(ci.ft, "is_vector", False):
        return None
    qv = const.value
    if qv is None or qv.is_null or not isinstance(qv.val, str):
        return None
    from ..expression.vec import _parse_vec_text
    q = _parse_vec_text(qv.val)
    if q is None or len(q) != ft.flen:
        return None
    return PhysVectorSearch(plan.items, plan.offset, plan.count, child,
                            e.op, ci.name, q, filters=filters)


def _try_ml_predict(plan: Projection, child) -> PhysMLPredict | None:
    """Recognize a projection with top-level predict() calls directly
    over a table scan and lower it to PhysMLPredict (batched
    standalone inference). The reader keeps its own filters — rows are
    filtered BEFORE feature extraction, so the batch is exactly the
    result set. Aggregated/fused shapes keep the conventional plan
    (there predict traces into the fragment body instead)."""
    from ..ml.lowering import MLFunc
    if not isinstance(child, PhysTableReader):
        return None
    dag = child.dag
    if dag.aggs or dag.group_items or dag.topn is not None:
        return None
    if not any(isinstance(e, MLFunc) and e.op == "predict"
               for e in plan.exprs):
        return None
    return PhysMLPredict(plan.exprs, plan.schema, child)


def _try_index_range(ds: DataSource) -> PhysPlan | None:
    """Range/point conds composed over an index's column prefix ->
    index range scan, when the table is fully KV-backed and the range
    is selective (reference ranger/detacher.go:1033: point-prefix x one
    interval; later index columns after the interval cannot constrain
    the key range and stay residual)."""
    tbl = ds.table_info
    if tbl.id < 0 or tbl.partitions or not ds.pushed_conds or \
            getattr(ds, "bulk_only", False):
        return None
    # per-column simple conds: name -> [(op, Constant, cond)]
    by_col = {}
    for c in ds.pushed_conds:
        if isinstance(c, ScalarFunc) and len(c.args) == 2 and \
                isinstance(c.args[0], Column) and \
                isinstance(c.args[1], Constant) and \
                c.op in ("=", "<", "<=", ">", ">="):
            name = getattr(ds, "col_name_of", {}).get(c.args[0].idx, "")
            by_col.setdefault(name.lower(), []).append((c.op, c.args[1], c))
    if not by_col:
        return None
    best = None     # (n_prefix, has_range, index, prefix, lo..hi, used)
    for idx in _candidate_indexes(ds, tbl):
        prefix, used = [], []
        low = high = None
        low_inc = high_inc = True
        for col in idx.columns:
            conds = by_col.get(col.lower())
            if not conds:
                break
            eq = next((t for t in conds if t[0] == "="), None)
            if eq is not None:
                # only the encoded cond counts as used: a second,
                # conflicting cond on the same column (a=3 AND a=4,
                # a=3 AND a>5) must stay residual or wrong rows return
                prefix.append(eq[1])
                used.append(eq[2])
                continue
            # first non-eq column: one lower + one upper bound encode;
            # any further range conds stay residual
            for op, v, cond in conds:
                if op in (">", ">=") and low is None:
                    low, low_inc = v, op == ">="
                    used.append(cond)
                elif op in ("<", "<=") and high is None:
                    high, high_inc = v, op == "<="
                    used.append(cond)
            break
        if not used:
            continue
        has_range = low is not None or high is not None
        cand = (len(prefix), has_range, idx, prefix, low, high,
                low_inc, high_inc, used)
        if best is None or (cand[0], cand[1]) > (best[0], best[1]):
            best = cand
    if best is None:
        return None
    n_prefix, has_range, target_idx, prefix, low, high, \
        low_inc, high_inc, used = best
    if not has_range and n_prefix == 0:
        return None
    used_ids = {id(c) for c in used}
    residual = [c for c in ds.pushed_conds if id(c) not in used_ids]
    # the prefix equality on a column with range conds too (a=1 and a>0):
    # unused extra conds stay residual via used_ids filtering above
    if not has_range:
        low = high = None
        low_inc = high_inc = True
    cols = getattr(ds, "used_cols", None) or list(ds.schema.cols)
    return PhysIndexRange(tbl, ds.db_name, cols, target_idx, low, high,
                          low_inc, high_inc, residual, Schema(list(cols)),
                          prefix=prefix)


class _ReaderDS:
    """Duck-typed DataSource view of a PhysTableReader so the range
    extractor can run at the LIMIT boundary."""

    def __init__(self, rd):
        self.table_info = rd.dag.table_info
        self.db_name = rd.dag.db_name
        self.pushed_conds = list(rd.dag.filters)
        self.col_name_of = {sc.col.idx: sc.name for sc in rd.dag.cols}
        self.used_cols = list(rd.dag.cols)
        self.schema = rd.schema
        self.stats_rows = rd.stats_rows
        self.bulk_only = False


def _limit_to_index_range(rd, scan_limit):
    """TableReader + LIMIT (no intervening operators) -> LIMITed index
    range scan when EVERY filter folds into one index's key range (a
    residual would make the limit cut filtered rows)."""
    if rd.dag.aggs or rd.dag.group_items or rd.dag.topn is not None \
            or rd.dag.host_filters or not rd.dag.filters \
            or rd.dag.limit >= 0:
        return None
    ir = _try_index_range(_ReaderDS(rd))
    if ir is None or ir.residual:
        return None
    ir.scan_limit = scan_limit
    ir.stats_rows = float(scan_limit)
    return ir


def _candidate_indexes(ds, tbl):
    """Access-path-visible indexes: drops INVISIBLE indexes (still
    write-maintained) and applies table-level USE/FORCE/IGNORE INDEX
    hints by name (reference pkg/planner/core access-path filtering;
    FORCE approximated as USE — candidates restrict, cost picks)."""
    idxs = [i for i in tbl.public_indexes()
            if not getattr(i, "invisible", False)]
    hints = getattr(ds, "index_hints", None) or []
    allowed, ignored = None, set()
    for kind, names in hints:
        low = {n.lower() for n in names}
        if kind in ("use", "force"):
            allowed = low if allowed is None else (allowed | low)
        else:
            ignored |= low
    if allowed is not None:
        idxs = [i for i in idxs if i.name.lower() in allowed]
    if ignored:
        idxs = [i for i in idxs if i.name.lower() not in ignored]
    return idxs


def _flatten_or(c, out):
    if isinstance(c, ScalarFunc) and c.op == "or":
        for a in c.args:
            _flatten_or(a, out)
    else:
        out.append(c)


def _try_index_merge(ds: DataSource) -> PhysPlan | None:
    """OR of simple ranges, each covered by some index -> union-type
    index merge."""
    tbl = ds.table_info
    if tbl.id < 0 or tbl.partitions or not ds.pushed_conds or \
            getattr(ds, "bulk_only", False):
        return None
    indexed_cols = {}
    for idx in _candidate_indexes(ds, tbl):
        if len(idx.columns) >= 1:
            indexed_cols.setdefault(idx.columns[0].lower(), idx)
    if not indexed_cols:
        return None
    for c in ds.pushed_conds:
        disj = []
        _flatten_or(c, disj)
        if len(disj) < 2:
            continue
        branches = []
        for d in disj:
            if not (isinstance(d, ScalarFunc) and len(d.args) == 2 and
                    isinstance(d.args[0], Column) and
                    isinstance(d.args[1], Constant) and
                    d.op in ("=", "<", "<=", ">", ">=")):
                branches = None
                break
            name = getattr(ds, "col_name_of", {}).get(d.args[0].idx, "")
            idx = indexed_cols.get(name.lower())
            if idx is None:
                branches = None
                break
            v = d.args[1]
            low = high = None
            low_inc = high_inc = True
            if d.op == "=":
                low = high = v
            elif d.op in (">", ">="):
                low, low_inc = v, d.op == ">="
            else:
                high, high_inc = v, d.op == "<="
            branches.append((idx, low, high, low_inc, high_inc))
        if branches:
            cols = getattr(ds, "used_cols", None) or list(ds.schema.cols)
            return PhysIndexMerge(tbl, ds.db_name, cols, branches,
                                  list(ds.pushed_conds),
                                  Schema(list(cols)))
    return None


def _mk_reader(ds: DataSource) -> PhysPlan:
    pg = _try_point_get(ds)
    if pg is not None:
        return pg
    # index range scan only when clearly selective (est < 2% of table)
    raw = getattr(ds, "pre_filter_rows", None)
    if ds.stats_rows > 0 and raw and ds.stats_rows <= max(raw * 0.02, 50):
        ir = _try_index_range(ds)
        if ir is not None:
            ir.stats_rows = ds.stats_rows
            return ir
    if ds.stats_rows > 0 and raw and ds.stats_rows <= max(raw * 0.05, 50):
        im = _try_index_merge(ds)
        if im is not None:
            im.stats_rows = ds.stats_rows
            return im
    cols = getattr(ds, "used_cols", None) or list(ds.schema.cols)
    dag = CoprDAG(table_info=ds.table_info, db_name=ds.db_name,
                  cols=list(cols),
                  part_sel=getattr(ds, "part_sel", None))
    _absorb_filters(dag, ds.pushed_conds)
    schema = Schema(list(cols))
    rd = PhysTableReader(dag, schema)
    rd.stats_rows = ds.stats_rows
    rd.raw_rows = float(getattr(ds, "pre_filter_rows", None) or
                        ds.stats_rows)
    return rd


def _absorb_filters(dag: CoprDAG, conds):
    for c in conds:
        (dag.filters if is_device_safe(c) else dag.host_filters).append(c)
        # filters may reference columns not in the output list
        s = set()
        c.collect_columns(s)
        have = {sc.col.idx for sc in dag.cols}
        missing = s - have
        if missing:
            # caller guarantees pruning kept filter cols in ds.used_cols;
            # this is a safety net for directly-absorbed selections
            pass


def _fusable_leaf(p):
    if not isinstance(p, PhysTableReader):
        return False
    dag = p.dag
    return not (dag.aggs or dag.topn is not None or dag.limit >= 0 or
                dag.host_filters or dag.table_info.partitions or
                dag.table_info.id < 0)


def _ci_join_pair(a, b):
    """Join keys on _ci strings compare by collation normal form: both
    sides wrap in _collkey_fold (a dict OF normal forms), so the join's
    shared-dict translation matches case/padding variants across sides
    (reference pkg/util/collate; MySQL collation coercion picks the
    non-binary collation when the sides disagree). Non-string or _bin
    pairs pass through — a wrapped key also keeps such a dim out of the
    raw-code fused path, which would otherwise compare codes binary."""
    from ..expression.vec import _needs_fold
    from ..types.field_type import TypeClass

    def is_ci_str(e):
        ft = getattr(e, "ft", None)
        return ft is not None and ft.tclass == TypeClass.STRING and \
            _needs_fold(ft)

    def is_str(e):
        ft = getattr(e, "ft", None)
        return ft is not None and ft.tclass == TypeClass.STRING

    if (is_ci_str(a) or is_ci_str(b)) and is_str(a) and is_str(b):
        def wrap(e):
            if isinstance(e, ScalarFunc) and e.op == "_collkey_fold":
                return e
            return ScalarFunc("_collkey_fold", [e], e.ft)
        return wrap(a), wrap(b)
    return a, b


def _bpg_to_reader(p):
    """Re-open a BatchPointGet as a plain scan with a device-safe
    `pk IN (consts)` filter so it can serve as a fused-pipeline dim
    (Q18: `o_orderkey in (<plan-time subquery result>)` picks the
    point-get access path, but inside an agg-over-join tree the fused
    kernel wants a scan leaf — the IN mask evaluates on device and the
    columnar scan reuses the HBM-resident buffers, so the handle list
    costs one fused filter instead of a host lookup join)."""
    tbl = p.table_info
    pk_name = (tbl.pk_col_name or "").lower()
    pk_sc = next((sc for sc in p.cols if sc.name == pk_name), None)
    if pk_sc is None or not p.handles:
        return None
    cond = ScalarFunc("in", [pk_sc.col] + list(p.handles),
                      new_bigint_type())
    if not is_device_safe(cond):
        return None
    dag = CoprDAG(table_info=tbl, db_name=p.db_name, cols=list(p.cols),
                  filters=[cond])
    rd = PhysTableReader(dag, Schema(list(p.cols)))
    rd.stats_rows = p.stats_rows
    rd.raw_rows = p.stats_rows
    return rd


def _collect_join_tree(p, leaves, eqs, filters, outer_dims):
    """Flatten a join tree into leaves + eq pairs + residual filters.
    Inner joins flatten freely; LEFT/SEMI joins whose non-preserved side
    is a plain leaf become `outer_dims` entries [(leaf, join_type,
    eq_conds)] — they attach after the inner orientation (a left dim
    never filters the pipeline; a semi dim only masks).
    -> False when any node is outside the fusable shape."""
    if isinstance(p, PhysShell):
        return _collect_join_tree(p.child, leaves, eqs, filters,
                                  outer_dims)
    if isinstance(p, PhysSelection):
        filters.extend(p.conds)
        return _collect_join_tree(p.child, leaves, eqs, filters,
                                  outer_dims)
    if isinstance(p, PhysIndexLookupJoin):
        # the ILJ keeps its hash-join equivalent as `fallback`: fuse from
        # that shape (the fused kernel replaces the whole subtree; the
        # runtime fallback tree keeps the ILJ node itself)
        return _collect_join_tree(p.fallback, leaves, eqs, filters,
                                  outer_dims)
    if isinstance(p, PhysHashJoin):
        if getattr(p, "null_aware", False):
            return False
        if p.join_type == "inner":
            eqs.extend(p.eq_conds)
            filters.extend(p.other_conds)
            return (_collect_join_tree(p.children[0], leaves, eqs,
                                       filters, outer_dims) and
                    _collect_join_tree(p.children[1], leaves, eqs,
                                       filters, outer_dims))
        if p.join_type in ("left", "semi", "anti") and \
                len(p.eq_conds) == 1:
            inner = p.children[1]
            crossing = []
            if p.other_conds:
                # ON filters over the inner side only pre-filter the dim
                # (exact for LEFT/SEMI: Q13's `on ... and o_comment not
                # like ...`); conds crossing sides go to the pair-count
                # rewrite below
                if not _fusable_leaf(inner):
                    return False
                inner_cols = {sc.col.idx for sc in inner.dag.cols}
                absorb = [c for c in p.other_conds
                          if _cols_of(c) <= inner_cols and
                          is_device_safe(c)]
                crossing = [c for c in p.other_conds if c not in absorb]
                if absorb:
                    import dataclasses
                    dag2 = dataclasses.replace(
                        inner.dag, filters=inner.dag.filters + absorb)
                    inner2 = PhysTableReader(dag2, inner.schema)
                    inner2.stats_rows = inner.stats_rows
                    inner2.raw_rows = getattr(inner, "raw_rows",
                                              inner.stats_rows)
                    inner = inner2
            if crossing:
                if p.join_type in ("semi", "anti") and \
                        len(crossing) == 1 and \
                        isinstance(inner, PhysTableReader) and \
                        _pair_count_rewrite(p, inner, crossing[0],
                                            filters, outer_dims):
                    return _collect_join_tree(p.children[0], leaves, eqs,
                                              filters, outer_dims)
                return False
            if not _fusable_leaf(inner):
                inner = _try_agg_leaf(inner)
            if inner is not None:
                outer_dims.append((inner, p.join_type, list(p.eq_conds),
                                   p))
                return _collect_join_tree(p.children[0], leaves, eqs,
                                          filters, outer_dims)
        return False
    if isinstance(p, PhysBatchPointGet):
        rd = _bpg_to_reader(p)
        if rd is not None:
            leaves.append(rd)
            return True
        return False
    if _fusable_leaf(p):
        leaves.append(p)
        return True
    al = _try_agg_leaf(p)
    if al is not None:
        leaves.append(al)
        return True
    return False


def _pair_count_rewrite(p, inner, cross, filters, outer_dims):
    """EXISTS/NOT EXISTS with a same-key inequality correlation (Q21's
    `l2.l_orderkey = l1.l_orderkey and l2.l_suppkey <> l1.l_suppkey`)
    -> two per-key COUNT dims:
      exists(T: T.k = o.k and T.c <> o.c and P(T))
        <=> cnt_k(o.k) - cnt_kc(o.k, o.c) > 0      (NOT EXISTS: == 0)
    where cnt_k counts filtered T rows per k and cnt_kc per (k, c) —
    both group-by results have unique keys, so they ride the fused
    probe as LEFT materialized dims (ifnull(cnt, 0) on miss) and the
    comparison becomes a device post filter. This is the classic Q21
    decorrelation, here produced mechanically so the whole query stays
    one device kernel."""
    inner_cols = {sc.col.idx for sc in inner.dag.cols}
    if not (isinstance(cross, ScalarFunc) and cross.op == "!=" and
            len(cross.args) == 2):
        return False
    a, b_out = cross.args
    if not (isinstance(a, Column) and a.idx in inner_cols):
        a, b_out = b_out, a
    if not (isinstance(a, Column) and a.idx in inner_cols):
        return False
    if (_cols_of(b_out) & inner_cols) or not is_device_safe(b_out):
        return False
    l_e, r_e = p.eq_conds[0]
    k_in, k_out = (l_e, r_e) if isinstance(l_e, Column) and \
        l_e.idx in inner_cols else (r_e, l_e)
    if not (isinstance(k_in, Column) and k_in.idx in inner_cols) or \
            (_cols_of(k_out) & inner_cols):
        return False
    if not (_fusable_key_ft(k_in.ft) and _fusable_key_ft(a.ft) and
            _fusable_key_ft(b_out.ft)):
        return False
    import dataclasses
    ft_i64 = new_bigint_type()
    k_sc = next(s for s in inner.dag.cols if s.col.idx == k_in.idx)
    a_sc = next(s for s in inner.dag.cols if s.col.idx == a.idx)
    k_col = Column(k_in.idx, k_in.ft, k_sc.name)
    a_col = Column(a.idx, a.ft, a_sc.name)
    cnt_cols = []
    for gi, gcols in enumerate(([k_col], [k_col, a_col])):
        cnt_col = Column(
            _syn_id("cntpair", inner.dag.table_info.id, k_in.idx, a.idx,
                    gi, p.join_type,
                    *(f.fingerprint() for f in inner.dag.filters)),
            ft_i64, f"cnt${gi}")
        sub_aggs = [AggDesc("count", [], ft=ft_i64)]
        dag2 = dataclasses.replace(
            inner.dag, cols=list(inner.dag.cols),
            filters=list(inner.dag.filters),
            host_filters=list(inner.dag.host_filters),
            group_items=list(gcols),
            aggs=[_to_partial(x) for x in sub_aggs])
        rd = PhysTableReader(dag2, inner.schema)
        rd.stats_rows = inner.stats_rows
        schema = Schema([SchemaCol(g, g.name) for g in gcols] +
                        [SchemaCol(cnt_col, cnt_col.name)])
        sp = PhysHashAgg(list(gcols), sub_aggs, "final", schema, rd)
        sp.stats_rows = max(inner.stats_rows / 4.0, 1.0)
        econds = [(k_col, k_out)]
        if gi == 1:
            econds.append((a_col, b_out))
        outer_dims.append((_AggLeaf(sp, sp), "left", econds, p))
        cnt_cols.append(cnt_col)
    zero = const_from_py(0, ft_i64)
    diff = ScalarFunc("-", [
        ScalarFunc("ifnull", [cnt_cols[0], zero], ft_i64),
        ScalarFunc("ifnull", [cnt_cols[1], zero], ft_i64)], ft_i64)
    filters.append(ScalarFunc(">" if p.join_type == "semi" else "=",
                              [diff, zero], ft_i64))
    return True


def _is_unique_col(tbl, name):
    nm = name.lower()
    if tbl.pk_is_handle and tbl.pk_col_name.lower() == nm:
        return True
    for idx in tbl.public_indexes():
        if (idx.unique or idx.primary) and len(idx.columns) == 1 and \
                idx.columns[0].lower() == nm:
            return True
    return False


def _cols_of(expr):
    s = set()
    expr.collect_columns(s)
    return s


def _fusable_key_ft(ft):
    """Join keys the fused pipeline compares as raw int64 (strings would
    need cross-dictionary translation; floats bitwise-compare unsafely)."""
    from ..types.field_type import TypeClass as TC
    return ft.tclass in (TC.INT, TC.UINT, TC.DATE, TC.DATETIME,
                         TC.TIMESTAMP, TC.DURATION)


def _inner_key_info(leaf: PhysTableReader, col_idx):
    """-> (SchemaCol, IndexInfo|None) when col_idx is the leaf table's
    clustered PK or a single-column unique index; None otherwise."""
    tbl = leaf.dag.table_info
    sc = next((s for s in leaf.dag.cols if s.col.idx == col_idx), None)
    if sc is None:
        return None
    nm = sc.name.lower()
    if tbl.pk_is_handle and tbl.pk_col_name.lower() == nm:
        return sc, None
    for idx in tbl.public_indexes():
        if getattr(idx, "invisible", False):
            continue        # invisible indexes serve no read path
        if (idx.unique or idx.primary) and len(idx.columns) == 1 and \
                idx.columns[0].lower() == nm:
            return sc, idx
    return None


def _try_join_strategy(plan: LJoin, left, right, hash_plan):
    """Hint- and cost-driven alternatives to the hash join (reference
    find_best_task.go physical property enumeration, collapsed to a
    direct choice): INL_JOIN -> PhysIndexLookupJoin when the inner side
    is a plain scan with a PK/unique key on the join column and the
    outer side is selective; MERGE_JOIN -> PhysMergeJoin."""
    inl = _hint_tables("inl_join")
    mj = _hint_tables("merge_join")
    hj = _hint_tables("hash_join")

    def _subtree_tables(p):
        out = set()
        if isinstance(p, PhysTableReader):
            out.add(p.dag.table_info.name.lower())
        for c in p.children:
            out |= _subtree_tables(c)
        return out

    join_tables = _subtree_tables(left) | _subtree_tables(right)
    if mj is not None and ("*" in mj or join_tables & set(mj)) and \
            plan.join_type in ("inner", "left") and \
            len(plan.eq_conds) == 1 and \
            not getattr(plan, "null_aware", False) and \
            all(_fusable_key_ft(a.ft) and _fusable_key_ft(b.ft)
                for a, b in plan.eq_conds):
        p = PhysMergeJoin(plan.join_type, plan.eq_conds, plan.other_conds,
                          plan.schema, left, right)
        p.stats_rows = plan.stats_rows
        return p
    if hj is not None and ("*" in hj or join_tables & set(hj)):
        return None                    # user asked for the hash join
    if plan.join_type not in ("inner", "left") or len(plan.eq_conds) != 1 \
            or getattr(plan, "null_aware", False):
        return None
    l_expr, r_expr = plan.eq_conds[0]
    if not (_fusable_key_ft(l_expr.ft) and _fusable_key_ft(r_expr.ft)):
        return None

    def try_side(inner_phys, outer_phys, inner_eq, outer_eq, outer_is_left):
        if not isinstance(inner_phys, PhysTableReader):
            return None
        dag = inner_phys.dag
        if dag.aggs or dag.topn is not None or dag.limit >= 0 or \
                dag.table_info.partitions or dag.table_info.id < 0:
            return None
        if not isinstance(inner_eq, Column):
            return None
        ki = _inner_key_info(inner_phys, inner_eq.idx)
        if ki is None:
            return None
        # left outer join preserves the LEFT side: inner must be right
        if plan.join_type == "left" and not outer_is_left:
            return None
        alias = dag.table_info.name.lower()
        if inl is not None:
            if "*" not in inl and alias not in inl:
                return None
        else:
            # cost gate: selective outer, non-trivial inner
            outer_rows = outer_phys.stats_rows or 1.0
            inner_raw = getattr(inner_phys, "raw_rows",
                                inner_phys.stats_rows) or 1.0
            if not (outer_rows <= 128 and inner_raw >= outer_rows * 16):
                return None
        sc, idx = ki
        p = PhysIndexLookupJoin(
            plan.join_type, outer_phys, dag, sc, idx, outer_eq,
            plan.other_conds, plan.schema, hash_plan)
        p.outer_is_left = outer_is_left
        p.stats_rows = plan.stats_rows
        return p

    # orientation: inner side = the one whose eq expr is a keyed column
    r = try_side(right, left, r_expr, l_expr, True)
    if r is None:
        r = try_side(left, right, l_expr, r_expr, False)
    return r


def _subst_cols(e, mapping):
    """Replace Column refs per mapping {idx: Expression}; shares untouched
    subtrees (expressions are immutable by convention)."""
    if isinstance(e, Column):
        return mapping.get(e.idx, e)
    if isinstance(e, ScalarFunc):
        na = [_subst_cols(a, mapping) for a in e.args]
        if all(x is y for x, y in zip(na, e.args)):
            return e
        return ScalarFunc(e.op, na, e.ft)
    return e


# plan-time device-routing cost gate (see the comment at the
# PhysFusedPipeline construction): decline fusing when the estimated
# group count is BOTH above this absolute floor and above this fraction
# of the fact cardinality
_FUSE_MAX_GROUPS_ABS = 1 << 18
_FUSE_MAX_GROUP_RATIO = 0.10
# combined dim build MASS (aggregate-subquery dims count their input
# rows) above BOTH bounds -> conventional host join. q18's one
# fact-sized IN-subquery dim lands ~1.3x fact and stays fused; q21's
# FOUR pair-count dims land ~4x fact and route to host.
_FUSE_MAX_DIM_MASS_ABS = 1 << 21
_FUSE_DEV_DIM_MASS_ABS = float(os.environ.get(
    "TIDB_TPU_FUSE_DEV_DIM_MASS_ABS", str(1 << 26)))
_FUSE_MAX_DIM_MASS_RATIO = 2.0


def _try_fuse_agg(plan: Aggregation, child: PhysPlan):
    """Aggregation over an inner-join tree of plain table scans ->
    PhysHashAgg(final) over a PhysFusedPipeline, when every expression is
    device-safe and every join can be oriented as probe(pipeline) ->
    build(bare int column of an unused scan). The conventional subtree is
    kept as the runtime fallback.

    Derived tables (Q7/Q8/Q9's `from (select ...) as x`) put
    Shell/Projection layers between the agg and the join tree; they peel
    here by substituting each projection's exprs into the group items,
    agg args and any filters collected above it, so the fused plan's
    expressions reference leaf columns directly."""
    group_items = list(plan.group_items)
    agg_args = [list(a.args) for a in plan.aggs]
    peeled_filters = []
    substituted = False
    p = child
    while True:
        if isinstance(p, PhysShell):
            p = p.children[0]
        elif isinstance(p, PhysProjection):
            m = {sc.col.idx: e
                 for sc, e in zip(p.schema.cols, p.exprs)}
            group_items = [_subst_cols(g, m) for g in group_items]
            agg_args = [[_subst_cols(a, m) for a in args]
                        for args in agg_args]
            peeled_filters = [_subst_cols(f, m) for f in peeled_filters]
            substituted = True
            p = p.children[0]
        elif isinstance(p, PhysSelection):
            peeled_filters.extend(p.conds)
            p = p.children[0]
        else:
            break
    aggs = list(plan.aggs)
    if substituted:
        aggs = [AggDesc(a.name, args, a.distinct, a.ft, a.mode,
                        a.order_by, a.separator)
                for a, args in zip(plan.aggs, agg_args)]
    for a in aggs:
        if a.name not in _PUSHABLE_AGGS or a.distinct:
            return None
        if not all(is_device_safe(arg) for arg in a.args):
            return None
    for g in group_items:
        if not is_device_safe(g):
            return None
    leaves, eqs, filters, outer_dims = list(), [], list(peeled_filters), []
    if not _collect_join_tree(p, leaves, eqs, filters, outer_dims) \
            or not leaves:
        return None
    if len(leaves) < 2 and not outer_dims and not eqs:
        # single-table scan->filter->agg (Q1/Q6): a zero-dim fused
        # pipeline — same kernels as the copr agg path single-chip,
        # but it FRAGMENTS onto the mesh like every other fused shape
        # (PassThrough exchange)
        if len(leaves) != 1 or isinstance(leaves[0], _AggLeaf):
            return None
    elif (len(leaves) < 2 and not outer_dims) or \
            (not eqs and not outer_dims):
        return None
    for f in filters:
        if not is_device_safe(f):
            return None
    if outer_dims:
        other_refs = set()
        for e in list(group_items) + list(filters):
            other_refs |= _cols_of(e)
        for l, r in eqs:
            other_refs |= _cols_of(l) | _cols_of(r)
        for _leaf, _jt, ec, _node in outer_dims:
            for l, r in ec:
                other_refs |= _cols_of(l) | _cols_of(r)
        eager = _eager_agg_outer_dims(outer_dims, group_items, aggs,
                                      other_refs)
        if eager is not None:
            outer_dims, aggs, (joinnode, subagg) = eager
            p2 = _swap_join_build(p, joinnode, subagg)
            if p2 is None:
                return None
            p = p2
    owner = {}                      # col idx -> leaf reader
    for leaf in leaves:
        for sc in leaf.dag.cols:
            owner[sc.col.idx] = leaf
    # fact candidates by RAW size (filtered stats can make the true fact
    # look smaller than a dimension); try each until one orients
    # the runtime fallback is the PEELED join tree: the fused plan's
    # exprs are substituted to leaf columns, so the fallback must expose
    # leaf columns too (the projection layers above only rename/compute
    # what the partial-agg shim now computes itself); filters that sat
    # above a projection re-apply via a Selection wrapper
    fallback = p if not peeled_filters else PhysSelection(
        list(peeled_filters), p)
    candidates = sorted(
        (c for c in leaves if not isinstance(c, _AggLeaf)),
        key=lambda c: getattr(c, "raw_rows", c.stats_rows),
        reverse=True)
    for fact in candidates:
        r = _orient_pipeline(plan, fallback, leaves, eqs, filters, owner,
                             fact, outer_dims, group_items, aggs)
        if r is not None:
            return r
    return None


def _orient_pipeline(plan, child, leaves, eqs, filters, owner, fact,
                     outer_dims=(), group_items=None, aggs=None):
    group_items = plan.group_items if group_items is None else group_items
    aggs = plan.aggs if aggs is None else aggs
    pipe = {sc.col.idx for sc in fact.dag.cols}
    used = {id(fact)}
    dims = []
    post = []
    remaining = list(eqs)
    ft_i64 = new_bigint_type()

    def try_join(l, r, unique_only):
        for b, pexp in ((l, r), (r, l)):
            if not isinstance(b, Column):
                continue
            leaf = owner.get(b.idx)
            if leaf is None or id(leaf) in used:
                continue
            if not (_cols_of(pexp) <= pipe and is_device_safe(pexp)):
                continue
            if not (_fusable_key_ft(b.ft) and _fusable_key_ft(pexp.ft)):
                continue
            sc = next(s for s in leaf.dag.cols if s.col.idx == b.idx)
            if unique_only and not (
                    leaf.unique_on(b.idx) if isinstance(leaf, _AggLeaf)
                    else _is_unique_col(leaf.dag.table_info, sc.name)):
                continue
            dims.append(DimJoin(leaf.dag, sc, pexp, "inner",
                                subplan=getattr(leaf, "plan", None)))
            used.add(id(leaf))
            pipe.update(s.col.idx for s in leaf.dag.cols)
            return True
        return False

    def try_composite():
        # two or more eq conds against one unattached leaf -> composite
        # packed-key dim (Q9 partsupp on (ps_partkey, ps_suppkey)); the
        # runtime verifies packed uniqueness and falls back otherwise
        by_leaf = {}
        for eq in remaining:
            l, r = eq
            for b, pexp in ((l, r), (r, l)):
                if isinstance(b, Column):
                    leaf = owner.get(b.idx)
                    if leaf is not None and id(leaf) not in used and \
                            _cols_of(pexp) <= pipe and \
                            is_device_safe(pexp) and \
                            _fusable_key_ft(b.ft) and \
                            _fusable_key_ft(pexp.ft):
                        by_leaf.setdefault(id(leaf), []).append(
                            (leaf, b, pexp, eq))
                        break
        for entries in by_leaf.values():
            if len(entries) < 2:
                continue
            leaf = entries[0][0]
            pairs = []
            for _, b, pexp, _eq in entries:
                sc = next(s for s in leaf.dag.cols if s.col.idx == b.idx)
                pairs.append((sc, pexp))
            dims.append(DimJoin(leaf.dag, pairs[0][0], pairs[0][1],
                                "inner", tuple(pairs[1:]),
                                subplan=getattr(leaf, "plan", None)))
            used.add(id(leaf))
            pipe.update(s.col.idx for s in leaf.dag.cols)
            for _, _, _, eq in entries:
                remaining.remove(eq)
            return True
        return False

    progress = True
    while remaining and progress:
        progress = False
        # unique singles first, then composite (so a 2-eq leaf packs
        # instead of attaching one non-unique column), then any single
        for phase in ("unique", "composite", "any"):
            if phase == "composite":
                progress = try_composite()
            else:
                nxt = []
                for l, r in remaining:
                    if _cols_of(l) <= pipe and _cols_of(r) <= pipe:
                        if not (is_device_safe(l) and is_device_safe(r)):
                            return None
                        post.append(ScalarFunc("=", [l, r], ft_i64))
                        progress = True
                    elif try_join(l, r, phase == "unique"):
                        progress = True
                    else:
                        nxt.append((l, r))
                remaining = nxt
            if progress:
                break                # re-prefer unique keys next round
    if remaining or len(used) != len(leaves):
        return None
    # LEFT/SEMI dims attach after the inner orientation: their probe
    # exprs may use any pipeline column; a left dim contributes columns,
    # a semi dim only masks. Collection order is outermost-first —
    # attach innermost-first so an outer dim can probe an inner one
    for leaf, jt, econds, _node in reversed(outer_dims):
        pairs = []
        for l_e, r_e in econds:       # >1 pair: composite outer dim
            build, probe = None, None
            for b, pexp in ((l_e, r_e), (r_e, l_e)):
                if isinstance(b, Column) and \
                        any(s.col.idx == b.idx for s in leaf.dag.cols) and \
                        _cols_of(pexp) <= pipe and is_device_safe(pexp) and \
                        _fusable_key_ft(b.ft) and _fusable_key_ft(pexp.ft):
                    build, probe = b, pexp
                    break
            if build is None:
                return None
            sc = next(s for s in leaf.dag.cols if s.col.idx == build.idx)
            pairs.append((sc, probe))
        dims.append(DimJoin(leaf.dag, pairs[0][0], pairs[0][1], jt,
                            tuple(pairs[1:]),
                            subplan=getattr(leaf, "plan", None)))
        if jt == "left":
            pipe.update(s.col.idx for s in leaf.dag.cols)
    for f in filters:
        if not (_cols_of(f) <= pipe):
            return None
    post.extend(filters)
    for e in list(group_items) + [a0 for a in aggs for a0 in a.args]:
        if not (_cols_of(e) <= pipe):
            return None
    # cost gate: a near-per-row group domain (Q18's GROUP BY o_orderkey
    # class) gains nothing from the device — the sort-based agg lowering
    # pays O(n log n) on ~n groups, every group ships back to the host
    # merge, and the measured on-chip sort is the weakest primitive
    # (ROADMAP §0). The host hash agg wins these outright (r4 measured:
    # q18@SF1 device 17.7s vs host 5.8s), so route them to the
    # conventional subtree at PLAN time — the same engine-choice call
    # the reference makes between TiKV and TiFlash by cost.
    est_groups = plan.stats_rows
    est_fact = max(fact.raw_rows
                   if getattr(fact, "raw_rows", 0) else fact.stats_rows,
                   1.0)
    if est_groups > _FUSE_MAX_GROUPS_ABS and \
            est_groups > _FUSE_MAX_GROUP_RATIO * est_fact:
        return None
    # build-side mass gate (Q21's EXISTS/NOT-EXISTS class): four
    # per-orderkey AGGREGATE dims each MATERIALIZE an aggregation over
    # ~the whole fact, and those results rebuild whenever the byte-
    # bounded matdim cache evicts them (SF10 measured: fused 313s vs
    # host semi-joins 38s). ONLY aggregate-subquery dims count — a
    # plain table dim (q4's lineitem semi) sorts once per version and
    # is cached by the engine itself, and gating it cost q4 its 6x win.
    # Input mass is used (aggregate output stats are unreliable).
    def agg_mass(leaf):
        if not isinstance(leaf, _AggLeaf):
            return 0.0
        total = 0.0
        stack = [leaf.plan]
        while stack:
            p0 = stack.pop()
            if isinstance(p0, (PhysTableReader, PhysFusedPipeline)):
                total += max(getattr(p0, "raw_rows", 0.0) or 0.0,
                             p0.stats_rows or 0.0)
            stack.extend(getattr(p0, "children", []))
        return total
    dim_rows = sum(agg_mass(l) for l in leaves if l is not fact) + \
        sum(agg_mass(l) for l, _jt, _ec, _n in outer_dims)
    if dim_rows > _FUSE_MAX_DIM_MASS_ABS and \
            dim_rows > _FUSE_MAX_DIM_MASS_RATIO * est_fact:
        # the host-semi-join alternative only wins on the CPU device:
        # on the card the conventional subtree runs every operator on
        # the host against the device-resident store, while the
        # aggregate dims materialize through device fragments. The
        # card keeps an ABSOLUTE ceiling as the device-memory escape
        # hatch: dims beyond it cannot all be resident. Only
        # aggregate-subquery dims count here: copr/pipeline.py
        # materializes each once and keeps the result across
        # statements while its base tables are unchanged.
        if getattr(_TLS, "device_type", "cpu") != "cuda" or \
                dim_rows > _FUSE_DEV_DIM_MASS_ABS:
            return None
    fused = PhysFusedPipeline(fact.dag, dims, post,
                              list(group_items),
                              [_to_partial(a) for a in aggs],
                              plan.schema, child)
    fused.stats_rows = plan.stats_rows
    agg = PhysHashAgg(group_items, aggs, "final", plan.schema, fused)
    agg.stats_rows = plan.stats_rows
    return agg


def _try_fuse_distinct(plan: Aggregation, child: PhysPlan):
    """COUNT(DISTINCT x) over a join tree (Q16) -> two stages: the fused
    pipeline groups by (G..., x) — deduplication IS aggregation on
    device — then a host complete-agg counts pair rows per G. Reference:
    the distinct spill path in agg_hash_executor.go, re-shaped so the
    heavy dedup runs as the device group-by."""
    if len(plan.aggs) != 1:
        return None
    a = plan.aggs[0]
    if not (a.distinct and a.name == "count" and len(a.args) == 1):
        return None
    x = a.args[0]
    ft_i64 = new_bigint_type()

    class _Inner:
        pass
    inner = _Inner()
    inner.group_items = list(plan.group_items) + [x]
    inner.aggs = [AggDesc("count", [], ft=ft_i64)]
    mid_cols = [Column(_syn_id("cdist-g", i, g.fingerprint()), g.ft,
                       f"g${i}")
                for i, g in enumerate(inner.group_items)]
    mid_cols.append(Column(
        _syn_id("cdist-cnt", x.fingerprint(),
                *(g.fingerprint() for g in plan.group_items)),
        ft_i64, "cnt$"))
    inner.schema = Schema([SchemaCol(c, c.name) for c in mid_cols])
    inner.stats_rows = plan.stats_rows * 4
    fused = _try_fuse_agg(inner, child)
    if fused is None:
        return None
    ngi = len(plan.group_items)
    outer = PhysHashAgg(
        [mid_cols[i] for i in range(ngi)],
        [AggDesc("count", [mid_cols[ngi]], ft=a.ft)],
        "complete", plan.schema, fused)
    outer.stats_rows = plan.stats_rows
    return outer


def attach_fused_topn(plan: PhysPlan) -> PhysPlan:
    """Annotate TopN(HashAgg final(FusedPipeline)) shapes with the
    primary order metric so the fused kernel can return only the
    top-candidate partials instead of every group (Q3/Q10/Q18's
    ORDER BY revenue LIMIT k over millions of groups; reference role:
    pushed-down topN, tipb executor TopN after aggregation).

    The annotation is advisory: pipeline.fused_partials applies it only
    when the group keys ride a verified clustered storage order
    (ColumnarTable.is_clustered), which makes per-run partials exact
    per-group, and falls back whenever tie-bounds cannot prove the
    candidate set covers the true top k."""
    def hop(p):
        while p is not None and p.__class__.__name__ in (
                "PhysExchangeReceiver", "PhysExchangeSender"):
            p = p.children[0] if p.children else None
        return p

    def walk(p):
        if isinstance(p, PhysTopN) and p.children and p.items:
            agg = hop(p.children[0])
            if isinstance(agg, PhysHashAgg) and agg.mode == "final" and \
                    agg.children:
                fused = hop(agg.children[0])
                ngi = len(agg.group_items)
                k_total = (p.offset or 0) + (p.count or 0)
                if isinstance(fused, PhysFusedPipeline) and \
                        0 < k_total <= 4096 and \
                        len(agg.schema.cols) == ngi + len(agg.aggs):
                    item, desc = p.items[0]
                    if isinstance(item, Column):
                        for pos, sc in enumerate(agg.schema.cols):
                            if sc.col.idx == item.idx:
                                if pos < ngi:
                                    fused.topn_spec = ("group", pos,
                                                       bool(desc), k_total)
                                else:
                                    fused.topn_spec = ("agg", pos - ngi,
                                                       bool(desc), k_total)
                                break
        for c in p.children:
            walk(c)

    walk(plan)
    return plan


def _can_push_agg(agg: Aggregation, reader: PhysTableReader) -> bool:
    if reader.dag.limit >= 0:
        return False
    for a in agg.aggs:
        if a.name not in _PUSHABLE_AGGS or a.distinct:
            return False
        if not all(is_device_safe(arg) for arg in a.args):
            return False
    for g in agg.group_items:
        if not is_device_safe(g):
            return False
    return True


def _to_partial(a: AggDesc) -> AggDesc:
    p = AggDesc(name=a.name, args=a.args, distinct=a.distinct, ft=a.ft,
                mode="partial1")
    return p


def explain_text(plan: PhysPlan) -> list:
    rows = []
    plan.explain_rows(rows)
    out = []
    for pid, depth, est, info in rows:
        prefix = ("  " * (depth - 1) + "└─") if depth > 0 else ""
        out.append((prefix + pid, est, info))
    return out
