"""In-process coprocessor: executes pushed-down CoprDAGs (reference
role: TiKV coprocessor handling tipb.DAGRequest —
unistore/cophandler/closure_exec.go:167), ported from tidb_tpu's
copr/dag_exec.py to PyTorch on one device.

What is ported: the upload seams into the device-resident store
(_pad_upload / _upload_padded / _dev_put / _dev_put_append), the dense
partial aggregation that the fused pipeline (copr/pipeline.py) runs on
the device, and the host twin of every reader DAG (_execute_host /
_host_partial_agg). The dense lowering routes by shape:

  nslots == 1, range filters   dense_agg_states_range
                                  -> ops.range_filter_sums
  nslots == 1, no range filter _dense_agg_states_reduce
                                  -> ops.masked_sums
  nslots <= MAX_SLOTS          _dense_agg_states_bcr
                                  -> ops.dense_group_sums
  any other shape              _dense_agg_states_scatter (torch
                               index_add_ / scatter_reduce_, the
                               reference's CPU lowering)

A group domain with no dense layout takes sort_agg_body, lowered as the
policy _segment_impl says: "scatter" on the CPU (the oracle), "runs" on
the card (contiguous-run partials, runs_agg_body: no sort), and
"sorted" once a runs query shape has been pinned there for unclustered
keys. On the card the fused pipeline also sends dense and posdense
domains over _BCR_MAX slots to the runs lowering, as the reference does
on its device. None of these lowerings reads the host: their segmented
reductions are prefix-sum differences (int64 sums and counts, exact)
and scatters into buffers indexed by segment ordinal (float sums,
min/max, first_row), where every row outside a segment lands in one of
_SPILL spread spill slots.

The range route is the fused fragment's (copr/pipeline.py): its fact
filters that copr/range_lowering.py turns into column bounds are tested
inside the kernel, and a sum/avg of the product of two bare int or
decimal columns that needs no rescale (fold_pairs; Q6's
l_extendedprice * l_discount) is summed there as a product pair. The three kernels take a shape only when every
aggregate is sum/avg/count and every argument is an int64 tensor without
a null mask (k <= 16, _kernel_args); a global reduce of any other shape
runs the plain torch twin of the reference's masked reductions, and a
slot domain the scatter.

A reader DAG (a scan outside a fused node: a filter, a top-n, a
partition aggregation, or a materialized dim's subplan scan) is routed
as the reference routes it (_execute_inner): virtual tables, DAGs whose
expressions or column types have no device form (_dag_decline;
a shape the device rule declines counts copr_host_bound)
and pure scans take the numpy host twin (copr_host_exec); a filter-only
or top-n-only DAG under tidb_tpu_fragment_min_rows rows does too
(copr_fragment_gated); every other DAG runs one fragment call per
partition on the device (copr_device_exec): the validity mask ANDed with
each filter (_run_filter_partition), a filter plus a stable top-k on one
key (topn_body; on the CPU the reference's _topn_host), or the partition
aggregation (_run_agg_partition: dense_agg_body, whose one- and <= 64-slot
layouts reach masked_sums and dense_group_sums, or sort_agg_body, with
the bucket regrow and runs->sorted pin of learn_sort_kind). Every
fragment call of the device, reader or fused, goes through run_fragment.
On the card a fragment that fails fails its statement; on the CPU it
degrades to the host twin, as the reference does.

The MPP mesh route (reference _try_execute_mpp): with
tidb_enable_mpp on, a mesh of two or more shards (the Domain's mesh
argument, else every visible CUDA device) and at least
tidb_mpp_min_rows rows, an aggregation DAG with a dense layout runs as
ONE mesh program (copr_mpp_exec, backend device-mpp): its columns and
validity mask stay resident row-sharded over the mesh (_dev_put_append
/ _dev_put, spec "sharded"), each shard runs the partition's
dense_agg_body — and so the same scan kernels — over its rows, and one
psum merges the shards' dense tables (psum_dense_result). On the card a
mesh run that fails fails its statement; it is never retried on one
device. Below two shards the route declines and every path above runs
as it does without a mesh.

The one-hot lowering (onehot_agg_body) takes a small group domain
whose slot table the fused pipeline learned from an earlier statement
(copr/pipeline.py): each row's packed group key is looked up in the
table and its int64 states add into its slot; a key not in the table is
counted as a miss, and the pipeline reruns the partition with the sort
kind.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..expression import EvalCtx, eval_expr, eval_bool_mask
from ..expression.expr import Column as ExprColumn, ScalarFunc
from ..expression import vec as _vec
from ..expression.vec import materialize_nulls, mul_is_plain_int64
from ..expression.torch_ns import (Decline, TorchNS, device_form,
                                    torch_dtype)
from ..utils import env_int
from ..utils.fetch import prefetch, host_array, host_int
from .residency import DeviceResidentStore
from ..utils import memory as _memory
from ..utils import phase
from ..utils import device_guard
from ..utils import metrics as _metrics
from ..utils.torchcfg import INT64, resolve_device
from ..chunk.device import shape_bucket, upload
from ..chunk.column import Column
from ..chunk.chunk import Chunk
from ..ops import scan_kernels
from ..types.field_type import TypeClass

_I64_MAX = np.iinfo(np.int64).max


class _KernelCache(dict):
    """Fragment-callable cache with hit/miss counters (reference
    coprocessor_cache.go metrics; surfaced per-operator by
    EXPLAIN ANALYZE's backend column). Every inserted fragment is
    wrapped with phase accounting (utils/phase.py): dispatch counts
    and per-kind time feed the bench sidecar artifact."""

    def __init__(self):
        super().__init__()
        self.hits = 0
        self.misses = 0

    def __setitem__(self, key, fn):
        kind = key[0] if isinstance(key, tuple) and key and \
            isinstance(key[0], str) else "kern"
        dict.__setitem__(self, key, phase.timed_kernel(kind, fn))

    def put(self, key, fn):
        """Insert and return the phase-wrapped fragment — call sites
        must dispatch the returned callable, not the raw one, or the
        first call vanishes from the phase stats."""
        self[key] = fn
        return dict.__getitem__(self, key)

    def get(self, key, default=None):
        v = super().get(key, default)
        if v is None:
            self.misses += 1
            _metrics.KERNEL_CACHE.labels("miss").inc()
        else:
            self.hits += 1
            _metrics.KERNEL_CACHE.labels("hit").inc()
        return v


class CoprExecutor:
    """Executes CoprDAGs against ColumnarTables on one torch device;
    caches fragment callables and device-resident column buffers."""

    def __init__(self, engine, device_rows=None, use_device=True,
                 dev_cache_bytes=8 << 30, device=None, mesh=None):
        self.engine = engine            # ColumnarEngine
        if device_rows is None:
            # partition size (rows per fragment call)
            device_rows = int(os.environ.get("TIDB_TPU_DEVICE_ROWS",
                                             str(1 << 22)))
        self.device_rows = device_rows
        self.use_device = use_device
        self.device = resolve_device(device)
        # the MPP mesh: a parallel.Mesh, an int (that many shards on
        # self.device), or None (every visible CUDA device); resolved
        # on first use by _get_mesh
        self.mesh_spec = mesh
        self._mesh = None
        # fragment selection (docs/PERFORMANCE.md): a filter/top-n-only
        # fragment below this many rows runs the host twin — its work
        # costs less than its dispatch and fetch. Aggregation fragments
        # always dispatch: their partials shrink the fetch to group
        # cardinality. The session's tidb_tpu_fragment_min_rows wins.
        self.fragment_min_rows = env_int("TIDB_TPU_FRAGMENT_MIN_ROWS",
                                         1 << 21)
        # on the card a fragment that fails fails its statement: the
        # numpy host twin serves only plans declined before dispatch.
        # On the CPU the guard degrades to it, as the reference does.
        self.degrade_to_host = self.device.type != "cuda"
        self.xp = TorchNS(self.device)
        self._kernel_cache = _KernelCache()
        self.last_backend = ""          # backend of the latest execute()
        # the device rule's reason when it sent the latest reader DAG to
        # the host (torch_ns.device_form)
        self.last_host_reason = None
        # device-resident columnar store: column buffers stay in device
        # memory across statements, keyed by (table, ..., version, ...)
        # and eagerly invalidated when a DML commit bumps the version
        # (copr/residency.py)
        self._dev_store = DeviceResidentStore(dev_cache_bytes)
        # memory pressure protocol (utils/device_guard): an
        # out-of-memory dispatch sheds cold resident entries from this
        # pool before retrying; weakly registered so discarded
        # test/mirror domains stay collectable
        device_guard.register_pressure_store(self._dev_store)
        # incremental HTAP (copr/delta.py): folds committed deltas
        # into resident buffers at bind time instead of letting the
        # version sweep drop-and-reupload them whole; also the
        # freshness bookkeeping behind tidb_replica_freshness
        from .delta import DeltaMaintainer
        self.delta = DeltaMaintainer(self)
        # host-side per-version metadata (learned pins / sizes)
        self._host_cache: dict = {}

    def _upload_padded(self, arr_np, cap, pad_fill=0, mesh=None,
                       spec="local"):
        """THE upload tail shared by every resident-store seam: pad to
        ``cap``, place by spec (a tensor on the device, or row-sharded /
        replicated over the mesh, parallel.dist), account upload phases
        and the Broadcast exchange. -> the tensor or placed buffer."""
        t0 = time.perf_counter()
        arr = arr_np
        if len(arr) != cap:
            arr = np.concatenate(
                [arr, np.full(cap - len(arr), pad_fill,
                              dtype=arr.dtype)])
        if mesh is None or spec == "local":
            dev = upload(arr, self.device)
            moved = dev.numel() * dev.element_size()
        elif spec == "sharded":
            from ..parallel import row_sharding
            dev = row_sharding(mesh).place(arr)
            moved = dev.numel() * dev.element_size()
        else:
            from ..parallel import replicated_sharding
            dev = replicated_sharding(mesh).place(arr)
            # bytes copied: one copy per distinct device; the exchange
            # counts the mesh's copies, one per shard, as the
            # reference's does
            moved = dev.numel() * dev.element_size() * len(dev.copies)
            _metrics.MPP_EXCHANGE.labels("broadcast").inc()
            _metrics.MPP_EXCHANGE_BYTES.labels("broadcast").inc(
                dev.numel() * dev.element_size() * mesh.size)
        phase.add("upload_s", time.perf_counter() - t0)
        phase.add("upload_bytes", moved)
        phase.inc("uploads")
        # device bytes charge the statement's memory tracker (device
        # memory is governed by the same quota + action chain as host
        # memory; the statement's detach releases the charge at its end)
        _memory.consume_current(moved)
        return dev

    def _dev_put(self, key, arr_np, pad_fill=0, uid=None, version=None,
                 mesh=None, spec="local"):
        """Upload (padded to key[-1]) into the resident store; returns
        the device tensor, or with a mesh the placed buffer: spec
        "sharded" partitions the rows over the mesh and stays
        partitioned across statements (the reference's
        _dev_put_sharded), "replicated" copies it to every device (its
        _dev_put_replicated, the Broadcast exchange, counted on the
        upload and not on a hit); the store charges by spec.
        uid/version feed eager invalidation (defaults: key[0] is the
        table uid by every caller's key layout; version None means
        LRU/uid-wide eviction only)."""
        hit = self._dev_store.get(key)
        if hit is not None:
            phase.inc("upload_hits")
            _metrics.DEV_BUFFER_POOL.labels("hit").inc()
            return hit
        _metrics.DEV_BUFFER_POOL.labels("miss").inc()
        if mesh is None:
            spec = "local"
        dev = self._upload_padded(arr_np, key[-1], pad_fill=pad_fill,
                                  mesh=mesh, spec=spec)
        self._dev_store.put(key, dev, dev.numel() * dev.element_size(),
                            uid=key[0] if uid is None else uid,
                            version=version, spec=spec,
                            ndev=1 if mesh is None else mesh.size)
        return dev

    def _get_mesh(self):
        """The copr's mesh, or None below two shards (the reference's
        rule below two devices): every route then runs on one device."""
        if self._mesh is None:
            from ..parallel.mesh import mesh_of
            spec = self.mesh_spec
            if spec is None and self.device.type != "cuda":
                self._mesh = False
            else:
                m = mesh_of(spec, self.device)
                self._mesh = m if m.size >= 2 else False
        return self._mesh or None

    # ---- public -------------------------------------------------------
    def execute(self, dag, overlay=None, read_ts=None, use_mpp=False,
                mpp_min_rows=1 << 16, ectx=None) -> list:
        """-> list of host Chunks (schema = dag.cols, or partial agg layout:
        [group_keys..., group_nullflags..., agg_states...]).

        overlay: {handle: row_datums|None} from the session's dirty txn
        memBuffer — UnionScan semantics (reference executor/builder.go:1473):
        deleted/updated committed rows are masked out, buffered rows are
        appended before filters run."""
        # reset per call: empty-snapshot / virtual-table paths return
        # early without running a backend — a stale tag from the
        # previous execute must not leak into EXPLAIN ANALYZE
        self.last_backend = ""
        dom = getattr(self, "domain", None)
        t0 = time.perf_counter()
        # install the statement tracker for the upload seams (device
        # bytes charge the statement that asked for them); only when
        # this call carries one — a nested tracker-less call must not
        # clear an enclosing statement's
        tr = getattr(ectx, "mem_tracker", None) if ectx is not None \
            else None
        prev = _memory.push_current(tr) if tr is not None else None
        try:
            if dom is not None:
                with dom.tracer.span("copr",
                                     table=dag.table_info.name):
                    return self._execute_inner(dag, overlay, read_ts,
                                               use_mpp, mpp_min_rows,
                                               ectx)
            return self._execute_inner(dag, overlay, read_ts, use_mpp,
                                       mpp_min_rows, ectx)
        finally:
            if tr is not None:
                _memory.set_current(prev)
            # labeled by the backend that actually served the DAG
            # ("none" = early return: empty snapshot / virtual table)
            _metrics.COPR_DISPATCH_SECONDS.labels(
                self.last_backend or "none").observe(
                time.perf_counter() - t0)

    def _execute_inner(self, dag, overlay, read_ts, use_mpp=False,
                       mpp_min_rows=1 << 16, ectx=None):
        if dag.table_info.id <= -1000:      # INFORMATION_SCHEMA virtual
            tbl = self._materialize_virtual(dag.table_info)
            read_ts = None
        else:
            tbl = self.engine.table(dag.table_info)
            if dag.table_info.id < 0:
                read_ts = None              # session temp table: read latest
            # incremental HTAP (copr/delta.py): fold committed deltas
            # into the resident buffers FIRST — patched entries advance
            # their version in place and survive the sweep below —
            # then drop whatever is still stale (derived entries:
            # validity masks, luts; and unpatchable buffers). Without
            # the fold this sweep was a full drop-and-reupload per
            # DML commit.
            self.delta.refresh(tbl, ectx)
            self._dev_store.invalidate(tbl.uid, tbl.version)
        arrays, valid = tbl.snapshot(
            [cid for cid in (self._cid(dag, sc) for sc in dag.cols)
             if cid != -1], read_ts)
        snapshot_arrays = arrays
        n = len(valid)          # snapshot length, not live tbl.n
        if overlay:
            arrays, valid, n = self._apply_overlay(dag, tbl, arrays, valid,
                                                   n, overlay)
        if n == 0:
            return []
        handles = tbl.handle_array()
        if len(handles) > n and not overlay:
            handles = handles[:n]       # concurrent append after snapshot
        elif n != len(handles):
            handles = np.concatenate([handles[:n - len(self._overlay_handles)]
                                      if len(handles) + len(self._overlay_handles) != n
                                      else handles,
                                      self._overlay_handles])
        decline = None
        if self.use_device and dag.table_info.id > -1000:
            decline = _dag_decline(dag, arrays, self._cid)
            if decline is not None and decline.kind == "host_bound":
                # the reference's route for this shape: its trace reads
                # the host, and the fragment runs on the host twin
                self.last_host_reason = decline.reason
                _metrics.FRAGMENT_ROUTING.labels("host_bound").inc()
                dom = getattr(self, "domain", None)
                if dom is not None:
                    dom.inc_metric("copr_host_bound")
        if not self.use_device or dag.table_info.id <= -1000 or \
                decline is not None:
            if dag.table_info.id > -1000:
                self._bump("copr_host_exec")
            return self._execute_host(dag, tbl, arrays, valid, n, handles)
        if not dag.filters and not dag.host_filters and not dag.aggs \
                and not dag.group_items and dag.topn is None:
            # pure scan: there is no compute to offload — a device
            # "filter" fragment would upload every column to produce an
            # identity mask and fetch it back. The columnar arrays
            # already live host-side; materialize there.
            self._bump("copr_host_exec")
            return self._execute_host(dag, tbl, arrays, valid, n, handles)
        frag_min = self.fragment_min_rows
        if ectx is not None:
            try:
                frag_min = int(ectx.sv.get("tidb_tpu_fragment_min_rows"))
            except Exception:               # noqa: BLE001
                pass
        if not dag.aggs and not dag.group_items and n < frag_min:
            # fragment selection: a filter/top-n-only fragment this
            # small costs less than its dispatch, and its output (a row
            # subset) feeds a host operator anyway
            _metrics.FRAGMENT_ROUTING.labels("host_small").inc()
            dom = getattr(self, "domain", None)
            if dom is not None:
                dom.inc_metric("copr_fragment_gated")
            self._bump("copr_host_exec")
            return self._execute_host(dag, tbl, arrays, valid, n, handles)
        _metrics.FRAGMENT_ROUTING.labels("device").inc()
        if use_mpp and (dag.aggs or dag.group_items) and not overlay \
                and not dag.host_filters and n >= mpp_min_rows:
            res = self._execute_mpp(dag, tbl, arrays, valid, n, handles,
                                    read_ts, ectx)
            if res is not None:
                self._bump("copr_mpp_exec")
                return res
        self._bump("copr_device_exec")
        # device residency only for the table's own rows: an overlay's
        # merged arrays are this statement's alone
        cacheable = n == tbl.n and arrays is snapshot_arrays
        return self._execute_device(dag, tbl, arrays, valid, n, handles,
                                    ectx, cacheable)

    def _bump(self, name):
        """Routing metrics (reference pkg/util/execdetails): which copr
        backend actually ran — the observable the golden routing tests
        pin so a silent device->host regression fails CI."""
        self.last_backend = {"copr_device_exec": "device",
                             "copr_mpp_exec": "device-mpp",
                             "copr_host_exec": "host"}.get(name, "")
        dom = getattr(self, "domain", None)
        if dom is not None:
            dom.inc_metric(name)
            # the copr span covers this (sub)dag's scan+kernel stage:
            # tag it with the backend that actually served it
            dom.tracer.tag(backend=self.last_backend)

    def _apply_overlay(self, dag, tbl, arrays, valid, n, overlay):
        valid = valid.copy()
        for h in overlay:
            pos = tbl.handle_pos.get(h)
            if pos is not None:
                valid[pos] = False
        put_rows = [(h, row) for h, row in overlay.items() if row is not None]
        if not put_rows:
            return arrays, valid, n
        m = len(put_rows)
        cols_info = tbl.table_info.columns
        off_by_id = {ci.id: i for i, ci in enumerate(cols_info)}
        new_arrays = {}
        new_handles = np.array([h for h, _ in put_rows], dtype=np.int64)
        for cid, (data, nulls, sdict) in arrays.items():
            off = off_by_id.get(cid)
            add = np.zeros(m, dtype=data.dtype)
            add_nulls = np.zeros(m, dtype=bool)
            for i, (_, row) in enumerate(put_rows):
                d = row[off] if off is not None and off < len(row) else None
                if d is None or d.is_null:
                    add_nulls[i] = True
                elif sdict is not None:
                    v = d.val
                    add[i] = sdict.encode_one(
                        v if isinstance(v, str) else str(v))
                elif data.dtype == np.float64:
                    add[i] = float(d.val)
                else:
                    add[i] = int(d.val)
            nd = np.concatenate([data, add])
            nn = None
            if nulls is not None or add_nulls.any():
                base_n = nulls if nulls is not None else \
                    np.zeros(len(data), dtype=bool)
                nn = np.concatenate([base_n, add_nulls])
            new_arrays[cid] = (nd, nn, sdict)
        valid = np.concatenate([valid, np.ones(m, dtype=bool)])
        self._overlay_handles = new_handles  # used by _bind_cols for _tidb_rowid
        return new_arrays, valid, n + m

    def _materialize_virtual(self, table_info):
        """INFORMATION_SCHEMA virtual table -> transient columnar table
        (reference pkg/executor/infoschema_reader.go memtable reads)."""
        from ..infoschema.virtual import virtual_rows
        from ..storage.columnar import ColumnarTable
        from ..chunk.column import py_to_datum_fast
        domain = getattr(self, "domain", None)
        tbl = ColumnarTable(table_info)
        if domain is None:
            return tbl
        rows = virtual_rows(domain, table_info)
        fts = [c.ft for c in table_info.columns]
        for h, row in enumerate(rows, start=1):
            datums = [None if v is None else py_to_datum_fast(v, ft)
                      for v, ft in zip(row, fts)]
            tbl.put_row(h, datums)
        return tbl

    def _cid(self, dag, sc):
        """Map a plan SchemaCol to the storage column id by name."""
        ci = dag.table_info.find_column(sc.name)
        if ci is None:
            # hidden handle column
            return -1
        return ci.id

    # ---- shared prep --------------------------------------------------
    def _bind_cols(self, dag, tbl, arrays, part_slice, handles,
                   cacheable=False):
        """-> cols mapping plan-col-idx -> (np data, np nulls, dict).
        When cacheable, also records device-cache keys per column in
        self._bind_keys (cache valid only for pristine table arrays)."""
        cols = {}
        self._bind_keys = {}
        for sc in dag.cols:
            cid = self._cid(dag, sc)
            if cid == -1:
                cols[sc.col.idx] = (handles[part_slice], None, None)
                continue
            data, nulls, sdict = arrays[cid]
            cols[sc.col.idx] = (data[part_slice],
                                None if nulls is None else nulls[part_slice],
                                sdict)
            if cacheable:
                # append-seam bind record (consumed by _pad_upload):
                # version/gc_epoch ride OUT of the cache key so a
                # pure-append commit tail-patches the resident buffer
                # instead of re-uploading it (copr/delta.py)
                self._bind_keys[sc.col.idx] = (
                    tbl.uid, cid, tbl.gc_epoch, part_slice.start,
                    part_slice.stop, tbl.version)
        return cols

    # ---- host (numpy) fallback ---------------------------------------
    def _execute_host(self, dag, tbl, arrays, valid, n, handles):
        t0 = time.perf_counter()
        try:
            return self._execute_host_inner(dag, tbl, arrays, valid, n,
                                            handles)
        finally:
            phase.add("host_exec_s", time.perf_counter() - t0)
            phase.inc("host_execs")

    def _execute_host_inner(self, dag, tbl, arrays, valid, n, handles):
        out = []
        step = self.device_rows
        produced = 0
        shared_dicts = {}
        for start in range(0, n, step):
            sl = slice(start, min(start + step, n))
            cols = self._bind_cols(dag, tbl, arrays, sl, handles)
            v = valid[sl].copy()
            m = v.shape[0]
            ctx = EvalCtx(np, m, cols, host=True)
            for f in dag.filters + dag.host_filters:
                v &= np.asarray(eval_bool_mask(ctx, f))
            if dag.aggs or dag.group_items:
                out.append(_host_partial_agg(ctx, dag, v,
                                             shared_dicts=shared_dicts))
                continue
            idx = np.nonzero(v)[0]
            if dag.limit >= 0:
                remain = dag.limit - produced
                if remain <= 0:
                    break
                idx = idx[:remain]
            produced += len(idx)
            chunk_cols = []
            for sc in dag.cols:
                data, nulls, sdict = cols[sc.col.idx]
                chunk_cols.append(Column(
                    sc.col.ft, data[idx],
                    None if nulls is None else nulls[idx], sdict))
            out.append(Chunk(chunk_cols))
            if 0 <= dag.limit <= produced:
                break
        return out

    # ---- device path --------------------------------------------------
    def _execute_device(self, dag, tbl, arrays, valid, n, handles,
                        ectx=None, cacheable=False):
        """Supervised device execution: each partition's fragment runs
        under device_guard (classified retry/backoff, watchdog). On the
        CPU an exhausted dispatch degrades the whole (sub)dag to the
        host twin, as the reference does; on the card it fails the
        statement (degrade_to_host is False)."""
        try:
            return self._execute_device_inner(dag, tbl, arrays, valid,
                                              n, handles, ectx, cacheable)
        except device_guard.DeviceDegradedError:
            if not self.degrade_to_host:
                raise
            self._bump("copr_host_exec")
            return self._execute_host(dag, tbl, arrays, valid, n,
                                      handles)

    def _execute_device_inner(self, dag, tbl, arrays, valid, n, handles,
                              ectx=None, cacheable=False):
        out = []
        step = self.device_rows
        produced = 0
        dom = getattr(self, "domain", None)
        to_host = self.degrade_to_host
        for start in range(0, n, step):
            sl = slice(start, min(start + step, n))
            m = sl.stop - sl.start
            cap = shape_bucket(m)
            cols = self._bind_cols(dag, tbl, arrays, sl, handles,
                                   cacheable=cacheable)
            # this partition's device-cache keys: a retry binds again
            bind_keys = dict(self._bind_keys)
            v = valid[sl]
            if dag.aggs or dag.group_items:
                out.append(device_guard.guarded_dispatch(
                    lambda: self._run_agg_partition(dag, tbl, cols, v, m,
                                                    cap, bind_keys),
                    site="copr/agg", ectx=ectx, domain=dom,
                    fallback_is_host=to_host))
                continue
            if dag.topn is not None:
                idx = device_guard.guarded_dispatch(
                    lambda: self._run_topn_partition(dag, tbl, cols, v, m,
                                                     cap, bind_keys),
                    site="copr/topn", ectx=ectx, domain=dom,
                    host_fallback=(lambda: self._topn_host(dag, cols, v, m))
                    if to_host else None, fallback_is_host=to_host)
                out.append(self._gather_chunk(dag, cols, idx))
                continue
            mask = device_guard.guarded_dispatch(
                lambda: self._run_filter_partition(dag, tbl, cols, v, m,
                                                   cap, bind_keys),
                site="copr/filter", ectx=ectx, domain=dom,
                fallback_is_host=to_host)
            idx = np.nonzero(mask[:m])[0]
            if dag.limit >= 0:
                remain = dag.limit - produced
                if remain <= 0:
                    break
                idx = idx[:remain]
            produced += len(idx)
            out.append(self._gather_chunk(dag, cols, idx))
            if 0 <= dag.limit <= produced:
                break
        return out

    @staticmethod
    def _gather_chunk(dag, cols, idx):
        """The partition's rows at host indexes `idx`, in dag.cols order."""
        chunk_cols = []
        for sc in dag.cols:
            data, nulls, sdict = cols[sc.col.idx]
            chunk_cols.append(Column(
                sc.col.ft, data[idx],
                None if nulls is None else nulls[idx], sdict))
        return Chunk(chunk_cols)

    def _fragment(self, dag, tbl, kind, cap, extra, build):
        """The cached fragment callable of (dag, kind, capacity, extra);
        build() makes it on a miss."""
        key = self._cache_key(dag, tbl, kind, cap, extra)
        kern = self._kernel_cache.get(key)
        if kern is None:
            kern = self._kernel_cache.put(key, build())
        return kern

    def _device_args(self, dag, cols, v, m, cap, bind_keys):
        """Upload one partition (resident columns, the validity mask with
        the host-only filters ANDed in) -> the fragment's arguments."""
        jcols, vv = self._pad_upload(cols, v, m, cap, bind_keys=bind_keys)
        if dag.host_filters:
            hm = self._host_filter_mask(dag, cols, m)
            hmp = np.concatenate([hm, np.zeros(cap - m, dtype=bool)]) \
                if m != cap else hm
            vv = vv & self.xp.asarray(hmp)
        return {k: (d, nl) for k, (d, nl, _) in jcols.items()}, vv

    @staticmethod
    def _host_filter_mask(dag, cols, m):
        """AND of the DAG's host-only filters over the partition."""
        ctx = EvalCtx(np, m, cols, host=True)
        hm = np.ones(m, dtype=bool)
        for f in dag.host_filters:
            hm &= np.asarray(eval_bool_mask(ctx, f))
        return hm

    def _run_filter_partition(self, dag, tbl, cols, v, m, cap,
                              bind_keys=None):
        """The partition's validity mask (host-only filters ANDed in)
        ANDed with each filter's three-valued mask on the device,
        fetched with one sync."""
        sdicts = {k: c[2] for k, c in cols.items()}
        kern = self._fragment(dag, tbl, "filter", cap, (), lambda:
                              _reader_fragment(dag.filters, sdicts, cap,
                                               self.xp, lambda c, m: m))
        jc, vv = self._device_args(dag, cols, v, m, cap, bind_keys)
        return host_array(prefetch(run_fragment(kern, jc, vv)))

    def _run_topn_partition(self, dag, tbl, cols, v, m, cap,
                            bind_keys=None):
        """Fused filter + device top-k over the single sort key; returns
        host indices of the top rows (<= k) in key order, ties by row.
        On the CPU the host twin _topn_host runs instead, as on the
        reference's CPU backend."""
        (expr, desc), k = dag.topn
        if self.device.type != "cuda":
            return self._topn_host(dag, cols, v, m)
        sdicts = {kk: c[2] for kk, c in cols.items()}
        kern = self._fragment(
            dag, tbl, "topn", cap, (expr.fingerprint(), desc, k),
            lambda: _reader_fragment(
                dag.filters, sdicts, cap, self.xp, lambda ctx, mask:
                topn_body(ctx, mask, expr, desc, k, cap)))
        jc, vv = self._device_args(dag, cols, v, m, cap, bind_keys)
        top_idx, cnt = prefetch(run_fragment(kern, jc, vv))
        return host_array(top_idx)[:host_int(cnt)]

    def _topn_host(self, dag, cols, v, m):
        """Host twin of the top-n fragment: the first k filtered rows by
        (NULL rank, key, row index) — NULLs first ascending, last
        descending, ties by the lowest row index, as topn_body orders
        them."""
        (expr, desc), k = dag.topn
        ctx = EvalCtx(np, m, cols, host=True)
        mask = v[:m].copy()
        for f in dag.filters + dag.host_filters:
            mask &= np.asarray(eval_bool_mask(ctx, f))
        idx = np.nonzero(mask)[0]
        if len(idx) == 0 or k <= 0:
            return np.empty(0, dtype=np.int64)
        d, nl, sd = eval_expr(ctx, expr)
        if np.isscalar(d):
            d = np.full(m, d)
        d = np.asarray(d)
        nm = np.asarray(materialize_nulls(ctx, nl))
        if np.ndim(nm) == 0:
            nm = np.full(m, bool(nm))
        if sd is not None:
            d = sd.ranks()[d]
        skey, rank = _topn_keys_np(d[idx], nm[idx], desc)
        first = rank == 0
        sel = []
        for part in (np.nonzero(first)[0], np.nonzero(~first)[0]):
            want = min(k, len(idx)) - sum(len(x) for x in sel)
            if want <= 0:
                break
            sel.append(part[_smallest_k_stable(skey[part], want)])
        return idx[np.concatenate(sel)]

    def _run_agg_partition(self, dag, tbl, cols, v, m, cap, bind_keys=None,
                           group_bucket=1024):
        """Device partial aggregation -> PartialAggResult: the dense
        layout (dense_agg_body; on the card only up to _BCR_MAX slots
        while the lowering is runs) or the sort kind (sort_agg_body),
        with its bucket regrow and runs->sorted pin (learn_sort_kind)."""
        gbkey = ("gb", tbl.uid,
                 tuple(g.fingerprint() for g in dag.group_items),
                 tuple(a.fingerprint() for a in dag.aggs))
        implk = ("aggimpl", tbl.gc_epoch) + gbkey
        kd, sd = capture_agg_dicts(dag, cols)
        # dense layout: group keys span a small combined domain (dict
        # codes, or int keys after a host min/max pass over the rows)
        strides = _dense_strides(dag, kd, cols, m)
        sdicts = {k: c[2] for k, c in cols.items()}
        dom = getattr(self, "domain", None)
        while True:
            bucket = max(group_bucket, self._host_cache.get(gbkey, 0))
            impl = self._host_cache.get(implk) or \
                _segment_impl(self.device)
            sizes = strides
            if sizes is not None and impl == "runs" and \
                    _dense_nslots(sizes) > _BCR_MAX:
                # the reference's device rule: no scatter into a big
                # dense domain while the lowering is runs
                sizes = None
            # the tails bind this pass's layout: a cached fragment must
            # not see a later pass's bucket or lowering
            groups, aggs = list(dag.group_items), list(dag.aggs)
            if sizes is not None:
                kern = self._fragment(
                    dag, tbl, "dagg", cap, tuple(sizes),
                    lambda: _reader_fragment(
                        dag.filters, sdicts, cap, self.xp,
                        lambda ctx, mask, s=sizes: dense_agg_body(
                            ctx, mask, groups, aggs, s, cap)))
            else:
                kern = self._fragment(
                    dag, tbl, "agg", cap, (bucket, impl),
                    lambda: _reader_fragment(
                        dag.filters, sdicts, cap, self.xp,
                        lambda ctx, mask, b=bucket, i=impl: sort_agg_body(
                            ctx, mask, groups, aggs, cap, b, impl=i)))
            jc, vv = self._device_args(dag, cols, v, m, cap, bind_keys)
            res = prefetch(run_fragment(kern, jc, vv))
            if sizes is not None:
                return _compact_dense(dag, res, sizes, kd, sd)
            ngroups = host_int(res["ngroups"])
            rerun = learn_sort_kind(self._host_cache, gbkey, implk, impl,
                                    bucket, ngroups, m)
            if rerun is not None:
                if dom is not None:
                    dom.inc_metric("copr_" + rerun)
                continue
            return PartialAggResult(
                ngroups=ngroups,
                keys=[host_array(k)[:ngroups] for k in res["keys"]],
                key_nulls=[host_array(kn)[:ngroups]
                           for kn in res["key_nulls"]],
                states=[[host_array(s)[:ngroups] for s in st]
                        for st in res["states"]],
                key_dicts=kd, state_dicts=sd)

    def _pad_upload(self, cols, v, m, cap, bind_keys=None):
        jcols = {}
        if bind_keys is None:
            # instance state is only valid for the MOST RECENT
            # _bind_cols call: pipelined/retried partitions must pass
            # their own captured keys or wrong cached buffers bind
            bind_keys = getattr(self, "_bind_keys", {})
        from .delta import append_key
        for k, (data, nulls, sdict) in cols.items():
            ck = bind_keys.get(k)
            if ck is not None:
                # _bind_cols record: (uid, cid, epoch, start, stop,
                # version). Keys are version-free ("tcol" layout): the
                # entry's rows/version advance in place under appends
                uid, cid, epoch, start, stop, ver = ck
                want = stop - start
                jd = self._dev_put_append(
                    append_key(uid, "frag", cid, "d", epoch, (start,),
                               cap),
                    data, want, cap, uid, ver, epoch, start,
                    self.device_rows)
                jn = None
                if nulls is not None:
                    jn = self._dev_put_append(
                        append_key(uid, "frag", cid, "n", epoch,
                                   (start,), cap),
                        nulls, want, cap, uid, ver, epoch, start,
                        self.device_rows, pad_fill=True)
            else:
                d = data
                if len(d) != cap:
                    d = np.concatenate([d, np.zeros(cap - m, dtype=d.dtype)])
                jd = upload(d, self.device)
                jn = None
                if nulls is not None:
                    nl = np.concatenate(
                        [nulls, np.ones(cap - m, dtype=bool)]) \
                        if len(nulls) != cap else nulls
                    jn = upload(nl, self.device)
            jcols[k] = (jd, jn, sdict)
        # the validity mask is per-dispatch scratch (MVCC visibility at
        # this read ts), uploaded every call and counted apart from the
        # resident columns' upload_bytes; like every upload here it is a
        # pinned, non-blocking copy on the card
        vv = np.concatenate([v, np.zeros(cap - m, dtype=bool)]) \
            if len(v) != cap else v
        phase.add("mask_upload_bytes", vv.nbytes)
        return jcols, upload(vv, self.device)

    def _dev_put_append(self, key, arr_np, want, cap, uid, version,
                        epoch, start, span, pad_fill=0, mesh=None,
                        spec="local"):
        """Append-aware resident upload of an append-only table-column
        slice (docs/PERFORMANCE.md "Incremental HTAP"). ``arr_np``
        holds rows [start, start+want) of the column; the buffer pads
        to ``cap``. A live entry with enough rows is a pure hit; one
        that fell behind is TAIL-PATCHED on device (O(delta) upload)
        and advances its version in place; only a missing entry (or a
        failed/oversized patch) pays the full upload. ``spec``/mesh
        choose placement as in _dev_put; a patch keeps it."""
        store = self._dev_store
        ent = store.get_appendable(key)
        if ent is not None:
            dev, rows, ver = ent
            if rows >= want:
                phase.inc("upload_hits")
                _metrics.DEV_BUFFER_POOL.labels("hit").inc()
                if ver != version:
                    # delete/update-only version bump: data unchanged
                    store.advance_version(key, version)
                return dev
            patched = self.delta.patch_entry(
                key, dev, rows, want, cap, arr_np[rows:want],
                pad_fill, version)
            if patched is not None:
                phase.inc("upload_hits")
                _metrics.DEV_BUFFER_POOL.labels("hit").inc()
                return patched
            store.drop(key, "delta_overflow")
            _metrics.DELTA_APPLY.labels("fell_back_full_upload").inc()
        _metrics.DEV_BUFFER_POOL.labels("miss").inc()
        if mesh is None:
            spec = "local"
        dev = self._upload_padded(arr_np, cap, pad_fill=pad_fill,
                                  mesh=mesh, spec=spec)
        store.put_appendable(key, dev, dev.numel() * dev.element_size(),
                             uid, version, rows=want, start=start,
                             span=span, cap=cap, epoch=epoch, spec=spec,
                             ndev=1 if mesh is None else mesh.size)
        return dev

    # ---- MPP mesh route ------------------------------------------------
    def _execute_mpp(self, dag, tbl, arrays, valid, n, handles, read_ts,
                     ectx):
        """Supervised mesh dispatch of a reader DAG's aggregation. ->
        partials, or None when there is no mesh or the shape has no
        dense layout (the caller runs its single-device route). On the
        CPU a degraded mesh run also returns None, as the reference's
        does; on the card it fails the statement."""
        mesh = self._get_mesh()
        if mesh is None:
            return None
        from ..errors import TiDBError
        from ..utils import tracing as _tracing
        t_mpp = time.perf_counter()
        with _tracing.span("mpp_dispatch", table=dag.table_info.name,
                           rows=n):
            try:
                res = device_guard.guarded_dispatch(
                    lambda: self._try_execute_mpp(dag, tbl, arrays, valid,
                                                  n, handles, mesh,
                                                  read_ts),
                    site="copr/mpp", ectx=ectx,
                    domain=getattr(self, "domain", None),
                    host_fallback=(lambda: None) if self.degrade_to_host
                    else None, fallback_is_host=False)
            except TiDBError:
                raise                   # kill/quota: statement error
            except Exception:           # noqa: BLE001
                if not self.degrade_to_host:
                    raise               # the card: the statement fails
                res = None
            if res is None:
                _tracing.tag(degraded=1)
        if res is not None:
            _metrics.MPP_DISPATCH_SECONDS.observe(
                time.perf_counter() - t_mpp)
        return res

    def _try_execute_mpp(self, dag, tbl, arrays, valid, n, handles, mesh,
                         read_ts=None):
        """MPP fragment path: rows sharded across the mesh, the dense
        partial-agg body per shard, merged with psum (the hash exchange
        collapsed into an allreduce over the dense key domain). Returns
        None when ineligible.

        Every input — column data AND the MVCC validity mask — rides the
        sharded residency store, so a repeated statement over an
        unchanged table uploads zero bytes to the mesh."""
        cols = self._bind_cols(dag, tbl, arrays, slice(0, n), handles)
        kd, sd = capture_agg_dicts(dag, cols)
        strides = _dense_strides(dag, kd, cols, n)
        if strides is None:
            return None
        if _segment_impl(self.device) == "runs" and \
                _dense_nslots(strides) > _BCR_MAX:
            # no scatter into a big dense domain while the lowering is
            # runs: the single-device runs path takes it
            return None
        ndev = mesh.size
        lane = 128 * ndev
        # bucketed lane-multiple padding: the padded capacity — and with
        # it the program shape and the buffer keys — survives appends
        # within a bucket, so a write stream tail-patches the sharded
        # buffers instead of re-keying them every `lane` rows
        padded = ((shape_bucket(n) + lane - 1) // lane) * lane
        local = padded // ndev
        names = sorted(cols.keys())
        # cache by STORAGE column id, never plan column idx
        cid_of_idx = {sc.col.idx: self._cid(dag, sc) for sc in dag.cols}
        from .delta import append_key
        jc = {}
        has_nulls = {}
        epoch = tbl.gc_epoch
        # keys carry the placement (the mesh's devices, so ndev too): a
        # mesh entry never aliases a single-device or another mesh's one
        mk = mesh.fingerprint()
        for k in names:
            data, nulls, _sdict = cols[k]
            cid = cid_of_idx.get(k, -1)
            kind = "h" if cid == -1 else "d"
            jd = self._dev_put_append(
                append_key(tbl.uid, "mppcol", cid, kind, epoch, (mk,),
                           padded),
                data, n, padded, tbl.uid, tbl.version, epoch, 0, None,
                mesh=mesh, spec="sharded")
            jn = None
            has_nulls[k] = nulls is not None
            if nulls is not None:
                jn = self._dev_put_append(
                    append_key(tbl.uid, "mppcol", cid, "n", epoch, (mk,),
                               padded),
                    nulls, n, padded, tbl.uid, tbl.version, epoch, 0,
                    None, pad_fill=True, mesh=mesh, spec="sharded")
            jc[k] = (jd, jn)
        # the MVCC validity mask is (version, read_ts)-immutable: it
        # stays resident too
        vv = self._dev_put(
            (tbl.uid, "mppvalid", tbl.version, read_ts, mk, padded),
            valid[:n], pad_fill=False, uid=tbl.uid, version=tbl.version,
            mesh=mesh, spec="sharded")
        sdicts = {k: c[2] for k, c in cols.items()}
        kern = self._fragment(
            dag, tbl, "mpp", padded,
            (tuple(strides), mk,
             tuple(sorted(has_nulls.items()))),
            lambda: _build_dense_agg_kernel_mpp(dag, sdicts, local,
                                                strides, mesh))
        res = run_fragment(kern, jc, vv)
        from ..mpp.exec import exchange_observed, tree_nbytes
        exchange_observed("passthrough", tree_nbytes(res))
        return [_compact_dense(dag, res, strides, kd, sd)]

    def _cache_key(self, dag, tbl, kind, cap, extra=()):
        dict_vers = tuple(sorted(
            (cid, len(d.values)) for cid, d in tbl.dicts.items()))
        fps = tuple(f.fingerprint() for f in dag.filters)
        gfps = tuple(g.fingerprint() for g in dag.group_items)
        afps = tuple(a.fingerprint() for a in dag.aggs)
        colsig = tuple(sorted((sc.col.idx, sc.name) for sc in dag.cols))
        return (kind, tbl.uid, cap, fps, gfps, afps, dict_vers, colsig,
                extra)


class PartialAggResult:
    """Per-partition aggregation partials: group keys (encoded: dict codes /
    int64) + per-agg state arrays (sum/count/min/max). key_dicts/state_dicts
    carry StringDicts for string-typed keys/args (codes are comparable
    across partitions because dict transforms are deterministic over the
    shared table dictionary)."""

    __slots__ = ("ngroups", "keys", "key_nulls", "states", "key_dicts",
                 "state_dicts")

    def __init__(self, ngroups, keys, key_nulls, states, key_dicts=None,
                 state_dicts=None):
        self.ngroups = ngroups
        self.keys = keys
        self.key_nulls = key_nulls
        self.states = states
        self.key_dicts = key_dicts or [None] * len(keys)
        self.state_dicts = state_dicts or [None] * len(states)


def _psum_first(lvs, lcs, mesh):
    """Exact cross-shard first_row merge: the value of the FIRST shard
    (in mesh order) that has rows in each slot."""
    from ..parallel.mesh import to_coordinator
    lvs = to_coordinator(list(lvs), mesh)
    lcs = to_coordinator(list(lcs), mesh)
    acc = torch.zeros_like(lvs[0])
    for lv, lc in zip(reversed(lvs), reversed(lcs)):
        acc = torch.where(lc > 0, lv, acc)
    return acc


def psum_dense_result(results, aggs, mesh):
    """Merge the shards' dense_agg_states outputs with one collective
    per state array (the MPP hash exchange collapsed into psum): sums
    and counts psum, min / max pmin / pmax (a shard's empty slot holds
    the identity), first_row the first shard's value."""
    from ..parallel.mesh import psum, pmax, pmin
    out = []
    for ai, a in enumerate(aggs):
        sts = [r["states"][ai] for r in results]
        cnt = psum([st[-1] for st in sts], mesh)
        if a.name == "count":
            out.append([cnt])
        elif a.name in ("sum", "avg"):
            out.append([psum([st[0] for st in sts], mesh), cnt])
        elif a.name == "min":
            out.append([pmin([st[0] for st in sts], mesh), cnt])
        elif a.name == "max":
            out.append([pmax([st[0] for st in sts], mesh), cnt])
        elif a.name == "first_row":
            out.append([_psum_first([st[0] for st in sts],
                                    [st[1] for st in sts], mesh), cnt])
        else:
            raise NotImplementedError(a.name)
    return {"present": psum([r["present"] for r in results], mesh),
            "states": out}


def _build_dense_agg_kernel_mpp(dag, sdicts, local_cap, sizes, mesh):
    """The dense partial-agg fragment as one mesh program: each shard
    aggregates its rows into the dense table (dense_agg_body, whose one-
    and <= 64-slot layouts launch masked_sums and dense_group_sums), one
    psum merges — the MPP hash exchange as an allreduce."""
    from ..parallel.mesh import shard_map
    groups, aggs = list(dag.group_items), list(dag.aggs)

    def body_for(dev):
        return _reader_fragment(
            dag.filters, sdicts, local_cap, TorchNS(dev),
            lambda ctx, mask: dense_agg_body(ctx, mask, groups, aggs,
                                             sizes, local_cap))
    return shard_map(mesh, body_for,
                     lambda outs: psum_dense_result(outs, aggs, mesh))


def run_fragment(kern, *args):
    """Enqueue one fragment call on the device: the seam around the
    fragment alone (not its uploads nor its fetch) that every reader-DAG
    and fused fragment goes through, which chip_smoke.py runs under
    torch.cuda.set_sync_debug_mode("error") to show that no fragment
    waits on the card."""
    # tpulint: disable=unguarded-dispatch — the seam itself: every
    # caller enqueues it inside guarded_dispatch (or a guard wrapper)
    return kern(*args)


def _device_dtype_ok(dtype) -> bool:
    """Does a storage dtype have a device form (not object)? uint64
    rides as its int64 bit patterns."""
    try:
        torch_dtype(dtype)
    except TypeError:
        return False
    return True


def _dag_decline(dag, arrays, cid_of):
    """Why the DAG's fragment cannot run on the device (a torch_ns.
    Decline), or None when it can: every expression it evaluates there
    passes the device rule (torch_ns.device_form, with the NULL masks
    the columns are bound with), and every column it binds has a device
    dtype."""
    exprs = [sc.col for sc in dag.cols] + list(dag.filters) + \
        list(dag.group_items)
    for a in dag.aggs:
        exprs.extend(a.args)
    if dag.topn is not None:
        exprs.append(dag.topn[0][0])
    masked = set()
    for sc in dag.cols:
        ent = arrays.get(cid_of(dag, sc))
        if ent is not None and ent[1] is not None:
            masked.add(sc.col.idx)
    for e in exprs:
        decline = device_form(e, masked.__contains__)
        if decline is not None:
            return decline
    for data, _nulls, _sd in arrays.values():
        if not _device_dtype_ok(data.dtype):
            return Decline("unsafe", f"no device dtype: {data.dtype}")
    return None


def _reader_fragment(filters, sdicts, cap, xp, tail):
    """A reader-DAG fragment (the reference's _filter_body, _topn_body
    and _build_*agg_kernel): the validity mask ANDed with each filter's
    mask over the partition's columns, then tail(ctx, mask), which
    returns the fragment's result: the mask itself, a top-n or the
    partial aggregation."""
    filters = list(filters)

    def body(jc, vv):
        full = {k: (d, nl, sdicts[k]) for k, (d, nl) in jc.items()}
        ctx = EvalCtx(xp, cap, full, host=False)
        mask = vv
        for f in filters:
            mask = mask & eval_bool_mask(ctx, f)
        return tail(ctx, mask)
    return body


def _topn_keys_np(d, nm, desc):
    """-> (sort key, rank) for a top-n over values `d` with NULL mask
    `nm`: ascending order of (rank, key) is the top-n order. The key is
    the value ascending, its bitwise complement (ints: never overflows,
    unlike a negation of INT64_MIN) or negation (floats) descending,
    0 for NULLs; rank 0 is the side NULLs do not take (NULL sorts
    lowest: first ascending, last descending)."""
    if d.dtype.kind == "f":
        skey = -d if desc else d.copy()
        skey = np.where(nm, 0.0, skey)
    else:
        d = d.astype(np.int64)
        skey = np.where(nm, 0, ~d if desc else d)
    rank = nm.astype(np.int8) if desc else (~nm).astype(np.int8)
    return skey, rank


def _smallest_k_stable(s, k):
    """Indexes of the k smallest of `s` in ascending order, ties by
    the lowest index: a partition to the k-th value, then the rows below
    it and the first of those equal to it."""
    if k >= len(s):
        return np.argsort(s, kind="stable")
    kth = np.partition(s, k - 1)[k - 1]
    below = np.nonzero(s < kth)[0]
    sel = np.concatenate([below, np.nonzero(s == kth)[0][:k - len(below)]])
    sel.sort()
    return sel[np.argsort(s[sel], kind="stable")]


def topn_body(ctx, mask, expr, desc, k, cap):
    """Top-k of the rows under `mask` by `expr` over an eval ctx (the
    torch body of the reference's _topn_body): dictionary codes ranked
    by their strings, NULLs first ascending and last descending, ties by
    the lowest row index (torch.topk promises no tie order, so the
    order is three stable sorts: key, NULL rank, mask). -> (the first
    min(k, cap) row indexes in that order, min(rows under mask, k))."""
    dev = mask.device
    d, nl, sd = eval_expr(ctx, expr)
    if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
        d = ctx.xp.full(cap, d)
    nm = materialize_nulls(ctx, nl)
    if not isinstance(nm, torch.Tensor) or nm.ndim == 0:
        nm = torch.full((cap,), bool(nm), dtype=torch.bool, device=dev)
    if sd is not None:
        ranks = _vec._dict_cached(ctx, sd, ("ranks",), lambda: (
            ctx.xp.asarray(np.asarray(sd.ranks(), dtype=np.int64)),
            8 * len(sd.values)))
        d = ranks[d.to(INT64)]
    if d.dtype.is_floating_point:
        skey = torch.where(nm, 0.0, -d if desc else d)
    else:
        d = d.to(INT64)
        skey = torch.where(nm, 0, torch.bitwise_not(d) if desc else d)
    rank = nm if desc else ~nm
    order = torch.sort(skey, stable=True).indices
    order = order[torch.sort(rank[order].to(torch.int8),
                             stable=True).indices]
    order = order[torch.sort((~mask[order]).to(torch.int8),
                             stable=True).indices]
    cnt = torch.clamp(mask.sum(dtype=INT64), max=k)
    return order[:min(k, cap)], cnt


def learn_sort_kind(host_cache, gbkey, implk, impl, bucket, ngroups, rows):
    """What a sort-kind aggregation learns from a partition's group
    count, shared by the fused and reader-DAG fragments: a runs lowering
    over more than max(_RUNS_DEGRADE_MIN, rows / 4) partials meets keys
    storage order does not cluster, and pins the query shape to sorted;
    more groups than the bucket it ran with regrow the bucket, which
    never shrinks. -> "runs_degrade" or "bucket_regrow" when the
    partition must run again, else None."""
    if impl == "runs" and ngroups > max(_RUNS_DEGRADE_MIN, rows // 4):
        host_cache[implk] = "sorted"
        return "runs_degrade"
    if ngroups > bucket:
        host_cache[gbkey] = max(host_cache.get(gbkey, 0),
                                shape_bucket(ngroups))
        return "bucket_regrow"
    return None


def capture_agg_dicts(dag, cols):
    """Evaluate group items / agg args over a 1-row host ctx to learn which
    produce dict-coded outputs (and with which dictionary)."""
    one = {}
    for k, (data, nulls, sdict) in cols.items():
        d1 = data[:1] if len(data) else np.zeros(1, dtype=data.dtype)
        n1 = None if nulls is None else nulls[:1]
        one[k] = (d1, n1, sdict)
    ctx = EvalCtx(np, 1, one, host=True)
    key_dicts = []
    for g in dag.group_items:
        try:
            _, _, sd = eval_expr(ctx, g)
        except Exception:
            sd = None
        key_dicts.append(sd)
    state_dicts = []
    for a in dag.aggs:
        sd = None
        if a.args:
            try:
                _, _, sd = eval_expr(ctx, a.args[0])
            except Exception:
                sd = None
        state_dicts.append(sd)
    return key_dicts, state_dicts


_DENSE_MAX = 1 << 18


def _dense_strides(dag, key_dicts, cols=None, n=0):
    """-> per-key (size, offset) when the combined group domain is small:
    dictionary codes (offset 0, size = |dict|+1) or integer keys whose
    runtime min/max span fits (offset = min). slot 0 per key = NULL. A
    global aggregation is the degenerate dense case (empty layout)."""
    if not dag.group_items:
        return []
    if len(key_dicts) != len(dag.group_items):
        return None
    layout = []
    total = 1
    pending = []            # indexes needing a min/max host pass
    for i, d in enumerate(key_dicts):
        if d is None:
            pending.append(i)
            layout.append(None)
            continue
        size = len(d.values) + 1
        layout.append((size, 0))
        total *= size
        if total > _DENSE_MAX:
            return None
    if pending:
        if cols is None or n == 0:
            return None
        ctx = EvalCtx(np, n, cols, host=True)
        for i in pending:
            g = dag.group_items[i]
            try:
                data, nulls, sd = eval_expr(ctx, g)
            except Exception:
                return None
            if sd is not None or np.isscalar(data):
                return None
            data = np.asarray(data)
            if data.dtype.kind not in "iu" or len(data) == 0:
                return None
            nm = np.asarray(materialize_nulls(ctx, nulls))
            live = data[~nm] if nm.any() else data
            if len(live) == 0:
                lo, hi = 0, 0
            else:
                lo, hi = int(live.min()), int(live.max())
            size = hi - lo + 2
            if size <= 0:
                return None
            layout[i] = (size, lo)
            total *= size
            if total > _DENSE_MAX:
                return None
    return layout


def _dense_nslots(sizes):
    """Slots of a dense layout: the product of its per-key sizes."""
    n = 1
    for s, _off in sizes:
        n *= s
    return n


def dense_agg_body(ctx, mask, group_items, aggs, sizes, cap):
    """Dense partial agg over an eval ctx + row mask: slot = mixed radix
    of the group codes (slot 0 per key = NULL), then per-slot states.
    Shared by the copr reader and the fused pipeline fragment."""
    dev = ctx.xp.device
    nslots = _dense_nslots(sizes)
    slot = torch.zeros(cap, dtype=INT64, device=dev)
    for g, (size, off) in zip(group_items, sizes):
        d, nl, _ = eval_expr(ctx, g)
        if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
            d = ctx.xp.full(cap, d)
        nm = materialize_nulls(ctx, nl)
        code = torch.clamp(torch.where(nm, 0, d.to(INT64) - off + 1),
                           0, size - 1)
        slot = slot * size + code
    slot = torch.where(mask, slot, nslots)    # invalid rows -> spill slot
    return dense_agg_states(ctx, mask, aggs, slot, nslots, cap)


def dense_agg_states(ctx, mask, aggs, slot, nslots, cap):
    """Partial-agg states into a precomputed dense slot table (slot ==
    nslots means masked-out). Routes by shape: one slot -> masked
    reductions, tiny domains -> per-slot sums, larger -> scatter."""
    if nslots == 1:
        return _dense_agg_states_reduce(ctx, mask, aggs, cap)
    if nslots <= scan_kernels.MAX_SLOTS:
        return _dense_agg_states_bcr(ctx, mask, aggs, slot, nslots, cap)
    return _dense_agg_states_scatter(ctx, mask, aggs, slot, nslots, cap)


def _dense_agg_states_scatter(ctx, mask, aggs, slot, nslots, cap):
    """Segment ops as torch scatters (index_add_ / scatter_reduce_): the
    twin of the reference's CPU lowering (jax.ops.segment_*)."""
    dev = ctx.xp.device

    def seg_sum(v):
        out = torch.zeros(nslots + 1, dtype=v.dtype, device=dev)
        return out.index_add_(0, slot, v)[:nslots]

    def seg_red(v, how, init):
        out = torch.full((nslots + 1,), init, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, slot, v, how,
                                   include_self=True)[:nslots]

    states = []
    for a in aggs:
        d, row_ok = _agg_eval_rows(ctx, a, mask, cap)
        cnt = seg_sum(row_ok.to(INT64))
        if a.name == "count":
            states.append([cnt])
        elif a.name in ("sum", "avg"):
            z = torch.zeros((), dtype=d.dtype, device=dev)
            states.append([seg_sum(torch.where(row_ok, d, z)), cnt])
        elif a.name in ("min", "max"):
            sent = _minmax_sentinel(a.name, d.dtype)
            s = seg_red(torch.where(row_ok, d, sent),
                        "amin" if a.name == "min" else "amax", sent)
            states.append([s, cnt])
        elif a.name == "first_row":
            iota = torch.arange(cap, dtype=INT64, device=dev)
            fi = seg_red(torch.where(row_ok, iota, cap - 1), "amin",
                         cap - 1)
            states.append([d[fi], cnt])
        else:
            raise NotImplementedError(a.name)
    return {"present": seg_sum(mask.to(INT64)), "states": states}


def _minmax_sentinel(name, dtype):
    """-> the identity a min/max agg's masked-out rows take, as a Python
    scalar (torch.where, torch.full and scatter_reduce_ take it as a
    kernel argument: building a device tensor from it would be a
    blocking copy), shared by every lowering so they cannot diverge."""
    is_f = dtype.is_floating_point
    if name == "min":
        return float("inf") if is_f else int(_I64_MAX)
    return float("-inf") if is_f else -int(_I64_MAX)


def _agg_eval_rows(ctx, a, mask, cap):
    """-> (d, row_ok) for one agg over the eval ctx (count(*) -> ones)."""
    if a.args:
        d, nl, _ = eval_expr(ctx, a.args[0])
        if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
            d = ctx.xp.full(cap, d)
        if d.dtype == torch.bool:
            # SUM(a = b) counts: a scatter-add in bool would OR
            d = d.to(INT64)
        nm = materialize_nulls(ctx, nl)
        return d, mask & ~nm
    return torch.ones(cap, dtype=INT64, device=ctx.xp.device), mask


def kernel_aggs_fit(aggs):
    """The part of the scan kernels' shape rule that the plan decides:
    every aggregate is sum/avg/count, with at most scan_kernels.MAX_COLS
    sum/avg arguments."""
    if any(a.name not in ("sum", "avg", "count") for a in aggs):
        return False
    return sum(1 for a in aggs if a.name != "count" and a.args) <= \
        scan_kernels.MAX_COLS


def _int64_arg(d, nl, cap):
    """`d` as a contiguous int64 [cap] tensor when it is one and has no
    null mask, else None."""
    if not (nl is None or nl is False) or \
            not isinstance(d, torch.Tensor) or d.dtype != INT64 or \
            d.ndim != 1 or d.shape[0] != cap:
        return None
    return d.contiguous()


def _kernel_args(ctx, aggs, cap):
    """The scan kernels' shape rule: kernel_aggs_fit, and every argument
    evaluates to an int64 [cap] tensor with no null mask. -> the
    evaluated sum/avg argument tensors (a count needs none: with no null
    mask it is the row count), or None for any other shape."""
    terms = _kernel_terms(ctx, aggs, cap, [None] * len(aggs))
    return None if terms is None else terms[0]


_FOLD_CLASSES = (TypeClass.INT, TypeClass.DECIMAL)


def product_operands(expr):
    """The fold rule's shape part, for one aggregate argument: the plan
    column indexes (i, j) when `expr` is a `*` of two bare int or decimal
    Columns that the evaluator multiplies as the plain int64 product of
    their storage (expression/vec.py mul_is_plain_int64: no rescale),
    else None."""
    if not isinstance(expr, ScalarFunc) or expr.op != "*" or \
            len(expr.args) != 2 or expr.ft is None:
        return None
    a, b = expr.args
    for c in (a, b):
        if not isinstance(c, ExprColumn) or c.ft is None or \
                c.ft.tclass not in _FOLD_CLASSES:
            return None
    if not mul_is_plain_int64(expr):
        return None
    return a.idx, b.idx


def fold_pairs(aggs):
    """Per aggregate, the operand columns its sum/avg argument folds into
    range_filter_sums as a product pair (product_operands), else None.
    Decided from the plan when the fragment is built."""
    return [product_operands(a.args[0])
            if a.name in ("sum", "avg") and a.args else None for a in aggs]


def _kernel_terms(ctx, aggs, cap, folds):
    """_kernel_args with the fold: a sum/avg argument with fold pair
    (i, j) (fold_pairs) passes columns i and j as a product pair when
    both are int64 [cap] tensors without a null mask; every other
    argument is evaluated as _kernel_args says. -> (cols, pairs, order):
    the evaluated columns, the pairs, and for each sum/avg its row in the
    kernel's [cols..., pairs...] sums; None for any other shape."""
    if not kernel_aggs_fit(aggs):
        return None
    cols, pairs, where = [], [], []
    for a, fold in zip(aggs, folds):
        if not a.args:
            continue
        if fold is not None:
            pair = tuple(_int64_arg(*ctx.cols[i][:2], cap) for i in fold)
            if None not in pair:
                where.append((True, len(pairs)))
                pairs.append(pair)
                continue
        d, nl, _ = eval_expr(ctx, a.args[0])
        d = _int64_arg(d, nl, cap)
        if d is None:
            return None
        if a.name != "count":
            where.append((False, len(cols)))
            cols.append(d)
    order = [len(cols) + j if is_pair else j for is_pair, j in where]
    return cols, pairs, order


def _kernel_states(aggs, sums, counts):
    """Kernel outputs -> the states layout (count -> [cnt]; sum/avg ->
    [s, cnt]); with no null masks every agg's count is the row count."""
    states = []
    j = 0
    for a in aggs:
        if a.name == "count":
            states.append([counts])
        else:
            states.append([sums[j], counts])
            j += 1
    return states


def _dense_agg_states_reduce(ctx, mask, aggs, cap):
    """Global aggregation (nslots == 1) as masked reductions: through
    the masked_sums kernel when the shape fits (_kernel_args), else the
    plain torch twin of the reference."""
    cols = _kernel_args(ctx, aggs, cap)
    if cols is not None:
        # tpulint: disable=unguarded-dispatch — runs inside a fragment
        # body (dense_agg_states), which its run_fragment caller guards
        sums, count = scan_kernels.masked_sums(cols, mask)
        count = count[None]
        return {"present": count,
                "states": _kernel_states(aggs, sums[:, None], count)}
    return _reduce_plain(ctx, mask, aggs, cap)


def _reduce_plain(ctx, mask, aggs, cap):
    """Global aggregation as plain torch masked reductions (the
    reference's twin), for aggregates the kernels do not take."""
    dev = ctx.xp.device
    states = []
    for a in aggs:
        d, ok = _agg_eval_rows(ctx, a, mask, cap)
        cnt = ok.sum(dtype=INT64)[None]
        if a.name == "count":
            states.append([cnt])
        elif a.name in ("sum", "avg"):
            z = torch.zeros((), dtype=d.dtype, device=dev)
            states.append([torch.where(ok, d, z).sum()[None], cnt])
        elif a.name in ("min", "max"):
            sent = _minmax_sentinel(a.name, d.dtype)
            red = torch.amin if a.name == "min" else torch.amax
            states.append([red(torch.where(ok, d, sent))[None], cnt])
        elif a.name == "first_row":
            fpos = torch.argmax(ok.to(torch.uint8))  # first True; 0 if none
            states.append([d[fpos][None], cnt])
        else:
            raise NotImplementedError(a.name)
    return {"present": mask.sum(dtype=INT64)[None], "states": states}


def dense_agg_states_range(ctx, valid, aggs, ranges, cap, folds):
    """Global aggregation (nslots == 1) under range filters through the
    range_filter_sums kernel: `ranges` is a copr/range_lowering
    RangeLowering over ctx's columns, `valid` the row mask with every
    other filter already ANDed in, `folds` fold_pairs(aggs): a product of
    two columns is summed in the kernel as a pair, without a product
    column. A predicate column's NULLs compare false, so its ~nulls join
    valid. The plan picked this route for aggregates that fit
    (kernel_aggs_fit); an argument that arrives with a null mask or
    another dtype sends the partition to the evaluator's compares and
    the plain reductions."""
    terms = _kernel_terms(ctx, aggs, cap, folds)
    if terms is None:
        for f in ranges.lowered:
            valid = valid & eval_bool_mask(ctx, f)
        return _reduce_plain(ctx, valid, aggs, cap)
    cols, pairs, order = terms
    preds = []
    for idx in ranges.cols:
        d, nl, _ = ctx.cols[idx]
        if isinstance(nl, torch.Tensor):
            valid = valid & ~nl
        preds.append(d.contiguous())
    # tpulint: disable=unguarded-dispatch — inside a fragment body, as
    # masked_sums above
    sums, count = scan_kernels.range_filter_sums(cols, preds, ranges.bounds,
                                                 valid, pairs)
    if order != list(range(len(order))):
        sums = sums[order]
    count = count[None]
    return {"present": count,
            "states": _kernel_states(aggs, sums[:, None], count)}


def _dense_agg_states_bcr(ctx, mask, aggs, slot, nslots, cap):
    """Tiny dense domains: per-slot sums through the dense_group_sums
    kernel when the shape fits (_kernel_args). Any other shape takes the
    scatter lowering, which gives the same states in O(cap); the
    reference's [nslots, cap] broadcast compare served a TPU without a
    fast scatter and is not kept."""
    cols = _kernel_args(ctx, aggs, cap)
    if cols is None:
        return _dense_agg_states_scatter(ctx, mask, aggs, slot, nslots, cap)
    # tpulint: disable=unguarded-dispatch — inside a fragment body, as
    # masked_sums above
    sums, counts = scan_kernels.dense_group_sums(cols, slot, nslots, mask)
    return {"present": counts,
            "states": _kernel_states(aggs, sums, counts)}


def _compact_dense(dag, res, sizes, key_dicts, state_dicts):
    """Compact the dense slot table (host side; <= _DENSE_MAX slots)."""
    res = prefetch(res)
    present = host_array(res["present"])
    slots = np.nonzero(present > 0)[0]
    ngroups = len(slots)
    keys = []
    key_nulls = []
    rem = slots.copy()
    for size, off in reversed(sizes):
        code = rem % size
        rem = rem // size
        keys.append(np.where(code == 0, 0, code - 1 + off).astype(np.int64))
        key_nulls.append(code == 0)
    keys.reverse()
    key_nulls.reverse()
    states = [[host_array(s)[slots] for s in st] for st in res["states"]]
    return PartialAggResult(ngroups=ngroups, keys=keys, key_nulls=key_nulls,
                            states=states, key_dicts=key_dicts,
                            state_dicts=state_dicts)


# ---- general group-by: sort / runs lowerings ------------------------

_FORCE_SEGMENT_IMPL = None  # tests: "scatter" | "sorted" | "runs" | None

# dense and posdense domains above this many slots leave the dense
# lowering on the card (the scan kernels take at most this many slots:
# scan_kernels.MAX_SLOTS) and take the sort kind, lowered as runs
_BCR_MAX = 64

# a runs lowering that yields more partials than this, and more than a
# quarter of the partition's rows, meets a group key that storage order
# does not cluster: its query shape is pinned to the sorted lowering
_RUNS_DEGRADE_MIN = 65536

# rows outside every segment (masked out, a NULL argument, a group past
# the bucket) scatter into this many spread spill slots: one slot would
# serialize their atomics
_SPILL = 4096


def _segment_impl(device):
    """How a general group-by lowers on `device`: "runs" on the card
    (contiguous equal-key runs become partial groups: cumsums and
    searchsorted gathers, no sort), "scatter" on the CPU (a sort, then
    scatters by group: the oracle the others are tested against), or
    what _FORCE_SEGMENT_IMPL names. The reference makes the same split
    by backend (its TPU runs, its CPU scatters)."""
    impl = _FORCE_SEGMENT_IMPL
    if impl:
        if impl not in ("scatter", "sorted", "runs"):
            raise ValueError(f"segment impl {impl!r}: expected one of "
                             "scatter|sorted|runs")
        return impl
    return "runs" if torch.device(device).type == "cuda" else "scatter"


def _seg_index(ordinal, ok, nseg):
    """Scatter index of each row: its segment ordinal where `ok` and
    below nseg, else one of _SPILL spill slots past nseg, spread by row."""
    iota = torch.arange(ordinal.shape[0], dtype=INT64,
                        device=ordinal.device)
    return torch.where(ok & (ordinal < nseg), ordinal,
                       nseg + (iota & (_SPILL - 1)))


def _seg_sum(index, vals, nseg):
    """Per-segment sums of `vals` at `index` (_seg_index) -> [nseg]."""
    out = torch.zeros(nseg + _SPILL, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, index, vals)[:nseg]


def _seg_reduce(index, vals, nseg, how, init):
    """Per-segment "amin"/"amax" of `vals` at `index` from `init`."""
    out = torch.full((nseg + _SPILL,), init, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, index, vals, how,
                               include_self=True)[:nseg]


def _span_diff(vals, starts, ends):
    """sum(vals[starts[j]:ends[j] + 1]) for each j, as the difference of
    two prefix sums: exact for int64 (wrapping adds cancel)."""
    if vals.dtype == torch.bool:
        vals = vals.to(INT64)
    cs = torch.cumsum(vals, 0)
    return cs[ends] - (cs - vals)[starts]


def _group_keys(ctx, group_items, cap):
    """-> (int64 keys with NULLs as 0, NULL masks, has-a-null-mask flags)
    of the group items over the eval ctx."""
    keys, key_nulls, nullable = [], [], []
    for g in group_items:
        d, nl, _sd = eval_expr(ctx, g)
        if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
            d = ctx.xp.full(cap, d)
        nm = materialize_nulls(ctx, nl)
        keys.append(torch.where(nm, 0, d.to(INT64)))
        key_nulls.append(nm)
        nullable.append(nl is not None and nl is not False)
    return keys, key_nulls, nullable


def _no_groups(ctx, mask, aggs, cap):
    """A group-by without group items: one group, masked reductions."""
    r = _dense_agg_states_reduce(ctx, mask, aggs, cap)
    return {"ngroups": torch.ones((), dtype=INT64, device=mask.device),
            "keys": [], "key_nulls": [], "states": r["states"]}


def _runs_agg_core(keys, key_nulls, mask, ctx, aggs, cap, bucket):
    """Contiguous-run partial aggregation (reference _runs_agg_core):
    every maximal run of equal group keys becomes one partial group,
    found with cumsums, cummax and left-sided searchsorted gathers; no
    sort, no host read. Runs wholly masked out are dropped, so ngroups
    counts the runs with a visible row; the first `bucket` of them come
    back in storage order. int64 sums and counts are prefix-sum
    differences (exact); float sums and min/max scatter by run ordinal.
    Unclustered keys stay correct (one key may yield several partials,
    which the host merge combines) but approach one run per row."""
    dev = mask.device
    idx = torch.arange(cap, dtype=INT64, device=dev)
    neq = torch.zeros(cap - 1, dtype=torch.bool, device=dev)
    for k, kn in zip(keys, key_nulls):
        neq = neq | (k[1:] != k[:-1]) | (kn[1:] != kn[:-1])
    change = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    cs_change = torch.cumsum(change.to(INT64), 0)          # run ordinal
    run_start = torch.cummax(torch.where(change, idx, -1), 0).values
    mi = mask.to(INT64)
    mask_cs = torch.cumsum(mi, 0)
    vstart = mask & (mask_cs == (mask_cs - mi)[run_start] + 1)
    vcs = torch.cumsum(vstart.to(INT64), 0)
    ngroups = vcs[cap - 1]
    want = torch.arange(1, bucket + 1, dtype=INT64, device=dev)
    posc = torch.clamp(torch.searchsorted(vcs, want), max=cap - 1)
    rs = run_start[posc]                                   # run start
    rid = cs_change[posc]
    re = torch.clamp(torch.searchsorted(cs_change, rid + 1), max=cap) - 1
    ordinal = cs_change - 1
    states = []
    for a in aggs:
        d, ok = _agg_eval_rows(ctx, a, mask, cap)
        oki = ok.to(INT64)
        cnt = _span_diff(oki, rs, re)
        if a.name == "count":
            states.append([cnt])
        elif a.name in ("sum", "avg"):
            v0 = torch.where(ok, d, torch.zeros((), dtype=d.dtype,
                                                device=dev))
            if d.dtype.is_floating_point:
                s = _seg_sum(_seg_index(ordinal, ok, cap), v0, cap)[rid - 1]
                s = torch.where(cnt > 0, s, 0.0)
            else:
                s = _span_diff(v0, rs, re)
            states.append([s, cnt])
        elif a.name in ("min", "max"):
            sent = _minmax_sentinel(a.name, d.dtype)
            s = _seg_reduce(_seg_index(ordinal, ok, cap), d, cap,
                            "amin" if a.name == "min" else "amax",
                            sent)[rid - 1]
            states.append([torch.where(cnt > 0, s, sent), cnt])
        elif a.name == "first_row":
            ok_cs = torch.cumsum(oki, 0)
            ford = (ok_cs - oki)[rs] + 1
            fpos = torch.clamp(torch.searchsorted(ok_cs, ford), max=cap - 1)
            states.append([d[fpos], cnt])
        else:
            raise NotImplementedError(a.name)
    return {"ngroups": ngroups, "keys": [k[posc] for k in keys],
            "key_nulls": [kn[posc] for kn in key_nulls], "states": states}


def runs_agg_body(ctx, mask, group_items, aggs, cap, group_bucket):
    """sort_agg_body's card lowering without the sort: the group keys
    are evaluated and contiguous equal-key runs become partial groups
    (_runs_agg_core). Same output contract as sort_agg_body, except that
    groups come in first-occurrence order and an unclustered key yields
    several partials for the merge to combine."""
    if not group_items:
        return _no_groups(ctx, mask, aggs, cap)
    keys, key_nulls, _ = _group_keys(ctx, group_items, cap)
    return _runs_agg_core(keys, key_nulls, mask, ctx, aggs, cap,
                          group_bucket)


def _multisort_order(keys, key_nulls, nullable, mask, cap):
    """Chained stable sorts (the reference's multisort branch): rows
    ordered by (masked out, then per key: NULL flag, value); a key
    without a null mask skips its flag's sort, which would move only the
    masked-out rows that the last sort moves anyway. -> (order, change:
    the key changes between neighbours in that order)."""
    dev = mask.device

    def sort_by(order, arr):
        return order[torch.sort(arr[order], stable=True).indices]
    skeys = [torch.where(mask, k, _I64_MAX) for k in keys]
    sflags = [torch.where(mask, kn.to(INT64), 2) if nb else None
              for kn, nb in zip(key_nulls, nullable)]
    order = torch.arange(cap, dtype=INT64, device=dev)
    for sk, sf in zip(reversed(skeys), reversed(sflags)):
        order = sort_by(order, sk)
        if sf is not None:
            order = sort_by(order, sf)
    order = sort_by(order, (~mask).to(INT64))
    neq = torch.zeros(cap - 1, dtype=torch.bool, device=dev)
    for arr in skeys + [f for f in sflags if f is not None]:
        s = arr[order]
        neq = neq | (s[1:] != s[:-1])
    change = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), neq])
    return order, change


def sort_agg_body(ctx, mask, group_items, aggs, cap, group_bucket,
                  impl=None):
    """Sort-based partial aggregation over an eval ctx + row mask (the
    general group domain; reference sort_agg_body), shared by the fused
    pipeline and the tests. -> {"ngroups", "keys", "key_nulls",
    "states"}: the first `group_bucket` groups' keys and states, and the
    group count (the caller regrows the bucket and reruns when it is
    larger).

    `impl` (default _segment_impl) "runs" takes runs_agg_body. Otherwise
    the rows are ordered by chained stable sorts (_multisort_order) in
    every case: the reference's single packed-key sort is chosen by a
    device value, a branch eager torch could take only after a host
    read; the group order differs from the packed order only in where
    NULL keys sort, which the host merge does not see. Then "scatter"
    reduces every state by scatter into the group ordinal, and "sorted"
    takes int64 sums and counts as prefix-sum differences over the
    sorted rows and scatters only float sums, min/max and first_row."""
    impl = impl or _segment_impl(ctx.xp.device)
    if impl == "runs":
        return runs_agg_body(ctx, mask, group_items, aggs, cap,
                             group_bucket)
    if not group_items:
        return _no_groups(ctx, mask, aggs, cap)
    dev = mask.device
    keys, key_nulls, nullable = _group_keys(ctx, group_items, cap)
    order, change = _multisort_order(keys, key_nulls, nullable, mask, cap)
    sorted_mask = mask[order]
    cs = torch.cumsum((change & sorted_mask).to(INT64), 0)
    ngroups = cs[cap - 1]
    gb = group_bucket
    first = torch.clamp(torch.searchsorted(
        cs, torch.arange(1, gb + 1, dtype=INT64, device=dev)), max=cap - 1)
    last = torch.clamp(torch.searchsorted(
        cs, torch.arange(2, gb + 2, dtype=INT64, device=dev)), max=cap) - 1
    ordinal = cs - 1
    iota = torch.arange(cap, dtype=INT64, device=dev)
    out_keys = [k[order][first] for k in keys]
    out_key_nulls = [kn[order][first] for kn in key_nulls]
    states = []
    for a in aggs:
        d, row_ok = _agg_eval_rows(ctx, a, mask, cap)
        dv, ok = d[order], row_ok[order]
        index = _seg_index(ordinal, ok, gb)
        oki = ok.to(INT64)
        if impl == "sorted":
            cnt = _span_diff(oki, first, last)
        else:
            cnt = _seg_sum(index, oki, gb)
        if a.name == "count":
            states.append([cnt])
        elif a.name in ("sum", "avg"):
            v0 = torch.where(ok, dv, torch.zeros((), dtype=dv.dtype,
                                                 device=dev))
            if impl == "sorted" and not dv.dtype.is_floating_point:
                s = _span_diff(v0, first, last)
            else:
                s = _seg_sum(index, v0, gb)
            states.append([s, cnt])
        elif a.name in ("min", "max"):
            states.append([_seg_reduce(
                index, dv, gb, "amin" if a.name == "min" else "amax",
                _minmax_sentinel(a.name, dv.dtype)), cnt])
        elif a.name == "first_row":
            fi = _seg_reduce(index, iota, gb, "amin", cap - 1)
            states.append([dv[fi], cnt])
        else:
            raise NotImplementedError(a.name)
    return {"ngroups": ngroups, "keys": out_keys,
            "key_nulls": out_key_nulls, "states": states}


# ---- one-hot slot aggregation (small learned group domains) ---------

# the learned slot table holds at most this many groups
_ONEHOT_MAX = 32768
# rows of the accumulator's copies: a table of scap slots is kept in
# max(1, _ONEHOT_SPREAD // scap) copies (at most _ONEHOT_COPIES), each
# row adding into copy (row index mod copies), so a few hot slots do
# not serialize every row's atomic add on one address
_ONEHOT_SPREAD = 1 << 14
_ONEHOT_COPIES = 64


def onehot_agg_layout(aggs):
    """-> the state columns of the one-hot accumulator, in order: (agg
    index, state index) per column — count -> its count; sum/avg -> the
    sum, then the count — and a trailing (-1, -1) row count per slot,
    which drives the zero-slot drop. Only count/sum/avg lay out: the
    pipeline checks eligibility before it learns a table."""
    specs = []
    for ai, a in enumerate(aggs):
        if a.name == "count":
            specs.append((ai, 0))
        elif a.name in ("sum", "avg"):
            specs.extend([(ai, 0), (ai, 1)])
        else:
            raise NotImplementedError(f"onehot lowering over {a.name}")
    specs.append((-1, -1))
    return specs


def onehot_agg_body(ctx, mask, group_items, aggs, cap, scap, sargs):
    """Segment aggregation into a host-learned slot table (the
    reference's onehot_agg_body) instead of a sort or a runs pass.

    sargs (the slot table, resident on the device):
      skeys  (scap,) int64  sorted packed keys, padded with INT64_MAX
      los    (K,)    int64  per group item: pack offset
      spans  (K,)    int64  per group item: pack span (NULL code 0 in it)
      nslots (1,)    int64  live slots
    Each row's group codes pack into one int64 with the table's offsets
    and spans; a code outside its span, or a packed key not in the
    table, is a miss (counted in res["miss"]: the caller reruns the
    partition with the sort kind and relearns, so a stale table never
    shapes a result). A live row's states add into its slot.

    The reference gets int64 states as 7-bit limbs of an int8 one-hot
    matmul accumulated in int32 (its TPU's MXU form), recombined mod
    2^64 on the host. Here each state is one int64 column added by
    index_add_ into [scap, L]: integer adds wrap mod 2^64 in any order,
    so the states equal the reference's decode bit for bit, with no
    per-block loop and no limb split. Dead rows add into _SPILL spread
    spill rows, and a small table is kept in several copies summed at
    the end (_ONEHOT_SPREAD). -> {"oh_acc": int64 [scap, L] in
    onehot_agg_layout's columns, "miss": int64 [], "ngroups": nslots}."""
    dev = mask.device
    packed = torch.zeros(cap, dtype=INT64, device=dev)
    okr = torch.ones(cap, dtype=torch.bool, device=dev)
    for i, g in enumerate(group_items):
        d, nl, _ = eval_expr(ctx, g)
        if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
            d = ctx.xp.full(cap, d)
        nm = materialize_nulls(ctx, nl)
        span = sargs["spans"][i]
        code = torch.where(nm, 0, d.to(INT64) - sargs["los"][i] + 1)
        # an out-of-span code would alias another packed tuple: a miss
        okr = okr & (code >= 0) & (code < span)
        packed = packed * span + torch.minimum(torch.clamp(code, min=0),
                                               span - 1)
    sk = sargs["skeys"]
    locc = torch.clamp(torch.searchsorted(sk, packed), max=scap - 1)
    hit = (sk[locc] == packed) & okr & (locc < sargs["nslots"][0])
    miss = (mask & ~hit).sum(dtype=INT64)
    live = mask & hit
    cols = []
    for a in aggs:
        if a.name not in ("count", "sum", "avg"):
            raise NotImplementedError(f"onehot lowering over {a.name}")
        d, ok = _agg_eval_rows(ctx, a, mask, cap)
        ok = ok & live
        if a.name != "count":
            cols.append(torch.where(ok, d.to(INT64), 0))
        cols.append(ok.to(INT64))
    cols.append(live.to(INT64))
    copies = max(1, min(_ONEHOT_COPIES, _ONEHOT_SPREAD // scap))
    iota = torch.arange(cap, dtype=INT64, device=dev)
    index = torch.where(live, (iota & (copies - 1)) * scap + locc,
                        copies * scap + (iota & (_SPILL - 1)))
    acc = torch.zeros((copies * scap + _SPILL, len(cols)), dtype=INT64,
                      device=dev)
    acc.index_add_(0, index, torch.stack(cols, 1))
    acc = acc[:copies * scap].view(copies, scap, len(cols)).sum(0)
    return {"oh_acc": acc, "miss": miss, "ngroups": sargs["nslots"][0]}


def onehot_decode_states(acc, aggs, nslots):
    """Host side: the one-hot accumulator (a host int64 [scap, L] array)
    -> (states, row count per slot), the first nslots slots; the states
    in _segscan_states' layout (count -> [cnt]; sum/avg -> [s, cnt])."""
    states = [[None] * (2 if a.name in ("sum", "avg") else 1) for a in aggs]
    rowcnt = None
    for j, (ai, sj) in enumerate(onehot_agg_layout(aggs)):
        col = np.ascontiguousarray(acc[:nslots, j])
        if ai < 0:
            rowcnt = col
        else:
            states[ai][sj] = col
    return states, rowcnt


def sorted_run_starts(kvecs, min_rows=1024):
    """Pre-sorted single-key fast path shared by the host partial agg
    and the partial MERGE (executors.HashAggExec): when the one key
    vector is already non-decreasing, group boundaries are run
    boundaries — no argsort / np.unique. -> (starts, change) or
    (None, None). Callers pick their own null sentinel BEFORE calling
    (the two sites differ) and derive inverse/firsts as needed."""
    if len(kvecs) != 1 or len(kvecs[0]) <= min_rows or \
            not bool(np.all(kvecs[0][:-1] <= kvecs[0][1:])):
        return None, None
    kv = kvecs[0]
    change = np.empty(len(kv), dtype=bool)
    change[0] = True
    np.not_equal(kv[1:], kv[:-1], out=change[1:])
    return np.nonzero(change)[0], change

def _host_partial_agg(ctx, dag, valid, shared_dicts=None):
    """numpy fallback with identical output layout.

    shared_dicts: when the caller aggregates chunk-by-chunk, pass ONE
    dict ({group_idx: StringDict}) for the whole loop — raw-string keys
    must encode through a dict shared across chunks or the int64 codes
    are not comparable when the partials merge."""
    mask = valid
    xp = np
    keys = []
    key_nulls = []
    key_dict_override = {}
    for gi, g in enumerate(dag.group_items):
        d, nl, sd = eval_expr(ctx, g)
        if np.isscalar(d):
            d = np.full(ctx.n, d)
        d = np.asarray(d)
        nm = np.asarray(materialize_nulls(ctx, nl))
        if d.dtype == object and sd is None:
            # raw strings (e.g. null-padded columns from a left join
            # fallback): encode into a dict so keys stay int64
            from ..chunk.device import StringDict
            if shared_dicts is not None:
                sd2 = shared_dicts.setdefault(gi, StringDict())
            else:
                sd2 = StringDict()
            d = np.array([0 if m else sd2.encode_one(str(v))
                          for v, m in zip(d, nm)], dtype=np.int64)
            key_dict_override[gi] = sd2
        d = d.astype(np.int64)
        keys.append(np.where(nm, 0, d))
        key_nulls.append(nm)
    idx = np.nonzero(mask)[0]
    starts = None       # run starts when keys arrive pre-sorted
    if keys:
        # a NULL key sorts by its flag, not by a sentinel value that a
        # real key can hold (the reference's -1 merged NULL with -1)
        kvecs = []
        for k, kn in zip(keys, key_nulls):
            kvecs.append(k[idx])
            if kn[idx].any():
                kvecs.append(kn[idx].astype(np.int64))
        starts, _change = sorted_run_starts(kvecs)
        if starts is not None:
            # pre-sorted single key (clustered-PK order, e.g. GROUP BY
            # l_orderkey over lineitem): group boundaries are run
            # boundaries — no argsort, and the agg loop below uses
            # exact dtype-preserving ufunc.reduceat instead of the
            # unbuffered (slow) ufunc.at scatters
            ngroups = len(starts)
            firsts = idx[starts]
        else:
            kmat = np.stack(kvecs, axis=1)
            uniq, inverse = np.unique(kmat, axis=0, return_inverse=True)
            ngroups = len(uniq)
            firsts = np.full(ngroups, np.iinfo(np.int64).max,
                             dtype=np.int64)
            np.minimum.at(firsts, inverse, idx)
        out_keys = [k[firsts] for k in keys]
        out_key_nulls = [kn[firsts] for kn in key_nulls]
    else:
        ngroups = 1
        inverse = np.zeros(len(idx), dtype=np.int64)
        out_keys = []
        out_key_nulls = []
    states = []
    for a in dag.aggs:
        if a.args:
            d, nl, _ = eval_expr(ctx, a.args[0])
            if np.isscalar(d):
                d = np.full(ctx.n, d)
            nm = np.asarray(materialize_nulls(ctx, nl))
            dv = np.asarray(d)[idx]
            if dv.dtype == bool:
                # SUM(a = b) counts (an add of bools would OR), as on the
                # device
                dv = dv.astype(np.int64)
            ok = ~nm[idx]
        else:
            dv = np.ones(len(idx), dtype=np.int64)
            ok = np.ones(len(idx), dtype=bool)
        if starts is not None:
            cnt = np.add.reduceat(ok.astype(np.int64), starts)
        else:
            cnt = np.zeros(ngroups, dtype=np.int64)
            np.add.at(cnt, inverse, ok.astype(np.int64))
        if a.name == "count":
            states.append([cnt])
        elif a.name in ("sum", "avg"):
            if starts is not None:
                s = np.add.reduceat(np.where(ok, dv, 0), starts)
            else:
                s = np.zeros(ngroups, dtype=dv.dtype)
                np.add.at(s, inverse, np.where(ok, dv, 0))
            states.append([s, cnt])
        elif a.name == "first_row":
            if starts is not None:
                pos = np.where(ok, np.arange(len(idx)),
                               np.iinfo(np.int64).max)
                fp = np.minimum.reduceat(pos, starts)
                fi = idx[np.minimum(fp, max(len(idx) - 1, 0))]
                fi = np.where(fp == np.iinfo(np.int64).max,
                              max(ctx.n - 1, 0), fi)
            else:
                fi = np.full(ngroups, np.iinfo(np.int64).max,
                             dtype=np.int64)
                np.minimum.at(fi, inverse[ok], idx[ok])
                fi = np.minimum(fi, max(ctx.n - 1, 0))
            states.append([np.asarray(d)[fi], cnt])
        elif a.name == "min":
            big = np.inf if dv.dtype.kind == "f" else _I64_MAX
            if starts is not None:
                s = np.minimum.reduceat(
                    np.where(ok, dv, np.asarray(big, dtype=dv.dtype)),
                    starts)
            else:
                s = np.full(ngroups, big, dtype=dv.dtype)
                np.minimum.at(s, inverse, np.where(ok, dv, big))
            states.append([s, cnt])
        elif a.name == "max":
            small = -np.inf if dv.dtype.kind == "f" else -_I64_MAX
            if starts is not None:
                s = np.maximum.reduceat(
                    np.where(ok, dv, np.asarray(small, dtype=dv.dtype)),
                    starts)
            else:
                s = np.full(ngroups, small, dtype=dv.dtype)
                np.maximum.at(s, inverse, np.where(ok, dv, small))
            states.append([s, cnt])
        else:
            raise NotImplementedError(a.name)
    kd, sd = capture_agg_dicts(dag, ctx.cols)
    for gi, sd2 in key_dict_override.items():
        kd[gi] = sd2
    return PartialAggResult(ngroups=ngroups, keys=out_keys,
                            key_nulls=out_key_nulls, states=states,
                            key_dicts=kd, state_dicts=sd)
