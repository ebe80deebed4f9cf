"""Domain: per-process singleton binding storage + schema + engines
(reference pkg/domain/domain.go:556)."""
from __future__ import annotations


from ..storage import Storage
from ..storage.columnar import ColumnarEngine
from ..infoschema import InfoSchemaCache
from ..copr import CoprExecutor
from ..dxf import TaskManager
from ..dxf.framework import Timer
from ..utils.memory import Tracker
from ..utils import metrics as metrics_util
from ..utils import lockrank


class _Allocator:
    """Per-table id allocator (reference pkg/meta/autoid). In-memory;
    rebased from data on first use."""

    def __init__(self, start=0):
        self._next = start + 1
        self._mu = lockrank.ranked_lock("domain.alloc")

    def next(self) -> int:
        with self._mu:
            v = self._next
            self._next += 1
            return v

    next_handle = next

    def rebase(self, v: int):
        with self._mu:
            if v >= self._next:
                self._next = v + 1


class GlobalMemoryController:
    """tidb_server_memory_limit analog (reference
    pkg/util/memory/memstats + the server-level OOM kill in
    session/session.go): watches the global tracker root and, when the
    whole process exceeds ``tidb_tpu_server_memory_limit``, cancels the
    single LARGEST-consumer live statement through the existing KILL
    seam (_live_execs) with ER 8175 — shed one query, never wedge or
    die. One victim at a time: the next breach picks a new one only
    after the current victim's tracker detached (its statement
    actually died and released)."""

    def __init__(self, domain):
        self.domain = domain
        self._mu = lockrank.ranked_lock("domain.memctl")
        self._victim_tracker = None

    def limit_bytes(self) -> int:
        v = self.domain.global_vars.get("tidb_tpu_server_memory_limit")
        if v is None:
            from .sysvars import get_sysvar
            v = get_sysvar("tidb_tpu_server_memory_limit").default
        try:
            return int(v)
        except (TypeError, ValueError):
            return 0

    def on_breach(self, root):
        """Called by the tracker root (outside its tree lock) when
        consumption crossed the server limit."""
        with self._mu:
            lim = self.limit_bytes()
            if not lim or root.consumed <= lim:
                return
            vt = self._victim_tracker
            if vt is not None and not vt.closed:
                return          # current victim still unwinding
            self._victim_tracker = None
            best = None
            best_ectx = None
            for _cid, lst in list(self.domain._live_execs.items()):
                for ectx in list(lst):
                    tr = getattr(ectx, "mem_tracker", None)
                    if tr is None or tr.closed:
                        continue
                    if getattr(ectx, "mem_killed", None):
                        return  # a marked victim is already dying
                    if best is None or tr.consumed > best.consumed:
                        best, best_ectx = tr, ectx
            if best is None:
                return          # nothing cancellable is live
            msg = ("Out Of Memory Quota! server memory limit %d bytes "
                   "exceeded (global tracker at %d); this statement "
                   "was the largest consumer (%d bytes) and was "
                   "cancelled (tidb_tpu_server_memory_limit)" % (
                       lim, root.consumed, best.consumed))
            best_ectx.mem_killed = msg
            best_ectx.killed = True
            best.mark_server_kill(msg)
            self._victim_tracker = best
        metrics_util.MEM_PRESSURE.labels("server_cancel").inc()
        self.domain.inc_metric("server_memory_cancel")
        from ..utils.logutil import warn
        warn("server_memory_cancel", limit=lim,
             consumed=root.consumed, victim=best.label,
             victim_bytes=best.consumed)


class Domain:
    def __init__(self, data_dir: str | None = None,
                 wal_sync: bool = False, device=None, mesh=None):
        import time as _time
        self._start_time = _time.time()
        self.data_dir = data_dir
        # fsync every commit frame (power-loss durability; default off —
        # the single-node trade is process-crash durability)
        self.wal_sync = wal_sync
        self.storage = Storage()
        self.is_cache = InfoSchemaCache(self.storage)
        self.columnar = ColumnarEngine(self.storage, self._table_info_by_id)
        from ..utils.torchcfg import resolve_device
        self.device = resolve_device(device)
        # mesh: the MPP mesh (parallel.Mesh, or an int: that many shards
        # on `device`); None is every visible CUDA device
        self.copr = CoprExecutor(self.columnar, device=self.device,
                                 mesh=mesh)
        self.copr.domain = self   # virtual-table reads need domain state
        self._allocators: dict[int, _Allocator] = {}
        self.global_vars: dict[str, object] = {}
        self.user_vars: dict[str, object] = {}
        self.mem_root = Tracker("global")
        # server-level memory governance: every consume that reaches
        # the root checks the soft limit; breach -> the controller
        # cancels the largest live statement (ER 8175). Wired before
        # any session exists so the very first statement is governed.
        self.mem_controller = GlobalMemoryController(self)
        self.mem_root.soft_limit_fn = self.mem_controller.limit_bytes
        self.mem_root.on_soft_breach = self.mem_controller.on_breach
        self.dxf = TaskManager(total_slots=8)
        self.timer = Timer()
        self.stats = {}        # table_id -> stats (module stats/, ANALYZE)
        self.slow_log: list = []
        self.stmt_summary_map: dict = {}
        # flat counter dict, kept as the per-store compat view; the
        # typed/labeled registry is utils/metrics.REGISTRY and every
        # inc_metric mirrors into it (see inc_metric below)
        self.metrics: dict = {}
        # per-digest device-time attribution ring fed by Session._observe
        # (information_schema.tidb_top_sql)
        self.top_sql = metrics_util.TopSQL()
        # per-digest estimate-vs-actual + routing feedback folded at
        # statement end (information_schema.tidb_plan_feedback); the
        # planner-side consumer is ROADMAP #1
        from ..executor.plan_feedback import PlanFeedback
        self.plan_feedback = PlanFeedback()
        metrics_util.track_domain(self)
        # why the most recent query declined / fell off the fused device
        # pipeline (None = fused OK); read by EXPLAIN ANALYZE and
        # scripts/diag_routing.py (reference: pkg/util/execdetails)
        self.last_fused_reason: str | None = None
        from ..utils.tracing import FlightRecorder, Tracer
        self.flight_recorder = FlightRecorder()
        self.tracer = Tracer(self.flight_recorder)
        from ..privilege import PrivManager
        self.priv = PrivManager(self)
        self._live_execs: dict = {}       # conn_id -> [ExecContext]
        self.sessions: dict = {}          # conn_id -> weakref(Session)
        # LOCK TABLES registry: (db, table) -> (mode, conn_id)
        # (reference pkg/ddl table locks, gated by enable-table-lock)
        self.table_locks: dict = {}
        self.table_locks_mu = lockrank.ranked_lock("domain.table_locks")
        from ..utils import LRUCache
        # (sql, db, ver, flags) -> PhysPlan; O(1) LRU (the residency
        # idiom) — the old list-order sidecar scanned on every insert
        self.plan_cache = LRUCache(256)
        # digest-shape -> point-op fast-path template (session/fastpath:
        # PK point/batch-point lookups served without the planner).
        # Keys embed schema_epoch + binding versions, so stale entries
        # age out through the LRU after invalidation.
        self.point_plans = LRUCache(512)
        # cheap plan-validity fence for the fast path: bumped by the
        # commit hook below on every meta-namespace commit (DDL), by
        # invalidate_plan_cache (bulk loads), and by checkpoint/restore
        # paths — reading an int attr per point op instead of a
        # meta-KV schema-version probe (~17us) keeps the hot path hot
        self.schema_epoch = 0
        # backup run records (tidb_tpu/br/snapshot.py) — the in-memory
        # half of information_schema.tidb_backup_jobs (restore jobs are
        # durable DDLJob rows and come from the job queue instead)
        self._br_runs: list = []
        from ..bindinfo import BindHandle
        self.bind_handle = BindHandle()   # GLOBAL plan baselines
        from .resource_group import ResourceGroupManager
        self.resource_groups = ResourceGroupManager()
        from ..plugin import PluginManager
        self.plugins = PluginManager()
        from ..dxf.framework import DurableTasks
        self.durable_tasks = DurableTasks(self)
        # sql -> parsed stmt list. Bounded LRU: ad-hoc SQL churn (every
        # bench/ORM statement is unique text) used to grow the old dict
        # without limit between 512-clears on ONE call path while
        # _parse_one_cached inserted uncapped on another
        self.ast_cache = LRUCache(512)
        self.digest_cache = LRUCache(1024)  # sql -> (normalized, digest)
        # fast-path schema fence: any commit touching the meta
        # namespace (DDL: schema version, table defs) invalidates
        # point templates by epoch bump — runs on the committing
        # thread inside _publish, so the DDL session itself can never
        # race its own next statement. The bump is locked: hooks run
        # OUTSIDE the store mutex, and an unsynchronized += from two
        # concurrent DDL commits could collapse two bumps into one,
        # leaving a template built between them validly keyed
        from ..codec.tablecodec import META_PREFIX as _MPREF
        self._epoch_mu = lockrank.ranked_lock("domain.epoch")

        # replica DDL barrier: the commit_ts of the latest meta-touching
        # commit. A replica may serve only once its applied watermark
        # covers it (watermark >= barrier implies the feed already
        # emitted — and the sink schema-synced — that DDL, since events
        # <= r emit before flush_resolved(r))
        self.ddl_barrier_ts = 0

        def _meta_epoch_hook(commit_ts, mutations):
            for k, _v in mutations:
                if k[:1] == _MPREF:
                    with self._epoch_mu:
                        self.schema_epoch += 1
                        if commit_ts > self.ddl_barrier_ts:
                            self.ddl_barrier_ts = commit_ts
                    return
        self.storage.mvcc.commit_hooks.append(_meta_epoch_hook)
        self._syncload_attempted: set = set()
        if data_dir:
            from ..utils import logutil
            logutil.set_sink_dir(data_dir)
            logutil.info("store_open", data_dir=data_dir)
            self._open_wal(data_dir)
        # change data capture (tidb_tpu/cdc): changefeed registry +
        # commit-stream capture; persisted feeds resume from their
        # checkpoint-ts once the WAL/checkpoint replay above has the
        # store consistent
        from ..cdc import ChangefeedManager
        self.cdc = ChangefeedManager(self)
        # vector search runtime (tidb_tpu/vector/): VECTOR(k) column
        # residency + IVF index registry; subscribes to the capture
        # seam lazily when the first vector index appears
        from ..vector import VectorRuntime
        self.vector = VectorRuntime(self)
        # in-SQL model inference (tidb_tpu/ml/): epoch-fenced model
        # registry + device-resident weights + forward kernels.
        # Attached BEFORE the DDL runner so a restart-resumed CREATE
        # MODEL job publishes into a live registry
        from ..ml import MLRuntime
        self.ml = MLRuntime(self)
        # incremental HTAP (copr/delta.py): the delta maintainer is
        # the capture seam's second consumer — per-table freshness
        # bookkeeping behind information_schema.tidb_replica_freshness
        # and the resolved-ts read view for analytic statements
        self.copr.delta.attach(self)
        # durable online-DDL job runner (owner/ddl_runner.py): the
        # queue lives in the meta namespace, so after checkpoint+WAL
        # replay in-flight schema changes resume forward (from the
        # recorded ladder state / backfill checkpoint) or roll back to
        # clean absence, orphaned non-PUBLIC index states are swept,
        # and leftover delete-ranges are purged — BEFORE any session
        # can observe a half-state index
        from ..owner.ddl_runner import DDLJobRunner
        self.ddl_jobs = DDLJobRunner(self)
        # elastic read-replica fabric (tidb_tpu/replica): supervised
        # CDC-fed mirror domains + the session router's pick() seam.
        # Created BEFORE resume_persisted so a persisted __replica_*
        # feed can rebuild its replica through make_sink("replica://N")
        from ..replica import ReplicaManager
        self.replicas = ReplicaManager(self)
        if data_dir:
            self.cdc.resume_persisted()
            self.replicas.resume()
            self.ddl_jobs.resume_pending()

    def close(self):
        """Graceful shutdown: drain the replica fabric FIRST (its
        monitor must stop reprovisioning and every feed must apply
        what the capture seam already published), then stop the
        remaining changefeed workers. Idempotent; no worker thread
        survives it and no acked-but-unapplied batch is left behind."""
        self.replicas.shutdown()
        self.cdc.shutdown()

    def _open_wal(self, data_dir):
        """Restore the latest checkpoint (if any), replay the WAL tail,
        then attach the writer (durability for the row/meta engines; bulk
        columnar loads persist via BR). Recovery cost is bounded by
        checkpointing (ADMIN CHECKPOINT / auto): snapshot + truncated
        WAL, the reference's RocksDB-snapshot + raft-log-GC shape."""
        import os
        from ..storage.wal import WalWriter, replay, decode_checkpoint
        # columnar effects buffer until segments load: a replayed DELETE
        # of an imported row must see the segment's handle
        self.columnar._replay_buffer = []
        ckpt = os.path.join(data_dir, "checkpoint.snap")
        if os.path.exists(ckpt):
            with open(ckpt, "rb") as f:
                ckpt_ts, triples = decode_checkpoint(f.read())
            # the snapshot header ts was ALLOCATED before the snapshot
            # was cut: the oracle must advance past it too, not just
            # past the replayed versions, or the first post-recovery
            # commit could reuse a pre-crash timestamp
            self.storage.oracle.fast_forward(ckpt_ts)
            # re-apply versions in commit order so the engine hooks
            # rebuild columnar/schema state exactly like a WAL replay
            triples.sort(key=lambda t: t[0])
            i = 0
            while i < len(triples):
                ts = triples[i][0]
                muts = []
                while i < len(triples) and triples[i][0] == ts:
                    muts.append((triples[i][1], triples[i][2]))
                    i += 1
                self.storage.oracle.fast_forward(ts)
                self.storage.mvcc.apply_replay(ts, muts)
        # LSM runs: flushed WAL segments between checkpoints (storage/sst)
        from ..storage import sst
        for rp in sst.run_files(data_dir):
            by_ts: dict = {}
            for ts, k, v, _wall in sst.read_run(rp):
                by_ts.setdefault(ts, []).append((k, v))
            for ts in sorted(by_ts):
                self.storage.oracle.fast_forward(ts)
                self.storage.mvcc.apply_replay(ts, by_ts[ts])
        path = os.path.join(data_dir, "commit.wal")
        for commit_ts, mutations, _wall in replay(path):
            # keep the oracle ahead of replayed commits so the engine hooks
            # (schema cache reads) see them
            self.storage.oracle.fast_forward(commit_ts)
            self.storage.mvcc.apply_replay(commit_ts, mutations)
        self.is_cache._cached = None     # reload schema from replayed meta
        self.storage.mvcc.wal = WalWriter(
            path, sync=self.wal_sync,
            group_commit=self._wal_group_commit())
        self._load_bulk_segments()
        buf = self.columnar._replay_buffer
        self.columnar._replay_buffer = None
        for ts, muts in buf:
            self.columnar.apply_commit(ts, muts)
        # store-format migrations: a FORMAT marker records which on-disk
        # encodings this store has been upgraded to. Format 2 = _ci
        # index keys hold the collation normal form; older stores (or
        # markerless pre-format stores with data) reindex once here.
        fmt_path = os.path.join(data_dir, "FORMAT")
        have_data = os.path.exists(path) or os.path.exists(ckpt)
        fmt = None
        if os.path.exists(fmt_path):
            with open(fmt_path) as f:
                fmt = f.read().strip()
        if fmt != "2" and have_data:
            self._migrate_ci_index_keys()
        with open(fmt_path, "w") as f:
            f.write("2")

    def _migrate_ci_index_keys(self):
        """One-time reindex for stores written before collation-aware
        index keys: every index entry over a _ci string column moves
        from the raw value encoding to the ci+PAD normal form, so the
        folding read paths (PointGet/IndexRange/FK/unique checks) keep
        finding pre-existing rows (reference: collate.Key change shipped
        with the new-collation framework's reindex requirement)."""
        from ..codec.tablecodec import (index_prefix, decode_index_key,
                                        index_key)
        from ..executor.table_rt import fold_ci_datums
        from ..expression.vec import _is_ci
        from ..types.field_type import TypeClass
        mvcc = self.storage.mvcc
        read_ts = self.storage.current_ts()
        muts = []
        isch = self.infoschema()
        for db in isch.all_schemas():
            if db.name.lower() in ("mysql", "information_schema"):
                continue
            for tbl in isch.tables_in_schema(db.name):
                for idx in tbl.indexes:
                    cols = [tbl.find_column(c) for c in idx.columns]
                    if not any(c is not None and
                               c.ft.tclass == TypeClass.STRING and
                               _is_ci(c.ft) for c in cols):
                        continue
                    pref = index_prefix(tbl.id, idx.id)
                    for k, v in mvcc.scan(pref, pref + b"\xff" * 9,
                                          read_ts):
                        try:
                            _t, _i, datums, rest = decode_index_key(
                                k, len(idx.columns))
                        except Exception:       # noqa: BLE001
                            continue
                        nk = index_key(tbl.id, idx.id,
                                       fold_ci_datums(tbl, idx, datums))
                        nk += rest
                        if nk != k:
                            muts.append((k, None))
                            muts.append((nk, v))
        if muts:
            # apply AND log: the reindex must survive the next restart —
            # apply_replay skips the WAL, so append the frame explicitly
            # (the writer is attached before migrations run)
            ts = self.storage.oracle.get_ts()
            if mvcc.wal is not None:
                mvcc.wal.append(ts, muts)
            mvcc.apply_replay(ts, muts)

    def _wal_group_commit(self):
        """Group-commit setting for a NEW WalWriter: the GLOBAL sysvar
        when an operator has SET it, else None (writer falls back to
        the TIDB_TPU_WAL_GROUP_COMMIT env default). Read at every
        writer construction — open, flush_wal, checkpoint — so SET
        GLOBAL takes effect at the next writer swap, as the sysvar
        comment promises."""
        v = self.global_vars.get("tidb_tpu_wal_group_commit")
        return None if v is None else bool(v)

    def flush_wal(self) -> int:
        """LSM flush: rewrite the WAL as one sorted immutable run and
        truncate it (reference: memtable flush to L0; the C++ memtable
        itself stays in memory — the run IS its durable image). Compacts
        when runs accumulate. Returns entries flushed."""
        import time as _time
        from ..storage import sst
        from ..storage.wal import replay, WalWriter
        mvcc = self.storage.mvcc
        n = 0
        t0 = _time.perf_counter()
        with mvcc._mu:
            w = mvcc.wal
            if w is None or not self.data_dir:
                return 0
            w._f.flush()
            triples = []
            for ts, muts, wall in replay(w.path):
                triples.extend((ts, k, v, wall) for k, v in muts)
            if not triples:
                return 0
            n = sst.write_run(sst.next_run_path(self.data_dir), triples)
            w.close()
            open(w.path, "wb").close()
            mvcc.wal = WalWriter(w.path, sync=self.wal_sync,
                                 group_commit=self._wal_group_commit())
            self.inc_metric("lsm_flushes")
            metrics_util.LSM_FLUSH_SECONDS.observe(
                _time.perf_counter() - t0)
            if len(sst.run_files(self.data_dir)) > 4:
                safepoint = getattr(self, "gc_safepoint", 0)
                sst.compact(self.data_dir, safepoint)
                self.inc_metric("lsm_compactions")
                metrics_util.LSM_COMPACTIONS.inc()
        return n

    # ---- bulk columnar segments (lightning-loaded data has no row KV;
    # its durability is segment files, reference: TiFlash stable layer) --
    def persist_bulk_segment(self, table_info, ctab, start, n):
        if not self.data_dir or n <= 0:
            return
        import json
        import os
        import time as _time
        import numpy as np
        segdir = os.path.join(self.data_dir, "segments")
        os.makedirs(segdir, exist_ok=True)
        # wall micros + per-domain counter: two imports in the same tick
        # (or a clock step) must not collide and clobber a segment
        self._seg_seq = getattr(self, "_seg_seq", 0) + 1
        seq = int(_time.time() * 1e6) * 1000 + self._seg_seq % 1000
        base = os.path.join(segdir, f"seg_{table_info.id}_{seq}")
        arrays = {"__handles": ctab.handles[start:start + n]}
        dicts = {}
        for ci in table_info.columns:
            arrays[f"d_{ci.id}"] = ctab.data[ci.id][start:start + n]
            arrays[f"n_{ci.id}"] = ctab.nulls[ci.id][start:start + n]
            if ci.id in ctab.dicts:
                dicts[str(ci.id)] = list(ctab.dicts[ci.id].values)
        # npz first, json LAST, both atomic+fsynced: the loader keys off
        # the .json, so a crash can never leave a loadable half-segment
        for suffix, writer in ((".npz", lambda f: np.savez_compressed(
                f, **arrays)),
                               (".json", lambda f: f.write(json.dumps(
                                   {"table_id": table_info.id, "n": n,
                                    "commit_ts": int(
                                        ctab.insert_ts[start]),
                                    "dicts": dicts}).encode()))):
            tmp = base + suffix + ".tmp"
            with open(tmp, "wb") as f:
                writer(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, base + suffix)

    def _load_bulk_segments(self):
        import json
        import os
        import re
        import numpy as np
        segdir = os.path.join(self.data_dir, "segments")
        if not os.path.isdir(segdir):
            return
        segs = []
        for name in os.listdir(segdir):
            m = re.fullmatch(r"seg_(\d+)_(\d+)\.json", name)
            if m:
                segs.append((int(m.group(2)), int(m.group(1)),
                             os.path.join(segdir, name)))
        for _seq, tid, meta_path in sorted(segs):
            info = self._table_info_by_id(tid)
            npz_path = meta_path[:-5] + ".npz"
            if info is None:           # dropped/truncated table: orphan
                for p in (meta_path, npz_path):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            z = np.load(npz_path, allow_pickle=False)
            ctab = self.columnar.table(info)
            columns = {}
            nulls = {}
            for ci in info.columns:
                key = f"d_{ci.id}"
                if key not in z:
                    continue       # column added by DDL after the import
                data = z[key]
                if str(ci.id) in meta["dicts"]:
                    data = ctab.dicts[ci.id].translate_codes(
                        meta["dicts"][str(ci.id)], data)
                columns[ci.name] = data
                nk = f"n_{ci.id}"
                if nk in z and z[nk].any():
                    nulls[ci.name] = z[nk]
            ctab.bulk_append(columns, int(meta["n"]),
                             handles=z["__handles"],
                             commit_ts=int(meta.get("commit_ts", 1)),
                             nulls=nulls or None)

    def invalidate_plan_cache(self):
        """Drop all cached plans (bulk loads change which access paths
        are valid for a table without bumping the schema version).
        Point fast-path templates go too: the epoch bump fences any
        in-flight lookup keyed on the old epoch."""
        self.plan_cache.clear()
        self.point_plans.clear()
        with self._epoch_mu:
            self.schema_epoch += 1

    def checkpoint(self) -> int:
        """Write a consistent snapshot of the MVCC store and truncate the
        WAL (commits pause for the duration; single-node trade, like a
        RocksDB checkpoint). Returns the checkpoint ts."""
        import os
        from ..storage.wal import encode_checkpoint
        if not self.data_dir:
            from ..errors import TiDBError
            raise TiDBError("checkpoint requires --data-dir")
        mvcc = self.storage.mvcc
        with mvcc._mu:
            ts = self.storage.current_ts()
            triples = []
            for k, vers in mvcc._kv.scan(b"", None):
                for vts, val in zip(vers.ts_list, vers.values):
                    triples.append((vts, k, val))
            tmp = os.path.join(self.data_dir, "checkpoint.tmp")
            with open(tmp, "wb") as f:
                f.write(encode_checkpoint(ts, triples))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.data_dir, "checkpoint.snap"))
            from ..storage import sst
            for rp in sst.run_files(self.data_dir):
                os.remove(rp)          # snapshot supersedes all runs
            if mvcc.wal is not None:
                mvcc.wal.close()
                wal_path = mvcc.wal.path
                open(wal_path, "wb").close()     # truncate: all frames
                from ..storage.wal import WalWriter  # are in the snapshot
                mvcc.wal = WalWriter(
                    wal_path, sync=self.wal_sync,
                    group_commit=self._wal_group_commit())
        self.inc_metric("checkpoints")
        return ts

    def maybe_checkpoint(self, wal_limit=32 << 20):
        """Auto-flush the WAL to an LSM run once it outgrows `wal_limit`
        (bounded recovery without the full-snapshot pause of ADMIN
        CHECKPOINT)."""
        import os
        w = self.storage.mvcc.wal
        if w is None:
            return
        try:
            if os.path.getsize(w.path) > wal_limit:
                self.flush_wal()
        except OSError:
            pass

    def seq_nextval(self, db_name: str, name: str) -> int:
        """Sequence allocation with cache chunks persisted via meta
        (reference pkg/meta sequence + docs/design/2020-04-17-sql-sequence)."""
        from ..meta import Mutator
        ischema = self.infoschema()
        tbl = ischema.table_by_name(db_name, name)
        if not tbl.sequence:
            from ..errors import TiDBError
            raise TiDBError("'%s' is not a SEQUENCE", name)
        cache = getattr(self, "_seq_cache", None)
        if cache is None:
            cache = self._seq_cache = {}
        cur = cache.get(tbl.id)
        if cur is None or cur[0] >= cur[1]:
            inc = tbl.sequence["increment"]
            chunk = tbl.sequence["cache"] * inc
            txn = self.storage.begin()
            try:
                m = Mutator(txn)
                db = next(d for d in m.list_databases()
                          if d.name.lower() == db_name.lower())
                t2 = m.get_table(db.id, tbl.id)
                start = t2.sequence["value"]
                t2.sequence["value"] = start + chunk
                m.update_table(db.id, t2)
                m.gen_schema_version()
                txn.commit()
            except BaseException:
                txn.rollback()
                raise
            cur = [start, start + chunk, inc]
            cache[tbl.id] = cur
        v = cur[0]
        cur[0] += cur[2]
        self._seq_last = getattr(self, "_seq_last", {})
        self._seq_last[tbl.id] = v
        return v

    def seq_lastval(self, db_name: str, name: str):
        tbl = self.infoschema().table_by_name(db_name, name)
        return getattr(self, "_seq_last", {}).get(tbl.id)

    def register_exec(self, conn_id, ectx):
        self._live_execs.setdefault(conn_id, []).append(ectx)

    def unregister_exec(self, conn_id, ectx):
        lst = self._live_execs.get(conn_id, [])
        if ectx in lst:
            lst.remove(ectx)

    def kill_conn(self, conn_id: int):
        """Cooperative query kill (reference pkg/util/sqlkiller): running
        executors observe the flag at their next pull."""
        for ectx in self._live_execs.get(conn_id, []):
            ectx.killed = True
        self.inc_metric("killed_queries")

    def start_background(self, ttl_interval=600.0, analyze_interval=300.0,
                         gc_interval=600.0):
        """Start background services (reference domain.Start: stats/ttl/gc
        loops). Off by default in embedded/test use; the server entrypoint
        calls this."""
        from ..ttl import start_ttl_worker
        start_ttl_worker(self, ttl_interval)
        self.timer.register("auto_analyze", analyze_interval,
                            self.auto_analyze_once)
        self.timer.register("gc", gc_interval, self.run_gc)
        self.timer.register("checkpoint", gc_interval,
                            self.maybe_checkpoint)
        try:
            self.durable_tasks.resume_all()
        except Exception:               # noqa: BLE001
            pass

    def auto_analyze_once(self, stale_ratio=0.5):
        """Re-ANALYZE tables whose row count drifted vs collected stats
        (reference handle/autoanalyze)."""
        from ..stats.analyze import analyze_tables
        from ..parser import ast
        from ..session import Session
        sess = Session(self)
        sess.is_internal = True
        ischema = self.infoschema()
        n = 0
        for db in ischema.all_schemas():
            if db.name.lower() in ("mysql", "information_schema"):
                continue
            for t in ischema.tables_in_schema(db.name):
                if t.view_select:
                    continue
                rows = self.table_rows(db.name, t)
                ts = self.stats.get(t.id)
                if ts is None or (rows and abs(rows - ts.row_count)
                                  / max(rows, 1) > stale_ratio):
                    sess.vars.current_db = db.name
                    analyze_tables(sess, [ast.TableName(name=t.name,
                                                        db=db.name)])
                    n += 1
        if n:
            self.inc_metric("auto_analyze_runs", n)
        return n

    def stats_or_syncload(self, table_id: int):
        """Planner stats accessor with SYNC LOAD (reference
        statistics/handle/syncload/stats_syncload.go:154 — a plan that
        needs missing stats loads them synchronously instead of planning
        blind): an un-analyzed table above a row floor gets a quick
        sampled ANALYZE inline, once."""
        ts = self.stats.get(table_id)
        if ts is not None:
            return ts
        if table_id in self._syncload_attempted or table_id < 0:
            return None
        info = self._table_info_by_id(table_id)
        ctab = self.columnar.tables.get(table_id)
        if info is None or ctab is None or ctab.live_count() < 2048:
            return None          # too small NOW — retry when it grows
        self._syncload_attempted.add(table_id)
        try:
            from ..stats.analyze import analyze_one
            ts = analyze_one(self, info)
            self.inc_metric("stats_syncload")
            return ts
        except Exception:               # noqa: BLE001
            return None

    def run_gc(self, safepoint=None) -> int:
        """MVCC GC across columnar tables (safepoint default: now).
        Also advances the LSM compaction safepoint: the next compaction
        drops row versions unreachable below it."""
        if safepoint is None:
            safepoint = self.storage.current_ts()
        self.gc_safepoint = safepoint
        total = 0
        for ctab in self.columnar.tables.values():
            total += ctab.gc(safepoint)
        # rollback tombstones / commit records for txns older than the
        # safepoint can never see a late commit attempt again
        self.storage.mvcc.gc_resolved(safepoint)
        self.inc_metric("gc_compacted_rows", total)
        return total

    def inc_metric(self, name: str, v=1):
        """Compat shim over the typed registry (utils/metrics): the flat
        per-store dict stays for existing readers (tests, chaos_smoke),
        and the same bump lands in the process registry as a sanitized
        unlabeled counter so /metrics exposes every legacy call site.
        New instrumentation should use registry instruments directly."""
        self.metrics[name] = self.metrics.get(name, 0) + v
        metrics_util.compat_counter(name).inc(v)

    def _table_info_by_id(self, tid: int):
        info = self.infoschema().table_by_id(tid)
        if info is not None:
            return info
        # partition pid -> physical clone of its logical table
        from ..storage.partition import partition_table_info
        ischema = self.infoschema()
        for db in ischema.all_schemas():
            for t in ischema.tables_in_schema(db.name):
                if t.partitions:
                    for p in t.partitions["parts"]:
                        if p["pid"] == tid:
                            return partition_table_info(t, tid)
        return None

    def infoschema(self):
        return self.is_cache.current()

    def _physical_ids(self, tbl):
        if tbl.partitions:
            return [p["pid"] for p in tbl.partitions["parts"]]
        return [tbl.id]

    def allocator(self, tbl) -> _Allocator:
        a = self._allocators.get(tbl.id)
        if a is None:
            start = 0
            for pid in self._physical_ids(tbl):
                ctab = self.columnar.tables.get(pid)
                if ctab is not None and ctab.n:
                    start = max(start, int(ctab.handles[:ctab.n].max()))
            if tbl.pk_is_handle:
                start = max(start, tbl.auto_inc_id)
            a = _Allocator(start)
            self._allocators[tbl.id] = a
        return a

    def mem_tracker_factory(self, quota):
        return self.mem_root.child("query", quota)

    def table_rows(self, db: str, tbl) -> float:
        total = 0
        for pid in self._physical_ids(tbl):
            ctab = self.columnar.tables.get(pid)
            if ctab is not None:
                total += ctab.live_count()
        if total == 0:
            return 10.0
        return float(total)
