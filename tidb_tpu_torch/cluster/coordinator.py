"""Cluster coordinator, ported from tidb_tpu's cluster/coordinator.py
(reference roles: tidb-server's distsql/MPP dispatch —
pkg/kv/mpp.go:183 DispatchMPPTasks — plus PD's TSO service consumed by
every node). The coordinator owns the schema, broadcasts DDL to workers,
shards bulk data, fans aggregation fragments out over the RPC seam, and
merges the returned partials with the same final-agg machinery the
single-process engine uses. Its own schema-and-plan Domain takes
`device=` as TestKit does: the card by default, "cpu" on a host."""
from __future__ import annotations

import os
import socket
import threading
import time
import uuid

import numpy as np

from .rpc import (send_msg, recv_msg, deserialize_partials,
                  ClusterTransportError)
from ..codec.tablecodec import meta_key
from ..errors import ClusterEpochStaleError
from ..utils import env_int
from ..utils import lockrank

_K_CLUSTER_EPOCH = meta_key(b"ClusterEpoch")


class _WorkerClient:
    """Supervised RPC client (docs/ROBUSTNESS.md "Cluster fault
    tolerance"; TiDB's store backoff + copr region retry).

    Every request is stamped with a (request_id, cluster_epoch) pair:
    the worker's dedup window answers a reply-lost retry from cache
    instead of re-executing, so EVERY op — including non-idempotent
    ones like load_sql, DDL ladder steps and dxf payloads — retries
    safely. Transport errors are classified through
    device_guard.classify (torn frames arrive as ClusterTransportError
    -> "transient"), retried with exponential backoff inside a
    per-call deadline, and counted against a per-worker circuit
    breaker that fails fast while open. Replies are correlated by
    request id, so a duplicated frame's extra reply can never shift
    the reply stream. Chaos: failpoint 'cluster/rpc' fires before
    every attempt; the cluster/net/* seams live inside
    send_msg/recv_msg."""

    def __init__(self, port, epoch_fn=None):
        self.port = port
        self.epoch_fn = epoch_fn       # () -> coordinator cluster epoch
        # one socket per worker: concurrent callers (dxf_run fans out
        # per-SUBTASK threads) must serialize send+recv or interleave
        # each other's frames
        self._call_mu = lockrank.ranked_lock("cluster.coordinator.call")
        self._rid_prefix = uuid.uuid4().hex[:12]
        self._rid_seq = 0
        from ..utils.device_guard import CircuitBreaker
        self.breaker = CircuitBreaker(
            threshold=env_int("TIDB_TPU_CLUSTER_BREAKER_THRESHOLD", 8),
            cooldown_s=float(os.environ.get(
                "TIDB_TPU_CLUSTER_BREAKER_COOLDOWN_S", "5")))
        self._connect()

    def _connect(self):
        self.sock = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=60)

    def _recv_reply(self, rid, op):
        """Read replies until one correlates to `rid`. A stale reply
        (the answer to a duplicated earlier frame) is discarded — it
        must never be delivered as the answer to a later call."""
        for _ in range(8):
            out, arrs = recv_msg(self.sock, op=op)
            r = out.get("rid")
            if r is None or r == rid:
                return out, arrs
        raise ClusterTransportError(
            f"no reply correlated to request {rid} (op {op})")

    def call(self, msg, arrays=None, retries=None, deadline_s=None):
        from ..utils import failpoint
        from ..utils import metrics as _metrics
        from ..utils.device_guard import (backoff_delay, classify,
                                          RETRYABLE)
        op = str(msg.get("op"))
        if retries is None:
            retries = env_int("TIDB_TPU_CLUSTER_RPC_RETRIES", 4)
        if deadline_s is None:
            deadline_s = float(os.environ.get(
                "TIDB_TPU_CLUSTER_RPC_DEADLINE_S", "60"))
        if not self.breaker.allow():
            _metrics.CLUSTER_RPC.labels(op, "breaker_open").inc()
            raise ClusterTransportError(
                f"worker {self.port} circuit breaker open (op {op})")
        # trace context rides the request next to rid/epoch: the worker
        # installs it, records its spans under our trace_id, and hands
        # the finished events back on the reply. Captured OUTSIDE the
        # call lock — it belongs to the CALLING thread's open trace.
        from ..utils import tracing as _tracing
        tctx = _tracing.current_context()
        with self._call_mu:
            self._rid_seq += 1
            rid = f"{self._rid_prefix}:{self._rid_seq}"
            req = dict(msg)
            req["rid"] = rid
            if self.epoch_fn is not None:
                req["epoch"] = self.epoch_fn()
            if tctx is not None:
                trace_id, parent_id, sampled, _state = tctx
                req["trace"] = [trace_id, parent_id, 1 if sampled else 0]
            deadline = time.monotonic() + deadline_s
            attempt = 0
            while True:
                try:
                    failpoint.inject("cluster/rpc")
                    t0 = time.perf_counter()
                    # socket I/O under _call_mu is the lock's PURPOSE:
                    # one stream per worker, send+recv must be an
                    # atomic frame exchange or concurrent callers
                    # interleave frames (see __init__)
                    # tpulint: disable=blocking-under-lock — per-socket
                    send_msg(self.sock, req, arrays, op=op)
                    # tpulint: disable=blocking-under-lock — per-socket
                    out, arrs = self._recv_reply(rid, op)
                    _metrics.RPC_SECONDS.labels(op).observe(
                        time.perf_counter() - t0)
                    self.breaker.record_success()
                    break
                except (ConnectionError, OSError) as exc:
                    err_class = classify(exc)
                    attempt += 1
                    self.breaker.record_failure()
                    delay = backoff_delay(attempt - 1)
                    if err_class not in RETRYABLE or attempt > retries \
                            or time.monotonic() + delay > deadline:
                        _metrics.CLUSTER_RPC.labels(
                            op, "transport_error").inc()
                        raise
                    _metrics.RPC_RETRIES.labels(op).inc()
                    # backoff stays under _call_mu on purpose: a
                    # second caller must not slip a frame onto the
                    # half-reconnected stream between attempts
                    # tpulint: disable=blocking-under-lock — retry gap
                    time.sleep(delay)
                    try:
                        self._connect()     # fresh stream: no stale
                    except OSError:         # half-frames or replies
                        continue
        spans = out.pop("spans", None)
        if spans and tctx is not None:
            # piggybacked remote spans join the calling statement's
            # open trace buffer (list.extend under the GIL — safe from
            # fan-out threads, which all share the coordinator state)
            tctx[3].buf.extend(
                _tracing.SpanEvent(*e) for e in spans)
        if out.get("dedup"):
            _metrics.CLUSTER_RPC_DEDUP.labels(op).inc()
        if out.get("err_kind") == "stale_epoch":
            _metrics.CLUSTER_RPC.labels(op, "stale_epoch").inc()
            raise ClusterEpochStaleError(
                "%s", out.get("err", "stale cluster epoch"))
        if "err" in out:
            _metrics.CLUSTER_RPC.labels(op, "app_error").inc()
            raise RuntimeError(out["err"])
        _metrics.CLUSTER_RPC.labels(op, "ok").inc()
        return out, arrs


class Cluster:
    """Coordinator session over N worker processes."""

    def __init__(self, ports, spawn_worker=None, regions=None,
                 data_dir=None, device=None):
        from ..session import new_store, Session
        # cluster epoch: bumped (and persisted in the coordinator's
        # meta namespace) by every fenced failover; every client call
        # stamps it, every worker rejects mismatches
        self.epoch = 0
        self._topo_mu = lockrank.ranked_rlock("cluster.coordinator.topo")
        self.workers = [self._client(p) for p in ports]
        # region label per worker (PD store labels); None = unlabeled
        self.worker_regions = list(regions) if regions else None
        # local schema-only domain: plans are built here, data lives on
        # the workers. With data_dir the domain is durable, so the
        # distributed-DDL job records (add_index_distributed) AND the
        # cluster epoch survive a coordinator restart.
        self.domain = new_store(data_dir, device=device)
        self.sess = Session(self.domain)
        self.sess.vars.current_db = "test"
        # recovery state (reference: stateless store nodes reload from
        # durable storage; DXF rebalances subtasks off dead executors —
        # dxf/framework/doc.go:30-33): the coordinator remembers enough
        # to rebuild a worker's shard on a replacement process
        self.spawn_worker = spawn_worker   # () -> port of a new worker
        self._ddl_log: list = []
        self._loads: list = []             # [(table, csv_path)]
        self._replicated = False           # WAL chain active
        self._follower_port: dict = {}     # slot -> its follower's port
        self._deposed: dict = {}           # old-primary port -> slot
        self._standbys: dict = {}          # port -> demoted follower
        self._aux_clients: dict = {}       # port -> cached ad-hoc client
        self._monitor = None
        self._load_epoch()
        if self.epoch:
            # durable coordinator restart: the persisted epoch outlives
            # the (fresh, epoch-0) worker fleet — hand it out before
            # any stamped data op is rejected as a mismatch
            for w in self.workers:
                try:
                    w.call({"op": "set_epoch"})
                except (OSError, RuntimeError):
                    pass
        # a live distributed job found at construction = a previous
        # coordinator died mid-reorg: abort it on the workers NOW,
        # before any query can observe leaked ladder state
        self.resume_ddl_jobs()

    # ---- epoch / supervision -------------------------------------------

    def _client(self, port) -> _WorkerClient:
        return _WorkerClient(port, epoch_fn=lambda: self.epoch)

    def _client_for_port(self, port) -> _WorkerClient:
        for w in self.workers:
            if w.port == port:
                return w
        if port in self._standbys:
            return self._standbys[port]
        # cache ad-hoc clients (deposed/rejoining peers): each one owns
        # a live socket, and failover/recovery paths look ports up
        # repeatedly — constructing a fresh client per lookup would
        # leak a connection per failover
        cli = self._aux_clients.get(port)
        if cli is None:
            cli = self._client(port)
            self._aux_clients[port] = cli
        return cli

    def _load_epoch(self):
        txn = self.domain.storage.begin()
        try:
            v = txn.get(_K_CLUSTER_EPOCH)
        finally:
            txn.rollback()
        if v is not None:
            self.epoch = int(v)

    def _persist_epoch(self):
        # the domain runner's shared retrying meta-txn wrapper RAISES
        # on conflict exhaustion — a silent fall-through would leave a
        # bumped epoch in memory only, and a coordinator restart would
        # reload + rebroadcast the stale value against newer-epoch
        # workers (cluster-wide 9010 with no repair path)
        self.domain.ddl_jobs._retry_txn(
            lambda m: m.txn.set(_K_CLUSTER_EPOCH,
                                str(self.epoch).encode()),
            what="cluster epoch")

    def start_supervision(self, interval_s=0.5, suspect_after_s=1.5,
                          down_after_s=3.5, auto_failover=True,
                          auto_reintegrate=True):
        """Start the heartbeat monitor (cluster/supervision.py): lag
        gauges, the suspect->down state machine, automatic fenced
        failover of down workers, and rejoin-demotion of deposed
        primaries that come back. Opt-in: tests that kill workers and
        drive _recover_worker by hand stay deterministic without it."""
        from .supervision import ClusterMonitor
        if self._monitor is not None:
            return self._monitor
        self._monitor = ClusterMonitor(
            self, interval_s=interval_s,
            suspect_after_s=suspect_after_s, down_after_s=down_after_s,
            auto_failover=auto_failover,
            auto_reintegrate=auto_reintegrate)
        self._monitor.start()
        # the cluster_health vtable reads the monitor off the domain
        self.domain.cluster_monitor = self._monitor
        return self._monitor

    def mark_down(self, slot: int):
        """Operator/test seam: declare a worker dead (the partitioned-
        primary case — the process may well still be running) and run
        the fenced failover for its slot NOW."""
        return self._failover(slot, reason="marked down")

    def _failover(self, i: int, reason: str = "down"):
        """Fenced failover of slot i (reference: raft leader election
        collapsed to coordinator-driven promotion): bump + persist the
        cluster epoch, move the slot's WAL-chain follower to the new
        epoch FIRST (from that instant any late ship from the old
        primary is rejected — it can never ack another write), then
        promote the follower's shipped log onto a replacement process
        and repair the chain. The deposed primary's port is remembered:
        if it ever answers again the monitor demotes it to a follower
        (reintegrate)."""
        from ..utils import metrics as _metrics
        from ..utils.logutil import log
        with self._topo_mu:
            old = self.workers[i]
            self.epoch += 1
            self._persist_epoch()
            try:
                n = len(self.workers)
                fport = self._follower_port.get(
                    i, self.workers[(i + 1) % n].port)
                fcli = self._client_for_port(fport)
                # fence point: the follower holding slot i's log moves
                # to the new epoch BEFORE its log is read for promotion
                fcli.call({"op": "set_epoch"})
                for w in self.workers:
                    if w is old or w is fcli:
                        continue
                    try:
                        w.call({"op": "set_epoch"})
                    except (OSError, RuntimeError):
                        pass    # straggler: epoch-mismatch rejected
                        #         until the monitor re-broadcasts
                w = self._recover_worker(i)
                if w is None:
                    raise ClusterTransportError(
                        f"failover of worker slot {i} impossible: "
                        f"no spawn_worker")
            except (SystemExit, KeyboardInterrupt):
                raise
            except BaseException:
                # the epoch is already bumped + persisted: hand it to
                # every reachable worker before surfacing the failure,
                # or one dead follower turns a single-slot problem into
                # a cluster-wide epoch-mismatch outage (with no monitor
                # there is no re-broadcast to repair it)
                for w in self.workers:
                    if w is old:
                        continue
                    try:
                        w.call({"op": "set_epoch"})
                    except (OSError, RuntimeError):
                        pass
                raise
            self._deposed[old.port] = i
            _metrics.CLUSTER_FAILOVERS.inc()
            log("warn", "cluster_failover", slot=i, reason=reason,
                epoch=self.epoch, old_port=old.port, new_port=w.port)
            return w

    def reintegrate(self, port: int):
        """Rejoin protocol: a deposed primary answered a heartbeat
        again. Demote it (sticky fence — it may hold writes the
        cluster never acked), then point the slot's CURRENT primary at
        it as the WAL-chain follower: set_follower re-seeds the full
        shipped history, so the rejoiner catches up from the new
        primary's WAL tail and serves as a follower from then on."""
        from ..utils.logutil import log
        with self._topo_mu:
            slot = self._deposed.get(port)
            if slot is None:
                return None
            cli = self._client_for_port(port)
            cli.call({"op": "demote"})
            self.workers[slot].call(
                {"op": "set_follower", "port": port, "primary": slot})
            self._follower_port[slot] = port
            self._standbys[port] = cli
            del self._deposed[port]
            log("info", "cluster_rejoin_demoted", slot=slot, port=port,
                epoch=self.epoch)
            return cli

    def _wait_replacement(self, i: int, old, timeout_s: float = 20.0):
        """Under supervision, a caller that hit a dead worker waits for
        the monitor's failover to swap the slot instead of racing its
        own _recover_worker against it."""
        if self._monitor is None:
            with self._topo_mu:
                if self.workers[i] is not old:
                    # a concurrent caller already replaced the slot —
                    # recovering again would double-spawn and orphan
                    # the first replacement
                    return self.workers[i]
                return self._recover_worker(i)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            cur = self.workers[i]
            if cur is not old:
                return cur
            time.sleep(0.1)
        return None

    def _job_txn(self, fn):
        """One meta txn against the coordinator's (durable) domain —
        the distributed reorg's job record rides it. Delegates to the
        domain runner's shared retrying txn wrapper (a concurrent
        local DDL on the coordinator domain races the queue/history
        keys)."""
        return self.domain.ddl_jobs._retry_txn(
            fn, what="coordinator job")

    def resume_ddl_jobs(self):
        """Coordinator-restart recovery (the distributed half of
        owner/ddl_runner.resume_pending, which skips distributed jobs):
        a live distributed job record means a coordinator died
        mid-reorg. If the coordinator's OWN durable schema already has
        the index, the crash fell between the local commit (which runs
        AFTER every worker reached public) and the job finish — roll
        FORWARD (record synced; aborting would strip workers of an
        index the coordinator still plans against). Otherwise abort it
        on every reachable worker (drop the index meta AND purge
        committed backfill KVs) and record the job cancelled. Returns
        the handled job ids."""
        from ..models.job import STATE_CANCELLED, STATE_SYNCED
        jobs = self._job_txn(
            lambda m: [j for j in m.list_ddl_jobs()
                       if j.args.get("distributed")])
        handled = []
        for job in jobs:
            iname = job.args["index"]["name"]
            local_has = False
            try:
                t = self.domain.infoschema().table_by_name(
                    job.db_name, job.table_name)
                local_has = t.find_index(iname) is not None
            except Exception:               # noqa: BLE001
                pass
            if local_has:
                job.state = STATE_SYNCED
                self._job_txn(lambda m, j=job: m.finish_ddl_job(j))
                handled.append(job.id)
                continue
            payload = {"db": job.db_name, "table": job.table_name,
                       "index": iname, "state": "abort"}

            def ab(_i, w):
                try:
                    w.call({"op": "dxf_subtask", "kind": "index_ladder",
                            "payload": dict(payload)})
                except (OSError, RuntimeError):
                    pass        # dead worker: a respawn replays only
                    #             the DDL log, which has no trace of
                    #             the aborted index
            self._fanout(ab)
            job.state = STATE_CANCELLED
            job.error = ("coordinator restarted mid-reorg; index "
                         "aborted on workers")
            self._job_txn(lambda m, j=job: m.finish_ddl_job(j))
            handled.append(job.id)
        return handled

    def _fanout(self, fn):
        """Run fn(i, worker) concurrently for every worker (independent
        sockets); returns results in worker order, raising the first
        error only after every thread joined. The caller's trace
        context is installed in each thread, so per-worker RPCs stamp
        the statement's trace_id and their piggybacked spans land in
        the statement's buffer (the threads join before the statement
        span closes)."""
        import threading
        from ..utils import tracing as _tracing
        tctx = _tracing.current_context()
        outs = [None] * len(self.workers)
        errs = []

        def run(i, w):
            _tracing.set_thread_context(tctx)
            try:
                outs[i] = fn(i, w)
            except Exception as e:      # noqa: BLE001
                errs.append(e)
            finally:
                _tracing.set_thread_context(None)
        ts = [threading.Thread(target=run, args=(i, w))
              for i, w in enumerate(self.workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]
        return outs

    def ddl(self, sql: str):
        with self.domain.tracer.span("cluster_ddl", sampled=True):
            self.sess.execute(sql)
            self._ddl_log.append(sql)
            for w in self.workers:
                w.call({"op": "load_sql", "sqls": [sql]})

    def _placement_workers(self, table: str) -> list:
        """Worker indexes eligible to hold this table's shards — the
        PD region-aware placement decision (reference PD placement
        rules driven by PLACEMENT POLICY, pkg/ddl/placement_policy.go)
        collapsed to: a table attached to a policy places its shards
        only on workers whose region label is in the policy's
        primary_region/regions; unlabeled clusters and unattached
        tables place round-robin on every worker."""
        everyone = list(range(len(self.workers)))
        if not self.worker_regions:
            return everyone
        try:
            t = self.domain.infoschema().table_by_name("test", table)
        except Exception:                     # noqa: BLE001
            return everyone
        pol = getattr(t, "placement_policy", "")
        if not pol:
            return everyone
        import json as _json
        try:
            rs = self.sess.execute(
                "select settings from mysql.placement_policies "
                f"where name = '{pol}'")
        except Exception:                     # noqa: BLE001
            return everyone
        if not rs.rows:
            return everyone
        opts = _json.loads(rs.rows[0][0])
        regions = {r.strip() for r in
                   str(opts.get("regions", "")).split(",") if r.strip()}
        if opts.get("primary_region"):
            regions.add(str(opts["primary_region"]))
        eligible = [i for i in everyone
                    if self.worker_regions[i] in regions]
        return eligible or everyone

    def load_shards(self, table: str, csv_path: str):
        with self.domain.tracer.span("load_shards", sampled=True,
                                     table=table):
            return self._load_shards(table, csv_path)

    def _load_shards(self, table: str, csv_path: str):
        eligible = self._placement_workers(table)
        # loads after enable_replication() reach the followers' WAL via
        # the INSERT commit hook; earlier ones exist only in the bulk
        # source, so recovery must replay them from there even when WAL
        # frames exist (flag: was the chain active at load time?)
        self._loads.append((table, csv_path, eligible, self._replicated))
        total = 0
        for pos, i in enumerate(eligible):
            out, _ = self.workers[i].call(
                {"op": "load_shard", "table": table, "csv": csv_path,
                 "shard": pos, "nshards": len(eligible)})
            total += out["rows"]
        return total

    def enable_replication(self):
        """Form the WAL chain: worker i ships every commit's data
        mutations to worker (i+1) % N before acking (reference: TiKV
        raft replication, collapsed to one synchronous follower).
        After this, _recover_worker promotes the follower's shipped
        log instead of re-reading bulk sources — an acked transactional
        write survives kill -9 of the only process that held it."""
        n = len(self.workers)
        if n < 2:
            raise ValueError("replication needs >= 2 workers")
        for i, w in enumerate(self.workers):
            w.call({"op": "set_follower",
                    "port": self.workers[(i + 1) % n].port,
                    "primary": i})
            self._follower_port[i] = self.workers[(i + 1) % n].port
        self._replicated = True

    def _recover_worker(self, i):
        """Replace dead worker i: spawn a fresh process, replay the DDL
        log (same fresh-store sequence -> same table ids), then restore
        the shard data. With replication on, the data comes from the
        slot's WAL-chain follower's shipped log (no acked txn lost) —
        the ring successor by default, a reintegrated standby when the
        monitor rewired the chain; otherwise it is re-read from the
        durable bulk sources (BR-manifest role). The recovered node
        then serves the same fragments."""
        with self._topo_mu:
            if self.spawn_worker is None:
                return None
            port = self.spawn_worker()
            w = self._client(port)
            # a fresh process is born at epoch 0: hand it the current
            # cluster epoch before any stamped data op reaches it
            w.call({"op": "set_epoch"})
            if self._ddl_log:
                w.call({"op": "load_sql", "sqls": list(self._ddl_log)})
            frames = None
            n = len(self.workers)
            if self._replicated:
                fport = self._follower_port.get(
                    i, self.workers[(i + 1) % n].port)
                follower = self._client_for_port(fport)
                out, arrs = follower.call(
                    {"op": "wal_fetch", "primary": i})
                if out["n"]:
                    frames = {f"f{j}": arrs[f"f{j}"]
                              for j in range(out["n"])}
            for table, csv_path, eligible, replicated in self._loads:
                # loads made under replication live in the WAL frames;
                # pre-replication loads only in the bulk source. Without
                # frames, everything reloads from the source.
                if i in eligible and \
                        not (replicated and frames is not None):
                    w.call({"op": "load_shard", "table": table,
                            "csv": csv_path, "shard": eligible.index(i),
                            "nshards": len(eligible)})
            if frames is not None:
                w.call({"op": "wal_replay", "n": len(frames)}, frames)
            if self._replicated:
                # install the replacement's ship hook BEFORE exposing
                # it to writers: swapping it into self.workers first
                # opened a window where a commit was acked with NO
                # follower configured — an acked write that existed on
                # one process only, silently lost the next time that
                # slot died (found by scripts/cluster_smoke.py's
                # ledger: consecutive same-slot keys lost in pairs)
                fport = self._follower_port.get(
                    i, self.workers[(i + 1) % n].port)
                w.call({"op": "set_follower", "port": fport,
                        "primary": i})
                self._follower_port[i] = fport
            self.workers[i] = w
            if self._replicated:
                # repair the chain behind the replacement: the
                # predecessor ships to the new process (its degraded
                # backlog toward the dead port flushes in the reseed)
                self.workers[(i - 1) % n].call(
                    {"op": "set_follower", "port": w.port,
                     "primary": (i - 1) % n})
                self._follower_port[(i - 1) % n] = w.port
            return w

    def tso(self, worker=0) -> int:
        out, _ = self.workers[worker].call({"op": "tso"})
        return out["ts"]

    def query_agg(self, sql: str):
        """Fan the aggregation fragment out to every worker, merge the
        partials locally, run the plan's post-agg operators. Runs under
        an always-sampled trace root: the fan-out threads propagate its
        context, so the coordinator ring ends up holding the whole
        cross-worker tree (TRACE-equivalent for the cluster API)."""
        with self.domain.tracer.span("query_agg", sampled=True):
            return self._query_agg(sql)

    def _query_agg(self, sql: str):
        from ..parser import parse
        from ..planner.optimize import optimize
        from ..planner.physical import PhysHashAgg
        from ..executor.exec_base import ExecContext
        from ..executor.executors import HashAggExec
        stmt = parse(sql)[0]
        plan = optimize(stmt, self.sess._plan_ctx())
        node = plan
        while node is not None and not isinstance(node, PhysHashAgg):
            node = node.children[0] if node.children else None
        if node is None:
            raise ValueError("query has no aggregation fragment")
        # fan out in parallel, merge with ONE set of shared dictionaries
        # so codes stay comparable across workers; a worker that died
        # mid-query is replaced and ONLY its fragment re-runs
        # (reference copr/coprocessor.go:525 retry loop per cop task)
        def fetch(i, w):
            try:
                return w.call({"op": "partial", "sql": sql})
            except (OSError, ClusterEpochStaleError):
                # dead or fenced-away worker: under supervision wait
                # for the monitor's failover to swap the slot (racing
                # our own recovery against it would double-spawn);
                # otherwise recover it ourselves, then re-run ONLY this
                # fragment
                nw = self._wait_replacement(i, w)
                if nw is None:
                    raise
                return nw.call({"op": "partial", "sql": sql})
        results = self._fanout(fetch)
        partials = []
        shared_dicts: dict = {}
        for out, arrs in results:
            partials.extend(deserialize_partials(out, arrs,
                                                 shared_dicts))

        class _RemoteReader:
            """Stands in for the TableReader: partials() returns what
            the exchange delivered from the workers."""

            def __init__(self, inner):
                self._partials = inner

            def partials(self):
                return self._partials

            def open(self):
                pass

            def close(self):
                pass
        ectx = ExecContext(self.sess)
        try:
            agg = HashAggExec(ectx, _FinalPlanView(node),
                              _RemoteReader(partials))
            # rebuild the operators ABOVE the agg on the merged result
            chunk = agg.next()
            return self._apply_tail(plan, node, chunk, ectx)
        finally:
            ectx.finish()

    def _apply_tail(self, plan, agg_node, chunk, ectx):
        """Run post-agg operators (sort/topn/projection) on the merged
        chunk by swapping the agg subtree for a static chunk source."""
        class _ChunkSource:
            def __init__(self, schema, ch):
                self.schema = schema
                self._ch = [ch] if ch is not None and len(ch) else []
                self.children = []

            def open(self):
                pass

            def next(self):
                return self._ch.pop(0) if self._ch else None

            def close(self):
                pass

            def all_chunks(self):
                out = list(self._ch)
                self._ch = []
                return out
        src = _ChunkSource(agg_node.schema, chunk)
        path = []
        node = plan
        while node is not agg_node:
            path.append(node)
            node = node.children[0]
        ex = src
        for p in reversed(path):
            ex = _shallow_with_child(ectx, p, ex)
        out = []
        ch = ex.next()
        while ch is not None:
            if len(ch):
                out.append(ch)
            ch = ex.next()
        rows = []
        for c in out:
            for i in range(len(c)):
                rows.append(c.row_py(i))
        return rows

    def spmd_init(self, port: int | None = None, local_shards: int = 1):
        """Form the process group: worker i = rank i of one global mesh
        with `local_shards` shards each (worker 0 hosts the group's TCP
        store, on `port` or a free one found here). init blocks until
        every peer joins, so the calls fan out in parallel threads.
        Returns per-worker layouts (device counts and the backend)."""
        if port is None:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
        coord = f"127.0.0.1:{port}"
        outs = [o for o, _ in self._fanout(
            lambda i, w: w.call({"op": "spmd_init", "coordinator": coord,
                                 "nproc": len(self.workers), "pid": i,
                                 "local_shards": local_shards}))]
        self._spmd_local_devices = [o["local_devices"] for o in outs]
        return outs

    def spmd_agg(self, sql: str, n_groups=None):
        """Plan locally, extract the pushed scan->filter->partial-agg
        CoprDAG, broadcast it (pickled — the tipb.DAGRequest analog) to
        every host, and launch the collective fragment: one SPMD
        program over the global mesh, psum as the exchange. Returns
        {"sums": [...], "counts": ...} (replicated; worker 0's copy),
        and asserts every host returned the same result — the SPMD
        invariant made observable."""
        with self.domain.tracer.span("spmd_agg", sampled=True):
            return self._spmd_agg(sql, n_groups)

    def _spmd_agg(self, sql: str, n_groups=None):
        import math
        import pickle
        from ..parser import parse
        from ..planner.optimize import optimize
        from ..planner.physical import PhysTableReader
        stmt = parse(sql)[0]
        plan = optimize(stmt, self.sess._plan_ctx())
        node, stack = None, [plan]
        while stack:
            p = stack.pop()
            if isinstance(p, PhysTableReader) and p.dag.aggs:
                node = p
                break
            stack.extend(p.children)
        if node is None:
            raise ValueError("no pushed partial-agg fragment in plan")
        dag = node.dag
        # one static per-host row capacity: max PHYSICAL rows over
        # workers (snapshot() binds closed version rows too, so the
        # live count would under-size after updates/deletes), rounded
        # to the lcm of local device counts
        tname = dag.table_info.name
        rows = [o["rows"] for o, _ in self._fanout(
            lambda i, w: w.call({"op": "table_rows", "table": tname,
                                 "db": dag.db_name or "test"}))]
        lcm = 1
        for ld in getattr(self, "_spmd_local_devices",
                          [1] * len(self.workers)):
            lcm = lcm * ld // math.gcd(lcm, ld)
        cap = -(-max(max(rows), 1) // lcm) * lcm
        blob = np.frombuffer(pickle.dumps(dag), dtype=np.uint8)
        outs = self._fanout(
            lambda i, w: w.call({"op": "spmd_frag", "local_cap": cap,
                                 "n_groups": n_groups}, {"dag": blob}))
        ref_meta, ref = outs[0]
        for meta, arrs in outs[1:]:
            for k in ref:
                assert np.array_equal(ref[k], arrs[k]), \
                    f"SPMD divergence on {k}"
        return {"sums": [ref[f"s{i}"] for i in range(ref_meta["nsums"])],
                "counts": ref["counts"]}

    def add_index_distributed(self, table, index, columns, unique=False,
                              db="test"):
        """Distributed ADD INDEX (reference
        pkg/ddl/backfilling_dist_scheduler.go + the DXF add-index app):
        the coordinator drives the F1 ladder as cluster-wide barriers —
        every node reaches delete-only, then write-only, then
        write-reorg (a per-state broadcast = the schema-version sync) —
        and dispatches one backfill subtask per shard. A shard's
        subtask is PINNED to its node (data locality); if the node dies
        mid-reorg the coordinator respawns it, replays the ladder, and
        re-runs just that shard's backfill. Cross-shard UNIQUE
        duplicates are caught by merging per-shard key hashes; on
        conflict every node aborts the index meta."""
        import time as _time
        from ..errors import DuplicateKeyError, DDLJobCancelledError
        from ..utils import failpoint
        from ..models import DDLJob
        from ..models.job import (TYPE_ADD_INDEX, STATE_RUNNING,
                                  STATE_SYNCED, STATE_CANCELLED,
                                  STATE_CANCELLING)
        base = {"db": db, "table": table, "index": index,
                "columns": list(columns), "unique": unique}
        applied: list = []          # ladder states every node reached
        backfilled = False
        # durable job record in the coordinator domain: each completed
        # cluster-wide barrier persists, so a coordinator restart knows
        # exactly what worker-side ladder state exists and aborts it
        # (resume_ddl_jobs) instead of leaking it
        job = DDLJob(
            type=TYPE_ADD_INDEX, state=STATE_RUNNING, db_name=db,
            table_name=table, start_wall=_time.time(),
            args={"distributed": True,
                  "index": {"name": index, "columns": list(columns),
                            "unique": bool(unique)},
                  "applied": []})
        self._job_txn(lambda m: m.enqueue_ddl_job(job))

        def _persist_barrier():
            # honor ADMIN CANCEL DDL JOB transactionally at every
            # barrier (the local runner skips distributed jobs, so the
            # coordinator is the only observer): the raise lands in the
            # BaseException handler below -> abort on every worker +
            # job cancelled — and the put can never clobber a
            # concurrent cancelling flag
            def put(m):
                cur = m.get_ddl_job(job.id)
                if cur is not None and cur.state == STATE_CANCELLING:
                    raise DDLJobCancelledError(
                        "Cancelled DDL job %d", job.id)
                job.args["applied"] = list(applied)
                job.args["backfilled"] = backfilled
                m.put_ddl_job(job)
            self._job_txn(put)
            failpoint.inject("ddl-dist-barrier")

        def _finish(state, error=""):
            job.state = state
            job.error = error
            self._job_txn(lambda m: m.finish_ddl_job(job))

        def ladder(w, state):
            w.call({"op": "dxf_subtask", "kind": "index_ladder",
                    "payload": {**base, "state": state}})

        def backfill(w):
            out, _ = w.call({"op": "dxf_subtask",
                             "kind": "index_backfill",
                             "payload": dict(base)})
            return out["result"]

        def with_recovery(i, fn):
            """Run fn against worker i; if the executor is dead,
            respawn it, replay the reorg work it missed (ladder
            states, plus its shard's backfill once that stage has
            passed), then retry fn."""
            try:
                return fn(self.workers[i])
            except OSError:
                w = self._recover_worker(i)
                if w is None:
                    raise
                for st in applied:
                    ladder(w, st)
                if backfilled:
                    backfill(w)
                return fn(w)

        def abort_all():
            """Best-effort abort on every reachable node: drop the
            index meta AND purge committed backfill KVs (index ids are
            recycled). A freshly respawned worker replayed only the
            DDL log, which has no trace of this index — nothing to do
            there."""
            def ab(i, w):
                try:
                    ladder(w, "abort")
                except OSError:
                    self._recover_worker(i)
            self._fanout(ab)

        try:
            for st in ("delete_only", "write_only", "write_reorg"):
                self._fanout(lambda i, w, st=st:
                             with_recovery(i, lambda ww: ladder(ww, st)))
                applied.append(st)
                _persist_barrier()
            outs = self._fanout(lambda i, w: with_recovery(i, backfill))
        except OSError:
            raise               # executor dead and no spawner: stuck —
            #                     the live job record lets a restarted
            #                     coordinator abort once workers return
        except (SystemExit, KeyboardInterrupt):
            raise               # process dying: can't abort now; the
            #                     durable record drives the abort at
            #                     the next coordinator start
        except BaseException as e:
            abort_all()
            _finish(STATE_CANCELLED, "%s: %s" % (type(e).__name__, e))
            raise
        dup = next((o["dup"] for o in outs if o.get("dup")), None)
        if dup is None and unique:
            seen: set = set()
            for out in outs:
                for h in out.get("key_hashes") or []:
                    if h in seen:
                        dup = f"duplicate key across shards ({index})"
                        break
                    seen.add(h)
                if dup:
                    break
        if dup is not None:
            abort_all()
            _finish(STATE_CANCELLED, dup)
            raise DuplicateKeyError("Duplicate entry for key '%s': %s",
                                    index, dup)
        backfilled = True
        _persist_barrier()
        self._fanout(lambda i, w:
                     with_recovery(i, lambda ww: ladder(ww, "public")))
        # coordinator's schema-only domain + the recovery DDL log (a
        # replacement worker rebuilds the index by replaying this)
        sql = (f"alter table {table} add "
               f"{'unique ' if unique else ''}index {index} "
               f"({', '.join(columns)})")
        self.sess.execute(sql)
        self._ddl_log.append(sql)
        _finish(STATE_SYNCED)
        return sum(out["rows"] for out in outs)

    def dxf_run(self, kind: str, payloads: list, concurrency: int = 4):
        """Multi-node DXF (reference dxf/framework scheduler +
        balancer, doc.go:30-33): dispatch {kind, payload} subtasks
        round-robin over the workers; when an executor dies mid-task,
        its unfinished subtasks re-assign to survivors, so the task
        completes as long as one node lives. Returns results in
        payload order; raises if every worker is gone or a subtask
        fails on a LIVE worker.

        CONTRACT (same as the reference's subtask model): handlers
        must be idempotent/re-runnable — a subtask whose executor died
        after executing but before replying is re-run on a survivor,
        exactly like the reference re-dispatches subtasks of dead
        executors. The dead-set is per task: a worker that timed out
        here is retried fresh by the next task."""
        import threading
        from concurrent.futures import ThreadPoolExecutor
        alive = set(range(len(self.workers)))
        alive_mu = lockrank.ranked_lock("cluster.coordinator.alive")

        def run_one(i):
            attempt = 0
            while True:
                with alive_mu:
                    live = sorted(alive)
                if not live:
                    raise RuntimeError("dxf: no live executors")
                widx = live[(i + attempt) % len(live)]
                try:
                    out, _ = self.workers[widx].call(
                        {"op": "dxf_subtask", "kind": kind,
                         "payload": payloads[i]})
                    return out["result"]
                except OSError:
                    # executor death: balance this subtask away
                    with alive_mu:
                        alive.discard(widx)
                    attempt += 1
        with ThreadPoolExecutor(max_workers=max(concurrency, 1)) as ex:
            return list(ex.map(run_one, range(len(payloads))))

    def query(self, sql: str, worker=0):
        out, _ = self.workers[worker].call({"op": "query", "sql": sql})
        return [tuple(r) for r in out["rows"]]

    def stop(self):
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None
        # drain-then-close: every worker flushes its in-flight WAL
        # ship + degraded backlog before the listener goes down, so a
        # clean shutdown can never present as acked loss in the soak
        for w in list(self.workers) + list(self._standbys.values()):
            try:
                w.call({"op": "stop"})
            except Exception:           # noqa: BLE001
                pass
        self._standbys.clear()
        self._aux_clients.clear()


class _FinalPlanView:
    """HashAggExec-compatible view of a PhysHashAgg forced into final
    mode (remote partials are always partial results)."""

    def __init__(self, agg_node):
        self.group_items = agg_node.group_items
        self.aggs = agg_node.aggs
        self.mode = "final"
        self.schema = agg_node.schema


def _shallow_with_child(ectx, plan, child_exec):
    """Build a one-level executor for `plan` with child_exec as input."""
    from ..executor import executors as X
    from ..planner import physical as pp
    if isinstance(plan, pp.PhysProjection):
        return X.ProjectionExec(ectx, plan, child_exec)
    if isinstance(plan, pp.PhysSort):
        return X.SortExec(ectx, plan, child_exec)
    if isinstance(plan, pp.PhysTopN):
        return X.TopNExec(ectx, plan, child_exec)
    if isinstance(plan, pp.PhysLimit):
        return X.LimitExec(ectx, plan, child_exec)
    if isinstance(plan, pp.PhysSelection):
        return X.SelectionExec(ectx, plan, child_exec)
    if isinstance(plan, pp.PhysShell):
        return X.ShellExec(ectx, plan, child_exec)
    raise ValueError(f"unsupported tail op {type(plan).__name__}")
