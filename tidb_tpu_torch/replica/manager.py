"""Read-replica fabric (reference TiFlash learner replicas + the
Taurus near-data-processing split, collapsed to in-process domains).

A replica is a full mirror Domain fed by its own changefeed through a
``ReplicaSink`` (TableSink direct-KV ingest at the source commit_ts,
on-demand schema sync, checkpoint-resume). The sink's
``flush_resolved`` stamps the replica's **applied watermark**: every
transaction at/below it has been applied to the mirror, so a read
pinned at the watermark sees an exact historical snapshot of the
leader.

Health state machine (supervision-thread driven, one tick surviving
any exception — the cluster/supervision.py pattern):

    provisioning — feed streaming but the watermark has not reached
                   the catch-up target captured at (re)provision time
    serving      — watermark >= target, feed normal, heartbeat fresh
    lagging      — feed in classified-retry (error), heartbeat stale,
                   or lag above the routing SLA; routed around, not
                   reprovisioned
    down         — feed failed / worker dead; the monitor
                   auto-reprovisions from the checkpoint with backoff

Degradation ladder (the router in session.py consumes ``pick``):
no replica qualifying -> leader, transparently; replica dies
mid-statement -> one leader retry, transparently; feed error/failed ->
routed around by the state machine. A replica read NEVER surfaces an
error the leader would not have raised.

Lock discipline: ``replica.manager`` (rank 195) guards only the
replicas dict and the round-robin cursor. Everything slow — mirror
bootstrap, feed lifecycle (create/resume/stop joins worker threads),
lag computation through the oracle — runs OUTSIDE the lock
(blocking-under-lock hygiene; replica state fields are monitor-owned
plain attributes, same benign-race contract as cluster supervision).
"""
from __future__ import annotations

import threading
import time

from ..cdc.sinks import TableSink
from ..errors import TiDBError
from ..utils import failpoint, lockrank
from ..utils import metrics as metrics_util

STATES = ("provisioning", "serving", "lagging", "down")
_STATE_CODE = {"provisioning": 0, "serving": 1, "lagging": 2, "down": 3}

# monitor knobs: tick fast enough that a killed replica is routed
# around within a poll interval or two; reprovision with backoff so a
# crash-looping replica cannot hot-spin feed restarts
_TICK_S = 0.05
_REPROVISION_BASE_S = 0.1
_REPROVISION_CAP_S = 2.0
_HEARTBEAT_STALE_S = 1.0


class ReplicaSink(TableSink):
    """TableSink bound to a ReplicaDomain: same exactly-once direct-KV
    apply, plus watermark/heartbeat stamping and the chaos seams. The
    sink object lives on the replica (NOT per feed incarnation), so
    ``applied_ts`` survives feed restarts and re-creation — redelivery
    after a checkpoint resume stays a no-op."""

    name = "replica"

    def __init__(self, replica: "ReplicaDomain"):
        super().__init__(replica.source, mirror_domain=replica.mirror)
        self.replica = replica

    def emit_txn(self, events):
        failpoint.inject("replica/apply")
        super().emit_txn(events)

    def emit_ddl(self, event):
        # DDL barrier: sync the mirror schema BEFORE any row at a later
        # commit_ts; the synced version is what lets the router prove
        # "watermark >= barrier implies schema is current"
        failpoint.inject("replica/ddl-barrier")
        super().emit_ddl(event)
        self.replica.synced_schema_version = max(
            self.replica.synced_schema_version,
            getattr(event, "schema_version", 0) or 0)

    def flush_resolved(self, ts: int):
        super().flush_resolved(ts)
        self.replica.on_resolved(ts)


class ReplicaDomain:
    """One replica: a private mirror store + the persistent sink + the
    health/watermark fields the monitor and router read."""

    def __init__(self, manager: "ReplicaManager", rid: int):
        from ..session import new_store
        self.manager = manager
        self.source = manager.domain
        self.rid = rid
        # the mirror runs on the leader's device: new_store's default is
        # the card, so a CPU leader's mirror must ask for the CPU
        self.mirror = new_store(None, device=self.source.copr.device)
        self.sink = ReplicaSink(self)
        self.state = "provisioning"
        self.applied_resolved_ts = 0
        self.synced_schema_version = 0
        self.routed_queries = 0
        self.reprovisions = 0
        self.heartbeat = time.time()
        self.catchup_target = 0
        self._fail_streak = 0
        self.next_reprovision = 0.0

    @property
    def feed_name(self) -> str:
        return f"__replica_{self.rid}"

    def on_resolved(self, ts: int):
        """Called by the sink at every watermark flush: all txns <= ts
        are applied (and any DDL <= ts synced — events emit before the
        flush that vouches for them)."""
        self.applied_resolved_ts = ts
        self.heartbeat = time.time()

    def lag_ms(self) -> float:
        wall = self.source.storage.oracle.wall_for_ts(
            self.applied_resolved_ts)
        if wall is None:
            return 0.0
        return max(0.0, (time.time() - wall) * 1000.0)

    def execute_pinned(self, sql: str, db: str):
        """Run one statement on the mirror, snapshot-pinned at the
        applied watermark. A fresh internal session per statement keeps
        the mirror path thread-safe (analyst threads race the feed
        worker's ingest; MVCC reads at the pin are stable)."""
        failpoint.inject("replica/mid-stmt")
        from ..session import Session
        sess = Session(self.mirror)
        sess.is_internal = True
        if db:
            sess.vars.current_db = db
        sess.pinned_read_ts = self.applied_resolved_ts
        return sess.execute(sql)


class ReplicaManager:
    """Domain-scoped fabric: provision / route / supervise / drain."""

    def __init__(self, domain):
        self.domain = domain
        self.replicas: dict[int, ReplicaDomain] = {}
        self._mu = lockrank.ranked_lock("replica.manager")
        self._rr = 0
        self._next_rid = 0
        self._monitor = None
        self._stop = threading.Event()

    # ---- provisioning -------------------------------------------------
    def provision(self, n: int = 1) -> list:
        """Create n replicas, each with its own changefeed. The feed's
        catch-up scan bulk-loads history; the replica serves once its
        watermark reaches the resolved floor captured here."""
        created = []
        for _ in range(n):
            rep = self._new_replica()
            rep.catchup_target = self.domain.cdc.capture.resolved_ts()
            self.domain.cdc.create(rep.feed_name,
                                   f"replica://{rep.rid}",
                                   auto_start=True)
            created.append(rep)
        self._ensure_monitor()
        self.refresh_gauges()
        return created

    def _new_replica(self) -> ReplicaDomain:
        # mirror bootstrap is heavy — build outside the lock, insert
        # under it
        with self._mu:
            rid = self._next_rid
            self._next_rid += 1
        rep = ReplicaDomain(self, rid)
        with self._mu:
            self.replicas[rid] = rep
        return rep

    def sink_for(self, rid: int):
        """make_sink seam for ``replica://<rid>``. Reuses the replica's
        persistent sink so applied_ts (exactly-once) survives feed
        restarts. Called under the cdc registry lock during feed
        construction, so it must not take ``_mu`` (rank 195 < 200);
        plain dict ops are safe — the replica is inserted before its
        feed is created, and the restart path below runs from the
        single-threaded domain-open resume."""
        rep = self.replicas.get(rid)
        if rep is None:
            # domain restart: a persisted __replica_* feed resumed
            # before any provision() call — re-create the replica with
            # a fresh mirror; resume_ts()==0 requests full catch-up
            rep = ReplicaDomain(self, rid)
            rep.catchup_target = self.domain.cdc.capture.resolved_ts()
            self.replicas[rid] = rep
            self._next_rid = max(self._next_rid, rid + 1)
        return rep.sink

    def resume(self):
        """Domain-open hook, called after ``cdc.resume_persisted()``:
        any replica rebuilt by ``sink_for`` from a persisted
        ``__replica_*`` feed needs the monitor running, or nothing ever
        promotes it out of provisioning. (``sink_for`` itself cannot
        start it — it runs under the cdc registry lock, rank 200, and
        the monitor takes ``replica.manager``, rank 195.)"""
        if self.replicas:
            self._ensure_monitor()

    def get(self, rid: int) -> ReplicaDomain:
        rep = self.replicas.get(rid)
        if rep is None:
            raise TiDBError("replica %s does not exist", rid)
        return rep

    # ---- routing ------------------------------------------------------
    def pick(self, max_lag_ms: int, min_ts: int = 0):
        """Freshness-SLA route selection: among serving replicas whose
        feed is healthy, whose watermark covers the DDL barrier and the
        session's own writes (min_ts), and whose lag is within the SLA
        (max_lag_ms <= 0 means unbounded), load-balance round-robin.
        Returns (replica, pinned_ts) or None — the caller degrades to
        the leader, never errors."""
        failpoint.inject("replica/route-pick")
        barrier = getattr(self.domain, "ddl_barrier_ts", 0)
        with self._mu:
            reps = list(self.replicas.values())
            cursor = self._rr
            self._rr += 1
        feeds = self.domain.cdc.feeds
        qualifying = []
        for rep in reps:
            if rep.state != "serving":
                continue
            feed = feeds.get(rep.feed_name)
            if feed is None or feed.state != "normal":
                continue
            ts = rep.applied_resolved_ts
            if ts <= 0 or ts < barrier or ts < min_ts:
                continue
            if max_lag_ms > 0 and rep.lag_ms() > max_lag_ms:
                continue
            qualifying.append((rep, ts))
        if not qualifying:
            return None
        qualifying.sort(key=lambda p: p[0].rid)
        return qualifying[cursor % len(qualifying)]

    def report_failure(self, rep: ReplicaDomain, exc: BaseException):
        """Router-observed mid-statement loss: route away immediately
        (the monitor decides down-vs-lagging on its next tick from the
        feed state, and reprovisions if the worker really died)."""
        from ..utils import device_guard
        cls = device_guard.classify(exc)
        if rep.state == "serving":
            rep.state = "lagging" if cls in ("transient",) else "down"
        self.domain.inc_metric(f"replica_midstmt_{cls}")
        self.refresh_gauges()

    # ---- chaos / failover ---------------------------------------------
    def kill(self, rid: int):
        """Hard-fail a replica: the feed drops to ``failed`` with its
        worker stopped and its subscription released — exactly what a
        retry-exhausted fatal error leaves behind. The monitor routes
        around it and auto-reprovisions from the checkpoint."""
        rep = self.get(rid)
        feed = self.domain.cdc.feeds.get(rep.feed_name)
        if feed is not None:
            feed.state = "failed"
            feed.stop()
        rep.state = "down"
        self.refresh_gauges()

    def _reprovision(self, rep: ReplicaDomain):
        """Resume the failed feed from its checkpoint. The persistent
        sink's applied_ts turns the at-least-once redelivery into
        exactly-once apply; the replica re-enters serving once its
        watermark reaches the CURRENT resolved floor (not the stale
        pre-kill one)."""
        failpoint.inject("replica/reprovision")
        feed = self.domain.cdc.feeds.get(rep.feed_name)
        rep.catchup_target = self.domain.cdc.capture.resolved_ts()
        rep.state = "provisioning"
        rep.reprovisions += 1
        if feed is None:
            self.domain.cdc.create(rep.feed_name,
                                   f"replica://{rep.rid}",
                                   auto_start=True)
        else:
            feed.resume()

    # ---- supervision --------------------------------------------------
    def _ensure_monitor(self):
        with self._mu:
            running = self._monitor is not None and \
                self._monitor.is_alive()
            if running:
                return
            self._stop = threading.Event()
            t = threading.Thread(target=self._run,
                                 name="replica-monitor", daemon=True)
            self._monitor = t
        t.start()

    def _run(self):
        while not self._stop.wait(_TICK_S):
            try:
                self._tick()
            except (SystemExit, KeyboardInterrupt):
                raise
            except BaseException:     # noqa: BLE001 — tick must survive
                pass

    def _sla_ms(self) -> int:
        v = self.domain.global_vars.get("tidb_tpu_replica_max_lag_ms")
        if v is None:
            from ..utils import env_int
            v = env_int("TIDB_TPU_REPLICA_MAX_LAG_MS", 5000)
        return int(v)

    def _tick(self):
        with self._mu:
            reps = list(self.replicas.values())
        feeds = self.domain.cdc.feeds
        sla = self._sla_ms()
        now = time.time()
        for rep in reps:
            feed = feeds.get(rep.feed_name)
            worker_dead = feed is None or feed.state == "failed" or \
                feed._worker is None or not feed._worker.is_alive()
            if worker_dead and (feed is None or
                                feed.state not in ("paused", "removed")):
                rep.state = "down"
                if now >= rep.next_reprovision:
                    backoff = min(_REPROVISION_CAP_S,
                                  _REPROVISION_BASE_S *
                                  (2 ** min(rep._fail_streak, 5)))
                    rep._fail_streak += 1
                    rep.next_reprovision = now + backoff
                    try:
                        self._reprovision(rep)
                    except (SystemExit, KeyboardInterrupt):
                        raise
                    except BaseException:   # noqa: BLE001 — retried
                        rep.state = "down"
                continue
            if feed is not None and feed.state == "paused":
                # operator verb: detached from capture, watermark
                # frozen — routed around as lagging until resumed
                if rep.state in ("serving", "lagging"):
                    rep.state = "lagging"
                continue
            if rep.state in ("provisioning", "down"):
                if rep.applied_resolved_ts >= rep.catchup_target and \
                        rep.applied_resolved_ts > 0 and \
                        feed is not None and feed.state == "normal":
                    rep.state = "serving"
                    rep._fail_streak = 0
                    rep.next_reprovision = 0.0
                continue
            # serving <-> lagging
            if feed is not None and feed.state == "error":
                rep.state = "lagging"
            elif now - rep.heartbeat > _HEARTBEAT_STALE_S:
                rep.state = "lagging"
            elif sla > 0 and rep.lag_ms() > sla:
                rep.state = "lagging"
            else:
                rep.state = "serving"
        self.refresh_gauges()

    # ---- introspection ------------------------------------------------
    def snapshot(self) -> list:
        """(rid, state, applied_resolved_ts, lag_ms, pending_rows,
        routed_queries) per replica, for the infoschema table."""
        with self._mu:
            reps = list(self.replicas.values())
        feeds = self.domain.cdc.feeds
        out = []
        for rep in reps:
            feed = feeds.get(rep.feed_name)
            pending = feed.pending_rows() if feed is not None else 0
            out.append((rep.rid, rep.state, rep.applied_resolved_ts,
                        round(rep.lag_ms(), 3), pending,
                        rep.routed_queries))
        return out

    def refresh_gauges(self):
        with self._mu:
            reps = list(self.replicas.values())
        for rep in reps:
            lab = str(rep.rid)
            metrics_util.REPLICA_STATE.labels(lab).set(
                _STATE_CODE.get(rep.state, 3))
            metrics_util.REPLICA_LAG.labels(lab).set(
                rep.lag_ms() / 1000.0)

    def serving(self) -> list:
        with self._mu:
            return [r for r in self.replicas.values()
                    if r.state == "serving"]

    # ---- shutdown -----------------------------------------------------
    def shutdown(self):
        """Graceful close: stop supervision first (no reprovision races
        the teardown), then drain each feed — apply every batch the
        capture seam already published at/below the resolved floor —
        and detach the replica domains. After this no worker thread is
        alive and no acked-but-unapplied batch exists."""
        self._stop.set()
        mon = self._monitor
        if mon is not None and mon.is_alive() and \
                mon is not threading.current_thread():
            mon.join(5.0)
        self._monitor = None
        with self._mu:
            reps = list(self.replicas.values())
        for rep in reps:
            feed = self.domain.cdc.feeds.get(rep.feed_name)
            if feed is not None:
                feed.drain()
            rep.state = "down"
        self.refresh_gauges()
