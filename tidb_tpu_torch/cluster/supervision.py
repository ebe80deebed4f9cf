"""Cluster failure detection + fenced failover loop, ported from
tidb_tpu's cluster/supervision.py (reference roles: PD's store
heartbeat stream + the region leader election it triggers, collapsed to
a coordinator-side monitor over the worker fleet).

One daemon thread heartbeats every worker slot on its own short-lived
socket (NEVER the supervised RPC client's socket: a heartbeat parked
behind a long-running call would false-positive). Per slot it runs the
up -> suspect -> down state machine on heartbeat lag; a slot that goes
down is failed over through Cluster._failover (epoch bump + fence +
promote). Deposed primaries keep being probed: one that answers again
is demoted and re-seeded as a WAL-chain follower (Cluster.reintegrate).
The monitor also re-broadcasts the cluster epoch to any live worker
that reports a stale one (a straggler that missed the failover
broadcast rejects data RPCs until it catches up).

Heartbeats ride send_msg/recv_msg, so the cluster/net/* fault seams
apply to them too — a sustained one-direction partition starves the
heartbeat exactly like the real fault would, and failover engages.
"""
from __future__ import annotations

import socket
import threading
import time

from .rpc import send_msg, recv_msg
from ..utils import metrics as _metrics
from ..utils.logutil import log
from ..utils import lockrank

STATE_UP = "up"
STATE_SUSPECT = "suspect"
STATE_DOWN = "down"


class ClusterMonitor:
    def __init__(self, cluster, interval_s=0.5, suspect_after_s=1.5,
                 down_after_s=3.5, auto_failover=True,
                 auto_reintegrate=True, ping_timeout_s=1.0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.suspect_after_s = suspect_after_s
        self.down_after_s = down_after_s
        self.auto_failover = auto_failover
        self.auto_reintegrate = auto_reintegrate
        self.ping_timeout_s = ping_timeout_s
        self.failovers = 0
        self.reintegrations = 0
        self._stop = threading.Event()
        self._mu = lockrank.ranked_lock("cluster.supervision")
        now = time.monotonic()
        self._slots = {i: {"state": STATE_UP, "last_ok": now,
                           "lag": 0.0, "epoch": 0, "fenced": False,
                           "inflight": 0, "dedup_hits": 0,
                           "next_failover": 0.0}
                       for i in range(len(cluster.workers))}
        self._standby_info: dict = {}      # port -> last ping payload
        self._thread = None

    # ---- lifecycle -----------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="cluster-monitor")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # ---- probing -------------------------------------------------------

    def _ping(self, port, extra=None):
        """One-shot heartbeat: fresh socket, short timeout, closed
        after the exchange — a wedged worker costs one timeout, never a
        poisoned long-lived stream."""
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=self.ping_timeout_s)
        try:
            msg = {"op": "ping"}
            if extra:
                msg.update(extra)
            send_msg(sock, msg, op="ping")
            out, _ = recv_msg(sock, op="ping")
            return out
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _push_epoch(self, port):
        """Re-broadcast the cluster epoch to a straggler over a
        one-shot socket (set_epoch is a control op: it adopts)."""
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=self.ping_timeout_s)
        try:
            send_msg(sock, {"op": "set_epoch",
                            "epoch": self.cluster.epoch},
                     op="set_epoch")
            recv_msg(sock, op="set_epoch")
        finally:
            try:
                sock.close()
            except OSError:
                pass

    # ---- the monitor loop ----------------------------------------------

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception as e:          # noqa: BLE001 — the monitor
                # must survive any single bad tick (a failover that
                # found the follower dead too, a racing stop, ...)
                log("warn", "cluster_monitor_tick_error",
                    err=f"{type(e).__name__}: {str(e)[:160]}")

    def _tick(self):
        now = time.monotonic()
        cl = self.cluster
        workers = list(cl.workers)
        for i, w in enumerate(workers):
            st = self._slots.setdefault(
                i, {"state": STATE_UP, "last_ok": now, "lag": 0.0,
                    "epoch": 0, "fenced": False, "inflight": 0,
                    "dedup_hits": 0, "next_failover": 0.0})
            try:
                out = self._ping(w.port)
            except (OSError, ValueError):
                self._miss(i, st, now, w)
                continue
            with self._mu:
                st["last_ok"] = now
                st["lag"] = 0.0
                st["state"] = STATE_UP
                st["epoch"] = int(out.get("epoch", 0))
                st["fenced"] = bool(out.get("fenced"))
                st["inflight"] = int(out.get("inflight", 0))
                st["dedup_hits"] = int(out.get("dedup_hits", 0))
            self._set_gauges(i, 0.0, w)
            if st["epoch"] < cl.epoch:
                # re-broadcast ONLY under the topology lock and only to
                # the slot's CURRENT member: this tick's worker list is
                # a snapshot, and a failover may have deposed this very
                # port since — handing the new epoch to a deposed
                # primary would legalize its WAL ship and let it ack a
                # write the coordinator no longer routes to (the fence
                # TOCTOU; regression-covered by the partitioned-primary
                # test)
                with cl._topo_mu:
                    cur_ok = (i < len(cl.workers)
                              and cl.workers[i].port == w.port
                              and w.port not in cl._deposed)
                    if cur_ok:
                        try:
                            self._push_epoch(w.port)
                        except OSError:
                            pass
        # deposed primaries: probe for rejoin
        for port in list(cl._deposed):
            try:
                out = self._ping(port)
            except OSError:
                continue
            if self.auto_reintegrate:
                try:
                    cl.reintegrate(port)
                    self.reintegrations += 1
                except (OSError, RuntimeError) as e:
                    log("warn", "cluster_rejoin_failed", port=port,
                        err=f"{type(e).__name__}: {str(e)[:120]}")
            else:
                self._standby_info[port] = out
        # reintegrated standbys: keep their health visible
        for port in list(cl._standbys):
            try:
                self._standby_info[port] = self._ping(port)
            except OSError:
                self._standby_info.pop(port, None)

    def _miss(self, i, st, now, w):
        lag = now - st["last_ok"]
        with self._mu:
            st["lag"] = lag
            if lag >= self.down_after_s:
                st["state"] = STATE_DOWN
            elif lag >= self.suspect_after_s:
                st["state"] = STATE_SUSPECT
        self._set_gauges(i, lag, w)
        if st["state"] == STATE_DOWN and self.auto_failover \
                and now >= st["next_failover"]:
            # back off failover attempts: if the follower is dead too,
            # the attempt raises and we must not spin on it
            st["next_failover"] = now + max(self.down_after_s, 2.0)
            if self.cluster.spawn_worker is None:
                return
            log("warn", "cluster_worker_down", slot=i,
                lag_s=round(lag, 2))
            self.cluster._failover(i, reason="heartbeat lost")
            self.failovers += 1
            with self._mu:
                st["state"] = STATE_UP
                st["last_ok"] = time.monotonic()
                st["lag"] = 0.0

    def _set_gauges(self, i, lag, w):
        wid = "%d" % i
        _metrics.CLUSTER_HB_LAG.labels(wid).set(round(lag, 3))
        _metrics.CLUSTER_BREAKER_STATE.labels(wid).set(
            0 if w.breaker.allow() else 1)

    # ---- surfaces ------------------------------------------------------

    def snapshot(self) -> list:
        """-> rows for information_schema.cluster_health: (worker_id,
        addr, state, epoch, role, heartbeat_lag_ms, inflight,
        dedup_hits)."""
        cl = self.cluster
        rows = []
        with self._mu:
            slots = {i: dict(st) for i, st in self._slots.items()}
        workers = list(cl.workers)
        for i, st in sorted(slots.items()):
            if i >= len(workers):
                continue
            role = "primary"
            if st.get("fenced"):
                role = "fenced"
            rows.append((i, "127.0.0.1:%d" % workers[i].port,
                         st["state"], st["epoch"], role,
                         round(st["lag"] * 1000.0, 1), st["inflight"],
                         st["dedup_hits"]))
        for port, out in sorted(self._standby_info.items()):
            rows.append((-1, "127.0.0.1:%d" % port, STATE_UP,
                         int(out.get("epoch", 0)), "follower",
                         0.0, int(out.get("inflight", 0)),
                         int(out.get("dedup_hits", 0))))
        for port, slot in sorted(self.cluster._deposed.items()):
            rows.append((slot, "127.0.0.1:%d" % port, STATE_DOWN,
                         -1, "deposed", -1.0, 0, 0))
        return rows
