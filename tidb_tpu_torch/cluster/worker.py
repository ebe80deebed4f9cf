"""Cluster worker, ported from tidb_tpu's cluster/worker.py: one
process = one store shard + copr executor (reference role: a
TiKV/TiFlash node serving coprocessor/MPP requests over gRPC —
pkg/store/copr server side; here the transport is cluster/rpc.py and the
compute is the same CoprDAG device path the embedded engine runs, on
this worker's card).

Ops:
  load_sql     {sqls: [...]}                 bootstrap DDL/DML
  load_shard   {table, csv, shard, nshards}  round-robin shard of a file
  partial      {sql}                         plan locally, run the
                                             pushed partial agg, return
                                             serialized partials
  tso          {}                            timestamp from this node's
                                             oracle (PD role when the
                                             worker is the TSO owner)
  prewrite     {muts}/commit {start,commit}  the 2PC seam crossed by RPC
  spmd_init / spmd_frag / spmd_shuffle       the multi-process mesh
  stop         {}

The `partial`, `spmd_frag` and `spmd_shuffle` replies carry meta
fields of the port's own, which the coordinator ignores (_counted):
`launches`, the scan-kernel launches of the request by kernel
(ops/scan_kernels.COUNTS); `phase`, its phase counters (`syncs`,
`spmd_upload_bytes`, `collective_stage_bytes`, ...); `metrics`, the
moves of the Domain's counters; `device`, where the Domain runs;
`peak_bytes`, the process's peak device memory so far.

Entry: `python -m tidb_tpu_torch.cluster.worker PORT [--cpu]` prints
`WORKER_READY <port>`. Its Domain runs on the card unless --cpu is
given; without a card and without --cpu it fails at start.
"""
from __future__ import annotations

import socket
import threading
import time
from collections import deque

import numpy as np
import torch

from .rpc import send_msg, recv_msg, serialize_partials
from ..errors import ClusterEpochStaleError
from ..utils import lockrank

# replies for these ops are never cached in the dedup window: they are
# read-only/idempotent by construction (or, for tso, must stay fresh),
# and partial/spmd replies can be megabytes of serialized agg state
_NO_DEDUP_OPS = frozenset({"partial", "spmd_frag", "spmd_shuffle",
                           "spmd_init", "wal_fetch", "tso",
                           "table_rows", "lease", "ping", "drain"})
# ops a FENCED (demoted) worker still serves: the supervision/rejoin
# control plane plus the follower role (frame store + promotion reads)
_FENCED_OK_OPS = frozenset({"ping", "set_epoch", "demote", "drain",
                            "set_follower", "wal_append", "wal_reset",
                            "wal_fetch"})
_DEDUP_WINDOW = 1024


class WorkerServer:
    def __init__(self, port=0, device=None):
        from ..session import new_store, Session
        self.domain = new_store(device=device)
        self.sess = Session(self.domain)
        self.sess.vars.current_db = "test"
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        # name this node in cross-worker trace trees (SpanEvent.worker;
        # "" stays the coordinator) — the port is the worker's identity
        # everywhere else in the cluster layer too
        self.domain.tracer.worker = f"w{self.port}"
        self._stop = threading.Event()
        self._pending: dict = {}       # start_ts -> prewritten mutations
        from ..owner import LocalLeaseStore
        self._leases = LocalLeaseStore()
        # cluster epoch + fencing (docs/ROBUSTNESS.md "Cluster fault
        # tolerance"): the epoch moves ONLY through coordinator control
        # ops (set_epoch/demote/set_follower). A data request whose
        # epoch doesn't match, a WAL ship from a stale primary, or any
        # data op on a fenced worker raises ClusterEpochStaleError —
        # a partitioned old primary can never ack a write after
        # failover, because its synchronous ship is rejected.
        self.cluster_epoch = 0
        self._fenced = False
        # request dedup window: a supervised client retry whose
        # original REPLY was lost is answered from here instead of
        # re-executed (exactly-once apply under at-least-once send).
        # rid -> ("pending", Event) while executing, ("done", out,
        # arrays) after; FIFO-evicted at _DEDUP_WINDOW entries.
        self._dedup: dict = {}
        self._dedup_order: deque = deque()
        self._dedup_mu = lockrank.ranked_lock("cluster.worker.dedup")
        self._dedup_hits = 0
        self._inflight = 0
        self._inflight_mu = lockrank.ranked_lock("cluster.worker.inflight")
        # ship-RPC correlation: WAL ship/reset frames carry their own
        # request ids so a duplicated frame's extra reply can never
        # shift the primary's reply stream (a stale buffered {ok}
        # would make a later FAILED ship look acked = silent loss),
        # and the follower's dedup window absorbs the duplicate append
        import uuid as _uuid
        self._ship_rid_prefix = "ship-" + _uuid.uuid4().hex[:10]
        self._ship_rid_seq = 0
        # WAL replication (reference: TiKV raft log shipped to
        # followers; here a primary->follower chain assigned by the
        # coordinator). As the PRIMARY: every mvcc commit's data
        # mutations are WAL2-encoded and shipped SYNCHRONOUSLY to the
        # follower inside the commit hook — the commit does not ack
        # until the follower holds the frame, so an acked transaction
        # survives this process's death. As a FOLLOWER: frames are
        # stored per-primary (raft-learner log, NOT applied — this
        # worker's own shard data must not double-count) and handed to
        # the coordinator at promotion time.
        self._follower_sock = None
        self._follower_mu = lockrank.ranked_lock("cluster.worker.follower")
        self._ship_suppressed = False
        self._replica: dict = {}       # primary id -> [frame bytes]
        self._ship_hook_installed = False
        # frames committed while the follower was unreachable (degraded
        # mode — a 2-node chain can't block writes on a dead follower
        # the way a raft majority could); flushed on reconnect
        self._unshipped: list = []
        self._follower_port = None
        self._reconnect_after = 0.0    # monotonic deadline for retry
        # full shipped history, retained so a REPLACED follower can be
        # re-seeded from scratch (its in-memory replica log died with
        # it); bounded by the same in-memory-store lifetime as the data
        # itself
        self._shipped: list = []

    def serve_forever(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                # the wake-up poke from the stop handler (or a client
                # racing shutdown): never serve it
                try:
                    conn.close()
                except OSError:
                    pass
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn):
        try:
            while True:
                msg, arrays = recv_msg(conn)
                op = msg.get("op")
                if op == "stop":
                    # drain-then-close handshake: wait out in-flight
                    # handlers and flush the WAL-ship backlog so a
                    # CLEAN shutdown can never present as acked loss
                    unshipped = self._drain()
                    send_msg(conn, {"ok": True, "unshipped": unshipped})
                    self._stop.set()
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    # closing a listener does NOT wake a thread already
                    # blocked in accept() (the kernel pins the open file
                    # for the syscall's duration, so the port would stay
                    # accepting forever); poke one connection through to
                    # unblock it — serve_forever sees _stop and exits
                    try:
                        socket.create_connection(
                            ("127.0.0.1", self.port), timeout=1).close()
                    except OSError:
                        pass
                    return
                rid = msg.get("rid")
                dedup = rid is not None and op not in _NO_DEDUP_OPS
                if dedup:
                    cached = self._dedup_lookup(rid)
                    if cached is not None:
                        out, out_arrays = cached
                        out = dict(out)
                        out["rid"] = rid
                        out["dedup"] = True
                        send_msg(conn, out, out_arrays, op=str(op))
                        continue
                with self._inflight_mu:
                    self._inflight += 1
                # cross-worker trace adoption: install the caller's
                # context, record this op's spans under it, piggyback
                # the finished events on the reply (the coordinator
                # folds them into its statement trace)
                tctx = msg.get("trace")
                tracer = self.domain.tracer
                if tctx:
                    tracer.install_remote(str(tctx[0]), str(tctx[1]),
                                          bool(tctx[2]))
                try:
                    try:
                        with tracer.span("worker_op", op=str(op)):
                            out, out_arrays = self._handle(op, msg,
                                                           arrays)
                    except Exception as e:          # noqa: BLE001
                        out = {"err": f"{type(e).__name__}: {e}"}
                        if isinstance(e, ClusterEpochStaleError):
                            out["err_kind"] = "stale_epoch"
                        out_arrays = {}
                finally:
                    with self._inflight_mu:
                        self._inflight -= 1
                    if tctx:
                        spans = tracer.uninstall_remote()
                        if spans:
                            out = dict(out)
                            out["spans"] = [list(e) for e in spans]
                if dedup:
                    self._dedup_store(rid, out, out_arrays)
                if rid is not None:
                    out = dict(out)
                    out["rid"] = rid
                send_msg(conn, out, out_arrays, op=str(op))
        except (ConnectionError, OSError):
            pass
        finally:
            # close EXPLICITLY: a lingering reference would withhold the
            # FIN and leave peers blocking a full socket timeout before
            # they notice this worker is gone
            try:
                conn.close()
            except OSError:
                pass

    # ---- request dedup window -----------------------------------------

    def _dedup_lookup(self, rid):
        """-> cached (out, arrays) when this rid already ran (waiting
        out a still-executing first attempt), else None and the caller
        OWNS the execution (a pending marker is in place)."""
        with self._dedup_mu:
            entry = self._dedup.get(rid)
            if entry is None:
                self._dedup[rid] = ("pending", threading.Event())
                return None
        if entry[0] == "pending":
            # a concurrent retry raced the first attempt (its reply was
            # lost mid-execution): wait for the original to finish so
            # the op runs ONCE, then answer from its cached reply
            entry[1].wait(timeout=60)
            with self._dedup_mu:
                entry = self._dedup.get(rid)
            if entry is None or entry[0] == "pending":
                return {"err": "dedup wait timed out"}, {}
        with self._dedup_mu:
            self._dedup_hits += 1
        return entry[1], entry[2]

    def _dedup_store(self, rid, out, out_arrays):
        with self._dedup_mu:
            old = self._dedup.get(rid)
            self._dedup[rid] = ("done", out, out_arrays)
            self._dedup_order.append(rid)
            while len(self._dedup_order) > _DEDUP_WINDOW:
                drop = self._dedup_order.popleft()
                e = self._dedup.get(drop)
                if e is not None and e[0] == "done":
                    del self._dedup[drop]
        if old is not None and old[0] == "pending":
            old[1].set()

    def _drain(self, timeout_s: float = 5.0, own: int = 0) -> int:
        """Satellite: drain-then-close. Wait for in-flight handlers
        (beyond the caller's own, when the caller runs inside _handle)
        and flush any degraded-mode WAL backlog to the follower.
        -> frames still unshipped."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._inflight_mu:
                n = self._inflight
            if n <= own:
                break
            time.sleep(0.01)
        with self._follower_mu:
            if self._unshipped and self._follower_sock is None:
                self._reconnect_after = 0.0
                # the follower socket is OWNED by _follower_mu: ship,
                # reconnect and reseed must serialize against the ship
                # hook or frames interleave on the stream (synchronous
                # replication design, epoch fencing)
                # tpulint: disable=blocking-under-lock — socket owner
                self._try_reconnect_locked()
            return len(self._unshipped)

    def _handle(self, op, msg, arrays):
        # ---- epoch fencing gate ---------------------------------------
        ep = msg.get("epoch")
        if op in ("wal_append", "wal_reset"):
            # a ship OR a log reset from a stale primary is the fencing
            # backstop: the old primary's synchronous ack path dies
            # here, so it can never ack a write after its slot failed
            # over — and a stale primary's reconnect reseed can never
            # WIPE the log the promoted replacement already re-seeded
            # (an unfenced wal_reset would truncate acked history)
            if ep is not None and ep < self.cluster_epoch:
                raise ClusterEpochStaleError(
                    "%s from stale primary epoch %d "
                    "(worker at epoch %d)", op, ep, self.cluster_epoch)
        elif op in ("set_epoch", "demote", "set_follower"):
            # the only ops that MOVE the epoch — coordinator control
            # plane. Data requests never adopt: a zombie would unfence
            # itself by receiving a current-epoch write.
            if ep is not None and ep > self.cluster_epoch:
                self.cluster_epoch = int(ep)
        elif op not in _FENCED_OK_OPS:
            if ep is not None and ep != self.cluster_epoch:
                raise ClusterEpochStaleError(
                    "cluster epoch mismatch: request %d, worker %d "
                    "(topology changed — refresh and re-route)",
                    ep, self.cluster_epoch)
            if self._fenced:
                raise ClusterEpochStaleError(
                    "worker fenced (demoted at epoch %d): data "
                    "requests refused", self.cluster_epoch)
        if op == "ping":
            # heartbeat probe: NEVER rejects and never adopts — the
            # monitor must be able to observe stale/fenced workers
            with self._dedup_mu:
                hits = self._dedup_hits
            with self._inflight_mu:
                infl = self._inflight
            return {"ok": True, "epoch": self.cluster_epoch,
                    "fenced": bool(self._fenced), "inflight": infl - 1,
                    "dedup_hits": hits, "port": self.port,
                    "unshipped": len(self._unshipped)}, {}
        if op == "set_epoch":
            return {"ok": True, "epoch": self.cluster_epoch}, {}
        if op == "demote":
            # rejoin protocol: a failed-over old primary is demoted —
            # sticky fence (only process replacement clears it); it
            # keeps serving the follower role (wal_append/wal_fetch)
            self._fenced = True
            return {"ok": True, "epoch": self.cluster_epoch}, {}
        if op == "drain":
            return {"ok": True,
                    "unshipped": self._drain(own=1)}, {}
        if op == "load_sql":
            for sql in msg["sqls"]:
                self.sess.execute(sql)
            return {"ok": True}, {}
        if op == "load_shard":
            n = self._load_shard(msg)
            return {"ok": True, "rows": n}, {}
        if op == "partial":
            (meta, arrs), counted = _counted(self.domain, lambda:
                                             serialize_partials(
                                                 self._partials(msg["sql"])))
            return {"ok": True, **meta, **counted}, arrs
        if op == "dxf_subtask":
            # per-node DXF task executor (reference
            # dxf/framework/taskexecutor): run a registered task kind
            # against this worker's shard
            from ..dxf.remote import HANDLERS
            fn = HANDLERS.get(msg["kind"])
            if fn is None:
                raise ValueError(f"unknown dxf kind {msg['kind']}")
            return {"ok": True, "result": fn(self, msg["payload"])}, {}
        if op == "table_rows":
            # PHYSICAL row count (includes closed version rows): the
            # SPMD row capacity must cover what snapshot() binds, not
            # just the live rows
            ti = self.domain.infoschema().table_by_name(
                msg.get("db", "test"), msg["table"])
            ctab = self.domain.columnar.table(ti)
            return {"ok": True, "rows": int(ctab.n)}, {}
        if op == "tso":
            return {"ok": True,
                    "ts": self.domain.storage.oracle.get_ts()}, {}
        if op == "prewrite":
            muts = [(bytes(k), bytes(v) if v is not None else None)
                    for k, v in zip(
                        [arrays[f"k{i}"].tobytes()
                         for i in range(msg["n"])],
                        [arrays[f"v{i}"].tobytes()
                         if msg["has_v"][i] else None
                         for i in range(msg["n"])])]
            self.domain.storage.mvcc.prewrite(
                muts, muts[0][0], msg["start_ts"])
            self._pending[msg["start_ts"]] = muts
            return {"ok": True}, {}
        if op == "commit":
            muts = self._pending.pop(msg["start_ts"], None)
            if muts is None:
                raise ValueError(
                    f"commit without prewrite (start_ts "
                    f"{msg['start_ts']})")
            self.domain.storage.mvcc.commit(
                muts, msg["start_ts"], msg["commit_ts"])
            self.domain.storage.oracle.fast_forward(msg["commit_ts"])
            return {"ok": True}, {}
        if op == "query":
            rows = self.sess.execute(msg["sql"]).rows
            return {"ok": True, "rows": [list(map(_py, r))
                                         for r in rows]}, {}
        if op == "spmd_init":
            # join the process group: every worker becomes one rank of a
            # single global mesh (the reference's "one MPP task per
            # store" topology as one process per rank of an SPMD
            # group). Blocks until all peers join — the coordinator fans
            # these out in parallel.
            from ..parallel.dist import init_distributed
            g = init_distributed(msg["coordinator"], msg["nproc"],
                                 msg["pid"], self.domain.copr.device,
                                 int(msg.get("local_shards", 1)))
            from ..utils.logutil import log
            log("info", "spmd_init", **g)
            return {"ok": True,
                    "global_devices": g["world"] * g["local_shards"],
                    "local_devices": g["local_shards"],
                    "backend": g["backend"], "device": g["device"]}, {}
        if op == "spmd_frag":
            # coordinator-broadcast CoprDAG (the DispatchMPPTask seam,
            # copr/mpp.go:94): deserialize the fragment, bind the LOCAL
            # store shard into the global mesh, run the identical
            # program on every rank. The pickle is the coordinator's
            # own broadcast over the cluster's loopback control plane.
            import pickle
            from ..parallel.dist import global_mesh
            from ..mpp.spmd import run_dag_spmd
            dag = pickle.loads(arrays["dag"].tobytes())
            out, counted = _counted(self.domain, lambda: run_dag_spmd(
                self.domain, dag, global_mesh(), int(msg["local_cap"]),
                msg.get("n_groups")))
            arrs = {f"s{i}": np.asarray(a)
                    for i, a in enumerate(out["sums"])}
            arrs["counts"] = np.asarray(out["counts"])
            return {"ok": True, "nsums": len(out["sums"]),
                    **counted}, arrs
        if op == "spmd_shuffle":
            # hash-exchange join fragment across ranks: both sides bound
            # per rank, all_to_all rides the process group; `cap` (the
            # per-peer frame size, skew-safe by construction) comes from
            # the coordinator so every rank runs the same program.
            from ..parallel.dist import global_mesh, bind_host_rows
            from ..mpp.exec import mpp_shuffle_join_agg
            mesh = global_mesh()
            lc = int(msg["local_cap"])
            lb = int(msg["local_cap_build"])

            def b(name, cap):
                return bind_host_rows(mesh, arrays[name], cap)
            (sums, cnts), counted = _counted(
                self.domain, lambda: mpp_shuffle_join_agg(
                    mesh, b("pk", lc), b("pv", lc), b("pok", lc),
                    b("bk", lb), b("bp", lb), b("bok", lb),
                    n_groups=int(msg["n_groups"]), cap=int(msg["cap"])))
            return {"ok": True, **counted}, {"sums": np.asarray(sums),
                                             "counts": np.asarray(cnts)}
        if op == "set_follower":
            self._set_follower(int(msg["port"]), int(msg["primary"]))
            return {"ok": True}, {}
        if op == "wal_append":
            self._replica.setdefault(int(msg["primary"]), []).append(
                arrays["frame"].tobytes())
            return {"ok": True}, {}
        if op == "wal_reset":
            self._replica[int(msg["primary"])] = []
            return {"ok": True}, {}
        if op == "wal_fetch":
            frames = self._replica.get(int(msg["primary"]), [])
            return {"ok": True, "n": len(frames)}, {
                f"f{i}": np.frombuffer(fr, dtype=np.uint8)
                for i, fr in enumerate(frames)}
        if op == "wal_replay":
            from ..storage.wal import decode_frame_payload
            applied = 0
            maxts = 0
            self._ship_suppressed = True
            try:
                for i in range(int(msg["n"])):
                    frame = arrays[f"f{i}"].tobytes()
                    rec = decode_frame_payload(frame)
                    if rec is None:
                        raise ValueError("unrecognized replicated frame")
                    commit_ts, muts, _wall = rec
                    self.domain.storage.mvcc.apply_replay(commit_ts, muts)
                    # promoted history is OURS now: a later chain repair
                    # re-seeds the follower from _shipped, which must
                    # cover everything this store holds
                    self._shipped.append(frame)
                    maxts = max(maxts, commit_ts)
                    applied += 1
            finally:
                self._ship_suppressed = False
            if maxts:
                self.domain.storage.oracle.fast_forward(maxts)
            return {"ok": True, "applied": applied}, {}
        if op == "lease":
            # owner-election authority (PD role; reference
            # owner/manager.go etcd campaign)
            ls = self._leases
            act = msg["action"]
            if act == "acquire":
                return {"ok": True, "granted": ls.acquire(
                    msg["key"], msg["node"], msg["ttl"])}, {}
            if act == "renew":
                return {"ok": True, "granted": ls.renew(
                    msg["key"], msg["node"], msg["ttl"])}, {}
            if act == "resign":
                ls.resign(msg["key"], msg["node"])
                return {"ok": True}, {}
            if act == "holder":
                return {"ok": True, "holder": ls.holder(msg["key"])}, {}
        raise ValueError(f"unknown op {op}")

    def _set_follower(self, port: int, primary: int):
        """Designate the follower this worker ships its commit WAL to,
        and install the ship hook (once). Only DATA mutations (record/
        index keys) ship: the replacement rebuilds schema by replaying
        the coordinator's DDL log, which allocates the same table ids
        from a fresh store — shipping meta KVs too would collide with
        that replay. The follower's log is RESET and re-seeded from this
        primary's full shipped history: a freshly replaced follower
        holds nothing, and a stale one may hold a divergent prefix."""
        from ..codec.tablecodec import TABLE_PREFIX
        with self._follower_mu:
            if self._follower_sock is not None:
                try:
                    self._follower_sock.close()
                except OSError:
                    pass
            self._follower_port = port
            self._follower_sock = socket.create_connection(
                ("127.0.0.1", port), timeout=30)
            self._primary_id = primary
            # reseed streams the full history over the follower socket
            # under its owner lock on purpose: a commit shipping
            # concurrently would land MID-SEED and corrupt the reset
            # log the replacement is rebuilding from
            # tpulint: disable=blocking-under-lock — socket owner
            self._seed_follower_locked()
        if self._ship_hook_installed:
            return

        def ship(commit_ts, mutations):
            if self._ship_suppressed:
                return
            data = [(bytes(k), bytes(v) if v is not None else None)
                    for k, v in mutations
                    if bytes(k).startswith(TABLE_PREFIX)]
            if not data:
                return
            from ..storage.wal import encode_frame_payload
            import time as _t
            payload = encode_frame_payload(commit_ts, data, _t.time())
            with self._follower_mu:
                if self._fenced:
                    # demoted while degraded: a fenced worker must not
                    # keep acking into a backlog that can never flush
                    raise ClusterEpochStaleError(
                        "worker fenced (demoted at epoch %d): write "
                        "refused", self.cluster_epoch)
                if self._follower_sock is None:
                    # degraded: keep acking writes, queue the frame, and
                    # periodically retry the follower — a transient
                    # socket error must not silence replication forever
                    self._unshipped.append(payload)
                    # tpulint: disable=blocking-under-lock — socket owner
                    self._try_reconnect_locked()
                    if self._fenced:
                        # the reconnect discovered the follower at a
                        # NEWER epoch (slot failed over while degraded):
                        # refuse the triggering write un-acked and drop
                        # it from a backlog that will never flush
                        self._unshipped.pop()
                        raise ClusterEpochStaleError(
                            "worker fenced (demoted at epoch %d): "
                            "write refused", self.cluster_epoch)
                    return
                try:
                    self._ship_locked(payload)
                    self._shipped.append(payload)
                except ClusterEpochStaleError:
                    # FENCED: the follower moved to a newer cluster
                    # epoch — this worker's slot failed over while it
                    # was partitioned. It must NOT enter degraded mode
                    # (degraded still acks); the commit surfaces the
                    # fence error and is never acknowledged, and every
                    # later data request is refused up front.
                    self._fenced = True
                    from ..utils.logutil import log
                    log("warn", "wal_ship_fenced",
                        follower_port=self._follower_port,
                        epoch=self.cluster_epoch)
                    raise
                except (ConnectionError, OSError, RuntimeError):
                    # RuntimeError = follower replied {err}: same
                    # degraded handling — the frame must land in the
                    # backlog, never vanish (an acked commit whose
                    # frame was dropped would be lost on promotion)
                    self._enter_degraded_locked(payload)

        self.domain.storage.mvcc.commit_hooks.append(ship)
        self._ship_hook_installed = True

    def _enter_degraded_locked(self, payload: bytes):
        from ..utils.logutil import log
        try:
            self._follower_sock.close()
        except OSError:
            pass
        self._follower_sock = None
        self._unshipped.append(payload)
        import time as _t
        self._reconnect_after = _t.monotonic() + 1.0
        log("warn", "wal_replication_degraded",
            follower_port=self._follower_port,
            queued=len(self._unshipped))

    def _try_reconnect_locked(self):
        import time as _t
        if self._fenced or self._follower_port is None or \
                _t.monotonic() < self._reconnect_after:
            return
        self._reconnect_after = _t.monotonic() + 1.0
        try:
            self._follower_sock = socket.create_connection(
                ("127.0.0.1", self._follower_port), timeout=5)
            self._seed_follower_locked()
            if self._follower_sock is not None and not self._fenced:
                from ..utils.logutil import log
                log("info", "wal_replication_restored",
                    follower_port=self._follower_port)
        except OSError:
            self._follower_sock = None

    def _seed_follower_locked(self):
        """Reset the follower's log for this primary and stream the full
        shipped history + any degraded-mode backlog (follower_mu held).
        On failure the backlog stays queued and we re-enter degraded.
        The reset carries this primary's epoch: a follower at a newer
        epoch rejects it, which FENCES this primary — a deposed
        primary's reconnect must never wipe the log the promoted
        replacement already re-seeded."""
        try:
            out = self._ship_rpc(
                {"op": "wal_reset", "primary": self._primary_id,
                 "epoch": self.cluster_epoch})
            if out.get("err_kind") == "stale_epoch":
                raise ClusterEpochStaleError(
                    "wal reset rejected: %s", out.get("err", ""))
            if "err" in out:
                raise RuntimeError(out["err"])
            for payload in self._shipped:
                self._ship_locked(payload)
            while self._unshipped:
                payload = self._unshipped[0]
                self._ship_locked(payload)
                self._shipped.append(payload)
                self._unshipped.pop(0)
        except ClusterEpochStaleError:
            # the follower moved to a newer epoch: this worker's slot
            # failed over while it was degraded. Fence (sticky) instead
            # of re-entering the degraded retry loop — callers observe
            # _fenced and refuse the triggering write.
            self._fenced = True
            from ..utils.logutil import log
            log("warn", "wal_ship_fenced",
                follower_port=self._follower_port,
                epoch=self.cluster_epoch)
            try:
                self._follower_sock.close()
            except OSError:
                pass
            self._follower_sock = None
        except (ConnectionError, OSError, RuntimeError):
            try:
                self._follower_sock.close()
            except OSError:
                pass
            self._follower_sock = None

    def _ship_rpc(self, msg: dict, arrays: dict | None = None) -> dict:
        """One correlated request/reply on the follower socket
        (follower_mu held): stamp a ship rid, read until the matching
        reply, discard strays — an injected duplicate frame's extra
        {ok} must never be consumed as the answer to a LATER (possibly
        failed) ship. The rid also routes the duplicate through the
        follower's dedup window instead of double-appending."""
        self._ship_rid_seq += 1
        rid = f"{self._ship_rid_prefix}:{self._ship_rid_seq}"
        msg = dict(msg)
        msg["rid"] = rid
        op = str(msg.get("op"))
        send_msg(self._follower_sock, msg, arrays, op=op)
        for _ in range(8):
            out, _ = recv_msg(self._follower_sock, op=op)
            r = out.get("rid")
            if r is None or r == rid:
                return out
        raise RuntimeError(f"no reply correlated to ship {rid} ({op})")

    def _ship_locked(self, payload: bytes):
        """Send one WAL frame to the follower (follower_mu held). The
        frame carries this primary's cluster epoch; a follower at a
        NEWER epoch rejects it, which fences this primary."""
        out = self._ship_rpc(
            {"op": "wal_append", "primary": self._primary_id,
             "epoch": self.cluster_epoch},
            {"frame": np.frombuffer(payload, dtype=np.uint8)})
        if out.get("err_kind") == "stale_epoch":
            raise ClusterEpochStaleError(
                "wal ship rejected: %s", out.get("err", ""))
        if "err" in out:
            raise RuntimeError(f"wal replication failed: {out['err']}")

    def _load_shard(self, msg):
        """Round-robin rows of a CSV into this worker's shard of the
        table (the data-placement role of PD + region split)."""
        shard, nshards = msg["shard"], msg["nshards"]
        rows = []
        with open(msg["csv"]) as f:
            for i, line in enumerate(f):
                if i % nshards == shard and line.strip():
                    rows.append(line.strip())
        if not rows:
            return 0
        vals = ",".join(f"({r})" for r in rows)
        self.sess.execute(f"insert into {msg['table']} values {vals}")
        return len(rows)

    def _partials(self, sql):
        """Plan the statement locally and drive the pushed partial-agg
        reader over THIS shard (the coprocessor-request role)."""
        from ..parser import parse
        from ..planner.optimize import optimize
        from ..planner.physical import PhysHashAgg
        from ..executor.builder import build_executor
        from ..executor.exec_base import ExecContext
        stmt = parse(sql)[0]
        plan = optimize(stmt, self.sess._plan_ctx())
        node = plan
        while node is not None and not isinstance(node, PhysHashAgg):
            node = node.children[0] if node.children else None
        if node is None:
            raise ValueError("no aggregation in fragment sql")
        ectx = ExecContext(self.sess)
        try:
            agg = build_executor(ectx, node)
            return agg.children[0].partials()
        finally:
            ectx.finish()


def _counted(domain, fn):
    """Run one request's work with the calling thread's phase counters
    reset -> (result, meta): "launches", the scan-kernel launches by
    kernel; "phase", the request's phase counters; "metrics", the moves
    of the Domain's counters (routes, fallbacks, degrades); "device",
    where the Domain runs. Launches and Domain counters are
    process-wide: a concurrent request on another connection would add
    its own."""
    from ..ops import scan_kernels
    from ..utils import phase
    phase.reset()
    before = dict(scan_kernels.COUNTS)
    m0 = dict(domain.metrics)
    out = fn()
    launches = {k: scan_kernels.COUNTS[k] - before[k] for k in before}
    moved = {k: v - m0.get(k, 0) for k, v in domain.metrics.items()
             if isinstance(v, (int, float)) and v != m0.get(k, 0)}
    dev = domain.copr.device
    return out, {"launches": launches, "metrics": moved,
                 "device": str(dev),
                 "peak_bytes": torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else 0,
                 "phase": {k: v for k, v in phase.snap().items()
                           if isinstance(v, (int, float))}}


def _py(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def serve_worker(port, device=None):
    """Entry for `python -m tidb_tpu_torch.cluster.worker PORT [--cpu]`."""
    w = WorkerServer(port, device=device)
    print(f"WORKER_READY {w.port}", flush=True)
    w.serve_forever()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(prog="python -m tidb_tpu_torch.cluster."
                                 "worker")
    ap.add_argument("port", nargs="?", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the worker's Domain on the host")
    args = ap.parse_args()
    serve_worker(args.port, device="cpu" if args.cpu else None)
