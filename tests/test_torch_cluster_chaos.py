"""Cluster fault tolerance of tidb_tpu_torch on the CPU: twins of the
14 tests of tests/test_cluster_chaos.py — every `cluster/net/*` seam
(drop, duplicate, torn frame, trickle, reply loss), the dedup window,
the epoch fence, the breaker, the heartbeat monitor's fenced failover,
the partitioned primary that rejoins as a follower, and the
cluster_health table — over `--cpu` workers and in-process
WorkerServers on the CPU."""
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

from tidb_tpu_torch.cluster.rpc import recv_msg, ClusterTransportError
from tidb_tpu_torch.cluster.worker import WorkerServer
from tidb_tpu_torch.cluster.coordinator import _WorkerClient
from tidb_tpu_torch.errors import ClusterEpochStaleError
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.utils import metrics as _metrics
from tidb_tpu_torch.utils.device_guard import classify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, phase
    from tidb_tpu_torch.utils import failpoint as _fp
    from tidb_tpu_torch.utils import metrics as _mu
    _mu.reset_all()
    device_guard.reset()
    phase.reset()
    _fp.disable_all()
    yield
    _fp.disable_all()


def _stop_all(cl, procs):
    try:
        if cl is not None:
            cl.stop()
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)


# ---- in-process units: transport classification + dedup ----------------

def _inproc_worker():
    w = WorkerServer(0, device="cpu")
    t = threading.Thread(target=w.serve_forever, daemon=True)
    t.start()
    return w


def test_torn_frame_classified_retryable():
    """Satellite regression: a peer that closes after a PARTIAL header
    must surface as ClusterTransportError (classified retryable, op
    attached), not a bare ConnectionError the supervisor can't map."""
    a, b = socket.socketpair()
    try:
        # 2 bytes of the 4-byte json-length prefix, then close
        b.sendall(struct.pack("<I", 999)[:2])
        b.close()
        with pytest.raises(ClusterTransportError) as ei:
            recv_msg(a, op="partial")
        assert classify(ei.value) == "transient"
        assert "partial" in str(ei.value)           # op name attached
        assert "mid-frame" in str(ei.value)
    finally:
        a.close()


def test_clean_close_stays_plain_connection_error():
    """A close BETWEEN frames is the normal end-of-stream: the worker
    serve loop exits on plain ConnectionError, not a torn-frame
    classification."""
    a, b = socket.socketpair()
    try:
        b.close()
        with pytest.raises(ConnectionError) as ei:
            recv_msg(a)
        assert not isinstance(ei.value, ClusterTransportError)
    finally:
        a.close()


def test_torn_frame_mid_arrays_classified():
    """Torn inside the array section (after a complete json) is just
    as classified."""
    a, b = socket.socketpair()
    try:
        payload = b'{"ok": true}'
        b.sendall(struct.pack("<I", len(payload)) + payload +
                  struct.pack("<I", 1) + struct.pack("<I", 5) + b"ab")
        b.close()
        with pytest.raises(ClusterTransportError):
            recv_msg(a, op="wal_append")
    finally:
        a.close()


@pytest.fixture()
def worker():
    w = _inproc_worker()
    cli = _WorkerClient(w.port, epoch_fn=lambda: w.cluster_epoch)
    yield w, cli
    try:
        cli.call({"op": "stop"}, retries=0)
    except Exception:               # noqa: BLE001
        pass


def test_reply_loss_answered_from_dedup_window(worker):
    """THE dedup seam: reply lost AFTER execution -> the retried frame
    is answered from cache; the op ran exactly once."""
    w, cli = worker
    cli.call({"op": "load_sql",
              "sqls": ["create table d1 (a int primary key)"]})
    before = _metrics.REGISTRY.snapshot().get(
        'tidb_tpu_cluster_rpc_dedup_total{op="load_sql"}', 0)
    # thread-filtered injection: the worker runs IN-PROCESS here, so a
    # DSL action on cluster/net/recv races between the client's recv
    # and the worker conn thread's next-frame recv for the nth token.
    # Dropping only on the CLIENT (this) thread — after a delay that
    # lets the worker execute + cache — makes the dedup hit
    # deterministic.
    me = threading.current_thread()
    fired = [False]

    def drop_client_reply_once():
        if threading.current_thread() is not me or fired[0]:
            return
        fired[0] = True
        time.sleep(0.3)
        raise ConnectionResetError("injected reply drop")

    failpoint.enable("cluster/net/recv", drop_client_reply_once)
    try:
        out, _ = cli.call(
            {"op": "load_sql", "sqls": ["insert into d1 values (7)"]})
    finally:
        failpoint.disable_all()
    assert fired[0]
    assert out.get("dedup") is True
    out, _ = cli.call({"op": "query", "sql": "select count(*) from d1"})
    assert out["rows"] == [[1]]
    snap = _metrics.REGISTRY.snapshot()
    assert snap.get('tidb_tpu_cluster_rpc_dedup_total{op="load_sql"}',
                    0) > before


def test_duplicate_frame_exactly_once_and_stream_correlated(worker):
    """A duplicated request frame executes once (dedup) and its extra
    reply is discarded by request-id correlation — the NEXT call gets
    its own answer, not the duplicate's."""
    w, cli = worker
    cli.call({"op": "load_sql",
              "sqls": ["create table d2 (a int primary key)"]})
    failpoint.enable("cluster/net/dup", "nth:1->error")
    try:
        cli.call({"op": "load_sql",
                  "sqls": ["insert into d2 values (1)"]})
    finally:
        failpoint.disable_all()
    out, _ = cli.call({"op": "query", "sql": "select count(*) from d2"})
    assert out["rows"] == [[1]]


def test_send_drop_and_partial_close_retry_clean(worker):
    """Dropped and torn-mid-frame request sends are retried to success;
    the torn frame never half-executes."""
    w, cli = worker
    cli.call({"op": "load_sql",
              "sqls": ["create table d3 (a int primary key)"]})
    failpoint.enable("cluster/net/send", "nth:1->error:conn_reset")
    try:
        cli.call({"op": "load_sql",
                  "sqls": ["insert into d3 values (1)"]})
    finally:
        failpoint.disable_all()
    failpoint.enable("cluster/net/partial-close", "nth:1->error")
    try:
        cli.call({"op": "load_sql",
                  "sqls": ["insert into d3 values (2)"]})
    finally:
        failpoint.disable_all()
    failpoint.enable("cluster/net/trickle", "nth:1->error")
    try:
        out, _ = cli.call({"op": "query",
                           "sql": "select count(*) from d3"})
    finally:
        failpoint.disable_all()
    assert out["rows"] == [[2]]


def test_epoch_mismatch_and_fence_refusal(worker):
    """Data RPCs need an epoch MATCH; control ops move the epoch; a
    fenced (demoted) worker refuses data ops up front."""
    w, cli = worker
    stale = _WorkerClient(w.port, epoch_fn=lambda: 5)
    with pytest.raises(ClusterEpochStaleError):
        stale.call({"op": "query", "sql": "select 1"})
    stale.call({"op": "set_epoch"})         # control op: adopts 5
    out, _ = stale.call({"op": "query", "sql": "select 1"})
    assert out["rows"] == [[1]]
    stale.call({"op": "demote"})
    with pytest.raises(ClusterEpochStaleError):
        stale.call({"op": "query", "sql": "select 1"})
    out, _ = stale.call({"op": "ping"})     # control plane still serves
    assert out["fenced"] is True


def test_breaker_opens_and_fails_fast(worker):
    """Per-worker circuit breaker: after `threshold` consecutive
    transport failures the next call short-circuits without touching
    the socket."""
    w, cli = worker
    cli.breaker.threshold = 3
    cli.breaker.cooldown_s = 30.0
    failpoint.enable("cluster/net/send", "error:conn_reset")
    try:
        for _ in range(3):
            with pytest.raises(OSError):
                cli.call({"op": "query", "sql": "select 1"},
                         retries=0)
    finally:
        failpoint.disable_all()
    assert not cli.breaker.allow()
    with pytest.raises(ClusterTransportError) as ei:
        cli.call({"op": "query", "sql": "select 1"})
    assert "breaker open" in str(ei.value)
    cli.breaker.record_success()            # close it for the fixture's
    assert cli.breaker.allow()              # stop call


def test_stale_degraded_primary_cannot_wipe_follower_log():
    """Regression: a deposed primary that was in DEGRADED mode
    at failover time reconnects later and re-seeds — its wal_reset
    must be REJECTED by the newer-epoch follower (an unfenced reset
    would wipe the log the promoted replacement already re-seeded),
    the triggering write refused un-acked, and the primary fenced."""
    follower = _inproc_worker()
    primary = WorkerServer(0, device="cpu")
    primary._set_follower(follower.port, primary=0)
    primary.sess.execute("create table wz (a int primary key)")
    primary.sess.execute("insert into wz values (1)")
    assert len(follower._replica[0]) == 1
    # primary degrades (ship fault) but keeps acking into its backlog
    failpoint.enable("cluster/net/send", "error:conn_reset")
    try:
        primary.sess.execute("insert into wz values (2)")
    finally:
        failpoint.disable_all()
    assert primary._follower_sock is None
    assert len(primary._unshipped) == 1
    # failover happens while the primary is partitioned: the follower
    # moves to a newer epoch (coordinator control op)
    fctl = _WorkerClient(follower.port, epoch_fn=lambda: 7)
    fctl.call({"op": "set_epoch"})
    frames_before = [bytes(f) for f in follower._replica[0]]
    # the stale primary's reconnect reseed must NOT reset the log
    primary._reconnect_after = 0.0
    with pytest.raises(ClusterEpochStaleError):
        primary.sess.execute("insert into wz values (3)")
    assert [bytes(f) for f in follower._replica[0]] == frames_before
    assert primary._fenced is True
    # and the fence is sticky: the next write is refused immediately
    with pytest.raises(ClusterEpochStaleError):
        primary.sess.execute("insert into wz values (4)")
    primary._stop.set()
    follower._stop.set()
    try:
        follower._sock.close()
    except OSError:
        pass


def test_duplicated_ship_frame_correlated_and_deduped():
    """Regression: WAL-ship replies are rid-correlated — a
    duplicated wal_append frame is absorbed by the follower's dedup
    window (one copy in the log) and its extra reply is discarded as
    a stray, never consumed as the answer to a LATER ship (a stale
    buffered {ok} would make a failed ship look acked = silent
    acked-commit loss at the next promotion)."""
    follower = _inproc_worker()
    primary = WorkerServer(0, device="cpu")
    primary._set_follower(follower.port, primary=0)
    primary.sess.execute("create table sp (a int primary key)")
    failpoint.enable("cluster/net/dup", "nth:1->error")
    try:
        primary.sess.execute("insert into sp values (1)")
    finally:
        failpoint.disable_all()
    assert len(follower._replica[0]) == 1       # deduped, not doubled
    # the stream stays correlated: the next ship discards the stray
    # duplicate reply and reads its own
    primary.sess.execute("insert into sp values (2)")
    assert len(follower._replica[0]) == 2
    assert primary._unshipped == []             # both acked SHIPPED
    primary._stop.set()
    follower._stop.set()
    try:
        follower._sock.close()
    except OSError:
        pass


def test_net_seams_registered():
    """Anti-drift: every net fault seam the gate drives is in the
    failpoint site registry (the tpulint rule enforces the reverse)."""
    from tidb_tpu_torch.utils.failpoint_sites import SITES, NET_SITES
    assert set(NET_SITES) <= set(SITES)
    assert "cluster/rpc" in SITES


# ---- subprocess cluster: failover / fencing / rejoin -------------------

@pytest.fixture(scope="module")
def cluster():
    procs = []
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))

    def spawn():
        p = subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch.cluster.worker", "0",
             "--cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=env, cwd=REPO, text=True)
        procs.append(p)
        line = p.stdout.readline().strip()
        assert line.startswith("WORKER_READY"), line
        p._tidb_port = int(line.split()[1])
        return p._tidb_port

    cl = None
    try:
        ports = [spawn(), spawn(), spawn()]
        from tidb_tpu_torch.cluster import Cluster
        cl = Cluster(ports, spawn_worker=spawn, device="cpu")
        cl.procs = procs
        cl.enable_replication()
        cl.ddl("create table fc (a int primary key, b int)")
        yield cl
    finally:
        _stop_all(cl, procs)


def _proc_of(cl, port):
    return next(p for p in cl.procs
                if p.poll() is None and p._tidb_port == port)


def test_monitor_failover_on_kill(cluster):
    """kill -9 a worker under write load: the heartbeat monitor walks
    suspect->down, runs the fenced failover (epoch bump + promote the
    follower's shipped log), and ZERO acked commits are lost."""
    cl = cluster
    mon = cl.start_supervision(interval_s=0.2, suspect_after_s=0.4,
                               down_after_s=1.0)
    acked = []
    for k in range(1, 31):
        cl.workers[k % 3].call(
            {"op": "load_sql",
             "sqls": [f"insert into fc values ({k}, 0)"]})
        acked.append(k)
    epoch0 = cl.epoch
    victim = _proc_of(cl, cl.workers[1].port)
    victim.kill()
    victim.wait(timeout=30)
    deadline = time.time() + 30
    base = mon.failovers
    while mon.failovers == base and time.time() < deadline:
        time.sleep(0.1)
    assert mon.failovers > base, "monitor never failed the slot over"
    assert cl.epoch > epoch0
    # ledger: every acked key present exactly once, cluster-wide
    have = []
    for wi in range(3):
        have += [r[0] for r in cl.query("select a from fc", worker=wi)]
    assert sorted(have) == sorted(set(have)), "double-applied rows"
    assert set(acked) <= set(have), "acked commits lost"
    snap = _metrics.REGISTRY.snapshot()
    assert snap.get("tidb_tpu_cluster_failover_total", 0) >= 1


def test_partitioned_primary_fenced_then_rejoins_as_follower(cluster):
    """The partition case: the slot fails over while the old primary
    still RUNS. Its next WAL ship is rejected (stale epoch) so the
    write errors un-acked and the worker self-fences; when it answers
    heartbeats again the monitor demotes it and re-seeds it from the
    new primary's WAL — and a later kill of the new primary recovers
    from THAT demoted follower."""
    cl = cluster
    mon = cl._monitor or cl.start_supervision(
        interval_s=0.2, suspect_after_s=0.4, down_after_s=1.0)
    for k in range(200, 210):
        cl.workers[0].call(
            {"op": "load_sql",
             "sqls": [f"insert into fc values ({k}, 1)"]})
    old_port = cl.workers[0].port
    cl.mark_down(0)                 # partition: process stays alive
    zombie = _WorkerClient(old_port)
    with pytest.raises((ClusterEpochStaleError, RuntimeError)):
        zombie.call({"op": "load_sql",
                     "sqls": ["insert into fc values (999, 9)"]})
    out, _ = zombie.call({"op": "ping"})
    assert out["fenced"] is True
    # second attempt refused up front — the fence is sticky
    with pytest.raises(ClusterEpochStaleError):
        zombie.call({"op": "load_sql",
                     "sqls": ["insert into fc values (998, 9)"]})
    # the never-acked write is nowhere in the cluster
    for wi in range(3):
        assert cl.query("select a from fc where a = 999",
                        worker=wi) == []
    # rejoin: the monitor demotes the zombie to slot 0's follower
    deadline = time.time() + 30
    while cl._follower_port.get(0) != old_port and \
            time.time() < deadline:
        time.sleep(0.1)
    assert cl._follower_port.get(0) == old_port, "never reintegrated"
    for k in range(300, 306):
        cl.workers[0].call(
            {"op": "load_sql",
             "sqls": [f"insert into fc values ({k}, 2)"]})
    # kill the NEW primary: recovery must come from the demoted
    # follower's re-seeded log — every acked slot-0 write survives
    old_w = cl.workers[0]
    victim = _proc_of(cl, old_w.port)
    victim.kill()
    victim.wait(timeout=30)
    deadline = time.time() + 30
    while cl.workers[0] is old_w and time.time() < deadline:
        time.sleep(0.1)             # wait for the slot swap, not just
    assert cl.workers[0] is not old_w   # the epoch bump
    rows = [r[0] for r in cl.query(
        "select a from fc where a >= 200", worker=0)]
    assert set(range(200, 210)) <= set(rows)
    assert set(range(300, 306)) <= set(rows)


def test_cluster_health_vtable(cluster):
    """information_schema.cluster_health surfaces the monitor state
    through plain SQL on the coordinator session."""
    cl = cluster
    assert cl._monitor is not None
    time.sleep(0.5)                 # one monitor tick
    rs = cl.sess.execute(
        "select worker_id, state, epoch, role, heartbeat_lag_ms, "
        "inflight, dedup_hits from information_schema.cluster_health")
    rows = rs.rows
    active = [r for r in rows if r[3] == "primary"]
    assert len(active) >= 3
    assert all(r[1] in ("up", "suspect", "down") for r in active)
    # the demoted rejoiner from the previous test shows as a follower
    roles = {r[3] for r in rows}
    assert "follower" in roles or "deposed" in roles
    # heartbeat-lag gauge exported
    snap = _metrics.REGISTRY.snapshot()
    assert any(k.startswith("tidb_tpu_cluster_heartbeat_lag_seconds")
               for k in snap)
