"""WAL replication between tidb_tpu_torch cluster workers on the CPU:
twins of the 6 tests of tests/test_replication.py. The acked-durability
contract under test: kill -9 the ONLY process holding a shard's primary
while writes continue — no acknowledged transaction is lost; the
promoted replacement serves the same rows."""
import os
import subprocess
import sys

import pytest

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


@pytest.fixture()
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
        return int(line.split()[1])

    cl = None
    try:
        ports = [spawn(), spawn()]
        from tidb_tpu_torch.cluster import Cluster
        cl = Cluster(ports, spawn_worker=spawn, device="cpu")
        cl.procs = procs
        yield cl
    finally:
        _stop_all(cl, procs)


def test_acked_writes_survive_primary_kill(cluster):
    cluster.enable_replication()
    cluster.ddl("create table wr (a int primary key, b int)")
    # acked transactional writes on worker 0 ONLY (its shard's primary
    # copy is the only one in the cluster)
    cluster.workers[0].call(
        {"op": "load_sql",
         "sqls": ["insert into wr values (1, 10), (2, 20)",
                  "update wr set b = 11 where a = 1",
                  "insert into wr values (3, 30)",
                  "delete from wr where a = 2"]})
    want = [(1, 11), (3, 30)]
    assert cluster.query("select a, b from wr order by a") == want
    # kill -9 the primary; its in-memory store is gone
    victim = cluster.procs[0]
    victim.kill()
    victim.wait(timeout=30)
    # writes continue on the surviving worker while 0 is down
    cluster.workers[1].call(
        {"op": "load_sql", "sqls": ["insert into wr values (100, 1)"]})
    # promotion: replay DDL + the follower's shipped WAL on a fresh
    # process — every acked write is back, including the update/delete
    assert cluster._recover_worker(0) is not None
    assert cluster.query("select a, b from wr order by a") == want
    # the replacement is a full chain member: new acked writes on it
    # survive a SECOND kill of the same slot
    cluster.workers[0].call(
        {"op": "load_sql", "sqls": ["insert into wr values (4, 40)"]})
    victim2 = cluster.procs[-1]
    victim2.kill()
    victim2.wait(timeout=30)
    assert cluster._recover_worker(0) is not None
    assert cluster.query("select a, b from wr order by a") == \
        [(1, 11), (3, 30), (4, 40)]


@pytest.fixture()
def cluster3():
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
        yield cl
    finally:
        _stop_all(cl, procs)


def test_double_failure_primary_then_follower(cluster3):
    """Kill a shard's primary, recover it, then kill the worker that
    was its follower (the one whose shipped WAL fed the recovery) —
    acked writes survive BOTH, and the repaired chain keeps working
    under continued writes (round-5 verdict next #8)."""
    cl = cluster3
    cl.enable_replication()
    cl.ddl("create table df (a int primary key, b int)")

    def port_proc(port):
        return next(p for p in cl.procs if p.poll() is None and
                    p._tidb_port == port)

    acked = {0: [], 1: [], 2: []}   # per slot: each worker is its own
    k = 0                           # store; queries read one worker

    def write(n, worker):
        nonlocal k
        for _ in range(n):
            k += 1
            cl.workers[worker].call(
                {"op": "load_sql",
                 "sqls": [f"insert into df values ({k}, {worker})"]})
            acked[worker].append(k)

    write(20, 0)
    write(20, 1)
    write(20, 2)
    # kill worker 0 (its follower is worker 1)
    p0 = port_proc(cl.workers[0].port)
    p0.kill(); p0.wait(timeout=30)
    assert cl._recover_worker(0) is not None
    write(10, 0)
    # now kill worker 1 — the follower whose WAL just fed 0's recovery
    p1 = port_proc(cl.workers[1].port)
    p1.kill(); p1.wait(timeout=30)
    assert cl._recover_worker(1) is not None
    write(10, 1)
    # and the tail of the chain once more for full coverage
    p2 = port_proc(cl.workers[2].port)
    p2.kill(); p2.wait(timeout=30)
    assert cl._recover_worker(2) is not None
    write(10, 2)
    for w in (0, 1, 2):
        rows = cl.query("select a from df order by a", worker=w)
        assert [r[0] for r in rows] == sorted(acked[w]), f"slot {w}"


def test_commit_latency_under_replication(cluster3):
    """The sync WAL ship runs inside the commit hook: measure acked
    commit latency under concurrent writers and record that the p99
    stays bounded (sanity fence, not a benchmark — the full numbers
    come from scripts/soak_replication.py)."""
    import threading
    import time as _t
    cl = cluster3
    cl.enable_replication()
    cl.ddl("create table lat (a int primary key, b int)")
    lat = []
    seq = [0]
    mu = threading.Lock()
    stop = _t.time() + 4.0

    def writer():
        while _t.time() < stop:
            with mu:
                seq[0] += 1
                kk = seq[0]
            t0 = _t.time()
            cl.workers[kk % 3].call(
                {"op": "load_sql",
                 "sqls": [f"insert into lat values ({kk}, 0)"]})
            lat.append(_t.time() - t0)

    ths = [threading.Thread(target=writer) for _ in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert len(lat) > 30
    lat.sort()
    p99 = lat[int(0.99 * (len(lat) - 1))]
    assert p99 < 2.0, f"p99 commit latency {p99:.3f}s"
    total = sum(cl.query("select count(*) from lat", worker=w)[0][0]
                for w in range(3))
    assert total == len(lat)


def _inproc_worker(port=0, serve=False):
    import threading
    from tidb_tpu_torch.cluster.worker import WorkerServer
    w = WorkerServer(port, device="cpu")
    if serve:
        threading.Thread(target=w.serve_forever, daemon=True).start()
    return w


def test_degrade_reconnect_reseed_caught_up():
    """Direct tier-1 coverage of the degraded-replication seams
    (_enter_degraded_locked / _try_reconnect_locked /
    _seed_follower_locked): a ship failure degrades WITHOUT losing the
    frame, later commits keep queueing, and the reconnect re-seeds the
    follower to an exactly-caught-up log (reset + full history + the
    backlog, no duplicates)."""
    from tidb_tpu_torch.storage.wal import decode_frame_payload
    from tidb_tpu_torch.utils import failpoint
    follower = _inproc_worker(serve=True)
    primary = _inproc_worker()
    primary._set_follower(follower.port, primary=0)
    primary.sess.execute("create table dg (a int primary key, b int)")
    primary.sess.execute("insert into dg values (1, 10)")
    assert len(follower._replica.get(0, [])) == 1
    # ship failure -> degraded: the commit still acks, the frame lands
    # in the backlog, the follower socket is torn down
    failpoint.enable("cluster/net/send", "error:conn_reset")
    try:
        primary.sess.execute("insert into dg values (2, 20)")
    finally:
        failpoint.disable_all()
    assert primary._follower_sock is None
    assert len(primary._unshipped) == 1
    # still degraded (reconnect backoff window): commits keep queueing
    primary.sess.execute("insert into dg values (3, 30)")
    assert len(primary._unshipped) == 2
    # backoff expired: the next commit reconnects and re-seeds — the
    # follower log is RESET and rebuilt from the full shipped history
    # plus the backlog, so it holds every frame exactly once
    primary._reconnect_after = 0.0
    primary.sess.execute("insert into dg values (4, 40)")
    assert primary._follower_sock is not None
    assert primary._unshipped == []
    frames = follower._replica.get(0, [])
    assert len(frames) == 4 == len(primary._shipped)
    assert [bytes(f) for f in frames] == \
        [bytes(f) for f in primary._shipped]
    # promotable: frames decode in strictly increasing commit order
    ts = [decode_frame_payload(f)[0] for f in frames]
    assert ts == sorted(ts) and len(set(ts)) == 4
    primary._stop.set()
    follower._stop.set()
    try:
        follower._sock.close()
    except OSError:
        pass


def test_stop_drains_unshipped_backlog():
    """Satellite: a clean shutdown must not present as acked loss —
    the stop handshake flushes the degraded-mode WAL backlog to the
    follower before the listener closes."""
    from tidb_tpu_torch.cluster.coordinator import _WorkerClient
    from tidb_tpu_torch.utils import failpoint
    follower = _inproc_worker(serve=True)
    primary = _inproc_worker(serve=True)
    primary._set_follower(follower.port, primary=0)
    primary.sess.execute("create table sd (a int primary key)")
    primary.sess.execute("insert into sd values (1)")
    failpoint.enable("cluster/net/send", "error:conn_reset")
    try:
        primary.sess.execute("insert into sd values (2)")
    finally:
        failpoint.disable_all()
    assert len(primary._unshipped) == 1     # acked, degraded, queued
    cli = _WorkerClient(primary.port)
    out, _ = cli.call({"op": "stop"}, retries=0)
    # the drain flushed the backlog before the close
    assert out.get("unshipped") == 0
    frames = follower._replica.get(0, [])
    assert len(frames) == 2                 # nothing lost on shutdown
    follower._stop.set()
    try:
        follower._sock.close()
    except OSError:
        pass


def test_replicated_fragment_query_completes_after_kill(cluster):
    """End-to-end: sharded data + aggregation fan-out; the primary of
    shard 0 dies mid-workload; query_agg recovers it from the
    replicated WAL (not the CSV) and returns the exact answer."""
    import numpy as np
    cluster.enable_replication()
    cluster.ddl("create table li2 (id int primary key, v int)")
    rng = np.random.RandomState(7)
    vals = [(i + 1, int(rng.randint(0, 1000))) for i in range(400)]
    for w, frac in ((0, vals[:200]), (1, vals[200:])):
        cluster.workers[w].call(
            {"op": "load_sql",
             "sqls": ["insert into li2 values " +
                      ",".join(f"({a},{b})" for a, b in frac)]})
    want = [(str(sum(b for _a, b in vals)), 400)]    # SUM(int) renders
    sql = "select sum(v), count(*) from li2"         # as DECIMAL
    got = cluster.query_agg(sql)
    assert [(str(a), b) for a, b in got] == want
    victim = cluster.procs[0]
    victim.kill()
    victim.wait(timeout=30)
    got = cluster.query_agg(sql)       # triggers recovery via WAL
    assert [(str(a), b) for a, b in got] == want
