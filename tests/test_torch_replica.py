"""The read-replica fabric on tidb_tpu_torch (tidb_tpu_torch/replica),
on the CPU: the twin of tests/test_replica_fabric.py. Freshness-SLA
routing, zero-error degradation, the DDL barrier,
reprovision-from-checkpoint, and graceful close under write load.
Beside the twins: a CPU leader's mirrors run on the CPU, and a table
with bulk-loaded rows (which no changefeed carries, so a mirror lacks
them) is served by the leader, never by a mirror."""
import threading
import time

import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.utils import metrics as mu


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, phase
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield
    failpoint.disable_all()


def _mk(n_rows=20):
    tk = TestKit(device="cpu")
    tk.must_exec("use test")
    tk.must_exec("create table t (id int primary key, k int, v int, "
                 "s varchar(16))")
    for i in range(n_rows):
        tk.must_exec(f"insert into t values ({i}, {i % 5}, {i * 10}, "
                     f"'x{i}')")
    return tk


def _provision(tk, n=2, timeout=10.0):
    reps = tk.sess.domain.replicas.provision(n)
    deadline = time.time() + timeout
    while time.time() < deadline and \
            any(r.state != "serving" for r in reps):
        time.sleep(0.02)
    assert all(r.state == "serving" for r in reps), \
        [(r.rid, r.state) for r in reps]
    tk.must_exec("set tidb_tpu_analytic_read_mode = 'resolved'")
    return reps


def _route_of(tk):
    return getattr(tk.sess, "_stmt_route", "")


OLAP = "select k, count(*), sum(v) from t group by k order by k"


def _wait_route(tk, sql, want_prefix, timeout=10.0):
    deadline = time.time() + timeout
    rs = tk.must_query(sql)
    while time.time() < deadline and \
            not _route_of(tk).startswith(want_prefix):
        time.sleep(0.02)
        rs = tk.must_query(sql)
    assert _route_of(tk).startswith(want_prefix), _route_of(tk)
    return rs


class TestReplicaRouting:
    def test_routes_to_qualifying_replica(self):
        tk = _mk()
        try:
            _provision(tk, 2)
            leader_rows = None
            # routing is load-balanced: with both serving, repeated
            # statements land on both replicas
            seen = set()
            for _ in range(6):
                rs = tk.must_query(OLAP)
                if leader_rows is None:
                    leader_rows = rs.rows
                assert rs.rows == leader_rows
                seen.add(_route_of(tk))
            assert seen == {"replica-0", "replica-1"}, seen
        finally:
            tk.sess.domain.close()

    def test_paused_feed_routed_around(self):
        """A replica whose feed is paused is not 'serving': the other
        replica takes every statement, rows stay correct."""
        tk = _mk()
        try:
            reps = _provision(tk, 2)
            dom = tk.sess.domain
            dom.cdc.pause(reps[0].feed_name)
            deadline = time.time() + 5
            while time.time() < deadline and reps[0].state == "serving":
                time.sleep(0.02)
            assert reps[0].state != "serving"
            leader = tk.must_query(
                "select id, k, v, s from t order by id").rows
            for _ in range(4):
                rs = tk.must_query(OLAP)
                assert _route_of(tk) == "replica-1"
            rs = tk.must_query("select id, k, v, s from t order by id")
            assert rs.rows == leader
        finally:
            tk.sess.domain.close()

    def test_sla_fallback_to_leader(self):
        """No replica within the freshness SLA -> leader serves, with
        the statement still correct and no error (degradation ladder
        step 1)."""
        tk = _mk()
        try:
            reps = _provision(tk, 2)
            dom = tk.sess.domain
            for r in reps:
                dom.cdc.pause(r.feed_name)
            tk.must_exec("insert into t values (500, 1, 1, 'new')")
            # watermarks are frozen below the new commit; even a huge
            # SLA cannot qualify a paused replica, and a tiny SLA
            # disqualifies on lag — both degrade to the leader
            tk.must_exec("set tidb_tpu_replica_max_lag_ms = 1")
            before = mu.REPLICA_ROUTE.labels("leader_fallback").value
            rs = tk.must_query("select count(*) from t")
            assert _route_of(tk) == "leader_fallback"
            assert rs.rows[0][0] == 21     # the leader sees the insert
            assert mu.REPLICA_ROUTE.labels(
                "leader_fallback").value > before
        finally:
            tk.sess.domain.close()

    def test_midstmt_replica_loss_retries_on_leader(self):
        """The chosen replica dies mid-statement: the router reports it
        to supervision and the leader transparently serves identical
        rows — the client never sees an error."""
        tk = _mk()
        try:
            _provision(tk, 2)
            control = tk.must_query(OLAP).rows
            before = mu.REPLICA_ROUTE.labels("degraded_midstmt").value
            failpoint.enable("replica/mid-stmt", "error")
            try:
                rs = tk.must_query(OLAP)
            finally:
                failpoint.disable("replica/mid-stmt")
            assert rs.rows == control
            assert _route_of(tk) == "degraded_midstmt"
            assert mu.REPLICA_ROUTE.labels(
                "degraded_midstmt").value > before
            # the fabric recovers: replicas serve again
            _wait_route(tk, OLAP, "replica")
        finally:
            tk.sess.domain.close()

    def test_route_pick_error_degrades(self):
        """An error inside route selection itself degrades to the
        leader (never to the client)."""
        tk = _mk()
        try:
            _provision(tk, 1)
            failpoint.enable("replica/route-pick", "error")
            try:
                rs = tk.must_query("select count(*) from t")
            finally:
                failpoint.disable("replica/route-pick")
            assert rs.rows[0][0] == 20
            assert _route_of(tk) == "leader_fallback"
        finally:
            tk.sess.domain.close()


class TestReplicaConsistency:
    def test_replica_rows_equal_leader_at_quiesce(self):
        tk = _mk(50)
        try:
            reps = _provision(tk, 2)
            for i in range(100, 130):
                tk.must_exec(f"insert into t values ({i}, {i % 7}, "
                             f"{i}, 'y{i}')")
            tk.must_exec("update t set v = v + 1 where k = 1")
            tk.must_exec("delete from t where k = 3")
            leader = tk.must_query(
                "select id, k, v, s from t order by id").rows
            deadline = time.time() + 10
            while time.time() < deadline:
                if all(r.sink.mirror_rows("test", "t") == leader
                       for r in reps):
                    break
                time.sleep(0.05)
            for r in reps:
                assert r.sink.mirror_rows("test", "t") == leader
        finally:
            tk.sess.domain.close()

    def test_resolved_read_after_other_writers_converges(self):
        """replica_smoke's quiesce check. Writers on other sessions
        stop; a resolved read of this session (which wrote nothing, so
        any replica within the SLA qualifies) may be served at a
        watermark below their last commits, but it holds only committed
        rows and reaches the leader's within the SLA; the leader-mode
        read has every committed row, and each mirror equals exactly
        those rows (none that was never acknowledged)."""
        tk = _mk(20)
        try:
            reps = _provision(tk, 2)
            stop = threading.Event()
            acked = []

            def writer(i):
                s = tk.new_session()
                k = 1000 * (i + 1)
                while not stop.is_set():
                    k += 1
                    s.must_exec(f"insert into t values ({k}, {k % 5}, "
                                f"{k}, 'w')")
                    acked.append(k)
            ths = [threading.Thread(target=writer, args=(i,))
                   for i in range(4)]
            for t in ths:
                t.start()
            time.sleep(1.0)
            stop.set()
            for t in ths:
                t.join()
            leader_sess = tk.new_session()
            leader_sess.must_exec(
                "set @@tidb_tpu_analytic_read_mode = 'leader'")
            leader = leader_sess.must_query(
                "select id, k, v, s from t order by id").rows
            assert {r[0] for r in leader} == set(range(20)) | set(acked)
            max_lag = int(tk.sess.vars.get("tidb_tpu_replica_max_lag_ms"))
            t0 = time.time()
            while True:
                rs = tk.must_query("select id, k, v, s from t order by id")
                assert set(rs.rows) <= set(leader)
                if rs.rows == leader:
                    break
                assert time.time() - t0 < max_lag / 1000.0 + 5
                time.sleep(0.02)
            deadline = time.time() + 10
            while time.time() < deadline and not all(
                    r.sink.mirror_rows("test", "t") == leader
                    for r in reps):
                time.sleep(0.05)
            for r in reps:
                assert r.sink.mirror_rows("test", "t") == leader
        finally:
            tk.sess.domain.close()

    def test_read_your_writes_in_explicit_txn(self):
        """Explicit-txn reads are leader-clamped (REPEATABLE
        READ): never routed to a replica, own writes visible under the
        resolved contract's rules; after COMMIT the session's reads
        only ride a replica whose watermark covers the commit."""
        tk = _mk()
        try:
            reps = _provision(tk, 1)
            dom = tk.sess.domain
            dom.cdc.pause(reps[0].feed_name)   # freeze the watermark
            tk.must_exec("begin")
            tk.must_exec("insert into t values (900, 1, 1, 'mine')")
            rs = tk.must_query("select count(*) from t")
            assert _route_of(tk) == ""         # clamped: not eligible
            tk.must_exec("commit")
            # the replica's frozen watermark is below the commit: the
            # router MUST NOT serve this session's reads from it
            rs = tk.must_query("select count(*) from t")
            assert _route_of(tk) != "replica-0"
            assert rs.rows[0][0] == 21
            dom.cdc.resume(reps[0].feed_name)
            rs = _wait_route(tk, "select count(*) from t", "replica")
            assert rs.rows[0][0] == 21         # caught up past commit
        finally:
            tk.sess.domain.close()

    def test_ddl_barrier_observed(self):
        """A replica below the DDL barrier is never picked; once the
        schema synced and the watermark covers the barrier, it serves
        with the new schema."""
        tk = _mk()
        try:
            reps = _provision(tk, 1)
            dom = tk.sess.domain
            dom.cdc.pause(reps[0].feed_name)
            tk.must_exec("alter table t add column extra int")
            tk.must_exec(
                "insert into t values (600, 2, 2, 'ddl', 42)")
            rs = tk.must_query("select count(*), sum(extra) from t")
            assert _route_of(tk) == "leader_fallback"
            assert rs.rows[0] == (21, "42")
            dom.cdc.resume(reps[0].feed_name)
            rs = _wait_route(tk,
                             "select count(*), sum(extra) from t",
                             "replica")
            assert rs.rows[0] == (21, "42")
            assert reps[0].applied_resolved_ts >= dom.ddl_barrier_ts
        finally:
            tk.sess.domain.close()


class TestReplicaSupervision:
    def test_kill_reprovisions_from_checkpoint(self):
        """Hard-fail a serving replica: it is routed around instantly,
        auto-reprovisioned from the feed checkpoint (exactly-once apply
        via the persistent sink), and folds back in caught-up."""
        tk = _mk()
        try:
            reps = _provision(tk, 2)
            dom = tk.sess.domain
            dom.replicas.kill(reps[0].rid)
            assert reps[0].state == "down"
            for _ in range(3):   # degradation is transparent meanwhile
                rs = tk.must_query(OLAP)
                route = _route_of(tk)
                # replica-0 may only serve again once reprovisioned
                assert route in ("replica-1", "leader_fallback") or \
                    (route == "replica-0" and
                     reps[0].reprovisions >= 1), route
            tk.must_exec("insert into t values (700, 3, 3, 'post')")
            leader = tk.must_query(
                "select id, k, v, s from t order by id").rows
            deadline = time.time() + 10
            while time.time() < deadline and \
                    reps[0].state != "serving":
                time.sleep(0.02)
            assert reps[0].state == "serving"
            assert reps[0].reprovisions >= 1
            deadline = time.time() + 10
            while time.time() < deadline and \
                    reps[0].sink.mirror_rows("test", "t") != leader:
                time.sleep(0.05)
            assert reps[0].sink.mirror_rows("test", "t") == leader
        finally:
            tk.sess.domain.close()

    def test_reprovision_failpoint_retries(self):
        """An error at the reprovision seam keeps the replica down
        (routed around); once the seam clears, the next monitor tick
        brings it back."""
        tk = _mk()
        try:
            reps = _provision(tk, 1)
            dom = tk.sess.domain
            failpoint.enable("replica/reprovision", "error")
            try:
                dom.replicas.kill(reps[0].rid)
                time.sleep(0.5)
                assert reps[0].state == "down"
                rs = tk.must_query("select count(*) from t")
                assert _route_of(tk) == "leader_fallback"
                assert rs.rows[0][0] == 20
            finally:
                failpoint.disable("replica/reprovision")
            deadline = time.time() + 10
            while time.time() < deadline and \
                    reps[0].state != "serving":
                time.sleep(0.02)
            assert reps[0].state == "serving"
        finally:
            tk.sess.domain.close()


class TestReplicaObservability:
    def test_freshness_rows_and_gauges(self):
        tk = _mk()
        try:
            reps = _provision(tk, 2)
            tk.must_query(OLAP)                 # at least one routed
            rs = tk.must_query(
                "select replica, state, resolved_ts, lag_ms, "
                "pending_delta_rows, routed_queries from "
                "information_schema.tidb_replica_freshness "
                "where replica != 'leader' order by replica")
            assert len(rs.rows) == 2
            for i, (rid, state, resolved, lag, pend, routed) in \
                    enumerate(rs.rows):
                assert rid == str(i)
                assert state == "serving"
                assert resolved > 0 and lag >= 0 and pend >= 0
            assert sum(r[5] for r in rs.rows) >= 1
            # reading the table refreshed the per-replica gauges
            for r in reps:
                assert mu.REPLICA_STATE.labels(
                    str(r.rid)).value == 1.0
                assert mu.REPLICA_LAG.labels(str(r.rid)).value >= 0.0
            # leader per-table rows intact (delta-maintenance compat)
            rs = tk.must_query(
                "select replica, state from information_schema."
                "tidb_replica_freshness where table_name = 't'")
            assert rs.rows == [("leader", "serving")]
        finally:
            tk.sess.domain.close()

    def test_route_in_slow_log_and_top_sql(self):
        tk = _mk()
        try:
            _provision(tk, 1)
            tk.must_exec("set tidb_slow_log_threshold = 0")
            rs = tk.must_query(OLAP)
            route = _route_of(tk)
            assert route.startswith("replica")
            rows = tk.must_query(
                "select replica from information_schema.slow_query "
                "where query like '%group by%' and replica != ''").rows
            assert (route,) in rows
            top = tk.must_query(
                "select replica_reads, leader_fallbacks, "
                "degraded_midstmt from information_schema.tidb_top_sql "
                "where sql_text like '%group by%'").rows
            assert any(r[0] >= 1 for r in top), top
        finally:
            tk.sess.domain.close()


class TestReplicaShutdown:
    def test_close_under_write_load(self):
        """Domain.close() drains replica feeds and joins every worker
        while writes are still landing: no acked-but-unapplied batch
        (mirror == leader at the replica's final watermark), no leaked
        threads."""
        tk = _mk()
        reps = _provision(tk, 2)
        dom = tk.sess.domain
        stop = threading.Event()
        errs = []

        from tidb_tpu_torch.session import Session

        def writer():
            wtk_sess = Session(dom)
            wtk_sess.execute("use test")
            i = 1000
            while not stop.is_set():
                try:
                    wtk_sess.execute(
                        f"insert into t values ({i}, {i % 5}, {i}, "
                        f"'w{i}')")
                except Exception as exc:   # noqa: BLE001
                    errs.append(exc)
                    return
                i += 1

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        time.sleep(0.3)
        dom.close()
        stop.set()
        th.join(5.0)
        assert not errs, errs
        # no leaked workers
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(("cdc-__replica", "replica-"))]
        assert not alive, alive
        # no acked-but-unapplied: everything at/below each replica's
        # final watermark is applied — compare against the leader AT
        # that watermark (writes kept landing above it)
        from tidb_tpu_torch.session import Session
        for r in reps:
            ts = r.applied_resolved_ts
            assert ts > 0
            pin = Session(dom)
            pin.pinned_read_ts = ts
            leader = pin.execute(
                "select id, k, v, s from `test`.`t` order by id").rows
            assert r.sink.mirror_rows("test", "t") == leader

    def test_close_idempotent(self):
        tk = _mk(2)
        tk.sess.domain.close()
        tk.sess.domain.close()


class TestReplicaApplyChaos:
    def test_apply_error_burst_is_exactly_once(self):
        """Error bursts at the apply seam: the feed redelivers with
        classified backoff and the persistent sink applies exactly
        once — final rows identical, no duplicates."""
        tk = _mk()
        try:
            reps = _provision(tk, 1)
            failpoint.enable("replica/apply", "nth:2->error")
            try:
                for i in range(300, 320):
                    tk.must_exec(f"insert into t values ({i}, 1, {i}, "
                                 f"'b{i}')")
            finally:
                failpoint.disable("replica/apply")
            leader = tk.must_query(
                "select id, k, v, s from t order by id").rows
            deadline = time.time() + 10
            while time.time() < deadline and \
                    reps[0].sink.mirror_rows("test", "t") != leader:
                time.sleep(0.05)
            assert reps[0].sink.mirror_rows("test", "t") == leader
        finally:
            tk.sess.domain.close()


class TestReplicaRestart:
    def test_persisted_replica_serves_after_domain_restart(self,
                                                           tmp_path):
        """Regression: a replica rebuilt from its persisted
        __replica_* feed at domain open was never supervised — it
        caught up but sat in 'provisioning' forever (the monitor only
        started from provision()). replicas.resume() must start it."""
        import os
        from tidb_tpu_torch.session import Session, new_store
        dd = os.path.join(str(tmp_path), "dd")
        dom = new_store(dd, device="cpu")
        s = Session(dom)
        s.vars.current_db = "test"
        s.execute("create table t (id int primary key, v int)")
        s.execute("insert into t values (1, 1), (2, 2)")
        reps = dom.replicas.provision(1)
        deadline = time.time() + 10
        while time.time() < deadline and reps[0].state != "serving":
            time.sleep(0.02)
        assert reps[0].state == "serving"
        dom.close()
        dom.storage.mvcc.wal.close()

        dom2 = new_store(dd, device="cpu")
        try:
            s2 = Session(dom2)
            s2.vars.current_db = "test"
            s2.execute("insert into t values (3, 3)")
            reps2 = list(dom2.replicas.replicas.values())
            assert reps2, "persisted feed did not rebuild its replica"
            rep = reps2[0]
            deadline = time.time() + 15
            while time.time() < deadline and rep.state != "serving":
                time.sleep(0.05)
            assert rep.state == "serving", rep.state
            assert rep.sink.mirror_rows("test", "t") == \
                s2.execute("select * from t order by 1").rows
            s2.execute("set @@tidb_tpu_analytic_read_mode = "
                       "'resolved'")
            base = mu.REPLICA_ROUTE.labels("replica").value
            deadline = time.time() + 10
            while time.time() < deadline and \
                    mu.REPLICA_ROUTE.labels("replica").value <= base:
                s2.execute("select v, count(*) from t group by v")
            assert s2._stmt_route == "replica-0"
        finally:
            dom2.close()
            dom2.storage.mvcc.wal.close()


class TestReplicaDevice:
    def test_mirror_of_cpu_leader_is_on_cpu(self):
        """A mirror runs on its leader's device: a CPU leader's mirrors
        (and their executors) are on the CPU and serve routed reads."""
        tk = _mk()
        try:
            reps = _provision(tk, 2)
            for r in reps:
                assert r.mirror.device.type == "cpu"
                assert r.mirror.copr.device.type == "cpu"
            _wait_route(tk, OLAP, "replica")
        finally:
            tk.sess.domain.close()

    def test_bulk_loaded_table_is_not_served_by_a_mirror(self):
        """Rows appended in bulk write no row KV, so neither a feed's
        catch-up scan nor its stream carries them and a mirror
        provisioned after the load lacks them. The router sends reads
        of such a table to the leader (equal rows); a table written
        through DML still rides a replica."""
        import numpy as np
        tk = _mk()
        try:
            tk.must_exec("create table b (id int primary key, k int, "
                         "v int)")
            tk.must_exec("insert into b values (100000, 1, 1)")
            dom = tk.sess.domain
            ctab = dom.columnar.table(
                dom.infoschema().table_by_name("test", "b"))
            n = 500
            ctab.bulk_append({"id": np.arange(n, dtype=np.int64),
                              "k": np.arange(n, dtype=np.int64) % 5,
                              "v": np.arange(n, dtype=np.int64)}, n)
            q = "select k, count(*), sum(v) from b group by k order by k"
            leader = tk.must_query(q).rows
            reps = _provision(tk, 1)
            # the reference's fact: the mirror holds only the DML row
            assert reps[0].sink.mirror_rows("test", "b") == \
                [(100000, 1, 1)]
            m0 = dom.metrics.get("replica_bulk_table_leader", 0)
            for _ in range(3):
                assert tk.must_query(q).rows == leader
                assert not _route_of(tk).startswith("replica")
            assert dom.metrics.get("replica_bulk_table_leader", 0) \
                == m0 + 3
            # a delete of a bulk row reaches the feed as an event; the
            # mirror, which never held the row, applies it and serves on
            tk.must_exec("delete from b where id = 3")
            assert tk.must_query(q).rows != leader
            assert dom.cdc.feeds[reps[0].feed_name].state == "normal"
            _wait_route(tk, OLAP, "replica")
            assert reps[0].sink.mirror_rows("test", "b") == \
                [(100000, 1, 1)]
        finally:
            tk.sess.domain.close()
