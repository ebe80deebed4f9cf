"""Incremental HTAP on tidb_tpu_torch, on CPU tensors: the twin of
tests/test_delta_maintenance.py. Delta maintenance (copr/delta.py and
the residency append seam) must cost O(delta) upload bytes under a
steady OLTP write stream, and resolved-mode analytic statements must
read a consistent committed-data snapshot at the resolved floor, never
the dirty session view. The reference's two mesh tests
(TestMeshPlacements) are twinned in tests/test_torch_mesh_residency.py.
Beside the twins: the fold's upload (pinned, non-blocking on the card;
no pageable Tensor.to and no torch.tensor), the same resolved analytics
under writes on the reference's TestKit and the port's, and the share
of resolved statements that fall back to the leader for staleness under
TPC-H RF1/RF2 writers in both packages."""
import numpy as np
import pytest
import torch

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.utils import metrics as mu
from tidb_tpu_torch.utils import phase


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def _mk(n=2100, name="t"):
    tk = TestKit(device="cpu")
    tk.must_exec("set @@tidb_slow_log_threshold = 100000")
    tk.must_exec(f"create table {name} (id int primary key, k int, "
                 "v int, s varchar(16))")
    tk.must_exec(f"insert into {name} values " + ",".join(
        f"({i},{i % 7},{i * 3},'s{i % 11}')" for i in range(n)))
    return tk


Q = "select k, count(*), sum(v), min(v) from t group by k order by k"


def _expected(rows_kv):
    exp = {}
    for k, v in rows_kv:
        c, s, m = exp.get(k, (0, 0, None))
        exp[k] = (c + 1, s + v, v if m is None else min(m, v))
    return {k: (c, s, m) for k, (c, s, m) in exp.items()}


def _got(rows):
    return {r[0]: (r[1], int(r[2]), int(r[3])) for r in rows}


def _outcome(name):
    return mu.DELTA_APPLY.labels(name).value


class TestAppendFold:
    def test_append_patches_not_reuploads(self):
        """In-bucket appends tail-patch resident buffers: rows stay
        host-identical to a full re-upload and the buffer pool serves
        hits, not misses."""
        tk = _mk()
        rows_kv = [(i % 7, i * 3) for i in range(2100)]
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)
        miss0 = mu.DEV_BUFFER_POOL.labels("miss").value
        applied0 = _outcome("applied")
        total = 2100
        for step in range(4):
            base = 2100 + step * 8
            tk.must_exec("insert into t values " + ",".join(
                f"({i},{i % 7},{i * 3},'s{i % 11}')"
                for i in range(base, base + 8)))
            rows_kv += [(i % 7, i * 3) for i in range(base, base + 8)]
            total += 8
            phase.reset()
            assert _got(tk.must_query(Q).rows) == _expected(rows_kv)
            ph = phase.snap()
            assert ph.get("delta_applies", 0) > 0
            # delta bytes are the REAL appended rows, tiny vs table
            assert ph.get("delta_bytes", 0) <= 8 * 8 * 4
        assert _outcome("applied") > applied0
        # zero full re-uploads after warmup: every bind was a pool hit
        assert mu.DEV_BUFFER_POOL.labels("miss").value == miss0
        assert mu.DELTA_APPLY_BYTES.labels().value > 0
        assert mu.DELTA_REUPLOAD_AVOIDED_BYTES.labels().value > 0

    def test_delta_bytes_small_vs_table(self):
        """Acceptance: delta_apply_bytes after a write burst is far
        below the table's column bytes (O(delta), not O(table))."""
        tk = _mk(4000)
        tk.must_query(Q)
        b0 = mu.DELTA_APPLY_BYTES.labels().value
        tk.must_exec("insert into t values " + ",".join(
            f"({i},{i % 7},{i * 3},'s{i % 11}')"
            for i in range(4000, 4020)))
        tk.must_query(Q)
        dbytes = mu.DELTA_APPLY_BYTES.labels().value - b0
        table_bytes = 4020 * 8 * 3
        assert 0 < dbytes < table_bytes / 20

    def test_tombstone_folding_advances_without_upload(self):
        """DELETE/UPDATE bump the version but touch no column data:
        the fold advances entries in place (outcome=advanced) and the
        next bind re-uploads nothing."""
        tk = _mk()
        rows_kv = [(i % 7, i * 3) for i in range(2100)]
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)
        adv0 = _outcome("advanced")
        miss0 = mu.DEV_BUFFER_POOL.labels("miss").value
        tk.must_exec("delete from t where id < 14")
        phase.reset()
        got = _got(tk.must_query(Q).rows)
        assert got == _expected(rows_kv[14:])
        assert _outcome("advanced") > adv0
        ph = phase.snap()
        assert ph.get("uploads", 0) == 0
        assert mu.DEV_BUFFER_POOL.labels("miss").value == miss0
        # an UPDATE appends a new version row: patch, not re-upload
        tk.must_exec("update t set v = v + 1000000 where id = 20")
        phase.reset()
        got = _got(tk.must_query(Q).rows)
        exp = _expected(rows_kv[14:20] + [(20 % 7, 20 * 3 + 1000000)] +
                        rows_kv[21:])
        assert got == exp
        assert mu.DEV_BUFFER_POOL.labels("miss").value == miss0

    def test_bucket_crossing_falls_back_to_full_upload(self):
        """Growth past the padding bucket cannot patch: the entry is
        superseded (compacted/fell_back) and re-uploaded whole at the
        new capacity — correctness first."""
        tk = _mk(2040)                      # bucket 2048
        rows_kv = [(i % 7, i * 3) for i in range(2040)]
        tk.must_query(Q)
        tk.must_exec("insert into t values " + ",".join(
            f"({i},{i % 7},{i * 3},'s{i % 11}')"
            for i in range(2040, 2080)))     # crosses 2048
        rows_kv += [(i % 7, i * 3) for i in range(2040, 2080)]
        c0 = _outcome("compacted") + _outcome("fell_back_full_upload")
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)
        assert _outcome("compacted") + \
            _outcome("fell_back_full_upload") > c0

    def test_delta_overflow_sysvar_falls_back(self):
        """A delta larger than tidb_tpu_delta_max_rows drops the
        entry for a full re-upload (outcome=fell_back_full_upload)."""
        tk = _mk()
        tk.must_query(Q)
        tk.must_exec("set @@tidb_tpu_delta_max_rows = 4")
        f0 = _outcome("fell_back_full_upload")
        tk.must_exec("insert into t values " + ",".join(
            f"({i},{i % 7},{i * 3},'s{i % 11}')"
            for i in range(2100, 2140)))
        rows_kv = [(i % 7, i * 3) for i in range(2140)]
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)
        assert _outcome("fell_back_full_upload") > f0

    def test_gc_compaction_drops_entries(self):
        """gc() rewrites positions in place: stale-epoch entries must
        be dropped (never patched or advanced), and rows stay right."""
        tk = _mk()
        tk.must_exec("delete from t where id < 50")
        tk.must_query(Q)
        ctab = tk.domain.columnar.tables[
            tk.domain.infoschema().table_by_name("test", "t").id]
        ctab.gc(safepoint=1 << 60)
        tk.must_exec("insert into t values (9001, 1, 7, 'x')")
        rows_kv = [(i % 7, i * 3) for i in range(50, 2100)] + [(1, 7)]
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)


class TestInvalidationRace:
    def test_patched_entry_survives_version_sweep(self):
        """The satellite regression: a delta-advanced entry records
        its new version through to the _by_uid index, so the bind-time
        ``invalidate(uid, keep_version)`` sweep KEEPS it. Without the
        write-through the sweep would drop the very buffer the
        maintainer just patched."""
        from tidb_tpu_torch.copr.residency import DeviceResidentStore
        store = DeviceResidentStore(1 << 20)
        dev = torch.zeros(64, dtype=torch.int64)
        store.put_appendable(("tcol", 1, "frag", 2, "d", 0, 0, 64),
                             dev, 64 * 8, uid=1, version=1, rows=10,
                             start=0, span=None, cap=64, epoch=0)
        # a version-keyed DERIVED entry of the same uid (a valid mask)
        store.put(("mask", 1, 1), dev, 64, uid=1, version=1)
        # maintainer patches: version advances in place
        dev2 = torch.ones(64, dtype=torch.int64)
        assert store.apply_delta(("tcol", 1, "frag", 2, "d", 0, 0, 64),
                                 dev2, 20, 2, expect_rows=10)
        dropped = store.invalidate(1, keep_version=2)
        # the derived entry (version 1) dies, the patched one lives
        assert dropped == 1
        ent = store.get_appendable(("tcol", 1, "frag", 2, "d", 0, 0,
                                    64))
        assert ent is not None and ent[1] == 20 and ent[2] == 2
        # in the port a LATER version sweep keeps it too (the delta fold
        # patches or drops appendable entries; a racing bind may insert
        # one at an older version after the fold ran), and a sweep of
        # the whole uid reclaims it
        assert store.invalidate(1, keep_version=3) == 0
        assert store.get_appendable(("tcol", 1, "frag", 2, "d", 0, 0,
                                     64)) is not None
        assert store.invalidate(1) == 1
        assert store.get_appendable(("tcol", 1, "frag", 2, "d", 0, 0,
                                     64)) is None

    def test_drop_table_drops_appendable_entries(self):
        """What reclaims the appendable entries the version sweep keeps:
        DROP TABLE and TRUNCATE TABLE release the table's device buffers
        at once (its uid is never bound again), appendable ones
        included."""
        tk = _mk()
        tk.must_exec("create table u (id int primary key, k int, v int)")
        tk.must_exec("insert into u select id, k, v from t")
        store = tk.domain.copr._dev_store
        uids = {}
        for name in ("t", "u"):
            tk.must_query(Q.replace("from t", f"from {name}"))
            uids[name] = tk.domain.columnar.tables[
                tk.domain.infoschema().table_by_name("test", name).id].uid
            assert store.appendable_entries(uids[name])
        tk.must_exec("drop table t")
        assert store.appendable_entries(uids["t"]) == []
        assert not store._by_uid.get(uids["t"])
        tk.must_exec("truncate table u")
        assert store.appendable_entries(uids["u"]) == []
        assert tk.must_query("select count(*) from u").rows == [(0,)]

    def test_apply_delta_cas_on_rows(self):
        """Two concurrent folds race: the second apply_delta with a
        stale expect_rows must lose without clobbering the winner."""
        from tidb_tpu_torch.copr.residency import DeviceResidentStore
        store = DeviceResidentStore(1 << 20)
        key = ("tcol", 9, "frag", 1, "d", 0, 0, 64)
        store.put_appendable(key, torch.zeros(64, dtype=torch.int64),
                             64 * 8, uid=9, version=1, rows=10,
                             start=0, span=None, cap=64, epoch=0)
        a = torch.full((64,), 7, dtype=torch.int64)
        b = torch.full((64,), 9, dtype=torch.int64)
        assert store.apply_delta(key, a, 20, 2, expect_rows=10)
        assert not store.apply_delta(key, b, 15, 2, expect_rows=10)
        dev, rows, ver = store.get_appendable(key)
        assert rows == 20 and int(np.asarray(dev)[0]) == 7

    def test_put_appendable_loser_records_no_meta(self):
        """When two binds race the insert, the loser must not record
        its rows against the winner's buffer (overclaimed coverage
        would serve short reads)."""
        from tidb_tpu_torch.copr.residency import DeviceResidentStore
        store = DeviceResidentStore(1 << 20)
        key = ("tcol", 3, "frag", 1, "d", 0, 0, 64)
        store.put_appendable(key, torch.zeros(64, dtype=torch.int64),
                             64 * 8, uid=3, version=1, rows=10,
                             start=0, span=None, cap=64, epoch=0)
        store.put_appendable(key, torch.ones(64, dtype=torch.int64),
                             64 * 8, uid=3, version=1, rows=50,
                             start=0, span=None, cap=64, epoch=0)
        dev, rows, _ver = store.get_appendable(key)
        assert rows == 10 and int(np.asarray(dev)[0]) == 0


class TestResolvedReads:
    def test_never_observes_uncommitted_or_above_watermark(self):
        """A resolved-mode analytic read sees neither an uncommitted
        row (another session's open txn) nor a row committed ABOVE the
        resolved floor held down by an older open transaction."""
        tk = _mk()
        rows_kv = [(i % 7, i * 3) for i in range(2100)]
        tk.must_query(Q)
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        # an open txn holds the floor at its start_ts via FOR UPDATE
        holder = tk.new_session()
        holder.must_exec("begin")
        holder.must_exec("select * from t where id = 1 for update")
        # another session COMMITS a row — its commit_ts > floor
        writer = tk.new_session()
        writer.must_exec("insert into t values (7001, 1, 999, 'w')")
        # and yet another has an UNCOMMITTED buffered row
        dirty = tk.new_session()
        dirty.must_exec("begin")
        dirty.must_exec("insert into t values (7002, 1, 888, 'u')")
        got = _got(tk.must_query(Q).rows)
        assert got == _expected(rows_kv)      # neither row visible
        holder.must_exec("rollback")
        dirty.must_exec("rollback")
        # floor released: the committed row appears
        got = _got(tk.must_query(Q).rows)
        assert got == _expected(rows_kv + [(1, 999)])

    def test_resolved_skips_dirty_overlay_leader_keeps_it(self):
        """mode=resolved retires the dirty-overlay rescan for the
        session's own analytic reads; mode=leader (default) keeps
        read-your-own-writes."""
        tk = _mk()
        tk.must_query(Q)
        rows_kv = [(i % 7, i * 3) for i in range(2100)]
        # leader: in-txn analytic sees the buffered write
        tk.must_exec("begin")
        tk.must_exec("insert into t values (7010, 2, 123, 'x')")
        got = _got(tk.must_query(Q).rows)
        assert got == _expected(rows_kv + [(2, 123)])
        tk.must_exec("rollback")
        # resolved: the same shape reads committed data only
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        r0 = mu.ANALYTIC_READS.labels("resolved").value
        tk.must_exec("begin")
        tk.must_exec("insert into t values (7011, 2, 123, 'x')")
        got = _got(tk.must_query(Q).rows)
        assert got == _expected(rows_kv)
        tk.must_exec("rollback")
        assert mu.ANALYTIC_READS.labels("resolved").value > r0

    def test_resolved_contract_covers_point_and_index_plans(self):
        """The committed-data contract must hold on EVERY plan shape:
        an olap-classified statement planned through batch-point-get
        or an index range must exclude the session's uncommitted
        writes exactly like the full-scan path."""
        tk = _mk()
        tk.must_exec("create index ik on t (k)")
        tk.must_query(Q)
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        tk.must_exec("begin")
        tk.must_exec("insert into t values (9999, 600, 111, 'pp')")
        # batch-point-get under an aggregate (IN over the PK)
        s = tk.must_query(
            "select sum(v) from t where id in (1, 2, 9999)").rows
        assert int(s[0][0]) == 1 * 3 + 2 * 3
        # index-range scan under an aggregate (k = 600 only exists in
        # the dirty buffer)
        s = tk.must_query(
            "select count(*), sum(v) from t where k > 99").rows
        assert (s[0][0], s[0][1]) == (0, None)
        tk.must_exec("rollback")

    def test_explicit_txn_stays_repeatable_read(self):
        """Inside an explicit transaction the resolved floor is
        clamped to the txn's start_ts: a commit from another session
        mid-txn must NOT appear between two analytic statements of the
        same transaction (the view may be stale, never fresher than
        the txn snapshot)."""
        tk = _mk()
        tk.must_query(Q)
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        rows_kv = [(i % 7, i * 3) for i in range(2100)]
        tk.must_exec("begin")
        first = _got(tk.must_query(Q).rows)
        writer = tk.new_session()
        writer.must_exec("insert into t values (7100, 3, 77, 'rr')")
        second = _got(tk.must_query(Q).rows)
        assert second == first == _expected(rows_kv)
        tk.must_exec("commit")
        got = _got(tk.must_query(Q).rows)
        assert got == _expected(rows_kv + [(3, 77)])

    def test_resolved_does_not_block_on_locks(self):
        """An analytic read at the resolved floor never waits on OLTP
        write locks (the decoupling contract)."""
        import time
        tk = _mk()
        tk.must_query(Q)
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        holder = tk.new_session()
        holder.must_exec("begin")
        holder.must_exec("select * from t where id = 3 for update")
        t0 = time.time()
        tk.must_query(Q)
        assert time.time() - t0 < 1.0
        holder.must_exec("rollback")

    def test_staleness_bound_falls_back_to_leader(self):
        """A floor older than the staleness bound keeps the statement
        on the strict leader path (and counts the fallback)."""
        import time
        tk = _mk()
        tk.must_query(Q)
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        tk.must_exec("set @@tidb_tpu_analytic_max_staleness_ms = 50")
        holder = tk.new_session()
        holder.must_exec("begin")
        holder.must_exec("select * from t where id = 3 for update")
        time.sleep(0.12)
        f0 = mu.ANALYTIC_READS.labels("staleness_fallback").value
        tk.must_query(Q)
        assert mu.ANALYTIC_READS.labels("staleness_fallback").value > f0
        holder.must_exec("rollback")

    def test_for_update_stays_strict(self):
        """FOR UPDATE analytics never route to the resolved view."""
        tk = _mk()
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        s0 = mu.ANALYTIC_READS.labels("strict").value
        tk.must_exec("begin")
        tk.must_query("select k, v from t where k > 100 for update")
        tk.must_exec("rollback")
        assert mu.ANALYTIC_READS.labels("strict").value >= s0

    def test_resolved_matches_leader_at_quiesce(self):
        """With no open transactions the resolved floor is current:
        both modes return identical rows (the htap_smoke equivalence
        gate, tier-1 sized)."""
        tk = _mk()
        tk.must_exec("insert into t values (7020, 5, 55, 'q')")
        leader = tk.must_query(Q).rows
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        assert tk.must_query(Q).rows == leader


class TestFreshnessSurface:
    def test_replica_freshness_rows_and_gauge(self):
        tk = _mk()
        tk.must_query(Q)
        tk.must_exec("insert into t values (7030, 0, 1, 'f')")
        rows = tk.must_query(
            "select table_schema, table_name, resolved_ts, lag_ms, "
            "pending_delta_rows, mode from information_schema"
            ".tidb_replica_freshness where table_name = 't'").rows
        assert len(rows) == 1
        sch, name, resolved, lag, pend, mode = rows[0]
        assert (sch, name) == ("test", "t")
        assert resolved > 0 and pend >= 1
        assert mode in ("leader", "resolved")
        # vtable read refreshes the lag gauge
        assert mu.REPLICA_LAG_SECONDS.labels().value >= 0

    def test_top_sql_attributes_delta_cost(self):
        tk = _mk()
        tk.must_query(Q)
        tk.must_exec("insert into t values (7040, 0, 1, 'g')")
        tk.must_query(Q)
        rows = tk.must_query(
            "select delta_applies, delta_bytes from information_schema"
            ".tidb_top_sql where delta_applies > 0").rows
        assert rows and all(r[1] > 0 for r in rows)


class _CardBuffer:
    """A resident buffer as _run_fold sees one on the card: its device
    reads "cuda" while its data stays a CPU tensor, so the fold's
    upload branch for the card runs on a host without one."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda")

    def clone(self):
        return self.t.clone()


class TestBindRaces:
    """Races between binds of concurrent statements and commits, each
    made deterministic: the bind-time sweep and the fold must not drop a
    resident buffer that a full upload would then replace."""

    def test_commit_between_fold_and_sweep_keeps_buffers(self):
        """A commit landing after the fold and before the sweep bumps
        the table version; the sweep at the new version keeps the
        appendable buffers the fold advanced (the next bind patches
        them), while a derived buffer of the old version goes."""
        tk = _mk()
        tk.must_query(Q)
        copr = tk.domain.copr
        store = copr._dev_store
        ctab = tk.domain.columnar.tables[
            tk.domain.infoschema().table_by_name("test", "t").id]
        tk.must_exec("insert into t values (5000, 1, 2, 'x')")
        keys = {e[0] for e in store.appendable_entries(ctab.uid)}
        assert keys
        copr.delta.refresh(ctab)
        store.put(("mask", ctab.uid, ctab.version),
                  torch.zeros(8, dtype=torch.bool), 8, uid=ctab.uid,
                  version=ctab.version)
        ctab.version += 1                   # a commit after the fold
        assert store.invalidate(ctab.uid, ctab.version) == 1
        assert {e[0] for e in store.appendable_entries(ctab.uid)} == keys

    def test_entry_inserted_after_fold_survives_sweep(self):
        """A racing bind may insert a buffer at an older table version
        after a fold ran; the version sweep keeps it (a bind patches or
        advances it in place)."""
        tk = _mk()
        tk.must_query(Q)
        copr = tk.domain.copr
        store = copr._dev_store
        ctab = tk.domain.columnar.tables[
            tk.domain.infoschema().table_by_name("test", "t").id]
        ents = store.appendable_entries(ctab.uid)
        key, dev, rows = ents[0][0], ents[0][1], ents[0][2]
        late = key[:-1] + (key[-1] * 2,)   # the slot at a larger cap
        store.put_appendable(late, dev, 8, uid=ctab.uid,
                             version=ctab.version - 1, rows=rows,
                             start=ents[0][4], span=ents[0][5],
                             cap=key[-1] * 2, epoch=ents[0][7])
        assert store.invalidate(ctab.uid, ctab.version) == 0
        assert store.get_appendable(late) is not None

    def test_fold_behind_a_concurrent_advance_keeps_buffers(self):
        """A fold that read the table's row count before a concurrent
        fold carried the buffers past it sees fewer rows than they hold:
        not a shrink (a gc changes the epoch), so the buffers stay."""
        from types import SimpleNamespace
        tk = _mk()
        tk.must_query(Q)
        copr = tk.domain.copr
        ctab = tk.domain.columnar.tables[
            tk.domain.infoschema().table_by_name("test", "t").id]
        keys = {e[0] for e in copr._dev_store.appendable_entries(ctab.uid)}
        behind = SimpleNamespace(uid=ctab.uid, version=ctab.version + 1,
                                 n=ctab.n - 5, gc_epoch=ctab.gc_epoch,
                                 table_info=ctab.table_info)
        c0 = _outcome("compacted")
        copr.delta.refresh(behind)
        assert _outcome("compacted") == c0
        assert {e[0] for e in copr._dev_store.appendable_entries(
            ctab.uid)} == keys

    def test_concurrent_writes_reupload_only_at_crossings(self):
        """Two analysts and a writer on one table: every resident buffer
        a full upload puts in the store during the writes is a bucket
        crossing's, once per buffer, and the rows equal a fresh read."""
        import threading
        tk = _mk(1900)
        tk.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        tk.must_query(Q)
        store = tk.domain.copr._dev_store
        puts = []
        real = store.put_appendable

        def put(key, dev, *a, **kw):
            # the table's rows when the buffer is put: a statement whose
            # snapshot predates a crossing still needs the old capacity
            n = ctab.n
            real(key, dev, *a, **kw)
            if store._entries.get(key) is dev:  # two racing misses: one
                puts.append((key, n))           # buffer is kept
        store.put_appendable = put
        ctab = tk.domain.columnar.tables[
            tk.domain.infoschema().table_by_name("test", "t").id]
        errors = []
        stop = threading.Event()

        def analyst():
            s = tk.new_session()
            s.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
            try:
                while not stop.is_set():
                    s.must_query(Q)
            except Exception as e:          # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=analyst) for _ in range(2)]
        for t in threads:
            t.start()
        w = tk.new_session()
        for r in range(30):
            w.must_exec("insert into t values " + ",".join(
                f"({i},{i % 7},{i * 3},'w')"
                for i in range(1900 + r * 10, 1910 + r * 10)))
        stop.set()
        for t in threads:
            t.join()
        assert not errors
        # 1900 -> 2200 rows crosses the 2048 bucket once: each buffer
        # is put once at 2560, and at 2048 only after the crossing (by a
        # statement whose snapshot predates it)
        caps = {}
        for k, n in puts:
            caps.setdefault(k[:-1], []).append(k[-1])
            assert k[-1] == 2560 or n > 2048, (k, n)
        assert caps and all(c.count(2560) == 1 for c in caps.values()), \
            caps
        rows_kv = [(i % 7, i * 3) for i in range(2200)]
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)


    def test_dict_table_built_while_the_dictionary_grows(self):
        """A string op's lookup table is built from a copy of the
        dictionary: a commit that grows it meanwhile (a concurrent
        insert of a new string) cannot run the build off its end."""
        from types import SimpleNamespace
        from tidb_tpu_torch.chunk.device import StringDict
        from tidb_tpu_torch.expression import vec
        d = StringDict()
        for w in ("ab", "b", "ac"):
            d.encode_one(w)

        def starts_a(s):
            d.encode_one(s + "!")          # a concurrent commit
            return s.startswith("a")
        ctx = SimpleNamespace(host=True, xp=np)
        tbl = vec._dict_table(ctx, d, starts_a, np.bool_)
        assert tbl.tolist() == [True, False, True]


class TestFoldUpload:
    def test_fold_upload_is_pinned_and_non_blocking(self, monkeypatch):
        """Each padded host delta goes up from pinned memory without
        blocking: the fold makes no pageable Tensor.to to the card and
        no torch.tensor, and still slice-assigns the delta into a clone
        (the old buffer is never written)."""
        from tidb_tpu_torch.copr import delta as dmod
        tk = _mk(64)
        copr = tk.domain.copr
        pinned, moves = set(), []
        real_to = torch.Tensor.to

        def pin_memory(self):
            pinned.add(id(self))
            return self

        def to(self, *a, **kw):
            dev = a[0] if a else kw.get("device")
            if torch.device(dev).type == "cuda":
                moves.append((id(self) in pinned,
                              kw.get("non_blocking", False)))
                return self
            return real_to(self, *a, **kw)

        def no_tensor(*a, **kw):
            raise AssertionError("torch.tensor in the fold")

        old = [torch.arange(8, dtype=torch.int64) * 10,
               torch.zeros(16, dtype=torch.bool)]
        items = [
            dmod._FoldItem("a", _CardBuffer(old[0]), 5, 7, 8,
                           np.array([70, 80, 0], dtype=np.int64), 5, 16),
            dmod._FoldItem("b", _CardBuffer(old[1]), 3, 4, 16,
                           np.array([True, True], dtype=np.bool_), 3, 1)]
        monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
        monkeypatch.setattr(torch.Tensor, "to", to)
        monkeypatch.setattr(torch, "tensor", no_tensor)
        out = copr.delta._run_fold(items)
        monkeypatch.undo()
        assert moves == [(True, True), (True, True)]
        assert out[0].tolist() == [0, 10, 20, 30, 40, 70, 80, 0]
        assert out[1].tolist() == [False] * 3 + [True, True] + \
            [False] * 11
        # the old buffers are untouched
        assert old[0].tolist() == list(range(0, 80, 10))
        assert not old[1].any()

    def test_sql_fold_makes_no_torch_tensor(self, monkeypatch):
        """A fold reached through SQL (an insert, then a warm statement)
        calls no torch.tensor and gives the rows of a full re-upload."""
        from tidb_tpu_torch.copr import delta as dmod
        tk = _mk()
        tk.must_query(Q)
        calls = []
        real = dmod.DeltaMaintainer._run_fold

        def run_fold(self, items):
            def no_tensor(*a, **kw):
                raise AssertionError("torch.tensor in the fold")
            with monkeypatch.context() as m:
                m.setattr(torch, "tensor", no_tensor)
                calls.append(len(items))
                return real(self, items)

        monkeypatch.setattr(dmod.DeltaMaintainer, "_run_fold", run_fold)
        tk.must_exec("insert into t values " + ",".join(
            f"({i},{i % 7},{i * 3},'s{i % 11}')"
            for i in range(2100, 2110)))
        phase.reset()
        rows_kv = [(i % 7, i * 3) for i in range(2110)]
        assert _got(tk.must_query(Q).rows) == _expected(rows_kv)
        assert calls and phase.snap().get("delta_applies", 0) > 0


class TestResolvedParity:
    def test_resolved_analytics_under_writes_match_reference(self):
        """The same SQL on the reference's TestKit and the port's:
        resolved analytics between rounds of inserts, deletes and
        updates, with an open transaction holding the floor in one
        round, give equal rows on both."""
        from tidb_tpu.testkit import TestKit as RefKit
        kits = [RefKit(), TestKit(device="cpu")]
        qs = (Q, "select count(*), sum(v) from t where v between 300 "
                 "and 4000 and k < 5")
        got = [[], []]
        for n, kit in enumerate(kits):
            kit.must_exec(f"create table t (id int primary key, k int, "
                          "v int, s varchar(16))")
            kit.must_exec("insert into t values " + ",".join(
                f"({i},{i % 7},{i * 3},'s{i % 11}')" for i in range(3000)))
            kit.must_exec(
                "set @@tidb_tpu_analytic_read_mode = 'resolved'")
            for q in qs:
                got[n].append(kit.must_query(q)._norm())
            for r in range(4):
                base = 3000 + r * 40
                kit.must_exec("insert into t values " + ",".join(
                    f"({i},{i % 7},{i * 3},'s{i % 11}')"
                    for i in range(base, base + 40)))
                kit.must_exec(f"delete from t where id < {r * 25}")
                kit.must_exec(f"update t set v = v + 1 where k = {r}")
                holder = None
                if r == 2:
                    holder = kit.new_session()
                    holder.must_exec("begin")
                    holder.must_exec(
                        "select * from t where id = 2999 for update")
                    kit.new_session().must_exec(
                        "insert into t values (9000, 1, 5, 'h')")
                for q in qs:
                    got[n].append(kit.must_query(q)._norm())
                if holder is not None:
                    holder.must_exec("rollback")
        assert got[0] == got[1]



def _rf_staleness_shares(pkg, bounds=(5000, 200), rf_orders=750):
    """chip_smoke.py's phase_htap recipe at SF0.01 through one package's
    TestKit: two RF1/RF2 pairs (rf_orders new orders each) from two
    writer threads while, for each staleness bound, two analyst sessions
    run Q1 and Q6 in resolved mode, every other statement in a
    transaction holding an insert. -> {bound: (resolved statements,
    staleness fallbacks)}: each statement's routing decision is read
    under a lock, so the fallback counter's step is its own."""
    import threading
    import chip_smoke as cs
    if pkg == "ref":
        from tidb_tpu.testkit import TestKit as Kit
        from tidb_tpu.bench import tpch
        from tidb_tpu.session.session import Session
        from tidb_tpu.utils import metrics as pmu
        kit = Kit()
    else:
        from tidb_tpu_torch.bench import tpch
        from tidb_tpu_torch.session.session import Session
        pmu = mu
        kit = TestKit(device="cpu")
    tpch.load_tpch(kit, sf=0.01, seed=7)
    first = int(kit.must_query(
        "select max(o_orderkey) from orders").rows[0][0]) + 1
    ncust = int(kit.must_query("select count(*) from customer").rows[0][0])
    rng = np.random.default_rng(7)
    saved = cs.RF_ORDERS
    cs.RF_ORDERS = rf_orders
    try:
        pairs = [cs.rf1_statements(rng, first + r * rf_orders, ncust)[0] +
                 cs.rf2_statements(1 + r * rf_orders) for r in range(2)]
    finally:
        cs.RF_ORDERS = saved
    counter = pmu.ANALYTIC_READS.labels("staleness_fallback")
    counts = {b: [0, 0] for b in bounds}
    lock = threading.Lock()
    orig = Session._maybe_resolved_read

    def decided(self, stmt, plan, ectx):
        with lock:
            f0 = counter.value
            orig(self, stmt, plan, ectx)
            bound = int(self.vars.get("tidb_tpu_analytic_max_staleness_ms"))
            if bound in counts and \
                    self.vars.get("tidb_tpu_analytic_read_mode") == \
                    "resolved":
                counts[bound][0] += 1
                counts[bound][1] += int(counter.value - f0)
    stop = threading.Event()
    errors = []

    def writer(w):
        s = kit.new_session()
        for sql in pairs[w]:
            s.must_exec(sql)

    def analyst(a, bound):
        s = kit.new_session()
        s.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        s.must_exec(f"set @@tidb_tpu_analytic_max_staleness_ms = {bound}")
        i = 0
        try:
            while not stop.is_set():
                dirty = i % 2 == 1
                if dirty:
                    s.must_exec("begin")
                    s.must_exec(cs.DIRTY_ROW)
                s.must_query(tpch.ALL_QUERIES[("q1", "q6")[(a + i) % 2]])
                if dirty:
                    s.must_exec("rollback")
                i += 1
        except Exception as e:              # noqa: BLE001
            errors.append(e)
    analysts = [threading.Thread(target=analyst, args=(a, b))
                for b in bounds for a in range(2)]
    writers = [threading.Thread(target=writer, args=(w,)) for w in range(2)]
    Session._maybe_resolved_read = decided
    try:
        for t in writers + analysts:
            t.start()
        for t in writers:
            t.join()
        stop.set()
        for t in analysts:
            t.join()
    finally:
        Session._maybe_resolved_read = orig
    assert errors == []
    return {b: tuple(c) for b, c in counts.items()}


class TestResolvedStaleness:
    def test_staleness_fallback_share_vs_reference(self, capsys):
        """phase_htap's writers and analysts at SF0.01 on both packages
        (does the port fall back to the leader under writes as the
        reference does?): at the default 5,000 ms bound resolved
        statements almost never fall back in either; at a 200 ms bound,
        which the
        writers' transactions do cross, both packages fall back on some
        statements and serve others resolved. Each package's shares are
        printed (pytest -s) for the record."""
        got = {pkg: _rf_staleness_shares(pkg) for pkg in ("ref", "port")}
        with capsys.disabled():
            print("\nresolved statements, staleness fallbacks by bound: "
                  f"{got}")
        for pkg, by_bound in got.items():
            n, f = by_bound[5000]
            assert n > 0 and f <= 0.05 * n, (pkg, by_bound)
            n, f = by_bound[200]
            assert n > 0 and 0 < f < n, (pkg, by_bound)
