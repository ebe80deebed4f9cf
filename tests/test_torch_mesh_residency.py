"""Sharded residency of tidb_tpu_torch's MPP mesh, on CPU tensors over
eight shards: twins of the mesh tests of tests/test_device_residency.py
(a second mesh statement uploads zero bytes, a DML commit drops only
the written table's sharded entries, the perf_smoke mesh fast slice)
and of tests/test_delta_maintenance.py's TestMeshPlacements (sharded
and replicated entries tail-patched in their placement), plus the
store's charging policy by placement."""
import numpy as np
import pytest

from tidb_tpu_torch.copr.residency import DeviceResidentStore
from tidb_tpu_torch.parallel.mesh import Replicated, Sharded
from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.utils import metrics as mu
from tidb_tpu_torch.utils import phase

NDEV = 8
N_ROWS = 600
AGG_SQL = "select b, sum(c), count(*) from t group by b order by b"


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard
    mu.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def _mesh_tk():
    tk = TestKit(device="cpu", mesh=NDEV)
    tk.must_exec("create table t (a int primary key, b int, c int)")
    vals = ",".join(f"({i}, {i % 7}, {i % 13})" for i in range(N_ROWS))
    tk.must_exec(f"insert into t values {vals}")
    tk.must_exec("set @@tidb_enable_mpp = on")
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    return tk


def _host_rows(tk, sql):
    tk.domain.copr.use_device = False
    try:
        return tk.must_query(sql).rows
    finally:
        tk.domain.copr.use_device = True


def _run_snap(tk, sql):
    phase.reset()
    rows = tk.must_query(sql).rows
    return rows, phase.snap()


def _mpp_marks(m):
    return m.get("copr_mpp_exec", 0) + m.get("fused_pipeline_mpp_hit", 0)


def test_mesh_second_statement_uploads_zero_bytes():
    """The first mesh statement uploads the table partitioned over the
    mesh; the second re-uploads NOTHING."""
    tk = _mesh_tk()
    mpp0 = _mpp_marks(tk.domain.metrics)
    rows1, s1 = _run_snap(tk, AGG_SQL)
    assert _mpp_marks(tk.domain.metrics) > mpp0          # on the mesh
    assert s1.get("upload_bytes", 0) > 0
    st = tk.domain.copr._dev_store.stats()
    assert st["bytes_by_spec"]["sharded"] > 0   # partitioned entries
    rows2, s2 = _run_snap(tk, AGG_SQL)
    assert rows2 == rows1
    assert s2.get("upload_bytes", 0) == 0       # warm: fully resident
    assert s2.get("uploads", 0) == 0
    assert s2.get("upload_hits", 0) > 0
    assert rows1 == _host_rows(tk, AGG_SQL)     # mesh == host


def test_mesh_dml_commit_invalidates_sharded_entries():
    """A DML commit drops ONLY the written table's sharded entries: the
    next mesh statement re-uploads that table (fresh answer) while
    another table's shards stay resident."""
    tk = _mesh_tk()
    tk.must_exec("create table u (a int primary key, b int)")
    tk.must_exec("insert into u values " + ",".join(
        f"({i}, {i % 5})" for i in range(200)))
    other_sql = "select b, count(*) from u group by b order by b"
    tk.must_query(AGG_SQL)
    tk.must_query(other_sql)
    tk.must_exec("update t set c = c + 7 where a = 3")
    rows, s = _run_snap(tk, AGG_SQL)
    assert s.get("upload_bytes", 0) > 0         # t re-uploaded fresh
    assert rows == _host_rows(tk, AGG_SQL)
    _, s2 = _run_snap(tk, other_sql)
    assert s2.get("upload_bytes", 0) == 0       # u untouched: resident


def test_perf_smoke_mesh_fast_slice():
    """The mesh gate of scripts/perf_smoke.py (mesh mode) on the port:
    Q1, Q3, Q6 and Q12 at SF0.01 on eight shards with MPP on hold the
    warm budget (at most 2 dispatches, at most 1 sync, 0 upload bytes),
    equal the host rows, and at least 4 of them route over the mesh."""
    from tidb_tpu_torch.bench.tpch import load_tpch, ALL_QUERIES
    queries = ["q1", "q3", "q6", "q12"]
    tk = TestKit(device="cpu", mesh=NDEV)
    load_tpch(tk, sf=0.01, seed=42)
    tk.must_exec("set @@tidb_enable_mpp = on")
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    host = {q: _host_rows(tk, ALL_QUERIES[q]) for q in queries}
    for q in queries:                    # warmup: builds, uploads,
        tk.must_query(ALL_QUERIES[q])    # learned capacities
    failures, eligible = [], []
    for q in queries:
        before = _mpp_marks(tk.domain.metrics)
        rows, s = _run_snap(tk, ALL_QUERIES[q])
        if _mpp_marks(tk.domain.metrics) != before:
            eligible.append(q)
        if s.get("dispatches", 0) > 2:
            failures.append(f"{q}: {s.get('dispatches')} dispatches")
        if s.get("syncs", 0) > 1:
            failures.append(f"{q}: {s.get('syncs')} syncs")
        if s.get("upload_bytes", 0) > 0:
            failures.append(f"{q}: re-uploaded {s['upload_bytes']} bytes")
        if s.get("mpp_exchanges", 0) < 1:
            failures.append(f"{q}: no exchange")
        if rows != host[q]:
            failures.append(f"{q}: rows differ from the host's")
    assert failures == []
    assert len(eligible) >= 4, eligible


# ---- the store's placement policy --------------------------------------

def test_store_charges_by_placement():
    """Sharded entries charge their own bytes, replicated ones size x
    ndev, local ones size; eviction refunds what was charged."""
    st = DeviceResidentStore(1000)
    st.put(("u", "l"), object(), 100, uid="u")
    st.put(("u", "s"), object(), 100, uid="u", spec="sharded", ndev=8)
    st.put(("u", "r"), object(), 50, uid="u", spec="replicated", ndev=8)
    s = st.stats()
    assert s["bytes_by_spec"] == {"local": 100, "sharded": 100,
                                  "replicated": 400}
    assert st.bytes == 600
    assert st.spec_of(("u", "r")) == "replicated"
    st.invalidate("u")
    assert st.stats()["bytes_by_spec"] == {"local": 0, "sharded": 0,
                                           "replicated": 0}
    with pytest.raises(ValueError):
        st.put(("u", "x"), object(), 1, spec="striped")


# ---- twins of test_delta_maintenance.py TestMeshPlacements -------------

def _mk(n):
    tk = TestKit(device="cpu", mesh=NDEV)
    tk.must_exec("set @@tidb_slow_log_threshold = 100000")
    tk.must_exec("create table t (id int primary key, k int, v int, "
                 "s varchar(16))")
    tk.must_exec("insert into t values " + ",".join(
        f"({i},{i % 7},{i * 3},'s{i % 11}')" for i in range(n)))
    return tk


def _got3(rows):
    return {r[0]: (r[1], int(r[2])) for r in rows}


def _outcome(name):
    return mu.DELTA_APPLY.labels(name).value


def test_sharded_entries_patch_on_mesh():
    """The MPP dense path's sharded fact buffers tail-patch under
    appends: rows identical, placement preserved, delta applied."""
    tk = _mk(3000)
    tk.must_exec("set @@tidb_mpp_min_rows = 0")
    tk.must_exec("set @@tidb_enable_mpp = on")
    q = "select k, count(*), sum(v) from t group by k order by k"
    tk.must_query(q)
    assert _mpp_marks(tk.domain.metrics) > 0
    applied0 = _outcome("applied")
    tk.must_exec("insert into t values " + ",".join(
        f"({i},{i % 7},{i * 3},'s{i % 11}')" for i in range(3000, 3012)))
    r1 = tk.must_query(q).rows
    tk.must_exec("set @@tidb_enable_mpp = off")
    tk.domain.plan_cache.clear()
    assert _got3(r1) == _got3(tk.must_query(q).rows)
    assert _outcome("applied") > applied0
    store = tk.domain.copr._dev_store
    assert store.stats()["bytes_by_spec"]["sharded"] > 0
    sharded = [k for k in list(store._entries)
               if store.spec_of(k) == "sharded"]
    assert sharded and all(isinstance(store.get(k), Sharded)
                           for k in sharded)


def test_replicated_entry_patches():
    """A replicated (broadcast dim) appendable entry patches on every
    device and keeps its replicated placement."""
    from tidb_tpu_torch.copr.delta import append_key
    tk = _mk(1200)
    copr = tk.domain.copr
    mesh = copr._get_mesh()
    assert mesh is not None and mesh.size == NDEV
    info = tk.domain.infoschema().table_by_name("test", "t")
    ctab = tk.domain.columnar.tables[info.id]
    cid = info.find_column("v").id
    cap = 2048
    key = append_key(ctab.uid, ("dim",), cid, "d", ctab.gc_epoch, (), cap)
    copr._dev_put_append(key, ctab.data[cid][:ctab.n], ctab.n, cap,
                         ctab.uid, ctab.version, ctab.gc_epoch, 0, None,
                         mesh=mesh, spec="replicated")
    assert copr._dev_store.spec_of(key) == "replicated"
    tk.must_exec("insert into t values (8000, 3, 424242, 'z')")
    copr.delta.refresh(ctab)
    ent = copr._dev_store.get_appendable(key)
    assert ent is not None
    dev2, rows, ver = ent
    assert rows == ctab.n and ver == ctab.version
    assert isinstance(dev2, Replicated)
    assert dev2.numpy()[ctab.n - 1] == 424242
    assert copr._dev_store.spec_of(key) == "replicated"
    assert set(dev2.copies) == {str(d) for d in mesh.distinct()}


def test_sharded_patch_spans_shards_and_keeps_the_old_buffer():
    """A tail patch that crosses a shard boundary lands in both shards
    of a fresh buffer; the old buffer, which a statement may still
    read, is unchanged."""
    from tidb_tpu_torch.parallel.mesh import Mesh, shard_rows
    mesh = Mesh(["cpu"] * 4)
    base = np.arange(64, dtype=np.int64)
    sh = shard_rows(mesh, base)
    new = sh.patched(np.array([-1, -2, -3], dtype=np.int64), 15)
    want = base.copy()
    want[15:18] = [-1, -2, -3]
    assert new.numpy().tolist() == want.tolist()
    assert sh.numpy().tolist() == base.tolist()
    assert [len(s) for s in new.shards] == [16] * 4


# ---- placement specs and collectives -----------------------------------

def test_placement_specs_place_and_tree():
    """row_sharding / replicated_sharding are the placements the upload
    seam reads; sharding_tree gives row arrays the row placement and
    scalars the replicated one."""
    from tidb_tpu_torch.parallel import (Mesh, replicated_sharding,
                                         row_sharding, sharding_tree)
    mesh = Mesh(["cpu"] * 4)
    arr = np.arange(16, dtype=np.int64)
    sh = row_sharding(mesh).place(arr)
    assert isinstance(sh, Sharded) and sh.full is not None
    assert [s.tolist() for s in sh.shards] == \
        [list(range(i * 4, i * 4 + 4)) for i in range(4)]
    assert sh.numel() * sh.element_size() == arr.nbytes
    rep = replicated_sharding(mesh).place(arr)
    assert isinstance(rep, Replicated) and list(rep.copies) == ["cpu"]
    assert rep.on("cpu").tolist() == arr.tolist()
    tree = sharding_tree({"a": arr, "b": (arr, np.int64(3))}, mesh)
    assert tree["a"].kind == "sharded" and tree["b"][0].kind == "sharded"
    assert tree["b"][1].kind == "replicated"


def test_collectives_in_shard_order():
    """psum adds the shards' partials in shard order (a float sum is
    the same as a left fold over shards 0..N-1), pmax / pmin take the
    extremes, and all_to_all hands destination d row s of what shard s
    sent it."""
    import torch
    from tidb_tpu_torch.parallel import Mesh, all_to_all, pmax, pmin, psum
    mesh = Mesh(["cpu"] * 3)
    parts = [torch.tensor(p, dtype=torch.float64) for p in
             ([1e16, 1.0], [1.0, -1e16], [-1e16, 1e16])]
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(psum(parts, mesh), want)
    assert pmax(parts, mesh).tolist() == [1e16, 1e16]
    assert pmin(parts, mesh).tolist() == [-1e16, -1e16]
    frames = [torch.arange(6).view(3, 2) + 10 * s for s in range(3)]
    got = all_to_all(frames, mesh)
    for d in range(3):
        assert got[d].tolist() == [frames[s][d].tolist() for s in range(3)]


def test_mesh_of_distinct_devices():
    """A mesh whose shards sit on distinct devices (cpu:0..cpu:3: each
    shard its own tensors, copies between devices by .to) takes the
    per-device placement, all_to_all and psum paths, and a fold patches
    only the shards the tail reaches: rows equal the single device's,
    before and after an insert."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.parallel import Mesh
    mesh = Mesh([f"cpu:{i}" for i in range(4)])
    assert len(mesh.distinct()) == 4
    tk = TestKit(device="cpu", mesh=mesh)
    tpch.load_tpch(tk, sf=0.01, seed=7)
    tk.must_exec("set @@tidb_mpp_min_rows = 0")

    def both(sql):
        tk.must_exec("set @@tidb_enable_mpp = off")
        want = tk.must_query(sql)._norm()
        tk.must_exec("set @@tidb_enable_mpp = on")
        m0 = _mpp_marks(tk.domain.metrics)
        assert tk.must_query(sql)._norm() == want
        assert _mpp_marks(tk.domain.metrics) > m0
    for q in ("q1", "q3", "q5"):
        both(tpch.ALL_QUERIES[q])
    store = tk.domain.copr._dev_store
    sharded = [store.get(k) for k in list(store._entries)
               if store.spec_of(k) == "sharded"]
    assert sharded and all(s.full is None for s in sharded)
    tk.must_exec("set @@tidb_broadcast_join_threshold_count = 100")
    both("select o_orderpriority, sum(l_quantity), count(*) from "
         "lineitem, orders where l_orderkey = o_orderkey group by "
         "o_orderpriority order by o_orderpriority")
    tk.must_exec("insert into lineitem select * from lineitem where "
                 "l_orderkey < 10")
    both(tpch.Q1)
