"""Storage tier: MVCC, snapshot isolation, 2PC conflicts, meta, infoschema.

The twin of tests/test_storage.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.storage import Storage, MemKV
from tidb_tpu_torch.meta import Mutator
from tidb_tpu_torch.infoschema import InfoSchemaCache
from tidb_tpu_torch.models import DBInfo, TableInfo, ColumnInfo
from tidb_tpu_torch.types import new_bigint_type, new_string_type
from tidb_tpu_torch.errors import WriteConflictError, TableExistsError


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def test_memkv_scan():
    kv = MemKV()
    for k in [b"c", b"a", b"b", b"e"]:
        kv.put(k, k + b"!")
    assert [k for k, _ in kv.scan(b"a", b"c")] == [b"a", b"b"]
    assert [k for k, _ in kv.scan(b"b")] == [b"b", b"c", b"e"]
    kv.delete(b"b")
    assert [k for k, _ in kv.scan(b"a")] == [b"a", b"c", b"e"]


def test_snapshot_isolation():
    s = Storage()
    t1 = s.begin()
    t1.set(b"k", b"v1")
    t1.commit()

    t2 = s.begin()          # snapshot after v1
    t3 = s.begin()
    t3.set(b"k", b"v2")
    t3.commit()
    # t2 still sees v1
    assert t2.get(b"k") == b"v1"
    t4 = s.begin()
    assert t4.get(b"k") == b"v2"


def test_write_conflict():
    s = Storage()
    t0 = s.begin()
    t0.set(b"k", b"v0")
    t0.commit()

    t1 = s.begin()
    t2 = s.begin()
    t1.set(b"k", b"v1")
    t2.set(b"k", b"v2")
    t1.commit()
    with pytest.raises(WriteConflictError):
        t2.commit()


def test_txn_buffer_scan_merge():
    s = Storage()
    t0 = s.begin()
    t0.set(b"a", b"1")
    t0.set(b"c", b"3")
    t0.commit()
    t1 = s.begin()
    t1.set(b"b", b"2")
    t1.delete(b"c")
    got = t1.scan(b"a", b"z")
    assert got == [(b"a", b"1"), (b"b", b"2")]


def test_delete_tombstone():
    s = Storage()
    t = s.begin()
    t.set(b"k", b"v")
    t.commit()
    t = s.begin()
    t.delete(b"k")
    t.commit()
    assert s.begin().get(b"k") is None


def _mk_table(m, dbid, name):
    tid = m.gen_global_id()
    tbl = TableInfo(id=tid, name=name, columns=[
        ColumnInfo(id=1, name="id", offset=0, ft=new_bigint_type()),
        ColumnInfo(id=2, name="name", offset=1, ft=new_string_type(64)),
    ])
    m.create_table(dbid, tbl)
    return tbl


def test_meta_and_infoschema():
    s = Storage()
    txn = s.begin()
    m = Mutator(txn)
    dbid = m.gen_global_id()
    m.create_database(DBInfo(id=dbid, name="test"))
    _mk_table(m, dbid, "t1")
    m.gen_schema_version()
    txn.commit()

    cache = InfoSchemaCache(s)
    is1 = cache.current()
    assert is1.has_schema("test")
    t = is1.table_by_name("test", "t1")
    assert [c.name for c in t.columns] == ["id", "name"]
    assert cache.current() is is1  # same version -> cached

    txn = s.begin()
    m = Mutator(txn)
    with pytest.raises(TableExistsError):
        _mk_table(m, dbid, "T1")
    txn.rollback()

    txn = s.begin()
    m = Mutator(txn)
    _mk_table(m, dbid, "t2")
    m.gen_schema_version()
    txn.commit()
    is2 = cache.current()
    assert is2 is not is1
    assert is2.has_table("test", "t2")
    assert not is1.has_table("test", "t2")  # immutability


def test_sysvars():
    from tidb_tpu_torch.session.sysvars import SessionVars
    sv = SessionVars()
    assert sv.tpu_exec is True
    sv.set("tidb_enable_tpu_exec", "off")
    assert sv.tpu_exec is False
    sv.set("tidb_max_chunk_size", 999999999)
    assert sv.max_chunk_size == 1 << 24  # clamped
    g = {}
    sv1, sv2 = SessionVars(g), SessionVars(g)
    sv1.set("tidb_executor_concurrency", 4, is_global=True)
    assert sv2.get("tidb_executor_concurrency") == 4


def test_native_memtable_parity():
    """C++ memtable must behave exactly like the python MemKV."""
    from tidb_tpu_torch.native.memtable import NativeMemKV, native_available
    import random
    if not native_available():
        import pytest
        pytest.skip("no C++ toolchain")
    rng = random.Random(3)
    a, b = NativeMemKV(), MemKV()
    keys = [bytes([rng.randrange(256) for _ in range(rng.randrange(1, 12))])
            for _ in range(500)]
    for i, k in enumerate(keys):
        a.put(k, i)
        b.put(k, i)
    for k in rng.sample(keys, 100):
        a.delete(k)
        b.delete(k)
    assert len(a) == len(b)
    for k in rng.sample(keys, 50):
        assert a.get(k) == b.get(k)
        assert (k in a) == (k in b)
    lo, hi = b"\x10", b"\xd0"
    assert list(a.scan(lo, hi)) == list(b.scan(lo, hi))
    assert list(a.scan(b"")) == list(b.scan(b""))


def test_wal_durability(tmp_path):
    """Commits survive a restart via WAL replay (schema + rows + seqs)."""
    from tidb_tpu_torch.session import new_store, Session
    d = str(tmp_path / "data")
    dom1 = new_store(d, device="cpu")
    s1 = Session(dom1)
    s1.vars.current_db = "test"
    s1.execute("create table w1 (id int primary key, v varchar(8))")
    s1.execute("insert into w1 values (1,'a'),(2,'b')")
    s1.execute("update w1 set v = 'bb' where id = 2")
    s1.execute("delete from w1 where id = 1")
    s1.execute("create sequence ws")
    s1.execute("select nextval(ws)")
    dom1.storage.mvcc.wal.close()

    dom2 = new_store(d, device="cpu")       # bootstrap no-ops; replay restores state
    s2 = Session(dom2)
    s2.vars.current_db = "test"
    rs = s2.execute("select id, v from w1")
    assert rs.rows == [(2, "bb")]
    # sequence continues past the replayed cache chunk
    v = s2.execute("select nextval(ws)").rows[0][0]
    assert v > 1
    # new writes keep working and persist again
    s2.execute("insert into w1 values (9, 'z')")
    dom2.storage.mvcc.wal.close()
    dom3 = new_store(d, device="cpu")
    s3 = Session(dom3)
    s3.vars.current_db = "test"
    assert len(s3.execute("select * from w1").rows) == 2


def test_checkpoint_truncates_wal(tmp_path):
    """ADMIN CHECKPOINT snapshots the MVCC store and truncates the WAL;
    recovery = snapshot + WAL tail (reference: RocksDB snapshot +
    raft-log GC shape)."""
    import os
    from tidb_tpu_torch.session import new_store, Session
    d = str(tmp_path / "data")
    dom1 = new_store(d, device="cpu")
    s1 = Session(dom1)
    s1.vars.current_db = "test"
    s1.execute("create table ck (id int primary key, v varchar(16))")
    s1.execute("insert into ck values (1,'a'),(2,'b')")
    s1.execute("admin checkpoint")
    wal = os.path.join(d, "commit.wal")
    assert os.path.getsize(wal) == 0
    assert os.path.exists(os.path.join(d, "checkpoint.snap"))
    # tail commits after the checkpoint
    s1.execute("insert into ck values (3,'c')")
    s1.execute("update ck set v = 'bb' where id = 2")
    assert os.path.getsize(wal) > 0
    dom1.storage.mvcc.wal.close()

    dom2 = new_store(d, device="cpu")
    s2 = Session(dom2)
    s2.vars.current_db = "test"
    assert s2.execute("select * from ck order by id").rows == [
        (1, "a"), (2, "bb"), (3, "c")]
    # second cycle: checkpoint over a restored store
    s2.execute("admin checkpoint")
    s2.execute("delete from ck where id = 1")
    dom2.storage.mvcc.wal.close()
    dom3 = new_store(d, device="cpu")
    s3 = Session(dom3)
    s3.vars.current_db = "test"
    assert s3.execute("select * from ck order by id").rows == [
        (2, "bb"), (3, "c")]
