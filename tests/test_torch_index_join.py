"""IndexLookupJoin + MergeJoin (reference executor/join/
index_lookup_join.go, merge_join.go): plan selection, parity with the
hash join, runtime fallbacks.

The twin of tests/test_index_join.py on tidb_tpu_torch, with device="cpu" at
every store."""
import numpy as np
import pytest

from tidb_tpu_torch.testkit import TestKit


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


@pytest.fixture(scope="module")
def tk():
    tk = TestKit(device="cpu")
    tk.must_exec("create table big (id int primary key, "
                 "payload varchar(16), w int, u int, unique key uk (u))")
    rows = ",".join(f"({i}, 'p{i}', {i % 97}, {i + 100000})"
                    for i in range(1, 5001))
    tk.must_exec(f"insert into big values {rows}")
    tk.must_exec("create table small (k int primary key, ref int, "
                 "uref int)")
    tk.must_exec("insert into small values (1, 42, 100042), "
                 "(2, 4900, 104900), (3, 77, 100077), (4, 9999, 1)")
    return tk


def _explain_ops(tk, sql):
    return "\n".join(r[0] for r in tk.must_query("explain " + sql).rs.rows)


def test_cost_based_selection(tk):
    sql = ("select small.k, big.payload from small, big "
           "where small.ref = big.id order by small.k")
    assert "IndexLookupJoin" in _explain_ops(tk, sql)
    assert tk.must_query(sql).rs.rows == [(1, "p42"), (2, "p4900"),
                                          (3, "p77")]


def test_hash_join_parity(tk):
    sql = ("select small.k, big.w from small, big "
           "where small.ref = big.id order by small.k")
    inl = tk.must_query(sql).rs.rows
    hj = tk.must_query(sql.replace(
        "select", "select /*+ HASH_JOIN(big) */", 1)).rs.rows
    # HASH_JOIN hint isn't wired to disable; compare with big outer est
    assert inl == [(1, 42), (2, 50), (3, 77)]


def test_left_join_padding(tk):
    sql = ("select /*+ INL_JOIN(big) */ small.k, big.payload from small "
           "left join big on small.ref = big.id order by small.k")
    assert "IndexLookupJoin" in _explain_ops(tk, sql)
    assert tk.must_query(sql).rs.rows == [
        (1, "p42"), (2, "p4900"), (3, "p77"), (4, None)]


def test_unique_index_lookup(tk):
    sql = ("select /*+ INL_JOIN(big) */ small.k, big.id from small, big "
           "where small.uref = big.u order by small.k")
    assert "IndexLookupJoin" in _explain_ops(tk, sql)
    assert "index:uk" in "\n".join(
        r[2] for r in tk.must_query("explain " + sql).rs.rows)
    assert tk.must_query(sql).rs.rows == [(1, 42), (2, 4900), (3, 77)]


def test_dirty_txn_fallback(tk):
    tk.must_exec("begin")
    tk.must_exec("insert into big values (9999, 'p9999', 1, 200000)")
    before = tk.domain.metrics.get("index_join_fallback", 0)
    sql = ("select /*+ INL_JOIN(big) */ small.k, big.payload from small, "
           "big where small.ref = big.id order by small.k")
    rows = tk.must_query(sql).rs.rows
    assert tk.domain.metrics.get("index_join_fallback", 0) == before + 1
    assert rows == [(1, "p42"), (2, "p4900"), (3, "p77"), (4, "p9999")]
    tk.must_exec("rollback")


def test_residual_filter_on_inner(tk):
    sql = ("select /*+ INL_JOIN(big) */ small.k from small, big "
           "where small.ref = big.id and big.w > 45 order by small.k")
    assert "IndexLookupJoin" in _explain_ops(tk, sql)
    assert tk.must_query(sql).rs.rows == [(2,), (3,)]


def test_merge_join_hint_and_parity(tk):
    sql = ("select /*+ MERGE_JOIN(big) */ small.k, big.w from small, big "
           "where small.ref = big.id order by small.k")
    assert "MergeJoin" in _explain_ops(tk, sql)
    assert tk.must_query(sql).rs.rows == [(1, 42), (2, 50), (3, 77)]
    sql2 = ("select /*+ MERGE_JOIN(big) */ small.k, big.w from small "
            "left join big on small.ref = big.id order by small.k")
    assert tk.must_query(sql2).rs.rows == [(1, 42), (2, 50), (3, 77),
                                           (4, None)]


def test_merge_join_duplicates():
    tk = TestKit(device="cpu")
    tk.must_exec("create table l (a int)")
    tk.must_exec("create table r (b int, v int)")
    tk.must_exec("insert into l values (1), (2), (2), (null)")
    tk.must_exec("insert into r values (2, 10), (2, 20), (3, 30), "
                 "(null, 40)")
    sql = ("select /*+ MERGE_JOIN(r) */ l.a, r.v from l, r "
           "where l.a = r.b order by l.a, r.v")
    assert tk.must_query(sql).rs.rows == [
        (2, 10), (2, 10), (2, 20), (2, 20)]


def test_hash_join_hint_respected(tk):
    sql = ("select /*+ HASH_JOIN(big) */ small.k, big.w from small, big "
           "where small.ref = big.id order by small.k")
    assert "IndexLookupJoin" not in _explain_ops(tk, sql)
    assert "HashJoin" in _explain_ops(tk, sql)
    assert tk.must_query(sql).rs.rows == [(1, 42), (2, 50), (3, 77)]


def test_unsigned_unique_index_lookup(tk):
    """Typed index-key encoding: UINT keys use UINT_FLAG, not INT."""
    tk.must_exec("create table ub (id int primary key, "
                 "u bigint unsigned, unique key uu (u))")
    tk.must_exec("insert into ub values (1, 5), "
                 "(2, 18446744073709551615)")
    tk.must_exec("create table us (k int primary key, r bigint unsigned)")
    tk.must_exec("insert into us values (1, 5), "
                 "(2, 18446744073709551615), (3, 7)")
    sql = ("select /*+ INL_JOIN(ub) */ us.k, ub.id from us, ub "
           "where us.r = ub.u order by us.k")
    assert "IndexLookupJoin" in _explain_ops(tk, sql)
    assert tk.must_query(sql).rs.rows == [(1, 1), (2, 2)]


def test_empty_inner_table(tk):
    tk.must_exec("create table never_written (id int primary key, x int)")
    sql = ("select /*+ INL_JOIN(never_written) */ small.k, never_written.x "
           "from small left join never_written "
           "on small.ref = never_written.id order by small.k")
    rows = tk.must_query(sql).rs.rows
    assert rows == [(1, None), (2, None), (3, None), (4, None)]
