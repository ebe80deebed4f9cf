"""Composite (multi-column) index range extraction + execution
(reference pkg/util/ranger/detacher.go:1033 — point-prefix x interval
composition over an index's column prefix).

The twin of tests/test_index_range.py on tidb_tpu_torch, with device="cpu" at
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


@pytest.fixture()
def tk():
    tk = TestKit(device="cpu")
    tk.must_exec("create table ev (id int primary key, tenant int, "
                 "day int, kind varchar(8), v int, "
                 "key k_tdk (tenant, day, kind))")
    rng = np.random.RandomState(7)
    rows = []
    for i in range(1, 2001):
        rows.append(f"({i}, {rng.randint(0, 20)}, {rng.randint(0, 50)}, "
                    f"'k{rng.randint(0, 5)}', {rng.randint(0, 1000)})")
    tk.must_exec("insert into ev values " + ",".join(rows))
    tk.must_exec("analyze table ev")
    return tk


def _host_rows(tk, sql):
    """Independent oracle: plan WITHOUT the index-range rule (full scan
    + filters), so the comparison never exercises the plan under test."""
    import tidb_tpu_torch.planner.physical as pp
    orig = pp._try_index_range
    pp._try_index_range = lambda ds: None
    tk.domain.invalidate_plan_cache()
    try:
        return tk.must_query(sql).rs.rows
    finally:
        pp._try_index_range = orig
        tk.domain.invalidate_plan_cache()


def _plan_uses_index_range(tk, sql):
    plan = tk.must_query("explain " + sql).rs.rows
    return any("IndexRange" in r[0] and "k_tdk" in str(r)
               for r in plan), plan


def test_eq_prefix_plus_range(tk):
    sql = ("select id, v from ev where tenant = 3 and day > 10 "
           "and day < 20 order by id")
    used, plan = _plan_uses_index_range(tk, sql)
    assert used, plan
    # range must show the composed prefix
    line = next(r for r in plan if "IndexRange" in r[0])
    assert "k_tdk" in str(line)
    got = tk.must_query(sql).rs.rows
    assert got == _host_rows(tk, sql)
    assert len(got) > 0


def test_two_eq_prefix_plus_range(tk):
    sql = ("select id from ev where tenant = 5 and day = 7 "
           "and kind >= 'k1' and kind <= 'k3' order by id")
    used, plan = _plan_uses_index_range(tk, sql)
    assert used, plan
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    want = [r[0] for r in _host_rows(tk, sql)]
    assert got == want and len(got) > 0


def test_full_eq_prefix_no_range(tk):
    sql = "select id from ev where tenant = 2 and day = 3 order by id"
    used, plan = _plan_uses_index_range(tk, sql)
    assert used, plan
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    want = [r[0] for r in _host_rows(tk, sql)]
    assert got == want and len(got) > 0


def test_residual_conditions_still_apply(tk):
    sql = ("select id from ev where tenant = 4 and day between 5 and 9 "
           "and v < 300 and kind <> 'k2' order by id")
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    want = [r[0] for r in _host_rows(tk, sql)]
    assert got == want


def test_skip_column_stops_prefix(tk):
    """tenant eq + KIND range (day unconstrained): only the tenant
    prefix may map to the key range; day/kind conds must stay residual
    and correct."""
    sql = ("select id from ev where tenant = 1 and kind = 'k1' "
           "order by id")
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    want = [r[0] for r in _host_rows(tk, sql)]
    assert got == want and len(got) > 0


def test_dirty_txn_sees_buffered_rows(tk):
    tk.must_exec("begin")
    tk.must_exec("insert into ev values (9001, 3, 15, 'kX', 1)")
    tk.must_exec("delete from ev where id = "
                 "(select min(id) from ev where tenant = 3 and day = 15)")
    sql = "select id from ev where tenant = 3 and day = 15 order by id"
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    want = [r[0] for r in _host_rows(tk, sql)]
    assert got == want
    assert 9001 in got
    tk.must_exec("rollback")


def test_conflicting_conds_stay_residual(tk):
    """Only the encoded cond leaves the residual set: a=3 AND a=4 must
    return zero rows; day>10 AND day>40 must apply BOTH bounds."""
    assert tk.must_query(
        "select count(*) from ev where tenant = 3 and tenant = 4"
    ).rs.rows[0][0] == 0
    sql = ("select id from ev where tenant = 3 and day > 10 "
           "and day > 40 order by id")
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    assert got == [r[0] for r in _host_rows(tk, sql)]
    sql = ("select id from ev where tenant = 3 and day < 40 "
           "and day < 10 order by id")
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    assert got == [r[0] for r in _host_rows(tk, sql)]


def test_update_then_range_scan(tk):
    tk.must_exec("update ev set day = 99 where tenant = 6 and day = 1")
    sql = "select id from ev where tenant = 6 and day = 99 order by id"
    got = [r[0] for r in tk.must_query(sql).rs.rows]
    want = [r[0] for r in _host_rows(tk, sql)]
    assert got == want and len(got) > 0


def test_limit_converts_unselective_range_to_index_scan(tk):
    """TableReader + LIMIT with one index-foldable range filter becomes
    a LIMITed index range scan even when the range is unselective (the
    scan reads <= offset+count index entries — sysbench index_range was
    53x slower via the per-statement device scan)."""
    plan = tk.must_query(
        "explain select id from ev where tenant >= 10 limit 5").rs.rows
    assert any("IndexRange" in r[0] for r in plan), plan
    got = tk.must_query(
        "select id from ev where tenant >= 10 limit 5").rs.rows
    assert len(got) == 5
    host = _host_rows(tk, "select count(*) from ev where tenant >= 10")
    assert host[0][0] > 5     # genuinely unselective
    # rows must actually satisfy the predicate
    ts = {r[0] for r in tk.must_query(
        "select tenant from ev where tenant >= 10 limit 5").rs.rows}
    assert all(t >= 10 for t in ts)
