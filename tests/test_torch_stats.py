"""Statistics depth (VERDICT r1 item 7): FM-sketch NDV + sampling,
global partition stats, sync load during planning, and the NDV-aware
join reorder picking a different order than row-count greedy.

The twin of tests/test_stats.py on tidb_tpu_torch, with device="cpu" at
every store."""
import numpy as np
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.stats.analyze import FMSketch, _hash_values


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def test_fmsketch_accuracy_and_merge():
    rng = np.random.RandomState(7)
    a = FMSketch()
    a.insert_hashes(_hash_values(rng.randint(0, 50_000, 200_000)))
    est = a.ndv()
    assert 0.7 * 50_000 <= est <= 1.4 * 50_000, est
    b = FMSketch()
    b.insert_hashes(_hash_values(rng.randint(40_000, 90_000, 200_000)))
    a.merge(b)
    est = a.ndv()
    assert 0.7 * 90_000 <= est <= 1.4 * 90_000, est


def test_global_partition_stats():
    tk = TestKit(device="cpu")
    tk.must_exec("create table pt (id int, v int) partition by range (id) "
                 "(partition p0 values less than (100), "
                 "partition p1 values less than (200), "
                 "partition p2 values less than (maxvalue))")
    rows = ",".join(f"({i}, {i % 37})" for i in range(0, 300))
    tk.must_exec(f"insert into pt values {rows}")
    tk.must_exec("analyze table pt")
    info = tk.domain.infoschema().table_by_name("test", "pt")
    ts = tk.domain.stats[info.id]
    assert ts.row_count == 300
    cs = ts.columns["v"]
    # v has 37 distinct values across ALL partitions; the merged NDV
    # must reflect the global domain, not a per-partition sum (3 * 37)
    assert 30 <= cs.ndv <= 48, cs.ndv
    assert ts.columns["id"].ndv >= 250


def test_stats_sync_load():
    tk = TestKit(device="cpu")
    tk.must_exec("create table sl (a int primary key, b int)")
    rows = ",".join(f"({i}, {i % 5})" for i in range(1, 3001))
    tk.must_exec(f"insert into sl values {rows}")
    # never ANALYZEd: planning a query must sync-load stats
    before = tk.domain.metrics.get("stats_syncload", 0)
    tk.must_query("select count(*) from sl where b = 3")
    assert tk.domain.metrics.get("stats_syncload", 0) == before + 1
    info = tk.domain.infoschema().table_by_name("test", "sl")
    assert tk.domain.stats[info.id].columns["b"].ndv == 5


def test_skewed_join_order_differs_from_row_greedy():
    """The NDV-aware reorder must NOT pick the smaller relation when its
    join key is skewed (low NDV -> multiplicative blowup)."""
    tk = TestKit(device="cpu")
    tk.must_exec("create table fact (id int primary key, skew_k int, "
                 "sel_k int)")
    rows = ",".join(f"({i}, {i % 2}, {i % 5000})" for i in range(1, 5001))
    tk.must_exec(f"insert into fact values {rows}")
    # skewed: SMALLER table, but its join key has NDV 2
    tk.must_exec("create table skewed (k int, pay int)")
    rows = ",".join(f"({i % 2}, {i})" for i in range(1, 1001))
    tk.must_exec(f"insert into skewed values {rows}")
    # selective: bigger than skewed, high-NDV key
    tk.must_exec("create table selective (k int, pay int)")
    rows = ",".join(f"({i}, {i})" for i in range(1, 2001))
    tk.must_exec(f"insert into selective values {rows}")
    for t in ("fact", "skewed", "selective"):
        tk.must_exec(f"analyze table {t}")
    sql = ("select count(*) from fact, skewed, selective "
           "where fact.skew_k = skewed.k and fact.sel_k = selective.k")
    import tidb_tpu_torch.planner.physical as pp
    orig = pp._try_fuse_agg
    pp._try_fuse_agg = lambda *a, **k: None
    tk.must_exec("set tidb_enable_mpp = 0")
    try:
        plan = [r[2] for r in tk.must_query("explain " + sql).rs.rows
                if "HashJoin" in str(r[0])]
    finally:
        pp._try_fuse_agg = orig
        tk.must_exec("set tidb_enable_mpp = 1")
        tk.domain.invalidate_plan_cache()
    # row-count greedy would join `skewed` (1000 rows) before
    # `selective` (2000 rows); the cardinality model joins `selective`
    # first because fact x skewed explodes (|fact| * 1000 / 2)
    assert len(plan) == 2, plan
    first_join = plan[-1]       # deepest join in the tree
    assert "sel_k" in first_join and "skew_k" not in first_join, plan
    # and it still returns the right answer: each fact row matches 500
    # skewed rows and exactly 1 selective row (sel_k 0 matches k 5000? no
    # -> 4999 fact rows match) -- just sanity-check magnitude
    # 2000 fact rows match selective (sel_k 1..2000), each matching 500
    # skewed rows = 1,000,000
    n = int(tk.must_query(sql).rs.rows[0][0])
    assert n == 1_000_000
