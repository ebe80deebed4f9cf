"""Cascades memo planner (reference pkg/planner/cascades + memo;
dispatch optimizer.go:335-341): memo-based join search behind
tidb_enable_cascades_planner must agree with the default planner on
results while exploring the full bushy space with exact dedup.

The twin of tests/test_cascades.py on tidb_tpu_torch, with device="cpu" at
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
    rng = np.random.RandomState(7)
    tk.must_exec("create table f (a int, b int, c int, v int)")
    tk.must_exec("create table d1 (a int primary key, x int)")
    tk.must_exec("create table d2 (b int primary key, y int)")
    tk.must_exec("create table d3 (c int primary key, z int)")
    tk.must_exec("insert into d1 values " + ",".join(
        f"({i},{i % 5})" for i in range(40)))
    tk.must_exec("insert into d2 values " + ",".join(
        f"({i},{i % 7})" for i in range(30)))
    tk.must_exec("insert into d3 values " + ",".join(
        f"({i},{i % 3})" for i in range(20)))
    rows = ",".join(
        f"({rng.randint(0, 40)},{rng.randint(0, 30)},"
        f"{rng.randint(0, 20)},{rng.randint(0, 100)})"
        for _ in range(500))
    tk.must_exec(f"insert into f values {rows}")
    tk.must_exec("analyze table f, d1, d2, d3")
    return tk


QUERIES = [
    ("4-way star", "select d1.x, sum(f.v) from f, d1, d2, d3 "
     "where f.a = d1.a and f.b = d2.b and f.c = d3.c "
     "group by d1.x order by d1.x"),
    ("chain + filter", "select count(*), sum(f.v) from f, d1, d2 "
     "where f.a = d1.a and f.b = d2.b and d1.x < 3 and d2.y > 1"),
    ("left barrier", "select d1.x, count(f.b) from d1 left join f "
     "on d1.a = f.a join d2 on 1 = 1 where d2.b = 5 "
     "group by d1.x order by d1.x"),
]


@pytest.mark.parametrize("name,sql", QUERIES)
def test_cascades_matches_default_planner(tk, name, sql):
    tk.must_exec("set tidb_enable_cascades_planner = 0")
    want = tk.must_query(sql)._norm()
    tk.must_exec("set tidb_enable_cascades_planner = 1")
    try:
        got = tk.must_query(sql)._norm()
    finally:
        tk.must_exec("set tidb_enable_cascades_planner = 0")
    assert got == want, name


def test_memo_dedup_and_exploration():
    """Commute+associate from one seed tree reach every connected
    bushy shape; group identity dedups exactly: a 4-relation chain
    explores all 15 non-empty subsets with a bounded expr count."""
    from tidb_tpu_torch.planner.cascades import Memo, _explore
    m = Memo(4)
    for i in range(4):
        m.add(1 << i, ("leaf", i))
    m.add(0b0011, (1, 2))
    m.add(0b0111, (0b0011, 4))
    m.add(0b1111, (0b0111, 8))
    _explore(m)
    assert len(m.groups) == 15          # every non-empty subset
    # full group: every (S, complement-part) split reachable = 14 for
    # n=4 bushy exploration
    assert len(m.groups[0b1111]) == 14
    assert m.n_exprs < 100              # exact dedup keeps this tiny


def test_cascades_prefers_selective_build(tk):
    """The memo's NDV cost model must not pick a cartesian start when
    connected orders exist: EXPLAIN under cascades contains no
    cartesian join for a fully-connected query."""
    tk.must_exec("set tidb_enable_cascades_planner = 1")
    try:
        rows = tk.must_query(
            "explain select count(*) from f, d1, d2, d3 "
            "where f.a = d1.a and f.b = d2.b and f.c = d3.c").rows
    finally:
        tk.must_exec("set tidb_enable_cascades_planner = 0")
    txt = "\n".join(str(r[2]) for r in rows)
    assert "cartesian" not in txt.lower(), txt
