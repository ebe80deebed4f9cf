"""Runtime filters (VERDICT r2 missing item 4, second half; reference
pkg/planner/core/runtime_filter_generator.go): the host hash join's
build side runs first, so its key bounds (exact IN set when small,
min/max range otherwise) push into the probe TableReader's device
filters before the probe scan runs.

The twin of tests/test_runtime_filter.py on tidb_tpu_torch, with device="cpu" at
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
    tk.must_exec("create table dim (k bigint primary key, g int)")
    tk.must_exec("create table fact (k bigint, v int)")
    tk.must_exec("insert into dim values " + ",".join(
        f"({i},{i % 4})" for i in range(100, 110)))
    rng = np.random.RandomState(3)
    tk.must_exec("insert into fact values " + ",".join(
        f"({rng.randint(0, 1000)},{i})" for i in range(2000)))
    return tk


def _oracle(tk, sql):
    tk.domain.copr.use_device = False
    try:
        return tk.must_query(sql).rs.rows
    finally:
        tk.domain.copr.use_device = True


def test_small_build_pushes_in_filter(tk):
    sql = ("select fact.k, fact.v, dim.g from fact join dim "
           "on fact.k = dim.k order by fact.v")
    got = tk.must_query(sql).rs.rows
    assert tk.domain.metrics.get("runtime_filter_pushed", 0) >= 1
    assert got == _oracle(tk, sql)
    assert len(got) == 13


def test_large_build_pushes_range_filter(tk):
    # >512 distinct build keys in a narrow band -> min/max range filter
    tk.must_exec("create table big (k bigint primary key)")
    tk.must_exec("insert into big values " + ",".join(
        f"({i})" for i in range(600)))
    n0 = tk.domain.metrics.get("runtime_filter_pushed", 0)
    sql = ("select fact.v from fact join big on fact.k = big.k "
           "order by fact.v")
    got = tk.must_query(sql).rs.rows
    assert tk.domain.metrics.get("runtime_filter_pushed", 0) > n0
    assert got == _oracle(tk, sql)


def test_decimal_build_key_never_pushes(tk):
    """A DECIMAL build key evaluates to SCALED ints on host; pushing
    those bounds at an unscaled INT probe column would drop every
    match (review finding) — mixed-type key pairs must not push."""
    tk.must_exec("create table a2 (k int)")
    tk.must_exec("create table b2 (d decimal(10,2))")
    tk.must_exec("insert into a2 values (1),(2),(3)")
    tk.must_exec("insert into b2 values (1.00),(2.00)")
    n0 = tk.domain.metrics.get("runtime_filter_pushed", 0)
    got = tk.must_query(
        "select a2.k from a2 join b2 on a2.k = b2.d order by a2.k").rows
    assert [int(r[0]) for r in got] == [1, 2]
    assert tk.domain.metrics.get("runtime_filter_pushed", 0) == n0


def test_outer_join_never_filters_preserved_side(tk):
    # LEFT join: every dim row must survive even when fact misses it
    sql = ("select dim.k, count(fact.v) from dim left join fact "
           "on dim.k = fact.k group by dim.k order by dim.k")
    got = tk.must_query(sql).rs.rows
    assert len(got) == 10                      # all dim rows present
    assert got == _oracle(tk, sql)
