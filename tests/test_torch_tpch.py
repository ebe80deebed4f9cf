"""The same SQL through tidb_tpu's TestKit and tidb_tpu_torch's TestKit
on the CPU: TPC-H Q6/Q1 at SF0.05 (the port's fused device path and
scan-kernel wrappers) and a few plain statements, with rows compared as
strings. Also the state carried across: lineitem exported from the
reference's columnar engine and imported into the port, and the port's
copy of the TPC-H generator against the reference's."""
import numpy as np
import pytest

from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu.utils import phase as ref_phase
from tidb_tpu_torch.testkit import TestKit as PortKit, import_columns
from tidb_tpu_torch.bench import tpch as port_tpch
from tidb_tpu_torch.ops import scan_kernels
from tidb_tpu_torch.utils import phase as port_phase

SF, SEED = 0.05, 7


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield


@pytest.fixture(scope="module")
def kits():
    ref = RefKit()
    ref_tpch.load_tpch(ref, sf=SF, seed=SEED)
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=SF, seed=SEED)
    return ref, port


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count calls of the scan-kernel wrappers (on the CPU they run their
    plain versions, so their launch counts stay 0)."""
    calls = {"masked_sums": 0, "dense_group_sums": 0,
             "range_filter_sums": 0}
    for name in calls:
        fn = getattr(scan_kernels, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(scan_kernels, name, spy)
    return calls


@pytest.mark.parametrize("q,kernel", [("q6", "range_filter_sums"),
                                      ("q1", "dense_group_sums")])
def test_tpch_rows_equal_reference(kits, kernel_calls, q, kernel):
    ref, port = kits
    want = ref.must_query(ref_tpch.QUERIES[q])._norm()
    hits0 = port.domain.metrics.get("fused_pipeline_hit", 0)
    rs = port.must_query(port_tpch.QUERIES[q])
    assert rs._norm() == want
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == hits0 + 1
    assert port.domain.last_fused_reason is None
    assert kernel_calls[kernel] >= 1
    oracle = {"q6": port_tpch.q6_oracle, "q1": port_tpch.q1_oracle}[q]
    assert oracle(port) == want
    plan = port.must_query("explain analyze " + port_tpch.QUERIES[q])
    assert any("device(fused)" in " ".join(map(str, r)) for r in plan.rows)


@pytest.mark.parametrize("q", ["q6", "q1"])
def test_warm_counters_within_reference(kits, q):
    ref, port = kits
    snaps = []
    for kit, ph, text in ((ref, ref_phase, ref_tpch.QUERIES[q]),
                          (port, port_phase, port_tpch.QUERIES[q])):
        kit.must_query(text)                         # warm up
        ph.reset()
        kit.must_query(text)
        snaps.append(ph.snap())
    r, p = snaps
    for key in ("dispatches", "syncs", "upload_bytes"):
        assert p.get(key, 0) <= r.get(key, 0), (key, p, r)
    assert p.get("dispatches", 0) >= 1            # the fused fragment ran
    assert p.get("upload_hits", 0) >= 1           # resident columns reused


# (sql, kernel, kernels that must not run): the three routes of a global
# aggregation. Q6 with a string filter mixes the routes: the range
# filters run in the kernel, the string filter on the evaluator into its
# valid mask. QSUM has no range filter and keeps masked_sums.
GLOBAL_ROUTE_SQL = [
    (port_tpch.Q6.rstrip() + " and l_returnflag = 'R'",
     "range_filter_sums", ("masked_sums",)),
    (port_tpch.Q6.rstrip() + " and l_tax != 0.02 and l_linestatus = 'F'",
     "range_filter_sums", ("masked_sums",)),
    ("select count(*) from lineitem where l_quantity between 10 and 20.5 "
     "and l_discount >= 0.05", "range_filter_sums", ("masked_sums",)),
    (port_tpch.QSUM, "masked_sums", ("range_filter_sums",)),
    # min/max are not the kernels' aggregates: the range filters go back
    # to the evaluator and the plain reductions
    ("select min(l_extendedprice), max(l_quantity), count(*) from "
     "lineitem where l_shipdate < date '1993-01-01'", None,
     ("range_filter_sums", "masked_sums")),
]


@pytest.mark.parametrize("sql,kernel,absent", GLOBAL_ROUTE_SQL)
def test_global_aggregate_routes_equal_reference(kits, kernel_calls, sql,
                                                 kernel, absent):
    ref, port = kits
    hits0 = port.domain.metrics.get("fused_pipeline_hit", 0)
    assert port.must_query(sql)._norm() == ref.must_query(sql)._norm()
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == hits0 + 1
    if kernel is not None:
        assert kernel_calls[kernel] >= 1
    for name in absent:
        assert kernel_calls[name] == 0, name
    if sql is port_tpch.QSUM:
        assert port_tpch.qsum_oracle(port) == \
            port.must_query(sql)._norm()


def test_q6_delta_partition_equals_reference(kits, kernel_calls):
    """Q6 inside a transaction with uncommitted inserts: the inserted
    rows run as one more partition through the same range fragment."""
    ref, port = kits
    ins = ("insert into lineitem (l_orderkey, l_quantity, "
           "l_extendedprice, l_discount, l_tax, l_returnflag, "
           "l_linestatus, l_shipdate) values "
           "(1, 10.00, 1000.00, 0.06, 0.01, 'N', 'O', '1994-06-01'),"
           "(2, 23.99, 2000.00, 0.05, 0.02, 'R', 'F', '1994-01-01'),"
           "(3, 24.00, 3000.00, 0.07, 0.02, 'A', 'F', '1994-12-31'),"
           "(4, 1.00, 4000.00, 0.08, 0.00, 'N', 'O', '1994-03-03'),"
           "(5, 2.00, 5000.00, 0.06, 0.00, 'N', 'O', '1995-01-01')")
    q6 = port_tpch.QUERIES["q6"]
    before = port.must_query(q6)._norm()
    try:
        for kit in (ref, port):
            kit.must_exec("begin")
            kit.must_exec(ins)
        calls0 = kernel_calls["range_filter_sums"]
        ovl0 = port.domain.metrics.get("fused_pipeline_dirty_overlay", 0)
        got = port.must_query(q6)._norm()
        assert got == ref.must_query(ref_tpch.QUERIES["q6"])._norm()
        assert got != before
        assert port.domain.metrics.get("fused_pipeline_dirty_overlay",
                                       0) == ovl0 + 1
        assert kernel_calls["range_filter_sums"] - calls0 >= 2
    finally:
        for kit in (ref, port):
            kit.must_exec("rollback")
    assert port.must_query(q6)._norm() == before


def _null_table_sql(rows=5000, seed=11):
    """A table past the planner's 4096-row floor for fusing, whose
    predicate columns hold NULLs (about one row in four)."""
    rng = np.random.default_rng(seed)
    vals = []
    for i in range(rows):
        n = "null" if rng.random() < 0.25 else str(int(rng.integers(-20, 20)))
        v = "null" if rng.random() < 0.1 else \
            f"{int(rng.integers(-99999, 99999)) / 100:.2f}"
        d = "null" if rng.random() < 0.25 else \
            f"'199{int(rng.integers(3, 7))}-0{int(rng.integers(1, 10))}-15'"
        vals.append(f"({i + 1}, {n}, {v}, {d})")
    return ["create table rn (id int primary key, n int, v decimal(10,2), "
            "d date)", "insert into rn values " + ",".join(vals)]


@pytest.mark.parametrize("sql", [
    "select sum(id), count(*) from rn where n >= 3 and n < 9",
    "select count(*) from rn where d between '1994-01-01' and '1995-06-30'",
    "select sum(id), count(*) from rn where n > 2 and v <= 3.1",
    "select sum(id) from rn where n <= 100 and d >= date '1995-01-01'",
])
def test_range_route_null_predicate_columns_equal_reference(kernel_calls,
                                                            sql):
    """A predicate column with NULLs: NULL compares false, so the
    column's ~nulls join the kernel's valid mask."""
    ref, port = RefKit(), PortKit(device="cpu")
    for setup in _null_table_sql():
        ref.must_exec(setup)
        port.must_exec(setup)
    hits0 = port.domain.metrics.get("fused_pipeline_hit", 0)
    assert port.must_query(sql)._norm() == ref.must_query(sql)._norm()
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == hits0 + 1
    assert kernel_calls["range_filter_sums"] >= 1


def test_range_route_nullable_sum_argument_equals_reference(kernel_calls):
    """The plan picks the range route for sum/count, but a sum argument
    that arrives with a null mask is not the kernel's shape: that
    partition runs the evaluator's compares and the plain reductions."""
    ref, port = RefKit(), PortKit(device="cpu")
    for setup in _null_table_sql():
        ref.must_exec(setup)
        port.must_exec(setup)
    sql = "select sum(v), count(v), count(*) from rn where n >= 3 and n < 9"
    hits0 = port.domain.metrics.get("fused_pipeline_hit", 0)
    assert port.must_query(sql)._norm() == ref.must_query(sql)._norm()
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == hits0 + 1
    assert kernel_calls["range_filter_sums"] == 0
    assert kernel_calls["masked_sums"] == 0


SLOT_DOMAIN_SQL = [
    # min/max decline the kernel: the scatter lowering serves the slots
    ("select l_returnflag, l_linestatus, min(l_quantity), "
     "max(l_extendedprice), count(*) from lineitem "
     "group by l_returnflag, l_linestatus "
     "order by l_returnflag, l_linestatus", "scatter"),
    ("select l_returnflag, l_linestatus, sum(l_quantity), "
     "avg(l_discount), min(l_shipdate), max(l_tax) from lineitem "
     "where l_shipdate <= date '1998-09-02' "
     "group by l_returnflag, l_linestatus "
     "order by l_returnflag, l_linestatus", "scatter"),
    ("select l_linestatus, count(*), sum(l_tax) from lineitem "
     "group by l_linestatus order by l_linestatus", "dense_group_sums"),
]


@pytest.mark.parametrize("sql,lowering", SLOT_DOMAIN_SQL)
def test_slot_domain_lowerings_equal_reference(kits, kernel_calls,
                                               monkeypatch, sql, lowering):
    """A small slot domain goes through dense_group_sums when every
    aggregate is sum/avg/count over int64 without nulls, and through
    the scatter lowering otherwise; both give the reference's rows."""
    from tidb_tpu_torch.copr import dag_exec
    scatter = dag_exec._dense_agg_states_scatter

    def spy(*a, **k):
        kernel_calls["scatter"] = kernel_calls.get("scatter", 0) + 1
        return scatter(*a, **k)
    monkeypatch.setattr(dag_exec, "_dense_agg_states_scatter", spy)
    ref, port = kits
    hits0 = port.domain.metrics.get("fused_pipeline_hit", 0)
    assert port.must_query(sql)._norm() == ref.must_query(sql)._norm()
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == hits0 + 1
    assert kernel_calls.get(lowering, 0) >= 1
    other = "dense_group_sums" if lowering == "scatter" else "scatter"
    assert kernel_calls.get(other, 0) == 0


@pytest.fixture
def small_port():
    from tidb_tpu_torch.utils import failpoint
    port = PortKit(device="cpu")
    port_tpch.load_tpch(port, sf=0.01, seed=3)
    yield port
    failpoint.disable_all()


def test_fused_error_degrades_to_host_on_cpu(small_port):
    """On the CPU device a failed fused fragment degrades to the numpy
    host twin, as in the reference, and is counted."""
    from tidb_tpu_torch.utils import failpoint
    assert small_port.domain.copr.degrade_to_host
    failpoint.enable("device_guard/fused", "error:generic")
    port_phase.reset()
    rows = small_port.must_query(port_tpch.QUERIES["q6"])._norm()
    assert rows == port_tpch.q6_oracle(small_port)
    assert port_phase.snap().get("fused_fallbacks", 0) == 1
    assert small_port.domain.metrics.get("fused_pipeline_error", 0) == 1


@pytest.mark.parametrize("how", ["error", "breaker_open"])
def test_fused_error_fails_statement_without_host_degrade(small_port, how):
    """With degrading to the host off (the card's rule), a failed fused
    fragment fails its statement, and so does every statement while the
    breaker is open: none of that work runs on the host."""
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.utils import failpoint
    small_port.domain.copr.degrade_to_host = False
    small_port.must_exec("set tidb_tpu_device_breaker_threshold = 1")
    q6 = port_tpch.QUERIES["q6"]
    failpoint.enable("device_guard/fused", "error:generic")
    port_phase.reset()
    with pytest.raises(DeviceUnavailableError, match="generic"):
        small_port.must_query(q6)
    if how == "breaker_open":
        failpoint.disable("device_guard/fused")
        with pytest.raises(DeviceUnavailableError, match="breaker_open"):
            small_port.must_query(q6)
    snap = port_phase.snap()
    for key in ("fused_fallbacks", "device_fallbacks", "host_execs"):
        assert snap.get(key, 0) == 0, (key, snap)
    assert small_port.domain.metrics.get("fused_pipeline_error", 0) == \
        (2 if how == "breaker_open" else 1)


PLAIN_SQL = [
    "create table t (id int primary key, g char(1), v decimal(10,2), "
    "n int, d date)",
    "insert into t values (1,'a',1.50,10,'1994-01-01'),"
    "(2,'b',2.25,null,'1995-06-30'),(3,'a',-0.75,7,'1996-12-31'),"
    "(4,'c',10.00,1,null)",
    "select * from t order by id",
    "select g, count(*), sum(v), sum(n), min(v), max(n) from t "
    "group by g order by g",
    "select sum(v), count(n), avg(v) from t where d >= '1995-01-01'",
    "select id, v * 2, n + 1 from t where v > 0 order by v desc",
    "insert into t values (5,'b',3.10,2,'1997-01-01'),"
    "(6,'d',0.05,5,'1998-08-08')",
    "select g, count(*), sum(v), sum(n) from t group by g order by g",
    "select sum(v), count(*) from t",
    "update t set v = v + 1 where id = 2",
    "delete from t where id = 3",
    "select g, count(*), sum(v) from t group by g order by g",
    "select count(*) from t where g = 'a' or n is null",
]


def test_plain_statements_equal_reference():
    ref, port = RefKit(), PortKit(device="cpu")
    for sql in PLAIN_SQL:
        r = ref.must_exec(sql)
        p = port.must_exec(sql)
        if r.names:
            assert [tuple(map(str, x)) for x in p.rows] == \
                [tuple(map(str, x)) for x in r.rows], sql


def test_append_folds_into_resident_buffers():
    """copr/delta.py: a row inserted after a warm Q1 tail-patches the
    resident column buffers (copy + slice-assign into fresh tensors)
    instead of re-uploading them, and the rows stay equal to the
    reference's."""
    ref, port = RefKit(), PortKit(device="cpu")
    ref_tpch.load_tpch(ref, sf=0.01, seed=3)
    port_tpch.load_tpch(port, sf=0.01, seed=3)
    q1 = port_tpch.QUERIES["q1"]
    assert port.must_query(q1)._norm() == ref.must_query(q1)._norm()
    ins = ("insert into lineitem (l_orderkey, l_quantity, "
           "l_extendedprice, l_discount, l_tax, l_returnflag, "
           "l_linestatus, l_shipdate) values "
           "(1, 7.00, 700.00, 0.05, 0.01, 'N', 'O', '1996-03-13')")
    for kit in (ref, port):
        kit.must_exec(ins)
    port_phase.reset()
    assert port.must_query(q1)._norm() == ref.must_query(q1)._norm()
    snap = port_phase.snap()
    assert snap.get("delta_applies", 0) >= 1, snap
    assert snap.get("upload_bytes", 0) < 1 << 16, snap
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == 2


def _export(kit, table):
    tbl = kit.domain.infoschema().table_by_name("test", table)
    ctab = kit.domain.columnar.tables[tbl.id]
    out = {}
    for ci in tbl.columns:
        nulls = ctab.nulls[ci.id][:ctab.n]
        d = ctab.dicts.get(ci.id)
        out[ci.name] = (ctab.data[ci.id][:ctab.n].copy(),
                        nulls.copy() if nulls.any() else None,
                        None if d is None else list(d.values))
    return out


def test_import_columns_carries_reference_state(kits, kernel_calls):
    ref, _ = kits
    port = PortKit(device="cpu")
    port.must_exec(port_tpch.DDL["lineitem"])
    import_columns(port, "lineitem", _export(ref, "lineitem"))
    for q in ("q6", "q1"):
        assert port.must_query(port_tpch.QUERIES[q])._norm() == \
            ref.must_query(ref_tpch.QUERIES[q])._norm()
    assert port.domain.metrics.get("fused_pipeline_hit", 0) == 2
    assert kernel_calls["range_filter_sums"] >= 1
    assert kernel_calls["dense_group_sums"] >= 1


def test_generator_copy_is_byte_identical(kits):
    ref, port = kits
    for table in ref_tpch.DDL:
        r, p = _export(ref, table), _export(port, table)
        assert r.keys() == p.keys()
        for name in r:
            (rd, rn, rv), (pd, pn, pv) = r[name], p[name]
            assert rd.dtype == pd.dtype and rd.tobytes() == pd.tobytes(), \
                (table, name)
            assert (rn is None) == (pn is None)
            if rn is not None:
                assert np.array_equal(rn, pn)
            assert rv == pv, (table, name)


def test_profile_busy_time_is_the_union_of_intervals():
    """bench/profile_tpch.py's device busy time: overlapping kernel and
    copy intervals count once, gaps not at all."""
    from types import SimpleNamespace as NS
    from tidb_tpu_torch.bench.profile_tpch import _busy_us

    def ev(s, e):
        return NS(time_range=NS(start=s, end=e))
    assert _busy_us([]) == 0
    assert _busy_us([ev(10, 20), ev(0, 5), ev(15, 30), ev(30, 31),
                     ev(40, 41)]) == 5 + 21 + 1
