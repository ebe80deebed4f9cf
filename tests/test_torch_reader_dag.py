"""Reader-DAG device fragments (tidb_tpu_torch/copr/dag_exec.py: the
filter, top-n and partition-aggregation fragments of scans outside a
fused node) against the reference package, through SQL on the CPU with
tidb_tpu_fragment_min_rows = 0, so every filter and top-n DAG takes the
device route as every aggregation DAG does. The table has 3,000 rows
(below the 4,096 at which a single-table aggregation becomes a zero-dim
fused pipeline in both packages, so its group-bys stay reader DAGs) in
partitions of 1,024 rows, with NULLs, ties and a dictionary-coded
string column. Rows must equal the reference's (integers and decimals
exactly, floats to rtol 1e-9), and so must each statement's routing
counters (copr_device_exec, copr_host_exec, copr_fragment_gated).

Also: the torch top-n body on CPU tensors against the host twin
_topn_host and a plain oracle, with ties, NULLs in both orders and
descending/ascending int, float and dictionary keys; dirty-transaction
overlays; the group-bucket regrow and the runs->sorted pin of a reader
DAG; and the dense route reaching the scan kernels' wrappers."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tidb_tpu.copr.dag_exec as rde
from tidb_tpu.testkit import TestKit as RefKit

import tidb_tpu_torch.copr.dag_exec as pde
from tidb_tpu_torch.expression import EvalCtx
from tidb_tpu_torch.expression.expr import Column
from tidb_tpu_torch.expression.torch_ns import TorchNS
from tidb_tpu_torch.chunk.device import StringDict
from tidb_tpu_torch.ops import scan_kernels
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.types.field_type import (new_bigint_type,
                                             new_double_type,
                                             new_string_type)
from tidb_tpu_torch.utils import phase as port_phase

N, PART = 3000, 1024
ROUTES = ("copr_device_exec", "copr_host_exec", "copr_fragment_gated")
WORDS = ["apple", "banana", "berry", "cherry", "apricot", "blue", "a", ""]


def _rows():
    """The table's rows as SQL literals, from a seeded generator: ties in
    k, NULLs in n, f and s, a dictionary of eight strings."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(1, N + 1):
        g = int(rng.integers(0, 6))
        k = int(rng.integers(0, 101))
        s = "NULL" if rng.random() < 0.05 else \
            f"'{WORDS[int(rng.integers(0, len(WORDS)))]}'"
        d = f"{int(rng.integers(-50000, 100000)) / 100:.2f}"
        f = "NULL" if rng.random() < 0.05 else \
            repr(float(np.round(rng.normal(0, 1000), 3)))
        dt = f"'2020-{int(rng.integers(1, 13)):02d}-" \
            f"{int(rng.integers(1, 29)):02d}'"
        n = "NULL" if rng.random() < 0.1 else str(int(rng.integers(-5, 40)))
        out.append(f"({i},{g},{k},{s},{d},{f},{dt},{n})")
    return out


DDL = ("create table t (id int primary key, g int, k int, s varchar(20), "
       "d decimal(10,2), f double, dt date, n int)")


def _load(kit):
    kit.must_exec(DDL)
    rows = _rows()
    for i in range(0, len(rows), 500):
        kit.must_exec("insert into t values " + ",".join(rows[i:i + 500]))
    kit.domain.copr.device_rows = PART
    kit.must_exec("set tidb_tpu_fragment_min_rows = 0")
    return kit


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only; the
    policy switches are put back after each test."""
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield
    pde._FORCE_SEGMENT_IMPL = None


@pytest.fixture(scope="module")
def kits():
    return _load(RefKit()), _load(PortKit(device="cpu"))


def _match(got, want):
    """Rows equal as strings, except a float that differs in its last
    digits: within rtol 1e-9."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if a == b:
                continue
            fa, fb = float(a), float(b)
            assert ("." in a or "e" in a) and \
                abs(fa - fb) <= 1e-9 * max(abs(fa), abs(fb)), (g, w)


def _run(kit, sql):
    m = kit.domain.metrics
    m0 = {c: m.get(c, 0) for c in ROUTES}
    rows = kit.must_query(sql)._norm()
    return rows, {c: m.get(c, 0) - m0[c] for c in ROUTES}


STATEMENTS = {
    # filter-only DAGs
    "filter_like": "select id, g, s from t where k > 50 and s like 'b%' "
                   "order by id",
    "filter_decimal_or_null": "select id, d, n from t where d between 10 "
                              "and 500 or n is null order by id",
    "filter_in_date": "select id from t where g in (1, 3, 5) and "
                      "dt >= '2020-06-01' order by id",
    "filter_case": "select id, k from t where case when g = 2 then k "
                   "else n end > 30 order by id",
    "filter_ifnull": "select id from t where ifnull(n, 100) > 35 "
                     "order by id",
    # top-n DAGs (the key columns only: rows are the same whichever of
    # tied rows a top-n keeps)
    "topn_int_desc_ties": "select k from t where g < 4 order by k desc "
                          "limit 7",
    "topn_int_asc_nulls": "select n from t order by n limit 9",
    "topn_int_desc_nulls": "select n from t order by n desc limit 300",
    "topn_float_asc": "select f from t where k > 10 order by f limit 5",
    "topn_float_desc_nulls": "select f from t order by f desc limit 200",
    "topn_dict_asc": "select s from t order by s limit 200",
    "topn_dict_desc": "select s from t where g = 1 order by s desc "
                      "limit 6",
    "topn_decimal_desc": "select d from t order by d desc limit 4",
    # partition aggregation DAGs
    "agg_dense_small": "select g, count(*), sum(k), avg(d), min(f), "
                       "max(f), min(dt), max(n) from t group by g order by g",
    "agg_dense_wide": "select k, count(n), sum(n), sum(d) from t where "
                      "s like 'a%' group by k order by k",
    "agg_dict_key": "select s, count(*), sum(d), avg(f) from t group by s "
                    "order by s",
    "agg_expr_key": "select id div 3, count(*), sum(k) from t "
                    "group by id div 3 order by 1",
    "agg_null_key": "select n, count(*), min(s) from t group by n "
                    "order by n",
    "agg_composite": "select g, k, count(*), sum(d) from t where k < 30 "
                     "group by g, k order by g, k",
    "agg_global": "select count(*), sum(k), sum(d), max(f), min(n) "
                  "from t where g = 2",
    "agg_global_empty": "select count(*), sum(k) from t where k > 1000",
}


@pytest.mark.parametrize("policy", [None, "runs"],
                         ids=["cpu_policy", "runs_policy"])
@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_reader_dag_equals_reference(kits, name, policy, monkeypatch):
    ref, port = kits
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", policy)
    sql = STATEMENTS[name]
    want, ref_route = _run(ref, sql)
    got, port_route = _run(port, sql)
    _match(got, want)
    assert port_route == ref_route
    assert port_route["copr_device_exec"] >= 1, port_route


def test_small_filter_is_gated_like_the_reference(kits):
    """Under the default tidb_tpu_fragment_min_rows (2 M rows) a
    filter-only DAG over 3,000 rows takes the host twin in both
    packages, counted as gated; an aggregation DAG still dispatches."""
    for kit in kits:
        kit.must_exec("set tidb_tpu_fragment_min_rows = 2097152")
    try:
        for sql in (STATEMENTS["filter_like"],
                    STATEMENTS["topn_int_desc_ties"],
                    STATEMENTS["agg_dense_small"]):
            want, ref_route = _run(kits[0], sql)
            got, port_route = _run(kits[1], sql)
            _match(got, want)
            assert port_route == ref_route
        assert port_route["copr_device_exec"] == 1
        _, gated = _run(kits[1], STATEMENTS["filter_like"])
        assert gated == {"copr_device_exec": 0, "copr_host_exec": 1,
                         "copr_fragment_gated": 1}
    finally:
        for kit in kits:
            kit.must_exec("set tidb_tpu_fragment_min_rows = 0")


def test_topn_keeps_the_lowest_row_of_tied_keys(kits):
    """Which of tied rows a top-n keeps: the lowest row, so the device
    route gives the host route's rows, ids included."""
    _, port = kits
    sql = "select id, k from t where g < 4 order by k desc limit 7"
    got, route = _run(port, sql)
    assert route["copr_device_exec"] == 1
    port.domain.copr.use_device = False
    try:
        want, host = _run(port, sql)
    finally:
        port.domain.copr.use_device = True
    assert host["copr_host_exec"] == 1 and got == want


DIRTY = ["begin",
         "insert into t values (5001, 2, 99, 'banana', 12.50, 1.5, "
         "'2020-07-01', NULL), (5002, 4, 100, NULL, -3.25, NULL, "
         "'2020-01-02', 7)",
         "update t set k = 100, s = 'cherry' where id < 40",
         "delete from t where id between 100 and 160"]


@pytest.mark.parametrize("name", ["filter_like", "topn_int_desc_ties",
                                  "agg_dense_small", "agg_dict_key",
                                  "agg_global"])
def test_dirty_transaction_overlay_equals_reference(kits, name):
    """A session's uncommitted inserts, updates and deletes overlay the
    committed rows of a reader DAG (UnionScan) on the device route."""
    ref, port = kits
    for kit in kits:
        for sql in DIRTY:
            kit.must_exec(sql)
    try:
        want, ref_route = _run(ref, STATEMENTS[name])
        got, port_route = _run(port, STATEMENTS[name])
    finally:
        for kit in kits:
            kit.must_exec("rollback")
    _match(got, want)
    assert port_route == ref_route and port_route["copr_device_exec"] == 1


def test_reader_dag_bucket_regrow_and_runs_pin(kits, monkeypatch):
    """On the runs lowering a reader-DAG group-by learns as the fused
    one does (dag_exec.learn_sort_kind): 3,000 groups of a clustered key
    in one partition regrow the 1,024-group bucket; an unclustered key
    whose span no dense layout takes (id * 1000003 % 9999991) with more
    partials than max(_RUNS_DEGRADE_MIN, rows / 4; 16 here) pins the
    shape to the sorted lowering, which then regrows its bucket. Each
    reruns its partition on the first statement only; the rows equal
    the reference's."""
    ref, port = kits
    monkeypatch.setattr(pde, "_FORCE_SEGMENT_IMPL", "runs")
    port.domain.copr.device_rows = 4096
    m = port.domain.metrics
    try:
        for sql, degrade_min, learned in (
                ("select id, count(*), sum(d) from t group by id "
                 "order by id", 65536, {"copr_bucket_regrow": 1}),
                ("select id * 1000003 % 9999991, count(*), sum(k) from t "
                 "group by id * 1000003 % 9999991 order by 1", 16,
                 {"copr_runs_degrade": 1, "copr_bucket_regrow": 1})):
            monkeypatch.setattr(pde, "_RUNS_DEGRADE_MIN", degrade_min)
            want, _ = _run(ref, sql)
            for i in range(2):
                m0 = dict(m)
                port_phase.reset()
                got, route = _run(port, sql)
                d = {c: m.get(c, 0) - m0.get(c, 0) for c in
                     ("copr_bucket_regrow", "copr_runs_degrade")}
                d = {c: v for c, v in d.items() if v}
                assert got == want
                assert route["copr_device_exec"] == 1
                assert d == (learned if i == 0 else {}), (sql, i, d)
                reruns = sum(learned.values()) if i == 0 else 0
                assert port_phase.snap()["dispatches"] == 1 + reruns
    finally:
        port.domain.copr.device_rows = PART


def test_dense_reader_dag_reaches_the_scan_kernels(kits, monkeypatch):
    """A reader-DAG group-by over at most 64 dense slots with int64
    sum/count arguments calls dense_group_sums, one per partition, and
    a global one masked_sums (on the CPU the wrappers run their plain
    versions)."""
    _, port = kits
    calls = []
    for name in ("dense_group_sums", "masked_sums"):
        fn = getattr(scan_kernels, name)
        monkeypatch.setattr(scan_kernels, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    nparts = -(-N // PART)
    port.must_query("select g, count(*), sum(k) from t group by g")
    assert calls == ["dense_group_sums"] * nparts
    calls.clear()
    port.must_query("select count(*), sum(k) from t where g = 2")
    assert calls == ["masked_sums"] * nparts


# ---- the top-n body on CPU tensors -------------------------------------

M = 257


def _topn_case(kind, desc, with_nulls, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        data = rng.integers(-3, 4, M).astype(np.int64)
        data[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
        ft, sd = new_bigint_type(), None
    elif kind == "float":
        data = rng.choice([-1.5, 0.0, 2.25, -1e300, 1e300], M)
        ft, sd = new_double_type(), None
    else:
        sd = StringDict()
        sd.encode(np.array(["pear", "apple", "fig", "apple2", "b"],
                           dtype=object))
        data = rng.integers(0, 5, M).astype(np.int32)
        ft = new_string_type()
    nulls = rng.random(M) < 0.2 if with_nulls else None
    mask = rng.random(M) < 0.8
    return data, nulls, sd, ft, mask


def _oracle(data, nulls, sd, mask, desc, k):
    """The first k rows under mask by (NULL rank, key, row)."""
    vals = data if sd is None else np.asarray(sd.ranks())[data]
    nm = np.zeros(M, bool) if nulls is None else nulls
    rows = [i for i in range(M) if mask[i]]

    def key(i):
        if nm[i]:
            return (0 if not desc else 1, 0, i)
        v = vals[i].item()
        return (1 if not desc else 0, -v if desc else v, i)
    return sorted(rows, key=key)[:k]


@pytest.mark.parametrize("k", [1, 10, 300])
@pytest.mark.parametrize("with_nulls", [False, True],
                         ids=["no_nulls", "nulls"])
@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("kind", ["int", "float", "dict"])
def test_topn_body_matches_host_twin(kind, desc, with_nulls, k):
    """topn_body on CPU tensors == _topn_host == the plain oracle: the
    first k rows under the mask by (NULL rank, key, row index), ties by
    the lowest row; int keys at INT64_MIN/MAX sort without overflow.
    The reference's _topn_host picks the same keys where it orders
    right (which of tied rows it keeps at the boundary is its
    partition's choice)."""
    data, nulls, sd, ft, mask = _topn_case(kind, desc, with_nulls,
                                           hash((kind, desc, k)) % 1000)
    expr = Column(0, ft)
    want = _oracle(data, nulls, sd, mask, desc, k)
    cap = 320
    pad = cap - M
    td = torch.from_numpy(np.concatenate([data, np.zeros(pad, data.dtype)]))
    tn = None if nulls is None else torch.from_numpy(
        np.concatenate([nulls, np.ones(pad, bool)]))
    tm = torch.from_numpy(np.concatenate([mask, np.zeros(pad, bool)]))
    ctx = EvalCtx(TorchNS("cpu"), cap, {0: (td, tn, sd)}, host=False)
    order, cnt = pde.topn_body(ctx, tm, expr, desc, k, cap)
    got = order.numpy()[:int(cnt)].tolist()
    assert got == want
    dag = SimpleNamespace(topn=((expr, desc), k), filters=[],
                          host_filters=[])
    host = pde.CoprExecutor._topn_host(None, dag, {0: (data, nulls, sd)},
                                       mask, M)
    assert host.tolist() == want
    # the reference's host twin: the same keys in the same order
    from tidb_tpu.chunk.device import StringDict as RefDict
    from tidb_tpu.expression.expr import Column as RefColumn
    from tidb_tpu.types.field_type import (new_bigint_type as rb,
                                           new_double_type as rdbl,
                                           new_string_type as rs)
    rsd = None
    if sd is not None:
        rsd = RefDict()
        rsd.encode(np.array(sd.values, dtype=object))
    rft = {"int": rb, "float": rdbl, "dict": rs}[kind]()
    rdag = SimpleNamespace(topn=((RefColumn(0, rft), desc), k), filters=[],
                           host_filters=[])
    # the reference's twin, on the inputs it orders right: it negates
    # int keys (INT64_MIN and INT64_MAX wrap or collide with its
    # sentinels), and descending it gives a float NULL the key of a
    # filtered row, so a filtered row can take a NULL row's place
    if kind == "float" and desc and with_nulls:
        return
    rmask = mask
    if kind == "int":
        rmask = mask & (data > -(1 << 62)) & (data < (1 << 62))
    rows = rde.CoprExecutor._topn_host(None, rdag, {0: (data, nulls, rsd)},
                                       rmask, M)
    nm = np.zeros(M, bool) if nulls is None else nulls

    def keys(idx):
        return [(bool(nm[i]), None if nm[i] else data[i]) for i in idx]
    assert keys(rows) == keys(_oracle(data, nulls, sd, rmask, desc, k))


def test_host_twin_keeps_a_null_key_apart_from_minus_one(kits):
    """The host twin groups a NULL key by its flag: the reference's
    _host_partial_agg sorted NULL as -1 and merged it with the group of
    -1 (its own device route keeps them apart). The port's host route
    equals the reference's device route."""
    ref, port = kits
    sql = "select n, count(*), sum(k) from t group by n order by n"
    want, route = _run(ref, sql)
    assert route["copr_device_exec"] == 1
    port.domain.copr.use_device = False
    try:
        got, host = _run(port, sql)
    finally:
        port.domain.copr.use_device = True
    assert host["copr_host_exec"] == 1
    assert got == want and want[0][0] == "<nil>" and want[5][0] == "-1"


@pytest.mark.parametrize("site,name", [("copr/agg", "agg_dense_small"),
                                       ("copr/filter", "filter_like"),
                                       ("copr/topn", "topn_int_desc_ties")])
def test_failed_reader_fragment_fails_the_statement_on_the_card(
        kits, site, name):
    """With degrading to the host off (the card's rule), a reader-DAG
    fragment whose dispatch fails fails its statement, and none of its
    work runs on the host; on the CPU's rule the host twin answers with
    the reference's rows."""
    from tidb_tpu_torch.errors import DeviceUnavailableError
    from tidb_tpu_torch.utils import failpoint
    ref, port = kits
    copr = port.domain.copr
    want, _ = _run(ref, STATEMENTS[name])
    failpoint.enable("device_guard/" + site, "error:generic")
    try:
        copr.degrade_to_host = False
        port_phase.reset()
        with pytest.raises(DeviceUnavailableError, match="generic"):
            port.must_query(STATEMENTS[name])
        assert port_phase.snap().get("host_execs", 0) == 0
        copr.degrade_to_host = True
        got, route = _run(port, STATEMENTS[name])
        assert got == want
        # the top-n degrades partition by partition to _topn_host, the
        # others the whole DAG to the host twin
        assert route["copr_host_exec"] == (0 if site == "copr/topn" else 1)
    finally:
        failpoint.disable("device_guard/" + site)
        copr.degrade_to_host = True
