"""The evaluator's builtin families through SQL (tidb_tpu_torch against
the reference, both on the CPU): one or two statements per family (math,
casts, dates, strings, JSON text made by CONCAT over a dictionary
column, bits over BIGINT UNSIGNED at and above 2^63, NULL logic) over a
5,000-row table, so a group-by is a zero-dim fused pipeline and a
filter-only statement a reader DAG (tidb_tpu_fragment_min_rows = 0).
Rows must equal the reference's (integers and decimals exactly, floats
to rtol 1e-9), and each statement must run on the port's device route
(fused_pipeline_hit or copr_device_exec) with no decline, host-bound
shape or fallback. A shape whose device form reads the host (CAST of an
int to CHAR) is declined by the device rule before dispatch, with its
reason, where the reference's trace fails and degrades to the host. A
warm string statement builds no dictionary table. One statement runs on
TestKit(device="cpu", mesh=4) on the mesh route."""
import numpy as np
import pytest

from tidb_tpu.testkit import TestKit as RefKit

from tidb_tpu_torch.expression import vec as port_vec
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import phase as port_phase

N = 5000
ROUTES = ("fused_pipeline_hit", "fused_pipeline_mpp_hit",
          "fused_pipeline_fallback", "fused_pipeline_error",
          "copr_device_exec", "copr_mpp_exec", "copr_host_exec",
          "copr_host_bound")
WORDS = ["apple", "Banana", "berry", "cherry ", "apricot", "blue", "a", "",
         "Ünï", "x'y"]


def _rows():
    """The table's rows as SQL literals, from a seeded generator: NULLs
    in s, f, u and n; unsigned values on both sides of 2^63."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(1, N + 1):
        g = int(rng.integers(0, 6))
        k = int(rng.integers(-50, 101))
        s = "NULL" if rng.random() < 0.05 else \
            "'" + WORDS[int(rng.integers(0, len(WORDS)))].replace(
                "'", "''") + "'"
        d = f"{int(rng.integers(-50000, 100000)) / 100:.2f}"
        f = "NULL" if rng.random() < 0.05 else \
            repr(float(np.round(rng.normal(0, 1000), 3)))
        dt = f"'{int(rng.integers(1996, 2025))}-" \
            f"{int(rng.integers(1, 13)):02d}-{int(rng.integers(1, 29)):02d}'"
        ts = f"'2020-{int(rng.integers(1, 13)):02d}-" \
            f"{int(rng.integers(1, 29)):02d} {int(rng.integers(0, 24)):02d}:" \
            f"{int(rng.integers(0, 60)):02d}:{int(rng.integers(0, 60)):02d}'"
        u = "NULL" if rng.random() < 0.05 else str(
            int(rng.integers(0, 1 << 63)) * (2 if rng.random() < 0.5 else 1)
            + int(rng.integers(0, 2)))
        n = "NULL" if rng.random() < 0.1 else str(int(rng.integers(-5, 40)))
        out.append(f"({i},{g},{k},{s},{d},{f},{dt},{ts},{u},{n})")
    return out


DDL = ("create table t (id int primary key, g int, k int, s varchar(20), "
       "d decimal(10,2), f double, dt date, ts datetime, "
       "u bigint unsigned, n int)")


def _load(kit):
    kit.must_exec(DDL)
    rows = _rows()
    for i in range(0, len(rows), 500):
        kit.must_exec("insert into t values " + ",".join(rows[i:i + 500]))
    kit.domain.copr.device_rows = 2048
    kit.must_exec("set tidb_tpu_fragment_min_rows = 0")
    return kit


@pytest.fixture(autouse=True)
def _torch_registries():
    from tidb_tpu_torch.utils import metrics, device_guard
    metrics.reset_all()
    device_guard.reset()
    port_phase.reset()
    yield


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
    "math": "select g, count(*), sum(round(f, 1)), sum(abs(d)), "
            "sum(floor(f)), sum(truncate(d, 1)), max(sqrt(abs(f))), "
            "sum(pow(k, 2)), sum(ceil(d)) from t where sign(d) >= 0 and "
            "ln(abs(k) + 1) > 1 group by g order by g",
    "math_filter": "select id, round(f, 2) from t where round(f, 1) > 100 "
                   "and abs(k) < 20 and degrees(atan2(k, 3)) > 0 "
                   "order by id",
    "casts": "select g, sum(cast(d as signed)), sum(cast(f as "
             "decimal(12,2))), sum(cast(k as double)), count(*) from t "
             "where cast(s as char) like 'b%' or cast(s as signed) = 0 "
             "group by g order by g",
    "dates": "select quarter(dt), count(*), sum(datediff(dt, "
             "'2020-01-01')), max(dayofweek(dt)), min(week(dt)), "
             "sum(hour(ts)), max(to_days(dt)), min(last_day(dt)) from t "
             "where dayofyear(dt) > 40 group by quarter(dt) order by 1",
    "dates_filter": "select id from t where dayofweek(dt) = 1 and "
                    "timestampdiff(month, dt, ts) > 3 and "
                    "unix_timestamp(ts) > 1590000000 order by id",
    "strings": "select upper(s), count(*), sum(length(s)), max(crc32(s)) "
               "from t where locate('a', s) > 0 group by upper(s) "
               "order by 1",
    "strings_filter": "select id from t where md5(s) like 'a%' or "
                      "hex(s) like '61%' or reverse(trim(s)) = 'yrreb' "
                      "order by id",
    "json": "select json_extract(concat('{\"w\": \"', s, '\"}'), '$.w'), "
            "count(*), sum(json_valid(concat('[', s, ']'))) from t "
            "group by 1 order by 1",
    "bits": "select count(*), sum(bit_count(u)), sum(u & 255), "
            "sum(u >> 60), sum((u | 1) ^ 3) from t "
            "where u > 9223372036854775807",
    "uint_cast": "select g, count(*), sum(bit_count(cast(k as unsigned))),"
                 " max(cast(k as unsigned) << 2) from t where cast(k as "
                 "unsigned) > 9223372036854775807 group by g order by g",
    "null_logic": "select g, count(*), sum(nullif(k, 5)), "
                  "sum(greatest(k, n)), sum(n <=> k), sum(least(k, 3)) "
                  "from t where (n > 3) is true group by g order by g",
}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_builtin_family_on_device_route(kits, name):
    ref, port = kits
    sql = STATEMENTS[name]
    want, _ = _run(ref, sql)
    got, route = _run(port, sql)
    _match(got, want)
    assert route["fused_pipeline_hit"] + route["copr_device_exec"] >= 1, \
        route
    for bad in ("fused_pipeline_fallback", "fused_pipeline_error",
                "copr_host_bound"):
        assert route[bad] == 0, (bad, route,
                                 port.domain.last_fused_reason)


@pytest.mark.parametrize("sql,route_key", [
    ("select g, count(*) from t where cast(k as char) like '1%' "
     "group by g order by g", "fused"),
    ("select id from t where concat(s, k) like 'a%' order by id",
     "reader"),
])
def test_host_bound_shape_declined_by_rule(kits, sql, route_key):
    """The reference traces the fragment, fails on the host read and
    degrades to its host twin; the port's rule declines the shape before
    dispatch, with its reason. Rows are the reference's."""
    ref, port = kits
    want, _ = _run(ref, sql)
    got, route = _run(port, sql)
    _match(got, want)
    assert route["fused_pipeline_hit"] == route["copr_device_exec"] == 0
    assert route["fused_pipeline_error"] == 0
    if route_key == "fused":
        assert route["fused_pipeline_fallback"] == 1
        assert port.domain.last_fused_reason == \
            "host-bound shape: cast_char of int"
    else:
        assert route["copr_host_bound"] == 1
        assert port.domain.copr.last_host_reason == \
            "host-bound shape: concat of int"


def test_warm_string_statement_builds_no_dictionary_table(kits):
    _, port = kits
    sql = STATEMENTS["strings"]
    port.must_query(sql)
    builds = port_vec.DICT_TABLE_STATS["builds"]
    hits = port_vec.DICT_TABLE_STATS["hits"]
    port.must_query(sql)
    assert port_vec.DICT_TABLE_STATS["builds"] == builds
    assert port_vec.DICT_TABLE_STATS["hits"] > hits


def test_round_digits_do_not_share_a_program(kits):
    """ROUND(x, 1) and ROUND(x, 2) differ in the fragment cache key."""
    ref, port = kits
    for d in (1, 2, 1):
        sql = f"select g, sum(round(f, {d})) from t group by g order by g"
        want, _ = _run(ref, sql)
        got, route = _run(port, sql)
        _match(got, want)
        assert route["fused_pipeline_hit"] == 1


def test_builtins_on_the_mesh(kits):
    """The math statement on four CPU shards: the mesh route, and the
    reference's rows."""
    ref, _ = kits
    mesh = _load(PortKit(device="cpu", mesh=4))
    mesh.must_exec("set @@tidb_mpp_min_rows = 0")
    for name in ("math", "bits"):
        want, _ = _run(ref, STATEMENTS[name])
        got, route = _run(mesh, STATEMENTS[name])
        _match(got, want)
        assert route["fused_pipeline_mpp_hit"] + route["copr_mpp_exec"] \
            >= 1, route
        assert route["fused_pipeline_fallback"] == 0


@pytest.fixture(scope="module")
def tpch_kits():
    from tidb_tpu.bench.tpch import load_tpch as ref_load
    from tidb_tpu_torch.bench.tpch import load_tpch as port_load
    ref, port = RefKit(), PortKit(device="cpu")
    ref_load(ref, sf=0.01, seed=7)
    port_load(port, sf=0.01, seed=7)
    return ref, port


def _builtin_case_names():
    from tidb_tpu_torch.bench.tpch import BUILTIN_CASES
    return [c[0] for c in BUILTIN_CASES]


@pytest.mark.parametrize("name", _builtin_case_names())
def test_builtin_cases_equal_reference(tpch_kits, name):
    """chip_smoke.py phase_builtins' statements (bench/tpch.py
    BUILTIN_CASES) at SF0.01: the reference's rows, and the case's
    route (at this scale customer is under the 4,096 rows at which a
    group-by becomes a fused pipeline: a reader DAG on the device)."""
    from tidb_tpu_torch.bench.tpch import BUILTIN_CASES
    _n, sql, route, reason = next(c for c in BUILTIN_CASES if c[0] == name)
    ref, port = tpch_kits
    want, _ = _run(ref, sql)
    got, r = _run(port, sql)
    _match(got, want)
    assert r["fused_pipeline_error"] == 0
    if route == "declined":
        # customer's group-by is a reader DAG here, which the rule sends
        # to the host
        assert port.domain.copr.last_host_reason == reason
        assert r["copr_host_bound"] == 1
        assert r["fused_pipeline_hit"] == r["copr_device_exec"] == 0
    else:
        assert r["fused_pipeline_hit"] + r["copr_device_exec"] == 1, r
        assert r["fused_pipeline_fallback"] == r["copr_host_bound"] == 0


def test_sum_of_a_comparison_counts_on_both_routes(kits):
    """SUM(a = b) in a group-by counts the rows where it is true, on the
    device route and on the host twin alike (a scatter-add or reduceat
    in bool would OR them: the reference's host twin does, its device
    route counts; ROADMAP C)."""
    ref, port = kits
    sql = "select g, sum(n = k), sum(k > 90) from t group by g order by g"
    want, _ = _run(ref, sql)
    got, route = _run(port, sql)
    _match(got, want)
    assert route["fused_pipeline_hit"] == 1
    assert max(int(r[2]) for r in want) > 1
    port.domain.copr.use_device = False
    try:
        host, _ = _run(port, sql)
    finally:
        port.domain.copr.use_device = True
    _match(host, want)
