"""EXPLAIN golden corpus (VERDICT r1 item 7; reference
pkg/planner/core/casetest — plan changes must be reviewable, not
silent). >=100 plans over the TPC-H schema + OLTP-shaped tables render
against tests/golden/explain_plans.txt.

Regenerate after an intentional planner change:
    TIDB_TPU_REGEN_GOLDEN=1 python -m pytest tests/test_explain_golden.py
then review the diff like any other code change.

The twin of tests/test_explain_golden.py on tidb_tpu_torch, with device="cpu" at
every store. It holds the port's plans to the reference's golden file
and never writes it: TIDB_TPU_REGEN_GOLDEN regenerates the file from
the reference (tests/test_explain_golden.py) only."""
import os

import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.bench.tpch import load_tpch, ALL_QUERIES

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "explain_plans.txt")


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


def _corpus():
    qs = [("tpch/" + name, sql) for name, sql in ALL_QUERIES.items()]
    t = "select %s from lineitem %s"
    extra = {
        # scan/filter/pushdown shapes
        "scan/full": "select l_quantity from lineitem",
        "scan/filter": "select l_quantity from lineitem "
                       "where l_shipdate > '1995-01-01'",
        "scan/proj_expr": "select l_extendedprice * (1 - l_discount) "
                          "from lineitem where l_tax > 0.02",
        "scan/limit": "select l_orderkey from lineitem limit 10",
        "scan/topn": "select l_orderkey from lineitem "
                     "order by l_extendedprice desc limit 5",
        "scan/host_filter": "select count(*) from part "
                            "where p_type like '%BRASS'",
        # aggregation shapes
        "agg/global": "select sum(l_quantity), count(*) from lineitem",
        "agg/dense_group": "select l_returnflag, l_linestatus, count(*) "
                           "from lineitem group by 1, 2",
        "agg/wide_group": "select l_orderkey, sum(l_quantity) "
                          "from lineitem group by l_orderkey",
        "agg/having": "select l_returnflag, count(*) from lineitem "
                      "group by 1 having count(*) > 10",
        "agg/distinct": "select count(distinct l_suppkey) from lineitem",
        "agg/avg_min_max": "select avg(l_quantity), min(l_shipdate), "
                           "max(l_discount) from lineitem",
        "agg/expr_group": "select year(l_shipdate), sum(l_quantity) "
                          "from lineitem group by 1",
        # join shapes
        "join/fused_two": "select n_name, count(*) from supplier, nation "
                          "where s_nationkey = n_nationkey group by 1",
        "join/hash_two": "select count(*) from lineitem, part "
                         "where l_partkey = p_partkey "
                         "and p_retailprice > 1000",
        "join/left": "select c_custkey, o_orderkey from customer "
                     "left join orders on c_custkey = o_custkey",
        "join/semi": "select s_name from supplier where s_suppkey in "
                     "(select l_suppkey from lineitem "
                     "where l_quantity > 45)",
        "join/cartesian": "select count(*) from region, nation",
        "join/merge_hint": "select /*+ MERGE_JOIN(orders) */ count(*) "
                           "from customer, orders "
                           "where c_custkey = o_custkey",
        "join/inl_hint": "select /*+ INL_JOIN(customer) */ c_name "
                         "from region, customer "
                         "where r_regionkey = c_custkey",
        "join/hash_hint": "select /*+ HASH_JOIN(nation) */ count(*) "
                          "from supplier, nation "
                          "where s_nationkey = n_nationkey",
        # point / index paths (oltp table below)
        "point/pk": "select v from oltp where id = 7",
        "point/batch": "select v from oltp where id in (1, 2, 3)",
        "point/unique": "select id from oltp where u = 1007",
        "index/range": "select v from oltp where k > 9990",
        "index/merge_or": "select v from oltp where k > 9995 or u < 1002",
        # sort / window / set ops
        "sort/order": "select l_orderkey from lineitem "
                      "order by l_shipdate, l_orderkey limit 20",
        "window/rank": "select o_custkey, rank() over "
                       "(partition by o_custkey order by o_totalprice) "
                       "from orders limit 5",
        "set/union": "select n_name from nation "
                     "union select r_name from region",
        "misc/dual": "select 1 + 1",
        "misc/subq_from": "select t.c from (select count(*) c "
                          "from nation) t",
        "misc/exists": "select r_name from region where exists "
                       "(select 1 from nation "
                       "where n_regionkey = r_regionkey)",
        "misc/case": "select sum(case when l_discount > 0.05 then 1 "
                     "else 0 end) from lineitem",
        "misc/between": "select count(*) from orders where o_orderdate "
                        "between '1994-01-01' and '1994-12-31'",
    }
    qs.extend(sorted(extra.items()))
    # parametric variants: per-column aggregates over lineitem (pads the
    # corpus with real, distinct plans — filter/agg combinations)
    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax"]
    cmps = [("gt", ">"), ("lt", "<")]
    for c in cols:
        for cn, op in cmps:
            qs.append((f"gen/{c}_{cn}",
                       f"select sum({c}) from lineitem where {c} {op} 1"))
            qs.append((f"gen/{c}_{cn}_grp",
                       f"select l_returnflag, max({c}) from lineitem "
                       f"where {c} {op} 1 group by l_returnflag"))
            qs.append((f"gen/{c}_{cn}_topn",
                       f"select l_orderkey, {c} from lineitem "
                       f"where {c} {op} 1 order by {c} desc limit 3"))
    for tbl, key in (("nation", "n_nationkey"), ("region", "r_regionkey"),
                     ("supplier", "s_suppkey"), ("customer", "c_custkey"),
                     ("orders", "o_orderkey"), ("part", "p_partkey")):
        qs.append((f"gen/count_{tbl}", f"select count(*) from {tbl}"))
        qs.append((f"gen/point_{tbl}",
                   f"select * from {tbl} where {key} = 1"))
    for q in ("q1", "q3", "q5", "q6", "q10", "q12", "q14", "q18",
              "q19", "q22"):
        qs.append((f"nompp/{q}", "/*MPPOFF*/" + ALL_QUERIES[q]))
    return qs


@pytest.fixture(scope="module")
def tk():
    tk = TestKit(device="cpu")
    load_tpch(tk, sf=0.01, seed=11)
    tk.must_exec("create table oltp (id int primary key, k int, "
                 "u int, v varchar(16), key ik (k), unique key uk (u))")
    rows = ",".join(f"({i}, {10000 - i}, {1000 + i}, 'v{i}')"
                    for i in range(1, 2001))
    tk.must_exec(f"insert into oltp values {rows}")
    tk.must_exec("analyze table oltp")
    return tk


def _render(tk, name, sql):
    if sql.startswith("/*MPPOFF*/"):
        tk.must_exec("set tidb_enable_mpp = 0")
        tk.domain.invalidate_plan_cache()
        try:
            rows = tk.must_query("explain " + sql[10:]).rs.rows
        finally:
            tk.must_exec("set tidb_enable_mpp = 1")
            tk.domain.invalidate_plan_cache()
    else:
        rows = tk.must_query("explain " + sql).rs.rows
    out = [f"==== {name}"]
    out.extend(f"{r[0]}\t{r[1]}\t{r[2]}" for r in rows)
    return "\n".join(out)


def test_explain_golden(tk):
    corpus = _corpus()
    assert len(corpus) >= 100, len(corpus)
    rendered = "\n".join(_render(tk, name, sql) for name, sql in corpus)
    assert os.path.exists(GOLDEN), GOLDEN
    want = open(GOLDEN).read().rstrip("\n")
    got = rendered.rstrip("\n")
    if got != want:
        import difflib
        diff = "\n".join(difflib.unified_diff(
            want.splitlines(), got.splitlines(), "golden", "current",
            lineterm=""))
        raise AssertionError("plan corpus changed:\n" + diff[:8000])
