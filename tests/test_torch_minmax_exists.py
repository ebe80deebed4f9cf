"""Min/max decorrelation of correlated EXISTS with one monotone
comparison (builder._try_minmax_exists, the classic TPC-H Q21
self-join reduction): EXISTS(SELECT … WHERE t.k = outer.k AND
t.c <op> outer.e) becomes a LEFT join against GROUP BY k → MIN/MAX(c).

Oracle: brute-force evaluation in Python over small tables with NULLs
in every role (inner key, inner value, outer key, outer value) — the
engine's own device-vs-host comparison cannot catch a rewrite bug
because both paths share the logical plan.

The twin of tests/test_minmax_exists.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.testkit import TestKit

ROWS_T = [(1, 10, 5), (2, 10, 7), (3, 20, 5), (4, 30, None),
          (5, None, 1), (6, 40, 4), (7, 50, 2)]
ROWS_U = [(1, 10, 5, 1), (2, 10, 5, 0), (3, 10, 8, 1), (4, 20, 5, 1),
          (5, 20, 5, 0), (6, 30, 2, 1), (7, 30, None, 1), (8, 40, 4, 0),
          (9, 40, 9, 0), (10, 60, 1, 1)]


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
    tk.must_exec("create table t (id int primary key, k int, c int)")
    tk.must_exec("create table u (id int primary key, k int, c int, "
                 "late int)")
    for r in ROWS_T:
        tk.must_exec("insert into t values (%s,%s,%s)" % tuple(
            "NULL" if v is None else str(v) for v in r))
    for r in ROWS_U:
        tk.must_exec("insert into u values (%s,%s,%s,%s)" % tuple(
            "NULL" if v is None else str(v) for v in r))
    return tk


OPS = {
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def brute(op, extra=None, negated=False):
    def sat(t, u):
        if t[1] is None or u[1] != t[1]:
            return False
        if u[2] is None or t[2] is None or not OPS[op](u[2], t[2]):
            return False
        return extra is None or extra(u)
    ids = [t[0] for t in ROWS_T
           if any(sat(t, u) for u in ROWS_U) != negated]
    return sorted(ids)


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("neg", ["exists", "not exists"])
def test_minmax_exists_ops(tk, op, neg):
    sql = (f"select id from t where {neg} (select * from u "
           f"where u.k = t.k and u.c {op} t.c) order by id")
    got = [r[0] for r in tk.must_query(sql).rows]
    assert got == brute(op, negated=neg == "not exists"), (op, neg)


@pytest.mark.parametrize("neg", ["exists", "not exists"])
def test_minmax_exists_inner_filter(tk, neg):
    # uncorrelated inner predicate (Q21's l3.l_receiptdate >
    # l3.l_commitdate class) stays inside the aggregated subplan
    sql = (f"select id from t where {neg} (select * from u "
           f"where u.k = t.k and u.c <> t.c and u.late = 1) order by id")
    got = [r[0] for r in tk.must_query(sql).rows]
    want = brute("<>", extra=lambda u: u[3] == 1,
                 negated=neg == "not exists")
    assert got == want


def test_minmax_exists_flipped_sides(tk):
    # outer expr on the left: t.c > u.c  ==  u.c < t.c
    a = [r[0] for r in tk.must_query(
        "select id from t where exists (select * from u "
        "where u.k = t.k and t.c > u.c) order by id").rows]
    assert a == brute("<")


def test_minmax_plan_has_no_semi_join(tk):
    rows = tk.must_query(
        "explain select id from t where exists (select * from u "
        "where u.k = t.k and u.c <> t.c)").rows
    txt = "\n".join(str(r) for r in rows)
    assert "semi" not in txt and "anti" not in txt
    assert "min" in txt and "max" in txt


def test_exists_without_disequality_keeps_semi_join(tk):
    rows = tk.must_query(
        "explain select id from t where exists (select * from u "
        "where u.k = t.k)").rows
    txt = "\n".join(str(r) for r in rows)
    assert "semi" in txt
