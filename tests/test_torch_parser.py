"""Parser: statements, expressions, precedence, TPC-H query shapes.

The twin of tests/test_parser.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.parser import parse_one, parse, normalize_digest
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.errors import ParseError


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


class TestSelect:
    def test_basic(self):
        s = parse_one("SELECT a, b+1 AS c FROM t WHERE a > 5 ORDER BY b DESC LIMIT 10")
        assert isinstance(s, ast.SelectStmt)
        assert len(s.fields) == 2
        assert s.fields[1].alias == "c"
        assert isinstance(s.where, ast.BinaryOp) and s.where.op == ">"
        assert s.order_by[0].desc
        assert s.limit.count.value == 10

    def test_wildcard(self):
        s = parse_one("select * from t")
        assert isinstance(s.fields[0], ast.Wildcard)
        s = parse_one("select t.* , a from t")
        assert s.fields[0].table == "t"

    def test_joins(self):
        s = parse_one(
            "select * from a join b on a.x=b.x left join c using(y), d")
        j = s.from_clause
        assert isinstance(j, ast.Join) and j.join_type == "cross"
        assert isinstance(j.left, ast.Join) and j.left.join_type == "left"
        assert j.left.using == ["y"]

    def test_group_having(self):
        s = parse_one("select a, count(*) from t group by a having count(*) > 2")
        assert len(s.group_by) == 1
        assert isinstance(s.having, ast.BinaryOp)

    def test_subqueries(self):
        s = parse_one("select * from (select a from t) x where a in (select b from u)")
        assert isinstance(s.from_clause, ast.SubqueryTable)
        assert s.from_clause.alias == "x"
        assert isinstance(s.where, ast.InSubquery)

    def test_exists_scalar(self):
        s = parse_one("select (select max(a) from t), 1 from u where exists (select 1 from v)")
        assert isinstance(s.fields[0].expr, ast.ScalarSubquery)
        assert isinstance(s.where, ast.ExistsSubquery)

    def test_union(self):
        s = parse_one("select a from t union all select b from u order by 1 limit 3")
        assert s.setops[0][0] == "union all"
        assert s.limit.count.value == 3

    def test_distinct_agg(self):
        s = parse_one("select count(distinct a), sum(b) from t")
        assert s.fields[0].expr.distinct
        assert not s.fields[1].expr.distinct


class TestExprs:
    def q(self, e):
        return parse_one(f"select {e}").fields[0].expr

    def test_precedence(self):
        e = self.q("1 + 2 * 3")
        assert e.op == "+" and e.right.op == "*"
        e = self.q("a or b and c")
        assert e.op == "or" and e.right.op == "and"
        e = self.q("not a = b")   # NOT (a=b)
        assert e.op == "not" and e.operand.op == "="

    def test_predicates(self):
        e = self.q("a between 1 and 2")
        assert isinstance(e, ast.Between)
        e = self.q("a not in (1,2,3)")
        assert isinstance(e, ast.InList) and e.negated and len(e.items) == 3
        e = self.q("a is not null")
        assert isinstance(e, ast.IsNull) and e.negated
        e = self.q("name like 'abc%'")
        assert isinstance(e, ast.Like)

    def test_case(self):
        e = self.q("case when a>1 then 'x' else 'y' end")
        assert isinstance(e, ast.Case) and e.operand is None
        e = self.q("case a when 1 then 'x' when 2 then 'z' end")
        assert len(e.when_clauses) == 2

    def test_cast(self):
        e = self.q("cast(a as decimal(10,2))")
        assert isinstance(e, ast.Cast) and e.flen == 10 and e.decimal == 2

    def test_date_arith(self):
        e = self.q("d + interval 3 day")
        assert isinstance(e, ast.FuncCall) and e.name == "date_add"
        e = self.q("date '1994-01-01'")
        assert isinstance(e, ast.FuncCall)

    def test_negative_literal(self):
        e = self.q("-5")
        assert isinstance(e, ast.Literal) and e.value == -5

    def test_string_concat_chain(self):
        e = self.q("concat(a, '-', b)")
        assert isinstance(e, ast.FuncCall) and len(e.args) == 3

    def test_any_all(self):
        e = self.q("a > all (select b from t)")
        assert isinstance(e, ast.CompareSubquery) and e.quantifier == "all"


class TestDDLDML:
    def test_create_table(self):
        s = parse_one("""
        CREATE TABLE t (
          id BIGINT PRIMARY KEY AUTO_INCREMENT,
          name VARCHAR(64) NOT NULL DEFAULT 'x',
          price DECIMAL(15,2),
          created DATE,
          KEY idx_name (name),
          UNIQUE uk (price, created)
        ) ENGINE=InnoDB
        """)
        assert isinstance(s, ast.CreateTableStmt)
        assert len(s.columns) == 4
        assert s.columns[0].primary_key and s.columns[0].auto_increment
        assert s.columns[1].not_null and s.columns[1].default_value == "x"
        assert len(s.indexes) == 2
        assert s.indexes[1].unique

    def test_insert(self):
        s = parse_one("insert into t (a,b) values (1,'x'),(2,'y')")
        assert len(s.values) == 2
        s = parse_one("insert into t select * from u")
        assert s.select is not None
        s = parse_one("replace into t values (1)")
        assert s.is_replace

    def test_update_delete(self):
        s = parse_one("update t set a=a+1, b=2 where id=3")
        assert len(s.assignments) == 2
        s = parse_one("delete from t where a<5 limit 2")
        assert s.limit.count.value == 2

    def test_alter(self):
        s = parse_one("alter table t add column c int, drop column d, add index (e)")
        kinds = [a[0] for a in s.actions]
        assert kinds == ["add_column", "drop_column", "add_index"]

    def test_misc(self):
        assert isinstance(parse_one("begin"), ast.BeginStmt)
        assert isinstance(parse_one("start transaction"), ast.BeginStmt)
        assert isinstance(parse_one("commit"), ast.CommitStmt)
        s = parse_one("set @@global.tidb_mem_quota_query = 123, autocommit=on")
        assert s.assignments[0][2] is True
        s = parse_one("show tables from test like 't%'")
        assert s.kind == "tables" and s.like == "t%"
        s = parse_one("explain analyze select 1")
        assert s.analyze
        s = parse_one("drop table if exists a, b")
        assert s.if_exists and len(s.tables) == 2

    def test_multi_stmt(self):
        stmts = parse("select 1; select 2;")
        assert len(stmts) == 2

    def test_error(self):
        with pytest.raises(ParseError):
            parse_one("select from where")
        with pytest.raises(ParseError):
            parse_one("selekt 1")


TPCH_Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval 90 day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

TPCH_Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
  o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10
"""

TPCH_Q5 = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval 1 year
group by n_name order by revenue desc
"""

TPCH_Q6 = """
select sum(l_extendedprice * l_discount) as revenue from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval 1 year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24
"""


@pytest.mark.parametrize("q", [TPCH_Q1, TPCH_Q3, TPCH_Q5, TPCH_Q6],
                         ids=["q1", "q3", "q5", "q6"])
def test_tpch_shapes(q):
    s = parse_one(q)
    assert isinstance(s, ast.SelectStmt)


def test_digest():
    n1, d1 = normalize_digest("SELECT * FROM t WHERE a = 5 AND b IN (1,2,3)")
    n2, d2 = normalize_digest("select * from t where a = 99 and b in (7)")
    assert d1 == d2
    n3, d3 = normalize_digest("select * from t where a = 5 and c in (1)")
    assert d3 != d1


def test_select_modifiers():
    from tidb_tpu_torch.testkit import TestKit
    tk = TestKit(device="cpu")
    tk.must_exec("create table sm (sql_cache int, a int)")
    tk.must_exec("insert into sm values (1, 2)")
    # non-reserved modifier words stay usable as column names
    assert tk.must_query("select sql_cache from sm").rs.rows == [(1,)]
    assert tk.must_query("select sql_cache, a from sm").rs.rows == [(1, 2)]
    # modifier forms, any order
    assert tk.must_query("select sql_no_cache a from sm").rs.rows == [(2,)]
    assert tk.must_query(
        "select straight_join distinct a from sm").rs.rows == [(2,)]
    assert tk.must_query(
        "select high_priority straight_join a from sm").rs.rows == [(2,)]


def test_unix_timestamp_invalid_null():
    from tidb_tpu_torch.testkit import TestKit
    tk = TestKit(device="cpu")
    assert tk.must_query("select unix_timestamp('garbage')").rs.rows == \
        [(None,)]
