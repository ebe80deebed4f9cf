"""Round-5 grammar tail: named WINDOW clauses, index hints + invisible
indexes, hex/bit/introducer literals, expression COLLATE, insert row
aliases, MEMBER OF, FOR UPDATE OF, pre-FROM INTO OUTFILE.
Reference grammar: pkg/parser/parser.y
(WindowClauseOptional, IndexHintList, AlterTableAlterIndex...).

The twin of tests/test_sql_tail8.py on tidb_tpu_torch, with device="cpu" at
every store."""
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
    return TestKit(device="cpu")


def rows(tk, sql):
    return tk.must_query(sql).rs.rows


def test_named_window(tk):
    tk.must_exec("create table t (a int, b int)")
    tk.must_exec("insert into t values (1,1),(2,1),(3,2),(4,2)")
    got = rows(tk, "select a, sum(a) over w, rank() over w from t "
                   "window w as (partition by b order by a) order by a")
    assert [(r[0], int(r[1]), int(r[2])) for r in got] == \
        [(1, 1, 1), (2, 3, 2), (3, 3, 1), (4, 7, 2)]


def test_named_window_inheritance(tk):
    tk.must_exec("create table t (a int, b int)")
    tk.must_exec("insert into t values (1,1),(2,1),(3,2)")
    got = rows(tk, "select a, count(*) over w2 from t "
                   "window w as (partition by b), w2 as (w order by a) "
                   "order by a")
    assert [(r[0], int(r[1])) for r in got] == [(1, 1), (2, 2), (3, 1)]


def test_hex_bit_introducer_literals(tk):
    got = rows(tk, "select x'4D', b'01001101', _utf8mb4'ok', n'nat'")
    assert list(got[0]) == ["M", "M", "ok", "nat"]


def test_collate_expr(tk):
    tk.must_exec("create table t (s varchar(10))")
    tk.must_exec("insert into t values ('a'), ('B'), ('c')")
    got = rows(tk, "select s from t order by s collate "
                   "utf8mb4_general_ci")
    assert [r[0] for r in got] == ["a", "B", "c"]
    # case-insensitive equality via explicit collate
    got = rows(tk, "select count(*) from t "
                   "where s collate utf8mb4_general_ci = 'b'")
    assert int(got[0][0]) == 1


def test_member_of(tk):
    got = rows(tk, "select 2 member of ('[1,2,3]'), "
                   "5 member of ('[1,2,3]')")
    assert [int(got[0][0]), int(got[0][1])] == [1, 0]


def test_insert_row_alias(tk):
    tk.must_exec("create table t (id int primary key, a int, b int)")
    tk.must_exec("insert into t values (1, 10, 100)")
    tk.must_exec("insert into t values (1, 20, 200) as new "
                 "on duplicate key update a = new.a + 1, b = new.b")
    assert [tuple(map(int, r)) for r in rows(
        tk, "select id, a, b from t")] == [(1, 21, 200)]
    tk.must_exec("insert into t (id, a, b) values (1, 30, 300) as "
                 "new(i, m, n) on duplicate key update a = m + n")
    assert [tuple(map(int, r)) for r in rows(
        tk, "select id, a, b from t")] == [(1, 330, 200)]


def test_index_hints_and_invisible(tk):
    tk.must_exec("create table t (id int primary key, k int, v int, "
                 "key ik (k))")
    tk.must_exec("insert into t values " + ",".join(
        f"({i}, {i % 50}, {i})" for i in range(500)))
    plan = "\n".join(r[0] for r in rows(
        tk, "explain select * from t where k = 7"))
    assert "ik" in plan or "IndexRange" in plan, plan
    # IGNORE INDEX drops the index path
    plan_ign = "\n".join(r[0] for r in rows(
        tk, "explain select * from t ignore index (ik) where k = 7"))
    assert "IndexRange" not in plan_ign, plan_ign
    # invisible index: still maintained, not used for access
    tk.must_exec("alter table t alter index ik invisible")
    plan_inv = "\n".join(r[0] for r in rows(
        tk, "explain select * from t where k = 7"))
    assert "IndexRange" not in plan_inv, plan_inv
    assert len(rows(tk, "select id from t where k = 7")) == 10
    tk.must_exec("insert into t values (1000, 7, 7)")
    tk.must_exec("alter table t alter index ik visible")
    # the index was maintained while invisible: the new row is found
    # through it once visible (ANALYZE refreshes the modify-count so
    # the cost model re-prefers the index path)
    tk.must_exec("analyze table t")
    assert len(rows(tk, "select id from t where k = 7")) == 11
    plan_back = "\n".join(r[0] for r in rows(
        tk, "explain select * from t force index (ik) where k = 7"))
    assert "IndexRange" in plan_back, plan_back


def test_fulltext_parsed_ignored(tk):
    tk.must_exec("create table t (a int, s varchar(64))")
    tk.must_exec("alter table t add fulltext index ft (s)")
    w = rows(tk, "show warnings")
    assert any("FULLTEXT" in r[2] for r in w), w


def test_for_update_of(tk):
    tk.must_exec("create table t (a int primary key)")
    tk.must_exec("insert into t values (1)")
    assert len(rows(tk, "select * from t for update of t")) == 1


def test_into_outfile_pre_from(tk, tmp_path):
    tk.must_exec("create table t (a int, s varchar(8))")
    tk.must_exec("insert into t values (1, 'x'), (2, 'y')")
    p = str(tmp_path / "o.csv")
    tk.must_exec(f"select * into outfile '{p}' from t order by a")
    txt = open(p).read()
    assert "1" in txt and "y" in txt


def test_insert_row_alias_no_column_list(tk):
    # col aliases map onto ALL table columns when no insert column
    # list is given (resolved at plan build, not parse)
    tk.must_exec("create table t (id int primary key, a int, b int)")
    tk.must_exec("insert into t values (1, 10, 100)")
    tk.must_exec("insert into t values (1, 30, 300) as new(i, m, n) "
                 "on duplicate key update a = m + n")
    got = tk.must_query("select id, a, b from t").rs.rows
    assert [tuple(map(int, r)) for r in got] == [(1, 330, 100)]


def test_window_clause_errors(tk):
    tk.must_exec("create table t (a int, b int)")
    with pytest.raises(Exception, match="defined twice"):
        tk.must_query("select sum(a) over w from t "
                      "window w as (order by a), w as (order by b)")


def test_index_hint_unknown_name_errors(tk):
    tk.must_exec("create table t (id int primary key, k int, key ik (k))")
    with pytest.raises(Exception, match="doesn't exist"):
        tk.must_query("select * from t use index (nope) where k = 1")
    # hinting an INVISIBLE index is also an error (MySQL 8)
    tk.must_exec("alter table t alter index ik invisible")
    with pytest.raises(Exception, match="doesn't exist"):
        tk.must_query("select * from t force index (ik) where k = 1")


def test_literal_introducer_no_hijack(tk):
    # x/b/n followed by a NON-adjacent string is a column + alias, and
    # `_foo` columns are not swallowed as charset introducers
    tk.must_exec("create table t (x int, _id int)")
    tk.must_exec("insert into t values (5, 6)")
    assert [r[0] for r in rows(tk, "select x 'col' from t")] == [5]
    assert [r[0] for r in rows(tk, "select _id 'c2' from t")] == [6]


def test_row_alias_insert_column_order(tk):
    # col aliases map onto the INSERT column list order, not the
    # table's column order
    tk.must_exec("create table t (a int primary key, b int)")
    tk.must_exec("insert into t values (1, 2)")
    tk.must_exec("insert into t (b, a) values (77, 1) as new(xx, yy) "
                 "on duplicate key update b = xx")
    assert [tuple(map(int, r)) for r in rows(
        tk, "select a, b from t")] == [(1, 77)]


def test_index_hint_error_code_1176(tk):
    tk.must_exec("create table t (a int primary key, k int, key ik (k))")
    try:
        tk.must_query("select * from t use index (nope) where k = 1")
        assert False, "expected error"
    except Exception as e:
        assert getattr(e, "code", None) == 1176


def test_adjacent_string_literal_concat(tk):
    # MySQL concatenates adjacent string literals (the implicit alias
    # rule must not hijack them)
    got = rows(tk, "select 'a' 'b', concat('x' 'y', 'z')")
    assert list(got[0]) == ["ab", "xyz"]


def test_row_alias_inside_case(tk):
    tk.must_exec("create table t (id int primary key, a int)")
    tk.must_exec("insert into t values (1, 10)")
    tk.must_exec("insert into t values (1, 30) as new on duplicate "
                 "key update a = case when new.a > 5 then new.a "
                 "else 0 end")
    assert [int(r[0]) for r in rows(tk, "select a from t")] == [30]
    tk.must_exec("insert into t values (1, 3) as new on duplicate "
                 "key update a = case when new.a > 5 then new.a "
                 "else 0 end")
    assert [int(r[0]) for r in rows(tk, "select a from t")] == [0]


def test_signal_and_get_diagnostics(tk):
    with pytest.raises(Exception) as ei:
        tk.must_exec("signal sqlstate '45000' set message_text = "
                     "'my oops', mysql_errno = 30001")
    assert getattr(ei.value, "code", None) == 30001
    assert "my oops" in str(ei.value)
    with pytest.raises(Exception) as ei:
        tk.must_exec("resignal")
    assert getattr(ei.value, "code", None) == 1645
    tk.must_exec("create table t (a int)")
    tk.must_exec("insert into t values (1), (2), (3)")
    tk.must_exec("get diagnostics @n = number, @rc = row_count")
    got = rows(tk, "select @n, @rc")
    assert [int(got[0][0]), int(got[0][1])] == [0, 3]
    tk.must_exec("alter table t add fulltext index ft (a)")
    tk.must_exec("get diagnostics condition 1 @m = message_text, "
                 "@e = mysql_errno")
    assert int(rows(tk, "select @e")[0][0]) == 1214
