"""SQL-level tests on the embedded store (reference tier-2 testing:
testkit against unistore, SURVEY.md §4).

The twin of tests/test_sql.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch import errors


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
    return TestKit(device="cpu")


@pytest.fixture()
def ftk():
    """Fresh store per test."""
    return TestKit(device="cpu")


class TestBasic:
    def test_select_literal(self, tk):
        tk.must_query("select 1").check([(1,)])
        tk.must_query("select 1+2*3, 'x'").check([(7, "x")])
        tk.must_query("select 10/4, 10 div 4, 10 % 3").check([("2.5000", 2, 1)])
        tk.must_query("select null").check([("<nil>",)])

    def test_create_insert_select(self, tk):
        tk.must_exec("drop table if exists t1")
        tk.must_exec("create table t1 (id int primary key, v varchar(10), "
                     "d decimal(10,2))")
        tk.must_exec("insert into t1 values (1,'a',1.5),(2,'b',2.5),"
                     "(3,null,null)")
        tk.must_query("select * from t1 order by id").check([
            (1, "a", "1.50"), (2, "b", "2.50"), (3, None, None)])
        tk.must_query("select v from t1 where d > 2").check([("b",)])
        tk.must_query("select id from t1 where v is null").check([(3,)])

    def test_duplicate_pk(self, tk):
        tk.must_exec("drop table if exists t2")
        tk.must_exec("create table t2 (id int primary key)")
        tk.must_exec("insert into t2 values (1)")
        e = tk.exec_err("insert into t2 values (1)")
        assert isinstance(e, errors.DuplicateKeyError)
        tk.must_exec("insert ignore into t2 values (1),(2)")
        tk.must_query("select count(*) from t2").check([(2,)])

    def test_update_delete(self, tk):
        tk.must_exec("drop table if exists t3")
        tk.must_exec("create table t3 (a int, b int)")
        tk.must_exec("insert into t3 values (1,10),(2,20),(3,30)")
        tk.must_exec("update t3 set b = b + 1 where a >= 2")
        tk.must_query("select b from t3 order by a").check([(10,), (21,), (31,)])
        tk.must_exec("delete from t3 where a = 2")
        tk.must_query("select a from t3 order by a").check([(1,), (3,)])
        assert tk.sess.vars.affected_rows == 1

    def test_auto_increment(self, tk):
        tk.must_exec("drop table if exists t4")
        tk.must_exec("create table t4 (id bigint primary key auto_increment, "
                     "v int)")
        tk.must_exec("insert into t4 (v) values (10),(20)")
        tk.must_exec("insert into t4 values (100, 30)")
        tk.must_exec("insert into t4 (v) values (40)")
        tk.must_query("select id, v from t4 order by id").check([
            (1, 10), (2, 20), (100, 30), (101, 40)])

    def test_null_constraints(self, tk):
        tk.must_exec("drop table if exists t5")
        tk.must_exec("create table t5 (a int not null, b int default 7)")
        e = tk.exec_err("insert into t5 values (null, 1)")
        assert isinstance(e, errors.BadNullError)
        tk.must_exec("insert into t5 (a) values (1)")
        tk.must_query("select * from t5").check([(1, 7)])


class TestExpressionsSQL:
    def test_string_funcs(self, tk):
        tk.must_query("select upper('abc'), lower('ABC'), length('héllo'), "
                      "concat('a','b','c')").check([("ABC", "abc", 6, "abc")])
        tk.must_query("select substring('hello', 2, 3), trim('  x  '), "
                      "replace('aaa','a','b')").check([("ell", "x", "bbb")])

    def test_case_if(self, tk):
        tk.must_query("select if(1 > 2, 'a', 'b'), ifnull(null, 5), "
                      "coalesce(null, null, 3)").check([("b", 5, 3)])
        tk.must_query("select case when 1=2 then 'x' when 1=1 then 'y' "
                      "else 'z' end").check([("y",)])

    def test_date_funcs(self, tk):
        tk.must_query("select year(date '1994-05-15'), month(date '1994-05-15'),"
                      " day(date '1994-05-15')").check([(1994, 5, 15)])
        tk.must_query("select date '1994-01-31' + interval 1 month")\
            .check([("1994-02-28",)])
        tk.must_query("select datediff('1994-01-10', '1994-01-01')")\
            .check([(9,)])
        tk.must_query("select extract(year from date '1999-12-31')")\
            .check([(1999,)])

    def test_math(self, tk):
        tk.must_query("select abs(-5), floor(2.7), ceil(2.1), round(2.567, 2)")\
            .check([(5, 2, 3, "2.57")])
        tk.must_query("select mod(10, 3), pow(2, 10), sqrt(16)")\
            .check([(1, 1024, 4)])

    def test_like_in(self, tk):
        tk.must_exec("drop table if exists ts")
        tk.must_exec("create table ts (s varchar(30))")
        tk.must_exec("insert into ts values ('apple'),('banana'),('cherry')")
        tk.must_query("select s from ts where s like 'b%'").check([("banana",)])
        tk.must_query("select s from ts where s like '%an%'").check([("banana",)])
        tk.must_query("select s from ts where s in ('apple','cherry') "
                      "order by s").check([("apple",), ("cherry",)])
        tk.must_query("select s from ts where s not in ('apple','cherry')")\
            .check([("banana",)])


class TestAggregation:
    def test_global_agg(self, tk):
        tk.must_exec("drop table if exists g")
        tk.must_exec("create table g (a int, b decimal(8,2), c varchar(10))")
        tk.must_exec("insert into g values (1,1.00,'x'),(2,2.50,'y'),"
                     "(3,null,'x'),(null,4.00,'z')")
        tk.must_query("select count(*), count(a), count(b) from g")\
            .check([(4, 3, 3)])
        tk.must_query("select sum(b), min(b), max(b), avg(b) from g")\
            .check([("7.50", "1.00", "4.00", "2.500000")])
        tk.must_query("select sum(a) from g where a > 100").check([(None,)])
        tk.must_query("select count(*) from g where a > 100").check([(0,)])

    def test_group_by(self, tk):
        tk.must_exec("drop table if exists g2")
        tk.must_exec("create table g2 (k varchar(5), v int)")
        tk.must_exec("insert into g2 values ('a',1),('b',2),('a',3),('b',4),"
                     "('c',5),(null,6)")
        tk.must_query("select k, sum(v), count(*) from g2 group by k "
                      "order by k").check([
                          (None, 6, 1), ("a", 4, 2), ("b", 6, 2), ("c", 5, 1)])
        tk.must_query("select k from g2 group by k having sum(v) > 4 "
                      "order by k").check([(None,), ("b",), ("c",)])

    def test_distinct(self, tk):
        tk.must_exec("drop table if exists g3")
        tk.must_exec("create table g3 (a int, b int)")
        tk.must_exec("insert into g3 values (1,1),(1,1),(2,2),(2,3)")
        tk.must_query("select distinct a from g3 order by a").check([(1,), (2,)])
        tk.must_query("select count(distinct a), count(b) from g3")\
            .check([(2, 4)])
        tk.must_query("select a, count(distinct b) from g3 group by a "
                      "order by a").check([(1, 1), (2, 2)])

    def test_group_by_expr(self, tk):
        tk.must_exec("drop table if exists g4")
        tk.must_exec("create table g4 (d date, v int)")
        tk.must_exec("insert into g4 values ('1994-01-05',1),('1994-02-05',2),"
                     "('1995-01-05',4)")
        tk.must_query("select year(d), sum(v) from g4 group by year(d) "
                      "order by 1").check([(1994, 3), (1995, 4)])


class TestJoin:
    @pytest.fixture(autouse=True)
    def setup(self, tk):
        tk.must_exec("drop table if exists j1, j2")
        tk.must_exec("create table j1 (id int, v varchar(5))")
        tk.must_exec("create table j2 (id int, w varchar(5))")
        tk.must_exec("insert into j1 values (1,'a'),(2,'b'),(3,'c')")
        tk.must_exec("insert into j2 values (2,'x'),(3,'y'),(3,'z'),(4,'q')")
        self.tk = tk

    def test_inner(self):
        self.tk.must_query(
            "select j1.id, v, w from j1 join j2 on j1.id = j2.id "
            "order by j1.id, w").check([
                (2, "b", "x"), (3, "c", "y"), (3, "c", "z")])

    def test_left(self):
        self.tk.must_query(
            "select j1.id, w from j1 left join j2 on j1.id = j2.id "
            "order by j1.id, w").check([
                (1, None), (2, "x"), (3, "y"), (3, "z")])

    def test_right(self):
        self.tk.must_query(
            "select j2.id, v from j1 right join j2 on j1.id = j2.id "
            "order by j2.id, v").check([
                (2, "b"), (3, "c"), (3, "c"), (4, None)])

    def test_cross(self):
        self.tk.must_query("select count(*) from j1, j2").check([(12,)])

    def test_implicit_eq(self):
        self.tk.must_query(
            "select count(*) from j1, j2 where j1.id = j2.id").check([(3,)])

    def test_join_agg(self):
        self.tk.must_query(
            "select v, count(*) from j1 join j2 on j1.id = j2.id "
            "group by v order by v").check([("b", 1), ("c", 2)])

    def test_non_eq_cond(self):
        self.tk.must_query(
            "select count(*) from j1 join j2 on j1.id = j2.id and w != 'z'")\
            .check([(2,)])

    def test_using(self):
        self.tk.must_query(
            "select id, v, w from j1 join j2 using(id) order by id, w")\
            .check([(2, "b", "x"), (3, "c", "y"), (3, "c", "z")])


class TestSortLimit:
    def test_order_limit(self, tk):
        tk.must_exec("drop table if exists s1")
        tk.must_exec("create table s1 (a int, b varchar(5))")
        tk.must_exec("insert into s1 values (3,'c'),(1,'a'),(2,'b'),(null,'n')")
        tk.must_query("select a from s1 order by a").check([
            (None,), (1,), (2,), (3,)])
        tk.must_query("select a from s1 order by a desc").check([
            (3,), (2,), (1,), (None,)])
        tk.must_query("select a from s1 order by a desc limit 2").check([
            (3,), (2,)])
        tk.must_query("select a from s1 order by a limit 1, 2").check([
            (1,), (2,)])
        tk.must_query("select a from s1 order by b desc limit 1 offset 1")\
            .check([(3,)])

    def test_order_by_alias_and_expr(self, tk):
        tk.must_exec("drop table if exists s2")
        tk.must_exec("create table s2 (a int, b int)")
        tk.must_exec("insert into s2 values (1,9),(2,4),(3,6)")
        tk.must_query("select a, a+b as s from s2 order by s").check([
            (2, 6), (3, 9), (1, 10)])
        tk.must_query("select a from s2 order by b*1 desc").check([
            (1,), (3,), (2,)])


class TestIndexAdvisor:
    def test_recommend_index(self, ftk):
        ftk.must_exec("create table adv (id int primary key, a int, b int)")
        ftk.must_exec("insert into adv values " + ",".join(
            f"({i},{i % 100},{i % 7})" for i in range(200)))
        for _ in range(3):
            ftk.must_query("select * from adv where a = 42")
        rows = ftk.must_query("recommend index run").rows
        assert any(r[1] == "adv" and r[3] == "a" for r in rows), rows
        # targeted form
        rows = ftk.must_query(
            "recommend index run for 'select * from adv where b = 1'").rows
        assert any(r[3] == "b" for r in rows), rows
        # existing indexes suppress the suggestion
        ftk.must_exec("create index idx_a on adv (a)")
        rows = ftk.must_query(
            "recommend index run for 'select * from adv where a = 1'").rows
        assert not any(r[3] == "a" for r in rows), rows


class TestVectorType:
    def test_vector_column_and_functions(self, ftk):
        ftk.must_exec("create table emb (id int primary key, v vector(3))")
        ftk.must_exec("insert into emb values (1,'[1,0,0]'),(2,'[0,1,0]'),"
                      "(3,'[0.5,0.5,0]'),(4,null)")
        ftk.must_query(
            "select id, vec_dims(v), round(vec_l2_norm(v), 4) from emb "
            "order by id").check([
                (1, 3, "1"), (2, 3, "1"), (3, 3, "0.7071"), (4, None, None)])
        # nearest neighbors by cosine distance
        ftk.must_query(
            "select id from emb where v is not null order by "
            "vec_cosine_distance(v, '[1,0,0]') limit 2").check([(1,), (3,)])
        ftk.must_query(
            "select round(vec_l2_distance(v, '[0,1,0]'), 4) from emb "
            "where id = 3").check([("0.7071",)])
        ftk.must_query(
            "select round(vec_negative_inner_product(v, '[2,2,0]'), 1) "
            "from emb where id = 3").check([("-2",)])
        # scalar forms + canonicalization
        ftk.must_query("select vec_l1_distance('[1,2]', '[3,1]')").check(
            [("3",)])
        ftk.must_query("select vec_from_text('[1.0, 2.5,3]')").check(
            [("[1,2.5,3]",)])
        # dimension + parse enforcement on write
        assert ftk.exec_err("insert into emb values (9, '[1,2]')")
        assert ftk.exec_err("insert into emb values (9, 'oops')")
        # vectors survive the full storage path (txn + scan)
        ftk.must_exec("begin")
        ftk.must_exec("insert into emb values (5, '[0,0,1]')")
        ftk.must_query("select vec_dims(v) from emb where id = 5").check(
            [(3,)])
        ftk.must_exec("commit")


class TestStaleRead:
    def test_as_of_timestamp(self, ftk):
        import time as _t
        from tidb_tpu_torch.types.time_types import micros_to_str
        ftk.must_exec("create table sr (id int primary key, v int)")
        ftk.must_exec("insert into sr values (1, 10)")
        _t.sleep(0.05)
        mid = micros_to_str(int(_t.time() * 1e6), 6)
        _t.sleep(0.05)
        ftk.must_exec("update sr set v = 99 where id = 1")
        ftk.must_exec("insert into sr values (2, 20)")
        ftk.must_query("select * from sr order by id").check(
            [(1, 99), (2, 20)])
        # snapshot before the update/insert
        ftk.must_query(f"select * from sr as of timestamp '{mid}' "
                       "order by id").check([(1, 10)])
        # stale point get takes the same snapshot
        ftk.must_query(f"select v from sr as of timestamp '{mid}' "
                       "where id = 1").check([(10,)])
        import pytest as _pt
        from tidb_tpu_torch import errors as _e
        with _pt.raises(_e.TiDBError, match="future"):
            ftk.must_query("select * from sr as of timestamp "
                           "'2099-01-01 00:00:00'")


class TestPluginsAndTopSQL:
    def test_audit_plugin_and_show(self, ftk):
        from tidb_tpu_torch.plugin import Plugin
        events = []
        ftk.domain.plugins.load(Plugin(
            name="audit_demo", kind="audit",
            hooks={"audit": lambda sess, ev: events.append(ev)}))
        ftk.must_exec("create table plg (v int)")
        ftk.must_exec("insert into plg values (1)")
        assert events and events[-1]["ok"] and \
            "insert into plg" in events[-1]["sql"]
        ftk.must_query("show plugins").check(
            [("audit_demo", "ENABLE", "audit", "", "", "1.0")])
        # plugin errors never fail the statement
        ftk.domain.plugins.load(Plugin(
            name="bad", kind="audit",
            hooks={"audit": lambda *a: 1 / 0}))
        ftk.must_query("select * from plg").check([(1,)])
        ftk.domain.plugins.unload("audit_demo")
        ftk.domain.plugins.unload("bad")

    def test_top_sql_table(self, ftk):
        ftk.must_exec("create table tsq (v int)")
        for _ in range(3):
            ftk.must_query("select * from tsq")
        rows = ftk.must_query(
            "select sql_text, exec_count from information_schema"
            ".tidb_top_sql where sql_text like '%tsq%'").rows
        assert ("select * from tsq", 3) in rows


class TestResourceControl:
    def test_group_lifecycle_and_accounting(self, ftk):
        ftk.must_exec("create table rcg (v int)")
        ftk.must_exec("insert into rcg values (1),(2)")
        ftk.must_exec("create resource group rg1 RU_PER_SEC = 100")
        ftk.must_query(
            "select name, ru_per_sec from information_schema"
            ".resource_groups where name = 'rg1'").check([("rg1", 100)])
        ftk.must_exec("set resource group rg1")
        ftk.must_query("select * from rcg order by v").check([(1,), (2,)])
        g = ftk.domain.resource_groups.get("rg1")
        assert g.consumed_ru > 0
        # deficit throttles the next statement (cooperative admission)
        import time as _t
        g.tokens = -5.0
        t0 = _t.time()
        ftk.must_query("select 1").check([(1,)])
        assert _t.time() - t0 >= 0.04
        assert g.throttled_stmts == 1
        ftk.must_exec("set resource group default")
        ftk.must_exec("alter resource group rg1 RU_PER_SEC = 500 BURSTABLE")
        ftk.must_query(
            "select ru_per_sec, burstable from information_schema"
            ".resource_groups where name = 'rg1'").check([(500, "YES")])
        ftk.must_exec("drop resource group rg1")
        import pytest as _pt
        from tidb_tpu_torch import errors as _e
        with _pt.raises(_e.TiDBError):
            ftk.must_exec("set resource group rg1")

    def test_runaway_query_limit_kills(self, ftk):
        ftk.must_exec("create resource group rk RU_PER_SEC = 10000 "
                      "QUERY_LIMIT=(EXEC_ELAPSED='1ms', ACTION=KILL)")
        ftk.must_exec("create table rkt (v int)")
        ftk.must_exec("insert into rkt values " + ",".join(
            f"({i})" for i in range(50)))
        ftk.must_exec("set resource group rk")
        import pytest as _pt
        from tidb_tpu_torch import errors as _e
        with _pt.raises(_e.TiDBError, match="interrupted"):
            # cross joins are slow enough to overrun 1ms
            ftk.must_query("select count(*) from rkt a, rkt b, rkt c")
        ftk.must_exec("set resource group default")


class TestIndexMerge:
    def test_union_type_index_merge(self, ftk):
        ftk.must_exec("create table im (a int, b int, c int, "
                      "key ia (a), key ib (b))")
        ftk.must_exec("insert into im values " + ",".join(
            f"({i}, {i * 2}, {i % 5})" for i in range(1000)))
        ftk.must_exec("analyze table im")
        r = ftk.must_query("explain select * from im where a = 3 or b = 10")
        assert any("IndexMerge" in row[0] for row in r.rows), r.rows
        ftk.must_query("select a, b from im where a = 3 or b = 10 "
                       "order by a").check([(3, 6), (5, 10)])
        # overlapping branches dedup by handle
        ftk.must_query("select count(*) from im "
                       "where a = 5 or b = 10").check([(1,)])
        # range branches
        ftk.must_query("select count(*) from im "
                       "where a < 3 or b > 1990").check([(7,)])
        # txn memBuffer rows visible through the merge
        ftk.must_exec("begin")
        ftk.must_exec("insert into im values (2000, 4000, 1)")
        ftk.must_query("select a from im where a = 2000 or b = 10 "
                       "order by a").check([(5,), (2000,)])
        ftk.must_exec("rollback")
        ftk.must_exec("delete from im where a = 3")
        ftk.must_query("select a, b from im where a = 3 or b = 10").check(
            [(5, 10)])


class TestBindingsAndHints:
    def test_hints_parse_and_execute(self, ftk):
        ftk.must_exec("create table bh1 (a int, b int)")
        ftk.must_exec("create table bh2 (a int, c int)")
        ftk.must_exec("insert into bh1 values (1,10),(2,20)")
        ftk.must_exec("insert into bh2 values (1,5),(2,6)")
        # LEADING flips the join order; results must be unchanged
        ftk.must_query(
            "select /*+ LEADING(bh2, bh1), MAX_EXECUTION_TIME(60000) */ "
            "bh1.b, bh2.c from bh1, bh2 where bh1.a = bh2.a "
            "order by bh1.b").check([(10, 5), (20, 6)])

    def test_global_binding_lifecycle(self, ftk):
        ftk.must_exec("create table bg1 (a int)")
        ftk.must_exec("create table bg2 (a int)")
        ftk.must_exec("insert into bg1 values (1),(2)")
        ftk.must_exec("insert into bg2 values (2),(3)")
        ftk.must_exec(
            "create global binding for "
            "select count(*) from bg1, bg2 where bg1.a = bg2.a "
            "using select /*+ LEADING(bg2), MEMORY_QUOTA(8 MB) */ "
            "count(*) from bg1, bg2 where bg1.a = bg2.a")
        assert len(ftk.must_query("show global bindings").rows) == 1
        # different case/whitespace still digest-matches
        ftk.must_query("SELECT COUNT(*) FROM bg1, bg2 "
                       "WHERE bg1.a = bg2.a").check([(1,)])
        ftk.must_query("select @@last_plan_from_binding").check([(1,)])
        ftk.must_query("select count(*) from bg1").check([(2,)])
        ftk.must_query("select @@last_plan_from_binding").check([(0,)])
        ftk.must_exec(
            "drop global binding for "
            "select count(*) from bg1, bg2 where bg1.a = bg2.a")
        assert ftk.must_query("show global bindings").rows == []

    def test_session_binding_shadows(self, ftk):
        ftk.must_exec("create table bs1 (v int)")
        ftk.must_exec("insert into bs1 values (3),(4)")
        ftk.must_exec("create binding for select sum(v) from bs1 "
                      "using select /*+ HASH_AGG() */ sum(v) from bs1")
        assert len(ftk.must_query("show bindings").rows) == 1
        ftk.must_query("select sum(v) from bs1").check([("7",)])
        ftk.must_query("select @@last_plan_from_binding").check([(1,)])
        # other sessions don't see a SESSION binding
        tk2 = ftk.new_session()
        assert tk2.must_query("show bindings").rows == []

    def test_var_reads_not_plan_cached(self, ftk):
        ftk.must_exec("set @bv = 7")
        ftk.must_query("select @bv").check([(7,)])
        ftk.must_exec("set @bv = 9")
        ftk.must_query("select @bv").check([(9,)])


class TestNullAwareAntiJoin:
    def test_not_in_null_semantics(self, ftk):
        ftk.must_exec("create table na_a (x int)")
        ftk.must_exec("create table na_b (y int)")
        ftk.must_exec("insert into na_a values (1),(2),(null)")
        ftk.must_exec("insert into na_b values (2),(null)")
        # inner side contains NULL: NOT IN is FALSE or NULL for every row
        ftk.must_query("select x from na_a where x not in "
                       "(select y from na_b)").check([])
        ftk.must_exec("delete from na_b where y is null")
        ftk.must_query("select x from na_a where x not in "
                       "(select y from na_b) order by x").check([(1,)])
        # empty inner side: NOT IN is TRUE even for a NULL probe
        ftk.must_exec("delete from na_b")
        ftk.must_query("select x from na_a where x not in "
                       "(select y from na_b) order by x").check(
            [(None,), (1,), (2,)])


class TestSubquery:
    def test_scalar(self, tk):
        tk.must_exec("drop table if exists sq")
        tk.must_exec("create table sq (a int)")
        tk.must_exec("insert into sq values (1),(5),(9)")
        tk.must_query("select (select max(a) from sq)").check([(9,)])
        tk.must_query("select a from sq where a > (select avg(a) from sq)")\
            .check([(9,)])

    def test_in_subquery(self, tk):
        tk.must_exec("drop table if exists sq1, sq2")
        tk.must_exec("create table sq1 (a int)")
        tk.must_exec("create table sq2 (b int)")
        tk.must_exec("insert into sq1 values (1),(2),(3)")
        tk.must_exec("insert into sq2 values (2),(3),(4)")
        tk.must_query("select a from sq1 where a in (select b from sq2) "
                      "order by a").check([(2,), (3,)])
        tk.must_query("select a from sq1 where a not in (select b from sq2)")\
            .check([(1,)])
        tk.must_query("select a from sq1 where exists (select 1 from sq2 "
                      "where b > 100)").check([])

    def test_derived_table(self, tk):
        tk.must_exec("drop table if exists dt")
        tk.must_exec("create table dt (a int, b int)")
        tk.must_exec("insert into dt values (1,10),(2,20),(3,30)")
        tk.must_query("select s from (select a, a+b as s from dt) x "
                      "where a > 1 order by s").check([(22,), (33,)])
        tk.must_query("select max(t.total) from (select a, sum(b) as total "
                      "from dt group by a) t").check([("30",)])


class TestUnion:
    def test_union(self, tk):
        tk.must_query("select 1 union select 2 union select 1 order by 1")\
            .check([(1,), (2,)])
        tk.must_query("select 1 union all select 1").check([(1,), (1,)])
        tk.must_exec("drop table if exists u1")
        tk.must_exec("create table u1 (a int)")
        tk.must_exec("insert into u1 values (1),(2)")
        tk.must_query("select a from u1 union all select 9 order by 1")\
            .check([(1,), (2,), (9,)])


class TestTxn:
    def test_commit_rollback(self, ftk):
        ftk.must_exec("create table tx (a int)")
        ftk.must_exec("begin")
        ftk.must_exec("insert into tx values (1)")
        ftk.must_query("select * from tx").check([(1,)])   # own writes
        ftk.must_exec("rollback")
        ftk.must_query("select count(*) from tx").check([(0,)])
        ftk.must_exec("begin")
        ftk.must_exec("insert into tx values (2)")
        ftk.must_exec("commit")
        ftk.must_query("select * from tx").check([(2,)])

    def test_isolation(self, ftk):
        ftk.must_exec("create table ti (a int)")
        ftk.must_exec("insert into ti values (1)")
        tk2 = ftk.new_session()
        ftk.must_exec("begin")
        ftk.must_query("select count(*) from ti").check([(1,)])
        tk2.must_exec("insert into ti values (2)")
        # snapshot was taken at BEGIN: still sees 1 row
        ftk.must_query("select count(*) from ti").check([(1,)])
        ftk.must_exec("commit")
        ftk.must_query("select count(*) from ti").check([(2,)])

    def test_write_conflict(self, ftk):
        ftk.must_exec("create table wc (id int primary key, v int)")
        ftk.must_exec("insert into wc values (1, 0)")
        tk2 = ftk.new_session()
        # optimistic mode: no DML locks — first committer wins, the
        # explicit txn sees the conflict at commit time
        ftk.must_exec("set @@tidb_txn_mode = 'optimistic'")
        ftk.must_exec("begin")
        ftk.must_exec("update wc set v = 1 where id = 1")
        tk2.must_exec("update wc set v = 2 where id = 1")
        with pytest.raises(errors.TiDBError):
            ftk.must_exec("commit")
        # pessimistic mode (default): the explicit txn's UPDATE takes a
        # row lock, so the second writer BLOCKS on the lock-wait queue
        # (ER 1205 at the wait deadline) instead of overtaking
        ftk.must_exec("set @@tidb_txn_mode = 'pessimistic'")
        tk2.must_exec("set @@tidb_tpu_lock_wait_timeout_ms = 100")
        ftk.must_exec("begin")
        ftk.must_exec("update wc set v = 3 where id = 1")
        e = tk2.exec_err("update wc set v = 4 where id = 1")
        assert e.code == 1205
        ftk.must_exec("commit")
        tk2.must_exec("update wc set v = 4 where id = 1")
        tk2.must_query("select v from wc").check([(4,)])


class TestDDL:
    def test_alter_add_drop_column(self, ftk):
        ftk.must_exec("create table ad (a int)")
        ftk.must_exec("insert into ad values (1)")
        ftk.must_exec("alter table ad add column b int default 5")
        ftk.must_query("select * from ad").check([(1, 5)])
        ftk.must_exec("insert into ad values (2, 7)")
        ftk.must_exec("alter table ad drop column a")
        ftk.must_query("select * from ad order by b").check([(5,), (7,)])

    def test_alter_column_forms(self, ftk):
        """RENAME/CHANGE COLUMN, SET/DROP DEFAULT, FIRST/AFTER
        positions, table options (reference ddl/column.go +
        parser.y AlterTableSpec breadth)."""
        ftk.must_exec("create table af (a int primary key, "
                      "b varchar(8), c int)")
        ftk.must_exec("insert into af values (1,'x',10),(2,'y',20)")
        ftk.must_exec("alter table af rename column b to bb")
        ftk.must_query("select bb from af where a = 1").check([("x",)])
        # rename follows into indexes
        ftk.must_exec("create index i_bb on af (bb)")
        ftk.must_exec("alter table af rename column bb to b3")
        ftk.must_query("select a from af where b3 = 'y'").check([(2,)])
        ftk.must_exec("alter table af rename index i_bb to i_b3")
        # CHANGE = rename + modify
        ftk.must_exec("alter table af change column b3 b varchar(20)")
        ftk.must_query("select b from af order by a").check(
            [("x",), ("y",)])
        # defaults
        ftk.must_exec("alter table af alter column c set default 7")
        ftk.must_exec("insert into af (a, b) values (3, 'z')")
        ftk.must_query("select c from af where a = 3").check([(7,)])
        ftk.must_exec("alter table af alter column c drop default")
        # positions rewrite rows positionally
        ftk.must_exec("alter table af add column d int after a")
        ftk.must_query("select * from af where a = 1").check(
            [(1, None, "x", 10)])
        ftk.must_exec("alter table af add column e int first")
        ftk.must_query("select * from af where a = 2").check(
            [(None, 2, None, "y", 20)])
        # duplicate rename refuses
        e = ftk.exec_err("alter table af rename column b to c")
        assert "Duplicate column" in str(e)
        # table options
        ftk.must_exec("alter table af comment = 'hello'")
        ftk.must_exec("alter table af auto_increment = 500")
        # CHANGE after a positional rewrite: column offsets must have
        # been renumbered (regression: stale offsets made modify
        # clobber a different column and corrupt row/columnar parity)
        ftk.must_exec("alter table af change column b bz varchar(30)")
        r = ftk.must_query("check table af")
        assert r.rows[0][3] == "OK", r.rows
        ftk.must_query("select bz from af where a = 1").check([("x",)])

    def test_alter_column_edge_cases(self, ftk):
        """Review regressions: failed AFTER must not half-apply; FK
        ref_cols in child tables follow a parent rename; generated
        columns block renames of their dependencies; float/negative
        defaults parse."""
        ftk.must_exec("create table ae (a int)")
        e = ftk.exec_err("alter table ae add column d int after nosuch")
        assert "Unknown column" in str(e)
        assert ftk.exec_err("select d from ae") is not None
        ftk.must_exec("create table aep (a int primary key)")
        ftk.must_exec("create table aec (x int, "
                      "foreign key (x) references aep (a))")
        ftk.must_exec("insert into aep values (1)")
        ftk.must_exec("alter table aep rename column a to a2")
        ftk.must_exec("insert into aec values (1)")
        assert ftk.exec_err("insert into aec values (99)") is not None
        ftk.must_exec("create table aeg (a int, b int as (a + 1) "
                      "stored)")
        e = ftk.exec_err("alter table aeg rename column a to az")
        assert "generated" in str(e)
        ftk.must_exec("create table aed (a int, f double, g int)")
        ftk.must_exec("alter table aed alter column f set default 1.5")
        ftk.must_exec("alter table aed alter column g set default -3")
        ftk.must_exec("insert into aed (a) values (1)")
        ftk.must_query("select f, g from aed").check([(1.5, -3)])
        ftk.must_exec("alter database `test` charset utf8mb4")

    def test_rename_role_follows_grantees(self, ftk):
        ftk.must_exec("create role rr1")
        ftk.must_exec("create user ru identified by 'p'")
        ftk.must_exec("grant select on test.* to rr1")
        ftk.must_exec("grant rr1 to ru")
        ftk.must_exec("rename user rr1 to rr2")
        pm = ftk.domain.priv
        assert ("rr2", "%") in pm.roles and ("rr1", "%") not in pm.roles
        assert ("rr2", "%") in pm.role_edges[("ru", "%")]
        assert pm.db_privs.get(("rr2", "%", "test")) == {"select"}

    def test_lock_tables(self, ftk):
        """LOCK TABLES behind tidb_enable_table_lock (reference
        enable-table-lock gate): READ blocks other sessions' writes,
        WRITE blocks their reads and conflicting locks; the gate off
        makes the statements no-ops."""
        from tidb_tpu_torch.session import Session
        from tidb_tpu_torch.errors import TiDBError
        ftk.must_exec("create table ltk (a int primary key)")
        ftk.must_exec("lock tables ltk write")   # gate off: no-op
        ftk.must_exec("unlock tables")
        ftk.must_exec("set @@tidb_enable_table_lock = 1")
        s2 = Session(ftk.domain)
        s2.vars.current_db = "test"
        try:
            ftk.must_exec("lock tables ltk read")
            s2.execute("select * from ltk")      # reads fine
            with pytest.raises(TiDBError):
                s2.execute("insert into ltk values (1)")
            ftk.must_exec("unlock tables")
            s2.execute("set @@tidb_enable_table_lock = 1")
            s2.execute("lock tables ltk write")
            with pytest.raises(TiDBError):
                ftk.must_query("select * from ltk")
            with pytest.raises(TiDBError):
                ftk.must_exec("lock tables ltk read")
            s2.execute("unlock tables")
            ftk.must_exec("insert into ltk values (2)")
            # review regressions: own READ lock forbids writing (1099),
            # DML-internal reads and DDL respect other sessions' locks,
            # dropping a locked table purges its registry entry
            ftk.must_exec("create table ltk2 (a int primary key)")
            ftk.must_exec("lock tables ltk read")
            with pytest.raises(TiDBError):
                ftk.must_exec("insert into ltk values (3)")
            ftk.must_exec("unlock tables")
            ftk.must_exec("lock tables ltk write")
            with pytest.raises(TiDBError):
                s2.execute("insert into ltk2 select a from ltk")
            with pytest.raises(TiDBError):
                s2.execute("drop table ltk")
            ftk.must_exec("drop table ltk")   # holder may; purges entry
            s2.execute("create table ltk (a int)")
            s2.execute("insert into ltk values (7)")
        finally:
            s2.execute("unlock tables")
            ftk.must_exec("unlock tables")
            ftk.must_exec("set @@tidb_enable_table_lock = 0")

    def test_show_breadth(self, ftk):
        """SHOW statement long tail (reference pkg/executor/show.go):
        stats/analyze/placement/config/next_row_id carry real data;
        MySQL-compat replication/trigger/event forms return empty sets
        with the right headers."""
        ftk.must_exec("create table shb (a int primary key)")
        ftk.must_exec("insert into shb values (1), (2), (3)")
        ftk.must_exec("analyze table shb")
        r = ftk.must_query("show stats_meta")
        assert any(row[1] == "shb" and str(row[5]) == "3"
                   for row in r.rows)
        r = ftk.must_query("show stats_histograms")
        assert any(row[1] == "shb" and row[2] == "a" for row in r.rows)
        r = ftk.must_query("show analyze status")
        assert any(row[1] == "shb" and row[5] == "finished"
                   for row in r.rows)
        r = ftk.must_query("show table shb next_row_id")
        assert r.rows[0][1] == "shb" and int(r.rows[0][3]) >= 4
        assert len(ftk.must_query("show privileges").rs.rows) > 5
        assert len(ftk.must_query("show config").rs.rows) >= 2
        for s in ("show master status", "show slave status",
                  "show open tables", "show triggers", "show events",
                  "show function status", "show procedure status",
                  "show placement labels"):
            ftk.must_query(s)          # parse + empty-compat result
        # review regressions: LIKE filters apply; slave headers are
        # slave-shaped; deleted max handles are not reissued
        assert ftk.must_query("show stats_meta like 'zzz%'").rs.rows \
            == []
        assert len(ftk.must_query("show privileges like 'Sel%'")
                   .rs.rows) == 1
        assert "Seconds_Behind_Master" in \
            ftk.must_query("show slave status").rs.names
        ftk.must_exec("delete from shb where a = 3")
        r = ftk.must_query("show table shb next_row_id")
        assert int(r.rows[0][3]) >= 4

    def test_maintain_statements(self, ftk):
        """CHECK/OPTIMIZE/REPAIR TABLE return MySQL-style maintenance
        rows; CHECK runs the index<->row consistency pass."""
        ftk.must_exec("create table mt (a int primary key, b int, "
                      "key ib (b))")
        ftk.must_exec("insert into mt values (1, 10)")
        r = ftk.must_query("check table mt")
        assert r.rows[0][2:] == ("status", "OK")
        r = ftk.must_query("optimize table mt")
        assert r.rows[0][1] == "optimize"
        r = ftk.must_query("repair table mt")
        assert r.rows[0][3] == "OK"

    def test_rename_user_moves_grants(self, ftk):
        ftk.must_exec("create user ru1 identified by 'p'")
        ftk.must_exec("grant select on test.* to ru1")
        ftk.must_exec("rename user ru1 to ru2")
        r = ftk.must_query("show grants for ru2")
        assert any("SELECT" in row[0] for row in r.rows)
        e = ftk.exec_err("rename user ru1 to ru3")
        assert "RENAME USER failed" in str(e)
        ftk.must_exec("drop user ru2")

    def test_index_lifecycle(self, ftk):
        ftk.must_exec("create table il (a int, b int)")
        ftk.must_exec("insert into il values (1,1),(2,2)")
        ftk.must_exec("create unique index uk_a on il (a)")
        e = ftk.exec_err("insert into il values (1, 9)")
        assert isinstance(e, errors.DuplicateKeyError)
        ftk.must_exec("drop index uk_a on il")
        ftk.must_exec("insert into il values (1, 9)")
        ftk.must_query("select count(*) from il").check([(3,)])

    def test_unique_backfill_conflict(self, ftk):
        ftk.must_exec("create table ub (a int)")
        ftk.must_exec("insert into ub values (1),(1)")
        e = ftk.exec_err("create unique index uk on ub (a)")
        assert isinstance(e, errors.DuplicateKeyError)
        # index creation rolled back: inserts still work
        ftk.must_exec("insert into ub values (1)")

    def test_online_index_states(self, ftk):
        """F1 state ladder (reference ddl/index.go): non-public indexes
        are invisible to the planner but maintained by writes."""
        from tidb_tpu_torch.models.schema import SchemaState
        ftk.must_exec("create table ois (id int primary key, a int)")
        ftk.must_exec("insert into ois values (1, 10), (2, 20)")
        ftk.must_exec("create index ia on ois (a)")
        tbl = ftk.domain.infoschema().table_by_name("test", "ois")
        idx = tbl.find_index("ia")
        assert idx.state == SchemaState.PUBLIC
        # force write-only: planner must not use it, writes must maintain it
        idx.state = SchemaState.WRITE_ONLY
        assert tbl.public_indexes() == []
        assert tbl.writable_indexes() == [idx]
        ftk.must_exec("insert into ois values (3, 30)")
        idx.state = SchemaState.PUBLIC
        # the write-only insert kept the index complete
        ftk.must_query("select id from ois where a = 30").check([(3,)])
        # delete-only still removes entries
        idx.state = SchemaState.DELETE_ONLY
        assert tbl.deletable_indexes() == [idx]
        ftk.must_exec("delete from ois where id = 3")
        idx.state = SchemaState.PUBLIC
        ftk.must_query("select id from ois where a = 30").check([])

    def test_truncate_rename(self, ftk):
        ftk.must_exec("create table tr (a int)")
        ftk.must_exec("insert into tr values (1)")
        ftk.must_exec("truncate table tr")
        ftk.must_query("select count(*) from tr").check([(0,)])
        ftk.must_exec("rename table tr to tr2")
        ftk.must_exec("insert into tr2 values (5)")
        e = ftk.exec_err("select * from tr")
        assert isinstance(e, errors.TableNotExistsError)

    def test_show(self, ftk):
        ftk.must_exec("create table sh (a int primary key, b varchar(10))")
        ftk.must_query("show tables").check([("sh",)])
        r = ftk.must_query("show create table sh")
        r.check_contain("`a` int")
        ftk.must_query("show databases").check_contain("test")
        r = ftk.must_query("describe sh")
        assert r.rows[0][0] == "a"


class TestSysVars:
    def test_set_show(self, ftk):
        ftk.must_exec("set @@tidb_max_chunk_size = 2048")
        ftk.must_query("select @@tidb_max_chunk_size").check([(2048,)])
        ftk.must_exec("set @@global.tidb_mem_quota_query = 2097152")
        tk2 = ftk.new_session()
        tk2.must_query("select @@global.tidb_mem_quota_query")\
            .check([(2097152,)])
        e = ftk.exec_err("set @@nonexistent_var = 1")
        assert isinstance(e, errors.UnknownSystemVariableError)

    def test_user_vars(self, ftk):
        ftk.must_exec("set @x = 42")
        ftk.must_query("select @x + 1").check([(43,)])

    def test_tpu_toggle(self, ftk):
        ftk.must_exec("create table tp (a int)")
        ftk.must_exec("insert into tp values (1),(2),(3)")
        ftk.must_exec("set @@tidb_enable_tpu_exec = off")
        ftk.must_query("select sum(a) from tp where a > 1").check([(5,)])
        ftk.must_exec("set @@tidb_enable_tpu_exec = on")
        ftk.must_query("select sum(a) from tp where a > 1").check([(5,)])


class TestExplain:
    def test_explain_shapes(self, tk):
        tk.must_exec("drop table if exists ex")
        tk.must_exec("create table ex (a int, b int)")
        r = tk.must_query("explain select sum(b) from ex where a > 1 group by a")
        text = "\n".join(r0[0] + " " + r0[2] for r0 in r.rows)
        assert "HashAgg" in text
        assert "TableReader" in text
        r = tk.must_query("explain select * from ex order by a limit 3")
        text = "\n".join(r0[0] for r0 in r.rows)
        assert "TopN" in text


class TestObservability:
    def test_information_schema(self, ftk):
        ftk.must_exec("create table obs (a int primary key, b varchar(10))")
        ftk.must_exec("insert into obs values (1, 'x')")
        r = ftk.must_query(
            "select table_name, table_rows from information_schema.tables "
            "where table_schema = 'test'")
        assert ("obs", 1) in r.rows
        r = ftk.must_query(
            "select column_name from information_schema.columns "
            "where table_name = 'obs' order by ordinal_position")
        assert r.rows == [("a",), ("b",)]
        r = ftk.must_query(
            "select schema_name from information_schema.schemata "
            "order by schema_name")
        assert ("test",) in r.rows
        # aggregation over a virtual table
        r = ftk.must_query(
            "select count(*) from information_schema.columns "
            "where table_schema = 'test'")
        assert r.rows[0][0] == 2

    def test_statement_summary_and_slow_log(self, ftk):
        ftk.must_exec("set @@tidb_slow_log_threshold = 0")
        ftk.must_exec("create table sl (a int)")
        ftk.must_exec("select * from sl")
        r = ftk.must_query(
            "select exec_count from information_schema.statements_summary "
            "where digest_text like 'select * from sl%'")
        assert len(r.rows) == 1 and r.rows[0][0] >= 1
        r = ftk.must_query(
            "select query from information_schema.slow_query")
        assert any("sl" in q[0] for q in r.rows)

    def test_explain_analyze(self, ftk):
        ftk.must_exec("create table ea (a int, b int)")
        ftk.must_exec("insert into ea values (1,1),(2,2),(3,3)")
        r = ftk.must_query("explain analyze select sum(b) from ea where a > 1")
        assert r.names == ["id", "estRows", "actRows", "time", "backend",
                           "operator info"]
        # the reader's actRows reflects the filtered partials and the agg
        ids = [row[0] for row in r.rows]
        assert any("HashAgg" in i for i in ids)


class TestWindow:
    @pytest.fixture(autouse=True)
    def setup(self, tk):
        tk.must_exec("drop table if exists w")
        tk.must_exec("create table w (g varchar(3), v int)")
        tk.must_exec("insert into w values ('a',10),('a',20),('a',20),"
                     "('b',5),('b',15),(null,7)")
        self.tk = tk

    def test_row_number(self):
        self.tk.must_query(
            "select g, v, row_number() over (partition by g order by v) "
            "from w order by g, v").check([
                (None, 7, 1), ("a", 10, 1), ("a", 20, 2), ("a", 20, 3),
                ("b", 5, 1), ("b", 15, 2)])

    def test_rank_dense(self):
        self.tk.must_query(
            "select v, rank() over (partition by g order by v), "
            "dense_rank() over (partition by g order by v) "
            "from w where g = 'a' order by v").check([
                (10, 1, 1), (20, 2, 2), (20, 2, 2)])

    def test_running_sum(self):
        self.tk.must_query(
            "select v, sum(v) over (partition by g order by v) "
            "from w where g = 'a' order by v").check([
                (10, "10"), (20, "50"), (20, "50")])  # peers share the frame

    def test_whole_partition_agg(self):
        self.tk.must_query(
            "select g, sum(v) over (partition by g) from w "
            "where g is not null order by g, v").check([
                ("a", "50"), ("a", "50"), ("a", "50"),
                ("b", "20"), ("b", "20")])

    def test_lag_lead(self):
        self.tk.must_query(
            "select v, lag(v) over (order by v), "
            "lead(v, 1, -1) over (order by v) from w where g = 'b' "
            "order by v").check([(5, None, 15), (15, 5, -1)])

    def test_first_last_value(self):
        self.tk.must_query(
            "select v, first_value(v) over (partition by g order by v), "
            "last_value(v) over (partition by g order by v) "
            "from w where g='a' order by v").check([
                (10, 10, 10), (20, 10, 20), (20, 10, 20)])

    def test_window_over_agg(self):
        self.tk.must_query(
            "select g, sum(v), rank() over (order by sum(v) desc) "
            "from w where g is not null group by g order by g").check([
                ("a", "50", 1), ("b", "20", 2)])


class TestPlanCache:
    def test_cache_hit_and_invalidation(self, ftk):
        ftk.must_exec("create table pc (a int, b int)")
        ftk.must_exec("insert into pc values (1,2),(3,4)")
        q = "select a from pc where b > 1 order by a"
        ftk.must_query(q).check([(1,), (3,)])
        before = ftk.domain.metrics.get("plan_cache_hit", 0)
        ftk.must_query(q).check([(1,), (3,)])
        assert ftk.domain.metrics.get("plan_cache_hit", 0) == before + 1
        # data changes flow through the cached plan
        ftk.must_exec("insert into pc values (5,6)")
        ftk.must_query(q).check([(1,), (3,), (5,)])
        # DDL bumps schema version -> cached plan invalidated, still correct
        ftk.must_exec("alter table pc add column c int default 9")
        ftk.must_query(q).check([(1,), (3,), (5,)])

    def test_uncacheable_subquery_plans(self, ftk):
        ftk.must_exec("create table pcs (a int)")
        ftk.must_exec("insert into pcs values (1)")
        q = "select a from pcs where a = (select max(a) from pcs)"
        ftk.must_query(q).check([(1,)])
        ftk.must_exec("insert into pcs values (5)")
        # plan embeds the subquery result; must NOT be cached
        ftk.must_query(q).check([(5,)])


class TestStatsPlanner:
    def test_analyze_changes_estimates(self, ftk):
        ftk.must_exec("create table st (a int, b int)")
        ftk.must_exec("insert into st values " + ",".join(
            f"({i % 10}, {i})" for i in range(200)))
        ftk.must_exec("analyze table st")

        def reader_est(r):
            return float(next(row[1] for row in r.rows
                              if "TableReader" in row[0]))
        r = ftk.must_query("explain select * from st where a = 5")
        # ndv(a)=10 over 200 rows -> ~20 estimated, not the pseudo 25%
        assert 10 <= reader_est(r) <= 40
        r = ftk.must_query("explain select * from st where b < 50")
        assert 30 <= reader_est(r) <= 70   # ~25% via min-max interpolation

    def test_topn_cmsketch_skew(self, ftk):
        """Skewed equality estimates come from TopN/CM-sketch, not the
        uniform NDV guess (reference pkg/statistics/cmsketch.go)."""
        ftk.must_exec("create table sk (k int, s varchar(10))")
        ftk.must_exec("insert into sk values " + ",".join(
            f"({900 if i % 2 else i}, 'v{i % 40}')" for i in range(400)))
        ftk.must_exec("analyze table sk")
        st = ftk.domain.stats[
            ftk.domain.infoschema().table_by_name("test", "sk").id]
        cs = st.columns["k"]
        # 900 occurs 200x; uniform NDV would put it near 400/201 ~ 2
        assert cs.eq_count("900") == 200
        # string keys decode through the column dictionary
        cs2 = st.columns["s"]
        assert cs2.eq_count("v1") == 10
        # estimates drive the plan; results stay exact
        ftk.must_query("select count(*) from sk where k = 900").check(
            [(200,)])

        def reader_est(r):
            return float(next(row[1] for row in r.rows
                              if "TableReader" in row[0]))
        r = ftk.must_query("explain select * from sk where k = 900")
        assert reader_est(r) >= 100        # sees the skew


class TestPreparedAndGC:
    def test_prepare_execute(self, ftk):
        ftk.must_exec("create table pe (a int, b varchar(8))")
        ftk.must_exec("insert into pe values (1,'x'),(2,'y'),(3,'z')")
        ftk.must_exec("prepare s1 from 'select b from pe where a > ? order by a limit ?'")
        ftk.must_exec("set @lo = 1")
        ftk.must_exec("set @n = 1")
        ftk.must_query("execute s1 using @lo, @n").check([("y",)])
        ftk.must_exec("set @lo = 0")
        ftk.must_exec("set @n = 3")
        ftk.must_query("execute s1 using @lo, @n").check([("x",), ("y",), ("z",)])
        ftk.must_exec("deallocate prepare s1")
        e = ftk.exec_err("execute s1 using @lo, @n")

    def test_api_params(self, ftk):
        ftk.must_exec("create table pp (a int)")
        ftk.must_exec("insert into pp values (1),(2),(3)")
        r = ftk.must_query("select a from pp where a >= ? and a < ?",
                           params=[2, 3])
        r.check([(2,)])

    def test_gc_compaction(self, ftk):
        ftk.must_exec("create table gc1 (a int)")
        ftk.must_exec("insert into gc1 values (1),(2),(3)")
        ftk.must_exec("update gc1 set a = a + 10 where a <= 2")
        ftk.must_exec("delete from gc1 where a = 3")
        tbl = ftk.domain.infoschema().table_by_name("test", "gc1")
        ctab = ftk.domain.columnar.tables[tbl.id]
        assert ctab.n > ctab.live_count()     # old versions retained
        compacted = ftk.domain.run_gc()
        assert compacted >= 3                  # 2 old versions + 1 delete
        assert ctab.n == ctab.live_count() == 2
        ftk.must_query("select a from gc1 order by a").check([(11,), (12,)])
        # table remains fully usable post-GC
        ftk.must_exec("insert into gc1 values (99)")
        ftk.must_query("select count(*) from gc1").check([(3,)])


class TestSpill:
    def test_sort_spills_and_stays_correct(self, ftk):
        ftk.must_exec("create table sp (a int, s varchar(16))")
        rows = ",".join(f"({(i * 7919) % 10007}, 'v{i % 97}')"
                        for i in range(12000))
        ftk.must_exec(f"insert into sp values {rows}")
        expect = ftk.must_query("select a from sp order by a limit 5").rows
        ftk.must_exec("set @@tidb_mem_quota_query = 131072")  # force spill
        got_rs = ftk.must_query("select a, s from sp order by a, s")
        vals = [r[0] for r in got_rs.rows]
        assert vals == sorted(vals)
        assert len(vals) == 12000
        assert ftk.domain.metrics.get("sort_spill_count", 0) >= 1
        assert [ (v,) for v in vals[:5] ] == expect


class TestViewsCTE:
    def test_cte(self, ftk):
        ftk.must_exec("create table c1 (a int, b int)")
        ftk.must_exec("insert into c1 values (1,10),(2,20),(3,30)")
        ftk.must_query(
            "with big as (select * from c1 where a >= 2), "
            "s (total) as (select sum(b) from big) "
            "select big.a, s.total from big, s order by big.a").check([
                (2, "50"), (3, "50")])

    def test_view(self, ftk):
        ftk.must_exec("create table v0 (a int, b int)")
        ftk.must_exec("insert into v0 values (1,10),(2,20)")
        ftk.must_exec("create view v1 as select a, b*2 as d from v0")
        ftk.must_query("select * from v1 order by a").check([(1, 20), (2, 40)])
        ftk.must_query("select sum(d) from v1").check([(60,)])
        # view over view + column aliases
        ftk.must_exec("create view v2 (x) as select d from v1 where a = 2")
        ftk.must_query("select x from v2").check([(40,)])
        # view reflects new base data
        ftk.must_exec("insert into v0 values (3,30)")
        ftk.must_query("select count(*) from v1").check([(3,)])
        r = ftk.must_query("select table_name from information_schema.views "
                           "where table_schema = 'test' order by 1")
        assert r.rows == [("v1",), ("v2",)]
        ftk.must_exec("drop table v2, v1")
        ftk.must_exec("create or replace view v1 as select 99")

    def test_kill(self, ftk):
        ftk.must_exec("create table k1 (a int)")
        # cooperative kill flag: mark, then next query of that conn dies
        ectx_holder = {}
        from tidb_tpu_torch.executor import ExecContext
        import tidb_tpu_torch.session.session as S
        ftk.domain.kill_conn(999)    # unknown conn: no-op
        ftk.must_query("select * from k1")


class TestPointGet:
    def test_pk_point_get(self, ftk):
        ftk.must_exec("create table pg1 (id int primary key, v varchar(10))")
        ftk.must_exec("insert into pg1 values (1,'a'),(2,'b'),(3,'c')")
        r = ftk.must_query("explain select * from pg1 where id = 2")
        assert any("PointGet" in row[0] for row in r.rows)
        ftk.must_query("select * from pg1 where id = 2").check([(2, "b")])
        ftk.must_query("select v from pg1 where id = 99").check([])
        ftk.must_exec("update pg1 set v = 'bb' where id = 2")
        ftk.must_query("select v from pg1 where id = 2").check([("bb",)])
        ftk.must_exec("delete from pg1 where id = 2")
        ftk.must_query("select * from pg1 where id = 2").check([])

    def test_unique_index_point_get(self, ftk):
        ftk.must_exec("create table pg2 (a int, u varchar(10) unique, v int)")
        ftk.must_exec("insert into pg2 values (1,'x',10),(2,'y',20)")
        r = ftk.must_query("explain select v from pg2 where u = 'y'")
        assert any("PointGet" in row[0] for row in r.rows)
        ftk.must_query("select v from pg2 where u = 'y'").check([(20,)])
        ftk.must_query("select v from pg2 where u = 'zz'").check([])

    def test_point_get_in_txn(self, ftk):
        ftk.must_exec("create table pg3 (id int primary key, v int)")
        ftk.must_exec("insert into pg3 values (1, 10)")
        ftk.must_exec("begin")
        ftk.must_exec("update pg3 set v = 99 where id = 1")
        ftk.must_query("select v from pg3 where id = 1").check([(99,)])
        tk2 = ftk.new_session()
        tk2.must_query("select v from pg3 where id = 1").check([(10,)])
        ftk.must_exec("commit")
        tk2.must_query("select v from pg3 where id = 1").check([(99,)])


class TestPartitionedTables:
    def test_range_partitions(self, ftk):
        ftk.must_exec("""create table pr (a int, v varchar(8))
            partition by range (a)
            (partition p0 values less than (10),
             partition p1 values less than (100),
             partition pmax values less than maxvalue)""")
        ftk.must_exec("insert into pr values (1,'a'),(5,'b'),(50,'c'),"
                      "(500,'d')")
        ftk.must_query("select a from pr order by a").check(
            [(1,), (5,), (50,), (500,)])
        # partition pruning: only p0 scanned for a < 10
        ftk.must_query("select v from pr where a < 10 order by a").check(
            [("a",), ("b",)])
        ftk.must_query("select count(*), sum(a) from pr where a >= 10")\
            .check([(2, "550")])
        # rows landed in distinct physical partitions
        tbl = ftk.domain.infoschema().table_by_name("test", "pr")
        pids = [p["pid"] for p in tbl.partitions["parts"]]
        counts = [ftk.domain.columnar.tables[p].live_count()
                  for p in pids if p in ftk.domain.columnar.tables]
        assert sum(counts) == 4 and len([c for c in counts if c]) >= 2
        r = ftk.must_query("select partition_name from "
                           "information_schema.partitions where "
                           "table_name = 'pr' order by 1")
        assert r.rows == [("p0",), ("p1",), ("pmax",)]

    def test_partition_update_move_and_delete(self, ftk):
        ftk.must_exec("""create table pm (a int, v int)
            partition by range (a)
            (partition p0 values less than (10),
             partition p1 values less than maxvalue)""")
        ftk.must_exec("insert into pm values (5, 1), (15, 2)")
        # update moves the row across partitions
        ftk.must_exec("update pm set a = 95 where a = 5")
        ftk.must_query("select a from pm order by a").check([(15,), (95,)])
        ftk.must_exec("delete from pm where a = 95")
        ftk.must_query("select a from pm").check([(15,)])

    def test_hash_partitions(self, ftk):
        ftk.must_exec("create table ph (a int, v int) "
                      "partition by hash (a) partitions 4")
        ftk.must_exec("insert into ph values " + ",".join(
            f"({i}, {i*2})" for i in range(20)))
        ftk.must_query("select count(*) from ph").check([(20,)])
        ftk.must_query("select sum(v) from ph where a = 7").check([("14",)])
        ftk.must_query("select a from ph where a in (3, 11) order by a")\
            .check([(3,), (11,)])

    def test_exchange_partition(self, ftk):
        """ALTER TABLE ... EXCHANGE PARTITION (reference
        ddl/partition.go onExchangeTablePartition): partition data and
        table data swap; validation rejects out-of-range rows."""
        ftk.must_exec("""create table pe (a int, v int)
            partition by range (a)
            (partition p0 values less than (10),
             partition p1 values less than maxvalue)""")
        ftk.must_exec("insert into pe values (1,10),(2,20),(50,500)")
        ftk.must_exec("create table pe_x (a int, v int)")
        ftk.must_exec("insert into pe_x values (7,70),(8,80)")
        ftk.must_exec("alter table pe exchange partition p0 "
                      "with table pe_x")
        ftk.must_query("select a, v from pe order by a").check(
            [(7, 70), (8, 80), (50, 500)])
        ftk.must_query("select a, v from pe_x order by a").check(
            [(1, 10), (2, 20)])
        # pruning still scans only p0 for a < 10 after the swap
        ftk.must_query("select sum(v) from pe where a < 10").check(
            [("150",)])
        # validation: a row outside the partition range refuses
        ftk.must_exec("insert into pe_x values (500, 1)")
        err = ftk.exec_err("alter table pe exchange partition p0 "
                           "with table pe_x")
        assert "does not match the partition" in str(err)
        # WITHOUT VALIDATION skips the check (MySQL semantics)
        ftk.must_exec("alter table pe exchange partition p0 "
                      "with table pe_x without validation")
        ftk.must_query("select count(*) from pe_x").check([(2,)])
        # schema mismatch refuses
        ftk.must_exec("create table pe_y (a int, v varchar(4))")
        err = ftk.exec_err("alter table pe exchange partition p1 "
                           "with table pe_y")
        assert "different definitions" in str(err)

    def test_reorganize_partition(self, ftk):
        """ALTER TABLE ... REORGANIZE PARTITION: split/merge range
        partitions; rows re-route; covered range must be preserved."""
        ftk.must_exec("""create table pro (a int, v int)
            partition by range (a)
            (partition p0 values less than (100),
             partition pmax values less than maxvalue)""")
        ftk.must_exec("insert into pro values (5,1),(50,2),(95,3),"
                      "(500,4)")
        ftk.must_exec("alter table pro reorganize partition p0 into "
                      "(partition p0a values less than (10), "
                      "partition p0b values less than (100))")
        tbl = ftk.domain.infoschema().table_by_name("test", "pro")
        assert [p["name"] for p in tbl.partitions["parts"]] == \
            ["p0a", "p0b", "pmax"]
        ftk.must_query("select a from pro order by a").check(
            [(5,), (50,), (95,), (500,)])
        # rows landed in the right new partitions (pruning-backed)
        ftk.must_query("select count(*) from pro where a < 10").check(
            [(1,)])
        ftk.must_query("select count(*) from pro where a >= 10 "
                       "and a < 100").check([(2,)])
        # merge back
        ftk.must_exec("alter table pro reorganize partition p0a, p0b "
                      "into (partition p0 values less than (100))")
        ftk.must_query("select count(*) from pro where a < 100").check(
            [(3,)])
        # range-coverage violation refuses
        err = ftk.exec_err("alter table pro reorganize partition p0 "
                           "into (partition q values less than (50))")
        assert "covered range" in str(err)
        # non-consecutive sources refuse
        err = ftk.exec_err("alter table pro reorganize partition p0, "
                           "pmax2 into (partition q values less than "
                           "maxvalue)")
        assert "Unknown partition" in str(err)
        # duplicate name vs an untouched partition refuses (review
        # probe: would leave ['pmax', ..., 'pmax'])
        err = ftk.exec_err("alter table pro reorganize partition p0 "
                           "into (partition pmax values less than "
                           "(100))")
        assert "Duplicate partition name" in str(err)
        # overlap with the preceding untouched partition refuses
        # (review probe: bounds [100, 50, ...] break pruning)
        ftk.must_exec("alter table pro reorganize partition pmax into "
                      "(partition p1 values less than (200), "
                      "partition pmax values less than maxvalue)")
        err = ftk.exec_err("alter table pro reorganize partition p1 "
                           "into (partition qa values less than (50), "
                           "partition qb values less than (200))")
        assert "ascending" in str(err)
        # all rows still present after every refused attempt
        ftk.must_query("select count(*) from pro").check([(4,)])

    def test_placement_policy_detach_via_default(self, ftk):
        """PLACEMENT POLICY = DEFAULT detaches (review probe: an
        attached policy was permanently undroppable)."""
        ftk.must_exec("create placement policy pdet followers=1")
        ftk.must_exec("create table pdt (a int)")
        ftk.must_exec("alter table pdt placement policy = pdet")
        err = ftk.exec_err("drop placement policy pdet")
        assert "in use" in str(err)
        ftk.must_exec("alter table pdt placement policy = default")
        ftk.must_exec("drop placement policy pdet")

    def test_placement_policies(self, ftk):
        """CREATE/ALTER/DROP PLACEMENT POLICY + table attachment
        (reference pkg/ddl/placement_policy.go)."""
        ftk.must_exec("create placement policy pp1 "
                      "primary_region='us-east-1' regions='us-east-1,"
                      "us-west-1' followers=2")
        ftk.must_exec("create table ppt (a int)")
        ftk.must_exec("alter table ppt placement policy = pp1")
        r = ftk.must_query(
            "select policy_name, attached_tables from "
            "information_schema.placement_policies")
        assert r.rows == [("pp1", "test.ppt")]
        # drop refuses while attached
        err = ftk.exec_err("drop placement policy pp1")
        assert "in use" in str(err)
        ftk.must_exec("alter placement policy pp1 followers=3")
        r = ftk.must_query("select settings from "
                           "information_schema.placement_policies")
        assert '"followers": 3' in r.rows[0][0]
        ftk.must_exec("drop table ppt")
        ftk.must_exec("drop placement policy pp1")
        ftk.must_exec("create placement policy if not exists pp1 "
                      "followers=1")
        ftk.must_exec("drop placement policy if exists pp1")
        err = ftk.exec_err("alter table pe placement policy = nope")
        assert "Unknown placement policy" in str(err)

    def test_partition_selection_clause(self, ftk):
        """SELECT/DELETE ... FROM t PARTITION (p, ...) restricts the
        scan to the named partitions (reference parser.y
        PartitionNameListOpt + partition pruning)."""
        ftk.must_exec("""create table psel (a int, v int)
            partition by range (a)
            (partition p0 values less than (10),
             partition p1 values less than maxvalue)""")
        ftk.must_exec("insert into psel values (1,10),(5,50),(50,500)")
        ftk.must_query("select a from psel partition (p0) order by a")\
            .check([(1,), (5,)])
        ftk.must_query("select sum(v) from psel partition (p1)").check(
            [("500",)])
        ftk.must_query("select count(*) from psel partition (p0, p1)")\
            .check([(3,)])
        e = ftk.exec_err("select * from psel partition (nope)")
        assert "Unknown partition" in str(e)
        ftk.must_query("select count(*) from psel partition (p0) "
                       "where a >= 10").check([(0,)])   # sel ∩ prune
        ftk.must_exec("delete from psel partition (p0) where a = 1")
        ftk.must_query("select count(*) from psel").check([(2,)])

    def test_multi_table_update(self, ftk):
        """UPDATE t1, t2 SET ... (reference executor/update.go): one
        joined read, each target row updates once even with multiple
        join matches."""
        ftk.must_exec("create table mua (id int primary key, v int)")
        ftk.must_exec("create table mub (id int primary key, aid int, "
                      "w int)")
        ftk.must_exec("insert into mua values (1, 10), (2, 20)")
        ftk.must_exec("insert into mub values (1,1,100),(2,1,200),"
                      "(3,2,300)")
        ftk.must_exec("update mua, mub set mua.v = mua.v + 1, "
                      "mub.w = mub.w * 2 where mua.id = mub.aid")
        ftk.must_query("select id, v from mua order by id").check(
            [(1, 11), (2, 21)])     # +1 once despite two matches
        ftk.must_query("select id, w from mub order by id").check(
            [(1, 200), (2, 400), (3, 600)])
        ftk.must_exec("update mua join mub on mua.id = mub.aid "
                      "set mua.v = 0 where mub.w > 500")
        ftk.must_query("select v from mua order by id").check(
            [(11,), (0,)])
        # aliases + unqualified unambiguous assignment column
        ftk.must_exec("update mua as x, mub as y set w = 1 "
                      "where x.id = y.aid and x.id = 2")
        ftk.must_query("select w from mub where id = 3").check([(1,)])

    def test_multi_update_outer_join_skips_nonmatches(self, ftk):
        """Review regression: outer-join rows with a NULL handle must
        not update a phantom record."""
        ftk.must_exec("create table moa (id int primary key, v int)")
        ftk.must_exec("create table mob (id int primary key, aid int, "
                      "w int)")
        ftk.must_exec("insert into moa values (1,10),(2,20),(5,50)")
        ftk.must_exec("insert into mob values (1,1,100)")
        ftk.must_exec("update moa left join mob on moa.id = mob.aid "
                      "set moa.v = moa.v + 1, mob.w = 0")
        ftk.must_query("select id, v from moa order by id").check(
            [(1, 11), (2, 21), (5, 51)])
        ftk.must_query("select id, w from mob").check([(1, 0)])

    def test_insert_partition_selection_enforced(self, ftk):
        """INSERT INTO t PARTITION (p): rows routing elsewhere refuse
        (MySQL ER_ROW_DOES_NOT_MATCH_GIVEN_PARTITION_SET)."""
        ftk.must_exec("""create table ipe (x int, y int)
            partition by range (x)
            (partition p0 values less than (5),
             partition p1 values less than maxvalue)""")
        ftk.must_exec("insert into ipe partition (p1) values (7, 7)")
        e = ftk.exec_err("insert into ipe partition (p1) values (1, 1)")
        assert "not matching the given partition" in str(e)
        e = ftk.exec_err("insert into ipe partition (nope) "
                         "values (1, 1)")
        assert "Unknown partition" in str(e)

    def test_pointget_skip_locked(self, ftk):
        from tidb_tpu_torch.session import Session
        ftk.must_exec("create table psl (a int primary key, b int)")
        ftk.must_exec("insert into psl values (1,10),(2,20)")
        s1 = Session(ftk.domain)
        s1.vars.current_db = "test"
        s2 = Session(ftk.domain)
        s2.vars.current_db = "test"
        try:
            s1.execute("begin")
            s1.execute("select * from psl where a = 2 for update")
            s2.execute("begin")
            rs = s2.execute("select * from psl where a = 2 "
                            "for update skip locked")
            assert rs.rows == []
        finally:
            s1.execute("rollback")
            s2.execute("rollback")

    def test_tablesample_and_rand(self, ftk):
        """TABLESAMPLE BERNOULLI/SYSTEM (pct): deterministic
        Knuth-hash Bernoulli over the row handle (reproducible runs,
        pushes down as an int filter); RAND([seed]) uniform rows."""
        ftk.must_exec("create table tsmp (id int primary key, v int)")
        ftk.must_exec("insert into tsmp values " +
                      ",".join(f"({i},{i})" for i in range(1, 2001)))
        n25 = ftk.must_query("select count(*) from tsmp tablesample "
                             "bernoulli (25)").rs.rows[0][0]
        assert 350 <= n25 <= 650
        ftk.must_query("select count(*) from tsmp tablesample "
                       "system (0)").check([(0,)])
        ftk.must_query("select count(*) from tsmp tablesample "
                       "bernoulli (100)").check([(2000,)])
        a = ftk.must_query("select sum(v) from tsmp tablesample "
                           "bernoulli (25)").rs.rows
        b = ftk.must_query("select sum(v) from tsmp tablesample "
                           "bernoulli (25)").rs.rows
        assert a == b                      # deterministic
        r = ftk.must_query("select rand(), rand(5), rand(5)").rs.rows[0]
        assert 0 <= r[0] < 1 and r[1] == r[2]
        rows = ftk.must_query("select rand(7) from tsmp limit 5").rs.rows
        assert len({x[0] for x in rows}) > 1   # varies per row

    def test_select_into_var(self, ftk):
        ftk.must_exec("create table siv (a int primary key, b int)")
        ftk.must_exec("insert into siv values (1,10),(2,20)")
        ftk.must_exec("select b into @sv from siv where a = 2")
        ftk.must_query("select @sv * 2").check([(40,)])
        ftk.must_exec("select a, b into @sa, @sb from siv where a = 1")
        ftk.must_query("select @sa + @sb").check([(11,)])
        e = ftk.exec_err("select b into @sz from siv")
        assert "more than one row" in str(e)

    def test_for_update_skip_locked_nowait(self, ftk):
        """FOR UPDATE SKIP LOCKED drops conflicting rows; NOWAIT (and
        plain FOR UPDATE — no wait queue here) errors immediately; the
        planner keeps the row handle so scan-shaped FOR UPDATE
        actually locks."""
        from tidb_tpu_torch.session import Session
        from tidb_tpu_torch.errors import LockWaitTimeoutError
        ftk.must_exec("create table fsl (a int primary key, b int)")
        ftk.must_exec("insert into fsl values (1,10),(2,20),(3,30)")
        s1 = Session(ftk.domain)
        s1.vars.current_db = "test"
        s2 = Session(ftk.domain)
        s2.vars.current_db = "test"
        try:
            s1.execute("begin")
            s1.execute("select * from fsl where a = 2 for update")
            s2.execute("begin")
            rs = s2.execute("select a from fsl for update skip locked")
            assert [r[0] for r in rs.rows] == [1, 3]
            with pytest.raises(LockWaitTimeoutError):
                s2.execute("select b from fsl for update nowait")
        finally:
            s1.execute("rollback")
            s2.execute("rollback")

    def test_partition_txn(self, ftk):
        ftk.must_exec("""create table pt2 (a int, v int)
            partition by range (a)
            (partition p0 values less than (10),
             partition p1 values less than maxvalue)""")
        ftk.must_exec("begin")
        ftk.must_exec("insert into pt2 values (5, 1), (50, 2)")
        ftk.must_query("select a from pt2 order by a").check([(5,), (50,)])
        ftk.must_exec("rollback")
        ftk.must_query("select count(*) from pt2").check([(0,)])


class TestForeignKeys:
    def test_fk_restrict(self, ftk):
        ftk.must_exec("create table par (id int primary key, v int)")
        ftk.must_exec("create table ch (a int, pid int, "
                      "foreign key (pid) references par (id))")
        ftk.must_exec("insert into par values (1, 10), (2, 20)")
        ftk.must_exec("insert into ch values (1, 1), (2, null)")
        e = ftk.exec_err("insert into ch values (3, 99)")
        assert e.code == 1452
        e = ftk.exec_err("delete from par where id = 1")
        assert e.code == 1451
        ftk.must_exec("delete from par where id = 2")  # unreferenced: ok
        ftk.must_exec("delete from ch where a = 1")
        ftk.must_exec("delete from par where id = 1")  # now ok

    def test_fk_cascade(self, ftk):
        ftk.must_exec("create table p2 (id int primary key)")
        ftk.must_exec("create table c2 (x int, pid int, "
                      "foreign key (pid) references p2 (id) "
                      "on delete cascade)")
        ftk.must_exec("insert into p2 values (1), (2)")
        ftk.must_exec("insert into c2 values (10, 1), (11, 1), (12, 2)")
        ftk.must_exec("delete from p2 where id = 1")
        ftk.must_query("select x from c2 order by x").check([(12,)])

    def test_fk_update_child(self, ftk):
        ftk.must_exec("create table p3 (id int primary key)")
        ftk.must_exec("create table c3 (pid int, "
                      "foreign key (pid) references p3 (id))")
        ftk.must_exec("insert into p3 values (1)")
        ftk.must_exec("insert into c3 values (1)")
        e = ftk.exec_err("update c3 set pid = 5")
        assert e.code == 1452
        ftk.must_exec("update c3 set pid = null")


class TestMoreBuiltins:
    def test_math_trig(self, tk):
        tk.must_query("select round(pi(), 4), round(degrees(pi()), 0), "
                      "round(sin(0), 3), round(cos(0), 3)").check(
            [("3.1416", "180", "0", "1")])
        tk.must_query("select crc32('abc')").check([(891568578,)])

    def test_string_extras(self, tk):
        tk.must_query("select hex('AB'), unhex('4142'), bin(5), oct(9)")\
            .check([("4142", "AB", "101", "11")])
        tk.must_query("select ascii('A'), repeat('ab', 3), strcmp('a','b'), "
                      "strcmp('b','a'), strcmp('a','a')").check(
            [(65, "ababab", -1, 1, 0)])
        tk.must_query("select md5('x') = 'deaf'").check([(0,)])
        tk.must_query("select field('b', 'a', 'b', 'c'), elt(2, 'x', 'y')")\
            .check([(2, "y")])
        tk.must_query("select conv('ff', 16, 10), conv('10', 10, 2)")\
            .check([("255", "1010")])


class TestSavepoints:
    def test_savepoint_rollback(self, ftk):
        ftk.must_exec("create table sv1 (a int)")
        ftk.must_exec("begin")
        ftk.must_exec("insert into sv1 values (1)")
        ftk.must_exec("savepoint s1")
        ftk.must_exec("insert into sv1 values (2), (3)")
        ftk.must_query("select count(*) from sv1").check([(3,)])
        ftk.must_exec("rollback to s1")
        ftk.must_query("select a from sv1").check([(1,)])
        ftk.must_exec("insert into sv1 values (9)")
        ftk.must_exec("commit")
        ftk.must_query("select a from sv1 order by a").check([(1,), (9,)])

    def test_savepoint_release_and_missing(self, ftk):
        ftk.must_exec("create table sv2 (a int)")
        ftk.must_exec("begin")
        ftk.must_exec("savepoint sa")
        ftk.must_exec("release savepoint sa")
        e = ftk.exec_err("rollback to sa")
        ftk.must_exec("commit")


class TestConcurrency:
    def test_concurrent_oltp_olap(self, ftk):
        """Race smoke test (reference -race CI runs): writer threads insert
        while readers aggregate; totals must reconcile at the end."""
        import threading
        ftk.must_exec("create table cc (id bigint primary key auto_increment,"
                      " g int, v int)")
        errors = []
        N, T = 120, 3

        def writer(t):
            try:
                s = ftk.new_session()
                for i in range(N):
                    s.must_exec(f"insert into cc (g, v) values ({t}, {i})")
            except Exception as e:                     # noqa: BLE001
                errors.append(e)

        def reader():
            try:
                s = ftk.new_session()
                for _ in range(30):
                    s.must_query("select g, count(*), sum(v) from cc "
                                 "group by g")
            except Exception as e:                     # noqa: BLE001
                errors.append(e)

        ths = [threading.Thread(target=writer, args=(t,)) for t in range(T)]
        ths += [threading.Thread(target=reader) for _ in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert not errors, errors[:2]
        ftk.must_query("select count(*), sum(v) from cc").check(
            [(N * T, str(T * (N * (N - 1) // 2)))])


class TestDeviceJoin:
    def test_device_join_matches_host(self, ftk):
        import numpy as np
        ftk.must_exec("create table dj1 (id int, v int)")
        ftk.must_exec("create table dj2 (id int, w int)")
        rng = np.random.default_rng(9)
        rows1 = ",".join(f"({int(a)}, {i})" for i, a in
                         enumerate(rng.integers(0, 50, 300)))
        rows2 = ",".join(f"({int(a)}, {i})" for i, a in
                         enumerate(rng.integers(0, 50, 200)))
        ftk.must_exec(f"insert into dj1 values {rows1}, (null, 999)")
        ftk.must_exec(f"insert into dj2 values {rows2}, (null, 998)")
        queries = [
            "select count(*), sum(v), sum(w) from dj1 join dj2 "
            "on dj1.id = dj2.id",
            "select count(*) from dj1 left join dj2 on dj1.id = dj2.id",
            "select count(*) from dj1 where id in (select id from dj2)",
            "select count(*) from dj1 where id not in "
            "(select dj2.id from dj2 where dj2.id is not null)",
        ]
        results = {}
        for mode in ("host", "device"):
            ftk.must_exec(f"set @@tidb_join_exec = {mode}")
            ftk.domain.plan_cache.clear()
            results[mode] = [ftk.must_query(q).rows for q in queries]
        assert results["host"] == results["device"]


class TestSetOpsAndRunaway:
    def test_except_intersect(self, ftk):
        ftk.must_exec("create table so1 (a int)")
        ftk.must_exec("create table so2 (a int)")
        ftk.must_exec("insert into so1 values (1),(2),(2),(3)")
        ftk.must_exec("insert into so2 values (2),(4)")
        ftk.must_query("select a from so1 except select a from so2 "
                       "order by 1").check([(1,), (3,)])
        ftk.must_query("select a from so1 intersect select a from so2")\
            .check([(2,)])

    def test_max_execution_time(self, ftk):
        ftk.must_exec("create table rt (a int)")
        ftk.must_exec("insert into rt values (1)")
        ftk.must_exec("set @@max_execution_time = 60000")
        ftk.must_query("select * from rt").check([(1,)])  # fast query fine
        ftk.must_exec("set @@max_execution_time = 0")

    def test_processlist(self, ftk):
        r = ftk.must_query("show processlist")
        ids = [int(row[0]) for row in r.rows]
        assert ftk.sess.conn_id in ids


class TestAdmin:
    def test_admin_check_table(self, ftk):
        ftk.must_exec("create table ac (id int primary key, v varchar(10), "
                      "key idx_v (v))")
        ftk.must_exec("insert into ac values (1,'a'),(2,'b')")
        ftk.must_exec("update ac set v = 'bb' where id = 2")
        ftk.must_exec("delete from ac where id = 1")
        r = ftk.must_exec("admin check table ac")
        assert r.affected == 1
        # corrupt the columnar engine; check must fail
        tbl = ftk.domain.infoschema().table_by_name("test", "ac")
        ctab = ftk.domain.columnar.tables[tbl.id]
        ci = tbl.find_column("v")
        pos = ctab.handle_pos[2]
        ctab.data[ci.id][pos] = 0   # wrong dict code
        e = ftk.exec_err("admin check table ac")
        assert "mismatch" in str(e)

    def test_global_var_persisted(self, ftk):
        ftk.must_exec("set @@global.tidb_executor_concurrency = 5")
        r = ftk.must_query("select variable_value from "
                           "mysql.global_variables where variable_name = "
                           "'tidb_executor_concurrency'")
        assert r.rows == [("5",)]


class TestForUpdate:
    def test_select_for_update_blocks_writer(self, ftk):
        ftk.must_exec("create table fu (id int primary key, v int)")
        ftk.must_exec("insert into fu values (1, 10)")
        ftk.must_exec("begin")
        ftk.must_query("select * from fu where id = 1 for update")
        tk2 = ftk.new_session()
        e = tk2.exec_err("update fu set v = 99 where id = 1")
        assert isinstance(e, (errors.LockWaitTimeoutError,
                              errors.WriteConflictError))
        ftk.must_exec("commit")
        tk2.must_exec("update fu set v = 99 where id = 1")
        tk2.must_query("select v from fu").check([(99,)])

    def test_load_data_alias(self, ftk, tmp_path):
        ftk.must_exec("create table ld (a int, b varchar(5))")
        p = tmp_path / "x.csv"
        p.write_text("1,aa\n2,bb\n")
        ftk.must_exec(f"load data infile '{p}' into table ld "
                      "fields terminated by ','")
        ftk.must_query("select * from ld order by a").check(
            [(1, "aa"), (2, "bb")])


class TestWindowFrames:
    def test_moving_sum_avg(self, ftk):
        ftk.must_exec("create table wf (g int, v int)")
        ftk.must_exec("insert into wf values (1,1),(1,2),(1,3),(1,4),(2,10)")
        ftk.must_query(
            "select v, sum(v) over (partition by g order by v "
            "rows between 1 preceding and current row) from wf "
            "where g = 1 order by v").check([
                (1, "1"), (2, "3"), (3, "5"), (4, "7")])
        ftk.must_query(
            "select v, count(v) over (partition by g order by v "
            "rows between 1 preceding and 1 following) from wf "
            "where g = 1 order by v").check([
                (1, 2), (2, 3), (3, 3), (4, 2)])

    def test_moving_min_max_firstlast(self, ftk):
        ftk.must_exec("create table wf2 (v int)")
        ftk.must_exec("insert into wf2 values (5),(1),(4),(2),(3)")
        ftk.must_query(
            "select v, min(v) over (order by v rows between 1 preceding "
            "and 1 following), max(v) over (order by v rows between "
            "1 preceding and 1 following) from wf2 order by v").check([
                (1, 1, 2), (2, 1, 3), (3, 2, 4), (4, 3, 5), (5, 4, 5)])
        ftk.must_query(
            "select v, first_value(v) over (order by v rows between "
            "2 preceding and current row) from wf2 order by v").check([
                (1, 1), (2, 1), (3, 1), (4, 2), (5, 3)])

    def test_range_frames(self, ftk):
        ftk.must_exec("create table wr (g int, k int, v int)")
        ftk.must_exec("insert into wr values (1,1,10),(1,2,20),(1,4,40),"
                      "(1,8,80),(2,1,5),(2,2,6),(1,null,99)")
        # value-based frame: k=2 reaches k=1..3; k=4 reaches only itself
        ftk.must_query(
            "select g, k, sum(v) over (partition by g order by k range "
            "between 1 preceding and 1 following) from wr "
            "order by g, k").check([
                (1, None, "99"), (1, 1, "30"), (1, 2, "30"), (1, 4, "40"),
                (1, 8, "80"), (2, 1, "11"), (2, 2, "11")])
        # unbounded start includes the NULL block; numeric end is by value
        ftk.must_query(
            "select k, count(*) over (order by k range between unbounded "
            "preceding and 2 following) from wr where g = 1 "
            "order by k").check([
                (None, 1), (1, 3), (2, 4), (4, 4), (8, 5)])
        # DESC: preceding/following run along the sort direction
        ftk.must_query(
            "select k, sum(v) over (order by k desc range between "
            "1 preceding and 1 following) from wr where g = 1 and "
            "k is not null order by k desc").check([
                (8, "80"), (4, "40"), (2, "30"), (1, "30")])
        # min/max over a value frame (sparse-table path)
        ftk.must_query(
            "select k, max(v) over (order by k range between 2 preceding "
            "and 2 following) from wr where g = 1 and k is not null "
            "order by k").check([(1, 20), (2, 40), (4, 40), (8, 80)])

    def test_range_frames_interval_units(self, ftk):
        """RANGE INTERVAL n unit frames over temporal ORDER keys
        (reference range framer + types.Interval): fixed units add a
        constant in key space; MONTH walks the civil calendar with
        MySQL's day clamping (Mar 31 - 1 month = Feb 29)."""
        ftk.must_exec("create table wri (d date, dt datetime, v int)")
        ftk.must_exec("""insert into wri values
            ('2024-01-01','2024-01-01 10:00:00',1),
            ('2024-01-03','2024-01-01 11:30:00',2),
            ('2024-01-05','2024-01-01 13:00:00',3),
            ('2024-02-28','2024-01-02 10:00:00',4),
            ('2024-03-31','2024-01-02 10:30:00',5)""")
        ftk.must_query(
            "select d, sum(v) over (order by d range between interval "
            "2 day preceding and current row) from wri order by d")\
            .check([("2024-01-01", "1"), ("2024-01-03", "3"),
                    ("2024-01-05", "5"), ("2024-02-28", "4"),
                    ("2024-03-31", "5")])
        ftk.must_query(
            "select dt, sum(v) over (order by dt range between interval "
            "90 minute preceding and current row) from wri order by dt")\
            .check([("2024-01-01 10:00:00", "1"),
                    ("2024-01-01 11:30:00", "3"),
                    ("2024-01-01 13:00:00", "5"),
                    ("2024-01-02 10:00:00", "4"),
                    ("2024-01-02 10:30:00", "9")])
        # calendar month: 2024-03-31 - 1 month = 2024-02-29 > 02-28
        ftk.must_query(
            "select d, sum(v) over (order by d range between interval "
            "1 month preceding and current row) from wri order by d")\
            .check([("2024-01-01", "1"), ("2024-01-03", "3"),
                    ("2024-01-05", "6"), ("2024-02-28", "4"),
                    ("2024-03-31", "5")])
        # DESC: preceding runs along the iteration direction
        ftk.must_query(
            "select d, sum(v) over (order by d desc range between "
            "interval 2 day preceding and current row) from wri "
            "order by d").check(
            [("2024-01-01", "3"), ("2024-01-03", "5"),
             ("2024-01-05", "3"), ("2024-02-28", "4"),
             ("2024-03-31", "5")])
        # following side + year unit
        ftk.must_query(
            "select d, count(*) over (order by d range between current "
            "row and interval 1 year following) from wri order by d")\
            .check([("2024-01-01", 5), ("2024-01-03", 4),
                    ("2024-01-05", 3), ("2024-02-28", 2),
                    ("2024-03-31", 1)])
        # review regressions: non-temporal keys refuse, ROWS+INTERVAL
        # refuses, fractional counts round (1.5 DAY = 2 DAY),
        # compound literals refuse cleanly
        e = ftk.exec_err(
            "select sum(v) over (order by v range between interval "
            "1 day preceding and current row) from wri")
        assert "temporal" in str(e)
        e = ftk.exec_err(
            "select sum(v) over (order by d rows between interval "
            "1 day preceding and current row) from wri")
        assert "RANGE" in str(e)
        ftk.must_query(
            "select d, sum(v) over (order by d range between interval "
            "1.5 day preceding and current row) from wri "
            "where d < '2024-01-10' order by d").check(
            [("2024-01-01", "1"), ("2024-01-03", "3"),
             ("2024-01-05", "5")])
        # compound units normalize to the finest single unit: a
        # sub-day remainder over a DATE key refuses (34h != whole
        # days), a whole-day count works
        e = ftk.exec_err(
            "select sum(v) over (order by d range between interval "
            "'1 10' day_hour preceding and current row) from wri")
        assert "DATETIME" in str(e)
        ftk.must_query(
            "select d, sum(v) over (order by d range between interval "
            "'2 0' day_hour preceding and current row) from wri "
            "where d < '2024-01-10' order by d").check(
            [("2024-01-01", "1"), ("2024-01-03", "3"),
             ("2024-01-05", "5")])
        ftk.must_query(
            "select dt, sum(v) over (order by dt range between interval "
            "'1:30' hour_minute preceding and current row) from wri "
            "order by dt").check(
            [("2024-01-01 10:00:00", "1"),
             ("2024-01-01 11:30:00", "3"),
             ("2024-01-01 13:00:00", "5"),
             ("2024-01-02 10:00:00", "4"),
             ("2024-01-02 10:30:00", "9")])


class TestRecursiveCTE:
    def test_numbers(self, ftk):
        ftk.must_query(
            "with recursive nums (n) as ("
            "  select 1 union all select n + 1 from nums where n < 5) "
            "select * from nums order by n").check(
            [(1,), (2,), (3,), (4,), (5,)])

    def test_hierarchy(self, ftk):
        ftk.must_exec("create table emp2 (id int, mgr int)")
        ftk.must_exec("insert into emp2 values (1, null), (2, 1), (3, 1), "
                      "(4, 2), (5, 4)")
        ftk.must_query(
            "with recursive chain (id) as ("
            "  select id from emp2 where mgr is null "
            "  union all "
            "  select emp2.id from emp2 join chain on emp2.mgr = chain.id) "
            "select count(*) from chain").check([(5,)])

    def test_union_distinct_termination(self, ftk):
        # cycle: a->b->a; UNION (distinct) must terminate
        ftk.must_exec("create table edges (src int, dst int)")
        ftk.must_exec("insert into edges values (1,2),(2,1),(2,3)")
        ftk.must_query(
            "with recursive reach (node) as ("
            "  select 1 union "
            "  select dst from edges join reach on src = node) "
            "select node from reach order by node").check(
            [(1,), (2,), (3,)])


class TestJSONFuncs:
    def test_json(self, ftk):
        ftk.must_exec("create table js (doc json)")
        ftk.must_exec("""insert into js values
            ('{"a": 1, "b": [10, 20], "s": "x"}'), ('[1,2,3]'), ('oops')""")
        ftk.must_query("select json_extract(doc, '$.a') from js "
                       "where json_valid(doc) = 1 and json_length(doc) > 2 "
                       "order by 1 desc").check([("1",), ("",)])
        ftk.must_query(
            "select json_unquote(json_extract(doc, '$.s')) from js "
            "where json_extract(doc, '$.s') <> ''").check([("x",)])
        ftk.must_query("select json_extract(doc, '$.b[1]') from js "
                       "where json_valid(doc) = 1 order by 1")\
            .check([("",), ("20",)])


class TestMultiTableDelete:
    def test_delete_join(self, ftk):
        ftk.must_exec("create table md1 (id int, v int)")
        ftk.must_exec("create table md2 (ref int)")
        ftk.must_exec("insert into md1 values (1,10),(2,20),(3,30)")
        ftk.must_exec("insert into md2 values (1),(3)")
        ftk.must_exec("delete md1 from md1 join md2 on md1.id = md2.ref")
        ftk.must_query("select id from md1").check([(2,)])
        ftk.must_query("select count(*) from md2").check([(2,)])

    def test_delete_both_tables(self, ftk):
        ftk.must_exec("create table mda (id int)")
        ftk.must_exec("create table mdb (id int)")
        ftk.must_exec("insert into mda values (1),(2)")
        ftk.must_exec("insert into mdb values (2),(9)")
        ftk.must_exec("delete mda, mdb from mda join mdb on mda.id = mdb.id")
        ftk.must_query("select id from mda order by id").check([(1,)])
        ftk.must_query("select id from mdb order by id").check([(9,)])


class TestConstraintsDefaults:
    def test_check_constraint(self, ftk):
        ftk.must_exec("create table ck2 (a int, b int, check (a < b))")
        ftk.must_exec("insert into ck2 values (1, 2)")
        e = ftk.exec_err("insert into ck2 values (5, 2)")
        assert e.code == 3819
        e = ftk.exec_err("update ck2 set a = 99 where a = 1")
        assert e.code == 3819
        ftk.must_exec("insert into ck2 values (null, 2)")  # NULL passes

    def test_current_timestamp_default(self, ftk):
        ftk.must_exec("create table ts1 (id int, created datetime "
                      "default current_timestamp)")
        ftk.must_exec("insert into ts1 (id) values (1)")
        r = ftk.must_query("select created >= '2020-01-01' from ts1")
        r.check([(1,)])

    def test_varchar_too_long(self, ftk):
        ftk.must_exec("create table vc (s varchar(3))")
        e = ftk.exec_err("insert into vc values ('abcdef')")
        assert isinstance(e, errors.DataTooLongError)
        ftk.must_exec("insert into vc values ('abc')")


class TestCorrelatedSelectList:
    def test_scalar_subquery_in_select(self, ftk):
        ftk.must_exec("create table cs1 (id int, g int)")
        ftk.must_exec("create table cs2 (g int, v int)")
        ftk.must_exec("insert into cs1 values (1, 10), (2, 20), (3, 30)")
        ftk.must_exec("insert into cs2 values (10, 1), (10, 2), (20, 5)")
        ftk.must_query(
            "select id, (select sum(v) from cs2 where cs2.g = cs1.g) "
            "from cs1 order by id").check([
                (1, "3"), (2, "5"), (3, None)])
        ftk.must_query(
            "select id, (select count(*) from cs2 where cs2.g = cs1.g) "
            "from cs1 order by id").check([
                (1, 2), (2, 1), (3, 0)])


class TestSequences:
    def test_sequence_basics(self, ftk):
        ftk.must_exec("create sequence seq1 start with 10 increment by 2 "
                      "cache 5")
        ftk.must_query("select nextval(seq1)").check([(10,)])
        ftk.must_query("select nextval(seq1), lastval(seq1)")
        ftk.must_query("select nextval(seq1)").check([(14,)])
        ftk.must_exec("create table st1 (id bigint primary key, v int)")
        ftk.must_exec("insert into st1 values (nextval(seq1), 1), "
                      "(nextval(seq1), 2)")
        ftk.must_query("select id from st1 order by id").check(
            [(16,), (18,)])
        ftk.must_exec("drop sequence seq1")
        e = ftk.exec_err("select nextval(seq1)")

    def test_sequence_cache_persistence(self, ftk):
        ftk.must_exec("create sequence s2 cache 3")
        vals = [ftk.must_query("select nextval(s2)").rows[0][0]
                for _ in range(7)]
        assert vals == [1, 2, 3, 4, 5, 6, 7]


class TestIndexRange:
    def test_index_range_scan(self, ftk):
        ftk.must_exec("create table ir (id int primary key, k int, v int, "
                      "key idx_k (k))")
        rows = ",".join(f"({i}, {i % 1000}, {i})" for i in range(1, 5001))
        ftk.must_exec(f"insert into ir values {rows}")
        ftk.must_exec("analyze table ir")
        r = ftk.must_query("explain select v from ir where k = 7")
        assert any("IndexRange" in row[0] for row in r.rows), r.rows
        got = ftk.must_query("select v from ir where k = 7 order by v").rows
        assert got == [(i,) for i in range(7, 5001, 1000)]
        # range form
        got = ftk.must_query(
            "select count(*) from ir where k >= 998 and k <= 999").rows
        assert got == [(10,)]
        # residual filter on top of the index range
        got = ftk.must_query(
            "select v from ir where k = 7 and v > 3000 order by v").rows
        assert got == [(3007,), (4007,)]

    def test_index_range_respects_txn(self, ftk):
        ftk.must_exec("create table ir2 (id int primary key, k int, "
                      "key ik (k))")
        rows = ",".join(f"({i}, {i % 100})" for i in range(1, 2001))
        ftk.must_exec(f"insert into ir2 values {rows}")
        ftk.must_exec("analyze table ir2")
        ftk.must_exec("begin")
        before = ftk.must_query("select count(*) from ir2 where k = 5").rows
        tk2 = ftk.new_session()
        tk2.must_exec("insert into ir2 values (9001, 5)")
        after = ftk.must_query("select count(*) from ir2 where k = 5").rows
        assert before == after          # snapshot isolation holds
        ftk.must_exec("commit")


class TestCollation:
    def test_bin_default_case_sensitive(self, ftk):
        ftk.must_exec("create table cl1 (s varchar(10))")
        ftk.must_exec("insert into cl1 values ('Abc'), ('abc')")
        ftk.must_query("select count(*) from cl1 where s = 'abc'")\
            .check([(1,)])
        ftk.must_query("select count(*) from cl1 where s like 'a%'")\
            .check([(1,)])

    def test_ci_collation(self, ftk):
        ftk.must_exec("create table cl2 (s varchar(10) collate "
                      "utf8mb4_general_ci)")
        ftk.must_exec("insert into cl2 values ('Abc'), ('abc'), ('xyz')")
        ftk.must_query("select count(*) from cl2 where s = 'ABC'")\
            .check([(2,)])
        ftk.must_query("select count(*) from cl2 where s like 'AB%'")\
            .check([(2,)])
        ftk.must_query("select count(*) from cl2 where s < 'M'")\
            .check([(2,)])

    def test_unicode_ci_accent_insensitive(self, ftk):
        """utf8mb4_unicode_ci (MySQL-verified semantics): accent- and
        case-insensitive, German sharp s equals 'ss' (unlike
        general_ci, where ss != the sharp s's casefold in MySQL), PAD
        SPACE. Reference pkg/util/collate/collate.go:462 unicode_ci
        collator registration."""
        ftk.must_exec("create table clu (s varchar(20) collate "
                      "utf8mb4_unicode_ci)")
        ftk.must_exec("insert into clu values ('café'), ('CAFE'), "
                      "('resume'), ('résumé'), ('straße'), ('STRASSE'), "
                      "('pad ')")
        # MySQL 8.0: SELECT 'café' = 'CAFE' COLLATE utf8mb4_unicode_ci -> 1
        ftk.must_query("select count(*) from clu where s = 'cafe'")\
            .check([(2,)])
        ftk.must_query("select count(*) from clu where s = 'RÉSUMÉ'")\
            .check([(2,)])
        # MySQL: 'straße' = 'STRASSE' under unicode_ci -> 1
        ftk.must_query("select count(*) from clu where s = 'strasse'")\
            .check([(2,)])
        # PAD SPACE: trailing spaces ignored
        ftk.must_query("select count(*) from clu where s = 'pad'")\
            .check([(1,)])
        # grouping merges accent/case variants (witness value shown)
        ftk.must_query("select count(*) from (select s from clu "
                       "group by s) t").check([(4,)])

    def test_0900_ai_ci_no_pad(self, ftk):
        """utf8mb4_0900_ai_ci (MySQL-verified): accent/case-insensitive
        like unicode_ci but NO PAD — trailing spaces are significant
        (MySQL 8.0 manual, NO PAD collations)."""
        ftk.must_exec("create table cl9 (s varchar(20) collate "
                      "utf8mb4_0900_ai_ci)")
        ftk.must_exec("insert into cl9 values ('café'), ('CAFE'), "
                      "('pad '), ('pad')")
        ftk.must_query("select count(*) from cl9 where s = 'Cafe'")\
            .check([(2,)])
        # NO PAD: 'pad ' <> 'pad'
        ftk.must_query("select count(*) from cl9 where s = 'pad'")\
            .check([(1,)])
        ftk.must_query("select count(*) from cl9 where s = 'pad '")\
            .check([(1,)])

    def test_unicode_ci_order_and_minmax(self, ftk):
        ftk.must_exec("create table clo (s varchar(20) collate "
                      "utf8mb4_unicode_ci)")
        ftk.must_exec("insert into clo values ('zeta'), ('Émile'), "
                      "('apple'), ('École')")
        # accent-insensitive order: École sorts with E, Émile with E
        got = [r[0] for r in ftk.must_query(
            "select s from clo order by s").rows]
        assert got == ["apple", "École", "Émile", "zeta"], got
        ftk.must_query("select min(s), max(s) from clo")\
            .check([("apple", "zeta")])


class TestJoinSpill:
    def test_grace_join(self, ftk):
        import numpy as np
        ftk.must_exec("create table gj1 (k int, v int)")
        ftk.must_exec("create table gj2 (k int, w int)")
        rng = np.random.default_rng(4)
        r1 = ",".join(f"({int(a)},{i})" for i, a in
                      enumerate(rng.integers(0, 3000, 9000)))
        r2 = ",".join(f"({int(a)},{i})" for i, a in
                      enumerate(rng.integers(0, 3000, 6000)))
        ftk.must_exec(f"insert into gj1 values {r1}, (null, 1)")
        ftk.must_exec(f"insert into gj2 values {r2}")
        want = ftk.must_query(
            "select count(*), sum(v), sum(w) from gj1 join gj2 "
            "on gj1.k = gj2.k").rows
        want_left = ftk.must_query(
            "select count(*) from gj1 left join gj2 on gj1.k = gj2.k").rows
        ftk.must_exec("set @@tidb_mem_quota_query = 131072")  # force spill
        got = ftk.must_query(
            "select count(*), sum(v), sum(w) from gj1 join gj2 "
            "on gj1.k = gj2.k").rows
        got_left = ftk.must_query(
            "select count(*) from gj1 left join gj2 on gj1.k = gj2.k").rows
        assert got == want and got_left == want_left
        assert ftk.domain.metrics.get("join_spill_count", 0) >= 1


class TestAggExtras:
    def test_group_concat_order(self, ftk):
        ftk.must_exec("create table gc (g int, s varchar(5), o int)")
        ftk.must_exec("insert into gc values (1,'b',2),(1,'a',1),(1,'c',3),"
                      "(2,'z',1)")
        ftk.must_query("select g, group_concat(s order by o separator '-') "
                       "from gc group by g order by g").check([
                           (1, "a-b-c"), (2, "z")])
        ftk.must_query("select group_concat(s order by o desc) from gc "
                       "where g = 1").check([("c,b,a",)])

    def test_on_dup_values(self, ftk):
        ftk.must_exec("create table od (id int primary key, v int)")
        ftk.must_exec("insert into od values (1, 10)")
        ftk.must_exec("insert into od values (1, 99) on duplicate key "
                      "update v = values(v) + 1")
        ftk.must_query("select v from od").check([(100,)])


class TestIntrospection:
    def test_show_table_status(self, ftk):
        ftk.must_exec("create table sts (a int)")
        ftk.must_exec("insert into sts values (1),(2)")
        r = ftk.must_query("show table status")
        row = next(r0 for r0 in r.rows if r0[0] == "sts")
        assert row[3] == "2"

    def test_key_column_usage(self, ftk):
        ftk.must_exec("create table p9 (id int primary key)")
        ftk.must_exec("create table c9 (x int, pid int, "
                      "constraint myfk foreign key (pid) "
                      "references p9 (id))")
        r = ftk.must_query(
            "select constraint_name, column_name, referenced_table_name "
            "from information_schema.key_column_usage "
            "where table_name = 'c9'")
        assert ("myfk", "pid", "p9") in r.rows
        r = ftk.must_query(
            "select delete_rule from "
            "information_schema.referential_constraints "
            "where constraint_name = 'myfk'")
        assert r.rows == [("RESTRICT",)]


class TestBatchPointGet:
    def test_batch_get(self, ftk):
        ftk.must_exec("create table bpg (id int primary key, v int)")
        ftk.must_exec("insert into bpg values " + ",".join(
            f"({i},{i*10})" for i in range(1, 51)))
        r = ftk.must_query("explain select v from bpg where id in (3,7,99)")
        assert any("BatchPointGet" in row[0] for row in r.rows)
        ftk.must_query("select v from bpg where id in (3,7,99) order by v")\
            .check([(30,), (70,)])

    def test_explain_json(self, ftk):
        ftk.must_exec("create table ej (a int)")
        r = ftk.must_query("explain format = 'json' select * from ej "
                           "where a > 1")
        import json
        tree = json.loads(r.rows[0][0])
        assert "id" in tree and "children" in tree


class TestFastPathTxn:
    def test_batch_get_in_txn(self, ftk):
        ftk.must_exec("create table bpt (id int primary key, v int)")
        ftk.must_exec("insert into bpt values (1,10),(2,20),(3,30)")
        ftk.must_exec("begin")
        ftk.must_exec("update bpt set v = 99 where id = 2")
        ftk.must_exec("delete from bpt where id = 3")
        ftk.must_query("select v from bpt where id in (1,2,3) order by v")\
            .check([(10,), (99,)])
        ftk.must_exec("rollback")
        ftk.must_query("select v from bpt where id in (2,3) order by v")\
            .check([(20,), (30,)])

    def test_index_range_in_txn(self, ftk):
        ftk.must_exec("create table irt (id int primary key, k int, "
                      "key ik (k))")
        rows = ",".join(f"({i}, {i % 50})" for i in range(1, 2001))
        ftk.must_exec(f"insert into irt values {rows}")
        ftk.must_exec("analyze table irt")
        ftk.must_exec("begin")
        ftk.must_exec("insert into irt values (9001, 7)")
        r = ftk.must_query("explain select count(*) from irt where k = 7")
        got = ftk.must_query("select count(*) from irt where k = 7").rows
        assert got == [(41,)], (got, r.rows)
        ftk.must_exec("rollback")


class TestCTAS:
    def test_create_table_as_select(self, ftk):
        ftk.must_exec("create table src1 (a int, b varchar(8), "
                      "d decimal(8,2))")
        ftk.must_exec("insert into src1 values (1,'x',1.50),(2,'y',2.25)")
        ftk.must_exec("create table dst1 as select a, upper(b) ub, d * 2 dd "
                      "from src1 where a >= 1")
        ftk.must_query("select * from dst1 order by a").check([
            (1, "X", "3.00"), (2, "Y", "4.50")])
        ftk.must_exec("insert into dst1 values (9, 'z', 0.01)")

    def test_create_table_like(self, ftk):
        ftk.must_exec("create table src2 (id int primary key "
                      "auto_increment, v varchar(5), key iv (v))")
        ftk.must_exec("create table dst2 like src2")
        ftk.must_exec("insert into dst2 (v) values ('a'), ('b')")
        ftk.must_query("select id, v from dst2 order by id").check([
            (1, "a"), (2, "b")])
        r = ftk.must_query("show create table dst2")
        r.check_contain("KEY `iv`")


class TestGeneratedAndGrants:
    def test_generated_column(self, ftk):
        ftk.must_exec("create table gen1 (a int, b int, "
                      "c int as (a + b) stored)")
        ftk.must_exec("insert into gen1 (a, b) values (1, 2), (10, 20)")
        ftk.must_query("select c from gen1 order by c").check([(3,), (30,)])
        ftk.must_exec("update gen1 set b = 100 where a = 1")
        ftk.must_query("select c from gen1 where a = 1").check([(101,)])

    def test_show_grants(self, ftk):
        ftk.must_exec("create user gu")
        ftk.must_exec("grant select, insert on test.* to gu")
        r = ftk.must_query("show grants for gu")
        assert any("INSERT, SELECT" in row[0] and "test.*" in row[0]
                   for row in r.rows), r.rows
        r2 = ftk.must_query("show grants")
        assert any("ALL PRIVILEGES" in row[0] for row in r2.rows)


class TestEnumAndGuards:
    def test_enum(self, ftk):
        ftk.must_exec("create table en (c enum('red','green','blue'))")
        ftk.must_exec("insert into en values ('red'), ('blue')")
        e = ftk.exec_err("insert into en values ('purple')")
        assert isinstance(e, errors.TruncatedWrongValueError)
        ftk.must_query("select c from en order by c").check(
            [("blue",), ("red",)])

    def test_insert_select_width(self, ftk):
        ftk.must_exec("create table iw1 (a int, b int)")
        ftk.must_exec("create table iw2 (x int)")
        ftk.must_exec("insert into iw2 values (1)")
        e = ftk.exec_err("insert into iw1 select x from iw2")
        assert isinstance(e, errors.WrongValueCountError)

    def test_readonly_targets(self, ftk):
        e = ftk.exec_err("delete from information_schema.tables")
        ftk.must_exec("create view rov as select 1 as x")
        e = ftk.exec_err("update rov set x = 2")


class TestMiscStatements:
    def test_do_flush_alter_user(self, ftk):
        ftk.must_exec("do 1 + 1, sleep_not_called(0) + 0"
                      if False else "do 1 + 1")
        ftk.must_exec("flush privileges")
        ftk.must_exec("create user au identified by 'old'")
        ftk.must_exec("alter user au identified by 'new'")
        assert ftk.domain.priv.auth("au", "%", "new")
        assert not ftk.domain.priv.auth("au", "%", "old")

    def test_into_outfile(self, ftk, tmp_path):
        ftk.must_exec("create table of1 (a int, s varchar(5))")
        ftk.must_exec("insert into of1 values (1,'x'),(2,null)")
        p = str(tmp_path / "out.tsv")
        r = ftk.must_exec(f"select * from of1 order by a into outfile '{p}'")
        assert r.affected == 2
        content = open(p).read()
        assert "1\tx" in content and "\\N" in content

    def test_processlist_table(self, ftk):
        r = ftk.must_query("select id, command from "
                           "information_schema.processlist")
        assert any(int(row[0]) == ftk.sess.conn_id for row in r.rows)


class TestCompatStatements:
    def test_show_variants(self, ftk):
        assert ftk.must_query("show engines").rows
        assert ftk.must_query("show charset").rows
        assert ftk.must_query("show collation").rows
        ftk.must_query("show errors").check([])
        ftk.must_query("show profiles").check([])
        assert any(r[0] == "Uptime"
                   for r in ftk.must_query("show status").rows)
        ftk.must_query("show create database test").check_contain(
            "CREATE DATABASE")
        ftk.must_query("select @@version_comment").check_contain("tidb-tpu")

    def test_table_values_checksum(self, ftk):
        ftk.must_exec("create table cvt (id int primary key, v int)")
        ftk.must_exec("insert into cvt values (1,10),(2,20)")
        ftk.must_query("table cvt").check([(1, 10), (2, 20)])
        ftk.must_query("values row(7, 8)").check([(7, 8)])
        ftk.must_query("select * from (values row(1,2), row(3,4)) v "
                       "order by column_0 desc").check([(3, 4), (1, 2)])
        r = ftk.must_query("checksum table cvt").rows
        assert r[0][0] == "test.cvt" and int(r[0][1]) != 0
        assert ftk.must_query("show table cvt regions").rows
        ftk.must_query("help 'select'").check([])


class TestDistinctAggSpill:
    def test_spill_matches_in_memory(self, ftk):
        ftk.must_exec("create table dsp (g int, v int, pad varchar(32))")
        ftk.must_exec("insert into dsp values " + ",".join(
            f"({i % 7},{i % 23},'pad{i % 5}')" for i in range(20000)))
        q = ("select g, count(distinct v), sum(distinct v), avg(distinct v)"
             " from dsp group by g order by g")
        expected = ftk.must_query(q).rows
        ftk.must_exec("set tidb_mem_quota_query = 262144")
        got = ftk.must_query(q).rows
        assert got == expected
        assert ftk.domain.metrics.get("agg_spill_count", 0) >= 1
        ftk.must_exec("set tidb_mem_quota_query = 1073741824")


class TestPlanReplayer:
    def test_dump(self, ftk):
        import json
        import zipfile
        ftk.must_exec("create table prz (a int, b int, key ia (a))")
        ftk.must_exec("insert into prz values (1,2),(3,4)")
        ftk.must_exec("analyze table prz")
        r = ftk.must_query(
            "plan replayer dump explain select * from prz where a = 1")
        path = r.rows[0][0]
        z = zipfile.ZipFile(path)
        names = set(z.namelist())
        assert {"sql/sql.sql", "explain.txt", "schema/schema.sql",
                "stats/stats.json", "variables.json"} <= names
        assert "prz" in z.read("explain.txt").decode()
        assert "CREATE TABLE `prz`" in z.read("schema/schema.sql").decode()
        assert json.loads(z.read("stats/stats.json"))[
            "test.prz"]["row_count"] == 2


class TestStatementAtomicity:
    def test_failed_dml_statement_rolls_back_wholly(self, ftk):
        """A DML statement that fails mid-way inside an explicit txn
        (CHECK violation on a later row) must not leave its earlier
        rows buffered for COMMIT to persist — implicit statement
        savepoint."""
        ftk.must_exec("create table sa (a int primary key, b int, "
                      "check (b < 100))")
        ftk.must_exec("insert into sa values (1, 1), (2, 95)")
        ftk.must_exec("begin")
        e = ftk.exec_err("update sa set b = b + 10")  # row 2 -> 105
        assert e.code == 3819
        ftk.must_exec("commit")
        ftk.must_query("select a, b from sa order by a").check(
            [(1, 1), (2, 95)])
        # the txn itself stays usable after the statement rollback
        ftk.must_exec("begin")
        ftk.must_exec("update sa set b = b + 1 where a = 1")
        ftk.must_exec("commit")
        ftk.must_query("select b from sa where a = 1").check([(2,)])

    def test_pessimistic_lock_conflict_fails_statement_not_commit(
            self, ftk):
        """A pessimistic txn whose target committed past its snapshot
        gets the write conflict AT THE STATEMENT (restartable), not a
        guaranteed-doomed lock that only explodes at COMMIT."""
        import tidb_tpu_torch.errors as errors
        ftk.must_exec("create table pc (a int primary key, b int)")
        ftk.must_exec("insert into pc values (1, 0)")
        tk2 = ftk.new_session()
        ftk.must_exec("begin")
        ftk.must_query("select 1")            # pin the snapshot
        tk2.must_exec("update pc set b = 7 where a = 1")
        e = ftk.exec_err("update pc set b = 8 where a = 1")
        assert isinstance(e, errors.WriteConflictError)
        ftk.must_exec("commit")               # nothing buffered: clean
        ftk.must_query("select b from pc").check([(7,)])
