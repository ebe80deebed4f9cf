"""MySQL-behavior differential suite (VERDICT r2 weak item 7: builtin
coverage was name-level only). Every case pins DOCUMENTED MySQL
semantics — per-type edges like truncation direction, numeric-prefix
string coercion, PAD SPACE comparisons, NULL propagation, month-end
date clamping — against the engine (reference
pkg/expression/builtin_*_test.go plays this role with ~600 typed
signatures; here one table drives both backends through SQL).

The twin of tests/test_mysql_conformance.py on tidb_tpu_torch, with device="cpu" at
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


@pytest.fixture(scope="module")
def tk():
    return TestKit(device="cpu")


CASES = [
    # ---- integer / div / mod (truncation toward zero; div-by-0 NULL)
    ("select 7 div 2, -7 div 2, 7 % 3, -7 % 3, 7 % -3",
     (3, -3, 1, -1, 1)),
    ("select 1/0, 1 % 0", (None, None)),
    ("select 5 / 2", "2.5000"),
    # ---- string -> number: numeric-prefix parse, never an error
    ("select '3abc' + 1, 'abc' + 1, '  8  ' + 0", (4.0, 1.0, 8.0)),
    ("select '1e2' + 0, '-2.5' + 0", (100.0, -2.5)),
    ("select cast('123.6' as signed), cast('-2.5' as signed),"
     " cast('3.7' as signed)", (124, -3, 4)),
    ("select cast(-1 as unsigned)", 18446744073709551615),
    # ---- NULL propagation
    ("select concat('a', null), concat_ws(',', 'a', null, 'b')",
     (None, "a,b")),
    ("select least(1, null, 2), greatest(1, null)", (None, None)),
    ("select nullif(3, 3), ifnull(null, 9), coalesce(null, null, 7)",
     (None, 9, 7)),
    # ---- PAD SPACE: trailing spaces ignored except binary
    ("select 'a' = 'a   ', 'a' = ' a', 'a' < 'a '", (1, 0, 0)),
    ("select cast('a' as binary) = cast('a ' as binary)", 0),
    # ---- rounding / truncation
    ("select round(2.5), round(-2.5), round(2.45, 1)",
     ("3", "-3", "2.5")),
    ("select truncate(-1.999, 1), truncate(199, -2)", ("-1.9", 100)),
    ("select floor(-1.5), ceil(-1.5)", (-2, -1)),
    # ---- strings
    ("select substring('hello', -3), substring('hello', 2, 2)",
     ("llo", "el")),
    ("select substring_index('a.b.c', '.', -2)", "b.c"),
    ("select lpad('abc', 2, 'x'), lpad('ab', 5, 'xy')",
     ("ab", "xyxab")),
    ("select repeat('ab', 0), space(3)", ("", "   ")),
    ("select instr('foobar', 'bar'), locate('o', 'foobar', 4)",
     (4, 0)),
    ("select field('b', 'a', 'b', 'c'), elt(2, 'x', 'y')", (2, "y")),
    ("select find_in_set('b', 'a,b,c'), find_in_set('d', 'a,b,c')",
     (2, 0)),
    ("select conv('ff', 16, 10), conv(255, 10, 16), hex(255), bin(5)",
     ("255", "FF", "FF", "101")),
    ("select reverse('abc'), left('hello', 2), right('hello', 2)",
     ("cba", "he", "lo")),
    ("select length('héllo'), char_length('héllo')", (6, 5)),
    ("select ascii('A'), char(65, 66)", (65, "AB")),
    ("select strcmp('a', 'b'), strcmp('b', 'a'), strcmp('a', 'a')",
     (-1, 1, 0)),
    ("select insert('Quadratic', 3, 4, 'What')", "QuWhattic"),
    ("select export_set(5, 'Y', 'N', ',', 4)", "Y,N,Y,N"),
    ("select soundex('Robert')", "R163"),
    ("select format(12332.1234, 2)", "12,332.12"),
    ("select 'abc' like 'a%', 'abc' like 'a_c', 'a%c' like 'a\\%c'",
     (1, 1, 1)),
    # ---- dates: month-end clamping, DATE vs DATETIME result types
    ("select datediff('2024-03-01', '2024-02-27')", 3),
    ("select date_add('2024-01-31', interval 1 month)", "2024-02-29"),
    ("select last_day('2024-02-15')", "2024-02-29"),
    ("select dayofweek('2024-07-01'), weekday('2024-07-01')", (2, 0)),
    ("select extract(year from '2024-07-30'), "
     "extract(month from '2024-07-30')", (2024, 7)),
    ("select date_format('2024-07-30 14:05:09', '%Y/%m/%d %H:%i:%s')",
     "2024/07/30 14:05:09"),
    ("select timestampdiff(day, '2024-01-01', '2024-02-01')", 31),
    ("select str_to_date('30/07/2024', '%d/%m/%Y')", "2024-07-30"),
    ("select str_to_date('30/07/2024 14:30', '%d/%m/%Y %H:%i')",
     "2024-07-30 14:30:00"),
    # ---- bit ops (unsigned 64-bit domain)
    ("select 5 & 3, 5 | 3, 5 ^ 3, 1 << 4, 16 >> 2, ~0",
     (1, 7, 6, 16, 4, 18446744073709551615)),
    # ---- json
    ("select json_extract('{\"a\": [1, 2]}', '$.a[1]')", "2"),
    ("select json_unquote(json_extract('{\"a\": \"x\"}', '$.a'))",
     "x"),
    # ---- control flow / misc
    ("select if(0, 'a', 'b'), case when null then 1 else 2 end",
     ("b", 2)),
    ("select abs(-3.5), sign(-2), power(2, 10), mod(10, 3)",
     ("3.5", -1, 1024.0, 1)),
    # ---- JSON (second sweep)
    ("select json_type('[1,2]'), json_type('{\"a\":1}'), "
     "json_type('3')", ("ARRAY", "OBJECT", "INTEGER")),
    ("select json_length('[1,2,3]'), json_valid('nope')", (3, 0)),
    ("select json_array(1, 'a', null), json_object('k', null)",
     ('[1, "a", null]', '{"k": null}')),
    ("select json_set('{\"a\":1}', '$.b', 2), "
     "json_remove('{\"a\":1,\"b\":2}', '$.a')",
     ('{"a": 1, "b": 2}', '{"b": 2}')),
    ("select json_merge_patch('{\"a\":1}', '{\"a\":null,\"b\":2}')",
     '{"b": 2}'),
    ("select '{\"a\": 5}' -> '$.a', '{\"a\": \"x\"}' ->> '$.a'",
     ("5", "x")),
    # ---- temporal (second sweep)
    ("select dayofyear('2024-12-31'), quarter('2024-07-30')",
     (366, 3)),
    ("select time_to_sec('01:30:30'), sec_to_time(5430)",
     (5430, "01:30:30")),
    ("select addtime('2024-01-01 10:00:00', '01:30:00')",
     "2024-01-01 11:30:00"),
    ("select period_add(202401, 2), period_diff(202403, 202401)",
     (202403, 2)),
    ("select to_days('2024-01-01'), from_days(739251)",
     (739251, "2024-01-01")),
    ("select makedate(2024, 60), maketime(10, 30, 5)",
     ("2024-02-29", "10:30:05")),
    ("select convert_tz('2024-01-01 12:00:00', '+00:00', '+05:30')",
     "2024-01-01 17:30:00"),
    # ---- numeric (second sweep)
    ("select round(1234.5678, -2), format(1234567.891, 0)",
     ("1200", "1,234,568")),
    ("select ln(exp(2)), log2(8), log10(1000)", (2.0, 3.0, 3.0)),
    ("select degrees(pi()), crc32('MySQL')", (180.0, 3259397556)),
    ("select oct(12), unhex('4D7953514C')", ("14", "MySQL")),
    # ---- string (second sweep)
    ("select quote(null), quote('ab''c')", ("NULL", "'ab\\'c'")),
    ("select concat(1, 2.5, 'x')", "12.5x"),
    ("select trim(both 'x' from 'xxaxx'), "
     "trim(leading 'x' from 'xxa')", ("a", "a")),
    ("select replace('www.mysql.com', 'w', 'W')", "WWW.mysql.com"),
    ("select substring_index('a.b.c', '.', 0), "
     "substring_index('abc', 'z', 2)", ("", "abc")),
    ("select bit_length('abc'), octet_length('abc')", (24, 3)),
    ("select position('b' in 'abc'), left('abc', -1)", (2, "")),
    ("select make_set(5, 'a', 'b', 'c')", "a,c"),
    # ---- aggregates (second sweep)
    ("select bit_and(v), bit_or(v), bit_xor(v) from "
     "(select 12 v union all select 10) t", (8, 14, 6)),
    ("select group_concat(v order by v desc separator '|') from "
     "(select 1 v union all select 3 union all select 2) t", "3|2|1"),
    ("select std(v), variance(v) from "
     "(select 2 v union all select 4) t", (1.0, 1.0)),
    ("select json_arrayagg(v) from "
     "(select 1 v union all select 2) t", "[1, 2]"),
]


def test_concat_renders_typed_values(tk):
    """CONCAT over numeric/temporal COLUMNS renders MySQL string
    forms — decimal scale and date text, never raw storage ints
    (review probe: scaled ints leaked)."""
    tk.must_exec("create table conf_c (d decimal(5,2), dt date)")
    tk.must_exec("insert into conf_c values (3.50, '2024-05-01')")
    tk.must_query("select concat('v=', d), concat('on ', dt) "
                  "from conf_c").check(
        [("v=3.50", "on 2024-05-01")])


def test_typed_rendering_in_string_and_json_contexts(tk):
    """Review regressions: unsigned renders full-domain in CONCAT;
    decimals/dates reach QUOTE/JSON/CONCAT_WS as values, never raw
    storage ints; JSON operators accept numeric operands."""
    tk.must_exec("create table conf_tr (b bigint unsigned, "
                 "d decimal(5,2), dt date)")
    tk.must_exec("insert into conf_tr values "
                 "(18446744073709551615, 1.25, '2024-05-01')")
    tk.must_query("select concat('x', b) from conf_tr").check(
        [("x18446744073709551615",)])
    tk.must_query("select json_array(d), quote(d), "
                  "concat_ws(',', d, dt) from conf_tr").check(
        [("[1.25]", "'1.25'", "1.25,2024-05-01")])
    tk.must_query("select json_object('k', d) from conf_tr").check(
        [('{"k": 1.25}',)])
    tk.must_query("select (-1) -> '$'").check([("-1",)])


def test_json_arrow_on_columns(tk):
    tk.must_exec("create table conf_j (doc varchar(64))")
    tk.must_exec('insert into conf_j values '
                 '(\'{"a": {"b": 7}}\')')
    tk.must_query("select doc -> '$.a.b', doc ->> '$.a.b' "
                  "from conf_j").check([("7", "7")])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_mysql_semantics(tk, i):
    sql, want = CASES[i]
    if not isinstance(want, tuple):
        want = (want,)
    got = tk.must_query(sql).rs.rows[0]
    assert tuple(str(g) for g in got) == tuple(str(w) for w in want), \
        f"{sql}\n got={got}\n want={want}"


def test_string_column_arithmetic(tk):
    """Dict-encoded string COLUMNS in numeric context parse values,
    never codes (review-probe regression: s + 1 returned code + 1)."""
    tk.must_exec("create table conf_s (s varchar(10), g int)")
    tk.must_exec("insert into conf_s values ('12',1),('3abc',1),"
                 "('x',2),(null,2)")
    r = tk.must_query("select s + 1, s * 2 from conf_s "
                      "order by g, s is null, s").rs.rows
    assert r == [(13.0, 24.0), (4.0, 6.0), (1.0, 0.0), (None, None)]
    tk.must_query("select sum(s), avg(s) from conf_s").check(
        [(15.0, 5.0)])
    tk.must_query("select g, sum(s) from conf_s group by g "
                  "order by g").check([(1, 15.0), (2, 0.0)])


def test_review_probe_regressions(tk):
    """Second review pass: float casts must not truncate through the
    dict-table path; CONV handles float/decimal args; LOCATE pos < 1
    is 0; PAD SPACE applies to object-array operands too."""
    tk.must_exec("create table conf_r (s varchar(10), d decimal(5,2), "
                 "dt datetime)")
    tk.must_exec("insert into conf_r values "
                 "('1.5', 25.50, '2024-03-05 10:00:00')")
    tk.must_query("select sum(s), cast(s as double) from conf_r "
                  "group by s").check([(1.5, 1.5)])
    tk.must_query("select conv(25.5, 10, 16), conv(d, 10, 16) "
                  "from conf_r").check([("19", "19")])
    tk.must_query("select locate('b','abc',0), locate('b','abc',-1)")\
        .check([(0, 0)])
    tk.must_query("select date_format(dt,'%Y-%m') = '2024-03 ' "
                  "from conf_r").check([(1,)])
    tk.must_query("select s > 1 from conf_r").check([(1,)])


def test_correlated_not_in_three_valued(tk):
    """Correlated NOT IN evaluates MySQL's 3-valued semantics PER
    correlation group (roadmap item closed): empty group keeps every
    probe (even NULL x); a NULL y in the group nulls out non-matching
    rows; NULL x with a non-empty group is excluded."""
    tk.must_exec("create table cni_t (k int, x int)")
    tk.must_exec("create table cni_s (k int, y int)")
    tk.must_exec("insert into cni_t values (1,10),(1,99),(1,null),"
                 "(2,20),(2,99),(2,null),(3,7),(3,null)")
    tk.must_exec("insert into cni_s values (1,10),(1,null),(2,20),"
                 "(null,99)")
    tk.must_query(
        "select k, x from cni_t where x not in "
        "(select y from cni_s where cni_s.k = cni_t.k) "
        "order by k, x is null, x").check(
        [(2, 99), (3, 7), (3, "<nil>")])
    tk.must_exec("delete from cni_s")
    tk.must_query(
        "select count(*) from cni_t where x not in "
        "(select y from cni_s where cni_s.k = cni_t.k)").check([(8,)])


def test_aes_block_encryption_modes(tk):
    """block_encryption_mode drives AES_ENCRYPT/AES_DECRYPT
    (reference builtin_encryption.go): ECB/CBC padded, OFB/CFB128
    stream; IV-required modes return NULL without one. Without the
    cryptography provider the builtins degrade to NULL (gated, not
    asserted wrong)."""
    pytest.importorskip("cryptography")
    tk.must_query(
        "select aes_decrypt(aes_encrypt('secret', 'k1'), 'k1')")\
        .check([("secret",)])
    tk.must_exec("set @@block_encryption_mode = 'aes-256-cbc'")
    try:
        tk.must_query(
            "select aes_decrypt(aes_encrypt('hello', 'key', "
            "'0123456789abcdef'), 'key', '0123456789abcdef')")\
            .check([("hello",)])
        tk.must_query("select aes_encrypt('x', 'k')").check(
            [("<nil>",)])     # IV required
        tk.must_exec("set @@block_encryption_mode = 'aes-128-ofb'")
        tk.must_query(
            "select aes_decrypt(aes_encrypt('stream', 'k', "
            "'aaaaaaaaaaaaaaaa'), 'k', 'aaaaaaaaaaaaaaaa')")\
            .check([("stream",)])
        tk.must_exec("set @@block_encryption_mode = 'aes-256-cfb128'")
        tk.must_query(
            "select aes_decrypt(aes_encrypt('feedback', 'k', "
            "'bbbbbbbbbbbbbbbb'), 'k', 'bbbbbbbbbbbbbbbb')")\
            .check([("feedback",)])
        # wrong key under a padded mode: NULL, never garbage
        tk.must_exec("set @@block_encryption_mode = 'aes-128-ecb'")
        tk.must_query(
            "select aes_decrypt(aes_encrypt('secret', 'right'), "
            "'wrong')").check([("<nil>",)])
    finally:
        tk.must_exec("set @@block_encryption_mode = 'aes-128-ecb'")


def test_pad_space_on_columns(tk):
    tk.must_exec("create table conf_p (s varchar(8))")
    tk.must_exec("insert into conf_p values ('x'), ('x  '), ('y')")
    tk.must_query("select count(*) from conf_p where s = 'x'").check(
        [(2,)])
    tk.must_query("select count(*) from conf_p where s = 'x '").check(
        [(2,)])


def test_compound_interval_units(tk):
    """'D H:M:S'-style compound INTERVAL literals (MySQL 8.0 manual
    "Temporal Intervals"; reference parser.y TimeUnit): fields
    right-align to the unit list, a microsecond field left-justifies
    to 6 digits, and sub-day intervals keep a string literal's time of
    day."""
    cases = [
        ("select date_add('2024-01-01', interval '1:30' minute_second)",
         "2024-01-01 00:01:30"),
        ("select date_add('2024-01-01 10:00:00', "
         "interval '2:15' hour_minute)", "2024-01-01 12:15:00"),
        ("select date_add('2024-01-01', interval '1 6' day_hour)",
         "2024-01-02 06:00:00"),
        ("select date_add('2024-01-01', interval '1-6' year_month)",
         "2025-07-01"),
        ("select date_add('2024-01-31', interval '0-1' year_month)",
         "2024-02-29"),                       # day-of-month clamp
        ("select date_sub('2024-01-01 00:02:00', "
         "interval '1:30' minute_second)", "2024-01-01 00:00:30"),
        # MySQL quirk: the fraction left-justifies ('1.5' = 1s 500000us)
        ("select date_add('2024-01-01', "
         "interval '1.5' second_microsecond)",
         "2024-01-01 00:00:01.500000"),
        ("select date_add('2024-01-01', "
         "interval '-1 2:00:00' day_second)", "2023-12-30 22:00:00"),
    ]
    for sql, want in cases:
        got = tk.must_query(sql).rows[0][0]
        assert str(got) == want, (sql, got, want)


def test_compound_interval_window_frame(tk):
    tk.must_exec("drop table if exists wfci")
    tk.must_exec("create table wfci (ts datetime, v int)")
    tk.must_exec("insert into wfci values "
                 "('2024-01-01 00:00:00', 1), ('2024-01-01 00:01:00', 2),"
                 "('2024-01-01 00:02:30', 3), ('2024-01-01 00:10:00', 4)")
    rows = tk.must_query(
        "select v, sum(v) over (order by ts range between "
        "interval '1:30' minute_second preceding and current row) "
        "from wfci order by ts").rows
    # 90s window: row3 (00:02:30) covers 00:01:00.. -> 2+3
    assert [(r[0], str(r[1])) for r in rows] == \
        [(1, "1"), (2, "3"), (3, "5"), (4, "4")], rows


def test_memory_quota_error_code_and_message(tk):
    """ER 8175 surface: the memory-governance
    cancel class — code 8175 / SQLSTATE HY000 with the reference's
    'Out Of Memory Quota!' message prefix — pinned on the catalog
    (information_schema.tidb_errors) AND a LIVE raised error."""
    rows = tk.must_query(
        "select error, code, sqlstate from "
        "information_schema.tidb_errors where code = 8175").rows
    assert rows == [("MemoryQuotaExceededError", 8175, "HY000")], rows
    from tidb_tpu_torch.errors import MemoryQuotaExceededError
    assert (MemoryQuotaExceededError.code,
            MemoryQuotaExceededError.sqlstate) == (8175, "HY000")
    tk.must_exec("drop table if exists mqc")
    tk.must_exec("create table mqc (a bigint, b bigint)")
    rows = ",".join(f"({i}, {i * 7})" for i in range(40000))
    tk.must_exec(f"insert into mqc values {rows}")
    # ungrouped DISTINCT agg: no spill path, so a breach must run the
    # chain to its cancel step (tidb_tpu_oom_action default)
    tk.must_exec("set @@tidb_mem_quota_query = 131072")
    e = tk.exec_err("select count(distinct a), count(distinct b) "
                    "from mqc")
    assert e.code == 8175 and e.sqlstate == "HY000", e
    assert "Out Of Memory Quota!" in e.msg, e.msg
    # the failed statement's diagnostics area carries the same pair
    warn = tk.must_query("show warnings").rows[0]
    assert int(warn[1]) == 8175
    tk.must_exec("set @@tidb_mem_quota_query = 1073741824")


def test_lock_error_codes_and_sqlstates(tk):
    """MySQL-compatible lock failure surface:
    deadlock victim -> ER 1213 / SQLSTATE 40001, lock-wait deadline ->
    ER 1205 / HY000 — asserted on LIVE raised errors and the catalog
    (information_schema.tidb_errors)."""
    rows = dict((code, state) for _n, code, state in tk.must_query(
        "select error, code, sqlstate from information_schema.tidb_errors"
        " where code in (1205, 1213, 3572)").rows)
    assert rows == {1205: "HY000", 1213: "40001", 3572: "HY000"}
    tk.must_exec("drop table if exists lkc")
    tk.must_exec("create table lkc (a int primary key, b int)")
    tk.must_exec("insert into lkc values (1, 10)")
    s2 = tk.new_session()
    tk.must_exec("begin")
    tk.must_query("select * from lkc where a = 1 for update")
    s2.must_exec("begin")
    # live ER 3572 (ER_LOCK_NOWAIT): NOWAIT fails fast with its own
    # code, distinct from a genuine wait-deadline 1205
    e = s2.exec_err("select * from lkc where a = 1 for update nowait")
    assert e.code == 3572 and e.sqlstate == "HY000"
    # the failed statement's diagnostics area carries the same pair
    warn = s2.must_query("show warnings").rows[0]
    assert int(warn[1]) == 3572
    # live ER 1205: the same conflict through the wait queue times out
    s2.must_exec("set @@tidb_tpu_lock_wait_timeout_ms = 100")
    e = s2.exec_err("select * from lkc where a = 1 for update")
    assert e.code == 1205 and e.sqlstate == "HY000"
    s2.must_exec("rollback")
    tk.must_exec("rollback")
    # live ER 1213 is exercised end-to-end in tests/test_deadlock.py;
    # here pin the class contract the wire protocol serializes
    from tidb_tpu_torch.errors import DeadlockError
    assert (DeadlockError.code, DeadlockError.sqlstate) == (1213, "40001")


def test_vector_error_codes_and_sqlstates(tk):
    """Vector ER surface: malformed vector text ->
    ER 6138 (the MySQL 9 ER_TO_VECTOR_CONVERSION family), dimension
    clash -> ER 6139, VECTOR in a numeric context -> ER 1235 — pinned
    on the catalog (information_schema.tidb_errors) AND live raised
    errors. A device shape error must never escape to the client."""
    rows = dict((code, (name, state)) for name, code, state in
                tk.must_query(
        "select error, code, sqlstate from "
        "information_schema.tidb_errors "
        "where code in (6138, 6139)").rows)
    assert rows == {6138: ("VectorConversionError", "22000"),
                    6139: ("VectorDimensionError", "22000")}, rows
    from tidb_tpu_torch.errors import (VectorConversionError,
                                 VectorDimensionError)
    assert (VectorConversionError.code,
            VectorConversionError.sqlstate) == (6138, "22000")
    assert (VectorDimensionError.code,
            VectorDimensionError.sqlstate) == (6139, "22000")
    tk.must_exec("drop table if exists vconf")
    tk.must_exec("create table vconf (id bigint primary key, "
                 "e vector(3))")
    tk.must_exec("insert into vconf values (1, '[1,2,3]')")
    # live: insert wrong-k vector
    e = tk.exec_err("insert into vconf values (2, '[1,2]')")
    assert (e.code, e.sqlstate) == (6139, "22000")
    warn = tk.must_query("show warnings").rows[0]
    assert int(warn[1]) == 6139
    # live: malformed literal
    e = tk.exec_err("insert into vconf values (2, '{not a vector}')")
    assert (e.code, e.sqlstate) == (6138, "22000")
    # live: distance between mismatched dims (column + literal forms)
    e = tk.exec_err("select vec_l2_distance(e, '[1,2]') from vconf")
    assert (e.code, e.sqlstate) == (6139, "22000")
    e = tk.exec_err("select vec_cosine_distance('[1,2]', '[1,2,3]')")
    assert (e.code, e.sqlstate) == (6139, "22000")
    # live: VECTOR in invalid contexts fails cleanly (planner-time
    # 1235, not a runtime shape error)
    for sql in ("select e * 2 from vconf",
                "select sum(e) from vconf",
                "select e - e from vconf"):
        e = tk.exec_err(sql)
        assert e.code == 1235, sql


def test_backup_error_codes_and_sqlstates(tk, tmp_path):
    """BR ER surface: finished-target reuse ->
    ER 8160, corrupt chunk -> ER 8161, non-empty restore target ->
    ER 8162, UNTIL TS below the snapshot -> ER 8163 — pinned on the
    catalog (information_schema.tidb_errors) AND live raised errors."""
    import glob
    import os
    rows = dict((code, (name, state)) for name, code, state in
                tk.must_query(
        "select error, code, sqlstate from "
        "information_schema.tidb_errors "
        "where code between 8160 and 8163").rows)
    assert rows == {
        8160: ("BackupTargetExistsError", "HY000"),
        8161: ("BackupChecksumMismatchError", "HY000"),
        8162: ("RestoreTargetNotEmptyError", "HY000"),
        8163: ("RestoreTsBelowBackupError", "HY000")}, rows
    from tidb_tpu_torch.errors import (BackupChecksumMismatchError,
                                 BackupTargetExistsError,
                                 RestoreTargetNotEmptyError,
                                 RestoreTsBelowBackupError)
    assert (BackupTargetExistsError.code,
            BackupChecksumMismatchError.code,
            RestoreTargetNotEmptyError.code,
            RestoreTsBelowBackupError.code) == (8160, 8161, 8162, 8163)
    src = TestKit(device="cpu")
    src.must_exec("create table bre (id int primary key)")
    src.must_exec("insert into bre values (1)")
    d = str(tmp_path / "bk")
    src.must_exec(f"backup database test to '{d}'")
    # live ER 8160: reusing the finished target for another db set
    src.must_exec("create database bro")
    src.must_exec("use bro")
    src.must_exec("create table brx (id int primary key)")
    e = src.exec_err(f"backup database bro to '{d}'")
    assert (e.code, e.sqlstate) == (8160, "HY000")
    # live ER 8163: PITR target below the snapshot consistency point
    fresh = TestKit(device="cpu")
    e = fresh.exec_err(f"restore database test from '{d}' until ts 1")
    assert (e.code, e.sqlstate) == (8163, "HY000")
    # live ER 8162: the target already holds a clashing table
    fresh.must_exec("create table bre (id int primary key)")
    e = fresh.exec_err(f"restore database test from '{d}'")
    assert (e.code, e.sqlstate) == (8162, "HY000")
    # live ER 8161: one flipped byte in a chunk
    chunk = glob.glob(os.path.join(d, "*.chunk000.npz"))[0]
    raw = open(chunk, "rb").read()
    with open(chunk, "wb") as f:
        f.write(raw[:50] + bytes([raw[50] ^ 0xFF]) + raw[51:])
    clean = TestKit(device="cpu")
    e = clean.exec_err(f"restore database test from '{d}'")
    assert (e.code, e.sqlstate) == (8161, "HY000")
