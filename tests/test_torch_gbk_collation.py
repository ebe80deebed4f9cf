"""gbk_chinese_ci / gb18030_chinese_ci collations (reference
pkg/util/collate/gbk_chinese_ci.go, gb18030_chinese_ci.go): ASCII
case-insensitive via uppercase, Chinese characters ordered by their
GBK/GB18030 code, PAD SPACE. Goldens verified against the GBK code
table: 啊=0xB0A1 < 文=0xCEC4 < 中=0xD6D0 (MySQL sorts 啊 first — it is
the first character of the GBK Chinese block).

The twin of tests/test_gbk_collation.py on tidb_tpu_torch, with device="cpu" at
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


def test_gbk_order_by(tk):
    tk.must_exec("create table g (a varchar(16) charset gbk "
                 "collate gbk_chinese_ci, k int primary key)")
    tk.must_exec("insert into g values ('中', 1), ('文', 2), ('啊', 3), "
                 "('b', 4), ('A', 5)")
    got = [r[0] for r in tk.must_query(
        "select a from g order by a, k").rs.rows]
    # ASCII by uppercase first, then Chinese by GBK code
    assert got == ["A", "b", "啊", "文", "中"], got


def test_gbk_group_by_case_and_pad(tk):
    tk.must_exec("create table g2 (a varchar(16) collate gbk_chinese_ci, "
                 "k int primary key)")
    tk.must_exec("insert into g2 values ('ab', 1), ('AB', 2), "
                 "('ab  ', 3), ('中', 4)")
    rows = tk.must_query(
        "select count(*) from g2 group by a order by count(*) desc"
    ).rs.rows
    assert [int(r[0]) for r in rows] == [3, 1]


def test_gbk_equality_ci(tk):
    tk.must_exec("create table g3 (a varchar(16) collate gbk_chinese_ci, "
                 "k int primary key)")
    tk.must_exec("insert into g3 values ('Hello', 1), ('中文', 2)")
    assert int(tk.must_query(
        "select count(*) from g3 where a = 'HELLO'").rs.rows[0][0]) == 1
    assert int(tk.must_query(
        "select count(*) from g3 where a = '中文'").rs.rows[0][0]) == 1


def test_table_level_charset_gbk_defaults_collation(tk):
    tk.must_exec("create table g4 (a varchar(16), k int primary key) "
                 "charset gbk")
    info = tk.domain.infoschema().table_by_name("test", "g4")
    col = next(c for c in info.columns if c.name == "a")
    assert col.ft.collate == "gbk_chinese_ci"
    tk.must_exec("insert into g4 values ('中', 1), ('啊', 2)")
    got = [r[0] for r in tk.must_query(
        "select a from g4 order by a").rs.rows]
    assert got == ["啊", "中"]


def test_column_charset_gbk_defaults_collation(tk):
    tk.must_exec("create table g5 (a varchar(16) charset gbk, "
                 "k int primary key)")
    info = tk.domain.infoschema().table_by_name("test", "g5")
    col = next(c for c in info.columns if c.name == "a")
    assert col.ft.collate == "gbk_chinese_ci"


def test_gb18030_chars_beyond_gbk(tk):
    """gb18030 covers all of Unicode via 4-byte forms; order follows
    the gb18030 code (ꬰ=0x8237BA37 < 𝄞=0x9432BE34 < 啊=0xB0A1)."""
    tk.must_exec("create table g6 (a varchar(16) charset gb18030, "
                 "k int primary key)")
    info = tk.domain.infoschema().table_by_name("test", "g6")
    col = next(c for c in info.columns if c.name == "a")
    assert col.ft.collate == "gb18030_chinese_ci"
    tk.must_exec("insert into g6 values ('啊', 1), ('\U0001d11e', 2), "
                 "('ꬰ', 3)")
    got = [r[0] for r in tk.must_query(
        "select a from g6 order by a").rs.rows]
    assert got == ["ꬰ", "\U0001d11e", "啊"], got


def test_gbk_join_across_collations_same_dict(tk):
    tk.must_exec("create table j1 (a varchar(16) collate gbk_chinese_ci, "
                 "k int primary key)")
    tk.must_exec("create table j2 (a varchar(16) collate gbk_chinese_ci, "
                 "k int primary key)")
    tk.must_exec("insert into j1 values ('中文', 1), ('Abc', 2)")
    tk.must_exec("insert into j2 values ('中文', 10), ('aBC', 20)")
    rows = tk.must_query(
        "select j1.k, j2.k from j1, j2 where j1.a = j2.a "
        "order by j1.k").rs.rows
    assert [(int(r[0]), int(r[1])) for r in rows] == [(1, 10), (2, 20)]


def test_explicit_column_charset_wins_over_table(tk):
    """A column's own CHARACTER SET must not inherit the table-level
    gbk default collation."""
    tk.must_exec("create table gc (a varchar(16) character set utf8mb4, "
                 "b varchar(16), k int primary key) charset gbk")
    info = tk.domain.infoschema().table_by_name("test", "gc")
    a = next(c for c in info.columns if c.name == "a")
    b = next(c for c in info.columns if c.name == "b")
    assert a.ft.collate != "gbk_chinese_ci"
    assert b.ft.collate == "gbk_chinese_ci"


def test_gbk_ascii_only_case_fold(tk):
    """'ß' must NOT equal 'ss' under gb18030 (Python upper() would
    map it to 'SS'; the reference weighs it by its own code)."""
    tk.must_exec("create table gs (a varchar(16) charset gb18030, "
                 "k int primary key)")
    tk.must_exec("insert into gs values ('ß', 1), ('ss', 2)")
    assert int(tk.must_query(
        "select count(*) from gs where a = 'ss'").rs.rows[0][0]) == 1
    rows = tk.must_query(
        "select count(*) from gs group by a").rs.rows
    assert sorted(int(r[0]) for r in rows) == [1, 1]


def test_gbk_min_max(tk):
    tk.must_exec("create table g7 (a varchar(16) collate gbk_chinese_ci, "
                 "k int primary key)")
    tk.must_exec("insert into g7 values ('中', 1), ('啊', 2), ('z', 3)")
    r = tk.must_query("select min(a), max(a) from g7").rs.rows[0]
    assert (r[0], r[1]) == ("z", "中")
