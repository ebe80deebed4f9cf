"""IMPORT INTO: native C++ loader vs python fallback parity.

The twin of tests/test_import.py on tidb_tpu_torch, with device="cpu" at
every store."""
import os

import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.native.loader import native_available


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


TBL = """1|7.5|12.34|1994-02-03|hello|1994-02-03 10:20:30
2|-1.25|0.05|1999-12-31|world|1999-12-31 23:59:59.5
3|0|-3.3|1970-01-01|hello|1970-01-01 00:00:00
"""


def _mk(tk, tmp_path):
    tk.must_exec("create table imp (a int, f double, d decimal(10,2), "
                 "dt date, s varchar(20), ts datetime)")
    p = tmp_path / "data.tbl"
    p.write_text(TBL)
    return str(p)


EXPECT = [
    (1, 7.5, "12.34", "1994-02-03", "hello", "1994-02-03 10:20:30"),
    (2, -1.25, "0.05", "1999-12-31", "world", "1999-12-31 23:59:59"),
    (3, 0, "-3.30", "1970-01-01", "hello", "1970-01-01 00:00:00"),
]


def test_import_python_path(tk, tmp_path):
    p = _mk(tk, tmp_path)
    tk.must_exec(f"import into imp from '{p}' with force_python")
    tk.must_query("select * from imp order by a").check(EXPECT)


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_import_native_path(tk, tmp_path):
    p = _mk(tk, tmp_path)
    r = tk.must_exec(f"import into imp from '{p}'")
    assert r.affected == 3
    tk.must_query("select * from imp order by a").check(EXPECT)
    # dict-encoded strings grouped correctly
    tk.must_query("select s, count(*) from imp group by s order by s").check([
        ("hello", 2), ("world", 1)])


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_native_decimal_rounding(tk, tmp_path):
    tk.must_exec("create table nd (d decimal(10,2))")
    p = tmp_path / "nd.csv"
    p.write_text("1.005\n-1.005\n2.994\n")
    tk.must_exec(f"import into nd from '{p}'")
    tk.must_query("select d from nd order by d").check([
        ("-1.01",), ("1.01",), ("2.99",)])


def test_bulk_table_point_get_by_pk(tk, tmp_path):
    """Imported rows have no index KV; PointGet-by-PK must still find
    them (handles derived from the PK column, not arange) — ADVICE r1."""
    tk.must_exec("create table bpk (id int primary key, v varchar(10))")
    p = tmp_path / "bpk.csv"
    p.write_text("100,alpha\n205,beta\n3,gamma\n")
    tk.must_exec(f"import into bpk from '{p}' with force_python")
    ctab = tk.domain.columnar.tables[
        tk.domain.infoschema().table_by_name("test", "bpk").id]
    assert ctab.bulk_rows == 3
    tk.must_query("select v from bpk where id = 205").check([("beta",)])
    tk.must_query("select v from bpk where id = 3").check([("gamma",)])
    tk.must_query("select v from bpk where id = 4").check([])


def test_bulk_table_unique_index_lookup(tk, tmp_path):
    """Unique-index point get on a bulk table must not consult (empty)
    index KV — planner gates on bulk_rows, executor probes columnar."""
    tk.must_exec("create table bui (id int primary key, u varchar(10), "
                 "unique key uk (u))")
    p = tmp_path / "bui.csv"
    p.write_text("1,aa\n2,bb\n3,cc\n")
    tk.must_exec(f"import into bui from '{p}' with force_python")
    tk.must_query("select id from bui where u = 'bb'").check([(2,)])
    tk.must_query("select id from bui where u = 'zz'").check([])


def test_bulk_table_index_range_falls_back(tk, tmp_path):
    """Range predicate on an indexed column of a bulk table must scan
    columnar (index KV is empty)."""
    tk.must_exec("create table bir (id int primary key, k int, key ik (k))")
    p = tmp_path / "bir.csv"
    rows = "\n".join(f"{i},{i * 10}" for i in range(1, 101))
    p.write_text(rows + "\n")
    tk.must_exec(f"import into bir from '{p}' with force_python")
    # even after ANALYZE makes the range look selective, results must
    # include the bulk rows
    tk.must_exec("analyze table bir")
    tk.must_query("select count(*) from bir where k >= 980").check([(3,)])


def _mk_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from decimal import Decimal
    import datetime as dt
    t = pa.table({
        "a": pa.array([1, 2, 3], pa.int64()),
        "f": pa.array([7.5, -1.25, 0.0], pa.float64()),
        "d": pa.array([Decimal("12.34"), Decimal("0.05"),
                       Decimal("-3.30")], pa.decimal128(10, 2)),
        "dt": pa.array([dt.date(1994, 2, 3), dt.date(1999, 12, 31),
                        dt.date(1970, 1, 1)], pa.date32()),
        "s": pa.array(["hello", "world", "hello"], pa.string()),
        "ts": pa.array([dt.datetime(1994, 2, 3, 10, 20, 30),
                        dt.datetime(1999, 12, 31, 23, 59, 59),
                        dt.datetime(1970, 1, 1)], pa.timestamp("us")),
    })
    p = tmp_path / "data.parquet"
    pq.write_table(t, str(p))
    return str(p)


def test_import_parquet(tk, tmp_path):
    """Parquet IMPORT INTO (reference pkg/dumpformat/parquetfile +
    lightning parquet reader): arrow date32/timestamp/decimal128 map
    exactly onto the engine's day/micro/scaled-int representations."""
    pytest.importorskip("pyarrow")
    tk.must_exec("create table imp (a int, f double, d decimal(10,2), "
                 "dt date, s varchar(20), ts datetime)")
    p = _mk_parquet(tmp_path)
    tk.must_exec(f"import into imp from '{p}'")
    tk.must_query("select * from imp order by a").check([
        (1, 7.5, "12.34", "1994-02-03", "hello", "1994-02-03 10:20:30"),
        (2, -1.25, "0.05", "1999-12-31", "world", "1999-12-31 23:59:59"),
        (3, 0, "-3.30", "1970-01-01", "hello", "1970-01-01 00:00:00"),
    ])
    # imported rows aggregate on the device path like any bulk rows
    assert tk.must_query(
        "select s, count(*) from imp group by s order by s").rs.rows == \
        [("hello", 2), ("world", 1)]


def test_import_parquet_pk_dedup(tk, tmp_path):
    """Clustered-PK parquet import takes PK handles + duplicate
    detection, same as the CSV path."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    tk.must_exec("create table ppk (k bigint primary key, v int)")
    tk.must_exec("insert into ppk values (2, 99)")
    t = pa.table({"k": pa.array([1, 2, 3], pa.int64()),
                  "v": pa.array([10, 20, 30], pa.int64())})
    p = str(tmp_path / "pk.parquet")
    pq.write_table(t, p)
    import pytest as _pt
    from tidb_tpu_torch.errors import TiDBError
    with _pt.raises(TiDBError):
        tk.must_exec(f"import into ppk from '{p}'")
    r = tk.must_exec(f"import into ppk from '{p}' "
                     f"with on_duplicate = skip")
    assert r.affected == 2 and r.skipped == 1
    assert tk.must_query("select v from ppk where k = 2").rs.rows == \
        [(99,)]


def test_import_parquet_null_rejected(tk, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from tidb_tpu_torch.errors import TiDBError
    tk.must_exec("create table pnull (a int, s varchar(8))")
    t = pa.table({"a": pa.array([1, None], pa.int64()),
                  "s": pa.array(["x", None], pa.string())})
    p = str(tmp_path / "n.parquet")
    pq.write_table(t, p)
    with pytest.raises(TiDBError):
        tk.must_exec(f"import into pnull from '{p}'")


def test_import_parquet_by_position_when_names_differ(tk, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    tk.must_exec("create table ppos (a int, b int)")
    t = pa.table({"c0": pa.array([1, 2], pa.int64()),
                  "c1": pa.array([10, 20], pa.int64())})
    p = str(tmp_path / "pos.parquet")
    pq.write_table(t, p)
    tk.must_exec(f"import into ppos from '{p}'")
    assert tk.must_query("select a, b from ppos order by a").rs.rows == \
        [(1, 10), (2, 20)]


def test_import_conflict_report(tk, tmp_path):
    """Skipped duplicates are queryable in
    information_schema.tidb_import_conflicts (reference lightning
    conflict detection), not silently dropped."""
    tk.must_exec("create table cr (k bigint primary key, v int)")
    tk.must_exec("insert into cr values (2, 99), (3, 98)")
    p = tmp_path / "cr.csv"
    p.write_text("1,10\n2,20\n3,30\n4,40\n")
    r = tk.must_exec(f"import into cr from '{p}' "
                     f"with on_duplicate = skip")
    assert r.affected == 2 and r.skipped == 2
    rows = tk.must_query(
        "select table_name, handle, conflict from "
        "information_schema.tidb_import_conflicts order by handle"
    ).rs.rows
    assert [(r0[0], r0[1]) for r0 in rows] == [("cr", 2), ("cr", 3)]
    assert all(r0[2] == "duplicate primary key" for r0 in rows)
