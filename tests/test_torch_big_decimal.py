"""DECIMAL beyond scale 18 (VERDICT r1 item 10): exact to MySQL's 65
digits via python-int object columns on the host path (reference
pkg/types/mydecimal.go); scaled-int64 device fast path is untouched for
scale <= 18.

The twin of tests/test_big_decimal.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.testkit import TestKit

A = "1.000000000000000000000000000001"
B = "2.000000000000000000000000000002"


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
    tk.must_exec("create table dx (id int primary key, "
                 "a decimal(38,30), b decimal(38,30))")
    tk.must_exec(f"insert into dx values (1, '{A}', '{B}'), "
                 "(2, '-0.000000000000000000000000000003', '7.5')")
    return tk


def test_roundtrip_and_order(tk):
    assert tk.must_query("select a from dx order by a").rs.rows == [
        ("-0.000000000000000000000000000003",), (A,)]


def test_exact_arithmetic(tk):
    r = tk.must_query("select a + b, a - b, a * b from dx "
                      "where id = 1").rs.rows[0]
    assert r[0] == "3.000000000000000000000000000003"
    assert r[1] == "-1.000000000000000000000000000001"
    assert r[2] == "2.000000000000000000000000000004"


def test_exact_division(tk):
    r = tk.must_query("select b / 3 from dx order by id").rs.rows
    assert r[0][0] == "0.666666666666666666666666666667"
    assert r[1][0] == "2.500000000000000000000000000000"


def test_aggregates_exact(tk):
    r = tk.must_query("select sum(a), min(a), max(b) from dx").rs.rows[0]
    assert r[0] == "0.999999999999999999999999999998"
    assert r[1] == "-0.000000000000000000000000000003"
    assert r[2] == "7.500000000000000000000000000000"


def test_filters(tk):
    assert tk.must_query(
        f"select id from dx where a = {A}").rs.rows == [(1,)]
    assert tk.must_query(
        "select count(*) from dx where a > 0").rs.rows == [(1,)]


def test_persistence_roundtrip(tmp_path):
    from tidb_tpu_torch.session import new_store, Session
    d = str(tmp_path / "dd")
    dom = new_store(d, device="cpu")
    s = Session(dom)
    s.vars.current_db = "test"
    s.execute("create table p (x decimal(40,25))")
    s.execute("insert into p values ('123456789012345.1234567890123456789012345')")
    dom.storage.mvcc.wal.close()
    dom2 = new_store(d, device="cpu")
    s2 = Session(dom2)
    s2.vars.current_db = "test"
    assert s2.execute("select x from p").rows == [
        ("123456789012345.1234567890123456789012345",)]


def test_small_scale_unaffected(tk):
    """Money-scale decimals keep the device-eligible int64 path."""
    from tidb_tpu_torch.expression.vec import is_device_safe
    from tidb_tpu_torch.expression import Column as C
    from tidb_tpu_torch.types.field_type import new_decimal_type
    assert is_device_safe(C(1, new_decimal_type(38, 4), "x"))
    assert not is_device_safe(C(1, new_decimal_type(38, 30), "x"))
