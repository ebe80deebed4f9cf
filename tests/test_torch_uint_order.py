"""Twins of tests/test_uint_order.py: the same statements through the
port's TestKit on the CPU, on the device route, and through the
reference's TestKit; the port's rows must equal the reference's, values
at and above 2^63 included. Every statement filters (id > 0) with
tidb_tpu_fragment_min_rows = 0, so the port binds the BIGINT UNSIGNED
column to a device fragment as its int64 bits."""
import pytest

from tidb_tpu.testkit import TestKit as RefKit

from tidb_tpu_torch.testkit import TestKit


def _kit(kit, ddl, rows):
    kit.must_exec("set tidb_tpu_fragment_min_rows = 0")
    kit.must_exec(ddl)
    kit.must_exec("insert into " + rows)
    return kit


UINT_TABLE = ("create table u (id int primary key, v bigint unsigned)",
              "u values (1, 18446744073709551615), (2, 0), "
              "(3, 9223372036854775808), (4, 42), (5, 9223372036854775807), "
              "(6, null), (7, 1)")


@pytest.fixture()
def kits():
    return _kit(TestKit(device="cpu"), *UINT_TABLE), \
        _kit(RefKit(), *UINT_TABLE)


def _same_rows(kits, sql):
    """`sql`'s rows through the port, on its device route, == the
    reference's; -> the rows as strings."""
    port, ref = kits
    m = port.domain.metrics
    before = m.get("copr_device_exec", 0)
    got = port.must_query(sql)._norm()
    assert m.get("copr_device_exec", 0) > before
    want = ref.must_query(sql)._norm()
    assert got == want, (sql, got, want)
    return got


def test_uint_order_asc(kits):
    got = _same_rows(kits, "select id from u where id > 0 order by v, id")
    assert len(got) == 7


def test_uint_order_desc(kits):
    got = _same_rows(
        kits, "select id from u where id > 0 order by v desc, id")
    assert len(got) == 7


def test_uint_topn(kits):
    assert len(_same_rows(
        kits, "select id from u where id > 0 order by v desc limit 3")) == 3
    assert len(_same_rows(
        kits, "select id from u where id > 0 order by v limit 2")) == 2


def test_uint_values_render(kits):
    got = _same_rows(
        kits, "select v from u where id + 0 in (1, 3) order by v desc")
    assert len(got) == 2


def test_compound_interval_window_frame():
    """RANGE frames accept compound fixed-width units (DAY_HOUR '1 2' =
    26 hours), over a filtered scan on the device route."""
    table = ("create table wf (id int primary key, t datetime, v int)",
             "wf values (1,'2020-01-01 00:00:00',1),"
             "(2,'2020-01-02 01:00:00',2),(3,'2020-01-03 03:00:00',3)")
    got = _same_rows(
        (_kit(TestKit(device="cpu"), *table), _kit(RefKit(), *table)),
        "select id, sum(v) over (order by t range between "
        "interval '1 2' day_hour preceding and current row) as s "
        "from wf where id > 0 order by id")
    assert len(got) == 3
