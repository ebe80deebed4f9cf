"""PAD SPACE folding for case-SENSITIVE legacy collations (MySQL 8:
every non-0900, non-binary collation pads — utf8mb4_bin included):
GROUP BY / joins / ORDER BY treat trailing spaces as insignificant
while case still distinguishes (reference pkg/util/collate PadSpace).

The twin of tests/test_padspace_bin.py on tidb_tpu_torch, with device="cpu" at
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
    tk = TestKit(device="cpu")
    tk.must_exec("create table pb (id int primary key, "
                 "s varchar(16) collate utf8mb4_bin)")
    tk.must_exec("insert into pb values (1, 'a'), (2, 'a  '), "
                 "(3, 'A'), (4, 'b')")
    return tk


def test_group_by_pads_but_keeps_case(tk):
    rows = tk.must_query(
        "select count(*) from pb group by s order by count(*) desc"
    ).rs.rows
    assert [int(r[0]) for r in rows] == [2, 1, 1]


def test_join_key_pads(tk):
    tk.must_exec("create table pb2 (id int primary key, "
                 "s varchar(16) collate utf8mb4_bin)")
    tk.must_exec("insert into pb2 values (10, 'a '), (11, 'B')")
    rows = tk.must_query(
        "select pb.id, pb2.id from pb, pb2 where pb.s = pb2.s "
        "order by pb.id").rs.rows
    # 'a' and 'a  ' both join 'a '; 'b' != 'B' (case-sensitive)
    assert [(r[0], r[1]) for r in rows] == [(1, 10), (2, 10)]


def test_order_by_pads(tk):
    # 'a' and 'a  ' are sort peers; 'A' < 'a' binary; stable by id
    got = [r[0] for r in tk.must_query(
        "select id from pb order by s, id").rs.rows]
    assert got == [3, 1, 2, 4]


def test_distinct_pads(tk):
    assert tk.must_query(
        "select count(distinct s) from pb").rs.rows[0][0] == 3
