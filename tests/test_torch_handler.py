"""HANDLER statements (reference pkg/parser/parser.y HandlerStmt;
MySQL's cursor interface). Covers OPEN/READ/CLOSE, natural and index
order, comparison positioning, WHERE, LIMIT, and aliasing.

The twin of tests/test_handler.py on tidb_tpu_torch, with device="cpu" at
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
    tk.must_exec("create table h (id int primary key, g int, "
                 "s varchar(8), key kg (g, id))")
    tk.must_exec("insert into h values (1, 30, 'c'), (2, 10, 'a'), "
                 "(3, 20, 'b'), (4, 10, 'd'), (5, 20, 'e')")
    return tk


def rows(rs):
    return [tuple(r) for r in rs.rs.rows]


def test_handler_natural_scan(tk):
    tk.must_exec("handler h open")
    assert rows(tk.must_query("handler h read first"))[0][0] == 1
    assert rows(tk.must_query("handler h read next"))[0][0] == 2
    assert rows(tk.must_query("handler h read next"))[0][0] == 3
    tk.must_exec("handler h close")


def test_handler_index_order_and_eq(tk):
    tk.must_exec("handler h open")
    got = rows(tk.must_query("handler h read kg first"))
    assert got[0][:2] == (2, 10)          # (g=10, id=2) sorts first
    got = rows(tk.must_query("handler h read kg next"))
    assert got[0][:2] == (4, 10)
    got = rows(tk.must_query("handler h read kg = (20)"))
    assert got[0][:2] == (3, 20)
    got = rows(tk.must_query("handler h read kg next"))
    assert got[0][:2] == (5, 20)
    got = rows(tk.must_query("handler h read kg last"))
    assert got[0][:2] == (1, 30)
    got = rows(tk.must_query("handler h read kg prev"))
    assert got[0][:2] == (5, 20)
    tk.must_exec("handler h close")


def test_handler_range_reads(tk):
    tk.must_exec("handler h open")
    assert rows(tk.must_query("handler h read kg >= (20)"))[0][1] == 20
    assert rows(tk.must_query("handler h read kg > (20)"))[0][1] == 30
    assert rows(tk.must_query("handler h read kg <= (10)"))[0][1] == 10
    assert rows(tk.must_query("handler h read kg < (20)"))[0][1] == 10
    assert rows(tk.must_query("handler h read kg = (15)")) == []
    tk.must_exec("handler h close")


def test_handler_where_and_limit(tk):
    tk.must_exec("handler h open")
    got = rows(tk.must_query("handler h read kg first where s <> 'a' "
                             "limit 2"))
    assert [r[:2] for r in got] == [(4, 10), (3, 20)]
    tk.must_exec("handler h close")


def test_handler_alias_and_errors(tk):
    tk.must_exec("handler h open as hx")
    assert rows(tk.must_query("handler hx read first"))[0][0] == 1
    tk.must_exec("handler hx close")
    from tidb_tpu_torch.errors import TiDBError
    with pytest.raises(TiDBError):
        tk.must_query("handler hx read next")


def test_handler_composite_eq(tk):
    tk.must_exec("handler h open")
    got = rows(tk.must_query("handler h read kg = (10, 4)"))
    assert got[0][:2] == (4, 10)
    tk.must_exec("handler h close")


def test_handler_sees_latest_committed(tk):
    tk.must_exec("handler h open")
    tk.must_query("handler h read first")
    tk.must_exec("insert into h values (0, 5, 'z')")
    got = rows(tk.must_query("handler h read kg first"))
    assert got[0][:2] == (0, 5)
    tk.must_exec("handler h close")


def test_handler_review_edges(tk):
    """Round-5 review findings: unseen range keys, NULL key parts, too
    many key parts, LIMIT 0, LIMIT offset."""
    from tidb_tpu_torch.errors import TiDBError
    tk.must_exec("create table hs (id int primary key, s varchar(8), "
                 "key ks (s))")
    tk.must_exec("insert into hs values (1, 'a'), (2, 'z')")
    tk.must_exec("handler hs open")
    # unseen literal between 'a' and 'z': range reads position correctly
    assert rows(tk.must_query("handler hs read ks < ('m')"))[0][1] == "a"
    assert rows(tk.must_query("handler hs read ks >= ('m')"))[0][1] == "z"
    assert rows(tk.must_query("handler hs read ks = ('m')")) == []
    with pytest.raises(TiDBError):
        tk.must_query("handler hs read ks = (null)")
    tk.must_exec("handler hs close")
    tk.must_exec("handler h open")
    with pytest.raises(TiDBError):
        tk.must_query("handler h read kg = (1, 2, 3)")
    assert rows(tk.must_query("handler h read first limit 0")) == []
    got = rows(tk.must_query("handler h read kg first limit 1, 2"))
    assert [r[:2] for r in got] == [(4, 10), (3, 20)]
    tk.must_exec("handler h close")


def test_handler_null_keys_sort_first(tk):
    tk.must_exec("create table hn (id int primary key, g int, "
                 "key kn (g))")
    tk.must_exec("insert into hn values (1, 5), (2, null), (3, 1)")
    tk.must_exec("handler hn open")
    got = rows(tk.must_query("handler hn read kn first"))
    assert got[0][0] == 2 and got[0][1] is None
    # = (0) must not match the NULL row
    assert rows(tk.must_query("handler hn read kn = (0)")) == []
    tk.must_exec("handler hn close")
