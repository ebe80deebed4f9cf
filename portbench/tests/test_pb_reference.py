"""The reference against the port: every statement of both mixes, over
the MySQL wire from a CPU Domain at SF0.01, for several parameter draws,
on one store and on four shards."""
import pytest

from portbench import gen, reference, sut, traffic
from portbench.tests.conftest import MPP_SESSION, SF
from portbench.wire import WireClient

SEEDS = (1, 2, 3, 2147483659)


@pytest.fixture(scope="module", params=[1, 4], ids=["one_store", "mpp4"])
def server(request):
    tables = gen.make_tables(gen.TABLES, SF, 11)
    dom = sut.make_domain("cpu", request.param)
    sut.load(dom, tables, gen.DDL)
    srv = sut.start_server(dom)
    cl = WireClient(srv.port, db="test")
    if request.param > 1:
        for k, v in MPP_SESSION.items():
            cl.query(f"set @@{k} = {v}")
    yield tables, cl, dom
    cl.close()
    srv.shutdown()


@pytest.mark.parametrize("mix", ["scan", "join"])
@pytest.mark.parametrize("seed", SEEDS)
def test_statements_equal_reference(server, mix, seed):
    tables, cl, dom = server
    for stmts in traffic.streams(traffic.load(mix), seed):
        for st in stmts:
            got = cl.query(st["sql"])["rows"]
            want = reference.statement(st["name"]).rows(tables,
                                                        st["params"])
            assert got == want, (st["name"], st["params"])


def test_mesh_exchanges_counted(server):
    tables, cl, dom = server
    c0 = sut.counters(dom)
    st = traffic.streams(traffic.load("join"), 1)[0][0]
    cl.query(st["sql"])
    moved = {k: v - c0.get(k, 0) for k, v in sut.counters(dom).items()
             if k.startswith("mpp_exchange.")}
    if dom.copr.mesh_spec is None:
        assert not any(moved.values())
    else:
        assert sum(moved.values()) > 0


def test_reference_answers_are_not_empty():
    tables = gen.make_tables(gen.TABLES, SF, 5)
    for mix in ("scan", "join"):
        for stmts in traffic.streams(traffic.load(mix), 5):
            for st in stmts:
                rows = reference.statement(st["name"]).rows(tables,
                                                            st["params"])
                assert rows and rows[0][0] is not None, st
