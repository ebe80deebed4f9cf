"""tidb_tpu_torch's MySQL wire server on the CPU device: the twin of
tests/test_server.py's tests against the port's Server, TPC-H Q6 over
the wire equal to the reference's own server, a prepared statement run
with two parameter sets through the binary protocol, and
`python -m tidb_tpu_torch --cpu --serve` as a process. The raw-socket
client is chip_smoke.py's WireClient (the one the chip smoke drives the
server with), extended here with the binary protocol's
prepare/execute."""
import os
import select
import socket
import struct
import subprocess
import sys

import pytest

from tidb_tpu.server import Server as RefServer
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.bench import tpch as ref_tpch
from tidb_tpu_torch.bench import tpch as port_tpch
from tidb_tpu_torch.ops import scan_kernels
from tidb_tpu_torch.session import new_store
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server import protocol as P
from tidb_tpu_torch.testkit import TestKit as PortKit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import WireClient  # noqa: E402  (the repo root's script)



@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import metrics, phase, device_guard
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


class MiniClient(WireClient):
    """chip_smoke's raw-socket client with the binary protocol's
    prepare/execute, which only these tests need."""

    def __init__(self, port, db="", user="root", password="",
                 expect_ok=True):
        super().__init__(port, user=user, password=password, db=db,
                         expect_ok=expect_ok, timeout=60)

    def prepare(self, sql):
        """COM_STMT_PREPARE -> (statement id, number of parameters)."""
        self.command(bytes([P.COM_STMT_PREPARE]) + sql.encode())
        ok = self._first()
        assert ok[0] == 0x00, ok
        sid = int.from_bytes(ok[1:5], "little")
        n_params = struct.unpack_from("<H", ok, 7)[0]
        for _ in range(n_params):
            self._read()
        if n_params:
            self._read()   # eof
        return sid, n_params

    def execute(self, sid, params):
        """COM_STMT_EXECUTE with longlong parameters -> rows of strings
        (every column of the binary rows is a lenenc string)."""
        payload = (bytes([P.COM_STMT_EXECUTE]) + struct.pack("<I", sid) +
                   b"\x00" + struct.pack("<I", 1))
        if params:
            payload += bytes((len(params) + 7) // 8)      # null bitmap
            payload += b"\x01"                            # new params bound
            payload += struct.pack("<H", 0x08) * len(params)
            payload += b"".join(struct.pack("<q", p) for p in params)
        self.command(payload)
        first = self._first()
        ncols, _ = self._lenenc(first, 0)
        for _ in range(ncols):
            self._read()
        self._read()   # eof
        rows = []
        while True:
            pkt = self._read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            # binary row: 0x00 header + null bitmap + lenenc values
            bitmap = pkt[1:1 + (ncols + 9) // 8]
            pos = 1 + (ncols + 9) // 8
            row = []
            for i in range(ncols):
                if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                    row.append(None)
                    continue
                ln, pos = self._lenenc(pkt, pos)
                row.append(pkt[pos:pos + ln].decode())
                pos += ln
            rows.append(tuple(row))
        return rows


@pytest.fixture(scope="module")
def server():
    domain = new_store(device="cpu")
    srv = Server(domain, port=0).start()
    yield srv
    srv.shutdown()


def test_wire_basic(server):
    c = MiniClient(server.port, db="test")
    try:
        r = c.query("select 1+1, 'hi'")
        assert r["rows"] == [("2", "hi")]
        c.query("create table wt (a int primary key, b varchar(10))")
        r = c.query("insert into wt values (1,'x'),(2,null)")
        assert r["affected"] == 2
        r = c.query("select * from wt order by a")
        assert r["cols"] == ["a", "b"]
        assert r["rows"] == [("1", "x"), ("2", None)]
    finally:
        c.close()


def test_wire_error_and_sessions(server):
    c1 = MiniClient(server.port, db="test")
    c2 = MiniClient(server.port, db="test")
    try:
        with pytest.raises(RuntimeError, match="1146"):
            c1.query("select * from missing_table")
        c1.query("create table ws (a int)")
        c1.query("begin")
        c1.query("insert into ws values (1)")
        # other connection doesn't see uncommitted data
        r = c2.query("select count(*) from ws")
        assert r["rows"] == [("0",)]
        c1.query("commit")
        r = c2.query("select count(*) from ws")
        assert r["rows"] == [("1",)]
    finally:
        c1.close()
        c2.close()


def test_status_port(server):
    import json
    import urllib.request
    from tidb_tpu_torch.server.status import start_status_server
    st = start_status_server(server.domain, port=0)
    try:
        base = f"http://127.0.0.1:{st.bound_port}"
        server.domain.inc_metric("unit_test_counter", 3)
        body = urllib.request.urlopen(f"{base}/metrics", timeout=10).read()
        assert b"tidb_tpu_unit_test_counter 3" in body
        schema = json.loads(urllib.request.urlopen(
            f"{base}/schema", timeout=10).read())
        assert "test" in schema
        status = json.loads(urllib.request.urlopen(
            f"{base}/status", timeout=10).read())
        assert "version" in status
    finally:
        st.shutdown()


def test_binary_protocol_prepared(server):
    c = MiniClient(server.port, db="test")
    try:
        c.query("create table bp (a int primary key, b varchar(10))")
        c.query("insert into bp values (1,'x'),(2,'y'),(3,'z')")
        sid, n_params = c.prepare("select b from bp where a > ? order by a")
        assert n_params == 1
        assert c.execute(sid, [1]) == [("y",), ("z",)]
        c.command(bytes([P.COM_STMT_CLOSE]) + struct.pack("<I", sid))
    finally:
        c.close()


def test_wire_auth(server):
    root = MiniClient(server.port, db="test")
    try:
        root.query("create user if not exists 'alice'@'%' "
                   "identified by 'sekrit'")
        root.query("grant select on *.* to 'alice'@'%'")
    finally:
        root.close()
    # correct password
    c = MiniClient(server.port, user="alice", password="sekrit")
    try:
        r = c.query("select current_user()")
        assert r["rows"][0][0].startswith("alice")
    finally:
        c.close()
    # wrong password rejected
    bad = MiniClient(server.port, user="alice", password="wrong",
                     expect_ok=False)
    assert not bad.auth_ok
    bad.sock.close()
    # unknown user rejected
    nob = MiniClient(server.port, user="nobody", password="",
                     expect_ok=False)
    assert not nob.auth_ok
    nob.sock.close()
    # authenticated non-root user is privilege-checked
    c2 = MiniClient(server.port, user="alice", password="sekrit", db="test")
    try:
        with pytest.raises(RuntimeError, match="1142|denied"):
            c2.query("create table alice_t (a int)")
    finally:
        c2.close()


def _self_signed(tmpdir):
    """Self-signed cert via openssl (baked into the image)."""
    cert = os.path.join(tmpdir, "cert.pem")
    key = os.path.join(tmpdir, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj",
         "/CN=localhost"], check=True, capture_output=True)
    return cert, key


def test_wire_tls(tmp_path):
    """TLS upgrade: SSLRequest packet -> wrapped socket -> normal
    handshake + queries over TLS."""
    import ssl
    cert, key = _self_signed(str(tmp_path))
    srv = Server(new_store(device="cpu"), port=0, tls_cert=cert,
                 tls_key=key).start()
    try:
        sock = socket.create_connection(("127.0.0.1", srv.port),
                                        timeout=10)
        io = P.PacketIO(sock)
        greeting = io.read_packet()
        caps_lo = struct.unpack_from(
            "<H", greeting, greeting.index(b"\x00", 1) + 13 + 1)[0]
        assert caps_lo & P.CLIENT_SSL        # server advertises TLS
        caps = (P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION |
                P.CLIENT_SSL)
        # SSLRequest: caps header only, then upgrade
        io.write_packet(struct.pack("<IIB", caps, 1 << 24, 46) +
                        b"\x00" * 23)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        tsock = ctx.wrap_socket(sock)
        tio = P.PacketIO(tsock)
        tio.seq = io.seq
        resp = (struct.pack("<IIB", caps, 1 << 24, 46) + b"\x00" * 23 +
                b"root\x00" + b"\x00")
        tio.write_packet(resp)
        ok = tio.read_packet()
        assert ok[0] == 0x00, ok
        tio.reset_seq()
        tio.write_packet(bytes([P.COM_QUERY]) + b"select 40 + 2")
        first = tio.read_packet()
        assert first[0] == 1                 # one column
        tio.read_packet()                    # col def
        tio.read_packet()                    # eof
        row = tio.read_packet()
        assert row.endswith(b"42")
        tsock.close()
        # plaintext connections still work alongside TLS
        c = MiniClient(srv.port, db="test")
        assert c.query("select 1")["rows"] == [("1",)]
        c.close()
    finally:
        srv.shutdown()


def test_result_packets_are_not_held_by_nagle(server, monkeypatch):
    """A result set goes out as several small packets; the server sets
    TCP_NODELAY on each connection so that Nagle's algorithm does not
    hold them until the client's delayed ACK (about 40 ms a statement;
    the reference's server does not set it)."""
    seen = []
    loop = Server._command_loop

    def spy(self, sess, io):
        seen.append(io.sock.getsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY))
        return loop(self, sess, io)
    monkeypatch.setattr(Server, "_command_loop", spy)
    c = MiniClient(server.port, db="test")
    try:
        assert c.query("select 1")["rows"] == [("1",)]
    finally:
        c.close()
    assert seen and seen[0] != 0


# ---- TPC-H over the wire -------------------------------------------------

@pytest.fixture(scope="module")
def tpch_servers():
    """The reference's server and the port's over TPC-H SF0.05."""
    ref, port = RefKit(), PortKit(device="cpu")
    ref_tpch.load_tpch(ref, sf=0.05, seed=7)
    port_tpch.load_tpch(port, sf=0.05, seed=7)
    rsrv = RefServer(ref.domain, port=0).start()
    psrv = Server(port.domain, port=0).start()
    yield rsrv, psrv, port
    rsrv.shutdown()
    psrv.shutdown()


@pytest.fixture
def range_calls(monkeypatch):
    """Calls of the range_filter_sums wrapper, from any thread (on the
    CPU it runs its plain version, so its launch count stays 0)."""
    calls = []
    fn = scan_kernels.range_filter_sums

    def spy(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(scan_kernels, "range_filter_sums", spy)
    return calls


def test_q6_over_the_wire_equals_reference(tpch_servers, range_calls):
    rsrv, psrv, port = tpch_servers
    rc = MiniClient(rsrv.port, db="test")
    try:
        want = rc.query(ref_tpch.Q6)["rows"]
    finally:
        rc.close()
    c = MiniClient(psrv.port, db="test")
    try:
        for _ in range(2):                   # cold, then warm
            hits0 = port.domain.metrics.get("fused_pipeline_hit", 0)
            calls0 = len(range_calls)
            assert c.query(port_tpch.Q6)["rows"] == want
            assert port.domain.metrics.get("fused_pipeline_hit", 0) == \
                hits0 + 1
            assert len(range_calls) > calls0
    finally:
        c.close()
    assert [tuple(r) for r in want] == port_tpch.q6_oracle(port)


def test_prepared_range_statement_two_parameter_sets(tpch_servers,
                                                     range_calls):
    """A cached fragment's bounds come from its own constants: the same
    prepared statement with two parameter sets gives each set's rows."""
    rsrv, psrv, port = tpch_servers
    sql = ("select sum(l_extendedprice * l_discount), count(*) from "
           "lineitem where l_shipdate >= date '1994-01-01' and "
           "l_quantity < ? and l_discount >= ?")
    c = MiniClient(psrv.port, db="test")
    rc = MiniClient(rsrv.port, db="test")
    try:
        sid, n_params = c.prepare(sql)
        rsid, _ = rc.prepare(sql)
        assert n_params == 2
        seen = []
        for params in ([24, 0], [10, 0], [24, 0]):
            calls0 = len(range_calls)
            got = c.execute(sid, params)
            assert got == rc.execute(rsid, params)
            text = sql.replace("?", "{}").format(*params)
            assert got == [tuple(r) for r in
                           port.must_query(text)._norm()]
            assert len(range_calls) > calls0
            seen.append(got)
        assert seen[0] != seen[1] and seen[0] == seen[2]
    finally:
        c.close()
        rc.close()


def test_cli_serve_answers_select_1():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", "--cpu", "--serve",
         "--port", "0", "--status-port", "-1"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "the server printed nothing in 120 s"
        line = proc.stdout.readline()
        assert line.startswith("listening on 127.0.0.1:"), line
        port = int(line.split(":")[1].split()[0])
        c = MiniClient(port)
        try:
            assert c.query("select 1")["rows"] == [("1",)]
        finally:
            c.close()
    finally:
        proc.kill()
        proc.communicate(timeout=60)
