"""MySQL-protocol server (reference pkg/server/server.go:498 Run +
conn.go:1157 clientConn.Run). Threaded accept loop; one Session per
connection; graceful shutdown drains connections. Host code, copied
from tidb_tpu's server/server.py over the port's Session and Domain."""
from __future__ import annotations

import os
import socket
import threading

from ..session import Session, Domain
from ..errors import TiDBError
from . import protocol as P


class Server:
    def __init__(self, domain: Domain, host="127.0.0.1", port=4000,
                 tls_cert=None, tls_key=None):
        self.domain = domain
        self.host = host
        self.port = port
        self._sock = None
        self._threads: list = []
        self._running = False
        self._ssl_ctx = None
        if tls_cert and tls_key:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._ssl_ctx = ctx

    def start(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        if self.port == 0:
            self.port = self._sock.getsockname()[1]
        self._sock.listen(128)
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    # ---- per-connection ----------------------------------------------
    def _serve_conn(self, sock):
        # a result set goes out as several small packets: without
        # TCP_NODELAY, Nagle's algorithm holds each one back until the
        # client's delayed ACK of the one before it (about 40 ms a
        # statement on Linux)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sess = Session(self.domain)
        io = P.PacketIO(sock)
        try:
            salt = os.urandom(20)
            io.write_packet(P.handshake_packet(
                sess.conn_id, salt, "8.0.11-tidb-tpu-0.1.0",
                with_tls=self._ssl_ctx is not None))
            resp = io.read_packet()
            caps0 = int.from_bytes(resp[:4], "little") if len(resp) >= 4 \
                else 0
            if self._ssl_ctx is not None and (caps0 & P.CLIENT_SSL) and \
                    len(resp) <= 32:
                # SSL request packet: upgrade the connection, then read
                # the real handshake response over TLS (reference
                # server/conn.go upgradeToTLS)
                sock = self._ssl_ctx.wrap_socket(sock, server_side=True)
                seq = io.seq
                io = P.PacketIO(sock)
                io.seq = seq
                resp = io.read_packet()
            user, db, caps, token = P.parse_handshake_response(resp)
            try:
                peer_host = sock.getpeername()[0]
            except OSError:
                peer_host = "%"
            from ..utils import logutil
            if not sess.domain.priv.auth_native(user, peer_host, salt,
                                                token):
                logutil.warn("auth_failed", user=user, host=peer_host,
                             conn=sess.conn_id)
                io.write_packet(P.err_packet(
                    1045, "28000",
                    f"Access denied for user '{user}'@'{peer_host}' "
                    f"(using password: {'YES' if token else 'NO'})"))
                return
            logutil.info("conn_open", user=user, host=peer_host,
                         conn=sess.conn_id)
            sess.user = user
            sess.host = peer_host
            if db:
                try:
                    sess.domain.infoschema().schema_by_name(db)
                    sess.vars.current_db = db
                except TiDBError:
                    pass
            io.write_packet(P.ok_packet())
            self._command_loop(sess, io)
        except (ConnectionError, OSError):
            pass
        finally:
            sess.rollback()
            # a dropped client must not strand its LOCK TABLES set
            sess._release_table_locks()
            try:
                sock.close()
            except OSError:
                pass

    def _command_loop(self, sess: Session, io: P.PacketIO):
        while True:
            io.reset_seq()
            pkt = io.read_packet()
            if not pkt:
                return
            cmd = pkt[0]
            if cmd == P.COM_QUIT:
                return
            if cmd == P.COM_PING:
                io.write_packet(P.ok_packet())
                continue
            if cmd == P.COM_INIT_DB:
                dbname = pkt[1:].decode()
                try:
                    sess.execute(f"use `{dbname}`")
                    io.write_packet(P.ok_packet())
                except TiDBError as e:
                    io.write_packet(P.err_packet(e.code, e.sqlstate, e.msg))
                continue
            if cmd == P.COM_FIELD_LIST:
                io.write_packet(P.eof_packet())
                continue
            if cmd == P.COM_QUERY:
                sql = pkt[1:].decode("utf-8", "surrogateescape")
                self._handle_query(sess, io, sql)
                continue
            if cmd == P.COM_STMT_PREPARE:
                sql = pkt[1:].decode("utf-8", "surrogateescape")
                try:
                    sid, n_params = sess.prepare_wire(sql)
                except TiDBError as e:
                    io.write_packet(P.err_packet(e.code, e.sqlstate, e.msg))
                    continue
                io.write_packet(P.stmt_prepare_ok(sid, 0, n_params))
                for _ in range(n_params):
                    io.write_packet(P.column_def("?"))
                if n_params:
                    io.write_packet(P.eof_packet())
                continue
            if cmd == P.COM_STMT_EXECUTE:
                sid = int.from_bytes(pkt[1:5], "little")
                entry = sess.stmt_handles.get(sid)
                if entry is None:
                    io.write_packet(P.err_packet(1243, "HY000",
                                                 "Unknown stmt handler"))
                    continue
                n_params = entry[1]
                try:
                    _, params = P.parse_execute_params(pkt[1:], n_params)
                    rs = sess.execute_wire(sid, params)
                except TiDBError as e:
                    io.write_packet(P.err_packet(e.code, e.sqlstate, e.msg))
                    continue
                except Exception as e:              # noqa: BLE001
                    io.write_packet(P.err_packet(1105, "HY000",
                                                 str(e)[:400]))
                    continue
                self._write_resultset(io, rs, binary=True)
                continue
            if cmd == P.COM_STMT_CLOSE:
                sid = int.from_bytes(pkt[1:5], "little")
                sess.close_wire(sid)
                continue
            io.write_packet(P.err_packet(1047, "08S01", "unknown command"))

    def _handle_query(self, sess: Session, io: P.PacketIO, sql: str):
        try:
            rs = sess.execute(sql)
        except TiDBError as e:
            io.write_packet(P.err_packet(e.code, e.sqlstate, e.msg))
            return
        except Exception as e:   # internal error -> protocol error packet
            io.write_packet(P.err_packet(1105, "HY000", str(e)[:400]))
            return
        self._write_resultset(io, rs, binary=False)

    def _write_resultset(self, io, rs, binary):
        if not rs.names:
            io.write_packet(P.ok_packet(
                affected=rs.affected, last_insert_id=rs.last_insert_id))
            return
        io.write_packet(P.lenenc_int(len(rs.names)))
        for name in rs.names:
            io.write_packet(P.column_def(name))
        io.write_packet(P.eof_packet())
        enc = P.binary_row if binary else P.text_row
        for ch in rs.chunks:
            for i in range(len(ch)):
                io.write_packet(enc(ch.row_py(i)))
        io.write_packet(P.eof_packet())


def serve(port=4000):
    """Entry point: bootstrapped store + MySQL-protocol listener
    (reference cmd/tidb-server/main.go:400). The store runs on the CUDA
    device, as new_store() does by default."""
    from ..session import new_store
    domain = new_store()
    domain.start_background()
    srv = Server(domain, port=port).start()
    return srv
