"""MySQL client/server wire protocol (reference pkg/server/conn.go packet
IO + pkg/server/column.go resultset writers — re-implemented from the
public protocol spec).

Supports protocol 4.1: handshake v10, COM_QUERY / COM_PING / COM_QUIT /
COM_INIT_DB / COM_FIELD_LIST, text resultsets, OK/ERR/EOF, multi-packet
payload splitting."""
from __future__ import annotations

import struct

# capability flags
CLIENT_LONG_PASSWORD = 0x1
CLIENT_FOUND_ROWS = 0x2
CLIENT_LONG_FLAG = 0x4
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_SSL = 0x800
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_DEPRECATE_EOF = 0x1000000

SERVER_CAPS = (CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG |
               CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 |
               CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION |
               CLIENT_PLUGIN_AUTH)

COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19

MAX_PACKET = 0xFFFFFF


def lenenc_int(v: int) -> bytes:
    if v < 251:
        return bytes([v])
    if v < 1 << 16:
        return b"\xfc" + struct.pack("<H", v)
    if v < 1 << 24:
        return b"\xfd" + struct.pack("<I", v)[:3]
    return b"\xfe" + struct.pack("<Q", v)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


class PacketIO:
    def __init__(self, sock):
        self.sock = sock
        self.seq = 0

    def read_packet(self) -> bytes:
        out = b""
        while True:
            hdr = self._read_n(4)
            ln = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
            self.seq = (hdr[3] + 1) & 0xFF
            out += self._read_n(ln)
            if ln < MAX_PACKET:
                return out

    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed connection")
            buf += chunk
        return buf

    def write_packet(self, payload: bytes):
        while True:
            part = payload[:MAX_PACKET]
            payload = payload[MAX_PACKET:]
            hdr = struct.pack("<I", len(part))[:3] + bytes([self.seq])
            self.seq = (self.seq + 1) & 0xFF
            self.sock.sendall(hdr + part)
            if len(part) < MAX_PACKET:
                return

    def reset_seq(self):
        self.seq = 0


def handshake_packet(conn_id: int, salt: bytes, server_version: str,
                     with_tls: bool = False) -> bytes:
    caps = SERVER_CAPS | (CLIENT_SSL if with_tls else 0)
    out = bytearray()
    out.append(10)                                        # protocol version
    out += server_version.encode() + b"\x00"
    out += struct.pack("<I", conn_id)
    out += salt[:8] + b"\x00"
    out += struct.pack("<H", caps & 0xFFFF)
    out.append(46)                                        # charset utf8mb4
    out += struct.pack("<H", 2)                           # status: autocommit
    out += struct.pack("<H", (caps >> 16) & 0xFFFF)
    out.append(21)                                        # auth data len
    out += b"\x00" * 10
    out += salt[8:20] + b"\x00"
    out += b"mysql_native_password\x00"
    return bytes(out)


def parse_handshake_response(data: bytes):
    """-> (user, db, caps, auth_token) — auth_token is the 20-byte
    mysql_native_password scramble (empty for empty-password logins)."""
    caps, max_packet, charset = struct.unpack_from("<IIB", data, 0)
    pos = 32
    end = data.index(b"\x00", pos)
    user = data[pos:end].decode()
    pos = end + 1
    if caps & CLIENT_SECURE_CONNECTION:
        alen = data[pos]
        token = data[pos + 1:pos + 1 + alen]
        pos += 1 + alen
    else:
        end = data.index(b"\x00", pos)
        token = data[pos:end]
        pos = end + 1
    db = ""
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(data):
        end = data.find(b"\x00", pos)
        if end < 0:
            end = len(data)
        db = data[pos:end].decode()
    return user, db, caps, token


def native_password_token(password: str, salt: bytes) -> bytes:
    """Client-side mysql_native_password scramble:
    SHA1(pwd) XOR SHA1(salt + SHA1(SHA1(pwd))) (MySQL 4.1 auth)."""
    import hashlib
    if not password:
        return b""
    stage1 = hashlib.sha1(password.encode()).digest()
    stage2 = hashlib.sha1(stage1).digest()
    mix = hashlib.sha1(salt + stage2).digest()
    return bytes(a ^ b for a, b in zip(stage1, mix))


def ok_packet(affected=0, last_insert_id=0, status=2, warnings=0) -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id) +
            struct.pack("<HH", status, warnings))


def err_packet(code: int, sqlstate: str, msg: str) -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" +
            sqlstate.encode()[:5].ljust(5, b"0") + msg.encode()[:512])


def eof_packet(status=2, warnings=0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def column_def(name: str, col_type=0xFD, charset=46, length=1024) -> bytes:
    """Column definition 41 (reference pkg/server/column.go dump)."""
    out = bytearray()
    out += lenenc_str(b"def")
    out += lenenc_str(b"")       # schema
    out += lenenc_str(b"")       # table
    out += lenenc_str(b"")       # org table
    out += lenenc_str(name.encode())
    out += lenenc_str(name.encode())
    out.append(0x0C)
    out += struct.pack("<H", charset)
    out += struct.pack("<I", length)
    out.append(col_type)
    out += struct.pack("<H", 0)  # flags
    out.append(0)                # decimals
    out += b"\x00\x00"
    return bytes(out)


def stmt_prepare_ok(stmt_id: int, n_cols: int, n_params: int) -> bytes:
    return (b"\x00" + struct.pack("<I", stmt_id) +
            struct.pack("<HH", n_cols, n_params) + b"\x00" +
            struct.pack("<H", 0))


def parse_execute_params(data: bytes, n_params: int):
    """COM_STMT_EXECUTE payload -> python param values (after the 1-byte
    command): stmt_id(4) flags(1) iteration(4) [null bitmap, new-bound flag,
    types, values]."""
    pos = 0
    stmt_id = struct.unpack_from("<I", data, pos)[0]
    pos += 4 + 1 + 4
    if n_params == 0:
        return stmt_id, []
    nb_len = (n_params + 7) // 8
    null_bitmap = data[pos:pos + nb_len]
    pos += nb_len
    new_bound = data[pos]
    pos += 1
    types = []
    if new_bound:
        for _ in range(n_params):
            t = struct.unpack_from("<H", data, pos)[0]
            types.append(t & 0xFF)
            pos += 2
    params = []
    for i in range(n_params):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            params.append(None)
            continue
        t = types[i] if types else 0xFD
        if t in (0x01,):                       # tiny
            params.append(struct.unpack_from("<b", data, pos)[0]); pos += 1
        elif t in (0x02,):                     # short
            params.append(struct.unpack_from("<h", data, pos)[0]); pos += 2
        elif t in (0x03,):                     # long
            params.append(struct.unpack_from("<i", data, pos)[0]); pos += 4
        elif t in (0x08,):                     # longlong
            params.append(struct.unpack_from("<q", data, pos)[0]); pos += 8
        elif t in (0x04,):                     # float
            params.append(struct.unpack_from("<f", data, pos)[0]); pos += 4
        elif t in (0x05,):                     # double
            params.append(struct.unpack_from("<d", data, pos)[0]); pos += 8
        else:                                  # lenenc string/decimal/etc.
            ln, pos = _read_lenenc(data, pos)
            params.append(data[pos:pos + ln].decode("utf-8",
                                                    "surrogateescape"))
            pos += ln
    return stmt_id, params


def _read_lenenc(data, pos):
    b = data[pos]
    if b < 251:
        return b, pos + 1
    if b == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if b == 0xFD:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9


def binary_row(values) -> bytes:
    """Binary-protocol row with every column typed VAR_STRING (lenenc)."""
    n = len(values)
    bitmap = bytearray((n + 9) // 8)
    out = bytearray(b"\x00")
    for i, v in enumerate(values):
        if v is None:
            bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
    out += bitmap
    for v in values:
        if v is None:
            continue
        s = v if isinstance(v, bytes) else str(v).encode()
        out += lenenc_str(s)
    return bytes(out)


def text_row(values) -> bytes:
    out = bytearray()
    for v in values:
        if v is None:
            out += b"\xfb"
        else:
            s = v if isinstance(v, bytes) else str(v).encode()
            out += lenenc_str(s)
    return bytes(out)
