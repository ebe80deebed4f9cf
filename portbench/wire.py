"""The load generator's MySQL client: a copy of chip_smoke.py's
raw-socket `WireClient` (protocol 4.1, handshake v10 with
mysql_native_password, COM_QUERY, text result sets). It imports neither
torch nor the port, so a client process holds nothing but the socket."""
from __future__ import annotations

import hashlib
import socket
import struct


class WireClient:
    """A raw-socket MySQL 4.1 client: handshake v10 with
    mysql_native_password, COM_QUERY and text result sets."""

    def __init__(self, port, user="root", password="", db="test",
                 expect_ok=True, timeout=600):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        greeting = self._read()
        if greeting[0] != 10:
            raise RuntimeError(f"not a v10 handshake: {greeting[:16]!r}")
        ve = greeting.index(b"\x00", 1)      # end of the version string
        salt = greeting[ve + 5:ve + 13] + greeting[ve + 32:ve + 44]
        token = b""
        if password:
            s1 = hashlib.sha1(password.encode()).digest()
            s3 = hashlib.sha1(salt + hashlib.sha1(s1).digest()).digest()
            token = bytes(a ^ b for a, b in zip(s1, s3))
        caps = 0x200 | 0x8000         # PROTOCOL_41, SECURE_CONNECTION
        if db:
            caps |= 0x8               # CONNECT_WITH_DB
        self._write(struct.pack("<IIB", caps, 1 << 24, 33) + b"\x00" * 23 +
                    user.encode() + b"\x00" + bytes([len(token)]) + token +
                    (db.encode() + b"\x00" if db else b""))
        ok = self._read()
        self.auth_ok = ok[0] == 0x00
        if expect_ok and not self.auth_ok:
            raise RuntimeError(f"handshake refused: {ok[3:]!r}")

    def _recv(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return buf

    def _read(self):
        out = b""
        while True:
            hdr = self._recv(4)
            n = int.from_bytes(hdr[:3], "little")
            self.seq = (hdr[3] + 1) & 0xFF
            out += self._recv(n)
            if n < 0xFFFFFF:
                return out

    def _write(self, payload):
        self.sock.sendall(len(payload).to_bytes(3, "little") +
                          bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    def command(self, payload):
        """Send one command packet (sequence number 0)."""
        self.seq = 0
        self._write(payload)

    @staticmethod
    def _lenenc(data, pos):
        b = data[pos]
        if b < 251:
            return b, pos + 1
        if b == 0xFB:
            return None, pos + 1
        width = {0xFC: 2, 0xFD: 3, 0xFE: 8}[b]
        return int.from_bytes(data[pos + 1:pos + 1 + width], "little"), \
            pos + 1 + width

    def _first(self):
        """The first packet of a response; raises on an error packet."""
        first = self._read()
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise RuntimeError(f"server error {code}: "
                               f"{first[9:].decode(errors='replace')}")
        return first

    def query(self, sql):
        """-> {"cols": names, "rows": tuples of str (None for NULL)} for a
        result set, {"affected": n} for an OK packet."""
        self.command(b"\x03" + sql.encode())
        first = self._first()
        if first[0] == 0x00:
            return {"affected": self._lenenc(first, 1)[0]}
        ncols, _ = self._lenenc(first, 0)
        cols = []
        for _ in range(ncols):            # name: 5th lenenc string
            pkt, pos = self._read(), 0
            for _ in range(5):
                ln, pos = self._lenenc(pkt, pos)
                name = pkt[pos:pos + ln]
                pos += ln
            cols.append(name.decode())
        self._read()                        # EOF
        rows = []
        while True:
            pkt = self._read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return {"cols": cols, "rows": rows}
            row, pos = [], 0
            while pos < len(pkt):
                ln, pos = self._lenenc(pkt, pos)
                if ln is None:
                    row.append(None)
                else:
                    row.append(pkt[pos:pos + ln].decode())
                    pos += ln
            rows.append(tuple(row))

    def close(self):
        try:
            self.command(b"\x01")          # COM_QUIT
        except OSError:
            pass
        self.sock.close()
