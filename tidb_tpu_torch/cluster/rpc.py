"""Multi-host RPC seam, ported from tidb_tpu's cluster/rpc.py
(reference role: the gRPC surface between tidb-server <-> TiKV/TiFlash/
PD — pkg/store/copr client, kv.mpp dispatch, pd TSO stream; re-designed
as a minimal length-prefixed JSON+tensor protocol: control riding JSON,
numpy arrays riding raw bytes so partial-agg states cross hosts without
base64 bloat).

Frame:  u32 json_len, json, u32 n_arrays, per array:
        u32 name_len, name, u32 dtype_len, dtype, u32 data_len, data

Network fault layer: every frame write/read passes the `cluster/net/*`
failpoint seams (registered in utils/failpoint_sites.NET_SITES) so a
chaos test can inject drop, delay, duplicate, one-direction partition,
trickle, and peer-close-mid-frame in whichever process enables them. A
torn frame (peer closed after a partial read) surfaces as
ClusterTransportError — a CLASSIFIED retryable error
(device_guard.classify -> "transient"), never a bare ConnectionError the
supervision layer can't reason about.

A partial whose states are torch tensors on the card reaches the frame
as host numpy arrays, the whole partial list fetched once
(serialize_partials: utils/fetch.py prefetch, one sync).
"""
from __future__ import annotations

import json
import socket
import struct
import time

import numpy as np

from ..errors import TiDBError
from ..utils import failpoint
from ..utils.device_guard import DeviceError


class ClusterTransportError(DeviceError, ConnectionError):
    """A cluster frame was torn, dropped, or the peer vanished mid-RPC.

    Subclasses DeviceError so `device_guard.classify` maps it straight
    to its retryable class, and ConnectionError so every existing
    `except (ConnectionError, OSError)` transport seam (worker serve
    loop, WAL ship degrade, coordinator recovery) still catches it."""
    err_class = "transient"


def _frame_bytes(obj: dict, arrays: dict | None) -> bytes:
    arrays = arrays or {}
    payload = json.dumps(obj).encode()
    out = [struct.pack("<I", len(payload)), payload,
           struct.pack("<I", len(arrays))]
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        nb = name.encode()
        if arr.dtype == object:
            # python-int payloads (big-decimal states): decimal-string
            # transport — tobytes() on object arrays would ship raw
            # POINTERS
            raw = "\x00".join(str(int(v)) for v in arr).encode()
            dt = f"pyint|{len(arr)}".encode()
        else:
            arr = np.ascontiguousarray(arr)
            dt = f"{arr.dtype.str}|" \
                 f"{','.join(map(str, arr.shape))}".encode()
            raw = arr.tobytes()
        out.append(struct.pack("<I", len(nb)))
        out.append(nb)
        out.append(struct.pack("<I", len(dt)))
        out.append(dt)
        out.append(struct.pack("<I", len(raw)))
        out.append(raw)
    return b"".join(out)


def send_msg(sock: socket.socket, obj: dict, arrays: dict | None = None,
             op: str = ""):
    """Write one frame, passing the net-fault seams. `op` labels the
    fault/error messages only — it never rides the wire."""
    data = _frame_bytes(obj, arrays)
    # duplicate: the frame is transmitted twice (at-least-once
    # delivery). The receiver's request-id correlation + dedup window
    # must keep the apply exactly-once and the reply stream in sync.
    try:
        failpoint.inject("cluster/net/dup")
    except TiDBError:
        sock.sendall(data)
    # peer-close mid-frame: a partial prefix goes out, then the
    # connection dies. The PEER sees a torn frame; this side sees a
    # dead socket on its next use.
    try:
        failpoint.inject("cluster/net/partial-close")
    except TiDBError:
        try:
            sock.sendall(data[:max(1, len(data) // 3)])
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise ClusterTransportError(
            f"injected peer close mid-frame (op {op or '?'})")
    # trickle: the frame dribbles out in small chunks with delays —
    # delivered intact, just slowly.
    trickle = False
    try:
        failpoint.inject("cluster/net/trickle")
    except TiDBError:
        trickle = True
    # drop/delay: an error action here means the frame never went out
    # (sustained = a one-direction partition); sleep = link delay. A
    # plain `error` action is wrapped so the drop always surfaces as a
    # classified transport error, whatever the action spec raised.
    try:
        failpoint.inject("cluster/net/send")
    except (ConnectionError, OSError):
        raise
    except TiDBError as e:
        raise ClusterTransportError(
            f"injected send drop (op {op or '?'}): {e}") from e
    if trickle:
        for i in range(0, len(data), 512):
            sock.sendall(data[i:i + 512])
            time.sleep(0.002)
        return
    sock.sendall(data)


def _read_exact(sock, n, started: bool = False, op: str = ""):
    """Read exactly n bytes. A clean close BEFORE any byte of the frame
    is the normal end-of-stream ConnectionError (the worker serve loop
    exits on it); a close after a partial read is a TORN frame and
    surfaces classified retryable with the op attached."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if started or buf:
                raise ClusterTransportError(
                    f"peer closed mid-frame (op {op or '?'}: "
                    f"{len(buf)}/{n} bytes of current field)")
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def recv_msg(sock: socket.socket, op: str = ""):
    # reply loss: an error action here means the peer already executed
    # the request but this side never reads the answer — the retried
    # request must be answered from the peer's dedup window.
    try:
        failpoint.inject("cluster/net/recv")
    except (ConnectionError, OSError):
        raise
    except TiDBError as e:
        raise ClusterTransportError(
            f"injected recv drop (op {op or '?'}): {e}") from e
    (jlen,) = struct.unpack("<I", _read_exact(sock, 4, op=op))
    obj = json.loads(_read_exact(sock, jlen, started=True, op=op))
    (na,) = struct.unpack("<I", _read_exact(sock, 4, started=True, op=op))
    arrays = {}
    for _ in range(na):
        (ln,) = struct.unpack("<I", _read_exact(sock, 4, True, op))
        name = _read_exact(sock, ln, True, op).decode()
        (ln,) = struct.unpack("<I", _read_exact(sock, 4, True, op))
        dt = _read_exact(sock, ln, True, op).decode()
        (ln,) = struct.unpack("<I", _read_exact(sock, 4, True, op))
        raw = _read_exact(sock, ln, True, op)
        # dtype.str may itself contain '|' (e.g. '|b1' for bool)
        dtype_str, shape_str = dt.rsplit("|", 1)
        if dtype_str == "pyint":
            n = int(shape_str)
            vals = raw.decode().split("\x00") if n else []
            arrays[name] = np.array([int(v) for v in vals],
                                    dtype=object)
        else:
            shape = tuple(int(x) for x in shape_str.split(",") if x)
            arrays[name] = np.frombuffer(
                raw, dtype=np.dtype(dtype_str)).reshape(shape).copy()
    return obj, arrays


def _pack_strs(vals):
    return np.frombuffer("\x00".join(str(v) for v in vals).encode(),
                         dtype=np.uint8)


def _unpack_strs(arr, n):
    if n == 0:
        return []
    return arr.tobytes().decode().split("\x00")


def serialize_partials(partials) -> tuple:
    """[PartialAggResult] -> (meta, arrays). String-typed group keys AND
    string-typed aggregate states are DECODED to value arrays:
    dictionary codes are per-process and must not cross hosts."""
    from ..utils.fetch import host_array, prefetch
    meta = {"parts": []}
    arrays = {}
    for pi, p in enumerate(prefetch([_tree(p) for p in partials])):
        p = _Partial(p, host_array)
        pm = {"ngroups": p.ngroups, "nkeys": len(p.keys),
              "states": [len(st) for st in p.states], "strkeys": [],
              "strstates": []}
        for ki, (k, kn, kd) in enumerate(zip(p.keys, p.key_nulls,
                                             p.key_dicts)):
            if kd is not None:
                vals = kd.decode(np.asarray(k).astype(np.int64))
                arrays[f"p{pi}_ks{ki}"] = _pack_strs(vals)
                pm["strkeys"].append(ki)
            else:
                arrays[f"p{pi}_k{ki}"] = np.asarray(k)
            arrays[f"p{pi}_kn{ki}"] = np.asarray(kn)
        for si, st in enumerate(p.states):
            sd = p.state_dicts[si]
            for vi, v in enumerate(st):
                if vi == 0 and sd is not None:
                    vals = sd.decode(np.asarray(v).astype(np.int64))
                    arrays[f"p{pi}_ss{si}_{vi}"] = _pack_strs(vals)
                    pm["strstates"].append(si)
                else:
                    arrays[f"p{pi}_s{si}_{vi}"] = np.asarray(v)
        meta["parts"].append(pm)
    return meta, arrays


def _tree(p):
    """A partial's arrays as one tree, for one prefetch of them all."""
    return {"p": p, "keys": list(p.keys), "key_nulls": list(p.key_nulls),
            "states": [list(st) for st in p.states]}


class _Partial:
    """A fetched _tree: the partial's fields with host numpy arrays."""

    def __init__(self, tree, host):
        p = tree["p"]
        self.ngroups = int(p.ngroups)
        self.keys = [host(k) for k in tree["keys"]]
        self.key_nulls = [host(k) for k in tree["key_nulls"]]
        self.states = [[host(v) for v in st] for st in tree["states"]]
        self.key_dicts = p.key_dicts
        self.state_dicts = p.state_dicts


def deserialize_partials(meta, arrays, shared_dicts=None):
    """-> [PartialAggResult]. `shared_dicts` must be reused across every
    worker's response of one query: the merge machinery assumes all
    partials share ONE dictionary per key/state position — re-encoding
    each worker's values into the same dict keeps codes comparable."""
    from ..copr.dag_exec import PartialAggResult
    from ..chunk.device import StringDict
    shared = shared_dicts if shared_dicts is not None else {}
    out = []
    for pi, pm in enumerate(meta["parts"]):
        ng = pm["ngroups"]
        keys, key_nulls, key_dicts = [], [], []
        for ki in range(pm["nkeys"]):
            if ki in pm["strkeys"]:
                vals = _unpack_strs(arrays[f"p{pi}_ks{ki}"], ng)
                sd = shared.setdefault(("k", ki), StringDict())
                keys.append(np.array([sd.encode_one(v) for v in vals],
                                     dtype=np.int64))
                key_dicts.append(sd)
            else:
                keys.append(arrays[f"p{pi}_k{ki}"])
                key_dicts.append(None)
            key_nulls.append(arrays[f"p{pi}_kn{ki}"].astype(bool))
        states = []
        state_dicts = []
        for si, nst in enumerate(pm["states"]):
            st = []
            if si in pm["strstates"]:
                vals = _unpack_strs(arrays[f"p{pi}_ss{si}_0"], ng)
                sd = shared.setdefault(("s", si), StringDict())
                st.append(np.array([sd.encode_one(v) for v in vals],
                                   dtype=np.int64))
                state_dicts.append(sd)
            else:
                st.append(arrays[f"p{pi}_s{si}_0"])
                state_dicts.append(None)
            for vi in range(1, nst):
                st.append(arrays[f"p{pi}_s{si}_{vi}"])
            states.append(st)
        out.append(PartialAggResult(
            ngroups=ng, keys=keys, key_nulls=key_nulls,
            states=states, key_dicts=key_dicts,
            state_dicts=state_dicts))
    return out
