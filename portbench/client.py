"""One stream of the load: a client process with one connection to the
wire server. It imports the harness's wire client and nothing of torch or
the port.

The parent talks to it in JSON lines. The first line on stdin names the
port, the session statements and the stream's statements in cycle order.
Then, per command line:
  {"cmd": "warm"}                    run each statement once; reply
                                     {"warm_ms": [...]}
  {"cmd": "run", "t0": m, "t1": m}   wait until time.monotonic() >= t0,
                                     then run the cycle in a closed loop,
                                     starting no statement at or after t1;
                                     reply with what each one did
  {"cmd": "quit"}                    close the connection and exit
The process's first reply is {"ready": conn_id, "sent": n}; every reply
also says how many COM_QUERYs the connection has sent so far."""
from __future__ import annotations

import json
import sys
import time

from portbench.wire import WireClient


def _key(rows):
    return json.dumps([list(r) for r in rows])


def main():
    spec = json.loads(sys.stdin.readline())
    cl = WireClient(spec["port"], db="test")
    sent = 0

    def query(sql):
        nonlocal sent
        sent += 1
        return cl.query(sql)

    def reply(obj):
        obj["sent"] = sent
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    for sql in spec["session"]:
        query(sql)
    conn_id = int(query("select connection_id()")["rows"][0][0])
    stmts = spec["statements"]
    reply({"ready": conn_id})
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "quit":
            break
        if cmd["cmd"] == "warm":
            ms = []
            for st in stmts:
                t = time.perf_counter()
                query(st["sql"])
                ms.append((time.perf_counter() - t) * 1e3)
            reply({"warm_ms": ms})
            continue
        if cmd["cmd"] != "run":
            raise ValueError(f"unknown command {cmd}")
        first = sent
        t0, t1 = cmd["t0"], cmd["t1"]
        while time.monotonic() < t0:
            time.sleep(min(0.001, max(t0 - time.monotonic(), 0.0)))
        # per statement of the loop: (index in the cycle, start, end)
        # on time.monotonic(); rows: per index, each distinct row set
        # and how often it came; errors: per index, the messages
        log, rows, errors = [], {}, {}
        i = 0
        while True:
            start = time.monotonic()
            if start >= t1:
                break
            k = i % len(stmts)
            try:
                got = query(stmts[k]["sql"])["rows"]
            except (RuntimeError, KeyError) as e:
                errors.setdefault(k, []).append(str(e)[:300])
                got = None
            log.append((k, start, time.monotonic()))
            if got is not None:
                seen = rows.setdefault(k, {})
                key = _key(got)
                seen[key] = seen.get(key, 0) + 1
            i += 1
        reply({"first": first, "log": log, "rows": rows,
               "errors": errors})
    cl.close()


if __name__ == "__main__":
    main()
