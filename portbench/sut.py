"""The system under test: tidb_tpu_torch, as one server process holds it.
This module, and what `run.py` calls through it, are the harness's only
way into the program: a Domain on the device (with an MPP mesh of the
configuration's shards), the TPC-H tables through the columnar bulk path,
ANALYZE, the MySQL wire server on loopback, the program's counters, and
the timers the traced run puts around the session's entries."""
from __future__ import annotations

import threading
import time

# the fused fragment's learning reruns: a window that moves one ran a
# statement cold (a new capacity, a pin, a relearnt table)
LEARNING = ("fused_compact_regrow", "fused_runs_degrade",
            "fused_bucket_regrow", "fused_topn_off", "fused_onehot_miss")


def make_domain(device: str, shards: int):
    from tidb_tpu_torch.session import new_store
    return new_store(device=device, mesh=shards if shards > 1 else None)


def session(domain):
    from tidb_tpu_torch.session import Session
    s = Session(domain)
    s.vars.current_db = "test"
    return s


def load(domain, tables: dict, ddl: dict):
    """Create each table and bulk-append its arrays (the loader's path:
    dictionaries seeded in code order, then one columnar append)."""
    s = session(domain)
    for name in tables:
        s.execute(f"drop table if exists {name}")
        s.execute(ddl[name])
    schema = domain.infoschema()
    for name, t in tables.items():
        info = schema.table_by_name("test", name)
        ctab = domain.columnar.table(info)
        for cname, values in t["dicts"].items():
            d = ctab.dicts[info.find_column(cname).id]
            for v in values:
                d.encode_one(v)
        ctab.bulk_append(t["cols"], t["n"])


def analyze(domain, names) -> dict:
    """ANALYZE each table, the statistics a table's first statement
    builds when it finds none -> {table: seconds}."""
    s = session(domain)
    out = {}
    for name in names:
        t = time.perf_counter()
        s.execute(f"analyze table {name}")
        out[name] = time.perf_counter() - t
    return out


def start_server(domain):
    from tidb_tpu_torch.server import Server
    return Server(domain, host="127.0.0.1", port=0).start()


def counters(domain) -> dict:
    """The program's process-wide counters: the learning reruns, the
    MPP exchanges by type and the scan kernels' launches."""
    from tidb_tpu_torch.ops import scan_kernels
    from tidb_tpu_torch.utils import metrics as mu
    out = {k: domain.metrics.get(k, 0) for k in LEARNING}
    for key, child in mu.MPP_EXCHANGE.child_items():
        out["mpp_exchange." + key[0]] = child.value
    for k, v in dict(scan_kernels.COUNTS).items():
        out["launch." + k] = v
    return out


class StatementTimer:
    """Host-clock timers around the session's entries, for the traced
    run: every outermost `Session.execute` (the server's statement) and
    the `execute` span inside it (executor and copr), per connection in
    statement order. Installed before the clients connect."""

    def __init__(self, domain):
        from tidb_tpu_torch.session import Session
        self.by_conn: dict = {}
        self._tls = threading.local()
        self._cls = Session
        self._orig_execute = Session.execute
        self._tracer = domain.tracer
        self._orig_span = domain.tracer.span
        timer = self

        def execute(sess, *a, **kw):
            tls = timer._tls
            depth = getattr(tls, "depth", 0)
            if depth:
                return timer._orig_execute(sess, *a, **kw)
            tls.depth, tls.exec_s, tls.in_exec = 1, 0.0, 0
            t = time.perf_counter()
            try:
                return timer._orig_execute(sess, *a, **kw)
            finally:
                dur = time.perf_counter() - t
                tls.depth = 0
                timer.by_conn.setdefault(sess.conn_id, []).append(
                    (dur, tls.exec_s))

        class _Span:
            def __init__(self, name, a, kw):
                self.cm = timer._orig_span(name, *a, **kw)
                self.timed = name == "execute"

            def __enter__(self):
                tls = timer._tls
                # only the outermost execute span of a timed statement
                self.timed = self.timed and getattr(tls, "depth", 0) and \
                    not tls.in_exec
                if self.timed:
                    tls.in_exec = 1
                    self.t = time.perf_counter()
                return self.cm.__enter__()

            def __exit__(self, *exc):
                if self.timed:
                    timer._tls.exec_s += time.perf_counter() - self.t
                    timer._tls.in_exec = 0
                return self.cm.__exit__(*exc)

        def span(name, *a, **kw):
            return _Span(name, a, kw)

        Session.execute = execute
        domain.tracer.span = span

    def remove(self):
        self._cls.execute = self._orig_execute
        self._tracer.span = self._orig_span
