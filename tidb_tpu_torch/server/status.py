"""HTTP status port (reference docs/tidb_http_api.md + pkg/metrics
Prometheus registry): /metrics (Prometheus text format), /status,
/schema, /slow_query, /stats. Copied from tidb_tpu's server/status.py;
/metrics exposes this package's own utils/metrics registry."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def start_status_server(domain, host="127.0.0.1", port=10080):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, body, ctype="application/json", code=200):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/metrics":
                from ..utils import metrics as metrics_util
                metrics_util.update_runtime_gauges(domain)
                body = metrics_util.REGISTRY.expose()
                # defensive compat tail: domain.metrics keys mutated
                # without inc_metric (so absent from the registry) still
                # surface, sanitized to the Prometheus charset — raw
                # dict keys must never make the page unscrapable
                exposed = {inst.name for inst
                           in metrics_util.REGISTRY.instruments()}
                merged: dict = {}
                for k, v in domain.metrics.items():
                    name = "tidb_tpu_" + metrics_util.sanitize_name(k)
                    if name in exposed:
                        continue
                    # distinct raw keys may sanitize identically: sum,
                    # never drop (a duplicate series is a format error)
                    merged[name] = merged.get(name, 0) + v
                extra = []
                for name, v in sorted(merged.items()):
                    extra.append(f"# TYPE {name} counter")
                    extra.append(
                        f"{name} {metrics_util.format_value(v)}")
                if extra:
                    body += "\n".join(extra) + "\n"
                self._send(body, "text/plain; version=0.0.4")
            elif path == "/status":
                self._send(json.dumps({
                    "connections": len(domain._live_execs),
                    "version": "8.0.11-tidb-tpu-0.1.0",
                    "git_hash": "none"}))
            elif path == "/schema":
                ischema = domain.infoschema()
                out = {db.name: [t.name for t in
                                 ischema.tables_in_schema(db.name)]
                       for db in ischema.all_schemas()}
                self._send(json.dumps(out))
            elif path == "/slow_query":
                self._send(json.dumps(domain.slow_log[-100:]))
            elif path == "/stats":
                out = {str(tid): {"rows": ts.row_count}
                       for tid, ts in domain.stats.items()}
                self._send(json.dumps(out))
            else:
                self._send(json.dumps({"error": "not found"}), code=404)

    srv = ThreadingHTTPServer((host, port), Handler)
    if port == 0:
        port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    srv.bound_port = port
    return srv
