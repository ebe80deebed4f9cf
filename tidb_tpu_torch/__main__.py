"""CLI: `python -m tidb_tpu_torch` — interactive SQL shell on an
embedded store, `-e "<sql>"` for one statement, or `--serve` for the
MySQL-protocol server (reference cmd/tidb-server). Runs on the CUDA
device unless --cpu is given."""
from __future__ import annotations

import argparse


def repl(domain):
    from .session import Session
    sess = Session(domain)
    sess.vars.current_db = "test"
    print("tidb_tpu_torch SQL shell (embedded store). \\q to quit.")
    buf = ""
    while True:
        try:
            prompt = "tidb> " if not buf else "   -> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if line.strip() in ("\\q", "exit", "quit"):
            return
        buf += (" " if buf else "") + line
        if not buf.rstrip().endswith(";"):
            continue
        sql, buf = buf, ""
        try:
            rs = sess.execute(sql)
            if rs.names:
                widths = [max(len(n), 8) for n in rs.names]
                print(" | ".join(n.ljust(w) for n, w in zip(rs.names, widths)))
                print("-+-".join("-" * w for w in widths))
                for row in rs.rows:
                    print(" | ".join(
                        ("NULL" if v is None else str(v)).ljust(w)
                        for v, w in zip(row, widths)))
                print(f"{len(rs.rows)} row(s)")
            else:
                print(f"OK, {rs.affected} row(s) affected")
        except Exception as e:                       # noqa: BLE001
            print(f"ERROR: {e}")


def serve(domain, args):
    """Run the wire server (and the status port) until interrupted."""
    import time
    from .server import Server
    domain.start_background()
    srv = Server(domain, port=args.port, tls_cert=args.tls_cert,
                 tls_key=args.tls_key).start()
    print(f"listening on 127.0.0.1:{srv.port} (MySQL protocol)", flush=True)
    if args.status_port >= 0:
        from .server.status import start_status_server
        try:
            st = start_status_server(domain, port=args.status_port)
            print(f"status/metrics on 127.0.0.1:{st.bound_port}", flush=True)
        except OSError as e:
            # a busy status port (second instance on the default 10080)
            # must not take the SQL server down with it
            print(f"status port {args.status_port} unavailable ({e}); "
                  "/metrics disabled", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tidb_tpu_torch")
    ap.add_argument("--serve", action="store_true",
                    help="run the MySQL-protocol server")
    ap.add_argument("--port", type=int, default=4000,
                    help="server port (0 binds a free one and prints it)")
    ap.add_argument("--status-port", type=int, default=10080,
                    help="HTTP status/metrics port for --serve "
                         "(/metrics Prometheus exposition; -1 disables)")
    ap.add_argument("-e", "--execute", help="run one statement and exit")
    ap.add_argument("--data-dir", default=None,
                    help="persist commits to a WAL in this directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run the device path on the CPU (no CUDA)")
    ap.add_argument("--tls-cert", default=None,
                    help="PEM certificate enabling TLS on the wire")
    ap.add_argument("--tls-key", default=None)
    args = ap.parse_args(argv)
    from .session import new_store
    domain = new_store(args.data_dir, device="cpu" if args.cpu else None)
    if args.serve:
        serve(domain, args)
        return
    if args.execute:
        from .session import Session
        sess = Session(domain)
        sess.vars.current_db = "test"
        rs = sess.execute(args.execute)
        for row in rs.rows:
            print("\t".join("NULL" if v is None else str(v) for v in row))
        return
    repl(domain)


if __name__ == "__main__":
    main()
