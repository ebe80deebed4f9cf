"""The metrics, end-to-end and per-layer, one reader per file, found by
the metric's name in BENCHMARK.json. Each has `read(ctx) -> float | None`: None where it
finds nothing to read, and the harness then leaves the metric out.

ctx: "seconds" (the window), "stmts" (per statement of the window: its
stream, name, start, end and client latency "lat_ms"), "completed",
"server" (per statement: the server's statement seconds, its execute
span's seconds and the client's latency seconds; traced runs), "trace"
(portbench.trace.Trace: busy_s, window_s, by_op; in an untraced run the
device's activity alone, where an end-to-end metric of the cell reads
it, else None), "delta" (the program's
counters over the window), "analyze_s" ({table: s}), "streams" (each
stream's statements with their parameters), "tables" (the generated
arrays), "workload", "setup_s"."""
