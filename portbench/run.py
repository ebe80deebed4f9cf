"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`); the per-layer metrics are readers of their
own (`metrics/<metric>.py`); `BENCHMARK.json` at the root ties them.

In order: make the tables the mix reads from the seed (`gen.py`),
bulk-load them into tidb_tpu_torch on the card, ANALYZE them, start its
MySQL wire server on a free loopback port, spawn one client process per
stream (`client.py`), warm every statement of every stream until the
fused fragment's learning counters stop moving, open the window at a
barrier, run the closed loop for --seconds, then free the program and
judge every row set the window returned against the NumPy reference
(`reference/`). The last line of standard output is the result; the
lines before it on standard error end with each number compared beside
its limit."""
from __future__ import annotations

import time

# set-up is counted from here: the interpreter has just started, and the
# imports of torch and the program, and the device's context, are set-up
T_IMPORT = time.perf_counter()

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's build and kernel caches, fixed inside the checkout so
# that only a cell's first run there builds
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tidb_tpu")
MAX_WARM_ROUNDS = 8


def log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def process_env():
    """The run's process settings, before torch is imported: one
    intra-op thread (the server's connection threads each run torch's
    host copies, and a thread pool per caller oversubscribes the cores
    they share), and the program's caches inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def blocking_sync():
    """Have a host thread that waits for the card sleep on a
    synchronisation primitive (cudaDeviceScheduleBlockingSync) rather
    than spin on a core: the server's connection threads wait in every
    statement's fetch, and spinning waiters take the cores the thread
    holding the interpreter lock needs. Set before the first CUDA
    context is made, in the CUDA runtime torch has loaded.
    -> the device flags read back once the context exists."""
    import ctypes
    import torch
    torch.cuda.init()
    with open("/proc/self/maps") as f:
        libs = sorted({ln.split()[-1] for ln in f if "libcudart" in ln})
    if not libs:
        raise RuntimeError("the CUDA runtime is not loaded")
    rt = ctypes.CDLL(libs[0])
    rc = rt.cudaSetDeviceFlags(ctypes.c_uint(0x04))
    if rc != 0:
        raise RuntimeError(f"cudaSetDeviceFlags returned {rc}")
    torch.zeros(1, device="cuda")
    flags = ctypes.c_uint(0)
    rt.cudaGetDeviceFlags(ctypes.byref(flags))
    return flags.value


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class GcPause:
    """The interpreter's collections while it is installed: count,
    seconds, and how many were of the oldest generation."""

    def __init__(self):
        self.n, self.s, self.gen2, self._t = 0, 0.0, 0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t
            self.gen2 += info.get("generation") == 2

    def remove(self):
        gc.callbacks.remove(self._cb)


class Cell:
    """One cell's system, clients and window. `bench` is BENCHMARK.json
    as a dict."""

    def __init__(self, bench, workload, seed, device="cuda",
                 config_patch=None):
        from . import traffic
        wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
        if wl is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.bench, self.wl, self.seed = bench, wl, seed
        self.end_to_end = in_cell(bench["end_to_end"], workload)
        self.per_layer = in_cell(bench["per_layer"], workload)
        self.device = device
        self.config = load_json(HERE, "configs", f"{wl['config']}.json")
        self.config.update(config_patch or {})
        self.mix = traffic.load(wl["traffic"])
        self.streams = traffic.streams(self.mix, seed)
        self.table_names = traffic.tables_read(self.mix)
        self.clients = []
        self.timer = None

    # ---- set-up ----------------------------------------------------
    def setup(self, trace):
        from . import gen, sut
        t = time.perf_counter()
        self.tables = gen.make_tables(self.table_names,
                                      float(self.config["scale_factor"]),
                                      self.seed)
        self.gen_s = time.perf_counter() - t
        t = time.perf_counter()
        self.domain = sut.make_domain(self.device,
                                      int(self.config["shards"]))
        sut.load(self.domain, self.tables, gen.DDL)
        self.load_s = time.perf_counter() - t
        self.analyze_s = sut.analyze(self.domain, self.table_names)
        if trace:
            self.timer = sut.StatementTimer(self.domain)
        self.server = sut.start_server(self.domain)
        log(f"set-up: tables {self.gen_s:.3f} s, load {self.load_s:.3f} s,"
            " analyze " + ", ".join(f"{k} {v:.3f} s"
                                    for k, v in self.analyze_s.items()) +
            f"; server on 127.0.0.1:{self.server.port}")

    def spawn(self):
        """Start one client process per stream; -> when all are ready."""
        env = dict(os.environ, PYTHONPATH=ROOT)
        session = [f"set @@{k} = {v}"
                   for k, v in self.config.get("session", {}).items()]
        for stmts in self.streams:
            p = subprocess.Popen(
                [sys.executable, "-m", "portbench.client"], cwd=ROOT,
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
            self.clients.append(p)
            self._send(p, {"port": self.server.port, "session": session,
                           "statements": stmts})
        self.conn_ids = [self._recv(p)["ready"] for p in self.clients]

    @staticmethod
    def _send(p, obj):
        p.stdin.write(json.dumps(obj) + "\n")
        p.stdin.flush()

    @staticmethod
    def _recv(p):
        line = p.stdout.readline()
        if not line:
            raise RuntimeError(f"client {p.pid} ended (code {p.wait()})")
        return json.loads(line)

    def counters(self):
        from . import sut
        return sut.counters(self.domain)

    def warm(self):
        """Every client runs each of its statements once, together, until
        a round moves no learning counter. -> rounds run."""
        from .sut import LEARNING
        for r in range(1, MAX_WARM_ROUNDS + 1):
            c0 = self.counters()
            for p in self.clients:
                self._send(p, {"cmd": "warm"})
            ms = [self._recv(p)["warm_ms"] for p in self.clients]
            c1 = self.counters()
            moved = {k: c1[k] - c0[k] for k in LEARNING if c1[k] != c0[k]}
            log(f"warm round {r}: learning {moved or 'none'}; ms " +
                json.dumps([[round(x, 1) for x in m] for m in ms]))
            if r >= 2 and not moved:
                return r
        return MAX_WARM_ROUNDS

    def window(self, seconds, trace):
        """Open the window at a barrier and run the loop. -> the clients'
        replies, the counters before and after, the window (t0, t1) on
        time.monotonic(), the Trace or None. An untraced run records the
        device's activity alone where an end-to-end metric of the cell
        is read from it."""
        import torch
        from .trace import Trace
        tr = None
        gc.collect()
        if trace:
            tr = Trace(self.device).start()
        elif self.device != "cpu" and any(
                m["source"] == "device_trace" for m in self.end_to_end):
            tr = Trace(self.device, host=False).start()
        elif self.device != "cpu":
            torch.cuda.synchronize()
        c0 = self.counters()
        gc_pause = GcPause()
        cpu0 = time.process_time()
        t0 = time.monotonic() + 0.25
        t1 = t0 + seconds
        for p in self.clients:
            self._send(p, {"cmd": "run", "t0": t0, "t1": t1})
        replies = [self._recv(p) for p in self.clients]
        c1 = self.counters()
        cpu = time.process_time() - cpu0
        gc_pause.remove()
        if tr is not None:
            tr.stop()
        log(f"window host: server process cpu {cpu:.3f} s, gc "
            f"{gc_pause.n} collections {gc_pause.s:.4f} s (gen2 "
            f"{gc_pause.gen2}), load average {os.getloadavg()[0]:.2f}")
        return replies, c0, c1, (t0, t1), tr

    def close(self):
        """Stop the clients and the server and free the program."""
        for p in self.clients:
            try:
                self._send(p, {"cmd": "quit"})
            except OSError:
                pass
        for p in self.clients:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.clients = []
        if getattr(self, "server", None) is not None:
            self.server.shutdown()
            self.server = None
        if self.timer is not None:
            self.timer.remove()
        self.domain = None
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()


def judge(cell, replies, precision="exact"):
    """Every row set of the window against the reference. -> (wrong
    statements, error statements, notes)."""
    from . import reference
    wrong = errors = 0
    notes = []
    cache = {}
    for s, rep in enumerate(replies):
        stmts = cell.streams[s]
        for k, msgs in rep["errors"].items():
            errors += len(msgs)
            notes.append(f"stream {s} {stmts[int(k)]['name']}: "
                         f"{len(msgs)} errors, first {msgs[0]!r}")
        for k, seen in rep["rows"].items():
            st = stmts[int(k)]
            key = (st["name"], json.dumps(st["params"], sort_keys=True))
            if key not in cache:
                ref = reference.statement(st["name"]).rows(
                    cell.tables, st["params"], precision)
                cache[key] = json.dumps([list(r) for r in ref])
            for got, n in seen.items():
                if got != cache[key]:
                    wrong += n
                    notes.append(f"stream {s} {st['name']} {st['params']}:"
                                 f" {n} x rows {got[:300]} != reference "
                                 f"{cache[key][:300]}")
    return wrong, errors, notes


def window_stats(cell, replies, t0, t1):
    """-> the window's statements as dicts, the completed count."""
    stmts = []
    for s, rep in enumerate(replies):
        for k, start, end in rep["log"]:
            stmts.append({"stream": s, "k": k,
                          "name": cell.streams[s][k]["name"],
                          "start": start, "end": end,
                          "lat_ms": (end - start) * 1e3})
    done = sum(1 for st in stmts if st["end"] <= t1)
    return stmts, done


def per_5s(stmts, t0, seconds):
    """-> statements completed in each 5 s of the window."""
    return [sum(1 for st in stmts if t0 + i < st["end"] <= t0 + i + 5)
            for i in range(0, int(seconds), 5)]


def server_pairs(cell, replies):
    """-> per window statement (server statement s, execute span s,
    client latency s), paired by connection and statement order."""
    if cell.timer is None:
        return None
    out = []
    for cid, rep in zip(cell.conn_ids, replies):
        srv = cell.timer.by_conn.get(cid, [])
        mine = srv[rep["first"]:rep["first"] + len(rep["log"])]
        for (stmt_s, exec_s), (_k, start, end) in zip(mine, rep["log"]):
            out.append((stmt_s, exec_s, end - start))
    return out


def in_cell(entries, workload):
    """The metrics of BENCHMARK.json's list `entries` that the cell
    reports: those whose `workloads` name it, and those with none."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


def read_metrics(entries, ctx):
    """Each metric's reader (`metrics/<name>.py`) over the run; a
    reader that finds nothing leaves its metric out."""
    out = {}
    for m in entries:
        v = importlib.import_module(
            f"portbench.metrics.{m['name']}").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(workload, seed, seconds, trace, device="cuda", bench=None,
             config_patch=None, t_start=None):
    """One run of one cell; set-up counts from `t_start` (perf_counter),
    by default from the call. -> (result dict, exit code)."""
    if t_start is None:
        t_start = time.perf_counter()
    import torch
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, workload, seed, device=device,
                config_patch=config_patch)
    chips = int(cell.wl["chips"])
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    try:
        cell.setup(trace)
        cell.spawn()
        rounds = cell.warm()
        setup_s = time.perf_counter() - t_start
        replies, c0, c1, (t0, t1), tr = cell.window(seconds, trace)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        pairs = server_pairs(cell, replies)
    finally:
        cell.close()
    stmts, done = window_stats(cell, replies, t0, t1)
    delta = {k: c1[k] - c0.get(k, 0) for k in c1}
    learning = {k: delta[k] for k in c1 if k in
                ("fused_compact_regrow", "fused_runs_degrade",
                 "fused_bucket_regrow", "fused_topn_off",
                 "fused_onehot_miss")}
    n = max(len(stmts), 1)
    log(f"window: {len(stmts)} statements started, {done} completed in "
        f"{seconds} s ({done / seconds} stmt/s); warm rounds {rounds}")
    log("window: completed per 5 s " + json.dumps(
        per_5s(stmts, t0, seconds)) + ", per statement " +
        json.dumps({n: sum(1 for st in stmts if st["name"] == n)
                    for n in sorted({st["name"] for st in stmts})}))
    log("window check: learning counter deltas " + json.dumps(learning) +
        ("" if not any(learning.values()) else
         " -- the window ran a statement cold"))
    log("window check: scan kernel launches per statement " + json.dumps(
        {k[7:]: delta[k] / n for k in delta if k.startswith("launch.")}) +
        "; mpp exchanges " + json.dumps(
            {k[13:]: delta[k] for k in delta
             if k.startswith("mpp_exchange.")}))
    t = time.perf_counter()
    wrong, errors, notes = judge(cell, replies)
    log(f"reference: {time.perf_counter() - t:.3f} s")
    for note in notes[:20]:
        log("mismatch: " + note)
    ctx = {"seconds": seconds, "stmts": stmts, "completed": done,
           "server": pairs, "trace": tr, "delta": delta,
           "analyze_s": cell.analyze_s, "streams": cell.streams,
           "tables": cell.tables, "workload": workload, "setup_s": setup_s}
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           ctx)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None, 4
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu"
           else "cpu", "count": chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        if trace:
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        log(f"trace{'' if trace else ' (device alone)'}: {tr.events} "
            f"device events, busy {tr.busy_s:.6f} s of {tr.window_s:.3f} s,"
            f" reduced in {tr.reduce_s:.3f} s")
    checks = {"wrong_row_sets": {"value": wrong, "limit": 0},
              "statement_errors": {"value": errors, "limit": 0}}
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    result = {"correct": wrong == 0 and errors == 0 and done > 0,
              "attempted": len(stmts), "failed": wrong + errors,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result, 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    process_env()
    bench = load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if wl is None:
        log(f"no workload {args.workload!r}")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        log(f"needs {wl['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"device flags {blocking_sync():#x}, torch threads "
        f"{torch.get_num_threads()}")
    result, code = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), bench=bench,
                            t_start=T_IMPORT)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
