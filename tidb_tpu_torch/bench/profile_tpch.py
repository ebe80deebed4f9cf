"""Where a TPC-H statement's time goes on the card: Q6, Q1 and the join
queries Q3 and Q5 by default, or any of the 22 or of the executor
statements of bench/tpch.py EXECUTOR_CASES at SF1, through TestKit on
CUDA, cold once and then warm. It
is the trace tool a performance change starts from (chip_smoke.py
checks, this explains), and it runs the sizes chip_smoke.py does not:
`--sf 10` is Q1's size in BASELINE.md.

It reports the load's wall time and the process's peak resident memory
after the load and at the end, and checks each query's rows against the
numpy oracle (bench/tpch.py) or, at SF1, the committed reference rows
(bench/tpch_sf1_expected.json; an executor statement: its count and
digest in bench/executor_sf1_expected.json), failing on a mismatch. For
each query
  - the warm wall time per statement (host clock around work that ends
    in torch.cuda.synchronize) and lineitem rows scanned per second;
  - the device's busy time over the same statements under
    torch.profiler (the union of the CUDA kernel and copy intervals),
    hence its idle share, the device time by kernel name and by op
    class (gathers, scatters, searchsorted, sorts, cumsum/cummax scans,
    the scan kernels, copies, the rest), and the elementwise multiplication kernels per
    statement (Q6 folds its product into range_filter_sums, so it has
    none);
  - one warm statement's phase counters: fragment dispatches, host
    syncs, the bytes fetched from the card and the time spent waiting
    for them (fetch_bytes, sync_s), uploads;
  - a host breakdown from cProfile: cumulative seconds per statement in
    the engine's stages (analyze, snapshot, upload, fragment enqueue,
    kernel wrappers, fetch + compaction, final merge). cProfile slows
    Python code and not native code, so the shares lean towards Python.

`--shards 4` runs the statements on the MPP mesh: the Domain's mesh is
that many shards of the card, so each fused or reader aggregation is one
mesh program (chip_smoke.py phase_mpp's cell).

Run from the repository root on a machine with one CUDA card:
    python -m tidb_tpu_torch.bench.profile_tpch [--sf 1.0] [--seed 7]
        [--runs 5] [--queries q6,q1,q3,q5] [--shards 1]
        [--out chiprun_out/profile_tpch.json]
It prints one line per measurement and writes the whole record as JSON
to --out. Without a CUDA device it exits non-zero."""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import resource
import statistics
import subprocess
import sys
import time

QUERY_MEM_QUOTA = 32 << 30     # bytes, per statement

# (label, file suffix, function name) of the host stages
STAGES = [
    ("stats_analyze", "stats/analyze.py", "analyze_one"),
    ("fused_partials", "copr/pipeline.py", "_fused_partials_inner"),
    ("snapshot", "storage/columnar.py", "snapshot"),
    ("dim_meta", "copr/pipeline.py", "_dim_sort_meta"),
    ("dim_upload", "copr/pipeline.py", "_upload_dim"),
    ("upload", "copr/dag_exec.py", "_pad_upload"),
    ("fragment_enqueue", "copr/pipeline.py", "body"),
    ("dim_probe_enqueue", "copr/pipeline.py", "_apply_dims"),
    ("masked_sums_wrapper", "ops/scan_kernels.py", "masked_sums"),
    ("dense_group_sums_wrapper", "ops/scan_kernels.py", "dense_group_sums"),
    ("range_filter_sums_wrapper", "ops/scan_kernels.py", "range_filter_sums"),
    ("fetch_and_compact", "copr/dag_exec.py", "_compact_dense"),
    ("fetch_and_compact_posdense", "copr/pipeline.py",
     "_compact_pos_dense"),
    # every kind's consume: the sort kind's group-count checks and
    # slicing of its partials to ngroups, the dense decodes above
    ("consume", "copr/pipeline.py", "_consume"),
    ("final_merge", "executor/executors.py", "_merge_partials"),
    # the MPP mesh (--shards): the fused route's sharded binds and its
    # program (every shard's body, then the collective)
    ("mesh_fused", "copr/pipeline.py", "_run_fused_mpp"),
    ("mesh_program", "parallel/mesh.py", "program"),
    # a materialized dim's subplan (a hit costs the lookup alone) and
    # the reader DAGs on the card
    ("matdim", "copr/pipeline.py", "_materialized_dim_meta"),
    ("reader_dag", "copr/dag_exec.py", "_execute_device_inner"),
    # the executor's device hooks (uploads, program and fetch) and the
    # host work around them
    ("sort_key_arrays", "executor/executors.py", "_sort_key_arrays"),
    ("sort_hook", "executor/sort_device.py", "device_sort_permutation"),
    ("window_hook", "executor/window_device.py", "run_window_device"),
    ("join_hook", "ops/device_join.py", "device_join_index"),
    ("join_emit", "executor/executors.py", "_emit"),
]


def _stage_seconds(prof, nstmts):
    """-> {label: cumulative seconds per statement} from a cProfile."""
    st = pstats.Stats(prof).stats
    out = {}
    for label, suffix, fn in STAGES:
        tot = 0.0
        for (path, _line, name), (_cc, _nc, _tt, ct, _callers) in st.items():
            if name != fn or not path.replace(os.sep, "/").endswith(suffix):
                continue
            # functions of one name in one file: the outermost is the stage
            tot = max(tot, ct)
        out[label] = tot / nstmts
    return out


def _busy_us(events):
    """Union length (us) of the intervals of device-side events."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


# op classes of device kernel names, first match wins: (class, name
# fragments)
OP_CLASSES = [
    ("scan_kernels", ("masked_sums", "dense_group_sums",
                      "range_filter_sums")),
    ("copies", ("Memcpy", "Memset", "memcpy", "memset")),
    ("searchsorted", ("searchsorted",)),
    ("sorts", ("RadixSort", "radixSort", "sort_", "Sort")),
    ("scans", ("Scan", "scan")),
    ("scatter", ("indexFunc", "index_add", "scatter", "Scatter")),
    ("gathers", ("index_elementwise", "Index", "gather", "Gather")),
]


def _op_class(name):
    for cls, frags in OP_CLASSES:
        if any(f in name for f in frags):
            return cls
    return "elementwise_and_other"


def _device_profile(torch, run, nstmts):
    """Run `run` under torch.profiler -> (wall s, busy s or None,
    [(kernel name, device ms per statement, calls per statement)], the
    elementwise multiplication kernels (torch's MulFunctor) per
    statement, {op class: device ms per statement})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return wall, None, [], None, {}
    by = {}
    for e in dev:
        ms, n = by.get(e.name, (0.0, 0))
        by[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                      n + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:12]
    muls = sum(n for name, (_ms, n) in by.items() if "MulFunctor" in name)
    classes = {}
    for name, (ms, _n) in by.items():
        cls = _op_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms / nstmts
    return wall, _busy_us(dev) / 1e6, [
        (name[:90], ms / nstmts, n / nstmts) for name, (ms, n) in top], \
        muls / nstmts, classes


def _peak_rss_gib():
    """Peak resident memory of this process so far (Linux: KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="q6,q1,q3,q5",
                    help="comma-separated TPC-H queries (q1..q22) or "
                    "executor statements (bench/tpch.py EXECUTOR_CASES, "
                    "SF1 only); at SF1 each is checked against the "
                    "committed rows, at other scale factors only q6, "
                    "q1, q3 and q5, against their numpy oracles")
    ap.add_argument("--shards", type=int, default=1,
                    help="MPP mesh shards on the card (1: no mesh)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                   "profile_tpch.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_tpch: no CUDA device", file=sys.stderr)
        return 2
    from ..testkit import TestKit
    from ..utils import phase
    from . import tpch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    tk = TestKit(mesh=args.shards if args.shards > 1 else None)
    # a cold statement's column upload counts against its memory quota,
    # as in the reference: at SF10 Q6 uploads 1.9 GB, past the 1 GiB
    # default, so the session takes the quota an analytical deployment
    # of that size sets
    tk.must_exec(f"set tidb_mem_quota_query = {QUERY_MEM_QUOTA}")
    t0 = time.perf_counter()
    tpch.load_tpch(tk, sf=args.sf, seed=args.seed)
    load_s = time.perf_counter() - t0
    tbl = tk.domain.infoschema().table_by_name("test", "lineitem")
    nrows = tk.domain.columnar.tables[tbl.id].n
    rec = {"card": card, "sf": args.sf, "seed": args.seed,
           "shards": args.shards,
           "lineitem_rows": nrows, "runs": args.runs, "load_s": load_s,
           "peak_rss_gib_after_load": _peak_rss_gib(), "queries": {}}
    print(f"load SF{args.sf} seed {args.seed}: {nrows} lineitem rows in "
          f"{load_s:.1f} s, peak RSS {rec['peak_rss_gib_after_load']:.2f} "
          "GiB", flush=True)
    oracles = {"q6": tpch.q6_oracle, "q1": tpch.q1_oracle,
               "q3": tpch.q3_oracle, "q5": tpch.q5_oracle}
    queries = dict(tpch.ALL_QUERIES)
    queries.update({c[0]: c[1] for c in tpch.EXECUTOR_CASES})
    if args.sf == 1.0:
        here = os.path.dirname(__file__)
        with open(os.path.join(here, "tpch_sf1_expected.json")) as f:
            committed = json.load(f)
        for q in tpch.ALL_QUERIES:
            oracles.setdefault(q, lambda _tk, _w=committed[q]: [
                tuple(r) for r in _w])
        with open(os.path.join(here, "executor_sf1_expected.json")) as f:
            digests = json.load(f)
        for c in tpch.EXECUTOR_CASES:
            # compared as (row count, digest) of the rows
            oracles[c[0]] = lambda _tk, _d=digests[c[0]]: (
                _d["rows"], _d["sha256"])
    executor = {c[0] for c in tpch.EXECUTOR_CASES}
    for q in args.queries.split(","):
        if q not in oracles:
            print(f"profile_tpch: no rows to check {q} against at "
                  f"SF{args.sf}", file=sys.stderr)
            return 2
        sql = queries[q]
        r = rec["queries"][q] = {}
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        rows = tk.must_query(sql)._norm()
        prof.disable()
        r["cold_ms_under_cprofile"] = (time.perf_counter() - t0) * 1e3
        if q in executor:
            rows = (len(rows), tpch.rows_digest(rows))
        if rows != oracles[q](tk):
            print(f"profile_tpch: {q} rows {rows} != the expected ones",
                  file=sys.stderr)
            return 1
        r["cold_stage_ms"] = {k: v * 1e3 for k, v in
                              _stage_seconds(prof, 1).items()}
        for _ in range(2):
            tk.must_query(sql)
        walls = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tk.must_query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        r["warm_ms"] = walls
        r["warm_ms_median"] = statistics.median(walls)
        r["rows_per_s"] = nrows / (r["warm_ms_median"] / 1e3)
        phase.reset()
        tk.must_query(sql)
        # one warm statement's counters; phase.snap gives times in ms
        r["warm_phase"] = {(k[:-2] + "_ms" if k.endswith("_s") else k): v
                           for k, v in phase.snap().items()
                           if isinstance(v, (int, float))}
        r["fused_pipeline_hit"] = tk.domain.metrics.get(
            "fused_pipeline_hit", 0)
        r["fused_pipeline_mpp_hit"] = tk.domain.metrics.get(
            "fused_pipeline_mpp_hit", 0)
        r["last_fused_reason"] = tk.domain.last_fused_reason

        def run():
            for _ in range(args.runs):
                tk.must_query(sql)
        wall, busy, top, muls, classes = _device_profile(torch, run,
                                                         args.runs)
        r["mul_kernels_per_stmt"] = muls
        r["device_ms_by_op_class"] = classes
        r["profiled_wall_ms_per_stmt"] = wall * 1e3 / args.runs
        if busy is None:
            r["device_busy_ms_per_stmt"] = None
            r["device_idle_share"] = None
        else:
            r["device_busy_ms_per_stmt"] = busy * 1e3 / args.runs
            r["device_idle_share"] = 1.0 - busy / wall
        r["device_top"] = top
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        run()
        torch.cuda.synchronize()
        prof.disable()
        r["warm_ms_under_cprofile"] = (time.perf_counter() - t0) * 1e3 / \
            args.runs
        r["warm_stage_ms"] = {k: v * 1e3 for k, v in
                              _stage_seconds(prof, args.runs).items()}
        print(f"{q}: warm {r['warm_ms_median']:.3f} ms median of "
              f"{args.runs} ({', '.join(f'{w:.3f}' for w in walls)}), "
              f"{r['rows_per_s']:.4g} lineitem rows/s", flush=True)
        if busy is None:
            print(f"{q}: device busy not measured (the profiler saw no "
                  "device events)", flush=True)
        else:
            print(f"{q}: device busy {r['device_busy_ms_per_stmt']:.3f} ms "
                  f"of {r['profiled_wall_ms_per_stmt']:.3f} ms per "
                  f"statement under the profiler, idle share "
                  f"{r['device_idle_share']:.4f}", flush=True)
        print(f"{q}: elementwise multiplication kernels per statement: "
              f"{'not measured' if muls is None else f'{muls:g}'}",
              flush=True)
        for name, ms, calls in top:
            print(f"{q}:   device {ms:.4f} ms/stmt {calls:g} calls/stmt "
                  f"{name}", flush=True)
        print(f"{q}: device ms/stmt by op class " + ", ".join(
            f"{k}={v:.4f}" for k, v in sorted(classes.items())), flush=True)
        wp = r["warm_phase"]
        print(f"{q}: warm phase " + ", ".join(
            f"{k}={wp.get(k, 0)}" for k in (
                "dispatches", "syncs", "fetches", "fetch_bytes", "sync_ms",
                "upload_bytes", "mask_upload_bytes",
                "hook_upload_bytes")) +
            f"; fused hits so far {r['fused_pipeline_hit']} (on the mesh "
            f"{r['fused_pipeline_mpp_hit']}), last "
            f"decline {r['last_fused_reason']}", flush=True)
        for phase_name in ("cold_stage_ms", "warm_stage_ms"):
            print(f"{q}: {phase_name} " + ", ".join(
                f"{k}={v:.3f}" for k, v in r[phase_name].items()),
                flush=True)
    rec["peak_rss_gib_end"] = _peak_rss_gib()
    print(f"peak RSS {rec['peak_rss_gib_end']:.2f} GiB", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
