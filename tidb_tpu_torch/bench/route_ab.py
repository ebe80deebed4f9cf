"""Wall time and route of TPC-H statements the fused pipeline declines
(Q9: sort aggregation after probes; Q17, Q21: materialized dims), on two
trees of the package in one call: this checkout and another one (the
parent commit unpacked with `git archive` into an ignored directory), in
the order other, this, this, other, each in its own process on the card.

For each tree and query it reports the cold statement and the median of
the warm ones (host clock around `must_query`, which ends in the rows on
the host), the host time each warm statement spends in the fused path
(`copr/pipeline.py:_fused_partials_inner`, which declines these plans:
what the tree's decline costs), the change of the routing counters over
the warm statements (fused fragments run, fused nodes that declined,
the host subtree's copr calls), the decline reasons of the last warm
statement, and a digest
of the rows; the digests of all runs must agree, or it exits non-zero.

Run from the repository root on a machine with one CUDA card:
    python -m tidb_tpu_torch.bench.route_ab [--parent _parent]
        [--sf 1.0] [--seed 7] [--runs 5] [--queries q9,q17,q21]
        [--out chiprun_out/route_ab.json]
Without --parent it measures this checkout once."""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
COUNTERS = ("fused_pipeline_hit", "fused_pipeline_fallback",
            "copr_host_exec")


def worker(root, sf, seed, runs, queries):
    """One tree: load TPC-H on the card, run each query cold then `runs`
    warm. -> record."""
    sys.path.insert(0, root)
    import torch
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.copr import pipeline
    inner, spent = pipeline._fused_partials_inner, [0.0]

    def timed_inner(*a, **k):
        t0 = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            spent[0] += time.perf_counter() - t0
    pipeline._fused_partials_inner = timed_inner
    set_reason, reasons = pipeline._set_reason, []

    def noted_reason(copr, msg):
        reasons.append(msg)
        return set_reason(copr, msg)
    pipeline._set_reason = noted_reason
    tk = TestKit()
    t0 = time.perf_counter()
    tpch.load_tpch(tk, sf=sf, seed=seed)
    rec = {"root": root, "load_s": time.perf_counter() - t0, "queries": {}}
    dom = tk.domain
    for q in queries:
        sql = tpch.ALL_QUERIES[q]
        times, fused = [], []
        for i in range(1 + runs):
            if i == 1:
                m0 = {c: dom.metrics.get(c, 0) for c in COUNTERS}
            spent[0] = 0.0
            reasons.clear()
            t0 = time.perf_counter()
            rows = tk.must_query(sql)._norm()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            fused.append(spent[0] * 1e3)
        rec["queries"][q] = {
            "cold_ms": times[0], "warm_ms": times[1:],
            "warm_median_ms": statistics.median(times[1:]),
            "warm_fused_path_ms": statistics.median(fused[1:]),
            "warm_counters": {c: dom.metrics.get(c, 0) - m0[c]
                              for c in COUNTERS},
            "warm_reasons": sorted(reasons),
            "rows": len(rows),
            "digest": hashlib.sha256(repr(rows).encode()).hexdigest()[:16]}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="q9,q17,q21")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "route_ab.json"))
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    queries = a.queries.split(",")
    if a.worker is not None:
        print("ROUTE_AB " + json.dumps(worker(a.worker, a.sf, a.seed,
                                               a.runs, queries)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("route_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = [ROOT] if a.parent is None else \
        [os.path.abspath(a.parent), ROOT, ROOT, os.path.abspath(a.parent)]
    recs = []
    for root in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root,
             "--sf", str(a.sf), "--seed", str(a.seed), "--runs",
             str(a.runs), "--queries", a.queries],
            capture_output=True, text=True, cwd=root)
        line = next((ln for ln in out.stdout.splitlines()
                     if ln.startswith("ROUTE_AB ")), None)
        if out.returncode or line is None:
            print(out.stdout[-4000:] + out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(line[len("ROUTE_AB "):])
        rec["tree"] = "this" if root == ROOT else "other"
        recs.append(rec)
        for q, r in rec["queries"].items():
            print(f"{rec['tree']} {q}: cold {r['cold_ms']:.1f} ms, warm "
                  f"median {r['warm_median_ms']:.1f} ms "
                  f"{[round(t, 1) for t in r['warm_ms']]}, fused path "
                  f"{r['warm_fused_path_ms']:.2f} ms, warm counters "
                  f"{json.dumps(r['warm_counters'])}, rows {r['rows']} "
                  f"{r['digest']}, declines {r['warm_reasons']}",
                  flush=True)
    bad = [q for q in queries
           if len({r["queries"][q]["digest"] for r in recs}) != 1]
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": card, "runs": recs, "rows_differ": bad}, f,
                  indent=1)
    if bad:
        print(f"route_ab: rows differ between runs for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
