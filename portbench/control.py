"""The control of the check that decides `correct`: the reference put in
the program's place and computed in a lower precision than the
configuration states (exact decimals as scaled int64): float64, then
float32. For each seed it draws the cell's streams, makes its tables at
the configuration's scale, and counts the (stream, statement) answers
whose rows differ from the exact reference's. A control whose count is
above 0 fails the check, whose limit is 0 wrong row sets.

    python3 -m portbench.control --workload tpch_sf1.join --seeds 1,2,3

prints one JSON line per seed. NumPy only: it runs where the cell runs,
at the cell's own size, without the card."""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import gen, reference, run, traffic


def control_counts(workload, seed, bench=None, config_patch=None):
    """-> {precision: [statement names whose rows differ from exact]},
    each distinct statement and parameter set counted once."""
    bench = bench or run.load_json(run.ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    config = run.load_json(run.HERE, "configs", f"{wl['config']}.json")
    config.update(config_patch or {})
    mix = traffic.load(wl["traffic"])
    tables = gen.make_tables(traffic.tables_read(mix),
                             float(config["scale_factor"]), seed)
    out = {p: [] for p in reference.PRECISIONS if p != "exact"}
    seen = set()
    for stmts in traffic.streams(mix, seed):
        for st in stmts:
            key = (st["name"], json.dumps(st["params"], sort_keys=True))
            if key in seen:     # a cycle repeats its statements
                continue
            seen.add(key)
            ref = reference.statement(st["name"])
            exact = ref.rows(tables, st["params"], "exact")
            for p in out:
                if ref.rows(tables, st["params"], p) != exact:
                    out[p].append(st["name"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = control_counts(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "wrong": {p: len(v) for p, v in got.items()},
                          "statements": got,
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
