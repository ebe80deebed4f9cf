"""A configuration, a traffic mix and a per-layer metric are added by new
files alone: in a copy of the harness, a new mix, a new configuration
and a new metric reader are found by the names a BENCHMARK.json gives
them, and no file that was there is edited."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT, SF

NEW_MIX = {"streams": 3, "loop": "closed", "statements": [
    {"name": "q6", "tables": ["lineitem"],
     "sql": "select sum(l_extendedprice * l_discount) as revenue from "
            "lineitem where l_shipdate >= date '{DATE}' and l_shipdate < "
            "date '{DATE}' + interval 1 year and l_discount between "
            "{DISCOUNT} - 0.01 and {DISCOUNT} + 0.01 and l_quantity < "
            "{QUANTITY}",
     "params": {"DATE": {"year_jan1": [1993, 1997]},
                "DISCOUNT": {"decimal": [2, 9], "scale": 2},
                "QUANTITY": {"int": [24, 25]}}}]}

NEW_METRIC = '''"""Statements per stream in the window."""


def read(ctx):
    streams = {s["stream"] for s in ctx["stmts"]}
    return len(ctx["stmts"]) / len(streams) if streams else None
'''


def _digests(root):
    out = {}
    for dp, _dn, fns in os.walk(root):
        for fn in fns:
            if "__pycache__" in dp:
                continue
            p = os.path.join(dp, fn)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_files_alone_add_a_cell_and_a_metric(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(pb)
    (pb / "traffic" / "q6_three.json").write_text(json.dumps(NEW_MIX))
    cfg = json.loads((pb / "configs" / "tpch_sf1.json").read_text())
    cfg.update(name="tpch_small", scale_factor=SF)
    (pb / "configs" / "tpch_small.json").write_text(json.dumps(cfg))
    (pb / "metrics" / "stmts_per_stream.py").write_text(NEW_METRIC)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tpch_small.q6_three",
                               "config": "tpch_small",
                               "traffic": "q6_three", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "qps":
            m["workloads"].append("tpch_small.q6_three")
    bench["per_layer"].append({"name": "stmts_per_stream", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["tpch_small.q6_three"]})
    code = ("import json, sys\nfrom portbench import run\n"
            f"bench = json.loads({json.dumps(json.dumps(bench))})\n"
            "res, code = run.run_cell('tpch_small.q6_three', 9, 3.0, True,"
            " device='cpu', bench=bench)\n"
            "print(json.dumps([code, res]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ,
                                  PYTHONPATH=f"{tmp_path}:{ROOT}"))
    assert out.returncode == 0, out.stderr[-3000:]
    code, res = json.loads(out.stdout.strip().splitlines()[-1])
    assert code == 0 and res["correct"], out.stderr[-2000:]
    assert res["metrics"]["stmts_per_stream"]["value"] > 0
    assert "scan_roofline" not in res["metrics"]
    after = _digests(pb)
    assert {k: after[k] for k in before} == before
