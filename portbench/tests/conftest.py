"""The benchmark's own tests: on the CPU (the port with device="cpu", at
SF0.01), a `cuda`-marked case for the card. Run from the repository
root: python3 -m pytest portbench/tests -q"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SF = 0.01
# the mesh engages below its default row floor only when told to
MPP_SESSION = {"tidb_enable_mpp": 1, "tidb_mpp_min_rows": 0}


# the MPP cell: its configuration and these CPU tests are in place, and
# it waits for its proof on the card before BENCHMARK.json lists it
MPP_CELL = {"name": "tpch_sf1_mpp4.join", "config": "tpch_sf1_mpp4",
            "traffic": "join", "chips": 1, "why": "the join mix with MPP on"}


def bench():
    """BENCHMARK.json, with the MPP cell added where it is not listed."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    if MPP_CELL["name"] not in {w["name"] for w in b["workloads"]}:
        b["workloads"].append(MPP_CELL)
    return b
