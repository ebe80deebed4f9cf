"""The one general generator of traffic. A mix is a data file,
`traffic/<name>.json`:

    {"streams": S, "loop": "closed",
     "statements": [{"name": "q6", "tables": [...], "sql": "... {DATE} ...",
                     "params": {"DATE": {"year_jan1": [1993, 1997]}, ...}},
                    ...]}

Each stream is one client connection. It runs its statements in a cycle,
in an order of its own, with one substitution set per statement, both
drawn once from the seed (TPC-H qgen fixes a stream's parameters the same
way). With "cycle_repeats": n the cycle holds each statement n times, in
an order drawn from the seed, so that streams do not settle into one
phase against each other. A parameter is drawn by one of these rules:

    {"int": [lo, hi]}                 a whole number, lo..hi
    {"decimal": [lo, hi], "scale": s} lo..hi as a decimal of scale s
    {"choice": [v, ...]}              one of the values
    {"year_jan1": [lo, hi]}           'YYYY-01-01' of a year lo..hi
    {"day_between": [d0, d1]}         a day d0..d1 ('YYYY-MM-DD')
    {"distinct": [v, ...], "names": [P1, P2, ...]}
                                      as many distinct values as names,
                                      each under its own name

Values are the text that goes into the SQL; the reference parses the
same text."""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_EPOCH = np.datetime64("1970-01-01", "D")


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    if mix.get("loop") != "closed":
        raise ValueError(f"traffic {name}: only closed loops are generated")
    if int(mix["streams"]) < 1 or not mix["statements"]:
        raise ValueError(f"traffic {name}: no streams or no statements")
    return mix


def tables_read(mix: dict) -> list:
    out = []
    for st in mix["statements"]:
        out += [t for t in st["tables"] if t not in out]
    return out


def _draw(rng, rule):
    if "int" in rule:
        lo, hi = rule["int"]
        return {"": str(int(rng.integers(lo, hi + 1)))}
    if "decimal" in rule:
        lo, hi = rule["decimal"]
        s = int(rule["scale"])
        v = int(rng.integers(lo, hi + 1))
        return {"": f"{v // 10 ** s}.{v % 10 ** s:0{s}d}"}
    if "choice" in rule:
        vals = rule["choice"]
        return {"": vals[int(rng.integers(0, len(vals)))]}
    if "year_jan1" in rule:
        lo, hi = rule["year_jan1"]
        return {"": f"{int(rng.integers(lo, hi + 1)):04d}-01-01"}
    if "day_between" in rule:
        d0, d1 = (np.datetime64(d, "D") for d in rule["day_between"])
        n = int((d1 - d0).astype(np.int64))
        return {"": str(d0 + np.timedelta64(int(rng.integers(0, n + 1)),
                                            "D"))}
    if "distinct" in rule:
        names = rule["names"]
        pick = rng.choice(len(rule["distinct"]), len(names), replace=False)
        return {n: rule["distinct"][int(i)] for n, i in zip(names, pick)}
    raise ValueError(f"unknown parameter rule {rule}")


def streams(mix: dict, seed: int) -> list:
    """-> one list per stream of {"name", "sql", "params"}, in the order
    the stream cycles them, drawn from `seed` alone."""
    out = []
    for s in range(int(mix["streams"])):
        rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7919, s])
        stmts = []
        for st in mix["statements"]:
            params = {}
            for pname, rule in st["params"].items():
                for sub, v in _draw(rng, rule).items():
                    params[sub or pname] = v
            stmts.append({"name": st["name"], "sql": " ".join(
                st["sql"].split()).format(**params), "params": params})
        reps = int(mix.get("cycle_repeats", 1))
        order = rng.permutation(len(stmts) * reps) % len(stmts)
        out.append([stmts[int(i)] for i in order])
    return out
