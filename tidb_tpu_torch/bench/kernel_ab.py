"""A/B of the scan kernels on one CUDA card: this tree's masked_sums,
dense_group_sums and range_filter_sums against another commit's, at the
main path's shapes (TPC-H SF1 lineitem, seed 7, per partition as
chip_smoke.py's main_path_inputs builds them), run in turns parent,
change, change, parent, each timed by CUDA events (warm median, inputs
read after an L2 flush, chip_smoke.time_ms) and by torch.profiler's
device time of the kernels. The other commit's scan_kernels.cu is built
with the same nvcc flags and called through that commit's own wrappers
(ops/scan_kernels.py, loaded beside this tree's). Also prints, per
build, the shared- and global-memory atomic instructions in each
kernel's SASS (cuobjdump).

range_filter_sums is timed twice on Q6's inputs: "range_filter_sums
fold", the other commit's path (the elementwise product
l_extendedprice * l_discount, then its kernel on the product column;
device time of both kernels) against this tree's kernel with the product
pair folded in; and "range_filter_sums", both kernels on the same
precomputed product column.

From the repository root, on a machine with the card and nvcc:

    mkdir -p _parent && git archive <commit> \\
        tidb_tpu_torch/ops/csrc/scan_kernels.cu \\
        tidb_tpu_torch/ops/scan_kernels.py | tar -x -C _parent
    python3 -m tidb_tpu_torch.bench.kernel_ab --parent _parent \\
        [--kernels masked_sums,dense_group_sums,range_filter_sums]

Writes chiprun_out/kernel_ab.json."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join("tidb_tpu_torch", "ops", "csrc", "scan_kernels.cu")
KERNELS = ("masked_sums", "dense_group_sums", "range_filter_sums")


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main_path(torch, cs):
    """TPC-H SF1 loaded on the card -> (chip_smoke.main_path_inputs'
    partitions, the L2 flush tensor for chip_smoke.time_ms)."""
    from ..testkit import TestKit
    from . import tpch
    t0 = time.perf_counter()
    tk = TestKit()
    tpch.load_tpch(tk, sf=cs.SF, seed=cs.SEED)
    parts = cs.main_path_inputs(tk)
    print(f"load SF{cs.SF}: {time.perf_counter() - t0:.1f} s", flush=True)
    return parts, torch.ones(cs.FLUSH_BYTES, dtype=torch.uint8,
                             device="cuda")


def build_parent(parent_root, out_dir):
    """nvcc the other commit's scan_kernels.cu -> its library path."""
    from ..ops import build
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libscan_kernels_parent.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                           os.path.join(parent_root, SRC)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's source:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    return so


def sass_atomics(so):
    """{kernel: {opcode: count}} of the atomic and reduction opcodes
    (ATOMS, ATOMG, ATOM, REDG, RED) in each function's SASS."""
    from ..ops import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=300)
    out, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", line)
        if m and fn is not None:
            out[fn][m.group(1)] = out[fn].get(m.group(1), 0) + 1
    return out


def parent_wrappers(parent_root, so):
    """The other commit's ops/scan_kernels.py as a module beside this
    tree's, its kernels' library the one built from its source."""
    import importlib.util
    from ..ops import build
    spec = importlib.util.spec_from_file_location(
        "tidb_tpu_torch.ops._ab_parent_scan_kernels",
        os.path.join(parent_root, "tidb_tpu_torch", "ops", "scan_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    load = build.load
    build.load = lambda name: ctypes.CDLL(so)
    try:
        mod._lib()
    finally:
        build.load = load
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of an unpacked archive of the other commit")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: choose from {','.join(KERNELS)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ..ops import build
    from ..ops import scan_kernels as sk
    card = card_name()
    print(f"card: {card}", flush=True)
    parent_so = build_parent(args.parent, os.path.join(
        "chiprun_out", "kernel_ab_build"))
    change_so = build.build("scan_kernels")
    _, log = build.BUILD_LOG.get("scan_kernels", (0.0, ""))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas (change): {line.strip()}")
    sass = {"parent": sass_atomics(parent_so),
            "change": sass_atomics(change_so)}
    for side, fns in sass.items():
        for fn, ops in fns.items():
            if ops:
                print(f"sass {side} {fn}: {json.dumps(ops)}")
    result = {"card": card, "sass": sass,
              "rows": run_ab(torch, cs, sk,
                             parent_wrappers(args.parent, parent_so),
                             kernels)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"card: {card}")
    return 0


def run_ab(torch, cs, sk, parent, kernels=KERNELS):
    """Each of `kernels` at each SF1 partition: parent, change, change,
    parent (CUDA events and profiler device time for each turn), the
    library call, the change's register path (unaligned views, dense
    only) and the bound (chip_smoke's sector count, distinct buffers
    once). `parent` is the other commit's wrapper module."""
    parts, flush = main_path(torch, cs)
    rows = []

    def same(a, b, what):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise RuntimeError(f"{what}: results differ")

    for p in parts:
        if "masked_sums" in kernels:
            rows.append(_ab_masked(torch, cs, sk, parent, p, flush, same))
        if "dense_group_sums" in kernels:
            rows.append(_ab_dense(torch, cs, sk, parent, p, flush, same))
        if "range_filter_sums" in kernels:
            rows.extend(_ab_range(cs, sk, parent, p, flush, same))
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


def _ab_masked(torch, cs, sk, parent, p, flush, same):
    n = p["n"]
    cols, mask = p["qsum"]
    stacked = torch.stack(cols)
    same(parent.masked_sums(cols, mask), sk.masked_sums(cols, mask),
         "masked_sums parent vs change")
    sides = {"parent": lambda: parent.masked_sums(cols, mask),
             "change": lambda: sk.masked_sums(cols, mask)}
    rec = turns(cs, sides, "masked_sums_kernel", flush)
    rec["library_ms"] = cs.time_ms(
        lambda: torch.where(mask, stacked, 0).sum(1), flush=flush)
    rec["bound_ms"] = (n + cs.sector_bytes(mask, cs.n_distinct(cols)) +
                       8 * (len(cols) + 1)) / cs.HBM_BYTES_PER_S * 1e3
    return {"kernel": "masked_sums", "n": n, "k": len(cols), **rec}


def _ab_dense(torch, cs, sk, parent, p, flush, same):
    n = p["n"]
    cols, slots, valid = p["q1"]
    stacked = torch.stack(cols)
    same(parent.dense_group_sums(cols, slots, 12, valid),
         sk.dense_group_sums(cols, slots, 12, valid),
         "dense_group_sums parent vs change")
    sides = {"parent": lambda: parent.dense_group_sums(cols, slots, 12,
                                                       valid),
             "change": lambda: sk.dense_group_sums(cols, slots, 12, valid)}
    rec = turns(cs, sides, "dense_group_sums_kernel", flush)
    # the register path: valid one byte on, the int64 buffers not, so
    # no head aligns them all (n - 1 rows)
    uv, us = valid[1:], slots[:-1]
    ucols = [c[:-1] for c in cols]
    same(sk.dense_group_sums(ucols, us, 12, uv),
         sk.dense_group_sums_plain(ucols, us, 12, uv),
         "dense_group_sums register path vs plain")
    rec["register_path_ms"] = cs.time_ms(
        lambda: sk.dense_group_sums(ucols, us, 12, uv), flush=flush)
    rec["register_path_device_ms"] = cs.device_ms(
        lambda: sk.dense_group_sums(ucols, us, 12, uv),
        "dense_group_sums_kernel", flush)
    live = valid & (slots >= 0) & (slots < 12)
    spill = torch.where(live, slots, 12)
    rec["library_ms"] = cs.time_ms(
        lambda: torch.zeros((len(cols), 13), dtype=torch.int64,
                            device="cuda").index_add_(1, spill, stacked),
        flush=flush)
    rec["bound_ms"] = (n + cs.sector_bytes(valid) +
                       cs.sector_bytes(live, cs.n_distinct(cols)) +
                       8 * (len(cols) + 1) * 12) / cs.HBM_BYTES_PER_S * 1e3
    return {"kernel": "dense_group_sums", "n": n, "k": len(cols), **rec}


def _ab_range(cs, sk, parent, p, flush, same):
    """Q6's range_filter_sums: the other commit's product pass + kernel
    against this tree's folded kernel, then both kernels on the same
    product column."""
    n = p["n"]
    sums, preds, bounds, valid, products = p["q6"]
    prod = [a * b for a, b in products]
    same(parent.range_filter_sums(sums + prod, preds, bounds, valid),
         sk.range_filter_sums(sums, preds, bounds, valid, products),
         "range_filter_sums parent (product pass) vs change (fold)")
    same(parent.range_filter_sums(sums + prod, preds, bounds, valid),
         sk.range_filter_sums(sums + prod, preds, bounds, valid),
         "range_filter_sums parent vs change on the product column")
    out = []
    sides = {"parent": lambda: parent.range_filter_sums(
        sums + [a * b for a, b in products], preds, bounds, valid),
        "change": lambda: sk.range_filter_sums(sums, preds, bounds, valid,
                                               products)}
    rec = turns(cs, sides, ("range_filter_sums", "MulFunctor"), flush)
    rec["bound_ms"] = cs.range_filter_bytes(
        sums, preds, bounds, valid, products)[0] / cs.HBM_BYTES_PER_S * 1e3
    out.append({"kernel": "range_filter_sums fold", "n": n,
                "k": len(sums) + len(products), **rec})
    sides = {"parent": lambda: parent.range_filter_sums(sums + prod, preds,
                                                        bounds, valid),
             "change": lambda: sk.range_filter_sums(sums + prod, preds,
                                                    bounds, valid)}
    rec = turns(cs, sides, "range_filter_sums", flush)
    rec["bound_ms"] = cs.range_filter_bytes(
        sums + prod, preds, bounds, valid)[0] / cs.HBM_BYTES_PER_S * 1e3
    out.append({"kernel": "range_filter_sums", "n": n, "k": len(prod),
                **rec})
    return out


def turns(cs, sides, kernel, flush):
    """parent, change, change, parent: CUDA-event ms and profiler device
    ms (of the kernels named `kernel`, chip_smoke.device_ms) of each turn
    -> {"<side>_ms": [..], "<side>_device_ms": [..]}."""
    rec = {}
    for side in ("parent", "change", "change", "parent"):
        fn = sides[side]
        rec.setdefault(f"{side}_ms", []).append(cs.time_ms(fn, flush=flush))
        rec.setdefault(f"{side}_device_ms", []).append(
            cs.device_ms(fn, kernel, flush))
    for side in ("parent", "change"):
        rec[f"{side}_median_ms"] = statistics.median(rec[f"{side}_ms"])
    return rec


if __name__ == "__main__":
    sys.exit(main())
