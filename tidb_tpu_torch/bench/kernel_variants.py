"""What bounds the scan kernels on one CUDA card: builds text variants of
this tree's ops/csrc/scan_kernels.cu and times each through this tree's
wrappers at the main path's shapes (TPC-H SF1 lineitem, seed 7, per
partition as chip_smoke.py's main_path_inputs builds them), every
variant twice, in the order given and then reversed; CUDA events
(chip_smoke.time_ms) and the profiler's device time of the kernel.

    tree             the source as it is
    ring_only        dense_group_sums' consumer warps wait for each tile
                     and free it without aggregating: the bulk-copy ring
                     alone (its sums are wrong)
    aggregate_only   dense_group_sums' producer copies the same two tiles
                     over and over, so they stay in L2: the aggregation
                     alone (its sums are wrong)
    blocks=N         dense_group_sums built for N blocks per SM
    masked_blocks=N  masked_sums built for N blocks per SM

From the repository root, on a machine with the card and nvcc:

    python3 -m tidb_tpu_torch.bench.kernel_variants tree ring_only \\
        aggregate_only blocks=2 blocks=3

Writes chiprun_out/kernel_variants.json."""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from .kernel_ab import ROOT, SRC, card_name, main_path

_CALL = "        group_rows(st[i] != 0, sl[i], x, k, nslots, wt);"
_ROW0 = "        const long long row0 = a.head + t * rows;"
_BLOCKS = "constexpr int gs_min_blocks(int kc) { return kc <= 8 ? 4 : 3; }"
_MS = "__global__ void __launch_bounds__(kThreads)\nmasked_sums_kernel"


def variant_source(src, name):
    """The text of variant `name` of scan_kernels.cu."""
    for anchor in (_CALL, _ROW0, _BLOCKS, _MS):
        if anchor not in src:
            raise ValueError(f"scan_kernels.cu no longer holds {anchor!r}")
    if name == "tree":
        return src
    if name == "ring_only":       # a.n < 0 never holds, warp-uniformly
        return src.replace(_CALL, "        if (a.n < 0)\n  " + _CALL)
    if name == "aggregate_only":
        return src.replace(_ROW0, _ROW0.replace("t * rows", "(t % 2) * rows"))
    if name.startswith("blocks="):
        n = int(name.split("=", 1)[1])
        return src.replace(_BLOCKS, "constexpr int gs_min_blocks(int kc) { "
                           f"return {n}; }}")
    if name.startswith("masked_blocks="):
        n = int(name.split("=", 1)[1])
        return src.replace(_MS, _MS.replace("(kThreads)", f"(kThreads, {n})"))
    raise ValueError(f"unknown variant {name!r}")


def build_variant(name, out_dir):
    """nvcc variant `name` -> (library path, ptxas register lines)."""
    from ..ops import build
    os.makedirs(out_dir, exist_ok=True)
    tag = name.replace("=", "")
    cu = os.path.join(out_dir, f"scan_kernels_{tag}.cu")
    with open(os.path.join(ROOT, SRC)) as f:
        src = f.read()
    with open(cu, "w") as f:
        f.write(variant_source(src, name))
    so = os.path.join(out_dir, f"libscan_kernels_{tag}.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                           cu], capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
    return so, [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv) or ["tree"]
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ..ops import build
    from ..ops import scan_kernels as sk
    card = card_name()
    print(f"card: {card}", flush=True)
    libs, ptxas = {}, {}
    for name in names:
        so, ptxas[name] = build_variant(name, os.path.join(
            "chiprun_out", "kernel_variants_build"))
        print(f"{name}: {ptxas[name]}", flush=True)
        load = build.load
        build.load = lambda _name, so=so: ctypes.CDLL(so)
        try:
            libs[name] = sk._load_lib()
        finally:
            build.load = load
    parts, flush = main_path(torch, cs)
    rows = {}
    try:
        for name in names + names[::-1]:
            sk._FNS["lib"] = libs[name]
            for p in parts:
                cols, slots, valid = p["q1"]
                cm, mask = p["qsum"]
                runs = {
                    "dense_group_sums": (
                        lambda: sk.dense_group_sums(cols, slots, 12, valid),
                        lambda: sk.dense_group_sums_plain(cols, slots, 12,
                                                          valid)),
                    "masked_sums": (lambda: sk.masked_sums(cm, mask),
                                    lambda: sk.masked_sums_plain(cm, mask))}
                for kern, (fn, plain) in runs.items():
                    r = rows.setdefault(f"{name} {kern} n={p['n']}", {
                        "exact": all(torch.equal(a, b)
                                     for a, b in zip(fn(), plain())),
                        "ms": [], "device_ms": []})
                    r["ms"].append(cs.time_ms(fn, flush=flush))
                    r["device_ms"].append(cs.device_ms(
                        fn, f"{kern}_kernel", flush))
    finally:
        sk._FNS.pop("lib", None)
    for key, r in rows.items():
        print(key, json.dumps(r), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_variants.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "rows": rows}, f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
