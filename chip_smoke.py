"""Chip smoke test of tidb_tpu_torch on one CUDA card: builds the
hand-written kernels, holds each against its plain PyTorch version,
times them, then runs TPC-H Q6, Q1 and a global aggregate without range
filters at SF1 from SQL to rows through the package's normal entry point
(TestKit on the card), then the join queries whose fused fragments probe
dimension tables on the card (Q3, Q4, Q5, Q10, Q12, Q14, Q19, Q22, and
the sort-kind group-bys Q2, Q7, Q8, Q9, Q11, Q15, Q16, Q18, Q20 and Q20
without its nation predicate; Q3 and Q10 aggregate as runs on the card),
the queries with a fused node the port does not fuse yet (Q13, Q17,
Q21), and Q6, Q1, the global aggregate, Q3 and Q5 again through the
package's MySQL wire server, with a raw-socket client. Every statement's
rows are held to the reference package's committed SF1 rows (or a numpy
oracle), and its route to the counters of the fused path: fragments,
host scans, declines, one dispatch and one sync per partition of a warm
statement, no upload. Every fragment enqueue of the SQL and join phases
runs under torch.cuda.set_sync_debug_mode("error"), so a blocking wait
on the card inside a fragment fails the run. Each kernel is held to its
plain version on inputs built from the loaded tables and on edge cases,
and, in one more warm statement of every TestKit query, on the very
tensors each fragment hands its wrapper. Each kernel's launches are
counted per path, and so are the product pairs Q6 folds into
range_filter_sums (one per partition and statement).

Run from the repository root: `python3 chip_smoke.py`. It needs one
CUDA device and the CUDA toolkit (nvcc), and exits non-zero, printing no
result, when either is missing or any phase fails. The last two lines
of its output are a `{"kernels": [...]}` JSON line and
`{"ok": true, "device": {...}}`."""
from __future__ import annotations

import hashlib
import json
import os
import socket
import statistics
import struct
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FLUSH_BYTES = 1 << 30           # read before each timed call (time_ms)
ROOT = os.path.dirname(os.path.abspath(__file__))
SF, SEED = 1.0, 7
WARM_RUNS = 5
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def time_ms(fn, iters=20, flush=None):
    """Warm median of `fn` in ms by CUDA events; `flush` (a tensor
    larger than L2) is READ before each timed launch, so the inputs come
    from device memory as a fragment's first pass finds them and the L2
    holds no dirty lines to write back inside the timed window. Reading
    FLUSH_BYTES keeps the card busy about 0.3 ms, longer than the host
    takes to enqueue `fn`, so the window holds the card's time for the
    call (fills, kernels, copies), not the Python before its launch."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sector_bytes(live, ncols=1):
    """Bytes that reading `ncols` int64 columns at the rows where `live`
    is set must move: the card reads device memory in 32-byte sectors,
    so every sector of 4 rows that holds such a row, once per column."""
    import torch
    pad = (-live.numel()) % 4
    if pad:
        live = torch.cat([live, live.new_zeros(pad)])
    return 32 * ncols * int(live.view(-1, 4).any(1).sum())


def n_distinct(cols):
    """Distinct buffers among `cols`, as the kernels' wrappers count them
    (scan_kernels.distinct_buffers): a bound reads each buffer once."""
    from tidb_tpu_torch.ops.scan_kernels import distinct_buffers
    return len(distinct_buffers(cols)[0])


def device_ms(fn, kernel, flush, iters=10):
    """Mean device time in ms, per call of `fn`, of the CUDA kernels whose
    name holds `kernel` (a string, or a tuple of strings, any of them),
    from torch.profiler (the kernel itself: not the fill of its output
    nor the host's launch); None when the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.max()
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and
          any(k in e.name for k in names)]
    return sum(us) / iters / 1e3 if us else None


def range_filter_bytes(sum_cols, pred_cols, bounds, valid, products=()):
    """range_filter_sums' bytes on this run's data: valid in full; each
    distinct predicate column at the rows that passed valid and every
    earlier predicate (a warp reads a column only for rows still live);
    each distinct operand buffer that is no predicate's (sum columns,
    product operands) at the rows that passed all; the k + 1 outputs.
    -> (bytes, live rows)."""
    from tidb_tpu_torch.ops.scan_kernels import distinct_buffers
    live = valid
    nbytes = valid.numel()
    _, pidx = distinct_buffers(pred_cols)
    for p, (c, (lo, hi)) in enumerate(zip(pred_cols, bounds)):
        if pidx[p] not in pidx[:p]:          # a buffer's first test
            nbytes += sector_bytes(live)
        live = live & (c >= lo) & (c <= hi)
    operands = list(sum_cols) + [t for pair in products for t in pair]
    n_pred = n_distinct(pred_cols)
    n_ops = n_distinct(list(pred_cols) + operands) - n_pred
    k = len(sum_cols) + len(products)
    nbytes += sector_bytes(live, n_ops) + 8 * (k + 1)
    return nbytes, int(live.sum())


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from tidb_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.load("scan_kernels")
    secs, out = build.BUILD_LOG.get("scan_kernels", (0.0, ""))
    log(f"kernel build: scan_kernels.cu {secs:.2f} s nvcc "
        f"({time.perf_counter() - t0:.2f} s with load)")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return card


def main_path_inputs(tk):
    """The kernels' inputs per fact partition, built on the card from the
    loaded lineitem the way the fused fragment builds them: Q6's
    (range_filter_sums, with the bounds copr/range_lowering.py derives
    from Q6's five filters and its folded product pair), QSUM's
    (masked_sums) and Q1's (dense_group_sums)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.chunk.device import shape_bucket
    from tidb_tpu_torch.types.time_types import parse_date
    tbl = tk.domain.infoschema().table_by_name("test", "lineitem")
    ctab = tk.domain.columnar.tables[tbl.id]
    step = tk.domain.copr.device_rows
    r_code = list(ctab.dicts[tbl.find_column("l_returnflag").id].values
                  ).index("R")
    q6_bounds = [(parse_date("1994-01-01"), parse_date("1995-01-01") - 1),
                 (5, 7), (I64_MIN, 2399)]

    def col(name, sl, cap):
        a = ctab.data[tbl.find_column(name).id][sl].astype(np.int64)
        a = np.concatenate([a, np.zeros(cap - len(a), np.int64)])
        return torch.from_numpy(a).cuda()
    parts = []
    for start in range(0, ctab.n, step):
        sl = slice(start, min(start + step, ctab.n))
        m = sl.stop - sl.start
        cap = shape_bucket(m)
        valid = torch.zeros(cap, dtype=torch.bool, device="cuda")
        valid[:m] = True
        ship, disc, qty, price, tax, rf, ls = (
            col(c, sl, cap) for c in ("l_shipdate", "l_discount",
                                      "l_quantity", "l_extendedprice",
                                      "l_tax", "l_returnflag",
                                      "l_linestatus"))
        disc_price = price * (100 - disc)
        q1_valid = valid & (ship <= parse_date("1998-12-01") - 90)
        q1_slots = torch.where(q1_valid, (rf + 1) * 3 + (ls + 1), 12)
        parts.append({
            "n": cap,
            "q6": ([], [ship, disc, qty], q6_bounds, valid,
                   [(price, disc)]),
            "qsum": ([qty, price], valid & (rf == r_code)),
            "q1": ([qty, price, disc_price, disc_price * (100 + tax), qty,
                    price, disc], q1_slots, q1_valid)})
    return parts


def q6_replaced_path(sum_cols, pred_cols, bounds, valid, products):
    """What Q6's fragment ran before the fold: the elementwise product
    pass, then range_filter_sums on the product column."""
    from tidb_tpu_torch.ops import scan_kernels as sk
    return sk.range_filter_sums(sum_cols + [a * b for a, b in products],
                                pred_cols, bounds, valid)


def q6_literal_path(sum_cols, pred_cols, bounds, valid, products):
    """Q6's five filters as its SQL writes them, ANDed into valid, then
    masked_sums with each pair's product a torch column: a check of the
    lowered bounds and of the fold that shares no code with
    range_filter_sums (`bounds` is not read)."""
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.types.time_types import parse_date
    ship, disc, qty = pred_cols
    mask = valid & (ship >= parse_date("1994-01-01")) & \
        (ship < parse_date("1995-01-01")) & (disc >= 5) & (disc <= 7) & \
        (qty < 2400)
    return sk.masked_sums(sum_cols + [a * b for a, b in products], mask)


def range_edge_cases():
    """range_filter_sums inputs off the main path: ragged n, k 0..16,
    npred 1..16, empty ranges, bounds at INT64_MIN/MAX, values at the
    int64 extremes, beyond 2^24 and negative; product pairs (up to two,
    within 16 terms) of a predicate column and a sum column, and of a sum
    column with itself (wrapping int64)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    out = []
    for n in (1, 255, 257, 8191, 100_003):
        for k in (0, 1, 3, 7, 16):
            for npred in (1, 2, 5, 16):
                sums = [torch.from_numpy(rng.integers(
                    -(1 << 40), 1 << 40, n)).cuda() for _ in range(k)]
                preds, bounds = [], []
                for p in range(npred):
                    v = rng.integers(-50, 50, n)
                    v[rng.random(n) < 0.02] = I64_MIN
                    v[rng.random(n) < 0.02] = I64_MAX
                    preds.append(torch.from_numpy(v).cuda())
                    a, b = sorted(int(x) for x in rng.integers(-60, 60, 2))
                    bounds.append([(a, b), (I64_MIN, b), (a, I64_MAX),
                                   (b + 1, a), (I64_MIN, I64_MAX)][
                                       (p + k + n) % 5])
                valid = torch.from_numpy(rng.random(n) < 0.9).cuda()
                pairs = [(preds[-1], sums[0] if k else preds[0])]
                if k:
                    pairs.append((sums[-1], sums[-1]))
                out.append((sums, preds, bounds, valid,
                            pairs[:16 - k]))
    return out


# Layouts the redesigned kernels split on, as (n, mask offset, column
# offset, mask kind, aliasing, nslots, extreme values): ragged n around
# the 16-byte mask vector and the 512-row chunk; views that are not
# 16-byte aligned, alike (a common head aligns them: dense_group_sums'
# bulk copies) and unlike (none does: its register path); masks all
# clear, all set, set only in the last row; one buffer named twice and
# overlapping views of one storage; k = 16 distinct columns at nslots
# 1, 12 and 64 (the largest tables); values at +-2^62.
LAYOUT_CASES = tuple(
    [(n, mo, co, mk, "same", 12, False)
     for n in (1, 15, 16, 17, 4097, 1 << 20)
     for mo, co in ((0, 0), (1, 1), (3, 3), (1, 0), (0, 3))
     for mk in ("random", "clear", "set", "last")] +
    [(n, mo, co, "random", "views", 12, False)
     for n in (17, 4097, 1 << 20) for mo, co in ((0, 0), (1, 1))] +
    [(100_003, mo, mo, "random", "wide", ns, True)
     for ns in (1, 12, 64) for mo in (0, 1)] +
    [(1 << 20, 0, 0, "set", "same", 12, True),
     (4097, 3, 3, "random", "same", 64, True)])


def layout_case(n, moff, coff, mask_kind, alias, nslots, extreme,
                device="cuda"):
    """-> (cols, mask, slots, nslots) for one LAYOUT_CASES entry. Column
    views start `coff` int64 elements, the mask `moff` bytes, into
    fresh allocations. alias "same": [a, b, a] (a named twice); "views":
    [a, b, b', a] with b' the view of b's storage one element on;
    "wide": 16 distinct columns."""
    import numpy as np
    import torch
    rng = np.random.default_rng(n * 131 + moff * 17 + coff * 7 + nslots)
    total = n + max(moff, coff) + 1

    def vals():
        if extreme:
            v = rng.choice(np.array([1 << 62, -(1 << 62), (1 << 62) - 1,
                                     1 - (1 << 62)], dtype=np.int64),
                           total)
        else:
            v = rng.integers(-(1 << 40), 1 << 40, total)
        return torch.from_numpy(v).to(device)
    m = {"random": rng.random(total) < 0.5,
         "clear": np.zeros(total, bool), "set": np.ones(total, bool),
         "last": np.arange(total) == moff + n - 1}[mask_kind]
    mask = torch.from_numpy(m).to(device)[moff:moff + n]
    slots = torch.from_numpy(rng.integers(-2, nslots + 2, total)).to(
        device)[coff:coff + n]
    if alias == "wide":
        cols = [vals()[coff:coff + n] for _ in range(16)]
    else:
        a, b = vals(), vals()
        cols = [a[coff:coff + n], b[coff:coff + n]]
        cols.append(cols[0])
        if alias == "views":
            cols.insert(2, b[coff + 1:coff + 1 + n])
    return cols, mask, slots, nslots


def edge_cases():
    """Inputs off the main path: ragged n, empty mask, negative values,
    values beyond 2^24, slots equal to nslots and negative slots; then
    LAYOUT_CASES. A generator: the cases are built one at a time."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    for n in (1, 255, 257, 8191, 100_003):
        for k in (0, 1, 7, 16):
            vals = rng.integers(-(1 << 40), 1 << 40, (k, n))
            mask = rng.random(n) < 0.5
            slots = rng.integers(-2, 14, n)
            cols = [torch.from_numpy(v.copy()).cuda() for v in vals]
            yield (cols, torch.from_numpy(mask).cuda(),
                   torch.from_numpy(slots).cuda(), 12)
    n = 4096
    cols = [torch.full((n,), -(1 << 50), dtype=torch.int64, device="cuda")]
    yield (cols, torch.zeros(n, dtype=torch.bool, device="cuda"),
           torch.full((n,), 64, dtype=torch.int64, device="cuda"), 64)
    yield (cols, torch.ones(n, dtype=torch.bool, device="cuda"),
           torch.arange(n, dtype=torch.int64, device="cuda") % 65, 64)
    for case in LAYOUT_CASES:
        yield layout_case(*case)


RANGE_NPREDS = (0, 1, 3, 16)


def range_layout_case(n, moff, coff, mask_kind, alias, nslots, extreme,
                      npred, device="cuda"):
    """-> (sum_cols, pred_cols, bounds, valid, products) of
    range_filter_sums for one LAYOUT_CASES entry and a predicate count,
    from layout_case's views and mask. Predicate p tests view p of
    [slots, *cols] (slots in [0, nslots // 2], a column where it is above
    -2^39, or above 1 - 2^62 for extreme values: about 3/4 of the rows);
    predicates past the distinct views test the full range. The sums are
    the first two columns (eight for "wide"); the products pair column 1
    with predicate 1's column (an operand that is a predicate's) and the
    last column with itself (wrapping int64 at +-2^62); "wide" pairs
    columns 8..15 (16 terms)."""
    cols, mask, slots, _ = layout_case(n, moff, coff, mask_kind, alias,
                                       nslots, extreme, device)
    views = [slots] + cols
    floor = 1 - (1 << 62) if extreme else -(1 << 39)
    preds, bounds = [], []
    for p in range(npred):
        preds.append(views[p % len(views)])
        bounds.append((0, nslots // 2) if p == 0 else (floor, I64_MAX)
                      if p < len(views) else (I64_MIN, I64_MAX))
    if alias == "wide":
        return cols[:8], preds, bounds, mask, [(cols[8 + i], cols[15 - i])
                                               for i in range(8)]
    return cols[:2], preds, bounds, mask, [(cols[1], views[1]),
                                           (cols[-1], cols[-1])]


# each kernel's largest difference from its plain version, over every
# comparison the script makes (exact int64: it must stay 0)
ERR = {"masked_sums": 0, "dense_group_sums": 0, "range_filter_sums": 0}


def cmp(name, got, want):
    """A kernel wrapper's result == its plain version's, tensor by
    tensor, exactly; records the largest difference in ERR."""
    import torch
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            d = (g - w).abs().max().item() if g.shape == w.shape \
                else float("inf")
            fail(f"{name} disagrees with its plain version "
                 f"(max abs err {d}, shapes {list(g.shape)} "
                 f"{list(w.shape)})")
        if g.numel():
            ERR[name] = max(ERR[name], (g - w).abs().max().item())


def checked_kernels(run):
    """Runs `run()` with each kernel wrapper of scan_kernels replaced by
    one that calls the wrapper (whose launch counts as the path's own),
    then the plain version on the same device tensors; once `run()` has
    returned, cmp()s the two of every call (not inside the fragment,
    where the sync guard allows no host read). The plain versions launch
    no kernel and count nothing. -> (run's result, [(name, shape)] of
    the calls, shape as "n=.. k=.. nslots=..")."""
    from tidb_tpu_torch.ops import scan_kernels as sk
    calls, pairs = [], []
    saved = {fn.__name__: getattr(sk, fn.__name__) for fn in sk.KERNELS}

    def checking(name, wrapper):
        plain = getattr(sk, name + "_plain")

        def call(*args, **kw):
            got = wrapper(*args, **kw)
            pairs.append((name, got, plain(*args, **kw)))
            cols, rest = list(args[0]), args[1:]
            n = rest[0].numel() if name == "dense_group_sums" else \
                rest[-1].numel() if name == "masked_sums" else \
                (args[3] if len(args) > 3 else kw["valid"]).numel()
            shape = f"n={n} k={len(cols)}"
            if name == "dense_group_sums":
                shape += f" nslots={int(rest[1])}"
            calls.append((name, shape))
            return got
        return call
    for name, wrapper in saved.items():
        setattr(sk, name, checking(name, wrapper))
    try:
        out = run()
    finally:
        for name, wrapper in saved.items():
            setattr(sk, name, wrapper)
    for name, got, want in pairs:
        cmp(name, got, want)
    return out, calls


class SyncGuard:
    """Runs every fragment enqueue (copr/pipeline.py run_fragment: the
    fragment's own call, not its uploads nor its fetch) under
    torch.cuda.set_sync_debug_mode("error"): a blocking wait on the card
    inside a fragment raises, and its statement fails. `calls` counts
    the enqueues it guarded. check() first shows the mode is live: a
    tensor's .item() and a device tensor made from a Python scalar must
    raise under it."""

    def __init__(self):
        self.calls = 0
        self._orig = None

    @staticmethod
    def check():
        import torch
        x = torch.ones(1, device="cuda")
        for what, fn in (("Tensor.item()", lambda: x.item()),
                         ("torch.tensor(1, device='cuda')",
                          lambda: torch.tensor(1, device="cuda"))):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError:
                continue
            finally:
                torch.cuda.set_sync_debug_mode(0)
            fail(f"sync debug mode 'error' did not catch {what}")
        log("sync guard: set_sync_debug_mode('error') raises on "
            "Tensor.item() and on torch.tensor(<scalar>, device='cuda')")

    def __enter__(self):
        import torch
        from tidb_tpu_torch.copr import pipeline
        self._orig = orig = pipeline.run_fragment

        def guarded(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.calls += 1
            return out
        pipeline.run_fragment = guarded
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.copr import pipeline
        pipeline.run_fragment = self._orig


def phase_kernels(parts):
    """Each kernel == its plain version (exact int64) at the main-path
    shapes built from the loaded tables and on the edge cases; then
    timings at the largest partition. The fragments' own calls are held
    to the plain versions in phase_sql (checked_kernels). -> per-kernel
    record (the differences go to ERR)."""
    import torch
    from tidb_tpu_torch.ops import scan_kernels as sk
    for p in parts:
        cols, mask = p["qsum"]
        cmp("masked_sums", sk.masked_sums(cols, mask),
            sk.masked_sums_plain(cols, mask))
        q6 = p["q6"]
        got = sk.range_filter_sums(*q6)
        cmp("range_filter_sums", got, sk.range_filter_sums_plain(*q6))
        cmp("range_filter_sums", got, q6_replaced_path(*q6))
        cmp("range_filter_sums", got, q6_literal_path(*q6))
        cols, slots, valid = p["q1"]
        cmp("dense_group_sums", sk.dense_group_sums(cols, slots, 12, valid),
            sk.dense_group_sums_plain(cols, slots, 12, valid))
    ncases = 0
    for cols, mask, slots, nslots in edge_cases():
        cmp("masked_sums", sk.masked_sums(cols, mask),
            sk.masked_sums_plain(cols, mask))
        cmp("dense_group_sums",
            sk.dense_group_sums(cols, slots, nslots, mask),
            sk.dense_group_sums_plain(cols, slots, nslots, mask))
        ncases += 1
    rcases = range_edge_cases()
    for case in LAYOUT_CASES:
        for npred in RANGE_NPREDS:
            rcases.append(range_layout_case(*case, npred))
    for case in rcases:
        cmp("range_filter_sums", sk.range_filter_sums(*case),
            sk.range_filter_sums_plain(*case))
    torch.cuda.synchronize()
    log(f"kernels == plain versions on {len(parts)} main-path partitions "
        f"and {ncases} + {len(rcases)} edge cases (exact int64)")

    flush = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for p in parts:
        cols, mask = p["qsum"]
        stacked = torch.stack(cols)
        n, k = p["n"], len(cols)
        nnz = int(mask.sum())
        t_k = time_ms(lambda: sk.masked_sums(cols, mask), flush=flush)
        t_p = time_ms(lambda: sk.masked_sums_plain(cols, mask), flush=flush)
        t_l = time_ms(lambda: torch.where(mask, stacked, 0).sum(1),
                      flush=flush)
        t_d = device_ms(lambda: sk.masked_sums(cols, mask),
                        "masked_sums_kernel", flush)
        # the mask in full, each distinct column where live, the outputs
        nbytes = n + sector_bytes(mask, n_distinct(cols)) + 8 * (k + 1)
        rows.append(("masked_sums", n, k, nnz, t_k, t_p, t_l,
                     nbytes / HBM_BYTES_PER_S * 1e3, None, t_d))
        q6 = p["q6"]
        k = len(q6[0]) + len(q6[4])
        nbytes, nnz = range_filter_bytes(*q6)
        t_k = time_ms(lambda: sk.range_filter_sums(*q6), flush=flush)
        t_p = time_ms(lambda: sk.range_filter_sums_plain(*q6), flush=flush)
        t_r = time_ms(lambda: q6_replaced_path(*q6), flush=flush)
        t_d = device_ms(lambda: sk.range_filter_sums(*q6),
                        "range_filter_sums", flush)
        rows.append(("range_filter_sums", n, k, nnz, t_k, t_p, None,
                     nbytes / HBM_BYTES_PER_S * 1e3, t_r, t_d))
        cols, slots, valid = p["q1"]
        stacked = torch.stack(cols)
        k = len(cols)
        live = valid & (slots >= 0) & (slots < 12)
        nnz = int(live.sum())
        spill = torch.where(live, slots, 12)
        t_k = time_ms(lambda: sk.dense_group_sums(cols, slots, 12, valid),
                      flush=flush)
        t_p = time_ms(lambda: sk.dense_group_sums_plain(cols, slots, 12,
                                                        valid),
                      iters=5, flush=flush)
        t_l = time_ms(lambda: torch.zeros((k, 13), dtype=torch.int64,
                                          device="cuda").index_add_(
            1, spill, stacked), flush=flush)
        t_d = device_ms(lambda: sk.dense_group_sums(cols, slots, 12, valid),
                        "dense_group_sums_kernel", flush)
        # valid in full, slots where valid, each distinct value column
        # where live (Q1 names 5 buffers in its 7 arguments), the table
        nbytes = n + sector_bytes(valid) + \
            sector_bytes(live, n_distinct(cols)) + 8 * (k + 1) * 12
        rows.append(("dense_group_sums", n, k, nnz, t_k, t_p, t_l,
                     nbytes / HBM_BYTES_PER_S * 1e3, None, t_d))
    for r in rows:
        other = (f"library {r[6]:.4f} ms" if r[6] is not None else
                 f"replaced path (product pass + unfolded kernel) "
                 f"{r[8]:.4f} ms")
        dev = "not measured" if r[9] is None else f"{r[9]:.4f} ms"
        log(f"time {r[0]} n={r[1]} k={r[2]} live={r[3]}: kernel {r[4]:.4f} "
            f"ms (profiler device {dev}), plain {r[5]:.4f} ms, {other}, "
            f"bound {r[7]:.4f} ms "
            f"({r[7] * 1e-3 * HBM_BYTES_PER_S:.0f} bytes)")
    big = {}
    for r in rows:
        if r[0] not in big or r[1] > big[r[0]][1]:
            big[r[0]] = r
    return big


# (query, kernel its statements must launch once per partition,
# kernels they must not launch, product pairs folded per partition)
SQL_CASES = (("q6", "range_filter_sums", ("masked_sums",), 1),
             ("q1", "dense_group_sums", (), 0),
             ("qsum", "masked_sums", ("range_filter_sums",), 0))

# domain counters, visible from every thread: a statement that takes the
# fused device path adds 1 to the first and 0 to the others
ROUTE_COUNTERS = ("fused_pipeline_hit", "copr_host_exec",
                  "fused_pipeline_fallback", "fused_pipeline_error")
# the sort kind's learning reruns (cold statements only)
RETRY_COUNTERS = ("fused_bucket_regrow", "fused_runs_degrade",
                  "fused_compact_regrow")
KERNELS = ("masked_sums", "dense_group_sums", "range_filter_sums")

# the join queries: (query, the fused fragments of a warm statement, the
# fragments only its first statement adds (a subquery whose value or
# rows the cached plan keeps), the host reader-DAG scans of a first and
# of a later statement). A fragment is (fact table, the kernel it
# launches once per partition of that table, or None: a sort-kind
# aggregation, plain PyTorch: Q3 and Q10's join positions over 64 slots
# take the runs lowering on the card). No fused node of these declines.
# The reader-DAG scans are those outside a fused node, run on the host
# (ROADMAP A.4) as the reference runs them on its CPU.
JOIN_CASES = (
    ("q3", (("lineitem", None),), (), (0, 0)),
    ("q4", (("orders", "dense_group_sums"),), (), (0, 0)),
    ("q5", (("lineitem", "dense_group_sums"),), (), (0, 0)),
    ("q10", (("lineitem", None),), (), (0, 0)),
    ("q12", (("lineitem", "dense_group_sums"),), (), (0, 0)),
    ("q14", (("lineitem", "masked_sums"),), (), (0, 0)),
    ("q19", (("lineitem", "masked_sums"),), (), (0, 0)),
    ("q22", (("customer", "dense_group_sums"),),
     (("customer", "range_filter_sums"),), (0, 0)),
    ("q2", (("partsupp", None),), (), (5, 5)),
    ("q7", (("lineitem", None),), (), (0, 0)),
    ("q8", (("lineitem", None),), (), (0, 0)),
    ("q9", (("lineitem", None),), (), (0, 0)),
    ("q11", (("partsupp", None),), (("partsupp", "masked_sums"),), (0, 0)),
    ("q15", (("lineitem", None),), (("lineitem", None),), (1, 1)),
    ("q16", (("partsupp", None),), (), (1, 0)),
    ("q18", (("lineitem", None),), (("lineitem", None),), (0, 0)),
    ("q20", (), (("lineitem", None),), (3, 1)),
    # Q20 returns no row at SF1; without its nation predicate it does,
    # through the IN-subquery result Q20's first statement computed
    ("q20_all_nations", (), (), (1, 1)),
)
# queries with a fused node the port does not fuse yet (materialized
# dims, ROADMAP A.3): (query, fused fragments of every statement, fused
# nodes that decline, host reader-DAG scans), run cold and warm
DECLINED_CASES = (("q13", (), 1, 2),
                  ("q17", (("lineitem", None),), 1, 2),
                  ("q21", (("lineitem", None), ("lineitem", None)), 1, 4))


def table_rows(tk, table):
    dom = tk.domain
    return dom.columnar.tables[dom.infoschema().table_by_name(
        "test", table).id].n


def partitions_of(tk, table):
    """Fact partitions of `table`: fragments a statement over it runs."""
    return -(-table_rows(tk, table) // tk.domain.copr.device_rows)


def route_of(tk, q, nparts, first=False):
    """-> the route query q's statement must show, on its first run or a
    later one: {"launches": {kernel: n}, "absent": kernels not launched,
    "pairs": product pairs folded, "fragments": fused fragments,
    "dispatches": fragment calls of a warm statement (a first one may
    rerun a partition while it learns), "host": reader-DAG scans on the
    host, "declined": fused nodes that decline}; nparts is lineitem's
    partitions."""
    case = next((c for c in SQL_CASES if c[0] == q), None)
    if case is not None:
        _q, kname, absent, pairs = case
        return {"launches": {kname: nparts}, "absent": absent,
                "pairs": pairs * nparts, "fragments": 1,
                "dispatches": nparts, "host": 0, "declined": 0}
    case = next((c for c in JOIN_CASES if c[0] == q), None)
    if case is not None:
        _q, frags, cold, host = case
        frags = frags + (cold if first else ())
        host, declined = host[0 if first else 1], 0
    else:
        _q, frags, declined, host = next(c for c in DECLINED_CASES
                                         if c[0] == q)
    launches = {}
    for fact, kname in frags:
        if kname is not None:
            launches[kname] = launches.get(kname, 0) + \
                partitions_of(tk, fact)
    return {"launches": launches,
            "absent": tuple(k for k in KERNELS if k not in launches),
            "pairs": 0, "fragments": len(frags),
            "dispatches": sum(partitions_of(tk, f) for f, _ in frags),
            "host": host, "declined": declined}


def sql_and_rows(tk, exp, q):
    """-> (sql, expected rows): a query of the committed reference rows
    from them (Q6, Q1, Q3 and Q5 also held to their numpy oracles), QSUM
    from its oracle."""
    from tidb_tpu_torch.bench import tpch
    oracle = {"q6": tpch.q6_oracle, "q1": tpch.q1_oracle,
              "q3": tpch.q3_oracle, "q5": tpch.q5_oracle,
              "qsum": tpch.qsum_oracle}.get(q)
    sql = {"qsum": tpch.QSUM, "q20_all_nations": tpch.Q20_ALL_NATIONS}.get(
        q) or tpch.ALL_QUERIES[q]
    if q not in exp:
        return sql, oracle(tk)
    want = [tuple(r) for r in exp[q]]
    if oracle is not None and oracle(tk) != want:
        fail(f"{q}: numpy oracle {oracle(tk)} != expected rows {want}")
    return sql, want


def check_route(q, run, dom, m0, c0, route):
    """The statement ran route["fragments"] fused device fragments and
    route["declined"] declined fused nodes, with route["host"] reader
    DAGs on the host and no fused fragment failing; each kernel in
    route["launches"] launched that many times and those in
    route["absent"] not at all (counts from the snapshot c0 of
    scan_kernels.COUNTS), and it folded route["pairs"] product pairs
    into range_filter_sums."""
    from tidb_tpu_torch.ops import scan_kernels as sk
    folded = sk.COUNTS["product_pairs"] - c0["product_pairs"]
    if folded != route["pairs"]:
        fail(f"{q} {run}: folded {folded} product pairs, expected "
             f"{route['pairs']}")
    d = {c: dom.metrics.get(c, 0) - m0[c] for c in ROUTE_COUNTERS}
    want = {"fused_pipeline_hit": route["fragments"],
            "copr_host_exec": route["host"],
            "fused_pipeline_fallback": route["declined"],
            "fused_pipeline_error": 0}
    if d != want:
        fail(f"{q} {run}: routing counters {d}, expected {want} "
             f"({dom.last_fused_reason})")
    for name, n in route["launches"].items():
        if sk.COUNTS[name] - c0[name] != n:
            fail(f"{q} {run}: {name} launched {sk.COUNTS[name] - c0[name]}"
                 f" times, expected {n}")
    for name in route["absent"]:
        if sk.COUNTS[name] != c0[name]:
            fail(f"{q} {run}: {name} launched {sk.COUNTS[name] - c0[name]}"
                 " times")


def check_phase(q, i, snap, route, guarded, cuda=True):
    """A statement's phase counters: no fused fragment fell back, the
    host ran only the route's reader DAGs, every fragment enqueue ran
    under the sync guard (`guarded` of them), and a warm run (i > 0)
    uploaded nothing (dims included) and made one dispatch and one sync
    per fact partition of its fragments (a sync is a wait on the card:
    `cuda` False, a CPU rehearsal, has none); a first run may rerun a
    partition while it learns, never fewer."""
    for c in ("device_fallbacks", "fused_fallbacks"):
        if snap.get(c, 0):
            fail(f"{q} run {i}: {c} = {snap[c]}")
    if snap.get("host_execs", 0) != route["host"]:
        fail(f"{q} run {i}: {snap.get('host_execs', 0)} host executions, "
             f"expected {route['host']}")
    disp, syncs = snap.get("dispatches", 0), snap.get("syncs", 0)
    if guarded != disp:
        fail(f"{q} run {i}: {disp} fragment dispatches, {guarded} under "
             "the sync guard")
    if i > 0 and snap.get("upload_bytes", 0):
        fail(f"{q} warm run {i}: uploaded {snap['upload_bytes']} bytes")
    if syncs != (disp if cuda else 0) or \
            (disp != route["dispatches"] if i > 0 else
             disp < route["dispatches"]):
        fail(f"{q} run {i}: {disp} dispatches and {syncs} syncs, expected "
             f"{route['dispatches']} of each")


def fact_of(q):
    """The fact table a query's fused fragments scan (the first one's)."""
    case = next((c for c in JOIN_CASES if c[0] == q), None)
    frags = () if case is None else case[1] + case[2]
    return frags[0][0] if frags else "lineitem"


# ngroups of each partition of the last fused fragment (record_ngroups)
NGROUPS = []


def record_ngroups():
    """Wraps copr/pipeline.py's _fused_partials_inner so NGROUPS holds
    the group count of every partition of the last fused fragment it
    returned."""
    from tidb_tpu_torch.copr import pipeline
    inner = pipeline._fused_partials_inner

    def recorded(*args, **kw):
        out = inner(*args, **kw)
        if out is not None:
            NGROUPS[:] = [p.ngroups for p in out]
        return out
    pipeline._fused_partials_inner = recorded


def sort_kind_state(dom):
    """The sort kind's learned state in the copr's host cache: group
    buckets, lowering pins, compact capacities."""
    return {k: v for k, v in dom.copr._host_cache.items()
            if isinstance(k, tuple) and k and
            k[0] in ("gb", "aggimpl", "fcompact")}


def phase_line(snap):
    return " ".join(f"{k}={snap.get(k, 0)}" for k in (
        "dispatches", "syncs", "upload_bytes", "mask_upload_bytes",
        "fetch_bytes"))


def phase_sql(tk, exp, nparts, queries, guard):
    """`queries` through SQL on the card: cold once, warm WARM_RUNS
    times, then once more with every kernel call the fragments make held
    to its plain version on the same tensors (checked_kernels), every
    fragment enqueue under the sync guard; rows == the committed
    reference rows or the numpy oracle (sql_and_rows), the route of
    route_of, warm statements upload nothing (dims included) and make
    one dispatch and one sync per partition. -> {query: warm median
    ms}."""
    from collections import Counter
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    cuda = dom.copr.device.type == "cuda"
    meds = {}
    for q in queries:
        sql, want = sql_and_rows(tk, exp, q)
        warm, calls = [], []
        learned0 = sort_kind_state(dom)
        for i in range(2 + WARM_RUNS):
            checked = i == 1 + WARM_RUNS
            route = route_of(tk, q, nparts, i == 0)
            m0 = {c: dom.metrics.get(c, 0) for c in ROUTE_COUNTERS +
                  RETRY_COUNTERS}
            c0 = dict(sk.COUNTS)
            g0 = guard.calls
            phase.reset()
            t0 = time.perf_counter()
            if checked:
                got, calls = checked_kernels(
                    lambda: tk.must_query(sql)._norm())
            else:
                got = tk.must_query(sql)._norm()
            ms = (time.perf_counter() - t0) * 1e3
            snap = phase.snap()
            if got != want:
                fail(f"{q} run {i}: rows {got} != expected {want}")
            check_route(q, f"run {i}", dom, m0, c0, route)
            check_phase(q, i, snap, route, guard.calls - g0, cuda)
            retries = {c: dom.metrics.get(c, 0) - m0[c]
                       for c in RETRY_COUNTERS}
            if i > 0 and any(retries.values()):
                fail(f"{q} warm run {i}: learning reruns {retries}")
            if 0 < i and not checked:
                warm.append(ms)
            kind = "cold" if i == 0 else "checked" if checked else "warm"
            log(f"sql {q} {kind} {ms:.2f} ms {phase_line(snap)} launches=" +
                json.dumps({k: sk.COUNTS[k] - c0[k]
                            for k in route["launches"]}) +
                f" product_pairs="
                f"{sk.COUNTS['product_pairs'] - c0['product_pairs']}" +
                ("".join(f" {c}={n}" for c, n in retries.items() if n)))
        for name, n in route["launches"].items():
            if sum(c[0] == name for c in calls) != n:
                fail(f"{q}: {n} {name} launches, "
                     f"{sum(c[0] == name for c in calls)} checked")
        log(f"sql {q}: kernel calls == plain versions on the same tensors: "
            + ("; ".join(f"{name} {shape} x{k}" for (name, shape), k in
                         sorted(Counter(calls).items())) or "none"))
        learned = [[k[0], v] for k, v in sort_kind_state(dom).items()
                   if learned0.get(k) != v]
        if learned:
            log(f"sql {q}: sort kind learned {json.dumps(learned)}; "
                f"ngroups by partition of the last statement "
                f"{NGROUPS}; fetch_bytes {snap.get('fetch_bytes', 0)}")
        meds[q] = statistics.median(warm)
        fact = fact_of(q)
        log(f"sql {q}: rows == {'expected' if q in exp else 'numpy oracle'}"
            f" ({len(want)} rows); warm median {meds[q]:.3f} ms, "
            f"{table_rows(tk, fact) / meds[q] * 1e3:.4g} {fact} rows/s")
    return meds


def phase_declined(tk, exp, nparts, queries, guard):
    """Queries with a fused node the port does not fuse yet: cold once
    and warm once, rows == the committed reference rows, the route of
    route_of (their other fused nodes run fused, under the sync guard),
    and the decline reasons printed."""
    from tidb_tpu_torch.copr import pipeline
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    reasons, set_reason = [], pipeline._set_reason

    def noted(copr, msg):
        reasons.append(msg)
        return set_reason(copr, msg)
    pipeline._set_reason = noted
    try:
        for q in queries:
            sql, want = sql_and_rows(tk, exp, q)
            for i in range(2):
                route = route_of(tk, q, nparts, i == 0)
                m0 = {c: dom.metrics.get(c, 0) for c in ROUTE_COUNTERS}
                c0 = dict(sk.COUNTS)
                g0 = guard.calls
                reasons.clear()
                phase.reset()
                t0 = time.perf_counter()
                got = tk.must_query(sql)._norm()
                ms = (time.perf_counter() - t0) * 1e3
                snap = phase.snap()
                if got != want:
                    fail(f"{q} run {i}: rows {got} != expected {want}")
                check_route(q, f"run {i}", dom, m0, c0, route)
                if len(reasons) != route["declined"] or not all(
                        r.startswith("not yet ported: materialized")
                        for r in reasons):
                    fail(f"{q} run {i}: decline reasons {reasons}")
                if snap.get("dispatches", 0) != guard.calls - g0:
                    fail(f"{q} run {i}: fragment dispatches outside the "
                         "sync guard")
                log(f"declined {q} {'cold' if i == 0 else 'warm'} "
                    f"{ms:.2f} ms {phase_line(snap)}; rows == expected "
                    f"({len(want)} rows); declined: {reasons}")
    finally:
        pipeline._set_reason = set_reason


class WireClient:
    """A raw-socket MySQL 4.1 client: handshake v10 with
    mysql_native_password, COM_QUERY and text result sets. The wire
    server's tests (tests/test_torch_server.py) use it too."""

    def __init__(self, port, user="root", password="", db="test",
                 expect_ok=True, timeout=600):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        greeting = self._read()
        if greeting[0] != 10:
            raise RuntimeError(f"not a v10 handshake: {greeting[:16]!r}")
        ve = greeting.index(b"\x00", 1)      # end of the version string
        salt = greeting[ve + 5:ve + 13] + greeting[ve + 32:ve + 44]
        token = b""
        if password:
            s1 = hashlib.sha1(password.encode()).digest()
            s3 = hashlib.sha1(salt + hashlib.sha1(s1).digest()).digest()
            token = bytes(a ^ b for a, b in zip(s1, s3))
        caps = 0x200 | 0x8000         # PROTOCOL_41, SECURE_CONNECTION
        if db:
            caps |= 0x8               # CONNECT_WITH_DB
        self._write(struct.pack("<IIB", caps, 1 << 24, 33) + b"\x00" * 23 +
                    user.encode() + b"\x00" + bytes([len(token)]) + token +
                    (db.encode() + b"\x00" if db else b""))
        ok = self._read()
        self.auth_ok = ok[0] == 0x00
        if expect_ok and not self.auth_ok:
            raise RuntimeError(f"handshake refused: {ok[3:]!r}")

    def _recv(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return buf

    def _read(self):
        out = b""
        while True:
            hdr = self._recv(4)
            n = int.from_bytes(hdr[:3], "little")
            self.seq = (hdr[3] + 1) & 0xFF
            out += self._recv(n)
            if n < 0xFFFFFF:
                return out

    def _write(self, payload):
        self.sock.sendall(len(payload).to_bytes(3, "little") +
                          bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    def command(self, payload):
        """Send one command packet (sequence number 0)."""
        self.seq = 0
        self._write(payload)

    @staticmethod
    def _lenenc(data, pos):
        b = data[pos]
        if b < 251:
            return b, pos + 1
        if b == 0xFB:
            return None, pos + 1
        width = {0xFC: 2, 0xFD: 3, 0xFE: 8}[b]
        return int.from_bytes(data[pos + 1:pos + 1 + width], "little"), \
            pos + 1 + width

    def _first(self):
        """The first packet of a response; raises on an error packet."""
        first = self._read()
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise RuntimeError(f"server error {code}: "
                               f"{first[9:].decode(errors='replace')}")
        return first

    def query(self, sql):
        """-> {"cols": names, "rows": tuples of str (None for NULL)} for a
        result set, {"affected": n} for an OK packet."""
        self.command(b"\x03" + sql.encode())
        first = self._first()
        if first[0] == 0x00:
            return {"affected": self._lenenc(first, 1)[0]}
        ncols, _ = self._lenenc(first, 0)
        cols = []
        for _ in range(ncols):            # name: 5th lenenc string
            pkt, pos = self._read(), 0
            for _ in range(5):
                ln, pos = self._lenenc(pkt, pos)
                name = pkt[pos:pos + ln]
                pos += ln
            cols.append(name.decode())
        self._read()                        # EOF
        rows = []
        while True:
            pkt = self._read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return {"cols": cols, "rows": rows}
            row, pos = [], 0
            while pos < len(pkt):
                ln, pos = self._lenenc(pkt, pos)
                if ln is None:
                    row.append(None)
                else:
                    row.append(pkt[pos:pos + ln].decode())
                    pos += ln
            rows.append(tuple(row))

    def close(self):
        try:
            self.command(b"\x01")          # COM_QUIT
        except OSError:
            pass
        self.sock.close()


def phase_wire(tk, exp, nparts, testkit_meds):
    """Q6 (first, then WARM_RUNS warm), Q1, QSUM, Q3 and Q5 over the
    package's MySQL wire server on the loaded SF1 domain. The server
    answers on its own thread, so the route is read from counters every
    thread sees: the domain's and the kernel wrappers' launch counts."""
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.server import Server
    dom = tk.domain
    srv = Server(dom, port=0).start()
    try:
        client = WireClient(srv.port)
        try:
            warm = []
            for q, run in [("q6", i) for i in range(1 + WARM_RUNS)] + \
                    [("q1", 0), ("qsum", 0), ("q3", 0), ("q5", 0)]:
                sql, want = sql_and_rows(tk, exp, q)
                route = route_of(tk, q, nparts)
                m0 = {c: dom.metrics.get(c, 0) for c in ROUTE_COUNTERS}
                c0 = dict(sk.COUNTS)
                t0 = time.perf_counter()
                got = client.query(sql)["rows"]
                ms = (time.perf_counter() - t0) * 1e3
                if got != want:
                    fail(f"wire {q} run {run}: rows {got} != expected "
                         f"{want}")
                check_route(f"wire {q}", f"run {run}", dom, m0, c0, route)
                if q == "q6" and run > 0:
                    warm.append(ms)
                log(f"wire {q} {'first' if run == 0 else 'warm'} "
                    f"{ms:.2f} ms launches=" + json.dumps(
                        {k: sk.COUNTS[k] - c0[k]
                         for k in route["launches"]}))
        finally:
            client.close()
    finally:
        srv.shutdown()
    med = statistics.median(warm)
    log(f"wire q6: rows == expected over the MySQL protocol; warm median "
        f"{med:.3f} ms (TestKit {testkit_meds['q6']:.3f} ms); q1, qsum, "
        "q3 and q5 == expected")
    return med


def main():
    sys.path.insert(0, ROOT)
    card = phase_card()
    import torch
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.ops import scan_kernels as sk
    with open(os.path.join(ROOT, "tidb_tpu_torch", "bench",
                           "tpch_sf1_expected.json")) as f:
        exp = json.load(f)
    t0 = time.perf_counter()
    tk = TestKit()                      # the card is the default device
    if tk.domain.copr.device.type != "cuda":
        fail(f"TestKit() runs on {tk.domain.copr.device}, not cuda")
    if tk.domain.copr.degrade_to_host:
        fail("a failed fused fragment would degrade to the host on the card")
    tpch.load_tpch(tk, sf=SF, seed=SEED)
    log(f"load TPC-H SF{SF} seed {SEED}: "
        f"{time.perf_counter() - t0:.1f} s")
    parts = main_path_inputs(tk)
    nparts = len(parts)
    big = phase_kernels(parts)
    del parts
    torch.cuda.empty_cache()
    # each path's launches: counts set to 0 just before it, read just
    # after; the kernel phase's launches count on neither
    by_path, pairs_by_path = {}, {}

    def counted(path, run, folds=True):
        sk.reset_launches()
        out = run()
        by_path[path] = {fn.__name__: sk.COUNTS[fn.__name__]
                         for fn in sk.KERNELS}
        pairs_by_path[path] = sk.COUNTS["product_pairs"]
        for name, n in by_path[path].items():
            if n == 0:
                fail(f"{name} was not launched on the {path} path")
        if folds and pairs_by_path[path] == 0:
            fail(f"no product pair was folded on the {path} path")
        return out
    SyncGuard.check()
    record_ngroups()
    with SyncGuard() as guard:
        meds = counted("sql", lambda: phase_sql(
            tk, exp, nparts, [c[0] for c in SQL_CASES], guard))
        t0 = time.perf_counter()

        def joins():
            out = phase_sql(tk, exp, nparts, [c[0] for c in JOIN_CASES],
                            guard)
            phase_declined(tk, exp, nparts, [c[0] for c in DECLINED_CASES],
                           guard)
            return out
        join_meds = counted("joins", joins, folds=False)
    log(f"join phase {time.perf_counter() - t0:.1f} s; warm medians ms: "
        f"{json.dumps(join_meds)}; {guard.calls} fragment enqueues ran "
        "under set_sync_debug_mode('error')")
    counted("wire", lambda: phase_wire(tk, exp, nparts, meds))
    log(f"launches by path: {json.dumps(by_path)}; folded product pairs "
        f"by path: {json.dumps(pairs_by_path)}")
    replaces = {"masked_sums": "tidb_tpu/ops/pallas_scan.py:75",
                "dense_group_sums": "tidb_tpu/ops/pallas_scan.py:219",
                "range_filter_sums": "tidb_tpu/ops/pallas_scan.py:146"}
    kernels = []
    for name in ("masked_sums", "dense_group_sums", "range_filter_sums"):
        r = big[name]
        rec = {
            "name": name, "route": "cuda",
            "source": "tidb_tpu_torch/ops/csrc/scan_kernels.cu",
            "replaces": replaces[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": ERR[name], "ms": r[4], "plain_ms": r[5],
            "bound_ms": r[7], "bound_by": "bytes", "library_ms": r[6],
            "kernel_device_ms": r[9]}
        rec["redesigned_in"] = 4 if name == "range_filter_sums" else 3
        if name == "range_filter_sums":
            rec["replaced_path_ms"] = r[8]
            rec["product_pairs_by_path"] = pairs_by_path
        kernels.append(rec)
    log(f"card: {card}")
    log(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
