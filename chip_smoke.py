"""Chip smoke test of tidb_tpu_torch on one CUDA card: builds the
hand-written kernels, holds each against its plain PyTorch version, times
them, then runs TPC-H Q6, Q1 and a global aggregate without range
filters at SF1 from SQL to rows through the package's normal entry point
(TestKit on the card), then the join queries whose fused fragments probe
dimension tables on the card (Q3, Q4, Q5, Q10, Q12, Q14, Q19, Q22, the
sort-kind group-bys Q2, Q7, Q8, Q9, Q11, Q15, Q16, Q18, Q20 and Q20
without its nation predicate, and Q13, Q17 and Q21, whose materialized
dims run their subplans once and serve later statements from a cache; Q3
and Q10 aggregate as runs on the card; the fused pipeline's three learned
programs each serve at least one of them: early compaction of the fact
filters' survivors, top-N candidates, one-hot slot aggregation, with
each query's route printed, and each program's warm statements timed
beside the same statements with its pin set off), then reader-DAG statements (a
filter and a top-N over lineitem, per-key counts that take the runs
lowering and the runs->sorted pin, dense and global group-bys of a small
table) against their host twin, then the executor's device hooks (ORDER
BYs over customer and orders, window functions over half of orders,
row-returning inner, left, semi and anti hash joins between them) against
their host twin and the reference's committed digests (the windows over
the orders of odd customers), then vector
search over 250,000 x VECTOR(128) (sift-128-euclidean's shape, a
seeded mixture of Gaussians loaded by IMPORT INTO's bulk path: exact
top-10 in three metrics, ties across the 10th row and NULL vectors, a
hybrid search at 1 % selectivity, an IVF index trained on the card with
recall@10 >= 0.95 against a float64 oracle, a stream of inserts folded
through the tail patch and the index's delta path) and in-SQL inference
(CREATE MODEL from seeded npz files; predict() fused in a filter over
SF1 lineitem, through masked_sums, and standalone over orders), vector
statements held to their host twin in the same process and predict()
to the numpy forward over the same features, then the MPP mesh (the
Domain's copr over four shards of the card: Q1, Q6, the global
aggregate, Q3, Q5, Q12 and tests/test_mpp.py's grouped statement as
mesh programs that launch the scan kernels once per shard and merge by
psum, a fused join whose orders dim is over the broadcast threshold and
a 90 %-hot-key join of generated tables through the all_to_all shuffle,
EXPLAIN of Q3 == the reference's exchange tree; each held to the
committed rows or digest or the host twin, its route and exchange
counted, warm within 2 dispatches, 1 sync and no upload; then the
vector statements over the VECTOR matrix row-sharded on the four
shards, held to the single card's rows, a 100-row insert folded into
the sharded matrix, and the fused predict() with masked_sums once per
shard, held to the single card's scores), then the cluster (three
worker processes on the card in one gloo process group, SF1 lineitem
dealt to them and loaded by IMPORT INTO: spmd_agg of Q6's shape, of a
filter that takes masked_sums and of a grouped statement, query_agg of
Q1 and Q6, the spmd_shuffle of lineitem x orders, TSO, a 2PC over RPC
and kill -9 of a worker under replication; every rank on the card,
spmd_frag one sync, a warm partial one sync per partition, each scan
kernel launched on every rank), and Q6, Q1, the global
aggregate, Q3 and Q5 again through the package's MySQL wire server,
with a raw-socket client. Then the phases that write (HTAP serving):
BACKUP DATABASE of the SF1 tables with a logbackup:// changefeed armed;
TPC-H's refresh functions RF1/RF2 from two writer threads while two
analyst threads run Q1 and Q6 in resolved read mode over resident
columns the writes fold into (mid-stream rows held to reads at their
resolved ts, full re-uploads only at bucket crossings, one folding
statement whole under the sync guard); two read replicas of a table
written through DML serving dense and LIKE aggregates under point ops,
an insert stream and a kill of each replica (mirrors == leader at
quiesce); RESTORE of the snapshot into a fresh Domain with its own data
dir (Q1, Q3, Q6, Q13 == the committed SF1 rows), then DROP DATABASE and
RESTORE ... UNTIL TS the mid-stream ts in that Domain (the old table ids
back, a first upload, rows == the leader's at that ts). Every statement's rows are held to the
reference package's committed SF1 rows (or a numpy oracle, or the host
twin), and its route to the counters of the fused path and the reader
DAGs: fragments, host and device scans, no decline, one dispatch and one
sync per partition of a warm statement, no upload. Every fragment
enqueue of the SQL, join and reader phases, and every executor hook but
for its fetches, runs under torch.cuda.set_sync_debug_mode("error"), so
a blocking wait on the card inside a fragment or a hook fails the run; a
hook statement makes exactly its hooks' fetches as syncs. Each kernel is
held to its plain version on inputs built from the loaded tables and on
edge cases, and, in one more warm statement of every TestKit query that
launches it (and one more run of every cluster case, in the worker
processes), on the very tensors each fragment hands its wrapper. Each
kernel's launches are counted per path, and so are the product pairs Q6
folds into range_filter_sums (one per partition and statement).

Run from the repository root: `python3 chip_smoke.py`. It needs one
CUDA device and the CUDA toolkit (nvcc), and exits non-zero, printing no
result, when either is missing or any phase fails. The last lines of
its output are a `{"htap_serving": {...}}` JSON line (the write
phases' figures), a `{"mpp_mesh": {...}}` JSON line (the mesh
statements' warm ms beside their single-card or host-twin ms, exchange
bytes, peak device memory), a `{"cluster": {...}}` JSON line (the
cluster's warm ms per case, per-rank counters, launches and peak
device memory, the backend), a `{"programs": [...]}` JSON line (the vector and
inference programs' device ms beside their bounds), the card's name and
power limit, a `{"kernels": [...]}` JSON line (each kernel's launches
by path, the mesh's under "mpp", the cluster's per rank under
"cluster_by_rank" and how many of its calls the workers held to the
plain version under "cluster_held") and
`{"ok": true, "device": {...}}`."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
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


# the executor's device hooks: (module, function, device_guard site)
HOOKS = (("tidb_tpu_torch.executor.sort_device", "device_sort_permutation",
          "sort"),
         ("tidb_tpu_torch.executor.window_device", "run_window_device",
          "window"),
         ("tidb_tpu_torch.ops.device_join", "device_join_index", "join"))


class SyncGuard:
    """Runs every fragment enqueue (copr/dag_exec.py run_fragment, the
    seam of the fused and the reader-DAG fragments: the fragment's own
    call, not its uploads nor its fetch) under
    torch.cuda.set_sync_debug_mode("error"): a blocking wait on the card
    inside a fragment raises, and its statement fails. `calls` counts
    the enqueues it guarded. Each executor hook (HOOKS) runs whole under
    the mode, its uploads included, except the waits of its pinned
    fetches (utils/fetch.py _Ticket.wait, each a counted sync):
    `hook_calls` counts by site the calls that ran on the device (a
    sort under its size floor does not), `hook_syncs` the syncs they
    made and `hook_ms` their wall time (host clock; a hook ends in its
    fetch). check() first shows the mode is live: a tensor's .item()
    and a device tensor made from a Python scalar must raise under
    it."""

    def __init__(self):
        self.calls = 0
        self.hook_calls = {site: 0 for _m, _f, site in HOOKS}
        self.hook_syncs = 0
        self.hook_ms = 0.0
        self._orig = None
        self._saved = []

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
        from tidb_tpu_torch.copr import dag_exec
        self._orig = orig = dag_exec.run_fragment

        def guarded(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.calls += 1
            return out
        dag_exec.run_fragment = guarded
        import importlib
        from tidb_tpu_torch.utils import fetch
        for mod_name, fn_name, site in HOOKS:
            mod = importlib.import_module(mod_name)
            self._saved.append((mod, fn_name, getattr(mod, fn_name)))
            setattr(mod, fn_name, self._hook(getattr(mod, fn_name), site))
        wait = fetch._Ticket.wait
        self._saved.append((fetch._Ticket, "wait", wait))

        def fetch_wait(ticket):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                wait(ticket)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        fetch._Ticket.wait = fetch_wait
        return self

    def _hook(self, fn, site):
        import torch
        from tidb_tpu_torch.utils import phase

        def guarded(*args, **kw):
            s0 = phase.current().get("syncs", 0)
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.hook_ms += (time.perf_counter() - t0) * 1e3
            if out is not None:           # None: a sort under its floor
                self.hook_calls[site] += 1
            self.hook_syncs += phase.current().get("syncs", 0) - s0
            return out
        return guarded

    def __exit__(self, *exc):
        from tidb_tpu_torch.copr import dag_exec
        dag_exec.run_fragment = self._orig
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []


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
# fused device path adds 1 to the first and 0 to the others; a reader DAG
# (a scan outside a fused node) counts on the device or on the host
ROUTE_COUNTERS = ("fused_pipeline_hit", "copr_host_exec", "copr_device_exec",
                  "fused_pipeline_fallback", "fused_pipeline_error")
# the learning reruns (cold statements only), fused and reader: the sort
# kind's regrows and pin, a compaction (late or early) regrown, top-N
# candidates whose cover proof failed, a one-hot slot table missing a key
RETRY_COUNTERS = ("fused_bucket_regrow", "fused_runs_degrade",
                  "fused_compact_regrow", "fused_topn_off",
                  "fused_onehot_miss", "copr_bucket_regrow",
                  "copr_runs_degrade")
# the fused pipeline's learned programs: the partitions each served, and
# the host cache entry that holds what it learned (an int capacity or
# "off"; True when the candidates are pinned off; a slot table or False)
PROGRAM_COUNTERS = {"ecap": "fused_ecap_run", "topn": "fused_topn_cand",
                    "onehot": "fused_onehot_agg"}
PROGRAM_STATE = {"ecap": "fecompact", "topn": "ftopn_off",
                 "onehot": "onehot"}
# per query of phase_sql: {"took": {program: partitions its last warm
# statement served}, "keys": the gb keys (host cache key tails) its
# fragments learned under, "fetch_bytes", "ngroups"}
PROGRAMS = {}
# materialized dims: subplans run, and served from the cache
MATDIM_COUNTERS = ("fused_matdim_build", "fused_matdim_hit")
KERNELS = ("masked_sums", "dense_group_sums", "range_filter_sums")

# the join queries: (query, the fused fragments of a warm statement, the
# fragments only its first statement adds (a subquery whose value or
# rows the cached plan keeps, a materialized dim's subplan), the host
# reader-DAG scans and the device reader DAGs (by table) of a first and
# of a later statement, the materialized dims). A fragment is (fact
# table, the kernel it launches once per partition of that table, or
# None: a sort-kind aggregation, plain PyTorch: Q3 and Q10's join
# positions over 64 slots take the runs lowering on the card). No fused
# node of these declines. The host reader-DAG scans are pure scans and
# filters under tidb_tpu_fragment_min_rows, as the reference routes
# them. A later statement serves every materialized dim from the cache.
JOIN_CASES = (
    ("q3", (("lineitem", None),), (), (0, 0), ((), ()), 0),
    ("q4", (("orders", "dense_group_sums"),), (), (0, 0), ((), ()), 0),
    ("q5", (("lineitem", "dense_group_sums"),), (), (0, 0), ((), ()), 0),
    ("q10", (("lineitem", None),), (), (0, 0), ((), ()), 0),
    ("q12", (("lineitem", "dense_group_sums"),), (), (0, 0), ((), ()), 0),
    ("q14", (("lineitem", "masked_sums"),), (), (0, 0), ((), ()), 0),
    ("q19", (("lineitem", "masked_sums"),), (), (0, 0), ((), ()), 0),
    ("q22", (("customer", "dense_group_sums"),),
     (("customer", "range_filter_sums"),), (0, 0), ((), ()), 0),
    ("q2", (("partsupp", None),), (), (5, 5), ((), ()), 0),
    ("q7", (("lineitem", None),), (), (0, 0), ((), ()), 0),
    ("q8", (("lineitem", None),), (), (0, 0), ((), ()), 0),
    ("q9", (("lineitem", None),), (), (0, 0), ((), ()), 0),
    ("q11", (("partsupp", None),), (("partsupp", "masked_sums"),), (0, 0),
     ((), ()), 0),
    ("q15", (("lineitem", None),), (("lineitem", None),), (1, 1), ((), ()),
     0),
    ("q16", (("partsupp", None),), (), (1, 0), ((), ()), 0),
    ("q18", (("lineitem", None),), (("lineitem", None),), (0, 0), ((), ()),
     0),
    ("q20", (), (("lineitem", None),), (3, 1), ((), ()), 0),
    # Q20 returns no row at SF1; without its nation predicate it does,
    # through the IN-subquery result Q20's first statement computed
    ("q20_all_nations", (), (), (1, 1), ((), ()), 0),
    # materialized dims: Q13's per-customer order counts (a
    # reader-DAG aggregation over orders), Q17's per-part average and
    # Q21's two per-order supplier counts (zero-dim fused group-bys)
    ("q13", (("customer", None),), (), (0, 0), (("orders",), ()), 1),
    ("q17", (("lineitem", "masked_sums"),), (("lineitem", None),), (0, 0),
     ((), ()), 1),
    ("q21", (("lineitem", None),), (("lineitem", None), ("lineitem", None)),
     (0, 0), ((), ()), 2),
)


# the executor hooks the SQL and join statements take on the card, where
# tidb_join_exec 'auto' sends each hash join of int64 keys outside the
# fused fragments to the join hook: {query: (hook calls of one
# statement by site, the syncs those calls make: 2 per inner or outer
# join, 1 per semi or anti join)}. Every other statement of these
# phases, and every reader statement, takes no hook; a CPU rehearsal
# ('auto' joins on the host there) takes none.
SQL_HOOKS = {"q2": ({"join": 5}, 10), "q15": ({"join": 1}, 2),
             "q20": ({"join": 1}, 1), "q20_all_nations": ({"join": 1}, 2)}


def check_hooks(label, dom, m0, guard, h0, hs0, want_calls, want_syncs):
    """The statement called each hook want_calls[site] times (the sync
    guard's count and the hook's own domain counter agree), degraded
    none (no error or fallback counter rose from the snapshot m0) and
    made want_syncs syncs inside them (h0, hs0: the guard's counts
    before it). -> (hook calls by site, the syncs they made)."""
    calls = {s: guard.hook_calls[s] - h0[s] for s in h0}
    syncs = guard.hook_syncs - hs0
    want_c = {s: want_calls.get(s, 0) for s in h0}
    d = {c: dom.metrics.get(c, 0) - m0[c] for c in HOOK_COUNTERS}
    want_m = {c: 0 for c in HOOK_COUNTERS}
    want_m.update({"sort_device": want_c["sort"],
                   "window_device": want_c["window"],
                   "device_join": want_c["join"]})
    if calls != want_c or d != want_m or syncs != want_syncs:
        fail(f"{label}: hook calls {calls}, counters {d}, {syncs} syncs in "
             f"hooks; expected {want_c}, {want_m}, {want_syncs}")
    return calls, syncs


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
    host, "device": reader DAGs on the card, "matdims": materialized
    dims, served from the cache on a later run}; nparts is lineitem's
    partitions."""
    case = next((c for c in SQL_CASES if c[0] == q), None)
    if case is not None:
        _q, kname, absent, pairs = case
        return {"launches": {kname: nparts}, "absent": absent,
                "pairs": pairs * nparts, "fragments": 1,
                "dispatches": nparts, "host": 0, "device": 0, "matdims": 0}
    _q, frags, cold, host, readers, matdims = next(
        c for c in JOIN_CASES if c[0] == q)
    frags = frags + (cold if first else ())
    readers = readers[0 if first else 1]
    launches = {}
    for fact, kname in frags:
        if kname is not None:
            launches[kname] = launches.get(kname, 0) + \
                partitions_of(tk, fact)
    return {"launches": launches,
            "absent": tuple(k for k in KERNELS if k not in launches),
            "pairs": 0, "fragments": len(frags),
            "dispatches": sum(partitions_of(tk, t) for t in
                              [f for f, _ in frags] + list(readers)),
            "host": host[0 if first else 1], "device": len(readers),
            "matdims": matdims}


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
    no declined fused node, with route["host"] reader DAGs on the host,
    route["device"] on the card, and no fused fragment failing; each
    kernel in
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
            "copr_device_exec": route["device"],
            "fused_pipeline_fallback": 0, "fused_pipeline_error": 0}
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


def check_phase(q, i, snap, route, guarded, cuda=True, hook_syncs=0):
    """A statement's phase counters: no fused fragment fell back, the
    host ran only the route's reader DAGs, every fragment enqueue ran
    under the sync guard (`guarded` of them), and a warm run (i > 0)
    uploaded nothing (dims included) and made one dispatch and one sync
    per fact partition of its fragments, besides the `hook_syncs` of
    executor hooks (a sync is a wait on the card: `cuda` False, a CPU
    rehearsal, has none); a first run may rerun a partition while it
    learns, never fewer."""
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
    if syncs != (disp + hook_syncs if cuda else 0) or \
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


def program_state(dom):
    """The learned programs' entries in the copr's host cache, keyed by
    (program, key tail)."""
    kinds = {v: k for k, v in PROGRAM_STATE.items()}
    return {(kinds[k[0]], k[1:]): v
            for k, v in dom.copr._host_cache.items()
            if isinstance(k, tuple) and k and k[0] in kinds}


def program_route(state, keys):
    """What a query's learned programs hold, in words: the early
    compaction capacity, the top-N pin, the one-hot slot count."""
    out = []
    for key in keys:
        ec = state.get(("ecap", key))
        oh = state.get(("onehot", key))
        out.append({"ecap": ec,
                    "topn_off": bool(state.get(("topn", key))),
                    "onehot": oh["nslots"] if isinstance(oh, dict) else oh})
    return out


def partition_caps(tk, table):
    """The padded capacities of `table`'s fact partitions."""
    from tidb_tpu_torch.chunk.device import shape_bucket
    n, step = table_rows(tk, table), tk.domain.copr.device_rows
    return {shape_bucket(min(step, n - s)) for s in range(0, n, step)}


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
    one dispatch and one sync per partition besides the syncs of the
    executor hooks SQL_HOOKS names for the query (check_hooks: exactly
    those calls and syncs, no other hook). -> {query: warm median
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
        programs0 = program_state(dom)
        for i in range(2 + WARM_RUNS):
            checked = i == 1 + WARM_RUNS
            route = route_of(tk, q, nparts, i == 0)
            m0 = {c: dom.metrics.get(c, 0) for c in ROUTE_COUNTERS +
                  RETRY_COUNTERS + MATDIM_COUNTERS + HOOK_COUNTERS +
                  tuple(PROGRAM_COUNTERS.values())}
            c0 = dict(sk.COUNTS)
            g0 = guard.calls
            hs0, h0 = guard.hook_syncs, dict(guard.hook_calls)
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
            hooks, hook_syncs = check_hooks(
                f"{q} run {i}", dom, m0, guard, h0, hs0,
                *(SQL_HOOKS.get(q, ({}, 0)) if cuda else ({}, 0)))
            check_phase(q, i, snap, route, guard.calls - g0, cuda,
                        hook_syncs)
            retries = {c: dom.metrics.get(c, 0) - m0[c]
                       for c in RETRY_COUNTERS}
            if i > 0 and any(retries.values()):
                fail(f"{q} warm run {i}: learning reruns {retries}")
            mat = {c: dom.metrics.get(c, 0) - m0[c] for c in MATDIM_COUNTERS}
            want_mat = {"fused_matdim_build": route["matdims"] if i == 0
                        else 0,
                        "fused_matdim_hit": 0 if i == 0 else route["matdims"]}
            if mat != want_mat:
                fail(f"{q} run {i}: materialized dims {mat}, expected "
                     f"{want_mat}")
            if 0 < i and not checked:
                warm.append(ms)
            took = {p: dom.metrics.get(c, 0) - m0[c]
                    for p, c in PROGRAM_COUNTERS.items()}
            if checked and took["ecap"]:
                check_compacted(q, calls, partition_caps(tk, fact_of(q)),
                                took["ecap"])
            elif 0 < i:
                last_warm = (took, snap.get("fetch_bytes", 0),
                             list(NGROUPS))
            kind = "cold" if i == 0 else "checked" if checked else "warm"
            log(f"sql {q} {kind} {ms:.2f} ms {phase_line(snap)} launches=" +
                json.dumps({k: sk.COUNTS[k] - c0[k]
                            for k in route["launches"]}) +
                f" product_pairs="
                f"{sk.COUNTS['product_pairs'] - c0['product_pairs']}" +
                ("".join(f" {c}={n}" for c, n in
                         list(retries.items()) + list(mat.items()) if n)) +
                (f" hooks={json.dumps({k: n for k, n in hooks.items() if n})}"
                 if any(hooks.values()) else ""))
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
        state = program_state(dom)
        keys = list(dict.fromkeys(key for (prog, key), v in state.items()
                                  if programs0.get((prog, key)) != v))
        PROGRAMS[q] = {"took": last_warm[0], "keys": keys,
                       "fetch_bytes": last_warm[1],
                       "ngroups": last_warm[2]}
        log(f"sql {q}: programs of a warm statement (partitions served) "
            f"{json.dumps(last_warm[0])}; learned "
            f"{json.dumps(program_route(state, keys))}; partials fetched "
            f"per partition {last_warm[2]}; fetch_bytes {last_warm[1]}")
        meds[q] = statistics.median(warm)
        fact = fact_of(q)
        log(f"sql {q}: rows == {'expected' if q in exp else 'numpy oracle'}"
            f" ({len(want)} rows); warm median {meds[q]:.3f} ms, "
            f"{table_rows(tk, fact) / meds[q] * 1e3:.4g} {fact} rows/s")
    return meds


def check_compacted(q, calls, caps, served):
    """The checked statement of q ran `served` partitions compacted
    early: its kernel calls at a compacted size (n below every partition
    capacity of its fact table, `caps`), which checked_kernels held to
    their plain versions, must be there when it launched any. -> those
    calls."""
    small = [(name, shape) for name, shape in calls
             if int(shape.split()[0][2:]) < min(caps)]
    if calls and not small:
        fail(f"{q}: {served} partitions compacted early, but no kernel "
             f"call at a compacted size among {calls}")
    log(f"sql {q}: {served} partitions compacted early; kernel calls at "
        f"the compacted size == plain versions: "
        + ("; ".join(f"{name} {shape}" for name, shape in small) or "none"))
    return small


def pin_off(dom, prog, keys):
    """Set the reference's own off pin of `prog` under each of `keys`
    (host cache key tails): ecap "off", top-N True, one-hot False."""
    value = {"ecap": "off", "topn": True, "onehot": False}[prog]
    for key in keys:
        dom.copr._host_cache[(PROGRAM_STATE[prog],) + key] = value


def phase_programs(tk, exp):
    """Each learned program against the route it replaces, on the
    statements of phase_sql whose warm runs it served: the statement
    with the learned state as phase_sql left it ("on") and with the
    program's pin set off (pin_off, "off"), alternated WARM_RUNS times
    each after one settling run of each (the state is put back before
    every statement, so neither mode learns for the other), rows ==
    the committed rows every time; then one statement of each mode
    under torch.profiler (device busy ms). A finding, not a gate. ->
    {program: {query: {"on_ms", "off_ms" (warm medians), "on_device_ms",
    "off_device_ms", "on_fetch_bytes", "off_fetch_bytes",
    "on_ngroups", "off_ngroups" (partials per partition)}}}."""
    import torch
    from tidb_tpu_torch.bench.profile_tpch import _device_profile
    from tidb_tpu_torch.utils import phase
    hc = tk.domain.copr._host_cache
    out = {}
    for prog in PROGRAM_COUNTERS:
        for q, rec in PROGRAMS.items():
            if not rec["took"][prog]:
                continue
            sql, want = sql_and_rows(tk, exp, q)
            saved = dict(hc)
            ms = {"on": [], "off": []}
            seen = {}

            def run(mode, timed=True):
                hc.clear()
                hc.update(saved)
                if mode == "off":
                    pin_off(tk.domain, prog, rec["keys"])
                phase.reset()
                t0 = time.perf_counter()
                got = tk.must_query(sql)._norm()
                if timed:
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
                if got != want:
                    fail(f"programs {prog} {mode} {q}: rows {got} != "
                         f"expected {want}")
                seen[mode] = (phase.snap().get("fetch_bytes", 0),
                              list(NGROUPS))

            def profiled(mode):
                _wall, busy, _top, _m, _c = _device_profile(
                    torch, lambda: run(mode, timed=False), 1)
                return None if busy is None else busy * 1e3
            try:
                run("off", timed=False)
                run("on", timed=False)
                for i in range(WARM_RUNS):
                    for mode in (("on", "off") if i % 2 else ("off", "on")):
                        run(mode)
                dev = {mode: profiled(mode) for mode in ("on", "off")}
            finally:
                hc.clear()
                hc.update(saved)
            r = {}
            for mode in ("on", "off"):
                r[f"{mode}_ms"] = statistics.median(ms[mode])
                r[f"{mode}_device_ms"] = dev[mode]
                r[f"{mode}_fetch_bytes"], r[f"{mode}_ngroups"] = seen[mode]
            out.setdefault(prog, {})[q] = r
            log(f"programs {prog} {q}: warm median {r['on_ms']:.3f} ms "
                f"with it, {r['off_ms']:.3f} ms with its pin off; device "
                f"busy {dev['on']} / {dev['off']} ms; fetch_bytes "
                f"{r['on_fetch_bytes']} / {r['off_fetch_bytes']}; partials "
                f"per partition {r['on_ngroups']} / {r['off_ngroups']}")
    return out


# the reader phase (ROADMAP A.4): statements whose scans run
# outside a fused node, as reader DAGs on the card: (name, SQL, the
# reader DAG's table, the kernel it launches once per partition or None,
# the fused fragments around it (fact tables), whether it is a
# materialized dim's subplan, so that a later statement serves it from
# the cache). The filter (lineitem, over tidb_tpu_fragment_min_rows) and
# the top-N (ties in l_quantity) are plain reader DAGs; "runs" and
# "sorted" are the per-key counts a LEFT JOIN pre-aggregates (as Q13
# does): l_orderkey clusters in storage order (the runs lowering keeps
# it), l_partkey does not (the runs->sorted pin); "dense" and "global"
# are group-bys of a table under 4,096 rows, which the planner pushes to
# the reader DAG instead of a fused fragment.
READER_CASES = (
    ("filter", "select l_orderkey, l_partkey, l_extendedprice from lineitem"
     " where l_shipdate >= '1998-06-01' and l_discount = 0.1 order by "
     "l_orderkey, l_partkey", "lineitem", None, (), False),
    ("topn", "select l_orderkey, l_quantity, l_extendedprice from lineitem "
     "where l_shipdate < '1993-06-01' order by l_quantity desc limit 100",
     "lineitem", None, (), False),
    ("runs", "select c_count, count(*) as n from (select o_orderkey, "
     "count(l_orderkey) as c_count from orders left join lineitem on "
     "o_orderkey = l_orderkey and l_quantity <= 25 group by o_orderkey) as "
     "t group by c_count order by c_count", "lineitem", None, ("orders",),
     True),
    ("sorted", "select c_count, count(*) as n from (select p_partkey, "
     "count(l_partkey) as c_count from part left join lineitem on "
     "p_partkey = l_partkey and l_discount <= 0.05 group by p_partkey) as t "
     "group by c_count order by c_count", "lineitem", None, ("part",), True),
    ("dense", "select n_regionkey, count(*), sum(n_nationkey) from nation "
     "group by n_regionkey order by n_regionkey", "nation",
     "dense_group_sums", (), False),
    ("global", "select count(*), sum(n_nationkey) from nation where "
     "n_regionkey >= 1", "nation", "masked_sums", (), False),
)


def phase_reader(tk, guard, cases=READER_CASES):
    """Each reader statement on the card: cold, warm, and a third run
    (warm again; a materialized dim's subplan re-materializes, its cache
    emptied first, so its reader DAG runs with what it learned), then
    its host twin (copr.use_device = False) on the same TestKit, whose
    rows every run must equal as exact strings; a statement with a
    kernel runs once more under checked_kernels. Each run is held to its
    route: the reader DAG counted as copr_device_exec (no host scan), its
    fused fragments, one dispatch and one sync per partition after the
    first run (which may rerun a partition while it learns), no upload
    on a warm run whose columns are resident, every enqueue under the
    sync guard, no executor hook called. -> {name: {"warm_ms": warm median, "rematerialized_ms":
    the third run of a materialized dim's statement, "host_twin_ms"}}."""
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    copr = dom.copr
    cuda = copr.device.type == "cuda"
    out = {}
    for name, sql, table, kname, fused, matdim in cases:
        copr.use_device = False
        t0 = time.perf_counter()
        want = tk.must_query(sql)._norm()
        host_ms = (time.perf_counter() - t0) * 1e3
        copr.use_device = True
        warm, calls, remat = [], [], None
        for i in range(3 + (kname is not None)):
            checked = i == 3
            cached = matdim and i == 1
            if matdim and i == 2:
                copr._matdim_lru.clear()
                copr._matdim_bytes = 0
            parts = partitions_of(tk, table)
            nreader = 0 if cached else 1
            disp = sum(partitions_of(tk, f) for f in fused) + \
                nreader * parts
            m0 = {c: dom.metrics.get(c, 0) for c in ROUTE_COUNTERS +
                  RETRY_COUNTERS + HOOK_COUNTERS}
            c0 = dict(sk.COUNTS)
            g0 = guard.calls
            hs0, h0 = guard.hook_syncs, dict(guard.hook_calls)
            phase.reset()
            t0 = time.perf_counter()
            if checked:
                got, calls = checked_kernels(
                    lambda: tk.must_query(sql)._norm())
            else:
                got = tk.must_query(sql)._norm()
            ms = (time.perf_counter() - t0) * 1e3
            snap = phase.snap()
            check_hooks(f"reader {name} run {i}", dom, m0, guard, h0, hs0,
                        {}, 0)
            d = {c: dom.metrics.get(c, 0) - m0[c] for c in ROUTE_COUNTERS}
            retries = {c: dom.metrics.get(c, 0) - m0[c]
                       for c in RETRY_COUNTERS}
            launches = {k: sk.COUNTS[k] - c0[k] for k in KERNELS}
            if got != want:
                fail(f"reader {name} run {i}: rows {got[:5]}... "
                     f"({len(got)}) != host twin {want[:5]}... ({len(want)})")
            route = {"fused_pipeline_hit": len(fused),
                     "copr_host_exec": 0, "copr_device_exec": nreader,
                     "fused_pipeline_fallback": 0, "fused_pipeline_error": 0}
            if d != route:
                fail(f"reader {name} run {i}: routing counters {d}, "
                     f"expected {route}")
            n, guarded = snap.get("dispatches", 0), guard.calls - g0
            if n != guarded or snap.get("syncs", 0) != (n if cuda else 0):
                fail(f"reader {name} run {i}: {n} dispatches, {guarded} "
                     f"under the sync guard, {snap.get('syncs', 0)} syncs")
            if (n != disp) if i > 0 else (n < disp):
                fail(f"reader {name} run {i}: {n} dispatches, expected "
                     f"{disp}")
            if i > 0 and any(retries.values()):
                fail(f"reader {name} run {i}: learning reruns {retries}")
            if i > 0 and not (matdim and i == 2) and \
                    snap.get("upload_bytes", 0):
                fail(f"reader {name} warm run: uploaded "
                     f"{snap['upload_bytes']} bytes")
            want_l = {k: (nreader * parts if k == kname else 0)
                      for k in KERNELS}
            if launches != want_l:
                fail(f"reader {name} run {i}: launches {launches}, expected "
                     f"{want_l}")
            if i == 2 and matdim:
                remat = ms
            elif 0 < i < 3:
                warm.append(ms)
            kind = ("cold", "warm", "rematerialized" if matdim else "warm",
                    "checked")[i]
            log(f"reader {name} {kind} {ms:.2f} ms {phase_line(snap)} "
                f"launches={json.dumps({k: v for k, v in launches.items() if v})}"
                + "".join(f" {c}={v}" for c, v in retries.items() if v))
        if kname is not None:
            if [c[0] for c in calls] != [kname] * parts:
                fail(f"reader {name}: checked calls {calls}")
            log(f"reader {name}: kernel calls == plain versions on the same "
                "tensors: " + "; ".join(f"{c} {sh}" for c, sh in calls))
        out[name] = {"warm_ms": statistics.median(warm),
                     "rematerialized_ms": remat, "host_twin_ms": host_ms}
        log(f"reader {name}: rows == host twin ({len(want)} rows); warm "
            f"median {out[name]['warm_ms']:.3f} ms" +
            ("" if remat is None else f", rematerialized {remat:.3f} ms") +
            f", host twin {host_ms:.3f} ms")
    return out


# domain counters of the executor hooks: the routes taken, and the
# degrades that must not happen on the card
HOOK_COUNTERS = ("sort_device", "window_device", "device_join",
                 "sort_device_error", "window_device_error",
                 "device_join_fallback", "device_fallback")
# warm runs of each executor statement's host twin (after its cold run):
# one since the whole run passed 900 s (3 before; PERF.md section 4)
HOST_RUNS = 1


def phase_executor(tk, exp, guard, card=""):
    """The executor's device hooks (bench/tpch.py EXECUTOR_CASES: ORDER
    BYs, window functions and row-returning hash joins over customer and
    orders). Each statement runs first as its host twin
    (copr.use_device = False, tidb_join_exec = 'host'; once cold, then
    HOST_RUNS warm), whose rows must equal the reference's committed
    count and digest; then on the card under tidb_join_exec = 'auto'
    (cold, then WARM_RUNS warm; a CPU rehearsal sets 'device', since
    'auto' takes the device join only on the card), whose rows must
    equal the host twin's.
    Each run on the card calls each hook as often as the case says (the
    hooks' own counters and the sync guard's agree), counts no error or
    fallback, and makes exactly the case's syncs besides one per
    fragment dispatch, every hook under set_sync_debug_mode("error")
    but for its fetches. A statement's time is the host clock around
    TestKit.must_query, the rows' formatting as strings (_norm, for the
    comparison) left out. -> {name: {"card_ms", "hook_ms" (the
    statement's time inside its hooks), "host_twin_ms", "rows",
    "hook_upload_bytes"}}."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    copr = dom.copr
    cuda = copr.device.type == "cuda"
    out = {}
    for name, sql, hooks, syncs in tpch.EXECUTOR_CASES:
        copr.use_device = False
        tk.must_exec("set @@tidb_join_exec = 'host'")
        host_ms, want = [], None
        try:
            for i in range(1 + HOST_RUNS):
                h0 = dict(guard.hook_calls)
                t0 = time.perf_counter()
                res = tk.must_query(sql)
                ms = (time.perf_counter() - t0) * 1e3
                rows = res._norm()
                if guard.hook_calls != h0:
                    fail(f"executor {name}: the host twin called a hook")
                if want is None:
                    want = rows
                elif rows != want:
                    fail(f"executor {name}: host twin rows changed")
                if i:
                    host_ms.append(ms)
        finally:
            copr.use_device = True
            tk.must_exec("set @@tidb_join_exec = "
                         f"'{'auto' if cuda else 'device'}'")
        ref = exp.get(name)
        got_ref = {"rows": len(want), "sha256": tpch.rows_digest(want)}
        if ref is not None and got_ref != ref:
            fail(f"executor {name}: host twin {got_ref} != the reference's "
                 f"{ref}")
        warm, hook_ms = [], []
        for i in range(1 + WARM_RUNS):
            m0 = {c: dom.metrics.get(c, 0) for c in HOOK_COUNTERS}
            h0, hs0, g0 = dict(guard.hook_calls), guard.hook_syncs, \
                guard.calls
            hm0 = guard.hook_ms
            phase.reset()
            t0 = time.perf_counter()
            res = tk.must_query(sql)
            ms = (time.perf_counter() - t0) * 1e3
            snap = phase.snap()
            rows = res._norm()
            if rows != want:
                fail(f"executor {name} run {i}: rows != host twin "
                     f"({len(rows)} vs {len(want)} rows)")
            calls, _ = check_hooks(f"executor {name} run {i}", dom, m0,
                                   guard, h0, hs0, hooks,
                                   syncs if cuda else 0)
            disp = snap.get("dispatches", 0)
            if guard.calls - g0 != disp:
                fail(f"executor {name} run {i}: {disp} fragment "
                     f"dispatches, {guard.calls - g0} under the sync guard")
            if snap.get("syncs", 0) != ((syncs + disp) if cuda else 0):
                fail(f"executor {name} run {i}: {snap.get('syncs', 0)} "
                     f"syncs; expected {syncs} in hooks and {disp} of "
                     "fragments")
            if i:
                warm.append(ms)
                hook_ms.append(guard.hook_ms - hm0)
            log(f"executor {name} {'warm' if i else 'cold'} {ms:.2f} ms "
                f"(in hooks {guard.hook_ms - hm0:.2f} ms) "
                f"{phase_line(snap)} hook_upload_bytes="
                f"{snap.get('hook_upload_bytes', 0)} "
                f"hooks={json.dumps(calls)}")
        out[name] = {"card_ms": statistics.median(warm),
                     "hook_ms": statistics.median(hook_ms),
                     "host_twin_ms": statistics.median(host_ms),
                     "rows": len(want),
                     "hook_upload_bytes": snap.get("hook_upload_bytes", 0)}
        log(f"executor {name}: rows == host twin == reference "
            f"({len(want)} rows, sha256 {got_ref['sha256'][:16]}...); warm "
            f"median {out[name]['card_ms']:.3f} ms on {copr.device} "
            f"({out[name]['hook_ms']:.3f} ms in hooks), host twin "
            f"{out[name]['host_twin_ms']:.3f} ms ({card})")
    return out


# ---- the evaluator's builtin functions (bench/tpch.py BUILTIN_CASES) ----
# the counters a builtin statement's route moves: fused on the card, or
# declined by the device rule (a fused decline whose fallback's reader
# DAG the rule sends to the host: copr_host_bound)
BUILTIN_COUNTERS = ROUTE_COUNTERS + ("copr_host_bound", "device_fallback")
BUILTIN_ROUTES = {
    "fused": {"fused_pipeline_hit": 1},
    "declined": {"fused_pipeline_fallback": 1, "copr_host_exec": 1,
                 "copr_host_bound": 1}}
# the cases whose aggregates fit the scan kernels (kernel_aggs_fit, every
# argument an int64 with no NULL mask): one launch of the kernel per
# partition of their table; no other case launches one
BUILTIN_KERNELS = {"json_orders": "dense_group_sums",
                   "bits_orders": "dense_group_sums"}


def phase_builtins(tk, exp, guard, card=""):
    """The evaluator's device functions over the SF1 tables already
    loaded (bench/tpch.py BUILTIN_CASES: math on lineitem, casts, dates,
    strings, JSON text, bits over BIGINT UNSIGNED and NULL logic on
    orders, customer and part, and one shape the device rule declines).
    Each statement runs as its host twin (copr.use_device = False; cold,
    then warm), whose rows must equal the reference's committed count
    and digest (bench/builtins_sf1_expected.json), then on the card cold
    and WARM_RUNS warm (a declined shape: cold and one warm), whose rows
    must equal the host twin's. Each card run takes its route
    (BUILTIN_ROUTES: one fused fragment on the card, or the rule's
    decline with its reason) and no other; every fragment
    enqueue under the sync guard; a warm run makes one dispatch and one
    sync per partition of its table (at most 2), uploads nothing and
    builds no dictionary table (DICT_TABLE_STATS), a declined one
    dispatches nothing. A fused case runs once more after its warm runs
    through checked_kernels (not in the warm median): each scan kernel
    it launches is held to its plain version on the same tensors, and
    the cases of BUILTIN_KERNELS launch their kernel once per partition
    there, the others none. -> {name: {"card_ms", "host_twin_ms",
    "rows", "dispatches"}, "checked": [(case, kernel, shape)] of the
    compared calls, "seconds": the phase's wall time}."""
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.expression import vec as tvec
    from tidb_tpu_torch.utils import phase
    t_phase = time.perf_counter()
    dom = tk.domain
    copr = dom.copr
    cuda = copr.device.type == "cuda"
    table_of = {"math_lineitem": "lineitem", "dates_lineitem": "lineitem",
                "declined_cast_char": "customer",
                "strings_customer": "customer", "strings_part": "part"}
    out, checked_calls = {}, []
    for name, sql, route, reason in tpch.BUILTIN_CASES:
        host_ms, want = [], None
        f0 = fallbacks(dom)
        copr.use_device = False
        try:
            for i in range(2):
                t0 = time.perf_counter()
                rows = tk.must_query(sql)._norm()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                if want is None:
                    want = rows
                elif rows != want:
                    fail(f"builtins {name}: host twin rows changed")
        finally:
            copr.use_device = True
        for k, v in fallbacks(dom).items():
            TWIN_MOVES[k] = TWIN_MOVES.get(k, 0) + v - f0[k]
        got_ref = {"rows": len(want), "sha256": tpch.rows_digest(want)}
        if got_ref != exp.get(name):
            fail(f"builtins {name}: host twin {got_ref} != the reference's "
                 f"{exp.get(name)}")
        parts = partitions_of(tk, table_of.get(name, "orders"))
        disp_want = 0 if route == "declined" else parts
        if disp_want > 2:
            fail(f"builtins {name}: {parts} partitions")
        warm = []
        for i in range(2 if route == "declined" else 2 + WARM_RUNS):
            checked = route != "declined" and i == 1 + WARM_RUNS
            m0 = {c: dom.metrics.get(c, 0) for c in BUILTIN_COUNTERS}
            b0 = tvec.DICT_TABLE_STATS["builds"]
            g0 = guard.calls
            phase.reset()
            t0 = time.perf_counter()
            if checked:
                rows, calls = checked_kernels(lambda: tk.must_query(sql))
                rows = rows._norm()
            else:
                rows = tk.must_query(sql)._norm()
            ms = (time.perf_counter() - t0) * 1e3
            snap = phase.snap()
            if rows != want:
                fail(f"builtins {name} run {i}: rows {rows[:3]}... "
                     f"({len(rows)}) != host twin {want[:3]}... "
                     f"({len(want)})")
            d = {c: dom.metrics.get(c, 0) - m0[c] for c in BUILTIN_COUNTERS}
            d = {c: n for c, n in d.items() if n}
            if d != BUILTIN_ROUTES[route]:
                fail(f"builtins {name} run {i}: route {d}, expected "
                     f"{BUILTIN_ROUTES[route]} ({dom.last_fused_reason})")
            if reason is not None and dom.last_fused_reason != reason:
                fail(f"builtins {name} run {i}: declined as "
                     f"{dom.last_fused_reason!r}, expected {reason!r}")
            disp, syncs = snap.get("dispatches", 0), snap.get("syncs", 0)
            builds = tvec.DICT_TABLE_STATS["builds"] - b0
            if guard.calls - g0 != disp:
                fail(f"builtins {name} run {i}: {disp} dispatches, "
                     f"{guard.calls - g0} under the sync guard")
            if syncs != (disp if cuda else 0) or \
                    (disp != disp_want if i else disp < disp_want):
                fail(f"builtins {name} run {i}: {phase_line(snap)}; "
                     f"expected {disp_want} dispatches and syncs")
            if i and (snap.get("upload_bytes", 0) or builds):
                fail(f"builtins {name} warm run {i}: {phase_line(snap)}, "
                     f"{builds} dictionary tables built")
            if checked:
                kern = BUILTIN_KERNELS.get(name)
                names = [c[0] for c in calls]
                if names != ([kern] * parts if kern else []):
                    fail(f"builtins {name}: the checked run launched "
                         f"{calls}, expected {kern or 'no kernel'} once "
                         f"per partition ({parts})")
                checked_calls.extend((name,) + c for c in calls)
                log(f"builtins {name} checked run {ms:.2f} ms: "
                    f"{len(calls)} kernel calls == their plain versions "
                    f"{[c[1] for c in calls]}")
                continue
            if i:
                warm.append(ms)
            log(f"builtins {name} {'warm' if i else 'cold'} {ms:.2f} ms "
                f"{phase_line(snap)} dict_table_builds={builds}")
        out[name] = {"card_ms": statistics.median(warm),
                     "host_twin_ms": host_ms[1], "rows": len(want),
                     "dispatches": disp_want}
        log(f"builtins {name}: rows == host twin == reference ({len(want)} "
            f"rows, sha256 {got_ref['sha256'][:16]}...; route {route}"
            + (f", {reason}" if reason else "") + f"); warm median "
            f"{out[name]['card_ms']:.3f} ms on {copr.device}, host twin "
            f"{host_ms[1]:.3f} ms ({card})")
    if not checked_calls:
        fail("builtins: no kernel call was held to its plain version")
    out["checked"] = checked_calls
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- vector search (ROADMAP A.8) ----------------------------------------
# The corpus has ann-benchmarks' sift-128-euclidean shape (SIFT1M: 10^6
# rows of 128 float dimensions) as a seeded mixture of Gaussians, as
# scripts/vector_smoke.py makes its own: centers * 4, noise 0.35, about
# 244 rows per center (vector_smoke: 195), 4 decimals of text per value.
# 10^6 rows cut to 500,000 (PERF.md section 4: the whole run passed 900 s
# with the cluster phase), then to 250,000 (it passed 1,200 s on a slow
# host), about 61 rows per center.
VEC_ROWS, VEC_DIM, VEC_CENTERS, VEC_BLOCK = 250_000, 128, 4096, 1 << 16
VEC_EDGE_ROWS, VEC_DUPS, VEC_NULLS = 1 << 16, 30, 3
# the edge table's copies of row 123 start 3 rows before the boundary of
# its first two shards on phase_mpp's mesh (81,920 rows of capacity over
# MPP_SHARDS = 4: 20,480 a shard), so the tied slate straddles it there
VEC_DUP_AT = 20_480 - 3
VEC_K, VEC_QUERIES, VEC_INSERTS = 10, 20, 5
VEC_RECALL = 0.95
FP32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores


def vector_block(b, nrows):
    """Rows [b * VEC_BLOCK, (b + 1) * VEC_BLOCK) of an nrows corpus
    (float32), from the seed alone, so that worker processes make them
    alike."""
    import numpy as np
    centers = np.random.default_rng([SEED, 1 << 20]).standard_normal(
        (VEC_CENTERS, VEC_DIM), dtype=np.float32) * np.float32(4.0)
    rng = np.random.default_rng([SEED, b])
    n = min(VEC_BLOCK, nrows - b * VEC_BLOCK)
    lab = rng.integers(0, VEC_CENTERS, n)
    return centers[lab] + rng.standard_normal(
        (n, VEC_DIM), dtype=np.float32) * np.float32(0.35)


def vector_block_texts(b_nrows):
    """A block's rows (vector_block) as VECTOR text, 4 decimals per
    value."""
    import io
    import numpy as np
    buf = io.StringIO()
    np.savetxt(buf, vector_block(*b_nrows), fmt="%.4f", delimiter=",")
    return ["[" + line + "]" for line in buf.getvalue().split("\n")[:-1]]


def vec_text(v):
    return "[" + ",".join(f"{x:.4f}" for x in v) + "]"


def vec_query(v):
    """The float32 vector the engine parses from vec_text(v)."""
    from tidb_tpu_torch.expression.vec import _parse_vec_text
    return _parse_vec_text(vec_text(v))


def vector_load(tk):
    """The corpus through the IMPORT INTO path (ColumnarTable.bulk_append:
    no row KV), its text made by one process per core. Table vcorpus
    (id, grp = id % 100, e VECTOR(128)); table vedge: the first
    VEC_EDGE_ROWS rows with VEC_DUPS copies of row 123 at VEC_DUP_AT, then
    VEC_NULLS NULL vectors. -> (the stored float32 matrix as parsed from
    the text, seconds)."""
    import multiprocessing
    import numpy as np
    t0 = time.perf_counter()
    nblocks = -(-VEC_ROWS // VEC_BLOCK)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, min(os.cpu_count() or 1, 16))) as pool:
        texts = [t for part in pool.map(
            vector_block_texts, [(b, VEC_ROWS) for b in range(nblocks)])
            for t in part]
    t_text = time.perf_counter() - t0
    dom = tk.domain
    tk.must_exec(f"create table vcorpus (id bigint primary key, grp bigint, "
                 f"e vector({VEC_DIM}))")
    tk.must_exec(f"create table vedge (id bigint primary key, "
                 f"e vector({VEC_DIM}))")
    ids = np.arange(VEC_ROWS, dtype=np.int64)
    tbl = dom.infoschema().table_by_name("test", "vcorpus")
    ctab = dom.columnar.table(tbl)
    ctab.bulk_append({"id": ids, "grp": ids % 100,
                      "e": np.array(texts, dtype=object)}, VEC_ROWS,
                     handles=ids + 1)
    ne = VEC_EDGE_ROWS + VEC_DUPS + VEC_NULLS
    etexts = np.array(texts[:VEC_DUP_AT] + [texts[123]] * VEC_DUPS +
                      texts[VEC_DUP_AT:VEC_EDGE_ROWS] + ["[]"] * VEC_NULLS,
                      dtype=object)
    enull = np.zeros(ne, dtype=bool)
    enull[-VEC_NULLS:] = True
    etab = dom.columnar.table(dom.infoschema().table_by_name("test",
                                                             "vedge"))
    etab.bulk_append({"id": np.arange(ne, dtype=np.int64), "e": etexts}, ne,
                     handles=np.arange(1, ne + 1, dtype=np.int64),
                     nulls={"e": enull})
    t_bulk = time.perf_counter() - t0 - t_text
    stored, n = ctab.vector_matrix(tbl.find_column("e").id, VEC_DIM)
    secs = time.perf_counter() - t0
    log(f"vector load: {VEC_ROWS} x VECTOR({VEC_DIM}) in {secs:.1f} s "
        f"(text {t_text:.1f} s in {nblocks} blocks, bulk_append "
        f"{t_bulk:.1f} s, parse into the float32 matrix "
        f"{secs - t_text - t_bulk:.1f} s); {n} rows")
    if n != VEC_ROWS or np.isnan(stored).any():
        fail("vector load: the parsed matrix has NaN rows or a wrong length")
    return stored, secs


def edge_want():
    """The edge statement's ids: the NULL vectors first, then row 123 and
    the lowest of its tied copies."""
    ne = VEC_EDGE_ROWS + VEC_DUPS + VEC_NULLS
    return list(range(ne - VEC_NULLS, ne)) + [123] + list(
        range(VEC_DUP_AT, VEC_DUP_AT + VEC_K - VEC_NULLS - 1))


def vec_sql(q, metric="vec_l2_distance", where="", table="vcorpus"):
    return (f"select id from {table} {where}order by "
            f"{metric}(e, '{vec_text(q)}') limit {VEC_K}")


def vector_mesh_cases(queries, stored):
    """The statements phase_mpp runs on the mesh, each held to its rows on
    the single card (recorded at the end of phase_vector, after its
    inserts): (name, tidb_tpu_vector_nprobe, sql). nprobe 0 keeps the
    indexed vcorpus on the exact path."""
    q0 = queries[0]
    return [("exact_l2", 0, vec_sql(q0)),
            ("exact_cosine", 0, vec_sql(q0, "vec_cosine_distance")),
            ("exact_negative_inner", 0,
             vec_sql(q0, "vec_negative_inner_product")),
            ("edge", 0, vec_sql(stored[123], table="vedge")),
            ("hybrid", 0, vec_sql(q0, where="where grp = 7 ")),
            ("ivf", 8, vec_sql(queries[1]))]


def l2_oracle(stored64, q, k, mask=None):
    """Top-k ids by float64 L2 over the stored vectors (stable)."""
    import numpy as np
    d = np.sqrt(((stored64 - q.astype(np.float64)) ** 2).sum(1))
    if mask is not None:
        d = np.where(mask, d, np.inf)
    return [int(i) for i in np.argsort(d, kind="stable")[:k]]


FALLBACK_LABELS = (("VECTOR_SEARCH", "host_fallback"),
                   ("VECTOR_SEARCH", "hybrid_host_fallback"),
                   ("ML_PREDICT", "host_fallback"))


def fallbacks(dom):
    """Counters a degrade or a host fallback moves, less what the host
    twin runs (copr.use_device = False, counted as served by the host)
    moved (TWIN_MOVES)."""
    from tidb_tpu_torch.utils import metrics as mu
    out = {f"{m}.{lab}": getattr(mu, m).labels(lab).value
           for m, lab in FALLBACK_LABELS}
    for c in ("device_fallback", "device_dispatch_error", "device_retry"):
        out[c] = dom.metrics.get(c, 0)
    return {k: v - TWIN_MOVES.get(k, 0) for k, v in out.items()}


TWIN_MOVES = {}


def host_twin(tk, sql):
    """`sql`'s rows as the host twin computes them (copr.use_device =
    False, same process), with the fallback counters it moves set apart
    in TWIN_MOVES. -> (rows, ms)."""
    dom = tk.domain
    f0 = fallbacks(dom)
    dom.copr.use_device = False
    try:
        t0 = time.perf_counter()
        rows = tk.must_query(sql).rows
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        dom.copr.use_device = True
    for k, v in fallbacks(dom).items():
        TWIN_MOVES[k] = TWIN_MOVES.get(k, 0) + v - f0[k]
    return rows, ms


def vector_run(tk, guard, sql, label, runs, twin=True):
    """`sql` cold once, then `runs` warm, every program enqueue under the
    sync guard; the last warm run's rows are held to the host twin's
    (copr.use_device = False, same process). A warm run: at most 2
    dispatches (all under the guard) and 1 sync, no upload. -> (rows,
    warm median ms, last warm phase snapshot)."""
    from tidb_tpu_torch.utils import phase
    warm, rows = [], None
    for i in range(1 + runs):
        g0 = guard.calls
        phase.reset()
        t0 = time.perf_counter()
        got = tk.must_query(sql).rows
        ms = (time.perf_counter() - t0) * 1e3
        snap = phase.snap()
        if rows is not None and got != rows:
            fail(f"vector {label} run {i}: rows changed")
        rows = got
        disp = snap.get("dispatches", 0)
        if guard.calls - g0 != disp or snap.get("device_fallbacks", 0):
            fail(f"vector {label} run {i}: {disp} dispatches, "
                 f"{guard.calls - g0} under the sync guard, "
                 f"{snap.get('device_fallbacks', 0)} fallbacks")
        if i:
            warm.append(ms)
            if disp > 2 or snap.get("syncs", 0) > 1 or \
                    snap.get("upload_bytes", 0):
                fail(f"vector {label} warm run {i}: {phase_line(snap)}")
        log(f"vector {label} {'warm' if i else 'cold'} {ms:.2f} ms "
            f"{phase_line(snap)} query_upload_bytes="
            f"{snap.get('query_upload_bytes', 0)}")
    if twin:
        twin, host_ms = host_twin(tk, sql)
        if twin != rows:
            fail(f"vector {label}: rows {rows} != host twin {twin}")
        log(f"vector {label}: rows == host twin ({host_ms:.1f} ms)")
    return rows, statistics.median(warm), snap


def phase_vector(tk, guard, card):
    """Vector search at SIFT1M's shape (VEC_ROWS x VECTOR(VEC_DIM)): warm
    exact top-10 (L2 x WARM_RUNS, cosine, negative inner product), the
    tie/NULL edge table, a hybrid search at 1 % selectivity, CREATE
    VECTOR INDEX ... USING IVF trained on the card, IVF searches at the
    default nprobe (recall@10 >= VEC_RECALL against the float64 numpy
    oracle), then a stream of inserts folded through the vector/delta
    patch and the index's delta path. Rows == the host twin's; no
    fallback. -> {"ms": {...}, "programs": [...]}."""
    import numpy as np
    import torch
    from tidb_tpu_torch.utils import metrics as mu
    from tidb_tpu_torch.utils import phase
    from tidb_tpu_torch.vector.ivf import KMEANS_ITERS
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is on: float32 products would keep ~3 digits")
    log("vector: TF32 off (matmul, cudnn), float32 matmul precision "
        "'highest'")
    dom = tk.domain
    f0 = fallbacks(dom)
    stored, load_s = vector_load(tk)
    stored64 = stored.astype(np.float64)
    rng = np.random.default_rng([SEED, 1 << 21])
    qrows = rng.integers(0, VEC_ROWS, VEC_QUERIES)
    queries = stored[qrows] + rng.standard_normal(
        (VEC_QUERIES, VEC_DIM), dtype=np.float32) * np.float32(0.15)
    ms = {"load_s": load_s}

    # exact, three metrics
    q0 = queries[0]
    rows, ms["exact_l2"], snap = vector_run(tk, guard, vec_sql(q0),
                                            "exact l2", WARM_RUNS)
    want = l2_oracle(stored64, vec_query(q0), VEC_K)
    if [r[0] for r in rows] != want:
        fail(f"vector exact l2: {rows} != the float64 oracle {want}")
    if mu.VECTOR_SEARCH.labels("exact").value < 1 + WARM_RUNS:
        fail("vector exact l2 did not take the exact device path")
    for metric in ("vec_cosine_distance", "vec_negative_inner_product"):
        _r, ms["exact_" + metric[4:-9]], _s = vector_run(
            tk, guard, vec_sql(q0, metric), "exact " + metric, 2)
    # ties across the 10th row and NULL vectors first
    edge, _m, _s = vector_run(tk, guard, vec_sql(
        stored[123], table="vedge"), "edge (ties, NULLs)", 2)
    want = edge_want()
    if [r[0] for r in edge] != want:
        fail(f"vector edge: {edge} != NULLs first, then the lowest of the "
             f"tied rows {want}")
    # hybrid at 1 % selectivity
    hyb, ms["hybrid"], _s = vector_run(
        tk, guard, vec_sql(q0, where="where grp = 7 "), "hybrid 1%",
        WARM_RUNS)
    want = l2_oracle(stored64, vec_query(q0), VEC_K,
                     np.arange(VEC_ROWS) % 100 == 7)
    if [r[0] for r in hyb] != want:
        fail(f"vector hybrid: {hyb} != the float64 oracle {want}")
    # IVF
    t0 = time.perf_counter()
    tk.must_exec("create vector index vidx on vcorpus (e) using ivf")
    phase.reset()
    k0 = guard.calls
    first = tk.must_query(vec_sql(queries[1])).rows
    ms["ivf_build_s"] = time.perf_counter() - t0
    index = dom.vector.indexes()[0][1]
    log(f"vector ivf: CREATE VECTOR INDEX + first search (trains "
        f"{len(index.centroids)} lists over {VEC_ROWS} rows, "
        f"{KMEANS_ITERS} Lloyd steps on the card) "
        f"{ms['ivf_build_s']:.2f} s {phase_line(phase.snap())}; "
        f"{guard.calls - k0} programs under the sync guard")
    hits = 0
    ivf_warm = []
    for i, q in enumerate(queries):
        sql = vec_sql(q)
        rows, med, _s = vector_run(tk, guard, sql, f"ivf q{i}",
                                   WARM_RUNS if i == 0 else 1,
                                   twin=i < 3)
        ivf_warm.append(med)
        got = [r[0] for r in rows]
        if i == 1 and got != [r[0] for r in first]:
            fail("vector ivf: the first search's rows changed")
        hits += len(set(got) & set(l2_oracle(stored64, vec_query(q),
                                             VEC_K)))
    recall = hits / (VEC_K * VEC_QUERIES)
    ms["ivf"] = ivf_warm[0]
    if mu.VECTOR_SEARCH.labels("ivf").value < VEC_QUERIES:
        fail("vector ivf: the searches did not take the IVF path")
    log(f"vector ivf: recall@{VEC_K} {recall:.4f} over {VEC_QUERIES} "
        f"queries at nprobe 8 (gate {VEC_RECALL}); warm {ms['ivf']:.3f} "
        f"ms vs exact {ms['exact_l2']:.3f} ms: IVF/exact rate "
        f"{ms['exact_l2'] / ms['ivf']:.2f}x ({card})")
    if recall < VEC_RECALL:
        fail(f"vector ivf: recall@{VEC_K} {recall} < {VEC_RECALL}")
    # a stream of inserts: the resident matrix patches its tail, the
    # index folds the new rows, and they are found
    app0 = mu.VECTOR_INDEX_DELTA.labels("applied").value
    reb0 = mu.VECTOR_INDEX_DELTA.labels("rebuild").value
    patches = 0
    for j in range(VEC_INSERTS):
        base = VEC_ROWS + 100 * j
        new = stored[(base + np.arange(100)) % VEC_ROWS] + np.float32(0.5)
        tk.must_exec("insert into vcorpus values " + ",".join(
            f"({base + r}, {(base + r) % 100}, '{vec_text(v)}')"
            for r, v in enumerate(new)))
        for metric, where in (("vec_l2_distance", ""),
                              ("vec_l2_distance", "where grp = 7 ")):
            phase.reset()
            q = new[7]
            got = tk.must_query(vec_sql(q, metric, where)).rows
            snap = phase.snap()
            patches += snap.get("delta_applies", 0)
            if got[0][0] != base + 7:
                fail(f"vector insert {j}: the new row {base + 7} is not "
                     f"first in {got}")
        tk.must_exec("set @@tidb_tpu_vector_nprobe = 0")
        phase.reset()
        got = tk.must_query(vec_sql(new[3])).rows
        patches += phase.snap().get("delta_applies", 0)
        tk.must_exec("set @@tidb_tpu_vector_nprobe = 8")
        if got[0][0] != base + 3:
            fail(f"vector insert {j}: exact search missed row {base + 3}")
    applied = mu.VECTOR_INDEX_DELTA.labels("applied").value - app0
    rebuilt = mu.VECTOR_INDEX_DELTA.labels("rebuild").value - reb0
    log(f"vector inserts: {VEC_INSERTS} x 100 rows; vector/delta patches "
        f"{patches}, index folds {applied}, rebuilds {rebuilt}")
    if patches < 1 or applied < 1 or rebuilt:
        fail("vector inserts did not fold through the delta paths")
    # the single card's rows and warm medians of phase_mpp's statements,
    # after the inserts (its exact L2 and hybrid rows are also held to the
    # oracle there)
    cases = vector_mesh_cases(queries, stored)
    single = {}
    for name, nprobe, sql in cases:
        tk.must_exec(f"set @@tidb_tpu_vector_nprobe = {nprobe}")
        rows, med, _s = vector_run(tk, guard, sql, f"single {name}", 2,
                                   twin=False)
        single[name] = (rows, med)
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 8")
    f1 = fallbacks(dom)
    if f1 != f0:
        fail(f"vector: fallback counters moved {f0} -> {f1}")
    return {"ms": ms, "programs": vector_programs(tk, index, queries,
                                                  card),
            "recall": recall, "mesh_cases": cases, "single": single,
            "stored": stored}


def vector_programs(tk, index, queries, card):
    """Each vector program's device time at the phase's shapes (CUDA
    events, warm median after a 1 GiB flush), beside its bound: the top-k
    and IVF programs read their inputs once (bytes at HBM_BYTES_PER_S);
    the k-means step and the assignment do 2 * rows * dim * lists
    float32 operations (FP32_FLOPS, no TF32); the tail patch copies the
    buffer (read and write) and writes its delta."""
    import numpy as np
    import torch
    from tidb_tpu_torch.chunk.device import shape_bucket
    from tidb_tpu_torch.vector import kernels as vk
    from tidb_tpu_torch.vector.runtime import _kcap
    dom = tk.domain
    copr = dom.copr
    tbl = dom.infoschema().table_by_name("test", "vcorpus")
    ctab = copr.engine.table(tbl)
    cid = tbl.find_column("e").id
    dmat, n, cap = dom.vector.device_matrix(copr, ctab, cid, VEC_DIM)
    valid = torch.zeros(cap, dtype=torch.bool, device="cuda")
    valid[:n] = True
    q = torch.from_numpy(queries[0]).cuda()
    flush = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kcap = _kcap(VEC_K, n)
    out = []

    def rec(name, src, replaces, per_stmt, fn, bound_ms, by, library=None):
        t = time_ms(fn, iters=10, flush=flush)
        lib = None if library is None else time_ms(library, iters=10,
                                                   flush=flush)
        out.append({"name": name, "source": src, "replaces": replaces,
                    "launches_per_statement": per_stmt, "ms": t,
                    "bound_ms": bound_ms, "bound_by": by,
                    "library_ms": lib})
        log(f"program {name}: {t:.4f} ms, bound {bound_ms:.4f} ms "
            f"({by}), {per_stmt}" +
            ("" if lib is None else f", library {lib:.4f} ms") +
            f" ({card})")
    topk = vk.build_topk_kernel("vec_l2_distance", kcap)
    rec("exact_topk", "tidb_tpu_torch/vector/kernels.py:build_topk_kernel",
        "tidb_tpu/vector/kernels.py:58", "1 per exact search",
        lambda: topk(dmat, valid, q),
        (cap * VEC_DIM * 4 + cap) / HBM_BYTES_PER_S * 1e3, "bytes",
        library=lambda: torch.topk(torch.cdist(dmat, q[None])[:, 0],
                                   kcap, largest=False))
    cand_np = index.candidates(queries[0], "vec_l2_distance", 8)
    ccap = shape_bucket(len(cand_np))
    cand = torch.zeros(ccap, dtype=torch.int32, device="cuda")
    cand[:len(cand_np)] = torch.from_numpy(cand_np.astype(np.int32)).cuda()
    cval = torch.zeros(ccap, dtype=torch.bool, device="cuda")
    cval[:len(cand_np)] = True
    ivf = vk.build_ivf_score_kernel("vec_l2_distance",
                                    _kcap(VEC_K, len(cand_np)))
    rec("ivf_score", "tidb_tpu_torch/vector/kernels.py:"
        "build_ivf_score_kernel", "tidb_tpu/vector/kernels.py:73",
        f"1 per IVF search ({len(cand_np)} candidates)",
        lambda: ivf(dmat, cand, cval, q),
        (len(cand_np) * (VEC_DIM * 4 + 5)) / HBM_BYTES_PER_S * 1e3,
        "bytes")
    cent = torch.from_numpy(index.centroids).cuda()
    nlist = cent.shape[0]
    step = vk.build_kmeans_step()
    flops = 2 * cap * VEC_DIM * nlist
    rec("kmeans_step", "tidb_tpu_torch/vector/kernels.py:build_kmeans_step"
        " (index_add_ into float64)", "tidb_tpu/vector/kernels.py:89",
        "8 per index build", lambda: step(dmat, valid, cent),
        flops / FP32_FLOPS * 1e3, "operations")
    assign = vk.build_assign_kernel()
    rec("assign", "tidb_tpu_torch/vector/kernels.py:build_assign_kernel",
        "tidb_tpu/vector/kernels.py:111", "1 per posting build or "
        "fold of >= 4096 rows", lambda: assign(dmat[:n], cent),
        2 * n * VEC_DIM * nlist / FP32_FLOPS * 1e3, "operations")
    upd = torch.zeros((128, VEC_DIM), dtype=torch.float32, device="cuda")
    rec("tail_patch", "tidb_tpu_torch/vector/kernels.py:patch_rows",
        "tidb_tpu/vector/runtime.py:253", "1 per search after an insert",
        lambda: vk.patch_rows(dmat, upd, n - 128),
        (2 * cap * VEC_DIM * 4 + upd.numel() * 8) / HBM_BYTES_PER_S * 1e3,
        "bytes")
    del flush
    return out


# ---- in-SQL inference (ROADMAP A.8) --------------------------------------
# predict() fused in a filter over SF1 lineitem (a ReLU MLP 4 -> 256 ->
# 128 -> 1) and standalone over orders (2 -> 64 -> 1); weights from the
# seed, the first layer scaled by each feature's magnitude so that the
# scores are of order 1, the last bias set so that about half the rows
# pass the filter.
ML_FUSED = ("select sum(l_extendedprice), count(*) from lineitem where "
            "predict(m, l_quantity, l_extendedprice, l_discount, l_tax) > 0")
ML_STANDALONE = ("select o_orderkey, predict(m2, o_totalprice, "
                 "o_shippriority) from orders")
ML_FEATURES = {"m": (("l_quantity", 25.5), ("l_extendedprice", 38000.0),
                     ("l_discount", 0.05), ("l_tax", 0.04)),
               "m2": (("o_totalprice", 150000.0), ("o_shippriority", 1.0))}
ML_LAYERS = {"m": (4, 256, 128, 1), "m2": (2, 64, 1)}


def ml_features(tk, model, table):
    """The model's feature matrix as _op_predict builds it on the host:
    each column's stored int64 (decimals scaled) to float64, divided by
    its scale, to float32."""
    import numpy as np
    from tidb_tpu_torch.types.field_type import TypeClass
    dom = tk.domain
    tbl = dom.infoschema().table_by_name("test", table)
    ctab = dom.columnar.tables[tbl.id]
    cols = []
    for name, _s in ML_FEATURES[model]:
        ci = tbl.find_column(name)
        a = ctab.data[ci.id][:ctab.n].astype(np.float64)
        scale = max(ci.ft.decimal, 0) \
            if ci.ft.tclass == TypeClass.DECIMAL else 0
        cols.append((a / float(10 ** scale)).astype(np.float32))
    return np.stack(cols, axis=1)


def ml_weights(tk, model, table):
    """Seeded weights; the last bias centres the scores of the table's
    rows on 0."""
    import numpy as np
    from tidb_tpu_torch.ml.kernels import host_forward
    rng = np.random.default_rng([SEED, len(model)])
    dims = ML_LAYERS[model]
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    ws[0] = (ws[0] / np.array([s for _n, s in ML_FEATURES[model]],
                              dtype=np.float32)[:, None]).astype(np.float32)
    bs = [(rng.standard_normal(b) * 0.1).astype(np.float32)
          for b in dims[1:]]
    X = ml_features(tk, model, table)
    y = host_forward(X[::7], ws, bs)
    bs[-1] = (bs[-1] - np.float32(np.median(y))).astype(np.float32)
    return ws, bs


def ml_run(tk, guard, sql, label, nparts, checked=False):
    """cold once, WARM_RUNS warm, then (checked) one more with every
    kernel call held to its plain version on the same tensors. Warm: one
    dispatch and one sync per partition of its fragment (standalone:
    one of each), under the sync guard, no upload (weights, features).
    -> (rows of the last run, warm median ms, checked calls)."""
    from tidb_tpu_torch.utils import phase
    syncs_per = nparts if tk.domain.copr.device.type == "cuda" else 0
    warm, calls, rows = [], [], None
    for i in range(2 + WARM_RUNS if checked else 1 + WARM_RUNS):
        g0 = guard.calls
        phase.reset()
        t0 = time.perf_counter()
        if i == 1 + WARM_RUNS:
            res, calls = checked_kernels(lambda: tk.must_query(sql))
        else:
            res = tk.must_query(sql)
        ms = (time.perf_counter() - t0) * 1e3
        snap = phase.snap()
        rows = res.rows
        disp, syncs = snap.get("dispatches", 0), snap.get("syncs", 0)
        if guard.calls - g0 != disp:
            fail(f"ml {label} run {i}: {disp} dispatches, "
                 f"{guard.calls - g0} under the sync guard")
        if i and (disp != nparts or syncs != syncs_per or
                  snap.get("upload_bytes", 0)):
            fail(f"ml {label} warm run {i}: {phase_line(snap)}; expected "
                 f"{nparts} dispatches and syncs, no upload")
        if 0 < i <= WARM_RUNS:
            warm.append(ms)
        log(f"ml {label} {'warm' if i else 'cold'} {ms:.2f} ms "
            f"{phase_line(snap)} ml_rows={snap.get('ml_rows', 0)}")
    return rows, statistics.median(warm), calls


def cents(v):
    from decimal import Decimal
    return int(Decimal(str(v)) * 100)


def ulp32(x):
    import numpy as np
    return np.spacing(np.abs(np.float32(x)).astype(np.float32))


def phase_ml(tk, guard, card, nparts):
    """CREATE MODEL from npz files the phase writes from the seed, then
    predict() fused in a filter over SF1 lineitem (the fused fragment;
    masked_sums once per partition, held to its plain version) and
    standalone over the 1,500,000 orders (MLPredictExec). The fused sum
    and count equal the host's (the numpy forward over the features as
    _op_predict builds them on the host, the computation the host twin
    runs), but for rows whose score the card and the host put on two
    sides of 0, each of which must lie within 4 ulp of 0 at the scale
    of its last layer's terms (named in the log); standalone values,
    in table order, within rtol 1e-5 of the host's.
    -> {"ms": ..., "programs": [...], "fused", "models"}."""
    import shutil
    import tempfile
    import numpy as np
    from tidb_tpu_torch.expression import vec as _vec
    from tidb_tpu_torch.ml.kernels import host_forward
    from tidb_tpu_torch.utils import metrics as mu
    dom = tk.domain
    copr = dom.copr
    f0 = fallbacks(dom)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ml_")
    models = {}
    try:
        for model, table in (("m", "lineitem"), ("m2", "orders")):
            ws, bs = ml_weights(tk, model, table)
            path = os.path.join(tmp, model + ".npz")
            np.savez(path, **{f"W{i}": w for i, w in enumerate(ws)},
                     **{f"b{i}": b for i, b in enumerate(bs)})
            tk.must_exec(f"create model {model} from '{path}'")
            models[model] = (ws, bs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms = {}
    # fused: record each fragment call's scores (device tensors, read
    # after the statement)
    scores = []
    orig = _vec._REGISTRY["predict"]

    def recording(ctx, e):
        out = orig(ctx, e)
        if not ctx.host:
            scores.append(out[0])
        return out
    _vec._REGISTRY["predict"] = recording
    try:
        m0 = dom.metrics.get("fused_pipeline_hit", 0)
        scores.clear()
        rows, ms["fused"], calls = ml_run(tk, guard, ML_FUSED, "fused",
                                          nparts, checked=True)
        if dom.metrics.get("fused_pipeline_hit", 0) - m0 != 2 + WARM_RUNS:
            fail("ml fused: the statement did not run as a fused fragment")
        if len(scores) != (2 + WARM_RUNS) * nparts:
            fail(f"ml fused: {len(scores)} predict() calls in fragments, "
                 f"expected one per partition and statement")
        last = [s.float().cpu().numpy() for s in scores[-nparts:]]
    finally:
        _vec._REGISTRY["predict"] = orig
    ms_calls = [c for c in calls if c[0] == "masked_sums"]
    if len(ms_calls) != nparts:
        fail(f"ml fused: {len(ms_calls)} checked masked_sums calls, "
             f"expected {nparts}")
    log("ml fused: kernel calls == plain versions on the same tensors: "
        + "; ".join(f"{n} {s}" for n, s in calls))
    ws, bs = models["m"]
    X = ml_features(tk, "m", "lineitem")
    n = len(X)
    y = host_forward(X, ws, bs)
    step = copr.device_rows
    dev_y = np.concatenate([s[:min(step, n - k * step)]
                            for k, s in enumerate(last)])
    flips = np.nonzero((dev_y > 0) != (y > 0))[0]
    h = X[flips]
    for W, b in zip(ws[:-1], bs[:-1]):
        h = np.maximum(h @ W + b, np.float32(0))
    terms = np.abs(h * ws[-1][:, 0]).sum(1) + abs(float(bs[-1][0]))
    for r, yh, yd, s in zip(flips, y[flips], dev_y[flips], terms):
        log(f"ml fused: row {r} score host {yh!r} card {yd!r} (4 ulp of its "
            f"terms {4 * ulp32(s)!r})")
        if abs(yh) > 4 * ulp32(s):
            fail(f"ml fused: row {r} changes sides of 0 at host score {yh}")
    price = ml_price(tk)
    adj_cnt = int((dev_y[flips] > 0).sum()) - int((y[flips] > 0).sum())
    adj_sum = int(price[flips][dev_y[flips] > 0].sum()) - \
        int(price[flips][y[flips] > 0].sum())
    want_cnt = int((y > 0).sum()) + adj_cnt
    want_sum = int(price[y > 0].sum()) + adj_sum
    if int(rows[0][1]) != want_cnt or cents(rows[0][0]) != want_sum:
        fail(f"ml fused: {rows} != the host's count {want_cnt} and sum "
             f"{want_sum} cents, adjusted by the {len(flips)} rows at 0 "
             f"({adj_cnt}, {adj_sum})")
    log(f"ml fused: {rows} == the host's count and sum (adjusted by "
        f"{len(flips)} rows at 0); warm {ms['fused']:.3f} ms ({card})")
    fused = {"rows": rows, "dev_y": dev_y, "ms": ms["fused"]}
    # standalone
    m0 = mu.ML_PREDICT.labels("device").value
    rows, ms["standalone"], _c = ml_run(tk, guard, ML_STANDALONE,
                                        "standalone", 1)
    if mu.ML_PREDICT.labels("device").value - m0 != 1 + WARM_RUNS:
        fail("ml standalone: the statement did not run MLPredictExec on "
             "the card")
    ws2, bs2 = models["m2"]
    want = host_forward(ml_features(tk, "m2", "orders"), ws2,
                        bs2).astype(np.float64)
    got = np.array([r[1] for r in rows], dtype=np.float64)
    otbl = dom.infoschema().table_by_name("test", "orders")
    octab = dom.columnar.tables[otbl.id]
    keys = octab.data[otbl.find_column("o_orderkey").id][:octab.n]
    if [r[0] for r in rows] != keys.tolist():
        fail("ml standalone: rows are not in the table's order")
    scale = float(np.median(np.abs(want)))
    err = np.abs(got - want)
    bad = err > 1e-5 * np.maximum(np.abs(want), scale)
    if bad.any():
        fail(f"ml standalone: {int(bad.sum())} values off the host's by "
             f"more than rtol 1e-5 (max {err.max()})")
    log(f"ml standalone: {len(rows)} values within rtol 1e-5 of the "
        f"host's (max abs err {err.max():.3g}, median |y| {scale:.3g}); "
        f"warm {ms['standalone']:.3f} ms ({card})")
    f1 = fallbacks(dom)
    if f1 != f0:
        fail(f"ml: fallback counters moved {f0} -> {f1}")
    return {"ms": ms, "programs": ml_programs(tk, models, card, step),
            "fused": fused, "models": models}


def ml_programs(tk, models, card, step):
    """The forward program's device time at both statements' shapes
    (CUDA events after a 1 GiB flush) beside its bound: 2 * rows *
    sum(in * out) float32 operations at FP32_FLOPS."""
    import torch
    from tidb_tpu_torch.ml.kernels import build_forward_kernel
    flush = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    programs = []
    for model, table, rows_, per in (
            ("m", "lineitem", step, "1 per partition, in the fused "
             "fragment"), ("m2", "orders", None, "1 per statement")):
        ws, bs = models[model]
        Xt = torch.from_numpy(ml_features(tk, model, table)[:rows_]).cuda()
        dws = [torch.from_numpy(w).cuda() for w in ws]
        dbs = [torch.from_numpy(b).cuda() for b in bs]
        kern = build_forward_kernel(len(ws))
        t = time_ms(lambda: kern(Xt, *dws, *dbs), iters=10, flush=flush)
        flops = 2 * len(Xt) * sum(w.shape[0] * w.shape[1] for w in ws)
        programs.append({
            "name": f"forward_{model}", "source":
            "tidb_tpu_torch/ml/kernels.py:build_forward_kernel",
            "replaces": "tidb_tpu/ml/kernels.py:46",
            "launches_per_statement": per, "rows": len(Xt),
            "layers": list(ML_LAYERS[model]), "ms": t,
            "bound_ms": flops / FP32_FLOPS * 1e3, "bound_by": "operations",
            "library_ms": None})
        log(f"program forward_{model} {list(ML_LAYERS[model])} over "
            f"{len(Xt)} rows: {t:.4f} ms, bound "
            f"{flops / FP32_FLOPS * 1e3:.4f} ms (operations) ({card})")
    del flush
    return programs


def ml_price(tk):
    """l_extendedprice in cents (the fused statement's SUM argument)."""
    dom = tk.domain
    tbl = dom.infoschema().table_by_name("test", "lineitem")
    ctab = dom.columnar.tables[tbl.id]
    return ctab.data[tbl.find_column("l_extendedprice").id][:ctab.n]


# the MPP mesh phase: SF1 over MPP_SHARDS shards of the one card (the
# four-chip layout mapped onto one card), with tidb_enable_mpp on. Each
# case: (name, the kernel each shard launches once per statement or
# None, the exchange a statement counts, the
# tidb_broadcast_join_threshold_count it runs under (None: the
# default), whether it is held to the committed SF1 rows (else to the
# host twin)). "grouped" is tests/test_mpp.py's grouped statement with
# filters over SF1 lineitem (min/max: no kernel), "shuffle" a fused join
# whose orders dim is over the threshold (the Hash exchange), "skew" the
# shape of test_shuffle_join_hot_key_skew: 90 % of the probe keys hot
MPP_SHARDS = 4
MPP_GROUPED = ("select l_shipmode, count(*), sum(l_quantity), "
               "min(l_discount), max(l_tax) from lineitem where "
               "l_quantity > 10 group by l_shipmode order by l_shipmode")
MPP_SHUFFLE = ("select o_orderpriority, sum(l_quantity), count(*) from "
               "lineitem, orders where l_orderkey = o_orderkey group by "
               "o_orderpriority order by o_orderpriority")
MPP_SKEW = ("select g, sum(v), count(*) from skew_f, skew_d where d = id "
            "group by g order by g")
SKEW_FACT_ROWS, SKEW_DIM_ROWS, SKEW_HOT = 2_000_000, 200_000, 13
MPP_CASES = (("q1", "dense_group_sums", "passthrough", None, True),
             ("q6", "range_filter_sums", "passthrough", None, True),
             ("qsum", "masked_sums", "passthrough", None, True),
             ("q3", None, "passthrough", None, True),
             ("q5", "dense_group_sums", "passthrough", None, True),
             ("q12", "dense_group_sums", "passthrough", None, True),
             ("grouped", None, "passthrough", None, False),
             ("shuffle", None, "hash", 1_000_000, False),
             ("skew", None, "hash", SKEW_DIM_ROWS - 1, False),
             ("builtins_math", None, "passthrough", None, False))
# the reference's EXPLAIN of Q3 with tidb_enable_mpp on (tidb_tpu on 8
# virtual devices; estRows left out, they depend on the scale): id, info
MPP_Q3_EXPLAIN = (
    ("Projection_0", "lineitem.l_orderkey, sum(*(lineitem.l_extendedprice,"
     " -(1, lineitem.l_discount))), orders.o_orderdate, "
     "orders.o_shippriority"),
    ("└─TopN_1", "sum(*(lineitem.l_extendedprice, -(1, "
     "lineitem.l_discount))) desc, orders.o_orderdate, offset:0, "
     "count:10"),
    ("  └─HashAgg_2", "mode:final, group:[lineitem.l_orderkey, "
     "orders.o_orderdate, orders.o_shippriority], funcs:[sum(*("
     "lineitem.l_extendedprice, -(1, lineitem.l_discount)))]"),
    ("    └─ExchangeReceiver_3", ""),
    ("      └─ExchangeSender_4", "type:PassThrough, fragment:1"),
    ("        └─FusedPipeline_5", "fact:lineitem, dims:[orders[o_orderkey "
     "= lineitem.l_orderkey], customer[c_custkey = orders.o_custkey]], "
     "group:[lineitem.l_orderkey, orders.o_orderdate, "
     "orders.o_shippriority], aggs:[sum(*(lineitem.l_extendedprice, -(1, "
     "lineitem.l_discount)))]"),
    ("          └─ExchangeReceiver_6", ""),
    ("            └─ExchangeSender_7", "type:Broadcast, fragment:2"),
    ("              └─TableReader_8", "table:orders, filters:[<("
     "orders.o_orderdate, '1995-03-15')]"),
    ("          └─ExchangeReceiver_9", ""),
    ("            └─ExchangeSender_10", "type:Broadcast, fragment:3"),
    ("              └─TableReader_11", "table:customer, filters:[=("
     "customer.c_mktsegment, 'BUILDING')]"))
MPP_ROUTE = ("fused_pipeline_mpp_hit", "copr_mpp_exec", "fused_pipeline_hit",
             "copr_device_exec", "copr_host_exec", "fused_pipeline_fallback",
             "fused_pipeline_error", "fused_shuffle_join")


def skew_load(tk):
    """The skew case's tables, bulk-loaded from a seeded generator:
    skew_d(id, g = id % 16) and skew_f(k, d, v) with 90 % of d the hot
    key SKEW_HOT (all its rows hash to one shard), the rest uniform over
    the dim's keys and 1 % past them (no match)."""
    import numpy as np
    from tidb_tpu_torch.testkit import import_columns
    rng = np.random.default_rng(SEED)
    tk.must_exec("create table skew_d (id bigint primary key, g bigint)")
    tk.must_exec("create table skew_f (k bigint primary key, d bigint, "
                 "v bigint)")
    ids = np.arange(1, SKEW_DIM_ROWS + 1, dtype=np.int64)
    import_columns(tk, "skew_d", {"id": (ids, None, None),
                                  "g": (ids % 16, None, None)})
    n = SKEW_FACT_ROWS
    d = np.where(rng.random(n) < 0.9, SKEW_HOT,
                 rng.integers(1, SKEW_DIM_ROWS * 101 // 100, n))
    import_columns(tk, "skew_f", {
        "k": (np.arange(1, n + 1, dtype=np.int64), None, None),
        "d": (d.astype(np.int64), None, None),
        "v": (rng.integers(0, 1000, n).astype(np.int64), None, None)})


def mpp_digest(name):
    """The reference's committed count and sha256 of a case's rows
    (bench/builtins_sf1_expected.json), else None."""
    if name != "builtins_math":
        return None
    with open(os.path.join(ROOT, "tidb_tpu_torch", "bench",
                           "builtins_sf1_expected.json")) as f:
        return json.load(f)["math_lineitem"]


def mpp_sql(tk, exp, name):
    """-> (sql, expected rows or None: held to the committed digest
    (mpp_digest) or else the host twin)."""
    if name == "grouped":
        return MPP_GROUPED, None
    if name == "shuffle":
        return MPP_SHUFFLE, None
    if name == "skew":
        return MPP_SKEW, None
    if name == "builtins_math":
        from tidb_tpu_torch.bench import tpch
        return dict((c[0], c[1]) for c in tpch.BUILTIN_CASES)[
            "math_lineitem"], None
    return sql_and_rows(tk, exp, name)


def mpp_vector(tk, guard, vec):
    """phase_vector's statements over the mesh (phase_mpp's shards of the
    card; no new load): exact in three metrics, the edge table's ties
    (straddling a shard boundary) and NULLs, hybrid at 1 % and IVF at
    nprobe 8, each cold once and warm WARM_RUNS times under the sync
    guard, rows == the single card's (exact L2 and hybrid also == the
    float64 oracle over the current corpus, the edge case == its want
    list); warm <= 2 dispatches, <= 1 sync, 0 upload bytes; the matrix
    a "sharded" entry of the store; then one insert of 100 rows folds
    into it (one delta apply, no whole upload) and is found.
    -> {"ms", "single_ms", "sharded_bytes", "fold"}."""
    import numpy as np
    from tidb_tpu_torch.expression.vec import _parse_vec_text
    from tidb_tpu_torch.utils import metrics as mu
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    copr = dom.copr
    tbl = dom.infoschema().table_by_name("test", "vcorpus")
    ctab = dom.columnar.table(tbl)
    cur, n = ctab.vector_matrix(tbl.find_column("e").id, VEC_DIM)
    cur64 = cur[:n].astype(np.float64)
    out = {"ms": {}, "single_ms": {}}
    for name, nprobe, sql in vec["mesh_cases"]:
        tk.must_exec(f"set @@tidb_tpu_vector_nprobe = {nprobe}")
        rows, med, _s = vector_run(tk, guard, sql, f"mpp {name}",
                                   WARM_RUNS, twin=False)
        want, single_ms = vec["single"][name]
        if rows != want:
            fail(f"mpp vector {name}: {rows} != the single card's {want}")
        got = [r[0] for r in rows]
        q = _parse_vec_text(sql.split("'")[1])
        if name == "exact_l2" and got != l2_oracle(cur64, q, VEC_K):
            fail(f"mpp vector exact l2: {got} != the float64 oracle")
        if name == "hybrid" and got != l2_oracle(
                cur64, q, VEC_K, np.arange(n) % 100 == 7):
            fail(f"mpp vector hybrid: {got} != the float64 oracle")
        if name == "edge" and got != edge_want():
            fail(f"mpp vector edge: {got} != {edge_want()}")
        out["ms"][name], out["single_ms"][name] = med, single_ms
        log(f"mpp vector {name}: rows == the single card's; warm median "
            f"{med:.3f} ms on {MPP_SHARDS} shards against {single_ms:.3f} "
            "ms on the single card")
    store = copr._dev_store
    mats = [k for k in list(store._entries) if k[0] == "vecmat" and
            k[1] == ctab.uid]
    cap = mats[0][-1] if mats else 0
    if len(mats) != 1 or store.spec_of(mats[0]) != "sharded" or \
            mats[0][-2] != MPP_SHARDS:
        fail(f"mpp vector: the matrix is not one sharded entry: {mats}")
    out["sharded_bytes"] = store.stats()["bytes_by_spec"]["sharded"]
    if out["sharded_bytes"] < cap * VEC_DIM * 4:
        fail(f"mpp vector: {out['sharded_bytes']} sharded bytes under the "
             f"{cap} x {VEC_DIM} matrix")
    # one insert folds into the sharded entry and is found
    base = n
    new = vec["stored"][(base + np.arange(100)) % VEC_ROWS] + \
        np.float32(0.5)
    tk.must_exec("insert into vcorpus values " + ",".join(
        f"({base + r}, {(base + r) % 100}, '{vec_text(v)}')"
        for r, v in enumerate(new)))
    a0 = mu.DELTA_APPLY.labels("applied").value
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 0")
    phase.reset()
    got = tk.must_query(vec_sql(new[3])).rows
    snap = phase.snap()
    tk.must_exec("set @@tidb_tpu_vector_nprobe = 8")
    whole = cap * VEC_DIM * 4
    if got[0][0] != base + 3 or snap.get("delta_applies", 0) != 1 or \
            mu.DELTA_APPLY.labels("applied").value - a0 != 1 or \
            snap.get("upload_bytes", 0) >= whole:
        fail(f"mpp vector insert: {got[:3]}, {phase_line(snap)}; expected "
             f"row {base + 3} first, one delta apply, no whole upload")
    got_ivf = tk.must_query(vec_sql(new[7])).rows
    if got_ivf[0][0] != base + 7:
        fail(f"mpp vector insert: IVF missed row {base + 7}: {got_ivf}")
    mats2 = [k for k in list(store._entries) if k[0] == "vecmat" and
             k[1] == ctab.uid]
    if mats2 != mats or store.spec_of(mats[0]) != "sharded":
        fail(f"mpp vector insert: the entry changed {mats} -> {mats2}")
    out["fold"] = {"delta_bytes": snap.get("delta_bytes", 0),
                   "upload_bytes": snap.get("upload_bytes", 0)}
    log(f"mpp vector insert: 100 rows folded into the sharded matrix "
        f"(delta_bytes {snap.get('delta_bytes', 0)}, upload_bytes "
        f"{snap.get('upload_bytes', 0)} < {whole}) and found by exact and "
        f"IVF search; sharded resident bytes {out['sharded_bytes']}")
    return out


def mpp_vector_ab(tk, vec, names=("exact_l2", "ivf")):
    """The mesh against the single card on the same statements, in one
    process: blocks of WARM_RUNS warm runs alternated single, mesh,
    single, mesh (each block's first run settles outside the timing: the
    column keeps one resident matrix, so a switch re-uploads it in its
    placement), rows equal in every run; then, in each mode's last
    block, one statement under torch.profiler (device busy ms, device
    kernels and copies per statement). A finding, not a gate. Ends on
    the mesh, as it began. -> {name: {"mesh_ms", "single_ms" (warm
    medians), "mesh_busy_ms", "single_busy_ms", "mesh_wall_ms",
    "single_wall_ms", "mesh_launches", "single_launches"}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tidb_tpu_torch.bench.profile_tpch import _busy_us
    copr = tk.domain.copr
    cases = {name: (nprobe, sql) for name, nprobe, sql in vec["mesh_cases"]
             if name in names}
    ms = {(n, m): [] for n in cases for m in ("mesh", "single")}
    rows, trace = {}, {}
    try:
        for block, mode in enumerate(("single", "mesh") * 2):
            copr._mesh = False if mode == "single" else None
            for name, (nprobe, sql) in cases.items():
                tk.must_exec(f"set @@tidb_tpu_vector_nprobe = {nprobe}")
                for i in range(1 + WARM_RUNS):
                    t0 = time.perf_counter()
                    got = tk.must_query(sql).rows
                    if i:
                        ms[(name, mode)].append(
                            (time.perf_counter() - t0) * 1e3)
                    if rows.setdefault(name, got) != got:
                        fail(f"mpp vector a/b {name} {mode}: rows "
                             f"{got} != {rows[name]}")
                if block < 2:
                    continue
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tk.must_query(sql)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                dev = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
                trace[(name, mode)] = (
                    wall, _busy_us(dev) / 1e3 if dev else None, len(dev))
    finally:
        copr._mesh = None
        tk.must_exec("set @@tidb_tpu_vector_nprobe = 8")
    out = {}
    for name in cases:
        r = out[name] = {}
        for mode in ("mesh", "single"):
            r[f"{mode}_ms"] = statistics.median(ms[(name, mode)])
            (r[f"{mode}_wall_ms"], r[f"{mode}_busy_ms"],
             r[f"{mode}_launches"]) = trace[(name, mode)]
        log(f"mpp vector a/b {name}: warm median {r['mesh_ms']:.3f} ms on "
            f"{MPP_SHARDS} shards, {r['single_ms']:.3f} ms on the single "
            f"card (blocks alternated); traced: wall {r['mesh_wall_ms']:.3f}"
            f" / {r['single_wall_ms']:.3f} ms, device busy "
            f"{r['mesh_busy_ms']} / {r['single_busy_ms']} ms, device "
            f"kernels and copies {r['mesh_launches']} / "
            f"{r['single_launches']}")
    return out


def mpp_ml(tk, guard, ml):
    """phase_ml's fused statement with MPP on over the mesh: cold once,
    WARM_RUNS warm, then once with every masked_sums call held to its
    plain version; each on the mesh route with masked_sums launched once
    per shard; warm <= 2 dispatches, <= 1 sync, 0 upload bytes (the
    weights resident on the shards' device). Sum and count == the single
    card's (phase_ml) but for rows the mesh and the single card put on
    two sides of 0, each within 4 ulp of 0 at its last layer's term scale
    (phase_ml's rule). -> {"ms", "single_ms", "flips"}."""
    import numpy as np
    from tidb_tpu_torch.expression import vec as _vec
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    scores = []
    orig = _vec._REGISTRY["predict"]

    def recording(ctx, e):
        res = orig(ctx, e)
        if not ctx.host:
            scores.append(res[0])
        return res
    _vec._REGISTRY["predict"] = recording
    warm, calls, rows = [], [], None
    try:
        for i in range(2 + WARM_RUNS):
            checked = i == 1 + WARM_RUNS
            scores.clear()
            m0 = {c: dom.metrics.get(c, 0) for c in MPP_ROUTE}
            c0 = sk.COUNTS["masked_sums"]
            g0 = guard.calls
            phase.reset()
            t0 = time.perf_counter()
            if checked:
                res, calls = checked_kernels(lambda: tk.must_query(ML_FUSED))
            else:
                res = tk.must_query(ML_FUSED)
            ms = (time.perf_counter() - t0) * 1e3
            snap = phase.snap()
            rows = res.rows
            d = {c: dom.metrics.get(c, 0) - m0[c] for c in MPP_ROUTE}
            if d["fused_pipeline_mpp_hit"] + d["copr_mpp_exec"] != 1 or any(
                    v for c, v in d.items() if c not in (
                        "fused_pipeline_mpp_hit", "copr_mpp_exec")):
                fail(f"mpp ml run {i}: route {d} ({dom.last_fused_reason})")
            launched = sk.COUNTS["masked_sums"] - c0
            if launched != MPP_SHARDS or len(scores) != MPP_SHARDS:
                fail(f"mpp ml run {i}: masked_sums {launched} times, "
                     f"{len(scores)} predict() calls; expected "
                     f"{MPP_SHARDS} (one per shard)")
            disp, syncs = snap.get("dispatches", 0), snap.get("syncs", 0)
            if guard.calls - g0 != disp:
                fail(f"mpp ml run {i}: {disp} dispatches, "
                     f"{guard.calls - g0} under the sync guard")
            if i and (disp > 2 or syncs > 1 or snap.get("upload_bytes", 0)):
                fail(f"mpp ml warm run {i}: {phase_line(snap)}")
            if 0 < i and not checked:
                warm.append(ms)
            kind = "cold" if i == 0 else "checked" if checked else "warm"
            log(f"mpp ml fused {kind} {ms:.2f} ms {phase_line(snap)}")
        mesh_y = np.concatenate([s.float().cpu().numpy() for s in scores])
    finally:
        _vec._REGISTRY["predict"] = orig
    if sum(c[0] == "masked_sums" for c in calls) != MPP_SHARDS:
        fail(f"mpp ml: {len(calls)} checked kernel calls, expected "
             f"{MPP_SHARDS} masked_sums")
    single_y = ml["fused"]["dev_y"]
    mesh_y = mesh_y[:len(single_y)]
    ws, bs = ml["models"]["m"]
    flips = np.nonzero((mesh_y > 0) != (single_y > 0))[0]
    h = ml_features(tk, "m", "lineitem")[flips]
    for W, b in zip(ws[:-1], bs[:-1]):
        h = np.maximum(h @ W + b, np.float32(0))
    terms = np.abs(h * ws[-1][:, 0]).sum(1) + abs(float(bs[-1][0]))
    for r, ys, ym, t in zip(flips, single_y[flips], mesh_y[flips], terms):
        log(f"mpp ml: row {r} score single card {ys!r} mesh {ym!r} (4 ulp "
            f"of its terms {4 * ulp32(t)!r})")
        if abs(ys) > 4 * ulp32(t) or abs(ym) > 4 * ulp32(t):
            fail(f"mpp ml: row {r} changes sides of 0 at {ys} / {ym}")
    price = ml_price(tk)
    up_m, up_s = mesh_y[flips] > 0, single_y[flips] > 0
    adj_cnt = int(up_m.sum()) - int(up_s.sum())
    adj_sum = int(price[flips][up_m].sum()) - int(price[flips][up_s].sum())
    want = ml["fused"]["rows"]
    if int(rows[0][1]) != int(want[0][1]) + adj_cnt or \
            cents(rows[0][0]) != cents(want[0][0]) + adj_sum:
        fail(f"mpp ml: {rows} != the single card's {want} adjusted by the "
             f"{len(flips)} rows at 0 ({adj_cnt}, {adj_sum})")
    out = {"ms": statistics.median(warm), "single_ms": ml["fused"]["ms"],
           "flips": len(flips)}
    log(f"mpp ml fused: {rows} == the single card's {want} (adjusted by "
        f"{len(flips)} rows at 0); warm median {out['ms']:.3f} ms on "
        f"{MPP_SHARDS} shards against {out['single_ms']:.3f} ms on the "
        "single card; masked_sums calls == plain versions: " + "; ".join(
            f"{nm} {sh}" for nm, sh in calls))
    return out


def phase_mpp(tk, exp, guard, single_meds, vec=None, ml=None):
    """The MPP mesh path at SF1 over MPP_SHARDS shards of the card: the
    Domain's copr takes a mesh of the card repeated MPP_SHARDS times (the
    lazily resolved mesh of copr/dag_exec.py _get_mesh; restored after),
    so the loaded tables are reused and become sharded resident copies
    beside the single-device ones. Each case cold once, warm WARM_RUNS
    times, then once more with every kernel call a shard makes held to
    its plain version on the tensors the shard handed it; every program
    enqueue under the sync guard. Rows == the committed SF1 rows or the
    host twin's; every statement on the mesh route (no single-device
    fragment, no fallback) with its exchange counted; warm: at most 2
    dispatches, at most 1 sync, 0 upload bytes; a kernel case launches
    its kernel once per shard. EXPLAIN of Q3 == the reference's tree.
    With phase_vector's and phase_ml's results, phase_vector's
    statements (mpp_vector) and phase_ml's fused predict() (mpp_ml) run
    on the mesh too.
    -> {"ms": {case: warm median}, "single_ms", "exchange_bytes",
    "peak_mib", "seconds", "vector", "ml"}."""
    import torch
    from collections import Counter
    from tidb_tpu_torch.ops import scan_kernels as sk
    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.utils import metrics as mu
    from tidb_tpu_torch.utils import phase
    t_phase = time.perf_counter()
    dom = tk.domain
    copr = dom.copr
    saved = (copr.mesh_spec, copr._mesh)
    copr.mesh_spec = make_mesh(devices=[copr.device] * MPP_SHARDS)
    copr._mesh = None
    if copr._get_mesh() is None or copr._get_mesh().size != MPP_SHARDS:
        fail(f"no mesh of {MPP_SHARDS} shards: {copr._get_mesh()}")
    t0 = time.perf_counter()
    skew_load(tk)
    log(f"mpp: skew tables loaded ({SKEW_FACT_ROWS} x {SKEW_DIM_ROWS} "
        f"rows) {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    tk.must_exec("set @@tidb_enable_mpp = on")
    out = {"ms": {}, "single_ms": {}, "exchange_bytes": {}}
    bcast0 = mu.MPP_EXCHANGE.labels("broadcast").value
    try:
        got = [(r[0], r[-1]) for r in
               tk.must_query("explain " + sql_and_rows(tk, exp, "q3")[0])
               .rows]
        if got != [tuple(r) for r in MPP_Q3_EXPLAIN]:
            fail(f"mpp: EXPLAIN Q3 {got} != the reference's tree")
        log("mpp: EXPLAIN Q3 == the reference's exchange tree (PassThrough"
            " fragment 1, Broadcast fragments 2 and 3)")
        for name, kernel, exch, bcast_t, committed in MPP_CASES:
            sql, want = mpp_sql(tk, exp, name)
            if bcast_t is not None:
                tk.must_exec("set @@tidb_broadcast_join_threshold_count = "
                             f"{bcast_t}")
            digest = mpp_digest(name)
            held = "committed rows" if committed else \
                "committed digest" if digest else "host twin"
            if want is None and digest is None:
                want_rows, twin_ms = host_twin(tk, sql)
                out["single_ms"][name] = twin_ms
                out.setdefault("twin_rows", {})[name] = want_rows
            warm, calls = [], []
            for i in range(2 + WARM_RUNS):
                checked = i == 1 + WARM_RUNS
                m0 = {c: dom.metrics.get(c, 0) for c in MPP_ROUTE}
                e0 = mu.MPP_EXCHANGE.labels(exch).value
                c0 = dict(sk.COUNTS)
                g0 = guard.calls
                phase.reset()
                t0 = time.perf_counter()
                if checked:
                    rows, calls = checked_kernels(
                        lambda: tk.must_query(sql))
                else:
                    rows = tk.must_query(sql)
                ms = (time.perf_counter() - t0) * 1e3
                snap = phase.snap()
                rows = rows._norm() if want is not None or \
                    digest is not None else rows.rows
                if digest is not None:
                    from tidb_tpu_torch.bench import tpch
                    differ = digest != {"rows": len(rows),
                                        "sha256": tpch.rows_digest(rows)}
                else:
                    differ = rows != (want if want is not None
                                      else want_rows)
                if differ:
                    fail(f"mpp {name} run {i}: rows differ from the "
                         f"{held}: {rows[:5]}")
                d = {c: dom.metrics.get(c, 0) - m0[c] for c in MPP_ROUTE}
                mesh_route = d["fused_pipeline_mpp_hit"] + d["copr_mpp_exec"]
                bad = {c: n for c, n in d.items() if n and c not in (
                    "fused_pipeline_mpp_hit", "copr_mpp_exec",
                    "fused_shuffle_join")}
                if mesh_route != 1 or bad or \
                        d["fused_shuffle_join"] != (exch == "hash"):
                    fail(f"mpp {name} run {i}: route {d} "
                         f"({dom.last_fused_reason})")
                if mu.MPP_EXCHANGE.labels(exch).value - e0 < 1:
                    fail(f"mpp {name} run {i}: no {exch} exchange counted")
                disp, syncs = snap.get("dispatches", 0), snap.get("syncs", 0)
                if guard.calls - g0 != disp:
                    fail(f"mpp {name} run {i}: {disp} dispatches, "
                         f"{guard.calls - g0} under the sync guard")
                if i > 0 and (disp > 2 or syncs > 1 or
                              snap.get("upload_bytes", 0)):
                    fail(f"mpp {name} warm run {i}: {phase_line(snap)}")
                if kernel is not None and \
                        sk.COUNTS[kernel] - c0[kernel] != MPP_SHARDS:
                    fail(f"mpp {name} run {i}: {kernel} launched "
                         f"{sk.COUNTS[kernel] - c0[kernel]} times, expected "
                         f"{MPP_SHARDS} (one per shard)")
                if 0 < i and not checked:
                    warm.append(ms)
                kind = "cold" if i == 0 else "checked" if checked else "warm"
                log(f"mpp {name} {kind} {ms:.2f} ms {phase_line(snap)} "
                    f"mpp_exchanges={snap.get('mpp_exchanges', 0)} "
                    f"mpp_exchange_bytes={snap.get('mpp_exchange_bytes', 0)}"
                    f" shuffle_upload_bytes="
                    f"{snap.get('shuffle_upload_bytes', 0)}")
            out["exchange_bytes"][name] = snap.get("mpp_exchange_bytes", 0)
            if kernel is not None and \
                    sum(c[0] == kernel for c in calls) != MPP_SHARDS:
                fail(f"mpp {name}: {len(calls)} kernel calls checked")
            out["ms"][name] = statistics.median(warm)
            if name in single_meds:
                out["single_ms"][name] = single_meds[name]
            log(f"mpp {name}: rows == {held}; warm "
                f"median {out['ms'][name]:.3f} ms against "
                f"{out['single_ms'].get(name, float('nan')):.3f} ms "
                f"{'host twin' if held == 'host twin' else 'single-card'}"
                "; kernel "
                "calls == plain versions: " + ("; ".join(
                    f"{n} {shape} x{k}" for (n, shape), k in
                    sorted(Counter(calls).items())) or "none"))
            if bcast_t is not None:
                tk.must_exec("set @@tidb_broadcast_join_threshold_count = "
                             "1024000")
        if mu.MPP_EXCHANGE.labels("broadcast").value - bcast0 < 1:
            fail("mpp: no broadcast exchange of a dim was counted")
        f0 = fallbacks(dom)
        if vec is not None:
            t0 = time.perf_counter()
            out["vector"] = mpp_vector(tk, guard, vec)
            out["vector"]["ab"] = mpp_vector_ab(tk, vec)
            out["vector"]["seconds"] = time.perf_counter() - t0
        if ml is not None:
            t0 = time.perf_counter()
            out["ml"] = mpp_ml(tk, guard, ml)
            out["ml"]["seconds"] = time.perf_counter() - t0
        f1 = fallbacks(dom)
        if f1 != f0:
            fail(f"mpp vector/ml: fallback counters moved {f0} -> {f1}")
    finally:
        copr.mesh_spec, copr._mesh = saved
        # the later phases count the single-card store's buffers (the
        # htap phase's folds and whole uploads): the mesh's sharded and
        # replicated entries leave with the mesh
        store = copr._dev_store
        for key in list(store._entries):
            if store.spec_of(key) in ("sharded", "replicated"):
                store.drop(key, "invalidate")
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mpp phase {out['seconds']:.1f} s; peak device memory "
        f"{out['peak_mib']:.0f} MiB; broadcast exchanges "
        f"{mu.MPP_EXCHANGE.labels('broadcast').value - bcast0}")
    return out


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


# ---- HTAP serving: BR, resolved reads under writes, read replicas -------
# These phases write, so they run after every phase that holds the SF1
# tables to the reference's committed rows.

# the SF1 tables BACKUP and both RESTOREs carry: those the restored
# statements read (Q1, Q3, Q6, Q13) and the HTAP writes change. The other
# five (part, partsupp, supplier, nation, region: 1,010,030 rows) are
# dropped before the backup (PERF.md section 4: the whole run passed
# 1,200 s on a slow host)
BR_TABLES = ("customer", "orders", "lineitem")
# TPC-H's refresh functions (spec 2.5): RF1 inserts SF x 1,500 new orders
# with their 1 to 7 lineitems, RF2 deletes SF x 1,500 old orders and
# theirs; the writers run RF_ROUNDS pairs, RF_BATCH rows an INSERT
RF_ORDERS = 1500
RF_ROUNDS = 5
RF_BATCH = 500
# the replica phase's DML-written table (scripts/replica_smoke.py's shape:
# lines(id, k, v, s)) with k in 0..62: 63 keys and the NULL slot fill
# dense_group_sums' 64 slots (a 64th key takes the sort kind on the
# card); 1,000,000 rows cut to REPLICA_ROWS, a multiple of the loader's
# 1,000-row blocks (PERF.md section 4: a mirror's catch-up applies rows
# one by one on the host; halved again when the whole run passed 900 s
# with the cluster phase)
REPLICA_ROWS = 31_000
REPLICA_SLA_MS = 5000
REPLICA_GROUP = "select k, count(*), sum(v) from lines group by k order by k"
REPLICA_LIKE = "select count(*), sum(v) from lines where s like 'a%'"
REPLICA_KERNELS = {REPLICA_GROUP: "dense_group_sums",
                   REPLICA_LIKE: "masked_sums"}
# a lineitem row that Q1 and Q6 both count, inserted by a session that
# then reads in an open transaction: a resolved read must not see it
DIRTY_ROW = ("insert into lineitem values (0, 1, 1, 1, 1.00, 1000.00, 0.06, "
             "0.00, 'N', 'O', '1994-06-01', '1994-06-02', '1994-06-03', "
             "'NONE', 'MAIL', '')")


def wait_for(pred, timeout=60.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class StatementGuard:
    """A whole statement (bind, uploads, fold, enqueue) under
    torch.cuda.set_sync_debug_mode("error"), but for the waits of its
    pinned fetches (utils/fetch.py _Ticket.wait, the statement's counted
    syncs). Run it with no other thread touching the card: the mode is
    process-wide."""

    def __enter__(self):
        import torch
        from tidb_tpu_torch.utils import fetch
        self._wait = wait = fetch._Ticket.wait

        def fetch_wait(ticket):
            torch.cuda.set_sync_debug_mode(0)
            try:
                wait(ticket)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        fetch._Ticket.wait = fetch_wait
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        import torch
        from tidb_tpu_torch.utils import fetch
        torch.cuda.set_sync_debug_mode(0)
        fetch._Ticket.wait = self._wait


class DeviceThreads:
    """Records the name of every thread that enters a device seam of the
    coprocessor (fragment enqueue, resident upload, delta fold): a
    changefeed worker or the replica monitor must enter none."""

    SEAMS = (("tidb_tpu_torch.copr.dag_exec", None, "run_fragment"),
             ("tidb_tpu_torch.copr.dag_exec", "CoprExecutor",
              "_upload_padded"),
             ("tidb_tpu_torch.copr.delta", "DeltaMaintainer", "_run_fold"))

    def __init__(self):
        import threading
        self.names = {}
        self._mu = threading.Lock()
        self._saved = []

    def __enter__(self):
        import importlib
        import threading
        for mod_name, cls, fn in self.SEAMS:
            owner = importlib.import_module(mod_name)
            if cls is not None:
                owner = getattr(owner, cls)
            orig = getattr(owner, fn)
            self._saved.append((owner, fn, orig))

            def seam(*a, _orig=orig, **kw):
                name = threading.current_thread().name
                with self._mu:
                    self.names[name] = self.names.get(name, 0) + 1
                return _orig(*a, **kw)
            setattr(owner, fn, seam)
        return self

    def __exit__(self, *exc):
        for owner, fn, orig in reversed(self._saved):
            setattr(owner, fn, orig)
        self._saved = []

    def feed_threads(self):
        return {n: c for n, c in self.names.items()
                if n.startswith(("cdc-", "replica-"))}


def tpch_date(day):
    import datetime
    return (datetime.date(1970, 1, 1) + datetime.timedelta(
        days=int(day))).isoformat()


def rf1_statements(rng, first_key, ncust):
    """RF1 as SQL: RF_ORDERS new orders from first_key on, each with 1
    to 7 lineitems over TPC-H's value domains (dates from 1992 to 1998,
    so both Q1 and Q6 count some) -> (INSERT statements, lineitems)."""
    import numpy as np
    from tidb_tpu_torch.bench import tpch
    d92 = (np.datetime64("1992-01-01") - np.datetime64("1970-01-01"))
    d98 = (np.datetime64("1998-08-02") - np.datetime64("1970-01-01"))
    cut = int((np.datetime64("1995-06-17") - np.datetime64(
        "1970-01-01")).astype(int))
    n = RF_ORDERS
    odate = rng.integers(int(d92.astype(int)), int(d98.astype(int)) - 151,
                         n)
    cust = rng.integers(1, ncust + 1, n)
    cust = np.where(cust % 3 == 0, np.maximum(cust - 1, 1), cust)
    orders, items = [], []
    for i in range(n):
        key = first_key + i
        nl = int(rng.integers(1, 8))
        total = 0
        for ln in range(1, nl + 1):
            ship = int(odate[i] + rng.integers(1, 122))
            commit = int(odate[i] + rng.integers(30, 91))
            receipt = ship + int(rng.integers(1, 31))
            qty = int(rng.integers(1, 51))
            price = int(rng.integers(90000, 10500000))
            total += price
            flag = ("R", "A")[int(rng.integers(0, 2))] \
                if receipt <= cut else "N"
            items.append(
                f"({key},{int(rng.integers(1, 200001))},"
                f"{int(rng.integers(1, 10001))},{ln},{qty}.00,"
                f"{price // 100}.{price % 100:02d},"
                f"0.{int(rng.integers(0, 11)):02d},"
                f"0.{int(rng.integers(0, 9)):02d},'{flag}',"
                f"'{'O' if ship > cut else 'F'}','{tpch_date(ship)}',"
                f"'{tpch_date(commit)}','{tpch_date(receipt)}',"
                f"'{tpch.INSTRUCTS[int(rng.integers(0, 4))]}',"
                f"'{tpch.SHIPMODES[int(rng.integers(0, 7))]}','')")
        orders.append(
            f"({key},{int(cust[i])},'O',{total // 100}.{total % 100:02d},"
            f"'{tpch_date(odate[i])}',"
            f"'{tpch.PRIORITIES[int(rng.integers(0, 5))]}',"
            f"'Clerk#000000001',0,'')")
    stmts = [f"insert into orders values {','.join(orders[j:j + RF_BATCH])}"
             for j in range(0, len(orders), RF_BATCH)]
    stmts += [f"insert into lineitem values "
              f"{','.join(items[j:j + RF_BATCH])}"
              for j in range(0, len(items), RF_BATCH)]
    return stmts, len(items)


def rf2_statements(lo):
    hi = lo + RF_ORDERS - 1
    return [f"delete from orders where o_orderkey between {lo} and {hi}",
            f"delete from lineitem where l_orderkey between {lo} and {hi}"]


def phase_br_snapshot(tk, tmp):
    """BACKUP DATABASE test over the SF1 tables of BR_TABLES (every
    other table is dropped first), with a logbackup:// changefeed
    armed before it and kept running through the HTAP writes. -> the
    backup's record."""
    dom = tk.domain
    for t in dom.infoschema().tables_in_schema("test"):
        if t.name not in BR_TABLES:
            tk.must_exec(f"drop table `{t.name}`")
    snap = os.path.join(tmp, "snap")
    feed = dom.cdc.create(
        "br_log", f"logbackup://{snap}/log/backup.log",
        start_ts=dom.cdc.capture.resolved_ts(), auto_start=True)
    t0 = time.perf_counter()
    n = tk.must_exec(f"backup database test to 'local://{snap}'").affected
    secs = time.perf_counter() - t0
    with open(os.path.join(snap, "backupmeta.json")) as f:
        man = json.load(f)
    rows = {e["table"]["name"]: sum(c["rows"] for c in e["chunks"])
            for e in man["tables"]}
    want = {t: table_rows(tk, t) for t in BR_TABLES}
    if n != len(BR_TABLES) or rows != want:
        fail(f"backup: {n} tables, rows {rows}; expected {want}")
    nbytes = sum(c["bytes"] for e in man["tables"] for c in e["chunks"])
    log(f"br backup: {sum(rows.values())} rows of {n} tables in {secs:.1f} "
        f"s, {nbytes} bytes in "
        f"{sum(len(e['chunks']) for e in man['tables'])} chunks; "
        f"backup_ts {man['backup_ts']}; logbackup:// feed armed")
    ids = {t: dom.infoschema().table_by_name("test", t).id
           for t in BR_TABLES}
    return {"path": snap, "feed": feed, "backup_s": secs,
            "backup_bytes": nbytes, "rows": sum(rows.values()),
            "backup_ts": man["backup_ts"], "table_ids": ids}


def pinned_rows(tk, sql, ts):
    """Rows of `sql` read at exactly `ts` (the session pin the replica
    fabric's mirrors read at; the port has no tidb_snapshot)."""
    pin = tk.new_session()
    pin.sess.pinned_read_ts = ts
    return pin.must_query(sql)._norm()


def slot_of(key):
    """An appendable entry's column slot: (uid, tag, column, kind,
    start); its key adds the gc epoch and the padded capacity."""
    return (key[1], key[2], key[3], key[4]) + tuple(key[6:-1])


def resident_slots(dom):
    """slot -> (uid, start, span, cap) of every table's appendable
    resident entries."""
    store = dom.copr._dev_store
    out = {}
    for ctab in list(dom.columnar.tables.values()):
        for key, _d, _r, _v, start, span, cap, _e in \
                store.appendable_entries(ctab.uid):
            out[slot_of(key)] = (ctab.uid, start, span, cap)
    return out


def grown_past(dom, uid, start, span, cap):
    """Whether the partition [start, start + span) of the table with
    `uid` now holds more rows than the padded capacity `cap`."""
    tab = next((t for t in list(dom.columnar.tables.values())
                if t.uid == uid), None)
    if tab is None:
        return False
    n = tab.n - start
    return (n if span is None else min(n, span)) > cap


def phase_htap(tk, exp, card):
    """TPC-H RF1/RF2 pairs from two writer threads while two analyst
    threads run Q1 and Q6 under tidb_tpu_analytic_read_mode = 'resolved'
    (every other statement inside an open transaction holding a DIRTY_ROW
    insert), over resident lineitem buffers the writes fold into. Gates:
    no statement error; no dirty-overlay routing in resolved mode (a
    leader-mode control does route one); delta folds applied and
    tombstones advanced; a resident buffer uploaded whole again only at
    its partition's bucket crossing, once; recorded mid-stream
    statements == the same statement read at their resolved ts on the
    card (and the middle ones on the host twin); at quiesce resolved ==
    leader == host twin; each kernel == its plain version on a checked
    statement; one warm folding statement under StatementGuard. -> the
    phase's record."""
    import threading
    import numpy as np
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.session.session import Session
    from tidb_tpu_torch.utils import metrics as mu
    from tidb_tpu_torch.utils import phase
    dom = tk.domain
    copr = dom.copr
    cuda = copr.device.type == "cuda"
    sqls = {"q1": tpch.Q1, "q6": tpch.Q6}
    res = tk.new_session()
    res.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
    quiet = {}
    for q, sql in sqls.items():
        ms = []
        for i in range(1 + WARM_RUNS):
            t0 = time.perf_counter()
            got = res.must_query(sql)._norm()
            ms.append((time.perf_counter() - t0) * 1e3)
            if got != [tuple(r) for r in exp[q]]:
                fail(f"htap {q} before writes: rows {got} != expected")
        quiet[q] = statistics.median(ms[1:])
    floors = threading.local()
    orig_resolved = Session._maybe_resolved_read

    def recording(self, stmt, plan, ectx):
        orig_resolved(self, stmt, plan, ectx)
        floors.ts = ectx.stale_read_ts if \
            getattr(ectx, "analytic_resolved", False) else 0
    Session._maybe_resolved_read = recording
    store = copr._dev_store
    resident0 = resident_slots(dom)
    puts = []
    orig_put = store.put_appendable

    def put_appendable(key, dev, *a, **kw):
        m = resident0.get(slot_of(key))
        crossed = m is not None and grown_past(dom, *m)
        orig_put(key, dev, *a, **kw)
        if store._entries.get(key) is dev:    # a racing bind's loses
            puts.append((key, crossed))
    store.put_appendable = put_appendable
    labels = ("applied", "advanced", "compacted", "fell_back_full_upload")
    a0 = {lab: mu.DELTA_APPLY.labels(lab).value for lab in labels}
    b0 = mu.DELTA_APPLY_BYTES.labels().value
    stale0 = mu.ANALYTIC_READS.labels("staleness_fallback").value
    overlay0 = dom.metrics.get("fused_pipeline_dirty_overlay", 0)
    li = dom.columnar.tables[dom.infoschema().table_by_name(
        "test", "lineitem").id]
    n0 = li.n
    first_key = int(tk.must_query(
        "select max(o_orderkey) from orders").rows[0][0]) + 1
    ncust = table_rows(tk, "customer")
    rng = np.random.default_rng(SEED)
    rounds = []
    for r in range(RF_ROUNDS):
        ins, nli = rf1_statements(rng, first_key + r * RF_ORDERS, ncust)
        rounds.append((ins, nli, rf2_statements(1 + r * RF_ORDERS)))
    errors, samples = [], []
    written = [0]
    done = [0]
    mid = {}
    mu_ = threading.Lock()
    stop = threading.Event()

    def writer(w):
        s = tk.new_session()
        try:
            for ins, nli, dels in rounds[w::2]:
                for sql in ins:
                    s.must_exec(sql)
                deleted = sum(s.must_exec(sql).affected for sql in dels)
                with mu_:
                    written[0] += RF_ORDERS + nli + deleted
                    done[0] += 1
                    if done[0] == RF_ROUNDS // 2:
                        mid["ts"] = copr.delta.resolved_ts()
        except Exception as e:              # noqa: BLE001
            errors.append(f"writer {w}: {type(e).__name__}: {e}")

    def analyst(a):
        s = tk.new_session()
        s.must_exec("set @@tidb_tpu_analytic_read_mode = 'resolved'")
        i = 0
        try:
            while not stop.is_set():
                q = ("q1", "q6")[(a + i) % 2]
                dirty = i % 2 == 1
                if dirty:
                    s.must_exec("begin")
                    s.must_exec(DIRTY_ROW)
                t0 = time.perf_counter()
                got = s.must_query(sqls[q])._norm()
                ms = (time.perf_counter() - t0) * 1e3
                if dirty:
                    s.must_exec("rollback")
                samples.append((q, floors.ts, got, ms, dirty))
                i += 1
        except Exception as e:              # noqa: BLE001
            errors.append(f"analyst {a}: {type(e).__name__}: {e}")
    try:
        t0 = time.perf_counter()
        writers = [threading.Thread(target=writer, args=(w,), daemon=True)
                   for w in range(2)]
        analysts = [threading.Thread(target=analyst, args=(a,),
                                     daemon=True) for a in range(2)]
        for t in writers + analysts:
            t.start()
        for t in writers:
            t.join()
        write_s = time.perf_counter() - t0
        stop.set()
        for t in analysts:
            t.join()
    finally:
        Session._maybe_resolved_read = orig_resolved
        store.put_appendable = orig_put
    if errors:
        fail(f"htap: statement errors {errors[:3]}")
    if done[0] != RF_ROUNDS or "ts" not in mid:
        fail(f"htap: {done[0]} of {RF_ROUNDS} RF pairs ran")
    applied = {lab: mu.DELTA_APPLY.labels(lab).value - a0[lab]
               for lab in labels}
    overlay = dom.metrics.get("fused_pipeline_dirty_overlay", 0) - overlay0
    stale_reads = mu.ANALYTIC_READS.labels("staleness_fallback").value - \
        stale0
    # a buffer resident before the writes is put whole again only once
    # its partition crossed its padded capacity: once at the new one
    # (and at the old one only by a statement whose snapshot predates
    # the crossing); the buffers of Q1's and Q6's columns in lineitem's
    # last partition crossed and were put at the new capacity
    crossed = {sl: m for sl, m in resident0.items() if grown_past(dom, *m)}
    again = [(slot_of(k), k[-1], c) for k, c in puts
             if slot_of(k) in resident0]
    grown = [(sl, cap) for sl, cap, _c in again if cap > resident0[sl][3]]
    needless = [sl for sl, cap, c in again if not c] + [
        g for g in set(grown) if grown.count(g) > 1]
    stale = [sl for sl, cap, c in again if c and cap == resident0[sl][3]]
    info = dom.infoschema().table_by_name("test", "lineitem")
    read = {info.find_column(c).id for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate")}
    last = ((li.n - 1) // copr.device_rows) * copr.device_rows
    hot = {sl for sl, m in crossed.items() if m[0] == li.uid and
           m[1] == last and sl[2] in read}
    parts_crossed = {(m[0], m[1]) for m in crossed.values()}
    parts_again = {(resident0[sl][0], resident0[sl][1]) for sl, _c in grown}
    log(f"htap: {RF_ROUNDS} RF1/RF2 pairs ({written[0]} rows written) in "
        f"{write_s:.1f} s, {written[0] / write_s:.1f} rows/s from 2 "
        f"writers; {len(samples)} analyst statements; delta outcomes "
        f"{json.dumps(applied)}; lineitem {n0} -> {li.n} rows; "
        f"partitions (uid, start) crossed {sorted(parts_crossed)}, "
        f"re-uploaded {sorted(parts_again)} ({len(grown)} buffers; "
        f"{len(stale)} at the old capacity by a statement older than the "
        f"crossing); {stale_reads} staleness fallbacks; {overlay} "
        f"dirty-overlay routings; card {card}")
    if needless or not hot or not hot <= {sl for sl, _c in grown}:
        fail(f"htap: whole uploads without a crossing or twice "
             f"{needless}; lineitem's crossed buffers {sorted(hot)}, put "
             f"at a new capacity {sorted(set(grown))}")
    crossings = len(parts_again)
    # a statement whose resolved floor lagged past
    # tidb_tpu_analytic_max_staleness_ms ran on the leader path (floor 0
    # recorded), where a dirty transaction routes the overlay: every
    # overlay routing must be one of those, none a resolved statement's
    dirty_leader = sum(1 for s in samples if s[4] and not s[1])
    if overlay != dirty_leader:
        fail(f"htap: {overlay} dirty-overlay routings, {dirty_leader} "
             "dirty statements on the leader path (staleness fallback)")
    if applied["applied"] <= 0 or applied["advanced"] <= 0:
        fail(f"htap: delta outcomes {applied}: no fold or no tombstone "
             "advance")
    if applied["fell_back_full_upload"]:
        fail(f"htap: {applied['fell_back_full_upload']} delta fallbacks")
    # mid-stream statements, read again at their resolved ts: on the
    # card (the first, the middle, the last and the last in a dirty
    # transaction of each query) and on the host twin (the middle one:
    # a host Q1 over SF1 takes seconds)
    usable = [s for s in samples if s[1]]
    picked, middle = [], []
    for q in sqls:
        mine = sorted((s for s in usable if s[0] == q), key=lambda s: s[1])
        if len(mine) < 3 or not any(s[4] for s in mine):
            fail(f"htap: {len(mine)} resolved {q} statements recorded")
        picked += [mine[0], mine[len(mine) // 2], mine[-1]]
        picked.append(next(s for s in reversed(mine) if s[4]))
        middle.append(mine[len(mine) // 2])
    for q, ts, got, _ms, dirty in picked:
        if pinned_rows(tk, sqls[q], ts) != got:
            fail(f"htap {q} at resolved ts {ts} (dirty txn {dirty}): rows "
                 "!= the card's read at that ts")
    mid_rows = {q: pinned_rows(tk, sql, mid["ts"])
                for q, sql in sqls.items()}
    mid_rows["q13"] = pinned_rows(tk, tpch.ALL_QUERIES["q13"], mid["ts"])
    copr.use_device = False
    try:
        for q, ts, got, _ms, dirty in middle:
            if pinned_rows(tk, sqls[q], ts) != got:
                fail(f"htap {q} at resolved ts {ts}: rows != the host "
                     "twin's read at that ts")
        host = {q: tk.must_query(sql)._norm() for q, sql in sqls.items()}
    finally:
        copr.use_device = True
    log(f"htap: {len(picked)} mid-stream statements (resolved ts "
        f"{[s[1] for s in picked]}) == the card's reads at their ts, "
        f"{len(middle)} == the host twin's")
    leader = tk.new_session()
    for q, sql in sqls.items():
        r_rows = res.must_query(sql)._norm()
        l_rows = leader.must_query(sql)._norm()
        if not (r_rows == l_rows == host[q]):
            fail(f"htap {q} at quiesce: resolved, leader and host twin "
                 "rows differ")
    # the overlay control: a leader-mode read in a dirty transaction
    c0 = dom.metrics.get("fused_pipeline_dirty_overlay", 0)
    leader.must_exec("begin")
    leader.must_exec(DIRTY_ROW)
    leader.must_query(sqls["q1"])
    leader.must_exec("rollback")
    if dom.metrics.get("fused_pipeline_dirty_overlay", 0) - c0 != 1:
        fail("htap: the leader-mode control took no dirty overlay")
    # each kernel held to its plain version on a checked statement
    for q, sql in sqls.items():
        got, calls = checked_kernels(lambda: res.must_query(sql)._norm())
        if got != host[q] or not calls:
            fail(f"htap {q} checked: rows or kernel calls {calls}")
        log(f"htap {q}: kernel calls == plain versions: " +
            "; ".join(f"{c} {sh}" for c, sh in calls))
    # one warm statement that folds, its bind and enqueue under the guard
    fresh, _n = rf1_statements(rng, first_key + RF_ROUNDS * RF_ORDERS,
                               ncust)
    res.must_exec(fresh[-1])                # one batch of lineitems
    phase.reset()
    peak = None
    if cuda:
        import torch
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with StatementGuard():
            got = res.must_query(sqls["q1"])._norm()
        peak = torch.cuda.max_memory_allocated() - base
    else:
        got = res.must_query(sqls["q1"])._norm()
    snap = phase.snap()
    want = leader.must_query(sqls["q1"])._norm()
    if got != want or not snap.get("delta_applies"):
        fail(f"htap guarded fold: {phase_line(snap)} delta_applies="
             f"{snap.get('delta_applies', 0)}; rows == the leader's "
             f"{got == want}")
    log(f"htap guarded fold: Q1 bound, folded and enqueued under "
        f"set_sync_debug_mode('error'): delta_applies="
        f"{snap['delta_applies']} delta_bytes={snap.get('delta_bytes', 0)} "
        f"{phase_line(snap)}; device memory over the statement "
        f"{peak} bytes")
    busy = {q: statistics.median([s[3] for s in samples if s[0] == q])
            for q in sqls}
    after = {}
    for q, sql in sqls.items():
        ms = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            res.must_query(sql)
            ms.append((time.perf_counter() - t0) * 1e3)
        after[q] = statistics.median(ms)
    folds = mu.DELTA_APPLY.labels("applied").value - a0["applied"]
    dbytes = mu.DELTA_APPLY_BYTES.labels().value - b0
    fold = fold_program(copr, li) if cuda else None
    rec = {"warm_ms_quiet": quiet, "warm_ms_under_writes": busy,
           "warm_ms_after": after, "writer_rows_per_s": written[0] / write_s,
           "write_s": write_s, "delta_outcomes": applied,
           "delta_bytes_per_fold": dbytes / max(folds, 1),
           "bucket_crossings": crossings, "statements": len(samples),
           "staleness_fallbacks": stale_reads, "fold": fold,
           "fold_statement_peak_bytes": peak,
           "mid_ts": mid["ts"], "mid_rows": mid_rows}
    log(f"htap: warm ms quiet {json.dumps(quiet)}, under writes "
        f"{json.dumps(busy)}, after {json.dumps(after)}; "
        f"{rec['delta_bytes_per_fold']:.1f} delta bytes per fold; "
        f"fold program {json.dumps(fold)}; card {card}")
    return rec


def fold_program(copr, li):
    """copr/delta.py's fold program timed on the card over the resident
    buffers of lineitem's last partition, with a padded delta of one RF1
    round's lineitems: ms per fold beside its bound (the buffers it
    clones, read once and written once, at HBM_BYTES_PER_S)."""
    import torch
    from tidb_tpu_torch.chunk.device import shape_bucket, upload
    from tidb_tpu_torch.copr.delta import _fold
    ents = [e for e in copr._dev_store.appendable_entries(li.uid)
            if e[4] == ((li.n - 1) // copr.device_rows) * copr.device_rows]
    if not ents:
        fail("fold program: no resident buffer of lineitem's last partition")
    ulen = shape_bucket(4 * RF_ORDERS)
    bufs = tuple(e[1] for e in ents)
    upds = tuple(upload(e[1][:ulen].cpu().numpy(), e[1].device)
                 for e in ents)
    offs = tuple(max(e[2] - ulen, 0) for e in ents)
    out = _fold(bufs, upds, offs)
    for b, u, o, nb in zip(bufs, upds, offs, out):
        want = b.clone()
        want[o:o + u.shape[0]] = u
        if not torch.equal(nb, want):
            fail("fold program disagrees with clone + slice-assign")
    flush = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: _fold(bufs, upds, offs), flush=flush)
    nbytes = sum(b.numel() * b.element_size() for b in bufs)
    return {"buffers": len(bufs), "clone_bytes": nbytes,
            "delta_rows": ulen, "ms": ms,
            "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3}


def phase_replica(card, device=None, rows=REPLICA_ROWS):
    """The read-replica fabric on the card: a leader Domain with
    lines(id, k, v, s) written through INSERT ... SELECT, two replicas
    provisioned (TiDB's SET TIFLASH REPLICA 2), then point ops and an
    insert stream with two replica-pinned analysts in resolved mode
    running REPLICA_GROUP (dense_group_sums) and REPLICA_LIKE
    (masked_sums) while each replica is killed in turn. Gates: no
    statement error, routed statements before and after each kill, no
    degrade and no mid-statement report, mirrors == leader at quiesce,
    no served statement staler than the SLA, no feed worker or monitor
    thread at a device seam, each kernel launched on a mirror's checked
    statement == its plain version. -> the phase's record."""
    import threading
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import metrics as mu
    tkr = TestKit(device=device)
    dom = tkr.domain
    cuda = dom.copr.device.type == "cuda"
    r0 = {o: mu.REPLICA_ROUTE.labels(o).value
          for o in ("replica", "leader_fallback", "degraded_midstmt")}

    def routed():
        return mu.REPLICA_ROUTE.labels("replica").value - r0["replica"]
    tkr.must_exec("create table digits (d int primary key, t varchar(8))")
    tkr.must_exec("insert into digits values " + ",".join(
        f"({i}, '{chr(97 + i % 26)}{i}')" for i in range(1000)))
    tkr.must_exec("create table lines (id int primary key, k int, v int, "
                  "s varchar(16))")
    t0 = time.perf_counter()
    for lo in range(0, rows // 1000, 50):
        tkr.must_exec(
            "insert into lines select a.d * 1000 + b.d, (a.d * 1000 + b.d) "
            "% 63, (a.d * 7919 + b.d * 31) % 100000, concat(a.t, '-', b.d) "
            f"from digits a join digits b where a.d >= {lo} and a.d < "
            f"{min(lo + 50, rows // 1000)}")
    load_s = time.perf_counter() - t0
    for scope in ("global", "session"):
        tkr.must_exec(f"set @@{scope}.tidb_tpu_analytic_read_mode = "
                      "'resolved'")
        tkr.must_exec(f"set @@{scope}.tidb_tpu_replica_max_lag_ms = "
                      f"{REPLICA_SLA_MS}")
    with DeviceThreads() as seams:
        t0 = time.perf_counter()
        reps = dom.replicas.provision(2)
        if not wait_for(lambda: all(r.state == "serving" for r in reps),
                        timeout=600):
            fail(f"replicas never served: {[r.state for r in reps]}")
        catchup_s = time.perf_counter() - t0
        for r in reps:
            if r.mirror.copr.device != dom.copr.device:
                fail(f"replica {r.rid} runs on {r.mirror.copr.device}")
        log(f"replica: {rows} rows loaded through INSERT ... SELECT in "
            f"{load_s:.1f} s; 2 replicas caught up in {catchup_s:.1f} s")
        leader = tkr.new_session()
        leader.must_exec("set @@tidb_tpu_analytic_read_mode = 'leader'")
        ms = {}
        for q in REPLICA_KERNELS:
            for who, kit in (("replica", tkr), ("leader", leader)):
                t = []
                for _ in range(1 + WARM_RUNS):
                    t1 = time.perf_counter()
                    kit.must_query(q)
                    t.append((time.perf_counter() - t1) * 1e3)
                    route = getattr(kit.sess, "_stmt_route", "")
                    if (who == "replica") != route.startswith("replica"):
                        fail(f"replica warm {who} statement routed "
                             f"'{route}'")
                ms.setdefault(q, {})[who] = statistics.median(t[1:])
        errors = []
        stop = threading.Event()
        seq = [10_000_000]
        runs = [0]

        def oltp():
            s = tkr.new_session()
            i = 0
            while not stop.is_set():
                try:
                    if i % 5 == 0:
                        seq[0] += 1
                        n = seq[0]
                        s.must_exec(f"insert into lines values ({n}, "
                                    f"{n % 63}, {n % 1000}, 'w{n % 26}')")
                    else:
                        s.must_query("select v from lines where id = "
                                     f"{(i * 7919) % rows}")
                except Exception as e:      # noqa: BLE001
                    errors.append(f"oltp: {type(e).__name__}: {e}")
                    return
                i += 1

        def analyst(a):
            s = tkr.new_session()
            i = 0
            while not stop.is_set():
                try:
                    s.must_query((REPLICA_GROUP, REPLICA_LIKE)[(a + i) % 2])
                    runs[0] += 1
                except Exception as e:      # noqa: BLE001
                    errors.append(f"analyst {a}: {type(e).__name__}: {e}")
                    return
                i += 1
        threads = [threading.Thread(target=oltp, daemon=True)] + [
            threading.Thread(target=analyst, args=(a,), daemon=True)
            for a in range(2)]
        for t in threads:
            t.start()
        kills = []
        try:
            for rep in reps:
                if not wait_for(lambda: rep.state == "serving"):
                    fail(f"replica {rep.rid} not serving before its kill")
                base = routed()
                if not wait_for(lambda: routed() > base):
                    fail(f"no replica-routed statement before killing "
                         f"{rep.rid}")
                pre = rep.reprovisions
                t1 = time.perf_counter()
                dom.replicas.kill(rep.rid)
                if not wait_for(lambda: rep.state == "serving" and
                                rep.reprovisions > pre, timeout=120):
                    fail(f"replica {rep.rid} did not come back "
                         f"({rep.state})")
                back = time.perf_counter() - t1
                base = routed()
                if not wait_for(lambda: routed() > base):
                    fail(f"no replica-routed statement after killing "
                         f"{rep.rid}")
                kills.append(back)
        finally:
            stop.set()
            for t in threads:
                t.join()
        if errors:
            fail(f"replica: statement errors {errors[:3]}")
        want = leader.must_query("select id, k, v, s from lines order by "
                                 "id").rows
        for rep in reps:
            if not wait_for(lambda: rep.sink.mirror_rows("test", "lines")
                            == want, timeout=120):
                got = set(rep.sink.mirror_rows("test", "lines"))
                fail(f"replica {rep.rid} ({rep.state}): mirror rows != "
                     f"leader rows at quiesce: {len(set(want) - got)} "
                     f"missing, {len(got - set(want))} extra")
        lead = {q: leader.must_query(q)._norm() for q in REPLICA_KERNELS}
        guard = SyncGuard() if cuda else None
        checked = {}
        if guard is not None:
            guard.__enter__()
        try:
            for q, kname in REPLICA_KERNELS.items():
                if not wait_for(lambda: all(
                        r.state == "serving" for r in reps)):
                    fail("replicas not serving at quiesce")
                got, calls = checked_kernels(
                    lambda: tkr.must_query(q)._norm())
                route = tkr.sess._stmt_route
                if got != lead[q] or not route.startswith("replica") or \
                        kname not in [c[0] for c in calls]:
                    fail(f"replica checked '{q}': route {route}, calls "
                         f"{calls}, rows == leader {got == lead[q]}")
                checked[q] = (route, calls)
        finally:
            if guard is not None:
                guard.__exit__()
    midstmt = {k: v for k, v in dom.metrics.items()
               if k.startswith("replica_midstmt_") and v}
    degraded = mu.REPLICA_ROUTE.labels("degraded_midstmt").value - \
        r0["degraded_midstmt"]
    served = dom.metrics.get("replica_served_max_lag_ms", 0.0)
    if degraded or midstmt or routed() <= 0:
        fail(f"replica: {degraded} mid-statement degrades, reports "
             f"{midstmt}, {routed()} routed statements")
    if served > REPLICA_SLA_MS:
        fail(f"replica: a served statement was {served} ms stale")
    if seams.feed_threads():
        fail(f"replica: feed or monitor threads at device seams: "
             f"{seams.feed_threads()}")
    peak = None
    if cuda:
        import torch
        peak = torch.cuda.max_memory_allocated()
    rec = {"rows": rows, "load_s": load_s, "catchup_s": catchup_s,
           "warm_ms": ms, "routed": routed(),
           "leader_fallback": mu.REPLICA_ROUTE.labels(
               "leader_fallback").value - r0["leader_fallback"],
           "analyst_statements": runs[0], "kill_recovery_s": kills,
           "served_max_lag_ms": served, "peak_device_bytes": peak,
           "device_seams_by_thread": seams.names}
    for q, (route, calls) in checked.items():
        log(f"replica '{q}' on {route}: kernel calls == plain versions: " +
            "; ".join(f"{c} {sh}" for c, sh in calls))
    log(f"replica: {rec['routed']} statements routed to replicas, "
        f"{rec['leader_fallback']} to the leader, 0 degraded, "
        f"{runs[0]} analyst statements under 2 kills (back to serving in "
        f"{[round(k, 2) for k in kills]} s); served lag <= {served:.1f} ms"
        f"; warm ms {json.dumps(ms)}; peak device memory {peak} bytes; "
        f"card {card}")
    dom.close()
    return rec


def phase_br_restore(tk, br, exp, htap, card, device=None):
    """RESTORE DATABASE test from the snapshot (UNTIL TS its backup ts:
    the log the HTAP writes filled is not replayed) into a fresh Domain
    with its own data dir: Q1, Q3, Q6 and Q13 == the committed SF1
    rows. Then DROP DATABASE and RESTORE ... UNTIL TS the HTAP phase's
    mid-stream ts in the same Domain: the old table ids come back, the
    first statement uploads, and Q1, Q6 and Q13 (whose materialized dim
    the cache held for the dropped tables) == the leader's reads at that
    ts. -> the record."""
    import shutil
    import tempfile
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.session import new_store
    from tidb_tpu_torch.testkit import TestKit
    from tidb_tpu_torch.utils import phase
    feed = br["feed"]
    if not wait_for(lambda: feed.checkpoint_ts >= htap["mid_ts"],
                    timeout=120):
        fail(f"logbackup:// feed checkpoint {feed.checkpoint_ts} below "
             f"the mid-stream ts {htap['mid_ts']}")
    feed.drain()
    tk.domain.cdc.remove("br_log")
    src = f"local://{br['path']}"
    out = {}
    ddir = tempfile.mkdtemp(prefix="restore_")
    try:
        tkr = TestKit(new_store(ddir, device=device))
        t0 = time.perf_counter()
        n = tkr.must_exec(f"restore database test from '{src}' until ts "
                          f"{br['backup_ts']}").affected
        out["restore_s"] = time.perf_counter() - t0
        if n != br["rows"]:
            fail(f"restore: {n} rows, backup holds {br['rows']}")
        ids = {t: tkr.domain.infoschema().table_by_name("test", t).id
               for t in BR_TABLES}
        if ids != br["table_ids"]:
            fail(f"restore: table ids {ids} != the backup's")
        for q in ("q1", "q3", "q6", "q13"):
            sql = tpch.ALL_QUERIES[q]
            for run in ("cold", "warm", "checked"):
                if run == "checked" and q not in ("q1", "q6"):
                    continue
                t0 = time.perf_counter()
                if run == "checked":
                    got, calls = checked_kernels(
                        lambda: tkr.must_query(sql)._norm())
                    log(f"br {q} restored: kernel calls == plain "
                        "versions: " + "; ".join(f"{c} {sh}"
                                                 for c, sh in calls))
                else:
                    got = tkr.must_query(sql)._norm()
                out[f"{q}_{run}_ms"] = (time.perf_counter() - t0) * 1e3
                if got != [tuple(r) for r in exp[q]]:
                    fail(f"br {q} {run} on the restored tables: rows {got}"
                         " != expected")
        log(f"br restore: {n} rows in {out['restore_s']:.1f} s; Q1, Q3, "
            "Q6, Q13 == expected SF1 rows (ms " + json.dumps(
                {k: round(v, 2) for k, v in out.items()
                 if k.endswith("_ms")}) + ")")
        # DROP and RESTORE in one Domain: the table ids repeat, the
        # resident columns and materialized dims (keyed on uids) must not
        tkr.must_exec("drop database test")
        t0 = time.perf_counter()
        tkr.must_exec(f"restore database test from '{src}' until ts "
                      f"{htap['mid_ts']}")
        out["pitr_s"] = time.perf_counter() - t0
        tkr.must_exec("use test")
        if {t: tkr.domain.infoschema().table_by_name("test", t).id
                for t in BR_TABLES} != ids:
            fail("drop + restore: the table ids changed")
        m0 = tkr.domain.metrics.get("fused_matdim_build", 0)
        phase.reset()
        got = tkr.must_query(tpch.ALL_QUERIES["q13"])._norm()
        snap = phase.snap()
        builds = tkr.domain.metrics.get("fused_matdim_build", 0) - m0
        if got != htap["mid_rows"]["q13"] or \
                not snap.get("upload_bytes") or not builds:
            fail(f"br drop + restore: Q13 rows == the leader's at the "
                 f"mid-stream ts {got == htap['mid_rows']['q13']}, "
                 f"{phase_line(snap)}, matdim builds {builds}")
        for q in ("q1", "q6"):
            got = tkr.must_query(tpch.ALL_QUERIES[q])._norm()
            if got != htap["mid_rows"][q]:
                fail(f"br pitr {q}: rows {got} != the leader's read at ts "
                     f"{htap['mid_ts']}")
        log(f"br drop + RESTORE ... UNTIL TS {htap['mid_ts']}: the same "
            f"table ids back in {out['pitr_s']:.1f} s; Q13's first "
            f"statement uploaded {snap['upload_bytes']} bytes and rebuilt "
            "its materialized dim; Q13, Q1 and Q6 == the leader's reads at "
            f"that ts; card {card}")
        tkr.domain.close()
    finally:
        shutil.rmtree(ddir, ignore_errors=True)
    out.update({"backup_s": br["backup_s"],
                "backup_bytes": br["backup_bytes"], "rows": br["rows"]})
    return out

CLUSTER_WORKERS = 3
CLUSTER_BLOCK = 250_000
CLUSTER_Q6 = ("select sum(l_extendedprice * l_discount), count(*) from "
              "lineitem where l_shipdate >= date '1994-01-01' and "
              "l_shipdate < date '1995-01-01' and l_discount between 0.05 "
              "and 0.07 and l_quantity < 24")
CLUSTER_MASKED = ("select sum(l_quantity), count(*) from lineitem where "
                  "l_commitdate < l_receiptdate")
CLUSTER_GROUPED = ("select l_linenumber, sum(l_quantity), count(*) from "
                   "lineitem group by l_linenumber")
CLUSTER_GROUPS = 8
CLUSTER_KILL_ROWS = 600
CLUSTER_SHUFFLE_RUNS = 3
# a worker's Domain counters that a degrade, a retry or a host route moves
CLUSTER_BAD = ("device_dispatch_error", "device_retry", "device_fallback",
               "device_breaker_short_circuit", "copr_host_exec",
               "fused_pipeline_fallback", "fused_pipeline_error")


# a cluster worker as this script starts it: the port's worker
# (cluster/worker.py serve_worker) with each scan_kernels wrapper
# replaced by one that, while the switch is on, also runs the kernel's
# plain version on the same device tensors and, once the request's work
# is done (not inside it), compares the two: the reply's meta gains
# "kernel_check" {kernel: [calls, max abs err, equal]}. The worker op
# {"op": "kernel_check", "on": bool} flips the switch. The plain runs
# launch no kernel and count nothing. argv: PORT [--cpu]
CLUSTER_WORKER = r"""
import sys
import torch
from tidb_tpu_torch.cluster import worker as wk
from tidb_tpu_torch.ops import scan_kernels as sk

check = {"on": False, "pairs": None}


def checking(name, wrapper):
    plain = getattr(sk, name + "_plain")

    def call(*args, **kw):
        got = wrapper(*args, **kw)
        if check["pairs"] is not None:
            check["pairs"].append((name, got, plain(*args, **kw)))
        return got
    return call


for fn in sk.KERNELS:
    setattr(sk, fn.__name__, checking(fn.__name__, fn))
counted, handle = wk._counted, wk.WorkerServer._handle


def checked_counted(domain, fn):
    if not check["on"]:
        return counted(domain, fn)
    check["pairs"] = []
    try:
        out, meta = counted(domain, fn)
    finally:
        pairs, check["pairs"] = check["pairs"], None
    res = {}
    for name, got, want in pairs:
        r = res.setdefault(name, [0, 0, True])
        r[0] += 1
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                r[2] = False
            if g.shape == w.shape and g.numel():
                r[1] = max(r[1], (g - w).abs().max().item())
    meta["kernel_check"] = res
    return out, meta


def checked_handle(self, op, msg, arrays):
    if op == "kernel_check":
        check["on"] = bool(msg["on"])
        return {"ok": True}, {}
    return handle(self, op, msg, arrays)


wk._counted = checked_counted
wk.WorkerServer._handle = checked_handle
wk.serve_worker(int(sys.argv[1]),
                device="cpu" if "--cpu" in sys.argv[2:] else None)
"""


def tbl_text(block):
    """Rows of lineitem as .tbl text (fields joined by '|', one row a
    line): `block` is [(kind, data, extra)] per column in table order,
    kind "int", "dec" (scaled int64, extra = scale), "date" (days since
    the epoch) or "dict" (int32 codes, extra = the values)."""
    import numpy as np
    fields = []
    for kind, data, extra in block:
        if kind == "int":
            s = data.astype(str).tolist()
        elif kind == "dec":
            a = np.abs(data)
            s = [f"{sign}{q}.{r}" for sign, q, r in zip(
                np.where(data < 0, "-", "").tolist(),
                (a // 10 ** extra).tolist(),
                np.char.zfill((a % 10 ** extra).astype(str), extra).tolist())]
        elif kind == "date":
            s = (np.datetime64("1970-01-01", "D") +
                 data.astype("timedelta64[D]")).astype(str).tolist()
        else:
            s = np.asarray(extra, dtype=object)[data].tolist()
        fields.append(s)
    return "".join(f"{'|'.join(row)}\n" for row in zip(*fields))


def cluster_shards(tk, tmp, nshards):
    """lineitem of the main TestKit dealt by row to `nshards` .tbl files
    (row i to shard i % nshards, as the reference's load_shard deals),
    the text made by one process per core. -> (paths, rows per shard)."""
    import multiprocessing
    from tidb_tpu_torch.types.field_type import TypeClass
    dom = tk.domain
    tbl = dom.infoschema().table_by_name("test", "lineitem")
    ctab = dom.columnar.tables[tbl.id]
    cols = []
    for ci in tbl.columns:
        data = ctab.data[ci.id][:ctab.n]
        d = ctab.dicts.get(ci.id)
        if d is not None:
            cols.append(("dict", data, list(d.values)))
        elif ci.ft.tclass == TypeClass.DECIMAL:
            cols.append(("dec", data, max(ci.ft.decimal, 0)))
        elif ci.ft.tclass == TypeClass.DATE:
            cols.append(("date", data, None))
        else:
            cols.append(("int", data, None))
    jobs, owner = [], []
    for s in range(nshards):
        n = len(cols[0][1][s::nshards])
        for lo in range(0, n, CLUSTER_BLOCK):
            jobs.append([(k, d[s::nshards][lo:lo + CLUSTER_BLOCK], x)
                         for k, d, x in cols])
            owner.append(s)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, min(os.cpu_count() or 1, 16))) as pool:
        texts = pool.map(tbl_text, jobs)
    paths = []
    for s in range(nshards):
        path = os.path.join(tmp, f"lineitem.{s}.tbl")
        with open(path, "w") as f:
            for o, t in zip(owner, texts):
                if o == s:
                    f.write(t)
        paths.append(path)
    return paths, [len(cols[0][1][s::nshards]) for s in range(nshards)]


class WorkerProcs:
    """The cluster's worker processes: the port's worker on a free port
    (`python -m tidb_tpu_torch.cluster.worker 0`, with --cpu off the
    card) started through CLUSTER_WORKER, each one's stderr in a file of
    `logdir`. spawn() is Cluster's spawn_worker; stop() ends every
    process still running."""

    def __init__(self, logdir, device=None):
        self.logdir = logdir
        self.device = device
        self.procs = []
        self.ports = {}

    def start(self):
        args = [sys.executable, "-c", CLUSTER_WORKER, "0"]
        if self.device == "cpu":
            args.append("--cpu")
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        err = open(os.path.join(self.logdir,
                                f"worker{len(self.procs)}.log"), "w")
        p = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=err, text=True)
        err.close()
        self.procs.append(p)
        return p

    def ready(self, p):
        line = p.stdout.readline().strip()
        if not line.startswith("WORKER_READY"):
            i = self.procs.index(p)
            with open(os.path.join(self.logdir, f"worker{i}.log")) as f:
                tail = f.read()[-2000:]
            fail(f"cluster: worker {i} did not start: {line!r}\n{tail}")
        port = int(line.split()[1])
        self.ports[port] = p
        return port

    def spawn(self):
        return self.ready(self.start())

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)


def record_replies(cl, replies):
    """Wrap each worker client's call so every reply's meta lands in
    `replies` as (port, op, meta) — the per-rank launches, syncs and
    counters of the worker ops (cluster/worker.py _counted)."""
    def wrap(w):
        if getattr(w, "_recorded", False):
            return
        call = w.call

        def recorded(msg, arrays=None, **kw):
            out, arrs = call(msg, arrays, **kw)
            replies.append((w.port, msg.get("op"), out))
            return out, arrs
        w.call = recorded
        w._recorded = True
    for w in cl.workers:
        wrap(w)
    client = cl._client

    def new_client(port):
        w = client(port)
        wrap(w)
        return w
    cl._client = new_client


def check_rank_meta(label, metas, want_syncs=None, on_card=True):
    """Gates on the meta of one fan-out's replies: every rank on the card,
    no degrade or host route, `want_syncs` syncs where given (None: syncs
    == dispatches, one per partition; False: not checked)."""
    for port, meta in metas:
        if on_card and not str(meta.get("device", "")).startswith("cuda"):
            fail(f"cluster {label}: worker {port} ran on {meta.get('device')}")
        bad = {k: v for k, v in meta.get("metrics", {}).items()
               if k in CLUSTER_BAD and v}
        ph = meta.get("phase", {})
        if bad or ph.get("device_fallbacks", 0):
            fail(f"cluster {label}: worker {port} degraded: {bad} {ph}")
        syncs = ph.get("syncs", 0)
        want = ph.get("dispatches", 0) if want_syncs is None else want_syncs
        if on_card and want_syncs is not False and (syncs != want or
                        (want_syncs is None and not want)):
            fail(f"cluster {label}: worker {port} {syncs} syncs, expected "
                 f"{want} ({phase_line(ph)})")


def held_to_plain(label, replies, held):
    """Gates on the replies of a run made with the workers' kernel_check
    on (CLUSTER_WORKER): on every rank each launch of a scan kernel was
    held to its plain version on the same tensors, and equal. Folds the
    differences into ERR and the compared calls into `held`."""
    for port, _op, meta in replies:
        if "launches" not in meta:
            continue
        kc = meta.get("kernel_check")
        if kc is None:
            fail(f"cluster {label}: worker {port} made no kernel check")
        for name in KERNELS:
            calls, err, equal = kc.get(name, (0, 0, True))
            if calls < meta["launches"].get(name, 0) or not equal:
                fail(f"cluster {label}: worker {port} {name}: "
                     f"{meta['launches'].get(name, 0)} launches, {calls} "
                     f"held to the plain version, equal {equal}, max abs "
                     f"err {err}")
            ERR[name] = max(ERR[name], err)
            held[name] += calls


def phase_cluster(tk, exp, card, shuffle_rows, device=None):
    """The cluster over torch.distributed: CLUSTER_WORKERS worker
    processes (the cards' shards of TiDB's MPP deployment, one task per
    store; here all on one card) join one gloo group, each holding its
    deal of SF1 lineitem loaded by IMPORT INTO from a .tbl file, with the
    coordinator in this process. Cases: spmd_agg of Q6's shape (==
    q6_oracle in scaled integers), a masked and a grouped spmd_agg (==
    numpy), query_agg of Q1 and Q6 (== the committed SF1 rows), the
    spmd_shuffle of lineitem x orders with o_orderpriority's code as
    payload (== phase_mpp's answer for MPP_SHUFFLE), then TSO, a 2PC
    over RPC and kill -9 of a worker under replication (the fragment
    query completes on the replacement's card, no acked write lost).
    Per rank: every reply on the card, no degrade, spmd_frag 1 sync, a
    warm partial 1 sync per partition, each scan kernel launched, and in
    one more run of each case (and of the recovered query) every launch
    held to its kernel's plain version (held_to_plain).
    -> the phase's figures (warm medians, bytes, per-rank launches)."""
    import numpy as np
    import torch
    from decimal import Decimal
    from tidb_tpu_torch.bench import tpch
    from tidb_tpu_torch.cluster import Cluster
    from tidb_tpu_torch.cluster.coordinator import _WorkerClient
    from tidb_tpu_torch.mpp.exec import _round_capacity, _shuffle_capacity
    from tidb_tpu_torch.native.build import load_library
    from tidb_tpu_torch.testkit import _fmt
    on_card = device is None
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    workers = WorkerProcs(tmp, device)
    cl = None
    replies = []
    out = {"ms": {}, "phase": {}, "launches": {}, "peak_mib": {},
           "held": dict.fromkeys(KERNELS, 0)}
    nw = CLUSTER_WORKERS
    try:
        t0 = time.perf_counter()
        paths, shard_rows = cluster_shards(tk, tmp, nw)
        out["write_s"] = time.perf_counter() - t0
        if load_library("loader") is None:
            log("cluster: no native loader (g++): IMPORT INTO parses with "
                "the Python fallback")
        t0 = time.perf_counter()
        procs = [workers.start() for _ in range(nw)]
        ports = [workers.ready(p) for p in procs]
        cl = Cluster(ports, spawn_worker=workers.spawn, device=device)
        record_replies(cl, replies)
        out["start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cl.ddl(tpch.DDL["lineitem"])
        cl._fanout(lambda i, w: w.call({"op": "load_sql", "sqls": [
            f"import into lineitem from '{paths[i]}'"]}))
        got = [o["rows"] for o, _ in cl._fanout(
            lambda i, w: w.call({"op": "table_rows", "table": "lineitem"}))]
        out["load_s"] = time.perf_counter() - t0
        if got != shard_rows:
            fail(f"cluster: lineitem rows per worker {got} != {shard_rows}")
        log(f"cluster: {nw} workers started in {out['start_s']:.1f} s; "
            f"lineitem {sum(shard_rows)} rows dealt {shard_rows}: .tbl "
            f"text {out['write_s']:.1f} s, IMPORT INTO {out['load_s']:.1f} s")
        layouts = cl.spmd_init()
        out["backend"] = layouts[0]["backend"]
        for lay in layouts:
            if on_card and not lay["device"].startswith("cuda"):
                fail(f"cluster: a worker's shard is on {lay['device']}")
            if lay["backend"] != out["backend"]:
                fail(f"cluster: backends differ: {layouts}")
        if on_card and torch.cuda.device_count() < nw and \
                out["backend"] != "gloo":
            fail(f"cluster: {nw} ranks on {torch.cuda.device_count()} "
                 f"card(s) took {out['backend']}, not gloo")
        log(f"cluster: process group of {nw} ranks, backend "
            f"{out['backend']} (the layout rule: {nw} ranks on "
            f"{torch.cuda.device_count()} card(s)); devices "
            f"{[lay['device'] for lay in layouts]}")

        def kernel_check(on):
            cl._fanout(lambda i, w: w.call({"op": "kernel_check",
                                            "on": on}))

        def timed(label, fn, runs, check):
            """Run fn cold once, `runs` warm times, then once more with
            the workers' kernel_check on (held_to_plain); check each
            result and its replies' meta. -> warm median ms."""
            warm = []
            for i in range(2 + runs):
                checked = i == 1 + runs
                if checked:
                    kernel_check(True)
                n0 = len(replies)
                t0 = time.perf_counter()
                res = fn()
                ms = (time.perf_counter() - t0) * 1e3
                if checked:
                    kernel_check(False)
                    held_to_plain(label, replies[n0:], out["held"])
                else:
                    last = replies[n0:]
                check(res, replies[n0:], i)
                if 0 < i <= runs:
                    warm.append(ms)
            out["ms"][label] = statistics.median(warm)
            metas = [m for _p, _op, m in last]
            out["phase"][label] = {
                k: sum(m.get("phase", {}).get(k, 0) for m in metas)
                for k in ("syncs", "dispatches", "spmd_upload_bytes",
                          "collective_stage_bytes", "mpp_exchange_bytes",
                          "fetch_bytes", "upload_bytes")}
            log(f"cluster {label}: warm median {out['ms'][label]:.3f} ms "
                f"({runs} warm); last run summed over ranks: "
                f"{json.dumps(out['phase'][label])}")

        def frag_metas(rs, op):
            return [(p, m) for p, o, m in rs if o == op]

        # 1. spmd_agg of Q6's shape
        (ship, _), (disc, _), (qty, _), (price, _) = tpch._lineitem(
            tk, "l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
        want_q6 = tpch.q6_oracle(tk)[0][0]
        from tidb_tpu_torch.types.time_types import parse_date
        m6 = (ship >= parse_date("1994-01-01")) & \
            (ship < parse_date("1995-01-01")) & (disc >= 5) & \
            (disc <= 7) & (qty < 2400)

        def check_q6(res, rs, i):
            got = tpch._fmt_scaled(int(np.asarray(res["sums"][0]).ravel()[0]),
                                   4)
            if got != want_q6 or int(np.asarray(res["counts"]).ravel()[0]) \
                    != int(m6.sum()):
                fail(f"cluster spmd q6 run {i}: {got} "
                     f"{res['counts']} != {want_q6} {int(m6.sum())}")
            check_rank_meta("spmd q6", frag_metas(rs, "spmd_frag"), 1,
                            on_card)
        timed("spmd_q6", lambda: cl.spmd_agg(CLUSTER_Q6), WARM_RUNS,
              check_q6)

        # 1b. a global spmd_agg whose filter does not lower to bounds
        (lq, _), (cd, _), (rd, _) = tpch._lineitem(
            tk, "l_quantity", "l_commitdate", "l_receiptdate")
        mm = cd < rd

        def check_masked(res, rs, i):
            got = [int(np.asarray(x).ravel()[0]) for x in res["sums"]]
            if got != [int(lq[mm].sum()), int(mm.sum())]:
                fail(f"cluster spmd masked run {i}: {got} != "
                     f"{[int(lq[mm].sum()), int(mm.sum())]}")
            check_rank_meta("spmd masked", frag_metas(rs, "spmd_frag"), 1,
                            on_card)
        timed("spmd_masked", lambda: cl.spmd_agg(CLUSTER_MASKED), WARM_RUNS,
              check_masked)

        # 2. spmd_agg grouped
        (ln, _), (lq, _) = tpch._lineitem(tk, "l_linenumber", "l_quantity")
        seg = np.clip(ln.astype(np.int64), 0, CLUSTER_GROUPS - 1)
        want_s = np.bincount(seg, weights=None, minlength=CLUSTER_GROUPS)
        want_q = np.zeros(CLUSTER_GROUPS, dtype=np.int64)
        np.add.at(want_q, seg, lq.astype(np.int64))

        def check_grouped(res, rs, i):
            if res["sums"][0].tolist() != want_q.tolist() or \
                    res["sums"][1].tolist() != want_s.tolist() or \
                    res["counts"].tolist() != want_s.tolist():
                fail(f"cluster spmd grouped run {i}: {res} != "
                     f"{want_q} {want_s}")
            check_rank_meta("spmd grouped", frag_metas(rs, "spmd_frag"), 1,
                            on_card)
        timed("spmd_grouped", lambda: cl.spmd_agg(
            CLUSTER_GROUPED, n_groups=CLUSTER_GROUPS), WARM_RUNS,
            check_grouped)

        # 3. query_agg of Q1 and Q6 (the partial fan-out)
        for q in ("q1", "q6"):
            sql, want = sql_and_rows(tk, exp, q)

            def check_rows(rows, rs, i, q=q, want=want):
                got = [tuple("<nil>" if v is None else _fmt(v) for v in r)
                       for r in rows]
                if got != want:
                    fail(f"cluster query_agg {q} run {i}: {got} != {want}")
                # a cold partial also runs first-touch ANALYZE: its syncs
                # are not one per partition
                check_rank_meta(f"query_agg {q}", frag_metas(rs, "partial"),
                                None if i else False, on_card)
            timed(f"query_agg_{q}", lambda sql=sql: cl.query_agg(sql),
                  WARM_RUNS, check_rows)

        # 4. the worker op spmd_shuffle: lineitem x orders
        (lok, _), (lq, _) = tpch._lineitem(tk, "l_orderkey", "l_quantity")
        (ook, _), (opr, prios) = tpch._columns(tk, "orders", "o_orderkey",
                                               "o_orderpriority")
        lc = -(-len(lok) // nw)
        lb = -(-len(ook) // nw)

        def padded(a, cap, fill=0):
            a = np.asarray(a)
            return np.concatenate([a, np.full(cap * nw - len(a), fill,
                                              dtype=a.dtype)])
        pk, pv = padded(lok.astype(np.int64), lc), padded(lq.astype(
            np.int64), lc)
        pok = padded(np.ones(len(lok), dtype=bool), lc, False)
        bk, bp = padded(ook.astype(np.int64), lb), padded(opr.astype(
            np.int64), lb)
        bok = padded(np.ones(len(ook), dtype=bool), lb, False)
        cap = _round_capacity(max(_shuffle_capacity(pk, pok, nw),
                                  _shuffle_capacity(bk, bok, nw), 1))
        ng = len(prios)
        want_rows = {str(r[0]): (Decimal(str(r[1])), int(r[2]))
                     for r in shuffle_rows}

        def shuffle():
            def call(i, w):
                return w.call({"op": "spmd_shuffle", "local_cap": lc,
                               "local_cap_build": lb, "n_groups": ng,
                               "cap": cap},
                              {"pk": pk[i * lc:(i + 1) * lc],
                               "pv": pv[i * lc:(i + 1) * lc],
                               "pok": pok[i * lc:(i + 1) * lc],
                               "bk": bk[i * lb:(i + 1) * lb],
                               "bp": bp[i * lb:(i + 1) * lb],
                               "bok": bok[i * lb:(i + 1) * lb]})
            return cl._fanout(call)

        def check_shuffle(outs, rs, i):
            for _meta, arrs in outs:
                got = {prios[c]: (Decimal(int(arrs["sums"][c])) / 100,
                                  int(arrs["counts"][c]))
                       for c in range(ng) if arrs["counts"][c]}
                if got != want_rows:
                    fail(f"cluster shuffle run {i}: {got} != phase_mpp's "
                         f"{want_rows}")
            check_rank_meta("shuffle", frag_metas(rs, "spmd_shuffle"),
                            None if out["backend"] == "nccl" else 2,
                            on_card)
        timed("spmd_shuffle", shuffle, CLUSTER_SHUFFLE_RUNS, check_shuffle)
        out["shuffle_cap"] = cap
        log(f"cluster shuffle: {len(lok)} x {len(ook)} rows, cap {cap}; "
            f"rows == phase_mpp's MPP_SHUFFLE answer on every rank")

        # 5. the control plane on the card
        import threading
        owner = [_WorkerClient(ports[0]) for _ in range(3)]
        stamps = [[] for _ in owner]

        def draw(j):
            for _ in range(50):
                stamps[j].append(owner[j].call({"op": "tso"})[0]["ts"])
        ths = [threading.Thread(target=draw, args=(j,)) for j in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        flat = [s for st in stamps for s in st]
        if any(b <= a for st in stamps for a, b in zip(st, st[1:])) or \
                len(set(flat)) != len(flat) or len(flat) != 150:
            fail("cluster: the TSO owner's stamps are not strictly "
                 "increasing and distinct across its callers")
        for c in owner:
            c.sock.close()
        from tidb_tpu_torch.codec.tablecodec import record_key
        from tidb_tpu_torch.codec.codec import encode_row_value
        from tidb_tpu_torch.types.datum import Datum, Kind
        cl.ddl("create table kv2 (a int primary key, b int)")
        tid = int(cl.query("select tidb_table_id from information_schema."
                           "tables where table_name = 'kv2'")[0][0])
        start, commit = cl.tso(), cl.tso()
        rv = encode_row_value([Datum(Kind.INT, 1), Datum(Kind.INT, 42)])
        for w in (1, 2):
            cl.workers[w].call(
                {"op": "prewrite", "n": 1, "has_v": [True],
                 "start_ts": start},
                {"k0": np.frombuffer(record_key(tid, 1), dtype=np.uint8),
                 "v0": np.frombuffer(rv, dtype=np.uint8)})
            cl.workers[w].call({"op": "commit", "start_ts": start,
                                "commit_ts": commit})
            if cl.query("select b from kv2 where a = 1", worker=w) != \
                    [(42,)]:
                fail(f"cluster: the 2PC write is not visible on worker {w}")
            if cl.tso(worker=w) <= commit:
                fail(f"cluster: worker {w}'s TSO is not past the commit ts")
        log("cluster: TSO owner strictly increasing over 3 callers x 50; "
            "2PC prewrite/commit over RPC visible on workers 1 and 2, "
            "their TSO past the commit ts")

        cl.enable_replication()
        cl.ddl("create table kr (id int primary key, v int)")
        rng = np.random.default_rng(SEED)
        vals = rng.integers(0, 1000, CLUSTER_KILL_ROWS)
        per = CLUSTER_KILL_ROWS // nw
        for w in range(nw):
            cl.workers[w].call({"op": "load_sql", "sqls": [
                "insert into kr values " + ",".join(
                    f"({i + 1},{vals[i]})"
                    for i in range(w * per, (w + 1) * per))]})
        kq = "select sum(v), count(*) from kr"
        want_k = [(str(int(vals.sum())), str(CLUSTER_KILL_ROWS))]

        def kill_rows():
            return [tuple(_fmt(v) for v in r) for r in cl.query_agg(kq)]
        if kill_rows() != want_k:
            fail(f"cluster: replicated table {kill_rows()} != {want_k}")
        victim = workers.ports[cl.workers[1].port]
        victim.kill()
        victim.wait(timeout=30)
        n0 = len(replies)
        t0 = time.perf_counter()
        got = kill_rows()
        out["recover_s"] = time.perf_counter() - t0
        if got != want_k:
            fail(f"cluster: after kill -9 of worker 1 {got} != {want_k}: "
                 "an acknowledged write was lost")
        new_port = cl.workers[1].port
        mine = [(p, m) for p, op, m in replies[n0:]
                if op == "partial" and p == new_port]
        if not mine:
            fail("cluster: the replacement worker ran no fragment")
        check_rank_meta("recovered partial", mine, None, on_card)
        if on_card and not mine[-1][1]["launches"].get("masked_sums"):
            fail(f"cluster: the replacement's fragment launched no "
                 f"masked_sums: {mine[-1][1]}")
        kernel_check(True)
        n1 = len(replies)
        got = kill_rows()
        kernel_check(False)
        if got != want_k:
            fail(f"cluster: the recovered query's checked run {got} != "
                 f"{want_k}")
        held_to_plain("recovered", replies[n1:], out["held"])
        log(f"cluster: kill -9 of worker 1 under replication: query_agg "
            f"recovered in {out['recover_s']:.1f} s on the replacement "
            f"({mine[-1][1]['device']}, launches "
            f"{json.dumps(mine[-1][1]['launches'])}); rows == every acked "
            "write")

        # each rank's launches over the phase (the replacement's under
        # its own port): every scan kernel on each of the first ranks
        for port, _op, meta in replies:
            per = out["launches"].setdefault(str(port), {})
            for k, v in meta.get("launches", {}).items():
                per[k] = per.get(k, 0) + v
        for port in ports if on_card else ():
            per = out["launches"].get(str(port), {})
            for name in KERNELS:
                if not per.get(name):
                    fail(f"cluster: {name} was not launched on worker "
                         f"{port}: {per}")
        log(f"cluster: launches per rank {json.dumps(out['launches'])}; "
            f"calls held to their plain versions on the ranks "
            f"{json.dumps(out['held'])}, max abs err "
            f"{json.dumps({k: ERR[k] for k in KERNELS})}")
        for port, _op, meta in replies:
            key = str(port)
            out["peak_mib"][key] = max(out["peak_mib"].get(key, 0.0),
                                       meta.get("peak_bytes", 0) / 2**20)
        log(f"cluster: peak device memory per rank (MiB) "
            f"{json.dumps(out['peak_mib'])}")
    finally:
        try:
            if cl is not None:
                cl.stop()
        finally:
            workers.stop()
            shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"cluster phase {out['seconds']:.1f} s ({card})")
    return out


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
    with open(os.path.join(ROOT, "tidb_tpu_torch", "bench",
                           "executor_sf1_expected.json")) as f:
        exp_exec = json.load(f)
    with open(os.path.join(ROOT, "tidb_tpu_torch", "bench",
                           "builtins_sf1_expected.json")) as f:
        exp_builtins = json.load(f)
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

    def counted(path, run, folds=True, kernels=KERNELS):
        sk.reset_launches()
        out = run()
        by_path[path] = {fn.__name__: sk.COUNTS[fn.__name__]
                         for fn in sk.KERNELS}
        pairs_by_path[path] = sk.COUNTS["product_pairs"]
        for name in kernels:
            if by_path[path][name] == 0:
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

        join_meds = counted("joins", lambda: phase_sql(
            tk, exp, nparts, [c[0] for c in JOIN_CASES], guard), folds=False)
        log(f"join phase {time.perf_counter() - t0:.1f} s; warm medians "
            f"ms: {json.dumps(join_meds)}")
        fired = {prog: [q for q, rec in PROGRAMS.items() if rec["took"][prog]]
                 for prog in PROGRAM_COUNTERS}
        log(f"learned programs served the warm statements of "
            f"{json.dumps(fired)}")
        for prog, qs in fired.items():
            if not qs:
                fail(f"the {prog} program served no SF1 statement")
        t0 = time.perf_counter()
        programs = counted("programs", lambda: phase_programs(tk, exp),
                           folds=False, kernels=())
        programs["seconds"] = time.perf_counter() - t0
        log(f"programs phase {programs['seconds']:.1f} s")
        t0 = time.perf_counter()
        reader_ms = counted("reader", lambda: phase_reader(tk, guard),
                            folds=False, kernels=("masked_sums",
                                                  "dense_group_sums"))
        log(f"reader phase {time.perf_counter() - t0:.1f} s; "
            f"{json.dumps(reader_ms)}")
        t0 = time.perf_counter()
        exec_ms = counted("executor", lambda: phase_executor(
            tk, exp_exec, guard, card), folds=False, kernels=())
        log(f"executor phase {time.perf_counter() - t0:.1f} s; "
            f"{json.dumps(exec_ms)}")
        builtins = counted("builtins", lambda: phase_builtins(
            tk, exp_builtins, guard, card), folds=False,
            kernels=("dense_group_sums",))
        log(f"builtins phase {builtins['seconds']:.1f} s; "
            f"{json.dumps(builtins)}")
        t0 = time.perf_counter()
        vec = counted("vector", lambda: phase_vector(tk, guard, card),
                      folds=False, kernels=())
        log(f"vector phase {time.perf_counter() - t0:.1f} s; warm ms "
            f"{json.dumps(vec['ms'])}; recall@{VEC_K} {vec['recall']}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ml = counted("ml", lambda: phase_ml(tk, guard, card, nparts),
                     folds=False, kernels=("masked_sums",))
        log(f"ml phase {time.perf_counter() - t0:.1f} s; warm ms "
            f"{json.dumps(ml['ms'])}")
        torch.cuda.empty_cache()
        mpp = counted("mpp", lambda: phase_mpp(
            tk, exp, guard, {**meds, **join_meds, "builtins_math": builtins[
                "math_lineitem"]["card_ms"]}, vec, ml))
        torch.cuda.empty_cache()
    log(f"{guard.calls} fragment and program enqueues and "
        f"{sum(guard.hook_calls.values())} hook calls "
        f"({json.dumps(guard.hook_calls)}) ran under "
        "set_sync_debug_mode('error')")
    # the cluster's kernels launch in its worker processes: each reply
    # carries its rank's launches, summed here as the path's count
    cluster = counted("cluster", lambda: phase_cluster(
        tk, exp, card, mpp.pop("twin_rows")["shuffle"]), folds=False,
        kernels=())
    by_path["cluster"] = {name: sum(r.get(name, 0) for r in
                                    cluster["launches"].values())
                          for name in KERNELS}
    torch.cuda.empty_cache()
    counted("wire", lambda: phase_wire(tk, exp, nparts, meds))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_br_")
    try:
        t0 = time.perf_counter()
        br = phase_br_snapshot(tk, tmp)
        htap = counted("htap", lambda: phase_htap(tk, exp, card),
                       kernels=("dense_group_sums", "range_filter_sums"))
        log(f"br snapshot and htap phases {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        replica = counted("replica", lambda: phase_replica(card),
                          folds=False,
                          kernels=("masked_sums", "dense_group_sums"))
        log(f"replica phase {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored = counted("br", lambda: phase_br_restore(
            tk, br, exp, htap, card),
            kernels=("dense_group_sums", "range_filter_sums"))
        log(f"br restore phase {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
            "mpp": by_path["mpp"][name],
            "cluster_by_rank": {port: c.get(name, 0) for port, c in
                                cluster["launches"].items()},
            "cluster_held": cluster["held"][name],
            "max_abs_err": ERR[name], "ms": r[4], "plain_ms": r[5],
            "bound_ms": r[7], "bound_by": "bytes", "library_ms": r[6],
            "kernel_device_ms": r[9]}
        rec["redesigned_in"] = 4 if name == "range_filter_sums" else 3
        if name == "range_filter_sums":
            rec["replaced_path_ms"] = r[8]
            rec["product_pairs_by_path"] = pairs_by_path
        kernels.append(rec)
    htap.pop("mid_rows")
    print(json.dumps({"htap_serving": {"htap": htap, "replica": replica,
                                       "br": restored}, "card": card}),
          flush=True)
    print(json.dumps({"mpp_mesh": {"shards": MPP_SHARDS, **mpp},
                      "card": card}), flush=True)
    print(json.dumps({"cluster": {"workers": CLUSTER_WORKERS, **cluster},
                      "card": card}), flush=True)
    print(json.dumps({"programs": vec["programs"] + ml["programs"],
                      "card": card}), flush=True)
    print(json.dumps({"builtins": builtins, "card": card}), flush=True)
    print(json.dumps({"learned_programs": {
        "routes": {q: {"took": rec["took"], "ngroups": rec["ngroups"],
                       "fetch_bytes": rec["fetch_bytes"]}
                   for q, rec in PROGRAMS.items()},
        "against_pins_off": programs}, "card": card}), flush=True)
    log(f"card: {card}")
    log(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
