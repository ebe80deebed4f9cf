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
    rf_ring          range_filter_sums with valid and predicate 0 brought
                     to the warps through a bulk-copy ring (one producer
                     thread, 3 stages of 8 chunks) instead of their own
                     vector loads; the source holds no ring, this variant
                     adds it (RING_KERNEL)
    rf_blocks=N      range_filter_sums built for N blocks per SM
    rf_no_keep       range_filter_sums keeps no predicate's values: an
                     operand that is a predicate's column is read again
                     (from L1 or L2), and the registers that held them
                     are free
    rf_stream_only   range_filter_sums stops after predicate 0 and reads
                     no term: the valid + predicate-0 stream alone (its
                     sums are wrong)

Names joined by "+" combine (rf_ring+rf_stream_only). The rf_
variants time range_filter_sums on Q6's folded inputs, the others
dense_group_sums and masked_sums; `tree` times all three.

From the repository root, on a machine with the card and nvcc:

    python3 -m tidb_tpu_torch.bench.kernel_variants tree ring_only \\
        aggregate_only blocks=2 blocks=3
    python3 -m tidb_tpu_torch.bench.kernel_variants tree rf_ring \\
        rf_stream_only rf_ring+rf_stream_only

Writes chiprun_out/kernel_variants.json."""
# tpulint: disable-file=unguarded-dispatch — a kernel timing harness:
# it times each kernel call alone on the card, where a supervised
# retry would hide a fault

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
_RF_TERMS = "  const int npred = a.npred;\n  const int k = a.k;\n"
_RF_KEEP = ("    if (p == a.keep) {", "    if ((a.a_kept >> j) & 1u) {",
            "      if ((a.b_kept >> j) & 1u) {")
_RF_BLOCKS = "constexpr int rf_min_blocks(int kc) { return kc <= 1 ? 2 : 1; }"
_RF_CHUNK = ("template <int KC>\n__device__ __forceinline__ void rf_chunk(",
             "                                         unsigned long long& cnt) {",
             "    load_pairs(a.pred[p] + base, (a.pred_pair >> p) & 1u, pr, v);\n")
_RF_LAUNCH = "int launch_rf(const RfArgs& a, cudaStream_t stream) {\n"
_HELPERS = "// ---- launch helpers"

# rf_ring: the ring kernel, put before the launch helpers. Consumer warp w
# takes chunk w of each tile; its launch passes nchunks in whole tiles, so
# rf_rows reads the head and every row after the last whole tile.
RING_KERNEL = r"""// ---- range_filter_sums through a bulk-copy ring (variant rf_ring)

constexpr int kRfRingWarps = 8;                          // consumer warps
constexpr int kRfRingThreads = (kRfRingWarps + 1) * 32;  // + one producer warp
constexpr int kRfTile = kRfRingWarps * kMsChunk;         // a chunk a consumer warp
constexpr int kRfStageBytes = kRfTile * 9;               // valid + predicate 0
constexpr int kRfStages = 3;                             // 108 KB: two blocks per SM

template <int KC>
__global__ void __launch_bounds__(kRfRingThreads, 2)
    range_filter_sums_ring_kernel(const __grid_constant__ RfArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRfStages;
  unsigned char* ring = smem + 2 * kRfStages * sizeof(uint64_t);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long ntiles = a.nchunks / kRfRingWarps;
  unsigned long long acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = 0ull;
  unsigned long long cnt = 0ull;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kRfRingWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kRfRingWarps) {
    if (lane == 0) {
      long long it = 0;
      for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
        const int s = (int)(it % kRfStages);
        const long long round = it / kRfStages;
        if (round > 0) mbar_wait(&empty[s], (unsigned)((round - 1) & 1));
        unsigned char* st = ring + (size_t)s * kRfStageBytes;
        const long long row0 = a.head + t * kRfTile;
        mbar_expect_tx(&full[s], kRfStageBytes);
        bulk_load(st, a.valid + row0, kRfTile, &full[s]);
        bulk_load(st + kRfTile, a.pred[0] + row0, 8u * kRfTile, &full[s]);
      }
    }
    __syncwarp();
  } else {
    rf_rows(a, acc, cnt);
    long long it = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
      const int s = (int)(it % kRfStages);
      mbar_wait(&full[s], (unsigned)((it / kRfStages) & 1));
      const unsigned char* st = ring + (size_t)s * kRfStageBytes;
      const uint4 m = reinterpret_cast<const uint4*>(st + warp * kMsChunk)[lane];
      const long long* p0 =
          reinterpret_cast<const long long*>(st + kRfTile) + warp * kMsChunk + 2 * lane;
      rf_chunk<KC, true>(a, m, a.head + t * kRfTile + warp * kMsChunk + 2 * lane, acc, cnt,
                         p0);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  // block_add over the consumer warps (the producer warp adds nothing)
  __shared__ unsigned long long part[kRfRingWarps][KC + 1];
  if (warp < kRfRingWarps) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j < a.k) {
        const unsigned long long v = warp_sum(acc[j]);
        if (lane == 0) part[warp][j] = v;
      }
    }
    const unsigned long long c = warp_sum(cnt);
    if (lane == 0) part[warp][KC] = c;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < a.k || t == KC) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int w = 0; w < kRfRingWarps; ++w) s += part[w][t];
    if (s != 0ull) atomicAdd(&a.out[t < a.k ? t : a.k], s);
  }
}

"""

# rf_ring: predicate 0's values come from the ring's stage (p0)
_RING_CHUNK = (
    "template <int KC, bool SMEM = false>\n"
    "__device__ __forceinline__ void rf_chunk(",
    "                                         unsigned long long& cnt,\n"
    "                                         const long long* p0 = nullptr) {",
    """    if (SMEM && p == 0) {
#pragma unroll
      for (int s = 0; s < kMsSteps; ++s) {
        const longlong2 t = reinterpret_cast<const longlong2*>(p0 + 64 * s)[0];
        v[s][0] = t.x;
        v[s][1] = t.y;
      }
    } else {
      load_pairs(a.pred[p] + base, (a.pred_pair >> p) & 1u, pr, v);
    }
""")

# rf_ring: the launch takes the ring where its bulk copies can: predicate
# 0 aligned at row head (valid is), and at least one whole tile
_RING_LAUNCH = r"""  if (a.npred > 0 && (a.pred_pair & 1u) && a.nchunks >= kRfRingWarps) {
    const size_t smem = 2 * kRfStages * sizeof(uint64_t) + (size_t)kRfStages * kRfStageBytes;
    static int most_ring = 0;
    if (most_ring == 0) {
      cudaFuncSetAttribute(range_filter_sums_ring_kernel<KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      cudaFuncSetAttribute(range_filter_sums_ring_kernel<KC>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
      most_ring = resident_blocks(range_filter_sums_ring_kernel<KC>, kRfRingThreads, smem);
    }
    RfArgs t = a;
    t.nchunks = a.nchunks / kRfRingWarps * kRfRingWarps;   // whole tiles
    range_filter_sums_ring_kernel<KC><<<clamp_grid(t.nchunks / kRfRingWarps, most_ring),
                                        kRfRingThreads, smem, stream>>>(t);
    return (int)cudaGetLastError();
  }
"""
KERNELS = ("dense_group_sums", "masked_sums", "range_filter_sums")


def variant_source(src, name):
    """The text of variant `name` of scan_kernels.cu."""
    for anchor in (_CALL, _ROW0, _BLOCKS, _MS, _RF_TERMS, _RF_BLOCKS,
                   *_RF_KEEP, *_RF_CHUNK, _RF_LAUNCH, _HELPERS):
        if anchor not in src:
            raise ValueError(f"scan_kernels.cu no longer holds {anchor!r}")
    for part in name.split("+"):
        src = _edit(src, part)
    return src


def _edit(src, name):
    if name == "tree":
        return src
    if name == "rf_ring":
        # from rf_chunk's template line on, the first of each anchor
        head, tail = src.split(_RF_CHUNK[0], 1)
        for old, new in zip(_RF_CHUNK[1:], _RING_CHUNK[1:]):
            tail = tail.replace(old, new, 1)
        src = head + _RING_CHUNK[0] + tail
        src = src.replace(_HELPERS, RING_KERNEL + _HELPERS, 1)
        return src.replace(_RF_LAUNCH, _RF_LAUNCH + _RING_LAUNCH, 1)
    if name.startswith("rf_blocks="):
        n = int(name.split("=", 1)[1])
        return src.replace(_RF_BLOCKS, "constexpr int rf_min_blocks(int kc) "
                           f"{{ return {n}; }}")
    if name == "rf_no_keep":
        for anchor in _RF_KEEP:
            src = src.replace(anchor, anchor.split("if (")[0] + "if (false) {")
        return src
    if name == "rf_stream_only":
        return src.replace(_RF_TERMS, "  const int npred = a.npred < 1 ? "
                           "a.npred : 1;\n  const int k = 0;\n")
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


def kernels_of(name):
    """The kernels variant `name` is timed on."""
    if name == "tree":
        return KERNELS
    if all(part.startswith("rf_") for part in name.split("+")):
        return ("range_filter_sums",)
    return ("dense_group_sums", "masked_sums")


def build_variant(name, out_dir):
    """nvcc variant `name` -> (library path, ptxas register lines)."""
    from ..ops import build
    os.makedirs(out_dir, exist_ok=True)
    tag = name.replace("=", "").replace("+", "_")
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
                q6 = p["q6"]
                runs = {
                    "dense_group_sums": (
                        lambda: sk.dense_group_sums(cols, slots, 12, valid),
                        lambda: sk.dense_group_sums_plain(cols, slots, 12,
                                                          valid)),
                    "masked_sums": (lambda: sk.masked_sums(cm, mask),
                                    lambda: sk.masked_sums_plain(cm, mask)),
                    "range_filter_sums": (
                        lambda: sk.range_filter_sums(*q6),
                        lambda: sk.range_filter_sums_plain(*q6))}
                for kern in kernels_of(name):
                    fn, plain = runs[kern]
                    r = rows.setdefault(f"{name} {kern} n={p['n']}", {
                        "exact": all(torch.equal(a, b)
                                     for a, b in zip(fn(), plain())),
                        "ms": [], "device_ms": []})
                    r["ms"].append(cs.time_ms(fn, flush=flush))
                    r["device_ms"].append(cs.device_ms(fn, kern, flush))
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
