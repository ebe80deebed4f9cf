// Scan-side reductions for the fused coprocessor fragment, written for
// Hopper (sm_90a). Plain C entry points, loaded with ctypes by
// tidb_tpu_torch/ops/scan_kernels.py; each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError(). The wrapper
// passes each distinct column buffer once (scan_kernels.distinct_buffers).
//
// tidb_masked_sums replaces tidb_tpu/ops/pallas_scan.py:masked_sums
// (_masked_sums_impl / _kernel): int64 sums of k columns over the rows
// where mask is set, plus the count of those rows. Memory-bound: it must
// read the n-byte mask and, of each column, the 32-byte sectors that
// hold a row whose mask is set (chip_smoke.py computes the bound from a
// run's data). A byte of mask per thread followed by dependent 8-byte
// loads would keep about 2 KB in flight per SM, where 3.35 TB/s over ~1
// us of latency needs 15-25 KB. Design: a warp takes 512-row chunks;
// each lane loads its 16 mask bytes as one 16-byte vector, and the next
// chunk's mask is in flight while the current chunk's columns load. The
// lanes' 16-bit live masks are exchanged with shuffles so that in each
// of 8 steps lane l reads rows 2l and 2l + 1 of a 64-row step: a warp's
// column loads cover 512 contiguous bytes, one 16-byte load where both
// rows are live and the column's address allows it, an 8-byte load
// where one is, none where neither is; a chunk whose mask is all clear
// reads no column bytes. The 8 steps' loads of a column are all issued
// before any is summed (112 registers: two blocks per SM; a third block
// spills and is slower). The grid is persistent: occupancy x SMs
// blocks, read once. A mask whose address is not 16-byte aligned (a
// view at an offset) takes its head rows, and the tail after the last
// whole chunk, one row per thread. Accumulators are int64 registers;
// each block reduces with warp shuffles and adds its k + 1 totals into
// the output with one 64-bit atomicAdd each (block_add). The atomics
// are kept, and not a merge by the last block to finish, because that
// merge needs a done-counter that lives across launches and one per
// stream (the wire server's connection threads launch concurrently)
// plus a scratch argument in the C contract, to save the caller's zero
// fill of k + 1 words. Integer adds wrap in two's complement, so the
// result is exact // and the same in any order.
//
// tidb_dense_group_sums replaces tidb_tpu/ops/pallas_scan.py:
// dense_group_sums (_group_sums_impl / _group_kernel): per-slot int64
// sums of k columns plus per-slot counts over a small dense slot domain;
// rows with !valid or a slot outside [0, nslots) are dropped. The TPU
// kernel sums through float32 one-hot matmuls and is exact only while a
// block's partial stays below 2^24; this one is exact in int64 at any
// magnitude. Bound: the n-byte valid mask, the slots' sectors that hold
// a valid row, each distinct column's sectors that hold a live row, and
// the output table; Q1's rows are nearly all live, so it streams whole
// columns. Rows cannot go straight into a shared table: a 64-bit
// shared-memory atomicAdd compiles for sm_90a to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64 in cuobjdump -sass), and Q1's 4 live groups put
// 32 lanes and 8 warps on 4 addresses per column. Design: a
// persistent grid; per block one producer thread issues 1-D
// cp.async.bulk copies of a tile of valid, slots and each column into a
// ring of shared-memory stages, each completing on its own mbarrier,
// while 8 consumer warps aggregate the tiles that have arrived and free
// each stage on a second mbarrier. A consumer warp takes 32 rows at a
// time: lanes with the same slot are found with __match_any_sync, their
// values summed in a shuffle tree (log2 of the largest group's size
// rounds), and the lowest lane of each group adds the sums into the
// warp's own [k+1][nslots] table with plain adds (one
// writer per slot in a warp: no atomics). At the end the 8 warp tables
// fold into the block's total, which is added into the output with one
// global atomicAdd per nonzero entry. What bounds it is that chain of
// dependent warp operations per 32 rows more than memory: on Q1's data
// the ring alone runs at about 1.1x the byte bound, the kernel built for
// two blocks per SM at 2x, for four at 1.4x (bench/kernel_variants.py,
// PERF.md). So the design buys warps: the kernel is instantiated for column buckets of 4, 8 and 16,
// so that x[] holds only the registers k needs, and bounded in
// registers for four blocks per SM (three for 16 columns); tile rows
// (512..64) and stages (2..8) come from the shared memory left beside
// the warp tables, for as many blocks where the tables allow, else two
// or one. Bulk
// copies need 16-byte-aligned addresses: a valid mask at an offset
// peels a head of up to 15 rows, and the rows after the last whole tile
// are the tail; both are read straight from global memory by the
// consumer warps. Where the arguments' offsets differ modulo 16 bytes,
// so that no common head aligns them all, the whole launch reads every
// row that way: a rule on the pointers, decided before the launch.
//
// tidb_range_filter_sums replaces tidb_tpu/ops/pallas_scan.py:
// range_filter_sums (_range_filter_sums_impl / _filter_kernel), the
// whole TPC-H Q6 hot loop as one program: inclusive [lo, hi] tests on
// npred int64 columns, ANDed with valid, then int64 sums of k terms plus
// the count. A term is a column, as on the TPU, or the wrapped int64
// product of two columns: Q6's sum(l_extendedprice * l_discount) is
// folded in, where the reference's jitted fragment evaluates the product
// inside its program, so no product column is written to device memory.
// Memory-bound: it must read the n-byte valid mask in full; of predicate
// column p, the 32-byte sectors that hold a row still passing valid and
// predicates 0..p-1; of each operand buffer that is no predicate's, the
// sectors that hold a row that passed all. On Q6's data the first
// predicate (shipdate) keeps about 15 % of the rows, so valid and
// shipdate are most of the bytes. Design, after masked_sums: a warp takes
// 512-row chunks; each lane loads its 16 valid bytes as one vector, the
// next chunk's in flight; the live masks are exchanged by shuffles so
// that lane l reads rows 2l and 2l + 1 of each 64-row step, a 16-byte
// load where both rows are live and the column is aligned, 8 bytes where
// one is, none where neither is. Each predicate reads its column for the
// rows still live, all 8 steps' loads issued before any test, and clears
// the rows that fail; a chunk with no live row left stops. The terms
// then read their operands for the rows that passed; an operand that is
// a predicate's column (Q6's l_discount) reuses the values from the
// registers that tested it (one such predicate, `keep`, chosen from the
// pointers; other aliases read again, from L1). Products multiply as
// unsigned 64-bit, wrapping as torch's int64 `*` does. The kernel is
// instantiated for term buckets of 1, 4 and 16, so the accumulators take
// only the registers k needs; the grid is persistent (occupancy x SMs).
// A valid mask at an offset takes its head rows, and the tail after the
// last whole chunk, one row per thread; a column that the head does not
// align takes 8-byte loads, decided from the pointers before the launch.
// The predicate pointers, the lo/hi bounds and the term pointers travel
// by value in a __grid_constant__ kernel parameter (RfArgs), the
// counterpart of the TPU's SMEM bounds. Accumulators and the reduction
// are masked_sums' (block_add): exact, the same in any block order. An
// empty range (lo > hi) passes no row. What bounds it on Q6's data: the
// valid + shipdate stream alone runs at about 1.3x its bytes' bound
// (rf_stream_only); the rest is the chain of dependent loads of the
// later predicates and the terms, one round trip each per chunk, at 16
// warps per SM (a third block spills; PERF.md). dense_group_sums' bulk-copy
// ring, tried for valid + shipdate, was slower than these vector loads
// (bench/kernel_variants.py rf_ring adds it).
//
// The k column pointers travel by value in a kernel parameter (an array
// of up to kMaxCols device pointers), so evaluated aggregate arguments
// need no torch.stack copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxSlots = 64;   // bounds the per-warp tables: 8 x 17 x 64 x 8 B
constexpr int kMaxPreds = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct ColPtrs {
  const int64_t* p[kMaxCols];
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds the per-thread accumulators acc[0..k) (k <= KC) and cnt of a
// block into out[0..k] (out[k] the count): warp shuffles, then one 64-bit
// atomicAdd per output. Adds wrap mod 2^64, so the sums are exact and
// the same in any block order.
template <int KC>
__device__ __forceinline__ void block_add(const unsigned long long (&acc)[KC],
                                          unsigned long long cnt, int k,
                                          unsigned long long* __restrict__ out) {
  __shared__ unsigned long long part[kWarps][KC + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    if (j < k) {
      const unsigned long long v = warp_sum(acc[j]);
      if (lane == 0) part[warp][j] = v;
    }
  }
  const unsigned long long c = warp_sum(cnt);
  if (lane == 0) part[warp][KC] = c;
  __syncthreads();
  // thread j < k sums column j across warps; thread KC the count
  const int t = threadIdx.x;
  if (t < k || t == KC) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][t];
    if (s != 0ull) atomicAdd(&out[t < k ? t : k], s);
  }
}

// ---- masked_sums --------------------------------------------------------

constexpr int kMsChunk = 32 * 16;        // rows a warp takes: 16 mask bytes a lane
constexpr int kMsSteps = kMsChunk / 64;  // column steps of 64 rows, 2 a lane

// bit b of the result: byte b of w is nonzero (b < 4)
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

__device__ __forceinline__ unsigned live16(uint4 m) {
  return nonzero4(m.x) | nonzero4(m.y) << 4 | nonzero4(m.z) << 8 | nonzero4(m.w) << 12;
}

__device__ __forceinline__ uint4 mask_vec(const unsigned char* __restrict__ mask, int64_t head,
                                          int64_t c, int64_t nchunks, int lane) {
  if (c >= nchunks) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(mask + head + c * kMsChunk) + lane);
}

__global__ void __launch_bounds__(kThreads)
masked_sums_kernel(ColPtrs cols, int k, const unsigned char* __restrict__ mask, int64_t n,
                   int64_t head, int64_t nchunks, unsigned long long* __restrict__ out) {
  unsigned long long acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) acc[j] = 0ull;
  unsigned long long cnt = 0ull;
  const int lane = threadIdx.x & 31;
  // rows outside the whole chunks, one a thread: the head before the
  // first 16-byte-aligned mask byte, the tail after the last chunk
  const int64_t body_end = head + nchunks * kMsChunk;
  const int64_t extra = n - nchunks * kMsChunk;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < extra;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t row = i < head ? i : body_end + (i - head);
    if (mask[row]) {
      ++cnt;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < k) acc[j] += (unsigned long long)__ldg(cols.p[j] + row);
    }
  }
  // columns whose chunk rows start 16-byte aligned take paired loads
  unsigned paired = 0u;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j)
    if (j < k && ((reinterpret_cast<uintptr_t>(cols.p[j] + head) & 15u) == 0u)) paired |= 1u << j;
  const int64_t wstride = (int64_t)gridDim.x * kWarps;
  int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  uint4 m = mask_vec(mask, head, c, nchunks, lane);
  while (c < nchunks) {                      // uniform across the warp
    const int64_t cn = c + wstride;
    const uint4 mn = mask_vec(mask, head, cn, nchunks, lane);
    const unsigned bits = live16(m);
    cnt += __popc(bits);
    if (__any_sync(kFull, bits != 0u)) {
      // rows 2*lane, 2*lane + 1 of step s sit in lane 4s + lane/8's mask
      unsigned pr[kMsSteps];
#pragma unroll
      for (int s = 0; s < kMsSteps; ++s)
        pr[s] = (__shfl_sync(kFull, bits, 4 * s + (lane >> 3)) >> (2 * (lane & 7))) & 3u;
      const int64_t base = head + c * kMsChunk + 2 * lane;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < k) {
          const long long* p = reinterpret_cast<const long long*>(cols.p[j]) + base;
          const bool pair_ok = (paired >> j) & 1u;
          unsigned long long a[kMsSteps], b[kMsSteps];
#pragma unroll
          for (int s = 0; s < kMsSteps; ++s) {
            a[s] = 0ull;
            b[s] = 0ull;
            if (pair_ok && pr[s] == 3u) {
              const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p + 64 * s));
              a[s] = (unsigned long long)v.x;
              b[s] = (unsigned long long)v.y;
            } else {
              if (pr[s] & 1u) a[s] = (unsigned long long)__ldg(p + 64 * s);
              if (pr[s] & 2u) b[s] = (unsigned long long)__ldg(p + 64 * s + 1);
            }
          }
#pragma unroll
          for (int s = 0; s < kMsSteps; ++s) acc[j] += a[s] + b[s];
        }
      }
    }
    c = cn;
    m = mn;
  }
  block_add(acc, cnt, k, out);
}

// ---- dense_group_sums ---------------------------------------------------

constexpr int kGsWarps = 8;                      // consumer warps
constexpr int kGsThreads = (kGsWarps + 1) * 32;  // + one producer warp
constexpr int kGsMaxStages = 8;
constexpr int kGsBarBytes = 2 * kGsMaxStages * 8;
constexpr int kGsSmemPerSm = 220 * 1024;         // of the SM's 228 KB, 1 KB a block kept

// Blocks per SM the kernel for column bucket KC is built for: 4 (56
// registers a thread) where x[] is 8 columns or fewer, else 3 (72
// registers; 56 would spill).
constexpr int gs_min_blocks(int kc) { return kc <= 8 ? 4 : 3; }

// the column bucket a launch with k columns takes
constexpr int gs_bucket(int k) { return k <= 4 ? 4 : k <= 8 ? 8 : 16; }

struct GsArgs {
  ColPtrs cols;
  const long long* slots;
  const unsigned char* valid;
  unsigned long long* out;
  long long n;
  long long head;     // rows before the first tile (the aligning peel)
  long long ntiles;   // whole tiles of `rows` rows from row `head`
  int k, nslots, rows, stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One 32-row group: lanes whose rows share a slot sum their values in a
// shuffle tree over the peers; the lowest peer adds the sums into the
// warp's table `wt` ([k+1][nslots], row k the counts). Leaders of one
// group write distinct slots, so plain adds suffice.
template <int KC>
__device__ __forceinline__ void group_rows(bool live, long long slot, unsigned long long (&x)[KC],
                                           int k, int nslots, unsigned long long* wt) {
  const unsigned lane = threadIdx.x & 31;
  live = live && slot >= 0 && slot < nslots;
  const int key = live ? (int)slot : -1;
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned rel = __popc(below);              // position among the peers
  unsigned up = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, up != 0u)) {
    const int next = __ffs(up);              // 1 + the next peer up, 0 if none
    const int src = next ? next - 1 : (int)lane;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j < k) {
        const unsigned long long t = __shfl_sync(kFull, x[j], src);
        if (next) x[j] += t;
      }
    }
    up &= ~__ballot_sync(kFull, rel & 1u);   // odd positions are summed in
    rel >>= 1;
  }
  if (live && below == 0u) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (j < k) wt[j * nslots + key] += x[j];
    wt[k * nslots + key] += (unsigned long long)__popc(peers);
  }
  __syncwarp();
}

// KC: the column bucket (4, 8 or 16 >= k), so x[] takes only the registers k needs
template <int KC>
__global__ void __launch_bounds__(kGsThreads, gs_min_blocks(KC))
    dense_group_sums_kernel(const GsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kGsMaxStages;
  const int k = a.k, nslots = a.nslots, rows = a.rows, stages = a.stages;
  const int tsize = (k + 1) * nslots;
  unsigned long long* tables = reinterpret_cast<unsigned long long*>(smem + kGsBarBytes);
  unsigned char* ring = smem + kGsBarBytes + sizeof(unsigned long long) * kGsWarps * tsize;
  const unsigned stage_bytes = (unsigned)rows * (9u + 8u * (unsigned)k);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < kGsWarps * tsize; t += kGsThreads) tables[t] = 0ull;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGsWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kGsWarps) {
    // producer: one thread keeps the ring's stages filled
    if (lane == 0) {
      long long it = 0;
      for (long long t = blockIdx.x; t < a.ntiles; t += gridDim.x, ++it) {
        const int s = (int)(it % stages);
        const long long round = it / stages;
        if (round > 0) mbar_wait(&empty[s], (unsigned)((round - 1) & 1));
        unsigned char* st = ring + (size_t)s * stage_bytes;
        const long long row0 = a.head + t * rows;
        mbar_expect_tx(&full[s], stage_bytes);
        bulk_load(st, a.valid + row0, (unsigned)rows, &full[s]);
        bulk_load(st + rows, a.slots + row0, 8u * rows, &full[s]);
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < k)
            bulk_load(st + (size_t)(9 + 8 * j) * rows, a.cols.p[j] + row0, 8u * rows, &full[s]);
      }
    }
    __syncwarp();
  } else {
    unsigned long long* wt = tables + warp * tsize;
    unsigned long long x[KC];
    // rows outside the tiles (the aligning head, the ragged tail; every
    // row where the pointers admit no common aligned head), read straight
    // from global memory while the first tiles load
    const long long body_end = a.head + a.ntiles * rows;
    const long long extra = a.n - a.ntiles * rows;
    for (long long g = (long long)blockIdx.x * kGsWarps + warp; g * 32 < extra;
         g += (long long)gridDim.x * kGsWarps) {
      const long long i = g * 32 + lane;
      bool live = false;
      long long slot = -1;
#pragma unroll
      for (int j = 0; j < KC; ++j) x[j] = 0ull;
      if (i < extra) {
        const long long row = i < a.head ? i : body_end + (i - a.head);
        live = a.valid[row] != 0;
        if (live) {
          slot = __ldg(a.slots + row);
          if (slot >= 0 && slot < nslots) {
#pragma unroll
            for (int j = 0; j < KC; ++j)
              if (j < k) x[j] = (unsigned long long)__ldg(a.cols.p[j] + row);
          }
        }
      }
      group_rows(live, slot, x, k, nslots, wt);
    }
    // the tiles, from the ring
    long long it = 0;
    for (long long t = blockIdx.x; t < a.ntiles; t += gridDim.x, ++it) {
      const int s = (int)(it % stages);
      mbar_wait(&full[s], (unsigned)((it / stages) & 1));
      const unsigned char* st = ring + (size_t)s * stage_bytes;
      const long long* sl = reinterpret_cast<const long long*>(st + rows);
      for (int g = warp; g < rows / 32; g += kGsWarps) {
        const int i = g * 32 + lane;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < k)
            x[j] = reinterpret_cast<const unsigned long long*>(st + (size_t)(9 + 8 * j) * rows)[i];
        group_rows(st[i] != 0, sl[i], x, k, nslots, wt);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tsize; e += kGsThreads) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int w = 0; w < kGsWarps; ++w) s += tables[w * tsize + e];
    if (s != 0ull) atomicAdd(&a.out[e], s);
  }
}

// Tile rows and stages for (k, nslots): within the first shared-memory
// budget (kGsSmemPerSm over gs_min_blocks, 2, then 1 blocks per SM) that
// holds the warp tables and two stages, the largest tile of 512..64 rows
// with two stages, then as many stages as fit (at most kGsMaxStages).
// rows == 0: no ring (every row read from global memory).
struct GsPlan {
  int rows, stages;
  size_t smem;
};

GsPlan gs_plan(int k, int nslots, bool bulk) {
  const size_t fixed = kGsBarBytes + sizeof(unsigned long long) * kGsWarps * (k + 1) * nslots;
  GsPlan p{0, 0, fixed};
  if (!bulk) return p;
  const int per_sm[3] = {gs_min_blocks(gs_bucket(k)), 2, 1};
  for (const int blocks : per_sm) {
    const size_t budget = kGsSmemPerSm / blocks;
    for (int rows = 512; rows >= 64; rows >>= 1) {
      const size_t stage = (size_t)rows * (9 + 8 * k);
      if (fixed + 2 * stage > budget) continue;
      size_t s = (budget - fixed) / stage;
      if (s > kGsMaxStages) s = kGsMaxStages;
      p.rows = rows;
      p.stages = (int)s;
      p.smem = fixed + s * stage;
      return p;
    }
  }
  return p;
}

// ---- range_filter_sums --------------------------------------------------

struct RfArgs {                  // about 0.7 KB of kernel parameters
  const long long* pred[kMaxPreds];
  long long lo[kMaxPreds];       // inclusive bounds
  long long hi[kMaxPreds];
  const long long* a[kMaxCols];  // term j sums a[j], or a[j] * b[j]
  const long long* b[kMaxCols];  // nullptr: a plain sum
  const unsigned char* valid;
  unsigned long long* out;
  long long n;
  long long head;                // rows before the first 16-byte-aligned valid byte
  long long nchunks;             // whole chunks of kMsChunk rows from row head
  int npred, k;
  int keep;                      // the predicate whose tested values operands reuse, or -1
  unsigned a_kept, b_kept;       // bit j: a[j] / b[j] is predicate keep's column
  unsigned pred_pair, a_pair, b_pair;  // bit: 16-byte loads (aligned at row head)
};

// The values of rows 2 * lane and 2 * lane + 1 of a chunk's 8 steps of 64
// rows (p: the lane's first row) where live (bits 0 and 1 of pr[s]): one
// 16-byte load where both are and `pair`, an 8-byte load per live row
// otherwise, none where neither is; 0 where a row is not live.
__device__ __forceinline__ void load_pairs(const long long* __restrict__ p, bool pair,
                                           const unsigned (&pr)[kMsSteps],
                                           long long (&v)[kMsSteps][2]) {
#pragma unroll
  for (int s = 0; s < kMsSteps; ++s) {
    v[s][0] = 0;
    v[s][1] = 0;
    if (pair && pr[s] == 3u) {
      const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(p + 64 * s));
      v[s][0] = t.x;
      v[s][1] = t.y;
    } else {
      if (pr[s] & 1u) v[s][0] = __ldg(p + 64 * s);
      if (pr[s] & 2u) v[s][1] = __ldg(p + 64 * s + 1);
    }
  }
}

// One warp's chunk of kMsChunk rows. m: the lane's 16 valid bytes; base:
// the row of the lane's first value (row 2 * lane of step 0). Each predicate
// tests the rows still live, with all 8 steps' loads of its column issued
// before any test; the chunk ends where no row of the warp is left. Then
// each term's operands are read for the rows that passed, an operand that
// is predicate `keep`'s column from the registers that tested it.
template <int KC>
__device__ __forceinline__ void rf_chunk(const RfArgs& a, uint4 m, long long base,
                                         unsigned long long (&acc)[KC],
                                         unsigned long long& cnt) {
  const int npred = a.npred;
  const int k = a.k;
  const int lane = threadIdx.x & 31;
  const unsigned bits = live16(m);
  if (!__any_sync(kFull, bits != 0u)) return;
  // rows 2*lane, 2*lane + 1 of step s sit in lane 4s + lane/8's mask
  unsigned pr[kMsSteps];
#pragma unroll
  for (int s = 0; s < kMsSteps; ++s)
    pr[s] = (__shfl_sync(kFull, bits, 4 * s + (lane >> 3)) >> (2 * (lane & 7))) & 3u;
  long long kv[kMsSteps][2];
#pragma unroll
  for (int s = 0; s < kMsSteps; ++s) kv[s][0] = kv[s][1] = 0;
  // unrolled with static indices, and the arguments __grid_constant__,
  // so the parameter arrays stay in the constant bank (no local copy)
#pragma unroll
  for (int p = 0; p < kMaxPreds; ++p) {
    if (p >= npred) break;
    long long v[kMsSteps][2];
    load_pairs(a.pred[p] + base, (a.pred_pair >> p) & 1u, pr, v);
    const long long lo = a.lo[p], hi = a.hi[p];
    unsigned any = 0u;
#pragma unroll
    for (int s = 0; s < kMsSteps; ++s) {
      if (v[s][0] < lo || v[s][0] > hi) pr[s] &= ~1u;
      if (v[s][1] < lo || v[s][1] > hi) pr[s] &= ~2u;
      any |= pr[s];
    }
    if (p == a.keep) {
#pragma unroll
      for (int s = 0; s < kMsSteps; ++s) {
        kv[s][0] = v[s][0];
        kv[s][1] = v[s][1];
      }
    }
    if (!__any_sync(kFull, any != 0u)) return;
  }
  unsigned c = 0u;
#pragma unroll
  for (int s = 0; s < kMsSteps; ++s) c += __popc(pr[s]);
  cnt += c;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    if (j >= k) break;
    long long x[kMsSteps][2], y[kMsSteps][2];
    const bool prod = a.b[j] != nullptr;
    if ((a.a_kept >> j) & 1u) {
#pragma unroll
      for (int s = 0; s < kMsSteps; ++s) x[s][0] = kv[s][0], x[s][1] = kv[s][1];
    } else {
      load_pairs(a.a[j] + base, (a.a_pair >> j) & 1u, pr, x);
    }
    if (prod) {
      if ((a.b_kept >> j) & 1u) {
#pragma unroll
        for (int s = 0; s < kMsSteps; ++s) y[s][0] = kv[s][0], y[s][1] = kv[s][1];
      } else {
        load_pairs(a.b[j] + base, (a.b_pair >> j) & 1u, pr, y);
      }
    }
    // unsigned: the product wraps mod 2^64 as torch's int64 `*` does
    unsigned long long t = 0ull;
#pragma unroll
    for (int s = 0; s < kMsSteps; ++s) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        unsigned long long xv = (unsigned long long)x[s][r];
        if (prod) xv *= (unsigned long long)y[s][r];
        if ((pr[s] >> r) & 1u) t += xv;
      }
    }
    acc[j] += t;
  }
}

// One row outside the whole chunks (the aligning head, the tail), read
// straight from global memory; stops at the first failing test.
template <int KC>
__device__ __forceinline__ void rf_row(const RfArgs& a, long long row,
                                       unsigned long long (&acc)[KC],
                                       unsigned long long& cnt) {
  if (!a.valid[row]) return;
#pragma unroll
  for (int p = 0; p < kMaxPreds; ++p) {
    if (p >= a.npred) break;
    const long long v = __ldg(a.pred[p] + row);
    if (v < a.lo[p] || v > a.hi[p]) return;
  }
  ++cnt;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    if (j >= a.k) break;
    unsigned long long x = (unsigned long long)__ldg(a.a[j] + row);
    if (a.b[j] != nullptr) x *= (unsigned long long)__ldg(a.b[j] + row);
    acc[j] += x;
  }
}

// The rows outside the whole chunks, one a thread: the head before the
// first aligned valid byte, the tail after the last chunk.
template <int KC>
__device__ __forceinline__ void rf_rows(const RfArgs& a, unsigned long long (&acc)[KC],
                                        unsigned long long& cnt) {
  const long long body_end = a.head + a.nchunks * kMsChunk;
  const long long extra = a.n - a.nchunks * kMsChunk;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < extra;
       i += (long long)gridDim.x * kThreads)
    rf_row(a, i < a.head ? i : body_end + (i - a.head), acc, cnt);
}

// Blocks per SM the kernel for term bucket KC is built for: two for one
// term (114 registers); three spill and are slower (rf_blocks=3). The
// 4- and 16-term buckets take up to 250 registers, one block.
constexpr int rf_min_blocks(int kc) { return kc <= 1 ? 2 : 1; }

// KC: the term bucket (1, 4 or 16 >= k), so acc[] takes only the registers k needs
template <int KC>
__global__ void __launch_bounds__(kThreads, rf_min_blocks(KC))
    range_filter_sums_kernel(const __grid_constant__ RfArgs a) {
  unsigned long long acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = 0ull;
  unsigned long long cnt = 0ull;
  rf_rows(a, acc, cnt);
  const int lane = threadIdx.x & 31;
  const long long wstride = (long long)gridDim.x * kWarps;
  long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  uint4 m = mask_vec(a.valid, a.head, c, a.nchunks, lane);
  while (c < a.nchunks) {                    // uniform across the warp
    const long long cn = c + wstride;
    const uint4 mn = mask_vec(a.valid, a.head, cn, a.nchunks, lane);
    rf_chunk(a, m, a.head + c * kMsChunk + 2 * lane, acc, cnt);
    c = cn;
    m = mn;
  }
  block_add(acc, cnt, a.k, a.out);
}

// ---- launch helpers -----------------------------------------------------

int sm_count() {
  static int cached[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev >= 0 && dev < 16 ? dev : 0;
  if (cached[slot] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[slot] = sms > 0 ? sms : 1;
  }
  return cached[slot];
}

// blocks of `fn` resident at once on the card (occupancy x SMs)
template <typename F>
int resident_blocks(F fn, int threads, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  return (per_sm > 0 ? per_sm : 1) * sm_count();
}

int clamp_grid(long long want, int most) {
  if (want < 1) want = 1;
  return (int)(want < most ? want : most);
}

// dense_group_sums_kernel<KC> with `smem` bytes of dynamic shared memory
// on at most `cap` blocks (occupancy x SMs, read at the first launch)
template <int KC>
int launch_gs(const GsArgs& a, size_t smem, long long want, int& cap, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(dense_group_sums_kernel<KC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGsSmemPerSm);
    cudaFuncSetAttribute(dense_group_sums_kernel<KC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    attr_set = true;
  }
  if (cap == 0) cap = resident_blocks(dense_group_sums_kernel<KC>, kGsThreads, smem);
  dense_group_sums_kernel<KC><<<clamp_grid(want, cap), kGsThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the term bucket a launch with k terms takes
constexpr int rf_bucket(int k) { return k <= 1 ? 1 : k <= 4 ? 4 : 16; }

// range_filter_sums_kernel<KC> on at most occupancy x SMs blocks (read
// at the first launch)
template <int KC>
int launch_rf(const RfArgs& a, cudaStream_t stream) {
  static int most = 0;
  if (most == 0) most = resident_blocks(range_filter_sums_kernel<KC>, kThreads, 0);
  range_filter_sums_kernel<KC>
      <<<clamp_grid((a.nchunks + kWarps - 1) / kWarps, most), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

ColPtrs pack(const void* const* ptrs, int k) {
  ColPtrs c;
  for (int j = 0; j < kMaxCols; ++j)
    c.p[j] = j < k ? static_cast<const int64_t*>(ptrs[j]) : nullptr;
  return c;
}

}  // namespace

extern "C" {

int tidb_scan_max_cols() { return kMaxCols; }
int tidb_scan_max_slots() { return kMaxSlots; }
int tidb_scan_max_preds() { return kMaxPreds; }

// out: int64[k + 1], zeroed by the caller; out[k] is the count.
int tidb_masked_sums(const void* const* col_ptrs, int k, const void* mask, long long n,
                     void* out, void* stream) {
  if (k < 0 || k > kMaxCols || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    static int most = 0;   // read once: the kernel's occupancy does not vary
    if (most == 0) most = resident_blocks(masked_sums_kernel, kThreads, 0);
    const unsigned char* m = static_cast<const unsigned char*>(mask);
    long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(m) & 15u)) & 15;
    if (head > n) head = n;
    const long long nchunks = (n - head) / kMsChunk;
    masked_sums_kernel<<<clamp_grid((nchunks + kWarps - 1) / kWarps, most), kThreads, 0,
                         (cudaStream_t)stream>>>(pack(col_ptrs, k), k, m, (int64_t)n, head,
                                                 nchunks, static_cast<unsigned long long*>(out));
  }
  return (int)cudaGetLastError();
}

// pred_ptrs[npred] with inclusive bounds lo[npred], hi[npred]; k terms,
// term j the sum of a_ptrs[j], or of the wrapped int64 product a_ptrs[j] *
// b_ptrs[j] where b_ptrs[j] is not null (host arrays, copied into the
// kernel parameters). out: int64[k + 1], zeroed by the caller; out[k] is
// the count. npred = 0 sums every valid row. A pointer named twice is one
// buffer: an operand that is a predicate's column reuses its values.
int tidb_range_filter_sums(const void* const* pred_ptrs, int npred, const long long* lo,
                           const long long* hi, const void* const* a_ptrs,
                           const void* const* b_ptrs, int k, const void* valid, long long n,
                           void* out, void* stream) {
  if (k < 0 || k > kMaxCols || npred < 0 || npred > kMaxPreds || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  RfArgs a = {};
  // the head that aligns valid to 16 bytes; a column whose row `head` it
  // does not align takes 8-byte loads
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(valid) & 15u)) & 15;
  if (head > n) head = n;
  auto paired = [head](const void* p) {
    return ((reinterpret_cast<uintptr_t>(p) + 8 * head) & 15u) == 0u;
  };
  a.keep = -1;
  for (int p = 0; p < npred; ++p) {
    a.pred[p] = static_cast<const long long*>(pred_ptrs[p]);
    a.lo[p] = lo[p];
    a.hi[p] = hi[p];
    if (paired(pred_ptrs[p])) a.pred_pair |= 1u << p;
    for (int j = 0; j < k && a.keep < 0; ++j)
      if (a_ptrs[j] == pred_ptrs[p] || b_ptrs[j] == pred_ptrs[p]) a.keep = p;
  }
  for (int j = 0; j < k; ++j) {
    a.a[j] = static_cast<const long long*>(a_ptrs[j]);
    a.b[j] = static_cast<const long long*>(b_ptrs[j]);
    if (paired(a_ptrs[j])) a.a_pair |= 1u << j;
    if (b_ptrs[j] != nullptr && paired(b_ptrs[j])) a.b_pair |= 1u << j;
    if (a.keep >= 0 && a_ptrs[j] == pred_ptrs[a.keep]) a.a_kept |= 1u << j;
    if (a.keep >= 0 && b_ptrs[j] == pred_ptrs[a.keep]) a.b_kept |= 1u << j;
  }
  a.valid = static_cast<const unsigned char*>(valid);
  a.out = static_cast<unsigned long long*>(out);
  a.n = n;
  a.head = head;
  a.npred = npred;
  a.k = k;
  a.nchunks = (n - head) / kMsChunk;
  switch (rf_bucket(k)) {
    case 1: return launch_rf<1>(a, (cudaStream_t)stream);
    case 4: return launch_rf<4>(a, (cudaStream_t)stream);
    default: return launch_rf<16>(a, (cudaStream_t)stream);
  }
}

// out: int64[(k + 1) * nslots], zeroed by the caller; row k holds counts.
int tidb_dense_group_sums(const void* const* col_ptrs, int k, const void* slots,
                          const void* valid, long long n, int nslots, void* out,
                          void* stream) {
  if (k < 0 || k > kMaxCols || n < 0 || nslots < 1 || nslots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  // the head that aligns valid to 16 bytes must align every int64 buffer
  const uintptr_t v = reinterpret_cast<uintptr_t>(valid);
  long long head = (16 - (long long)(v & 15u)) & 15;
  if (head > n) head = n;
  bool bulk = ((reinterpret_cast<uintptr_t>(slots) + 8 * head) & 15u) == 0u;
  for (int j = 0; j < k; ++j)
    bulk = bulk && ((reinterpret_cast<uintptr_t>(col_ptrs[j]) + 8 * head) & 15u) == 0u;
  GsPlan plan = gs_plan(k, nslots, bulk);
  long long ntiles = plan.rows ? (n - head) / plan.rows : 0;
  if (ntiles == 0) {
    plan = gs_plan(k, nslots, false);
    head = 0;
  }
  const long long extra_groups = (n - ntiles * plan.rows + 31) / 32;
  const long long want = ntiles > 0 ? ntiles : (extra_groups + kGsWarps - 1) / kGsWarps;
  GsArgs a;
  a.cols = pack(col_ptrs, k);
  a.slots = static_cast<const long long*>(slots);
  a.valid = static_cast<const unsigned char*>(valid);
  a.out = static_cast<unsigned long long*>(out);
  a.n = n;
  a.head = head;
  a.ntiles = ntiles;
  a.k = k;
  a.nslots = nslots;
  a.rows = plan.rows;
  a.stages = plan.stages;
  // per (ring or not, k, nslots): occupancy, read once
  static int most[2][kMaxCols + 1][kMaxSlots + 1] = {};
  int& cap = most[plan.rows ? 1 : 0][k][nslots];
  switch (gs_bucket(k)) {
    case 4: return launch_gs<4>(a, plan.smem, want, cap, (cudaStream_t)stream);
    case 8: return launch_gs<8>(a, plan.smem, want, cap, (cudaStream_t)stream);
    default: return launch_gs<16>(a, plan.smem, want, cap, (cudaStream_t)stream);
  }
}

}  // extern "C"
