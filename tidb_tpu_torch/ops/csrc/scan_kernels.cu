// Scan-side reductions for the fused coprocessor fragment, written for
// Hopper (sm_90a). Plain C entry points, loaded with ctypes by
// tidb_tpu_torch/ops/scan_kernels.py; each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// tidb_masked_sums replaces tidb_tpu/ops/pallas_scan.py:masked_sums
// (_masked_sums_impl / _kernel): int64 sums of k columns over the rows
// where mask is set, plus the count of those rows. Memory-bound: it must
// read the n-byte mask and, of each column, the 32-byte sectors that
// hold a row whose mask is set (chip_smoke.py computes the bound from a
// run's data). Design: a grid-stride loop keeps one int64
// accumulator per column per thread in registers; a row whose mask is
// clear reads no column bytes. Each block reduces its threads with warp
// shuffles and shared memory, then adds its k+1 totals into the output
// with one 64-bit atomicAdd each. Integer adds wrap in two's complement,
// so the result is exact and the same in any order: deterministic.
//
// tidb_dense_group_sums replaces tidb_tpu/ops/pallas_scan.py:
// dense_group_sums (_group_sums_impl / _group_kernel): per-slot int64
// sums of k columns plus per-slot counts over a small dense slot domain;
// rows with !valid or a slot outside [0, nslots) are dropped. The TPU
// kernel sums through float32 one-hot matmuls and is exact only while a
// block's partial stays below 2^24; this one is exact in int64 at any
// magnitude. Bound: the n-byte valid mask, the slots' sectors that hold
// a valid row, the k columns' sectors that hold a live row, and the
// output table. Design: each block keeps a [k+1][nslots] int64
// table in shared memory (at most (kMaxCols+1) x kMaxSlots x 8 B = 8.5 KB) that rows add
// into with shared-memory 64-bit atomics; at the end the block adds its
// table into the global output with atomics. With few live groups
// (Q1 has 4) the shared atomics contend on a handful of addresses; that
// is this kernel's likely limit.
//
// tidb_range_filter_sums replaces tidb_tpu/ops/pallas_scan.py:
// range_filter_sums (_range_filter_sums_impl / _filter_kernel), the
// whole TPC-H Q6 hot loop as one program: inclusive [lo, hi] tests on
// npred int64 columns, ANDed with valid, then masked int64 sums of k
// columns plus the count. Memory-bound: it must read the n-byte valid
// mask in full; of predicate column p, the 32-byte sectors that hold a
// row still passing valid and predicates 0..p-1; of the k sum columns,
// the sectors that hold a row that passed all. On Q6's data that is far
// below n + 8*n*npred bytes: the first predicate (shipdate) keeps about
// 15 % of the rows. Design: the
// TPU kernel's 8192-row blocks and 128-lane accumulator tile are not
// kept. One thread per row in a grid-stride loop tests valid[i], then
// the predicates in order, and stops at the first that fails; only a
// row that passes every test reads its k sum columns. The accumulators
// and the reduction are masked_sums': int64 registers, warp shuffles,
// one 64-bit atomicAdd per output, exact and the same in any block
// order. The predicate pointers and the lo/hi bounds travel by value
// in a kernel parameter (PredArgs), the counterpart of the TPU's SMEM
// bounds, so no bounds tensor is copied to the card per launch. An
// empty range (lo > hi) passes no row.
//
// The k column pointers travel by value in a kernel parameter (an array
// of up to kMaxCols device pointers), so evaluated aggregate arguments
// need no torch.stack copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kMaxSlots = 64;   // bounds the shared table: 17 x 64 x 8 B
constexpr int kMaxPreds = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct ColPtrs {
  const int64_t* p[kMaxCols];
};

struct PredArgs {              // 16 x 24 B = 384 B of kernel parameters
  const int64_t* p[kMaxPreds];
  long long lo[kMaxPreds];     // inclusive bounds
  long long hi[kMaxPreds];
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Adds the block's per-thread accumulators into out[0..k] (out[k] the
// count): warp shuffles, then one 64-bit atomicAdd per output.
__device__ __forceinline__ void block_add(const long long (&acc)[kMaxCols], long long cnt,
                                          int k, unsigned long long* __restrict__ out) {
  __shared__ long long part[kWarps][kMaxCols + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    if (j < k) {
      long long v = warp_sum(acc[j]);
      if (lane == 0) part[warp][j] = v;
    }
  }
  long long c = warp_sum(cnt);
  if (lane == 0) part[warp][kMaxCols] = c;
  __syncthreads();
  // thread j < k sums column j across warps; thread kMaxCols the count
  const int t = threadIdx.x;
  if (t < k || t == kMaxCols) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][t];
    if (s != 0) atomicAdd(&out[t < k ? t : k], (unsigned long long)s);
  }
}

__global__ void __launch_bounds__(kThreads)
masked_sums_kernel(ColPtrs cols, int k, const bool* __restrict__ mask, int64_t n,
                   unsigned long long* __restrict__ out) {
  long long acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) acc[j] = 0;
  long long cnt = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    if (mask[i]) {
      ++cnt;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < k) acc[j] += cols.p[j][i];
    }
  }
  block_add(acc, cnt, k, out);
}

__global__ void __launch_bounds__(kThreads)
range_filter_sums_kernel(ColPtrs cols, int k, PredArgs preds, int npred,
                         const bool* __restrict__ valid, int64_t n,
                         unsigned long long* __restrict__ out) {
  long long acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) acc[j] = 0;
  long long cnt = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    bool pass = true;
    // unrolled with static indices, so the parameter arrays stay in the
    // constant bank instead of a local-memory copy
#pragma unroll
    for (int p = 0; p < kMaxPreds; ++p) {
      if (p >= npred) break;
      const long long v = __ldg(reinterpret_cast<const long long*>(preds.p[p]) + i);
      if (v < preds.lo[p] || v > preds.hi[p]) {
        pass = false;
        break;
      }
    }
    if (!pass) continue;
    ++cnt;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < k) acc[j] += cols.p[j][i];
  }
  block_add(acc, cnt, k, out);
}

__global__ void __launch_bounds__(kThreads)
dense_group_sums_kernel(ColPtrs cols, int k, const int64_t* __restrict__ slots,
                        const bool* __restrict__ valid, int64_t n, int nslots,
                        unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long table[];   // [(k+1) * nslots]
  const int tsize = (k + 1) * nslots;
  for (int t = threadIdx.x; t < tsize; t += kThreads) table[t] = 0ull;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    const int64_t s = slots[i];
    if (s < 0 || s >= nslots) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < k) atomicAdd(&table[j * nslots + s], (unsigned long long)cols.p[j][i]);
    atomicAdd(&table[k * nslots + s], 1ull);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tsize; t += kThreads) {
    const unsigned long long v = table[t];
    if (v != 0ull) atomicAdd(&out[t], v);
  }
}

int grid_for(int64_t n, int max_blocks) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < max_blocks ? b : max_blocks);
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
    masked_sums_kernel<<<grid_for(n, 132 * 16), kThreads, 0, (cudaStream_t)stream>>>(
        pack(col_ptrs, k), k, static_cast<const bool*>(mask), (int64_t)n,
        static_cast<unsigned long long*>(out));
  }
  return (int)cudaGetLastError();
}

// pred_ptrs[npred] with inclusive bounds lo[npred], hi[npred] (host
// arrays, copied into the kernel parameters); out: int64[k + 1], zeroed
// by the caller; out[k] is the count. npred = 0 sums every valid row.
int tidb_range_filter_sums(const void* const* col_ptrs, int k, const void* const* pred_ptrs,
                           int npred, const long long* lo, const long long* hi,
                           const void* valid, long long n, void* out, void* stream) {
  if (k < 0 || k > kMaxCols || npred < 0 || npred > kMaxPreds || n < 0)
    return (int)cudaErrorInvalidValue;
  PredArgs preds;
  for (int p = 0; p < kMaxPreds; ++p) {
    const bool used = p < npred;
    preds.p[p] = used ? static_cast<const int64_t*>(pred_ptrs[p]) : nullptr;
    preds.lo[p] = used ? lo[p] : 0;
    preds.hi[p] = used ? hi[p] : -1;
  }
  if (n > 0) {
    range_filter_sums_kernel<<<grid_for(n, 132 * 16), kThreads, 0, (cudaStream_t)stream>>>(
        pack(col_ptrs, k), k, preds, npred, static_cast<const bool*>(valid), (int64_t)n,
        static_cast<unsigned long long*>(out));
  }
  return (int)cudaGetLastError();
}

// out: int64[(k + 1) * nslots], zeroed by the caller; row k holds counts.
int tidb_dense_group_sums(const void* const* col_ptrs, int k, const void* slots,
                          const void* valid, long long n, int nslots, void* out,
                          void* stream) {
  if (k < 0 || k > kMaxCols || n < 0 || nslots < 1 || nslots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned long long) * (size_t)(k + 1) * nslots;
  if (n > 0) {
    dense_group_sums_kernel<<<grid_for(n, 132 * 8), kThreads, smem, (cudaStream_t)stream>>>(
        pack(col_ptrs, k), k, static_cast<const int64_t*>(slots),
        static_cast<const bool*>(valid), (int64_t)n, nslots,
        static_cast<unsigned long long*>(out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
