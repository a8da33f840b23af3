// K2: additive ADC scan plus an exact (dist, id)-lexicographic top-k.
//
// Replaces local_search_quantization_tpu/ops/select_pallas.py:
// _select_kernel_grouped (with its distance helpers _dist_tile and
// _onehot_tile), launched there through fused_scan_topk / scan_topk_warm.
// Same contract: dist[q, i] = sum_j lut[q, j, Bt[j, i]] + extra[i], summed in
// j order then extra; the k smallest in (dist, id) order; +inf rows are
// never selected, and empty slots are (+inf, -1).
//
// The staged path (the wrapper scan_topk in ops/select_kernels.py runs it):
// 1. pre-scan, outside this file: K3 over every 16th row gives each query a
//    threshold t0 (the sample's rank-th distance, a 6-sigma upper bound on
//    the k-th) and an append capacity cap (2688 at k=1000);
// 2. k2_filter<CodeT, G>: grid (row segments) x (groups of G queries). A
//    block holds its G queries' LUTs in shared memory as
//    s_lut[(j*h + c)*G + q] (G*m*h*4 bytes: 114,688 at G=16, m=7, h=256) and
//    stages each tile of kTile rows of codes and extra with 16-byte loads
//    (the staging, the code loads and the lookup are scan_common.cuh's, which
//    K3 shares).
//    Lane l serves the query pair 2p, 2p + 1 with p = l % (G/2), and row
//    slot l / (G/2), four consecutive rows a slot: a warp scores 64/G rows
//    of G queries at once, each code is a broadcast, and one 8-byte load
//    fetches two queries' entries (half the load and address instructions
//    of one query a lane). An entry's G words sit in banks
//    ((j*h + c)*G + q) mod 32 = (c mod 32/G)*G + q for even h: the lanes of
//    one row never collide, and the rows served together collide only when
//    their codes agree mod 32/G (expected 1.5 ways at G=16), where one
//    query a lane (the dense path's scan) hits 32 random banks. A row with
//    dist < t0[q] appends the 64-bit key mono(dist) << 32 | id to cand[q]
//    through one warp-aggregated atomicAdd a query on count[q]; it writes
//    while its slot is below cap and always counts. Every segment appends
//    to the same per-query buffer,
//    so segments need no merge, and the grid has >= 2 blocks an SM at any nq.
//    A block has 1024 threads: at one block an SM (137 KB of shared memory
//    at G=16, uint8 codes), 32 warps hide the lookups' latency better than
//    8 or 16 did on the H100, and four queries a lane did no better than two.
// 3. k2_select: one block per query sorts its min(count, cap) keys, padded
//    with all-ones keys to a power of two (<= kSelectMax = 16384 keys, 128 KB
//    of shared memory), by a bitonic network, and writes the first k as
//    (dist, id). Ids are unique, so key order is (dist, id) order. It also
//    writes the certificate ok[q] = k <= count[q] <= cap: every appended row
//    lies below t0 and every other row does not, so the k returned are the
//    exact top-k.
// 4. dense path, for the queries that fail the certificate and the shapes
//    the staged path does not take (n < 65,536; cap > kSelectMax; LUTs too
//    large for G = 4): adc_scan writes a [nq_block, n] distance scratch, and
//    a radix select on the key mono(dist) << 32 | id takes each query's k
//    smallest keys. Ids are distinct, so the k-th key K* is unique and
//    exactly k rows have key <= K*. The grid is (row segments) x queries:
//    the wrapper cuts each row into segments of whole tiles, enough for
//    >= 2 blocks an SM at any nq (one segment a query at nq >= 2 * SMs), so
//    a few reruns over many rows fill the card as a full batch does.
//    - dense_hist, once a digit of mono(dist) (bits 31-21, 20-10, 9-0): each
//      block counts its segment's rows that match the bits chosen so far in
//      a shared-memory histogram (plain shared atomics), adds it into the
//      query's histogram in device memory, one atomic a non-empty bin, and
//      the block that finishes the query last (a ticket) picks the bin
//      where the count reaches the rows still needed. The digit never
//      crosses to the host. A query whose bin holds exactly the rows still
//      needed is done: its later passes return at once.
//    - Where more rows tie at the k-th distance T than are still needed,
//      the id half of the key decides. Its high digit is the segment: the
//      last pass keeps each segment's histogram, and its pick finds the
//      segment holding K*; the segments below it give all their ties, those
//      above none. Its low digits are the tiles of that segment:
//      dense_tie_count counts each tile's ties, and dense_tie_take appends
//      the ties of the tiles below K* and, in id order, the lowest of the
//      tile holding it (grids of (tiles a segment) x queries). A query with
//      no ties beyond the rows needed pays no id pass.
//    - dense_collect appends every row below the chosen bin, and the bin's
//      rows where the bin (or the segment's share of it) is taken whole,
//      with one warp-aggregated atomic a warp on the query's slot count. No
//      barrier.
//    Fewer than k finite rows: every finite row, then (+inf, -1) slots. The
//    wrapper allocates the scratch and the select's workspace, launches at
//    most 256 queries at once and sorts the [nq, k] result by (dist, id).
//
// Bounds on this card, for 1000 queries x 1M rows at m=7, k=1000: 7e9 LUT
// lookups and 8e9 f32 adds and compares (0.12 ms at 67 TFLOP/s); ~27 MB of
// inputs and outputs (8 us at 3.35 TB/s). Shared memory serves one 32-lane
// lookup an SM a clock, so the lookups take >= 0.84 ms at 1.98 GHz: the
// filter's bank layout aims at that. The select sorts ~3k keys a query.
// The dense path moves 4 * nq * n bytes of scratch five times (written
// once, read by three digit passes and the collect; the tie kernels read one
// segment a query more, twice, where ties need them) beside the codes and
// extra it reads once a scan block's 4 queries: at 21 queries x 10M rows,
// 4.2 GB of scratch and 0.48 GB of codes and extra, 1.45 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "scan_common.cuh"

namespace {

using lsq_scan::kFull;
using lsq_scan::mono;
using lsq_scan::unmono;

constexpr uint32_t kInfKey = 0xff800000u;  // mono(+inf)
constexpr int kSmemLimit = 227 * 1024;

// --- dense path: scan into a distance scratch, then a radix select over segments ---
constexpr int kQB = 4;              // queries per scan block
constexpr int kScanThreads = 256;
constexpr int kRowsPerBlock = 16384;  // rows per scan block
constexpr int kDThreads = 512;        // a select block
constexpr int kDWarps = kDThreads / 32;
constexpr int kDRows = 8;             // rows a thread loads at once
constexpr int kDTile = kDThreads * kDRows;  // a segment is a whole number of tiles
constexpr int kDBins = 2048;          // an 11-bit digit's bins
constexpr int kLastBins = 1024;       // the last digit's (10 bits)
constexpr int kPasses = 3;            // digits of mono(dist): bits 31-21, 20-10, 9-0
constexpr uint32_t kInfDigit = kInfKey >> 21;  // mono(+inf)'s first digit
constexpr int kDone = 1;  // the chosen bin holds just the rows still needed
constexpr int kInf = 2;   // fewer than k finite rows

// --- staged path ---
constexpr int kFThreads = 1024;    // filter block: 32 warps, one block an SM at G=16
constexpr int kTile = 2048;        // rows a filter block stages at once
constexpr int kRowsPerLane = 4;    // consecutive rows a lane scores per step
constexpr int kSelectThreads = 1024;
constexpr int kSelectMax = 16384;  // most keys a select block sorts

template <typename CodeT>
__global__ void __launch_bounds__(kScanThreads)
adc_scan(const float* __restrict__ luts, const CodeT* __restrict__ bt,
         const float* __restrict__ extra, int nq, int m, int h, int n,
         float* __restrict__ dist) {
  extern __shared__ float s_lut[];
  const int mh = m * h;
  const int q0 = blockIdx.y * kQB;
  for (int e = threadIdx.x; e < kQB * mh; e += kScanThreads) {
    const int q = q0 + e / mh;
    s_lut[e] = q < nq ? luts[static_cast<size_t>(q) * mh + e % mh] : 0.0f;
  }
  __syncthreads();
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(n, r0 + kRowsPerBlock);
  for (int i = r0 + threadIdx.x; i < r1; i += kScanThreads) {
    float acc[kQB];
    int c = static_cast<int>(bt[i]);
#pragma unroll
    for (int q = 0; q < kQB; ++q) acc[q] = s_lut[q * mh + c];
    for (int j = 1; j < m; ++j) {
      c = static_cast<int>(bt[static_cast<size_t>(j) * n + i]);
#pragma unroll
      for (int q = 0; q < kQB; ++q) acc[q] += s_lut[q * mh + j * h + c];
    }
    const float e = extra[i];
#pragma unroll
    for (int q = 0; q < kQB; ++q)
      if (q0 + q < nq) dist[static_cast<size_t>(q0 + q) * n + i] = acc[q] + e;
  }
}

__device__ __forceinline__ int digit_shift(int pass) { return pass == 0 ? 21 : pass == 1 ? 10 : 0; }
__device__ __forceinline__ int digit_bins(int pass) {
  return pass == kPasses - 1 ? kLastBins : kDBins;
}

// One query's select in the wrapper's workspace, zeroed before the passes.
struct DenseState {
  uint32_t prefix;  // the key bits chosen so far,
  uint32_t mask;    // and which bits they are
  int less;         // rows whose key lies below the chosen bin
  int flags;        // kDone, kInf
  unsigned ticket;  // blocks of the current pass that have added their counts
  int pos;          // output slots written
  int tseg;         // ties at T beyond the rows needed: the segment holding K*,
  int tneed;        // and its lowest-id ties to take (0: all of them)
};

// Exclusive prefix sum of x over the block's threads in order. Every thread
// calls it; s_warp holds kDWarps words.
__device__ __forceinline__ unsigned block_exclusive(unsigned x, unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  __syncthreads();  // s_warp's last readers are done
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  return before + inc - x;
}

// Append (v, id) to the query's output where `take`: one atomicAdd a warp on
// the slot count. Every lane of the warp calls it.
__device__ __forceinline__ void append_row(bool take, float v, long long id, int lane,
                                           int* pos, float* od, int* oi) {
  const unsigned bal = __ballot_sync(kFull, take);
  if (bal == 0u) return;  // warp-uniform
  const int leader = __ffs(bal) - 1;
  int p = 0;
  if (lane == leader) p = atomicAdd(pos, __popc(bal));
  p = __shfl_sync(kFull, p, leader) + __popc(bal & ((1u << lane) - 1u));
  if (take) {
    od[p] = v;
    oi[p] = static_cast<int>(id);
  }
}

// kDRows rows of one thread, kDThreads apart from `base`; past r1 reads +inf.
__device__ __forceinline__ void load_rows(const float* row, long long base, long long r1,
                                          int stride, float (&v)[kDRows]) {
#pragma unroll
  for (int u = 0; u < kDRows; ++u) {
    const long long i = base + static_cast<long long>(u) * stride;
    v[u] = i < r1 ? row[i] : INFINITY;
  }
}

// One digit pass: grid (segments, queries). Counts the digit of the rows of
// the segment whose key matches the bits chosen so far; the query's last
// block picks the bin holding the k-th key.
__global__ void __launch_bounds__(kDThreads, 3)
dense_hist(const float* __restrict__ dist, int n, int k, int rows_per_block, int pass,
           DenseState* __restrict__ state, unsigned* __restrict__ qhist,
           unsigned* __restrict__ seghist) {
  __shared__ unsigned s_hist[kDBins];
  __shared__ unsigned s_warp[kDWarps];
  __shared__ unsigned s_digit, s_below, s_count, s_finite, s_tneed;
  __shared__ int s_last, s_tseg;
  const int tid = threadIdx.x, q = blockIdx.y, seg = blockIdx.x, segs = gridDim.x;
  DenseState* st = state + q;
  if (st->flags & kDone) return;  // block-uniform
  const uint32_t prefix = st->prefix, mask = st->mask;
  const int shift = digit_shift(pass), bins = digit_bins(pass);
  for (int b = tid; b < bins; b += kDThreads) s_hist[b] = 0u;
  __syncthreads();
  const float* row = dist + static_cast<size_t>(q) * n;
  const long long r0 = static_cast<long long>(seg) * rows_per_block;
  const long long r1 = min(static_cast<long long>(n), r0 + rows_per_block);
  for (long long base = r0 + tid; base < r1; base += kDTile) {
    float v[kDRows];
    load_rows(row, base, r1, kDThreads, v);
#pragma unroll
    for (int u = 0; u < kDRows; ++u) {
      const uint32_t key = mono(v[u]);
      if (base + u * kDThreads < r1 && (key & mask) == prefix)
        atomicAdd(&s_hist[(key >> shift) & (bins - 1)], 1u);
    }
  }
  __syncthreads();
  unsigned* qh = qhist + static_cast<size_t>(q) * kDBins;
  unsigned* sh = seghist + (static_cast<size_t>(q) * segs + seg) * kLastBins;
  for (int b = tid; b < bins; b += kDThreads) {
    const unsigned c = s_hist[b];
    if (c) atomicAdd(qh + b, c);
    if (pass == kPasses - 1) sh[b] = c;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&st->ticket, 1u) == static_cast<unsigned>(segs - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last block: read (and clear, for the next pass) the query's counts,
  // a run of `per` bins a thread, and find the bin where the count of rows
  // below it reaches the rows still needed.
  const int per = bins / kDThreads;
  unsigned c[kDBins / kDThreads];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < kDBins / kDThreads; ++j) {
    c[j] = j < per ? atomicExch(qh + tid * per + j, 0u) : 0u;
    sum += c[j];
  }
  const unsigned excl = block_exclusive(sum, s_warp);
  const unsigned need = static_cast<unsigned>(k - st->less);
  if (pass == 0 && tid == static_cast<int>(kInfDigit) / per) {  // rows below +inf
    unsigned f = excl;
#pragma unroll
    for (int j = 0; j < kDBins / kDThreads; ++j)
      if (tid * per + j < static_cast<int>(kInfDigit)) f += c[j];
    s_finite = f;
  }
  if (excl < need && need <= excl + sum) {  // one thread
    unsigned cum = excl, cnt = 0;
    int d = 0;
#pragma unroll
    for (int j = 0; j < kDBins / kDThreads; ++j) {
      if (j < per && cum < need) {
        d = j;
        cnt = c[j];
        if (cum + cnt >= need) break;
        cum += cnt;
      }
    }
    s_digit = static_cast<unsigned>(tid * per + d);
    s_below = cum;
    s_count = cnt;
  }
  __syncthreads();
  if (pass == kPasses - 1 && s_count != need - s_below) {  // block-uniform
    // More rows tie at T than are still needed: find the segment where the
    // count of ties reaches them (every block's counts are in seghist).
    const unsigned left = need - s_below;
    const unsigned* sh = seghist + static_cast<size_t>(q) * segs * kLastBins + s_digit;
    unsigned run = 0;  // ties in the segments of earlier rounds
    for (int s0 = 0; s0 < segs; s0 += kDThreads) {  // block-uniform
      const int s = s0 + tid;
      const unsigned c = s < segs ? __ldcg(sh + static_cast<size_t>(s) * kLastBins) : 0u;
      const unsigned before = run + block_exclusive(c, s_warp);
      if (before < left && left <= before + c) {  // one thread
        s_tseg = s;
        s_tneed = left - before == c ? 0u : left - before;
      }
      for (int w = 0; w < kDWarps; ++w) run += s_warp[w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (pass == 0 && s_digit >= kInfDigit) {
      st->less = static_cast<int>(s_finite);
      st->flags = kDone | kInf;
    } else {
      st->less += static_cast<int>(s_below);
      st->prefix = prefix | (s_digit << shift);
      st->mask = mask | (static_cast<uint32_t>(bins - 1) << shift);
      if (s_count == need - s_below) {
        st->flags = kDone;
      } else if (pass == kPasses - 1) {
        st->tseg = s_tseg;
        st->tneed = static_cast<int>(s_tneed);
      }
    }
    st->ticket = 0u;
  }
}

// Append every row of the segment whose key lies below K*: grid (segments,
// queries). Ties at T beyond the rows needed go here from the segments below
// the one holding K*, and from that one where all of its ties are taken; the
// rest of that segment's are dense_tie_take's.
__global__ void __launch_bounds__(kDThreads, 3)
dense_collect(const float* __restrict__ dist, int n, int k, int rows_per_block,
              DenseState* __restrict__ state, float* __restrict__ out_d,
              int* __restrict__ out_i) {
  const int tid = threadIdx.x, lane = tid & 31, q = blockIdx.y, seg = blockIdx.x;
  DenseState* st = state + q;
  const int flags = st->flags, less = st->less;
  uint32_t prefix = st->prefix, mask = st->mask;
  float* od = out_d + static_cast<size_t>(q) * k;
  int* oi = out_i + static_cast<size_t>(q) * k;
  bool take_bin = true;
  if (flags & kInf) {  // every finite row, then (+inf, -1)
    prefix = kInfKey;
    mask = 0xffffffffu;
    take_bin = false;
    if (seg == 0)
      for (int p = less + tid; p < k; p += kDThreads) {
        od[p] = INFINITY;
        oi[p] = -1;
      }
  } else if (!(flags & kDone)) {  // more ties at T than needed
    take_bin = seg < st->tseg || (seg == st->tseg && st->tneed == 0);
  }
  const float* row = dist + static_cast<size_t>(q) * n;
  const long long r0 = static_cast<long long>(seg) * rows_per_block;
  const long long r1 = min(static_cast<long long>(n), r0 + rows_per_block);
  for (long long base = r0 + tid; base - tid < r1; base += kDTile) {  // block-uniform
    float v[kDRows];
    load_rows(row, base, r1, kDThreads, v);
#pragma unroll
    for (int u = 0; u < kDRows; ++u) {
      const long long i = base + u * kDThreads;
      const uint32_t km = mono(v[u]) & mask;
      append_row(i < r1 && (km < prefix || (take_bin && km == prefix)), v[u], i, lane,
                 &st->pos, od, oi);
    }
  }
}

// Whether a query has a segment whose lowest-id ties at T are to be picked,
// and the rows [r0, r1) of its tile `t` (empty past the segment's end).
__device__ __forceinline__ bool tie_tile(const DenseState* st, int n, int rows_per_block, int t,
                                         long long& r0, long long& r1) {
  if (st->flags || st->tneed == 0) return false;
  const long long s0 = static_cast<long long>(st->tseg) * rows_per_block;
  const long long s1 = min(static_cast<long long>(n), s0 + rows_per_block);
  r0 = s0 + static_cast<long long>(t) * kDTile;
  r1 = min(s1, r0 + kDTile);
  return true;
}

// The ties at T in each tile of the segment holding K*: grid (tiles a
// segment, queries), one tile a block.
__global__ void __launch_bounds__(kDThreads)
dense_tie_count(const float* __restrict__ dist, int n, int rows_per_block,
                const DenseState* __restrict__ state, unsigned* __restrict__ tcount) {
  __shared__ unsigned s_cnt;
  const int tid = threadIdx.x, q = blockIdx.y, t = blockIdx.x;
  const DenseState* st = state + q;
  long long r0, r1;
  if (!tie_tile(st, n, rows_per_block, t, r0, r1)) return;  // block-uniform
  const uint32_t T = st->prefix;
  if (tid == 0) s_cnt = 0u;
  __syncthreads();
  float v[kDRows];
  load_rows(dist + static_cast<size_t>(q) * n, r0 + tid, r1, kDThreads, v);
  unsigned c = 0;
#pragma unroll
  for (int u = 0; u < kDRows; ++u) c += r0 + tid + u * kDThreads < r1 && mono(v[u]) == T;
  c = __reduce_add_sync(kFull, c);
  if ((tid & 31) == 0 && c) atomicAdd(&s_cnt, c);
  __syncthreads();
  if (tid == 0) tcount[static_cast<size_t>(q) * gridDim.x + t] = s_cnt;
}

// Append the segment's lowest-id ties at T, as many as its segment was left
// to give: grid (tiles a segment, queries). A tile wholly below K* appends
// all of its ties; the tile holding K* its lowest ids, in id order.
__global__ void __launch_bounds__(kDThreads)
dense_tie_take(const float* __restrict__ dist, int n, int k, int rows_per_block,
               DenseState* __restrict__ state, const unsigned* __restrict__ tcount,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ unsigned s_warp[kDWarps];
  __shared__ unsigned s_before;
  const int tid = threadIdx.x, lane = tid & 31, q = blockIdx.y, t = blockIdx.x;
  DenseState* st = state + q;
  long long r0, r1;
  if (!tie_tile(st, n, rows_per_block, t, r0, r1)) return;  // block-uniform
  const uint32_t T = st->prefix;
  const unsigned tneed = static_cast<unsigned>(st->tneed);
  const unsigned* tc = tcount + static_cast<size_t>(q) * gridDim.x;
  if (tid == 0) s_before = 0u;
  __syncthreads();
  unsigned b = 0;
  for (int s = tid; s < t; s += kDThreads) b += tc[s];
  b = __reduce_add_sync(kFull, b);
  if (lane == 0 && b) atomicAdd(&s_before, b);
  __syncthreads();
  const unsigned before = s_before, cnt = tc[t];
  if (before >= tneed || cnt == 0u) return;  // block-uniform
  const unsigned lim = min(cnt, tneed - before);
  float v[kDRows];
  load_rows(dist + static_cast<size_t>(q) * n, r0 + tid, r1, kDThreads, v);
  float* od = out_d + static_cast<size_t>(q) * k;
  int* oi = out_i + static_cast<size_t>(q) * k;
  unsigned taken = 0;  // ties of the tile in the rows before step u
#pragma unroll
  for (int u = 0; u < kDRows; ++u) {  // rows r0 + u * kDThreads + tid: id order
    const long long i = r0 + tid + u * kDThreads;
    const bool tie = i < r1 && mono(v[u]) == T;
    bool take = tie;
    if (lim < cnt) {  // block-uniform: the tile holding K*
      const unsigned bal = __ballot_sync(kFull, tie);
      const unsigned off = __shfl_sync(kFull, block_exclusive(lane == 0 ? __popc(bal) : 0u,
                                                              s_warp), 0);
      take = tie && taken + off + __popc(bal & ((1u << lane) - 1u)) < lim;
      for (int w = 0; w < kDWarps; ++w) taken += s_warp[w];
    }
    append_row(take, v[u], i, lane, &st->pos, od, oi);
  }
}

template <typename CodeT>
int launch_dense(const void* luts, const void* bt, const void* extra, int nq, int m, int h,
                 int n, int k, int rows_per_block, void* dist, void* work, void* out_d,
                 void* out_i, cudaStream_t stream) {
  const int smem = kQB * m * h * 4;
  cudaError_t err = cudaFuncSetAttribute(adc_scan<CodeT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, (nq + kQB - 1) / kQB);
  adc_scan<CodeT><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const CodeT*>(bt),
      static_cast<const float*>(extra), nq, m, h, n, static_cast<float*>(dist));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int segs = static_cast<int>((static_cast<long long>(n) + rows_per_block - 1) /
                                    rows_per_block);
  DenseState* state = static_cast<DenseState*>(work);
  unsigned* qhist = reinterpret_cast<unsigned*>(state + nq);
  unsigned* seghist = qhist + static_cast<size_t>(nq) * kDBins;
  err = cudaMemsetAsync(work, 0, static_cast<size_t>(nq) * (sizeof(DenseState) + kDBins * 4),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* d = static_cast<const float*>(dist);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  const dim3 sgrid(segs, nq);
  for (int pass = 0; pass < kPasses; ++pass) {
    dense_hist<<<sgrid, kDThreads, 0, stream>>>(d, n, k, rows_per_block, pass, state, qhist,
                                                seghist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dense_collect<<<sgrid, kDThreads, 0, stream>>>(d, n, k, rows_per_block, state, od, oi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tgrid(rows_per_block / kDTile, nq);
  unsigned* tcount = seghist + static_cast<size_t>(nq) * segs * kLastBins;
  dense_tie_count<<<tgrid, kDThreads, 0, stream>>>(d, n, rows_per_block, state, tcount);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_tie_take<<<tgrid, kDThreads, 0, stream>>>(d, n, k, rows_per_block, state, tcount, od,
                                                  oi);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The staged path: k2_filter, then k2_select.

inline size_t filter_smem_bytes(int m, int h, int code_bytes, int g) {
  return static_cast<size_t>(g) * m * h * 4 + static_cast<size_t>(kTile) * (4 + m * code_bytes);
}

// The largest of 16, 8, 4 queries a filter block holds, or 0.
inline int filter_group(int m, int h, int code_bytes) {
  for (int g = 16; g >= 4; g >>= 1)
    if (filter_smem_bytes(m, h, code_bytes, g) <= static_cast<size_t>(kSmemLimit)) return g;
  return 0;
}

// Append row `id` to query gq's buffer when d < thr: one atomicAdd per query
// and warp, by the leader of the lanes `mask` that serve that query.
__device__ __forceinline__ void append(float d, float thr, int gq, unsigned mask, int lane,
                                       uint32_t id, int cap, int* __restrict__ count,
                                       unsigned long long* __restrict__ my_cand) {
  const bool take = d < thr;
  const unsigned bal = __ballot_sync(kFull, take);
  if (bal == 0u) return;  // warp-uniform
  const unsigned peers = bal & mask;
  const int leader = peers ? __ffs(peers) - 1 : lane;
  int pos = 0;
  if (take && lane == leader) pos = atomicAdd(count + gq, __popc(peers));
  pos = __shfl_sync(kFull, pos, leader) + __popc(peers & ((1u << lane) - 1u));
  if (take && pos < cap)
    my_cand[pos] = (static_cast<unsigned long long>(mono(d)) << 32) | id;
}

template <typename CodeT, int G>
__global__ void __launch_bounds__(kFThreads)
k2_filter(const float* __restrict__ luts, const CodeT* __restrict__ bt,
          const float* __restrict__ extra, const float* __restrict__ t0, int nq, int m,
          int h, int n, int rows_per_block, int cap, int vec,
          unsigned long long* __restrict__ cand, int* __restrict__ count) {
  constexpr int kPairs = G / 2;                        // lanes a row, two queries each
  constexpr int kSlots = 32 / kPairs;                  // rows a warp scores at once
  constexpr int kStep = kFThreads / kPairs * kRowsPerLane;  // rows a block scores a step
  static_assert(kTile % kStep == 0, "a tile is a whole number of steps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int mh = m * h;
  float* s_lut = reinterpret_cast<float*>(smem);            // [m*h][G]
  float* s_extra = s_lut + static_cast<size_t>(G) * mh;     // [kTile]
  CodeT* s_codes = reinterpret_cast<CodeT*>(s_extra + kTile);  // [m][kTile]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * G;
  lsq_scan::load_luts<G, kFThreads>(s_lut, luts, q0, nq, mh);
  const int p = lane % kPairs, slot = lane / kPairs;
  const int ga = q0 + 2 * p, gb = ga + 1;
  const float thr_a = ga < nq ? t0[ga] : -INFINITY;  // a padding query never appends
  const float thr_b = gb < nq ? t0[gb] : -INFINITY;
  unsigned pmask = 0u;  // the lanes of query pair p in this warp
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pmask |= 1u << (p + s * kPairs);
  const float* lq = s_lut + 2 * p;
  const int r_lane = (warp * kSlots + slot) * kRowsPerLane;
  unsigned long long* cand_a = cand + static_cast<size_t>(ga < nq ? ga : 0) * cap;
  unsigned long long* cand_b = cand + static_cast<size_t>(gb < nq ? gb : 0) * cap;
  const int seg0 = blockIdx.x * rows_per_block;
  const int seg1 = min(n, seg0 + rows_per_block);
  for (int base = seg0; base < seg1; base += kTile) {
    const int rows = min(kTile, seg1 - base);
    __syncthreads();  // the previous tile is consumed
    lsq_scan::stage_tile<CodeT, kTile, kFThreads, false>(s_codes, s_extra, bt, extra, m, n,
                                                         base, rows, vec != 0);
    __syncthreads();
    for (int step = 0; step < rows; step += kStep) {  // block-uniform
      const int r = step + r_lane;
      float da[kRowsPerLane], db[kRowsPerLane];
      lsq_scan::score_rows<CodeT, G, kRowsPerLane, kTile>(lq, s_codes, s_extra, r, m, h, da,
                                                          db);
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        const uint32_t id = static_cast<uint32_t>(base + r + u);
        append(da[u], thr_a, ga, pmask, lane, id, cap, count, cand_a);
        append(db[u], thr_b, gb, pmask, lane, id, cap, count, cand_b);
      }
    }
  }
}

template <typename CodeT, int G>
int launch_filter(const void* luts, const void* bt, const void* extra, const void* t0, int nq,
                  int m, int h, int n, int rows_per_block, int cap, int vec, void* cand,
                  void* count, cudaStream_t stream) {
  const size_t smem = filter_smem_bytes(m, h, sizeof(CodeT), G);
  cudaError_t err = cudaFuncSetAttribute(k2_filter<CodeT, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, (nq + G - 1) / G);
  k2_filter<CodeT, G><<<grid, kFThreads, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const CodeT*>(bt),
      static_cast<const float*>(extra), static_cast<const float*>(t0), nq, m, h, n,
      rows_per_block, cap, vec, static_cast<unsigned long long*>(cand),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT>
int dispatch_filter(const void* luts, const void* bt, const void* extra, const void* t0,
                    int nq, int m, int h, int n, int rows_per_block, int cap, int vec,
                    void* cand, void* count, cudaStream_t s) {
  switch (filter_group(m, h, sizeof(CodeT))) {
    case 16:
      return launch_filter<CodeT, 16>(luts, bt, extra, t0, nq, m, h, n, rows_per_block, cap,
                                      vec, cand, count, s);
    case 8:
      return launch_filter<CodeT, 8>(luts, bt, extra, t0, nq, m, h, n, rows_per_block, cap,
                                     vec, cand, count, s);
    case 4:
      return launch_filter<CodeT, 4>(luts, bt, extra, t0, nq, m, h, n, rows_per_block, cap,
                                     vec, cand, count, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline int pow2_at_least(int x) {
  int p = 2;
  while (p < x) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(kSelectThreads)
k2_select(const unsigned long long* __restrict__ cand, const int* __restrict__ count,
          int cap, int k, float* __restrict__ out_d, int* __restrict__ out_i,
          unsigned char* __restrict__ ok) {
  extern __shared__ unsigned long long s_keys[];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int c = count[q];
  const int filled = min(c, cap);
  int P = 2;  // this query's sort width
  while (P < filled) P <<= 1;
  const unsigned long long* src = cand + static_cast<size_t>(q) * cap;
  for (int i = tid; i < P; i += kSelectThreads) s_keys[i] = i < filled ? src[i] : ~0ull;
  __syncthreads();
  // Bitonic sort, ascending: pairs (lo, lo + stride) with bit `stride` of lo clear.
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kSelectThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const unsigned long long a = s_keys[lo], b = s_keys[hi];
        if ((a > b) == asc) {
          s_keys[lo] = b;
          s_keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  float* od = out_d + static_cast<size_t>(q) * k;
  int* oi = out_i + static_cast<size_t>(q) * k;
  for (int p = tid; p < k; p += kSelectThreads) {
    if (p < filled) {
      const unsigned long long key = s_keys[p];
      od[p] = unmono(static_cast<uint32_t>(key >> 32));
      oi[p] = static_cast<int>(static_cast<uint32_t>(key));
    } else {
      od[p] = INFINITY;
      oi[p] = -1;
    }
  }
  if (tid == 0) ok[q] = c >= k && c <= cap;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one dense scan block.
int lsq_scan_smem_bytes(int m, int h) { return kQB * m * h * 4; }

// The staged path's shape rules: queries a filter block holds (0: none
// fits), its dynamic shared memory, its tile, and the select's largest cap.
int lsq_k2_group(int m, int h, int code_bytes) { return filter_group(m, h, code_bytes); }
int lsq_k2_filter_smem_bytes(int m, int h, int code_bytes, int g) {
  return static_cast<int>(filter_smem_bytes(m, h, code_bytes, g));
}
int lsq_k2_tile() { return kTile; }
int lsq_k2_select_max() { return kSelectMax; }

// The dense path's tile (a segment is a whole number of them) and the bytes
// of its select's workspace for nq queries over segments of rows_per_block
// rows: a state and a histogram a query, a last-digit histogram a (query,
// segment) and a tie count a (query, tile of a segment).
int lsq_dense_tile() { return kDTile; }
long long lsq_dense_work_bytes(int nq, int segments, int rows_per_block) {
  return static_cast<long long>(nq) *
         (sizeof(DenseState) + kDBins * 4 + static_cast<long long>(segments) * kLastBins * 4 +
          rows_per_block / kDTile * 4);
}

// Dense path: unsorted exact top-k candidates of nq queries; `dist` is
// [nq, n] f32 scratch and `work` lsq_dense_work_bytes(nq, segments,
// rows_per_block) bytes,
// segments = ceil(n / rows_per_block), rows_per_block a multiple of
// lsq_dense_tile(). code_bytes is 1 (uint8 codes) or 4 (int32 codes).
// Needs 1 <= k <= n.
int lsq_scan_topk(const void* luts, const void* bt, int code_bytes, const void* extra, int nq,
                  int m, int h, int n, int k, int rows_per_block, void* dist, void* work,
                  void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > n || rows_per_block < kDTile || rows_per_block % kDTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return launch_dense<uint8_t>(luts, bt, extra, nq, m, h, n, k, rows_per_block, dist, work,
                                 out_d, out_i, s);
  if (code_bytes == 4)
    return launch_dense<int32_t>(luts, bt, extra, nq, m, h, n, k, rows_per_block, dist, work,
                                 out_d, out_i, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Append, per query q, the key mono(dist) << 32 | id of every row with
// dist < t0[q] to cand[q, :cap] (uint64 [nq, cap]) in no fixed order;
// count[q] (int32 [nq], zeroed by the caller) counts every such row, also
// those past cap. rows_per_block is a multiple of lsq_k2_tile(); vec = 1
// allows 16-byte staging loads (aligned pointers, n * code_bytes % 16 == 0).
int lsq_k2_filter(const void* luts, const void* bt, int code_bytes, const void* extra,
                  const void* t0, int nq, int m, int h, int n, int rows_per_block, int cap,
                  int vec, void* cand, void* count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap < 1 || rows_per_block < kTile || rows_per_block % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return dispatch_filter<uint8_t>(luts, bt, extra, t0, nq, m, h, n, rows_per_block, cap,
                                    vec, cand, count, s);
  if (code_bytes == 4)
    return dispatch_filter<int32_t>(luts, bt, extra, t0, nq, m, h, n, rows_per_block, cap,
                                    vec, cand, count, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Sort each query's min(count, cap) keys and write the first k as (dist, id)
// [nq, k], (+inf, -1) past them; ok[q] = k <= count[q] <= cap. Needs
// 1 <= cap <= lsq_k2_select_max().
int lsq_k2_select(const void* cand, const void* count, int nq, int cap, int k, void* out_d,
                  void* out_i, void* ok, void* stream) {
  if (cap < 1 || cap > kSelectMax || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pow2_at_least(cap) * 8;
  cudaError_t err = cudaFuncSetAttribute(k2_select,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2_select<<<nq, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(cand), static_cast<const int*>(count), cap, k,
      static_cast<float*>(out_d), static_cast<int*>(out_i), static_cast<unsigned char*>(ok));
  return static_cast<int>(cudaGetLastError());
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
