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
//    large for G = 4): adc_scan writes a [nq_block, n] distance scratch and
//    radix_select takes the exact k-th by four 8-bit radix passes, then
//    collects the rows below it and the lowest-id ties, so the tie rule is
//    structural. The wrapper launches it for at most 256 queries at once.
//
// Bounds on this card, for 1000 queries x 1M rows at m=7, k=1000: 7e9 LUT
// lookups and 8e9 f32 adds and compares (0.12 ms at 67 TFLOP/s); ~27 MB of
// inputs and outputs (8 us at 3.35 TB/s). Shared memory serves one 32-lane
// lookup an SM a clock, so the lookups take >= 0.84 ms at 1.98 GHz: the
// filter's bank layout aims at that. The select sorts ~3k keys a query.
// The dense path reads and writes its scratch five times a query.
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

// --- dense path: scan into a distance scratch, then radix select ---
constexpr int kQB = 4;              // queries per scan block
constexpr int kScanThreads = 256;
constexpr int kRowsPerBlock = 16384;  // rows per scan block
constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;

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

__global__ void __launch_bounds__(kSelThreads)
radix_select(const float* __restrict__ dist, int n, int k, float* __restrict__ out_d,
             int* __restrict__ out_i) {
  __shared__ unsigned hist[256];
  __shared__ uint32_t s_prefix, s_mask;
  __shared__ int s_need, s_pos, s_tie, s_total;
  __shared__ int s_woff[kSelWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = dist + static_cast<size_t>(blockIdx.x) * n;
  float* od = out_d + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_need = k;
    s_pos = 0;
    s_tie = 0;
  }

  // --- radix select: T = the k-th smallest key, s_need = ties at T to take ---
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kSelThreads) hist[b] = 0;
    __syncthreads();
    const uint32_t prefix = s_prefix, mask = s_mask;
    for (int base = 0; base < n; base += kSelThreads) {
      const int i = base + tid;
      unsigned digit = 256;  // no bin
      if (i < n) {
        const uint32_t key = mono(row[i]);
        if ((key & mask) == prefix) digit = (key >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      unsigned cum = 0;
      const unsigned need = static_cast<unsigned>(s_need);
      int d = 0;
      for (; d < 255; ++d) {
        if (cum + hist[d] >= need) break;
        cum += hist[d];
      }
      s_need = static_cast<int>(need - cum);
      s_prefix = prefix | (static_cast<uint32_t>(d) << shift);
      s_mask = mask | (255u << shift);
    }
    __syncthreads();
  }
  const uint32_t T = s_prefix;
  const bool finite_t = T < kInfKey;
  const uint32_t bound = finite_t ? T : kInfKey;
  const int less = k - s_need;  // rows with key < T when T is finite
  int need = finite_t ? s_need : 0;

  // --- collect: all key < bound (any order), then the first `need` ties in id order ---
  for (int base = 0; base < n; base += kSelThreads) {
    const int i = base + tid;
    uint32_t key = 0xffffffffu;
    float v = 0.0f;
    if (i < n) {
      v = row[i];
      key = mono(v);
    }
    if (key < bound) {
      const int p = atomicAdd(&s_pos, 1);
      od[p] = v;
      oi[p] = i;
    }
    if (need > 0) {  // block-uniform
      const bool tie = key == T;
      const unsigned bal = __ballot_sync(kFull, tie);
      if (lane == 0) s_woff[warp] = __popc(bal);
      __syncthreads();
      if (tid == 0) {
        int run = 0;
        for (int w = 0; w < kSelWarps; ++w) {
          const int c = s_woff[w];
          s_woff[w] = run;
          run += c;
        }
        s_total = run;
      }
      __syncthreads();
      const int pos = s_tie + s_woff[warp] + __popc(bal & ((1u << lane) - 1u));
      if (tie && pos < need) {
        od[less + pos] = v;
        oi[less + pos] = i;
      }
      __syncthreads();
      if (tid == 0) s_tie += s_total;
      __syncthreads();
      if (s_tie >= need) need = 0;
    }
  }
  __syncthreads();
  const int written = finite_t ? k : s_pos;
  for (int p = written + tid; p < k; p += kSelThreads) {
    od[p] = INFINITY;
    oi[p] = -1;
  }
}

template <typename CodeT>
int launch_dense(const void* luts, const void* bt, const void* extra, int nq, int m, int h,
                 int n, int k, void* dist, void* out_d, void* out_i, cudaStream_t stream) {
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
  radix_select<<<nq, kSelThreads, 0, stream>>>(static_cast<const float*>(dist), n, k,
                                                static_cast<float*>(out_d),
                                                static_cast<int*>(out_i));
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

// Dense path: unsorted exact top-k candidates of nq queries; `dist` is
// [nq, n] f32 scratch. code_bytes is 1 (uint8 codes) or 4 (int32 codes).
// Needs 1 <= k <= n.
int lsq_scan_topk(const void* luts, const void* bt, int code_bytes, const void* extra, int nq,
                  int m, int h, int n, int k, void* dist, void* out_d, void* out_i,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch_dense<uint8_t>(luts, bt, extra, nq, m, h, n, k, dist, out_d, out_i, s);
  if (code_bytes == 4)
    return launch_dense<int32_t>(luts, bt, extra, nq, m, h, n, k, dist, out_d, out_i, s);
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
