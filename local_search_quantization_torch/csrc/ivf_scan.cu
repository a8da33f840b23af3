// The IVF probed scan: each query's probed segments of the grouped store
// scored in place, and the exact (dist, id)-lexicographic top-k kept on chip.
//
// Replaces no TPU kernel: the JAX package scans the probed lists on the host
// (local_search_quantization_tpu/ivf.py: numpy, or the native scanner
// native/lsq_native.cpp lsq_linscan_ivf). It takes the place of the plain
// torch scan of `ivf.ivf_scan_reference` on a CUDA index, which pads every
// query to the longest candidate list of its chunk and makes some thirty
// temporaries a slot, after reading that longest list back to the host. Same
// contract: dist = sum_j lut[q, j, code_j] + extra, summed in j order then
// extra, in f32; the k smallest keys mono(dist) << 32 | id (scan_common.cuh,
// as K2's), so ties at the k-th distance keep their lowest ids; rows that are
// not finite (+inf tombstones) are never returned; slots past the live
// candidates are (+inf, -1).
//
// The grouped store: codes as planes [m, n_g] uint8 (the partition's
// codesT_g), extra [n_g] f32 or none, order [n_g] int64 (the original ids),
// and per list its padded start and its live rows. Every segment starts on
// a multiple of 64 rows and is padded to one, so a segment is whole 64-row
// chunks, and a chunk's rows of one plane are 64 aligned, contiguous bytes.
//
// ivf_scan: grid (queries x slices), 256 threads. A block
// - loads its query's table [m, h] f32 into shared memory (7 KB at m=7,
//   h=256);
// - counts the query's chunks from `lives` of its probes (-1 = unused slot)
//   and takes slice s's share of them, [C*s/S, C*(s+1)/S): a heavy list is
//   cut like any other, so a few heavy queries do not set the pace, and the
//   host chooses S from shapes it knows (no read of the lists);
// - walks the probes a tile of 256 at a time (an exclusive scan of their
//   chunk counts in shared memory) and scores 16 chunks a step, a
//   half-warp a chunk, four rows a lane: one 4-byte load a plane and one
//   16-byte load of extra a lane, 64 bytes a plane a half-warp;
// - keeps a buffer of keys in shared memory behind a bound T: a row is
//   appended (one warp-aggregated atomic a warp) only if its key lies below
//   T, with its grouped position in the low half; ids are read from `order`
//   where the buffer is sorted, and in the scan only for a row at T's own
//   distance. At most one step's rows (1024) arrive between two checks of
//   the room left, and where the room runs out the ids are read, a bitonic
//   sort keeps the k smallest keys and T becomes the k-th. At k <= 32 the
//   first step's rows set T at once, at their k-th smallest distance: each
//   warp finds its k smallest among its 128 rows by k rounds of a warp
//   minimum, and one warp the k-th of those, so the buffer is not sorted
//   whole for a first bound, and about k of every step's 1024 rows pass it;
// - sorts what is left and writes the k smallest: as (dist, id) where the
//   query has one slice, else as keys to the workspace [nq, S, k].
// ivf_merge (S > 1): one block a query merges its S sorted lists by bitonic
// merges of two lists at a time in shared memory, skipping a list whose
// smallest key is not below the current k-th, and writes (dist, id).
// Block 0 of each query adds the live rows of its probed lists to a device
// counter (`ivf_rows_scanned`), so no count is read back in the call.
//
// The kernel is built for k capacities 32, 256 and 2048 (a template):
// shared memory holds pow2(cap + 1024) keys (16 KB, 16 KB, 32 KB).
//
// Bounds on this card, at the benchmark's IVF shapes (1000 queries, nprobe 64
// of 16,384 lists, 42.6M live probed rows a call, m=7): bytes, each probed
// row's 7 code bytes and 4-byte extra read once, 0.47 GB, 0.14 ms at 3.35
// TB/s; 3.0e8 table lookups from shared memory, at one 32-lane lookup an SM
// a clock 0.036 ms without bank conflicts (random codes put ~3.5 lanes on a
// bank, ~0.13 ms). What the design spends to approach the bytes' bound is
// loads in flight: six resident blocks of 16 half-warps an SM (40
// registers a thread), each half-warp's 7 plane loads and extra load
// issued together before its lookups, and no id read in the scan. A
// block's set-up (its table, its probes' scan) is dear beside a few
// thousand rows, so the host cuts a query into few slices (~16k rows each).
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "scan_common.cuh"

namespace {

using lsq_scan::kFull;
using lsq_scan::mono;
using lsq_scan::unmono;

constexpr int kThreads = 256;
// Resident scan blocks an SM: at most 40 registers a thread. Six blocks of
// eight warps keep more chunk loads in flight than four at 64 registers.
constexpr int kScanBlocksPerSM = 6;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                               // rows a chunk (segments are 64-aligned)
constexpr int kLanesPerChunk = 16;                       // a half-warp a chunk
constexpr int kRows = kChunk / kLanesPerChunk;           // rows a lane: 4
constexpr int kChunksPerStep = kThreads / kLanesPerChunk;  // 16
constexpr int kStepRows = kChunksPerStep * kChunk;       // 1024: most appends a step
constexpr int kWarmMax = 32;                             // k at which the first step sets T
constexpr int kPlanes = 8;                               // code planes loaded at once
constexpr int kMergeThreads = 256;
constexpr int kLutMaxBytes = 160 * 1024;                 // the largest table a block holds
constexpr uint32_t kNoBound = 0xffffffffu;               // a row that is not a candidate
constexpr unsigned long long kEmpty = ~0ull;             // an empty slot; T before any bound

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Exclusive prefix sum of x over the block's threads in order, and the
// total. Every thread calls it; s_warp holds kWarps words.
__device__ __forceinline__ int block_exclusive(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  __syncthreads();  // s_warp's last readers are done
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    if (w < warp) before += v;
    total += v;
  }
  return before + inc - x;
}

// The sum of x over the block's threads. Every thread calls it.
__device__ __forceinline__ long long block_sum(long long x, long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  __syncthreads();
  if (lane == 0) s_warp[warp] = x;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  return total;
}

// Sort s[0, P) ascending, P a power of two >= 2, by a bitonic network; ends
// with a barrier.
template <int kBlock>
__device__ __forceinline__ void bitonic_sort(unsigned long long* s, int P) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kBlock) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == asc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Sort the buffer's `count` keys (padded with kEmpty to a power of two);
// call after a barrier. Ends with a barrier.
__device__ __forceinline__ void sort_buffer(unsigned long long* s_keys, int count) {
  const int P = pow2_ceil(count < 2 ? 2 : count);
  for (int i = count + threadIdx.x; i < P; i += kThreads) s_keys[i] = kEmpty;
  __syncthreads();
  bitonic_sort<kThreads>(s_keys, P);
}

// The buffer's keys [from, count) hold a row's grouped position in their low
// half: replace it by the row's id. Call after a barrier; the sort that
// follows begins with one.
__device__ __forceinline__ void resolve_ids(unsigned long long* s_keys, int from, int count,
                                            const long long* __restrict__ order) {
  for (int i = from + threadIdx.x; i < count; i += kThreads) {
    const unsigned long long key = s_keys[i];
    s_keys[i] = (key & 0xffffffff00000000ull) |
                static_cast<uint32_t>(order[static_cast<uint32_t>(key)]);
  }
}

// Append `key` where `take`: one shared atomic a warp on the buffer's count.
// Every lane of the warp calls it.
__device__ __forceinline__ void append(bool take, unsigned long long key, int lane,
                                       unsigned long long* s_keys, int* s_count) {
  const unsigned bal = __ballot_sync(kFull, take);
  if (bal == 0u) return;  // warp-uniform
  const int leader = __ffs(bal) - 1;
  int pos = 0;
  if (lane == leader) pos = atomicAdd(s_count, __popc(bal));
  pos = __shfl_sync(kFull, pos, leader) + __popc(bal & ((1u << lane) - 1u));
  if (take) s_keys[pos] = key;
}

// Distances of the lane's kRows rows from `row` on (nrows of them live, from
// the lane's first): the table entries summed in j order, then extra. Pad
// rows read code 0.
__device__ __forceinline__ void score_rows(const float* s_lut, int m, int h,
                                           const uint8_t* __restrict__ codes_t, long long n_g,
                                           const float* __restrict__ extra, long long row,
                                           int live, float (&d)[kRows]) {
  float e[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (extra != nullptr) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(extra + row));
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  }
  // The live rows' code bytes; a pad row's are masked to 0.
  const uint32_t keep = live >= kRows ? 0xffffffffu : (1u << (8 * live)) - 1u;
  for (int j0 = 0; j0 < m; j0 += kPlanes) {
    uint32_t w[kPlanes];
#pragma unroll
    for (int jj = 0; jj < kPlanes; ++jj)
      w[jj] = j0 + jj < m ? __ldg(reinterpret_cast<const uint32_t*>(
                                codes_t + static_cast<size_t>(j0 + jj) * n_g + row)) & keep
                          : 0u;
#pragma unroll
    for (int jj = 0; jj < kPlanes; ++jj) {
      const int j = j0 + jj;
      if (j < m) {
        const float* lj = s_lut + j * h;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const float v = lj[(w[jj] >> (8 * u)) & 255u];
          d[u] = j == 0 ? v : d[u] + v;
        }
      }
    }
  }
  if (extra != nullptr) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) d[u] += e[u];
  }
}

// The k-th smallest of a warp's values (kPer a lane, distinct), by k rounds
// of a warp minimum; where `out` is given, round r's minimum (the r-th
// smallest) goes to out[r]. kEmpty where the warp has fewer than k values.
// Every lane calls it.
template <int kPer>
__device__ __forceinline__ unsigned long long warp_kth(unsigned long long (&v)[kPer], int k,
                                                       uint32_t* out) {
  unsigned long long mn = kEmpty;
  for (int round = 0; round < k; ++round) {
    mn = v[0];
#pragma unroll
    for (int u = 1; u < kPer; ++u) mn = v[u] < mn ? v[u] : mn;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long t = __shfl_xor_sync(kFull, mn, o);
      mn = t < mn ? t : mn;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (v[u] == mn) v[u] = kEmpty;
    if (out != nullptr && (threadIdx.x & 31) == 0) out[round] = static_cast<uint32_t>(mn >> 32);
  }
  return mn;
}

// The key's (dist, id) as the scan's output: (+inf, -1) for an empty slot.
__device__ __forceinline__ void write_key(unsigned long long key, float* od, long long* oi) {
  if (key == kEmpty) {
    *od = INFINITY;
    *oi = -1;
  } else {
    *od = unmono(static_cast<uint32_t>(key >> 32));
    *oi = static_cast<long long>(static_cast<uint32_t>(key));
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads, kScanBlocksPerSM)
ivf_scan(const float* __restrict__ luts, int m, int h, const long long* __restrict__ probes,
         int p, const long long* __restrict__ starts, const long long* __restrict__ lives,
         const uint8_t* __restrict__ codes_t, long long n_g, const float* __restrict__ extra,
         const long long* __restrict__ order, int k, int slices,
         unsigned long long* __restrict__ work, unsigned long long* __restrict__ rows_scanned,
         float* __restrict__ out_d, long long* __restrict__ out_i) {
  constexpr int kBuf = pow2_ceil(kCap + kStepRows);
  __shared__ unsigned long long s_keys[kBuf];
  __shared__ int s_end[kThreads];  // a tile's probes: the chunk after each probe's last
  __shared__ int s_live[kThreads];
  __shared__ long long s_start[kThreads];
  __shared__ long long s_sum[kWarps];
  __shared__ int s_warp[kWarps];
  __shared__ uint32_t s_wlist[kWarps * kWarmMax];  // each warp's k smallest distances
  __shared__ uint32_t s_wbound;
  __shared__ int s_count, s_resolved;
  __shared__ unsigned long long s_bound;
  extern __shared__ float s_lut[];  // [m][h]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / slices, s = blockIdx.x % slices;
  const long long* pq = probes + static_cast<size_t>(q) * p;
  const int mh = m * h;
  const float* lq = luts + static_cast<size_t>(q) * mh;
  if (mh % 4 == 0 && (reinterpret_cast<uintptr_t>(luts) & 15) == 0) {
    for (int e = tid; e < mh / 4; e += kThreads)
      reinterpret_cast<float4*>(s_lut)[e] = __ldg(reinterpret_cast<const float4*>(lq) + e);
  } else {
    for (int e = tid; e < mh; e += kThreads) s_lut[e] = lq[e];
  }
  if (tid == 0) {
    s_count = 0;
    s_resolved = 0;
    s_bound = kEmpty;
  }

  // The query's chunks and live rows, and this slice's chunks [c0, c1). A
  // thread keeps its probe of the first tile (pr0, live0, start0).
  long long my_rows = 0, my_chunks = 0, start0 = 0;
  int live0 = 0;
  for (int i = tid; i < p; i += kThreads) {
    const long long pr = pq[i];
    if (pr >= 0) {
      const long long live = lives[pr];
      if (i == tid) {
        live0 = static_cast<int>(live);
        start0 = starts[pr];
      }
      my_rows += live;
      my_chunks += (live + kChunk - 1) / kChunk;
    }
  }
  const long long total = block_sum(my_chunks, s_sum);
  const long long rows = block_sum(my_rows, s_sum);
  if (s == 0 && tid == 0 && rows > 0)
    atomicAdd(rows_scanned, static_cast<unsigned long long>(rows));
  const int c0 = static_cast<int>(total * s / slices);
  const int c1 = static_cast<int>(total * (s + 1) / slices);

  unsigned long long bound = kEmpty;
  int base = 0;  // chunks of the tiles before this one
  for (int t0 = 0; t0 < p && base < c1; t0 += kThreads) {  // block-uniform
    const int i = t0 + tid;
    int live = live0;
    long long st = start0;
    if (t0 > 0) {
      live = 0;
      st = 0;
      if (i < p) {
        const long long pr = pq[i];
        if (pr >= 0) {
          live = static_cast<int>(lives[pr]);
          st = starts[pr];
        }
      }
    }
    const int nch = (live + kChunk - 1) / kChunk;
    int tile_total;
    const int excl = block_exclusive(nch, s_warp, tile_total);  // its barriers guard s_end
    s_end[tid] = base + excl + nch;
    s_live[tid] = live;
    s_start[tid] = st;
    const int tile_n = min(kThreads, p - t0);
    const int lo = max(c0, base), hi = min(c1, base + tile_total);
    for (int cb = lo; cb < hi; cb += kChunksPerStep) {  // block-uniform
      __syncthreads();  // the tile is written, the last step's appends are in
      if (s_count + kStepRows > kBuf) {  // block-uniform: keep the k smallest
        const int count = s_count;
        resolve_ids(s_keys, s_resolved, count, order);
        sort_buffer(s_keys, count);
        if (tid == 0) {
          s_bound = s_keys[k - 1];
          s_count = s_resolved = k;
        }
        __syncthreads();
      }
      bound = s_bound;
      // This half-warp's chunk, and its probe: the first whose end is past it.
      const int c = cb + (tid >> 4);
      const int r = (tid & 15) * kRows;
      int nrows = 0;
      long long row = 0;
      if (c < hi) {
        int a = 0, b = tile_n - 1;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (s_end[mid] > c) {
            b = mid;
          } else {
            a = mid + 1;
          }
        }
        const int cc = c - (s_end[a] - (s_live[a] + kChunk - 1) / kChunk);
        row = s_start[a] + static_cast<long long>(cc) * kChunk + r;
        nrows = min(kChunk, s_live[a] - cc * kChunk) - r;
      }
      float d[kRows];
      uint32_t key_hi[kRows];
      if (nrows > 0) score_rows(s_lut, m, h, codes_t, n_g, extra, row, nrows, d);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        key_hi[u] = u < nrows && fabsf(d[u]) < INFINITY ? mono(d[u]) : kNoBound;
      if (kCap <= kWarmMax && bound == kEmpty) {  // block-uniform: a first bound
        // The step's k-th smallest distance: each warp's k smallest, then the
        // k-th of those (any of the step's k smallest is among its warp's).
        unsigned long long v[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          v[u] = (static_cast<unsigned long long>(key_hi[u]) << 32) | (lane * kRows + u);
        warp_kth<kRows>(v, k, s_wlist + warp * kWarmMax);
        __syncthreads();
        if (warp == 0) {
          constexpr int kPer = kWarps * kWarmMax / 32;
          unsigned long long x[kPer];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int e = lane + 32 * i;
            x[i] = e % kWarmMax < k ? (static_cast<unsigned long long>(s_wlist[e]) << 32) | e
                                    : kEmpty;
          }
          const unsigned long long kth = warp_kth<kPer>(x, k, nullptr);
          if (lane == 0) s_wbound = static_cast<uint32_t>(kth >> 32);
        }
        __syncthreads();
        const uint32_t b = s_wbound;
        if (b != kNoBound) bound = (static_cast<unsigned long long>(b) << 32) | 0xffffffffull;
        if (tid == 0) s_bound = bound;  // read again after the next step's barrier
      }
      // A row below T's distance is taken without its id; at T's distance
      // its id decides, unless T is a first step's bound, which takes every id.
      const uint32_t bound_hi = static_cast<uint32_t>(bound >> 32);
      const uint32_t bound_lo = static_cast<uint32_t>(bound);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const bool take = key_hi[u] != kNoBound &&
                          (key_hi[u] < bound_hi ||
                           (key_hi[u] == bound_hi &&
                            (bound_lo == 0xffffffffu ||
                             static_cast<uint32_t>(order[row + u]) < bound_lo)));
        append(take, (static_cast<unsigned long long>(key_hi[u]) << 32) |
                         static_cast<uint32_t>(row + u), lane, s_keys, &s_count);
      }
    }
    base += tile_total;
  }

  __syncthreads();
  const int count = s_count;
  resolve_ids(s_keys, s_resolved, count, order);
  sort_buffer(s_keys, count);
  const int n = min(count, k);
  if (slices == 1) {
    for (int i = tid; i < k; i += kThreads)
      write_key(i < n ? s_keys[i] : kEmpty, out_d + static_cast<size_t>(q) * k + i,
                out_i + static_cast<size_t>(q) * k + i);
  } else {
    unsigned long long* wq = work + (static_cast<size_t>(q) * slices + s) * k;
    for (int i = tid; i < k; i += kThreads) wq[i] = i < n ? s_keys[i] : kEmpty;
  }
}

// The k smallest of a query's `slices` sorted lists of k keys.
template <int kCap>
__global__ void __launch_bounds__(kMergeThreads)
ivf_merge(const unsigned long long* __restrict__ work, int k, int slices,
          float* __restrict__ out_d, long long* __restrict__ out_i) {
  __shared__ unsigned long long s[2 * kCap];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int P = pow2_ceil(k);  // <= kCap
  const unsigned long long* wq = work + static_cast<size_t>(q) * slices * k;
  for (int i = tid; i < P; i += kMergeThreads) s[i] = i < k ? wq[i] : kEmpty;
  for (int sl = 1; sl < slices; ++sl) {
    const unsigned long long* ws = wq + static_cast<size_t>(sl) * k;
    __syncthreads();
    if (ws[0] >= s[k - 1]) continue;  // block-uniform: no key of the list can enter
    // The list reversed behind the current one: a bitonic sequence of 2P.
    for (int i = tid; i < P; i += kMergeThreads) {
      const int src = P - 1 - i;
      s[P + i] = src < k ? ws[src] : kEmpty;
    }
    __syncthreads();
    for (int stride = P; stride > 0; stride >>= 1) {
      for (int t = tid; t < P; t += kMergeThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = s[lo], b = s[hi];
        if (a > b) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int i = tid; i < k; i += kMergeThreads)
    write_key(s[i], out_d + static_cast<size_t>(q) * k + i, out_i + static_cast<size_t>(q) * k + i);
}

template <int kCap>
int launch_ivf(const void* luts, int nq, int m, int h, const void* probes, int p,
               const void* starts, const void* lives, const void* codes_t, long long n_g,
               const void* extra, const void* order, int k, int slices, void* work,
               void* rows_scanned, void* out_d, void* out_i, cudaStream_t stream) {
  const int smem = m * h * 4;
  cudaError_t err = cudaFuncSetAttribute(ivf_scan<kCap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_scan<kCap><<<nq * slices, kThreads, smem, stream>>>(
      static_cast<const float*>(luts), m, h, static_cast<const long long*>(probes), p,
      static_cast<const long long*>(starts), static_cast<const long long*>(lives),
      static_cast<const uint8_t*>(codes_t), n_g, static_cast<const float*>(extra),
      static_cast<const long long*>(order), k, slices,
      static_cast<unsigned long long*>(work), static_cast<unsigned long long*>(rows_scanned),
      static_cast<float*>(out_d), static_cast<long long*>(out_i));
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  ivf_merge<kCap><<<nq, kMergeThreads, 0, stream>>>(
      static_cast<const unsigned long long*>(work), k, slices, static_cast<float*>(out_d),
      static_cast<long long*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest table [m, h] f32 a scan block holds, in bytes.
int lsq_ivf_lut_max_bytes() { return kLutMaxBytes; }

// The probed scan of nq queries: luts [nq, m, h] f32; probes [nq, p] int64
// list ids (-1 = unused); starts, lives [nlist] int64; codes_t [m, n_g]
// uint8 (n_g a multiple of 64, every segment 64-aligned); extra [n_g] f32
// or null; order [n_g] int64 ids below 2^32. Writes out_d [nq, k] f32 and
// out_i [nq, k] int64; adds the probed lists' live rows to *rows_scanned
// (uint64). kcap is 32, 256 or 2048 and >= k; work is uint64 [nq, slices,
// k] where slices > 1. nq * slices < 2^31.
int lsq_ivf_scan(const void* luts, int nq, int m, int h, const void* probes, int p,
                 const void* starts, const void* lives, const void* codes_t, long long n_g,
                 const void* extra, const void* order, int k, int kcap, int slices, void* work,
                 void* rows_scanned, void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kcap || slices < 1 || (slices > 1 && work == nullptr) ||
      rows_scanned == nullptr || n_g % kChunk != 0 ||
      static_cast<long long>(m) * h * 4 > kLutMaxBytes || nq < 1 || p < 1 ||
      static_cast<long long>(nq) * slices >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kcap) {
    case 32:
      return launch_ivf<32>(luts, nq, m, h, probes, p, starts, lives, codes_t, n_g, extra, order,
                            k, slices, work, rows_scanned, out_d, out_i, s);
    case 256:
      return launch_ivf<256>(luts, nq, m, h, probes, p, starts, lives, codes_t, n_g, extra,
                             order, k, slices, work, rows_scanned, out_d, out_i, s);
    case 2048:
      return launch_ivf<2048>(luts, nq, m, h, probes, p, starts, lives, codes_t, n_g, extra,
                              order, k, slices, work, rows_scanned, out_d, out_i, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
