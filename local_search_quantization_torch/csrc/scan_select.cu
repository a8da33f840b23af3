// K3: additive ADC scan plus a top-k cut at a warm bound, streamed through a
// per-query shared-memory buffer: no distance scratch.
//
// Replaces local_search_quantization_tpu/ops/select_pallas.py: _select_kernel
// (variants "sorted" and "unsorted"), launched there through fused_scan_topk
// and scan_topk_warm (the warm pre-scan and the key variant's fallback).
// Contract: dist[q, i] = sum_j lut[q, j, Bt[j, i]] + extra[i], summed in j
// order then extra (the f32 values of K2 and lut_scan_block); only rows with
// dist < t0[q] are kept, and +inf rows never are.
// - lex (the "sorted" variant): the keep = k rows that are smallest in
//   (dist, id) order, bit for bit K2's answer cut at t0;
// - value (the "unsorted" variant): keep = cap rows, value-exact: the k
//   smallest distances are right, but which ids survive a tie block across
//   the k-th value follows arrival order.
// The survivors come back unsorted, (+inf, -1) past them; the wrapper sorts by
// (dist, id), as the TPU route sorts after its kernel.
//
// One block per query. The query's LUT (m*h f32) sits in shared memory
// beside a buffer of 64-bit keys, (monotone image of dist) << 32 | id, of
// 2*keep + one tile. A tile of kTile rows is scored in registers; each row
// below the threshold thr = min(t0, the largest kept distance) is appended
// with a warp-aggregated shared-memory atomic. When the buffer holds more
// than 2*keep rows, a radix select over its keys (8-bit digits; the whole
// 64-bit key in lex mode, the distance half in value mode) finds the keep-th
// key, an order-preserving in-place compaction keeps the rows at or below it,
// and thr tightens. Rows of later tiles have larger ids than every kept row,
// so a strict dist < thr is the lexicographic rule too.
// What bounds it on this card: the m shared-memory LUT lookups a row (random
// banks) and the code bytes read from L2 once per query; the selection runs
// only on the few rows below thr once the buffer has filled.
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;  // rows scored per tile
constexpr unsigned kFull = 0xffffffffu;
// Static shared memory the kernel keeps besides the dynamic block (the
// histogram, counters and warp offsets), reserved out of the 227 KB.
constexpr int kStaticSmemReserve = 2048;
constexpr int kSmemLimit = 227 * 1024;

// Monotone image of a float: a < b iff mono(a) < mono(b) (NaN excluded);
// -0.0 maps with +0.0, as the two compare equal.
__device__ __forceinline__ uint32_t mono(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unmono(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__host__ __device__ inline size_t lut_bytes(int m, int h) {
  return (static_cast<size_t>(m) * h * 4 + 7) / 8 * 8;
}

__host__ __device__ inline size_t smem_bytes(int m, int h, int keep) {
  return lut_bytes(m, h) + 8 * (2 * static_cast<size_t>(keep) + kTile);
}

struct Shared {
  unsigned hist[256];
  int count;       // rows in the buffer
  int need;        // ties at the selected prefix still to keep
  int done;        // the select is decided
  int kept;        // running output position of the compaction
  int ties;        // running tie count of the compaction
  float thr;       // acceptance threshold
  uint32_t max_hi;  // largest kept distance key
  unsigned long long prefix, mask;
  int wa[kWarps], wb[kWarps];
};

// Exclusive prefix of a per-warp count over the block; returns the block
// total. Every thread must call it; it synchronises twice.
__device__ __forceinline__ int block_scan(int* w, int warp_count, int warp, int lane,
                                          int* offset) {
  if (lane == 0) w[warp] = warp_count;
  __syncthreads();
  int run = 0, total = 0;
  for (int v = 0; v < kWarps; ++v) {
    const int c = w[v];
    if (v < warp) run += c;
    total += c;
  }
  *offset = run;
  __syncthreads();
  return total;
}

// Keep the `keep` smallest keys of buf[0, count) (lex: whole key; value: the
// distance half, ties kept in buffer order), compacted in place, and tighten
// thr. Needs count > keep. Block-uniform.
template <bool kLex>
__device__ void compact(Shared& s, unsigned long long* buf, int keep, float t0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = s.count;
  if (tid == 0) {
    s.prefix = 0ull;
    s.mask = 0ull;
    s.need = keep;
    s.done = 0;
  }
  const int last_shift = kLex ? 0 : 32;
  for (int shift = 56; shift >= last_shift; shift -= 8) {
    for (int b = tid; b < 256; b += kThreads) s.hist[b] = 0;
    __syncthreads();
    const unsigned long long prefix = s.prefix, mask = s.mask;
    for (int base = 0; base < count; base += kThreads) {
      const int e = base + tid;
      unsigned digit = 256;  // no bin
      if (e < count) {
        const unsigned long long key = buf[e];
        if ((key & mask) == prefix) digit = static_cast<unsigned>(key >> shift) & 255u;
      }
      // Warp-aggregated: keys of one query share their leading digits.
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&s.hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      unsigned cum = 0;
      const unsigned need = static_cast<unsigned>(s.need);
      int d = 0;
      for (; d < 255; ++d) {
        if (cum + s.hist[d] >= need) break;
        cum += s.hist[d];
      }
      s.need = static_cast<int>(need - cum);
      s.prefix = prefix | (static_cast<unsigned long long>(d) << shift);
      s.mask = mask | (255ull << shift);
      s.done = s.hist[d] == need - cum;  // every row at this prefix is kept
    }
    __syncthreads();
    if (s.done) break;
  }
  const unsigned long long prefix = s.prefix, mask = s.mask;
  const int need = s.need;
  if (tid == 0) {
    s.kept = 0;
    s.ties = 0;
    s.max_hi = 0u;
  }
  __syncthreads();
  uint32_t my_max = 0u;
  // Order-preserving compaction, one chunk of kThreads keys at a time: every
  // key of a chunk is read before any is written, and a key moves only to a
  // lower index, so nothing unread is overwritten.
  for (int base = 0; base < count; base += kThreads) {
    const int e = base + tid;
    const unsigned long long key = e < count ? buf[e] : ~0ull;
    const bool in = e < count;
    const bool less = in && (key & mask) < prefix;
    const bool tie = in && (key & mask) == prefix;
    const unsigned tb = __ballot_sync(kFull, tie);
    int tie_off;
    const int tie_total = block_scan(s.wa, __popc(tb), warp, lane, &tie_off);
    const int tie_rank = s.ties + tie_off + __popc(tb & ((1u << lane) - 1u));
    const bool keep_it = less || (tie && tie_rank < need);
    const unsigned kb = __ballot_sync(kFull, keep_it);
    int keep_off;
    const int keep_total = block_scan(s.wb, __popc(kb), warp, lane, &keep_off);
    if (keep_it) {
      buf[s.kept + keep_off + __popc(kb & ((1u << lane) - 1u))] = key;
      my_max = max(my_max, static_cast<uint32_t>(key >> 32));
    }
    __syncthreads();
    if (tid == 0) {
      s.kept += keep_total;
      s.ties += tie_total;
    }
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1) my_max = max(my_max, __shfl_xor_sync(kFull, my_max, o));
  if (lane == 0) atomicMax(&s.max_hi, my_max);
  __syncthreads();
  if (tid == 0) {
    s.count = s.kept;
    s.thr = fminf(t0, unmono(s.max_hi));
  }
  __syncthreads();
}

template <typename CodeT, bool kLex>
__global__ void __launch_bounds__(kThreads)
scan_select(const float* __restrict__ luts, const CodeT* __restrict__ bt,
            const float* __restrict__ extra, const float* __restrict__ t0s, int m, int h,
            int n, int keep, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared s;
  float* s_lut = reinterpret_cast<float*>(smem);
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem + lut_bytes(m, h));
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = blockIdx.x;
  const int mh = m * h;
  const float t0 = t0s == nullptr ? INFINITY : t0s[q];
  for (int e = tid; e < mh; e += kThreads) s_lut[e] = luts[static_cast<size_t>(q) * mh + e];
  if (tid == 0) {
    s.count = 0;
    s.thr = t0;
  }
  __syncthreads();
  const int room = 2 * keep;  // compact when the buffer holds more rows
  for (int base = 0; base < n; base += kTile) {
    const float thr = s.thr;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = base + r * kThreads + tid;
      bool take = false;
      float d = 0.0f;
      if (i < n) {
        d = s_lut[static_cast<int>(bt[i])];
        for (int j = 1; j < m; ++j)
          d += s_lut[j * h + static_cast<int>(bt[static_cast<size_t>(j) * n + i])];
        d += extra[i];
        take = d < thr;
      }
      const unsigned bal = __ballot_sync(kFull, take);
      if (bal) {
        int pos = 0;
        if (lane == __ffs(bal) - 1) pos = atomicAdd(&s.count, __popc(bal));
        pos = __shfl_sync(kFull, pos, __ffs(bal) - 1) + __popc(bal & ((1u << lane) - 1u));
        if (take)
          buf[pos] = (static_cast<unsigned long long>(mono(d)) << 32) |
                     static_cast<uint32_t>(i);
      }
    }
    __syncthreads();
    const int count = s.count;
    __syncthreads();
    if (count > room) compact<kLex>(s, buf, keep, t0);
  }
  if (s.count > keep) compact<kLex>(s, buf, keep, t0);
  const int count = s.count;
  float* od = out_d + static_cast<size_t>(q) * keep;
  int* oi = out_i + static_cast<size_t>(q) * keep;
  for (int p = tid; p < keep; p += kThreads) {
    if (p < count) {
      const unsigned long long key = buf[p];
      od[p] = unmono(static_cast<uint32_t>(key >> 32));
      oi[p] = static_cast<int>(static_cast<uint32_t>(key));
    } else {
      od[p] = INFINITY;
      oi[p] = -1;
    }
  }
}

template <typename CodeT, bool kLex>
int launch(const void* luts, const void* bt, const void* extra, const void* t0, int nq,
           int m, int h, int n, int keep, void* out_d, void* out_i, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, h, keep);
  if (smem > static_cast<size_t>(kSmemLimit - kStaticSmemReserve) ||
      sizeof(Shared) > static_cast<size_t>(kStaticSmemReserve))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(scan_select<CodeT, kLex>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_select<CodeT, kLex><<<nq, kThreads, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const CodeT*>(bt),
      static_cast<const float*>(extra), static_cast<const float*>(t0), m, h, n, keep,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, and the most a launch may ask for.
int lsq_select_smem_bytes(int m, int h, int keep) {
  return static_cast<int>(smem_bytes(m, h, keep));
}
int lsq_select_smem_limit() { return kSmemLimit - kStaticSmemReserve; }
int lsq_select_tile() { return kTile; }

// Per query, the keep rows below t0 (t0 may be NULL: +inf): lex = 1 keeps the
// (dist, id)-smallest, lex = 0 the value-smallest. Unsorted out_d/out_i
// [nq, keep], (+inf, -1) past the survivors. code_bytes is 1 (uint8 codes) or
// 4 (int32 codes). Needs 1 <= keep, n < 2^31.
int lsq_select_topk(const void* luts, const void* bt, int code_bytes, const void* extra,
                    const void* t0, int nq, int m, int h, int n, int keep, int lex,
                    void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return lex ? launch<uint8_t, true>(luts, bt, extra, t0, nq, m, h, n, keep, out_d, out_i, s)
               : launch<uint8_t, false>(luts, bt, extra, t0, nq, m, h, n, keep, out_d, out_i, s);
  if (code_bytes == 4)
    return lex ? launch<int32_t, true>(luts, bt, extra, t0, nq, m, h, n, keep, out_d, out_i, s)
               : launch<int32_t, false>(luts, bt, extra, t0, nq, m, h, n, keep, out_d, out_i, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
