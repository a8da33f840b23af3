// K2: additive ADC scan plus an exact (dist, id)-lexicographic top-k.
//
// Replaces local_search_quantization_tpu/ops/select_pallas.py:
// _select_kernel_grouped (with its distance helpers _dist_tile and
// _onehot_tile), launched there through fused_scan_topk / scan_topk_warm.
// Same contract: dist[q, i] = sum_j lut[q, j, B[i, j]] + extra[i], summed in
// j order then extra; the k smallest in (dist, id) order; +inf rows are
// never selected, and empty slots are (+inf, -1).
//
// Two kernels per block of queries, both launched by lsq_scan_topk:
// 1. adc_scan: a block loads kQB queries' LUTs (kQB * m * h f32, 28 KB at
//    m=7, h=256) into shared memory and sums table lookups for a tile of
//    rows; codes are [m, n] (uint8 or int32), so each codebook's read is
//    coalesced. Distances go to a [nq_block, n] f32 buffer.
// 2. radix_select: one block per query finds the exact k-th smallest
//    distance T by a radix select over the monotone 32-bit image of the
//    float (four 8-bit passes, warp-aggregated shared-memory histograms),
//    then collects every row with dist < T and the lowest-id rows with
//    dist == T, scanning in id order with a block prefix sum, so the tie
//    rule is structural: no warm start, certificate or deep-k rerun
//    (adc.py:625-715) is needed. The <= k survivors are sorted by (dist, id)
//    outside the kernel, as the TPU path sorts outside its kernel.
// What bounds it on this card: shared-memory LUT lookups (m per row per
// query, random banks) in the scan, and five passes over each query's
// distance row (4 bytes per row per pass) in the select. No matrix unit.
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kQB = 4;              // queries per scan block
constexpr int kScanThreads = 256;
constexpr int kRowsPerBlock = 16384;  // rows per scan block
constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kInfKey = 0xff800000u;  // mono(+inf)

// Monotone image of a float: a < b as floats iff mono(a) < mono(b) as
// unsigned ints (NaN excluded). -0.0 maps with +0.0, as the two compare equal.
__device__ __forceinline__ uint32_t mono(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

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
int launch(const void* luts, const void* bt, const void* extra, int nq, int m, int h,
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

}  // namespace

extern "C" {

int lsq_scan_smem_bytes(int m, int h) { return kQB * m * h * 4; }

// Unsorted exact top-k candidates of nq queries; `dist` is [nq, n] f32 scratch.
// code_bytes is 1 (uint8 codes) or 4 (int32 codes). Needs 1 <= k <= n.
int lsq_scan_topk(const void* luts, const void* bt, int code_bytes, const void* extra, int nq,
                  int m, int h, int n, int k, void* dist, void* out_d, void* out_i,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(luts, bt, extra, nq, m, h, n, k, dist, out_d, out_i, s);
  if (code_bytes == 4)
    return launch<int32_t>(luts, bt, extra, nq, m, h, n, k, dist, out_d, out_i, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
