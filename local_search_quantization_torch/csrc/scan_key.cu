// K4: additive ADC scan over bf16-rounded LUTs that appends, per query, every
// row whose truncated monotone distance key lies below the warm bound's.
//
// Replaces local_search_quantization_tpu/ops/select_pallas.py:
// _select_kernel_key, launched there through fused_scan_topk(variant="key")
// from scan_topk_warm. Contract: hi[q, i] = sum_j bf16(lut[q, j, Bt[j, i]]) +
// extra[i], the bf16 values widened to f32 and summed in j order, then extra.
// With key(x) the signed-int32 monotone map of the f32 bits (_f32_to_key) and
// M = -(1 << 13), row i is appended when (key(hi) & M) < (key(t0[q]) & M):
// the TPU kernel's compare without its lane bits. ids [nq, cap] come back in
// no fixed order, -1 where unfilled; count [nq] counts every hit, also those
// dropped past cap, so count >= cap flags overflow. The exact f32 re-rank, the
// (dist, id) sort and the certificate run outside, in the wrapper.
//
// A block holds kQB queries' bf16 LUTs in shared memory (half of K2's f32
// tables) and scores a tile of kRowsPerBlock rows for each of them; a hit is
// appended with one warp-aggregated atomicAdd on its query's cursor. There is
// no buffer upkeep and no threshold to tighten.
// What bounds it on this card: the m shared-memory lookups per row and query
// (random banks), as in K2's scan; there is no select pass and no distance
// scratch, and the appends are ~2k per query at a warm bound.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kQB = 4;  // queries per block
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16384;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeyMask = -(1 << 13);

// Signed-int32 monotone key of a float (select_pallas.py:475): non-negative
// floats keep their bits, negative ones map to MININT - bits, computed in
// unsigned arithmetic so nothing overflows; -0.0 maps to 0.
__device__ __forceinline__ int f32_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : static_cast<int>(0x80000000u - static_cast<unsigned>(b));
}

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
scan_key(const uint16_t* __restrict__ luts, const CodeT* __restrict__ bt,
         const float* __restrict__ extra, const float* __restrict__ t0, int nq, int m,
         int h, int n, int cap, int* __restrict__ out_i, int* __restrict__ count) {
  extern __shared__ uint16_t s_lut[];
  const int mh = m * h;
  const int q0 = blockIdx.y * kQB;
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < kQB * mh; e += kThreads) {
    const int q = q0 + e / mh;
    s_lut[e] = q < nq ? luts[static_cast<size_t>(q) * mh + e % mh] : 0;
  }
  int t0k[kQB];
#pragma unroll
  for (int q = 0; q < kQB; ++q)
    t0k[q] = q0 + q < nq ? (f32_key(t0[q0 + q]) & kKeyMask) : INT32_MIN;
  __syncthreads();
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(n, r0 + kRowsPerBlock);
  for (int base = r0; base < r1; base += kThreads) {
    const int i = base + threadIdx.x;
    float acc[kQB];
    if (i < r1) {
      int c = static_cast<int>(bt[i]);
#pragma unroll
      for (int q = 0; q < kQB; ++q) acc[q] = bf16_to_f32(s_lut[q * mh + c]);
      for (int j = 1; j < m; ++j) {
        c = static_cast<int>(bt[static_cast<size_t>(j) * n + i]);
#pragma unroll
        for (int q = 0; q < kQB; ++q) acc[q] += bf16_to_f32(s_lut[q * mh + j * h + c]);
      }
      const float e = extra[i];
#pragma unroll
      for (int q = 0; q < kQB; ++q) acc[q] += e;
    }
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      const bool hit = i < r1 && (f32_key(acc[q]) & kKeyMask) < t0k[q];
      const unsigned bal = __ballot_sync(kFull, hit);
      if (bal == 0u) continue;  // warp-uniform
      const int leader = __ffs(bal) - 1;
      int pos = 0;
      if (lane == leader) pos = atomicAdd(&count[q0 + q], __popc(bal));
      pos = __shfl_sync(kFull, pos, leader) + __popc(bal & ((1u << lane) - 1u));
      if (hit && pos < cap) out_i[static_cast<size_t>(q0 + q) * cap + pos] = i;
    }
  }
}

template <typename CodeT>
int launch(const void* luts, const void* bt, const void* extra, const void* t0, int nq,
           int m, int h, int n, int cap, void* out_i, void* count, cudaStream_t stream) {
  const int smem = kQB * m * h * 2;
  cudaError_t err = cudaFuncSetAttribute(scan_key<CodeT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, (nq + kQB - 1) / kQB);
  scan_key<CodeT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(luts), static_cast<const CodeT*>(bt),
      static_cast<const float*>(extra), static_cast<const float*>(t0), nq, m, h, n, cap,
      static_cast<int*>(out_i), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lsq_key_smem_bytes(int m, int h) { return kQB * m * h * 2; }

// Append the hits of nq queries: luts [nq, m*h] bf16, t0 [nq] f32, out_i
// [nq, cap] int32 prefilled with -1, count [nq] int32 prefilled with 0.
// code_bytes is 1 (uint8 codes) or 4 (int32 codes).
int lsq_scan_key(const void* luts, const void* bt, int code_bytes, const void* extra,
                 const void* t0, int nq, int m, int h, int n, int cap, void* out_i,
                 void* count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return launch<uint8_t>(luts, bt, extra, t0, nq, m, h, n, cap, out_i, count, s);
  if (code_bytes == 4)
    return launch<int32_t>(luts, bt, extra, t0, nq, m, h, n, cap, out_i, count, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
