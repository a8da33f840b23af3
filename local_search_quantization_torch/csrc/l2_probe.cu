// The L2 gather probe: how fast the card serves random table rows from L2.
//
// A measurement tool, not a port: it replaces no TPU kernel and runs on no
// path. K1 (ils_encode.cu), K5 and K6 (icm_sweeps.cu) are bound by the
// table rows they gather: each visit of each row reads m-1 rows of h values
// (512 B of bf16 for K5/K6, 1 KB of f32 for K1) from a table (6.4 MB and
// 12.8 MB at m=7, h=256) that stays in the 50 MB L2. This kernel does only
// that: warp w gathers rows_per_warp rows, chosen by a hash of its row
// counter, sums them into registers and writes one float. Its bytes over
// its time is the rate at which L2 serves such gathers, and the kernels'
// gathered bytes over that rate their practical bound.
//
// Two load widths: VEC = 1 loads one element a lane, as K1/K5/K6 do (32
// lanes read 64 B of bf16 or 128 B of f32 an instruction); VEC = 16 bytes /
// element size loads 16 B a lane (a whole 512 B row an instruction). Four
// rows are in flight a warp, and 64 warps an SM, to hide L2's latency.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;

// The row a warp reads at step i: murmur3's finalizer of (seed ^ counter),
// scaled to [0, nrows) by a high multiply. ops/l2_probe.py repeats it.
__device__ __forceinline__ unsigned row_of(unsigned seed, unsigned counter, unsigned nrows) {
  unsigned x = seed ^ counter;
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return __umulhi(x, nrows);
}

__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float widen(float f) { return f; }

// The sum of the VEC elements at p (16-byte aligned when VEC > 1).
template <typename E, int VEC>
__device__ __forceinline__ float load_sum(const E* p) {
  if constexpr (VEC == 1) {
    return widen(__ldg(p));
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(E) == 2) {
        s += __uint_as_float(w[k] << 16);
        s += __uint_as_float(w[k] & 0xffff0000u);
      } else {
        s += __uint_as_float(w[k]);
      }
    }
    return s;
  }
}

template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads)
l2_gather_kernel(const E* __restrict__ table, int nrows, int row_elems, int rows_per_warp,
                 unsigned seed, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  float acc[kUnroll] = {};
  for (int i = 0; i < rows_per_warp; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned r = row_of(seed, warp * rows_per_warp + i + u, nrows);
      const E* p = table + static_cast<size_t>(r) * row_elems;
      for (int e = lane * VEC; e < row_elems; e += 32 * VEC) acc[u] += load_sum<E, VEC>(p + e);
    }
  }
  float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) out[warp] = v;
}

template <typename E, int VEC>
int launch(const void* table, int nrows, int row_elems, int warps, int rows_per_warp,
           unsigned seed, void* out, void* stream) {
  l2_gather_kernel<E, VEC><<<warps / (kThreads / 32), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(table), nrows, row_elems, rows_per_warp, seed,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Warps a block (the launch takes warps in whole blocks) and rows a warp
// step (rows_per_warp is a multiple of it).
int lsq_l2_warps_per_block() { return kThreads / 32; }
int lsq_l2_rows_per_step() { return kUnroll; }

// table: [nrows, row_elems] of bf16 (elem_bytes 2) or f32 (elem_bytes 4),
// rows 16-byte aligned; wide != 0 loads 16 B a lane, else one element.
// out: [warps] f32, warp w's sum of its rows.
int lsq_l2_gather(const void* table, int elem_bytes, int wide, int nrows, int row_elems,
                  int warps, int rows_per_warp, unsigned seed, void* out, void* stream) {
  if (elem_bytes == 2) {
    return wide ? launch<unsigned short, 8>(table, nrows, row_elems, warps, rows_per_warp,
                                            seed, out, stream)
                : launch<unsigned short, 1>(table, nrows, row_elems, warps, rows_per_warp,
                                            seed, out, stream);
  }
  if (elem_bytes == 4) {
    return wide ? launch<float, 4>(table, nrows, row_elems, warps, rows_per_warp, seed, out,
                                   stream)
                : launch<float, 1>(table, nrows, row_elems, warps, rows_per_warp, seed, out,
                                   stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
