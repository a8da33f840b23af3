// K5 and K6: `icmiter` ICM sweeps over every row in one launch, the
// per-round step of the "fused" ILS encoder.
//
// Replaces local_search_quantization_tpu/ops/icm_pallas.py:_icm_kernel_v2
// (K5, entry point lsq_icm_sweeps_v2) and its older layout _icm_kernel (K6,
// entry point lsq_icm_sweeps_v1), both launched there through
// fused_icm_sweeps. A visit to codebook j sets code j of the row to
//
//   argmin_c  u[j, c] + sum_{k != j} lut_k[B_k, c]        (lowest c on ties)
//
// where lut_k is the bf16 pairwise table between codebooks k and j. The two
// TPU kernels differ in two ways that change float32 results, so the
// template keeps both:
//
// - the table layout: K5 reads bint[j, k*h + B_k, :] from the j-stacked
//   [m, m*h, h] table with a zeroed (j, j) block; K6 reads bin[k, j, B_k, :]
//   from [m, m, h, h];
// - the summation order: K5 sums the pair rows first, in k order, and then
//   adds the unary (argmin(acc + cond), icm_pallas.py:111); K6 starts from
//   the unary and adds k = 0..m-1, k != j (icm_pallas.py:51-61).
//
// The TPU kernels condition through a one-hot x bf16 table product on the
// matrix unit. Each one-hot row selects one table row, so the product adds
// exact zeros and the function is the f32 sum of the m-1 selected bf16
// values: here it is that gather, with the bf16 values widened exactly to
// f32. The (j, j) block is skipped rather than read as zeros.
//
// Design, as K1 (ils_encode.cu): one warp owns one row for all icmiter*m
// visits. The row's unaries ([m, h] f32, 7 KB at m=7, h=256) and codes live
// in shared memory; lane l holds the CPL candidates c = l, l+32, ... in
// registers. The bf16 table (6.4 MB at m=7, h=256) stays in device memory
// and is served from the 50 MB L2. What bounds it: each visit of each row
// reads (m-1) table rows of h bf16 values (512 B at h=256) from L2, and a
// lane's CPL loads of one table row are independent, so they are in flight
// together. Adds only and no fast math, so no sum is reassociated or
// contracted, and the plain PyTorch version (fused_icm_sweeps_reference)
// gives the same codes bit for bit.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// Exact widening of a bf16 bit pattern to f32.
__device__ __forceinline__ float bf16_bits_to_f32(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// VARIANT 2: K5 (j-stacked table, pair rows first, then the unary).
// VARIANT 1: K6 ([m, m, h, h] table, unary first).
template <int VARIANT, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
icm_sweeps_kernel(const int* __restrict__ B, const float* __restrict__ unaries,
                  const unsigned short* __restrict__ lut, const int* __restrict__ visits,
                  int n, int m, int h, int nvisit, int* __restrict__ out_b) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warp; only __syncwarp is used below
  const int mh = m * h;
  float* u = smem + warp * mh;
  int* cur = reinterpret_cast<int*>(smem + kWarps * mh) + warp * m;

  const float* urow = unaries + static_cast<size_t>(row) * mh;
  for (int e = lane; e < mh; e += 32) u[e] = urow[e];
  if (lane < m) cur[lane] = B[static_cast<size_t>(row) * m + lane];
  __syncwarp();

  for (int s = 0; s < nvisit; ++s) {
    const int j = __ldg(&visits[s]);
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(m)) continue;
    float acc[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      acc[t] = VARIANT == 1 ? (c < h ? u[j * h + c] : INFINITY) : 0.0f;
    }
    for (int k = 0; k < m; ++k) {
      if (k == j) continue;
      const unsigned short* r =
          VARIANT == 2
              ? lut + (static_cast<size_t>(j) * mh + static_cast<size_t>(k) * h + cur[k]) * h
              : lut + ((static_cast<size_t>(k) * m + j) * h + cur[k]) * h;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        if (c < h) acc[t] += bf16_bits_to_f32(__ldg(&r[c]));
      }
    }
    if (VARIANT == 2) {
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        acc[t] = c < h ? u[j * h + c] + acc[t] : INFINITY;
      }
    }
    float bv = acc[0];
    int bc = lane < h ? lane : INT_MAX;
#pragma unroll
    for (int t = 1; t < CPL; ++t) {
      if (acc[t] < bv) {
        bv = acc[t];
        bc = lane + 32 * t;
      }
    }
    warp_argmin(bv, bc);
    __syncwarp();
    if (lane == 0) cur[j] = bc;
    __syncwarp();
  }
  if (lane < m) out_b[static_cast<size_t>(row) * m + lane] = cur[lane];
}

template <int VARIANT, int CPL>
int launch(const void* B, const void* unaries, const void* lut, const void* visits, int n,
           int m, int h, int nvisit, void* out_b, cudaStream_t stream, int smem) {
  cudaError_t err = cudaFuncSetAttribute(icm_sweeps_kernel<VARIANT, CPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kWarps - 1) / kWarps;
  icm_sweeps_kernel<VARIANT, CPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int*>(B), static_cast<const float*>(unaries),
      static_cast<const unsigned short*>(lut), static_cast<const int*>(visits), n, m, h,
      nvisit, static_cast<int*>(out_b));
  return static_cast<int>(cudaGetLastError());
}

template <int VARIANT>
int dispatch(const void* B, const void* unaries, const void* lut, const void* visits, int n,
             int m, int h, int nvisit, void* out_b, void* stream, int smem) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSQ_ICM_LAUNCH(CPL) \
  return launch<VARIANT, CPL>(B, unaries, lut, visits, n, m, h, nvisit, out_b, s, smem)
  if (h <= 32) LSQ_ICM_LAUNCH(1);
  if (h <= 64) LSQ_ICM_LAUNCH(2);
  if (h <= 128) LSQ_ICM_LAUNCH(4);
  if (h <= 256) LSQ_ICM_LAUNCH(8);
  if (h <= 512) LSQ_ICM_LAUNCH(16);
  if (h <= 1024) LSQ_ICM_LAUNCH(32);
#undef LSQ_ICM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int lsq_icm_smem_bytes(int m, int h) { return kWarps * (m * h * 4 + m * 4); }

// Largest h the kernels take (32 candidates per lane).
int lsq_icm_max_h() { return 1024; }

// K5: lut is the j-stacked [m, m*h, h] bf16 table with zeroed (j, j) blocks.
int lsq_icm_sweeps_v2(const void* B, const void* unaries, const void* lut,
                      const void* visits, int n, int m, int h, int nvisit, void* out_b,
                      void* stream) {
  return dispatch<2>(B, unaries, lut, visits, n, m, h, nvisit, out_b, stream,
                     lsq_icm_smem_bytes(m, h));
}

// K6: lut is the [m, m, h, h] bf16 table.
int lsq_icm_sweeps_v1(const void* B, const void* unaries, const void* lut,
                      const void* visits, int n, int m, int h, int nvisit, void* out_b,
                      void* stream) {
  return dispatch<1>(B, unaries, lut, visits, n, m, h, nvisit, out_b, stream,
                     lsq_icm_smem_bytes(m, h));
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
