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
//
// K7: timing dissections of K5's visit (replaces
// benchmarks/bench_kernel_variants.py:kernel, entry point
// lsq_icm_sweeps_dissect). The same kernel with a DISSECT switch that takes
// parts of the visit out, on K5's j-stacked table: kWhole ("full") is K5's
// function, kPredWrite writes the new code through m predicated stores (the
// TPU body's pl.when(j == jj) writes), kNoWrite never writes the state, kNoArgmin
// writes code 3 in place of the argmin, kMmOnly keeps the table sum alone.
// Where a part is taken out, what is left would feed nothing and nvcc would
// delete it, so each variant writes a per-row f32 sink that keeps its work
// live: kMmOnly and kNoArgmin each lane's running sum of its scores over
// the visits, reduced once per row at the end; kNoWrite the sum of the
// argmin codes; kWhole and kPredWrite 0. kProduction (K5, K6) writes no sink
// and compiles to the code it compiled to before the switch existed.
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

// K7's switches; kProduction is K5 and K6 as they run on the encode path.
enum Dissect { kProduction, kWhole, kPredWrite, kNoWrite, kNoArgmin, kMmOnly };

// VARIANT 2: K5 (j-stacked table, pair rows first, then the unary).
// VARIANT 1: K6 ([m, m, h, h] table, unary first).
template <int VARIANT, int CPL, int DISSECT = kProduction>
__global__ void __launch_bounds__(kWarps * 32)
icm_sweeps_kernel(const int* __restrict__ B, const float* __restrict__ unaries,
                  const unsigned short* __restrict__ lut, const int* __restrict__ visits,
                  int n, int m, int h, int nvisit, int* __restrict__ out_b,
                  float* __restrict__ sink) {
  static_assert(DISSECT == kProduction || VARIANT == 2, "K7 dissects K5's visit");
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

  float lane_sum = 0.0f;  // kMmOnly, kNoArgmin: this lane's scores, summed
  int code_sum = 0;       // kNoWrite: the argmin codes, summed
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
    if constexpr (DISSECT == kMmOnly || DISSECT == kNoArgmin) {
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        if (lane + 32 * t < h) lane_sum += acc[t];
      }
      if constexpr (DISSECT == kNoArgmin) {
        __syncwarp();
        if (lane == 0) cur[j] = 3;
        __syncwarp();
      }
      continue;
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
    if constexpr (DISSECT == kNoWrite) {
      code_sum += bc;
      continue;
    }
    __syncwarp();
    if constexpr (DISSECT == kPredWrite) {
      if (lane == 0) {
        for (int jj = 0; jj < m; ++jj) {
          if (j == jj) cur[jj] = bc;
        }
      }
    } else {
      if (lane == 0) cur[j] = bc;
    }
    __syncwarp();
  }
  if (lane < m) out_b[static_cast<size_t>(row) * m + lane] = cur[lane];
  if constexpr (DISSECT != kProduction) {
    float v = DISSECT == kNoWrite ? static_cast<float>(code_sum) : 0.0f;
    if constexpr (DISSECT == kMmOnly || DISSECT == kNoArgmin) {
      v = lane_sum;
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    }
    if (lane == 0) sink[row] = v;
  }
}

template <int VARIANT, int CPL, int DISSECT>
int launch(const void* B, const void* unaries, const void* lut, const void* visits, int n,
           int m, int h, int nvisit, void* out_b, void* sink, cudaStream_t stream,
           int smem) {
  cudaError_t err = cudaFuncSetAttribute(icm_sweeps_kernel<VARIANT, CPL, DISSECT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kWarps - 1) / kWarps;
  icm_sweeps_kernel<VARIANT, CPL, DISSECT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int*>(B), static_cast<const float*>(unaries),
      static_cast<const unsigned short*>(lut), static_cast<const int*>(visits), n, m, h,
      nvisit, static_cast<int*>(out_b), static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

template <int VARIANT, int DISSECT = kProduction>
int dispatch(const void* B, const void* unaries, const void* lut, const void* visits, int n,
             int m, int h, int nvisit, void* out_b, void* sink, void* stream, int smem) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSQ_ICM_LAUNCH(CPL)                                                                  \
  return launch<VARIANT, CPL, DISSECT>(B, unaries, lut, visits, n, m, h, nvisit, out_b, sink, \
                                       s, smem)
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
  return dispatch<2>(B, unaries, lut, visits, n, m, h, nvisit, out_b, nullptr, stream,
                     lsq_icm_smem_bytes(m, h));
}

// K6: lut is the [m, m, h, h] bf16 table.
int lsq_icm_sweeps_v1(const void* B, const void* unaries, const void* lut,
                      const void* visits, int n, int m, int h, int nvisit, void* out_b,
                      void* stream) {
  return dispatch<1>(B, unaries, lut, visits, n, m, h, nvisit, out_b, nullptr, stream,
                     lsq_icm_smem_bytes(m, h));
}

// K7: variant 0 full, 1 predwrite, 2 nowrite, 3 noargmin, 4 mmonly, on K5's
// j-stacked table; sink is [n] f32 (see the head of this file).
int lsq_icm_sweeps_dissect(int variant, const void* B, const void* unaries, const void* lut,
                           const void* visits, int n, int m, int h, int nvisit, void* out_b,
                           void* sink, void* stream) {
  const int smem = lsq_icm_smem_bytes(m, h);
#define LSQ_ICM_DISSECT(V, D) \
  case V:                     \
    return dispatch<2, D>(B, unaries, lut, visits, n, m, h, nvisit, out_b, sink, stream, smem)
  switch (variant) {
    LSQ_ICM_DISSECT(0, kWhole);
    LSQ_ICM_DISSECT(1, kPredWrite);
    LSQ_ICM_DISSECT(2, kNoWrite);
    LSQ_ICM_DISSECT(3, kNoArgmin);
    LSQ_ICM_DISSECT(4, kMmOnly);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LSQ_ICM_DISSECT
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
