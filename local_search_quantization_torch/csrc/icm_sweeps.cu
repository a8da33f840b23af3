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
// What bounds it on this card: each visit of each row gathers m-1 rows of the
// bf16 table (512 B each at h=256; the 6.4 MB table stays in the 50 MB L2),
// 11.3 GB over n=131072 rows and 4 sweeps, which L2 serves at 6.2 TB/s for
// 16-byte loads and at 4.1 TB/s for one element a lane (csrc/l2_probe.cu).
// The first port read a row as eight 2-byte loads a lane (lane l held
// c = l, l+32, ...), 64 B a warp-level load, with one register pair for them,
// so most of a row's loads waited for the add before them: 1.6 TB/s.
//
// Design: one warp owns one row for all icmiter*m visits. The row's unaries
// ([m, h] f32, 7 KB at m=7, h=256) and codes live in shared memory. Lane l
// holds the CPL consecutive candidates c = l*CPL + t in registers, so its
// share of a table row is one 16-byte load at CPL 8 (two at 16, four at 32,
// 8 and 4 bytes at CPL 4 and 2), neighbouring lanes on neighbouring
// addresses: 512 B a warp-level load. A visit issues the loads of all its
// m-1 rows (kRowsInFlight at a time where m is larger) into registers of
// their own before the first add, so they are in flight together: one L2
// round trip a visit instead of one a load. The lane reads its unaries from
// shared memory as float4s. Where h is no multiple of CPL (rows are then not
// 16-byte aligned, and a lane's candidates straddle h) the VEC = false
// instantiation loads element by element with a masked tail. Each
// candidate's sum keeps its order (K5: pair rows in k order, then the unary;
// K6: the unary, then k order), adds only and no fast math, and a lane scans
// its candidates upward before warp_argmin compares indices, so ties go to
// the lowest c and the plain PyTorch version (fused_icm_sweeps_reference)
// gives the same codes bit for bit.
//
// Chosen not to: load the next visit's rows across the visit boundary, or
// keep only the visited codebook's unaries in shared memory so that more than
// 28 warps an SM fit (a row's 7 KB of unaries set that number). With the
// packed loads the kernel takes within a tenth of the time in which the L2
// gather probe moves the same 11.3 GB (1.95 ms against 1.83 on an H100), so
// neither the loads' round trips nor the occupancy sets its time any more,
// and both would add registers or traffic for nothing.
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

// Candidate t of a lane: the CPL consecutive candidates from lane * CPL.
template <int CPL>
__device__ __forceinline__ int cand(int lane, int t) {
  return lane * CPL + t;
}

// A lane's share of one bf16 table row, in registers: CPL/2 words of two
// values each when loaded by vector loads, one word a value otherwise.
template <int CPL, bool VEC>
struct RowRegs {
  static constexpr int kWords = VEC ? CPL / 2 : CPL;
  uint32_t w[kWords];
  __device__ __forceinline__ float value(int t) const {
    if constexpr (VEC) {
      const uint32_t x = w[t >> 1];
      return __uint_as_float((t & 1) ? (x & 0xffff0000u) : (x << 16));
    } else {
      return __uint_as_float(w[t] << 16);
    }
  }
};

// Table rows a visit keeps in flight at once: all m-1 up to 8, fewer where a
// row takes many registers.
template <int CPL, bool VEC>
struct RowsInFlight {
  static constexpr int kByRegs = 32 / RowRegs<CPL, VEC>::kWords;
  static constexpr int value = kByRegs > 8 ? 8 : (kByRegs < 1 ? 1 : kByRegs);
};

// Load a lane's share of table row r; candidates at or past h read as 0.
template <int CPL, bool VEC>
__device__ __forceinline__ void load_row(const unsigned short* __restrict__ r, int lane, int h,
                                         RowRegs<CPL, VEC>& row) {
  if constexpr (VEC) {
    // h % CPL == 0: a lane is whole or idle, and r + lane*CPL is aligned
    // to the load's width.
    const unsigned short* p = r + lane * CPL;
    const bool live = lane * CPL < h;
    if constexpr (CPL == 2) {
      row.w[0] = live ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
    } else if constexpr (CPL == 4) {
      const uint2 v = live ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
      row.w[0] = v.x;
      row.w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < CPL / 8; ++i) {
        const uint4 v = live ? __ldg(reinterpret_cast<const uint4*>(p) + i)
                             : make_uint4(0u, 0u, 0u, 0u);
        row.w[4 * i] = v.x;
        row.w[4 * i + 1] = v.y;
        row.w[4 * i + 2] = v.z;
        row.w[4 * i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = cand<CPL>(lane, t);
      row.w[t] = c < h ? static_cast<uint32_t>(__ldg(&r[c])) : 0u;
    }
  }
}

// A lane's unaries of codebook j from shared memory; +inf at or past h.
template <int CPL, bool VEC>
__device__ __forceinline__ void load_unaries(const float* uj, int lane, int h,
                                             float (&uv)[CPL]) {
  if constexpr (VEC && CPL >= 4) {
    const bool live = lane * CPL < h;
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) {
      const float4 v = live ? *reinterpret_cast<const float4*>(uj + lane * CPL + 4 * i)
                            : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      uv[4 * i] = v.x;
      uv[4 * i + 1] = v.y;
      uv[4 * i + 2] = v.z;
      uv[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = cand<CPL>(lane, t);
      uv[t] = c < h ? uj[c] : INFINITY;
    }
  }
}

// VARIANT 2: K5 (j-stacked table, pair rows first, then the unary).
// VARIANT 1: K6 ([m, m, h, h] table, unary first).
template <int VARIANT, int CPL, int DISSECT, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
icm_sweeps_kernel(const int* __restrict__ B, const float* __restrict__ unaries,
                  const unsigned short* __restrict__ lut, const int* __restrict__ visits,
                  int n, int m, int h, int nvisit, int* __restrict__ out_b,
                  float* __restrict__ sink) {
  static_assert(DISSECT == kProduction || VARIANT == 2, "K7 dissects K5's visit");
  static_assert(!VEC || CPL >= 2, "vector loads need two candidates a lane");
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warp; only __syncwarp is used below
  const int mh = m * h;
  float* u = smem + warp * mh;
  int* cur = reinterpret_cast<int*>(smem + kWarps * mh) + warp * m;

  // The unaries are read once: streaming loads, so they do not evict the table.
  const float* urow = unaries + static_cast<size_t>(row) * mh;
  if constexpr (VEC && CPL >= 4) {  // h % 4 == 0: rows of mh floats are 16-byte aligned
    for (int e = lane; e < mh / 4; e += 32)
      reinterpret_cast<float4*>(u)[e] = __ldcs(reinterpret_cast<const float4*>(urow) + e);
  } else {
    for (int e = lane; e < mh; e += 32)
      u[e] = __ldcs(&urow[e]);
  }
  if (lane < m) cur[lane] = B[static_cast<size_t>(row) * m + lane];
  __syncwarp();

  float lane_sum = 0.0f;  // kMmOnly, kNoArgmin: this lane's scores, summed
  int code_sum = 0;       // kNoWrite: the argmin codes, summed
  for (int s = 0; s < nvisit; ++s) {
    const int j = __ldg(&visits[s]);
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(m)) continue;
    float acc[CPL];
    constexpr int kRows = RowsInFlight<CPL, VEC>::value;
    float uv[CPL];  // +inf at or past h, so those candidates never win
    load_unaries<CPL, VEC>(u + j * h, lane, h, uv);
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[t] = VARIANT == 1 ? uv[t] : 0.0f;
    // The visit's m-1 rows are those of k = kk + (kk >= j), kk = 0..m-2,
    // in k order; kRows of them are loaded before any is added.
    for (int kk0 = 0; kk0 < m - 1; kk0 += kRows) {
      RowRegs<CPL, VEC> rows[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kk = kk0 + i;
        if (kk < m - 1) {
          const int k = kk + (kk >= j);
          const unsigned short* r =
              VARIANT == 2
                  ? lut + (static_cast<size_t>(j) * mh + static_cast<size_t>(k) * h + cur[k]) * h
                  : lut + ((static_cast<size_t>(k) * m + j) * h + cur[k]) * h;
          load_row<CPL, VEC>(r, lane, h, rows[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (kk0 + i < m - 1) {
#pragma unroll
          for (int t = 0; t < CPL; ++t) acc[t] += rows[i].value(t);
        }
      }
    }
    if constexpr (VARIANT == 2) {
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[t] = uv[t] + acc[t];
    }
    if constexpr (DISSECT == kMmOnly || DISSECT == kNoArgmin) {
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        if (cand<CPL>(lane, t) < h) lane_sum += acc[t];
      }
      if constexpr (DISSECT == kNoArgmin) {
        __syncwarp();
        if (lane == 0) cur[j] = 3;
        __syncwarp();
      }
      continue;
    }
    // A lane's candidates ascend with t, so a strict < keeps its lowest c.
    float bv = acc[0];
    int bc = cand<CPL>(lane, 0) < h ? cand<CPL>(lane, 0) : INT_MAX;
#pragma unroll
    for (int t = 1; t < CPL; ++t) {
      if (acc[t] < bv) {
        bv = acc[t];
        bc = cand<CPL>(lane, t);
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

template <int VARIANT, int CPL, int DISSECT, bool VEC>
int launch(const void* B, const void* unaries, const void* lut, const void* visits, int n,
           int m, int h, int nvisit, void* out_b, void* sink, cudaStream_t stream,
           int smem) {
  auto kernel = icm_sweeps_kernel<VARIANT, CPL, DISSECT, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kWarps - 1) / kWarps;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int*>(B), static_cast<const float*>(unaries),
      static_cast<const unsigned short*>(lut), static_cast<const int*>(visits), n, m, h,
      nvisit, static_cast<int*>(out_b), static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

// Vector loads where every row of the table and of the unaries starts on a
// 16-byte boundary and a lane's candidates never straddle h.
inline bool can_vec(const void* unaries, const void* lut, int h, int cpl) {
  return cpl >= 2 && h % cpl == 0 && reinterpret_cast<uintptr_t>(unaries) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(lut) % 16 == 0;
}

template <int VARIANT, int DISSECT = kProduction>
int dispatch(const void* B, const void* unaries, const void* lut, const void* visits, int n,
             int m, int h, int nvisit, void* out_b, void* sink, void* stream, int smem) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSQ_ICM_LAUNCH(CPL)                                                                 \
  return can_vec(unaries, lut, h, CPL)                                                      \
             ? launch<VARIANT, CPL, DISSECT, true>(B, unaries, lut, visits, n, m, h, nvisit, \
                                                   out_b, sink, s, smem)                    \
             : launch<VARIANT, CPL, DISSECT, false>(B, unaries, lut, visits, n, m, h,       \
                                                    nvisit, out_b, sink, s, smem)
  if (h <= 32)  // one candidate a lane: nothing to vectorise
    return launch<VARIANT, 1, DISSECT, false>(B, unaries, lut, visits, n, m, h, nvisit, out_b,
                                              sink, s, smem);
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

// 16-byte aligned per row of the block where m*h is a multiple of 4.
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
