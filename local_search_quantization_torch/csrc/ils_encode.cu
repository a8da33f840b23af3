// K1: a whole ILS/ICM encode in one launch.
//
// Replaces local_search_quantization_tpu/ops/icm_pallas.py:_ils_kernel_pp
// (and its unpipelined twin _ils_kernel, with the cost helper _mrf_cost),
// launched there through fused_ils_encode. Same function, rethought for an
// H100:
//
// - One warp owns one row for the whole encode: `rounds` x (perturb npert
//   codebooks from the streamed keys/codes -> icmiter*m ICM visits -> MRF
//   cost -> accept only if strictly better, else restore).
// - A visit to codebook j scores all h candidates c; lane l holds the CPL
//   candidates c = l, l+32, ... in registers. Each candidate's score is
//   unaries[j][c] first, then binaries[k][j][B_k][c] for k = 0..m-1, k != j,
//   in that fixed order; the warp's argmin breaks ties to the lowest c.
//   Everything is full float32: the TPU's bf16 visit LUT and hi/lo cost
//   split were workarounds for its matrix unit.
// - The row's unaries ([m, h] f32, 7 KB at m=7, h=256) and codes live in
//   shared memory. The pairwise tables [m, m, h, h] f32 (12.8 MB at m=7,
//   h=256) are too big for shared memory; they stay in device memory and
//   are served from the 50 MB L2.
// - What bounds it: each visit of each row gathers (m-1) table rows of h
//   floats (6 KB at m=7, h=256) from L2. Reads are coalesced 128-byte
//   segments within each gathered row, and a lane's CPL loads of one table
//   row are independent, so CPL loads per lane are in flight at once
//   instead of one.
// - The cost is xsq + (sum of unaries in i order) + pairs (i<j) in row-major
//   order, as cost_from_luts computes it: the lanes load the pair terms in
//   parallel and the sum walks them in that order through shuffles. Dead
//   rows carry xsq = -1e30 and so never accept; that holds only because no
//   sum is reassociated (no fast math, and adds only, so nothing is
//   contracted into an FMA).
// - Perturbation follows the TPU kernel's rule (icm_pallas.py:245-256):
//   npert times, take the argmin key (lowest index on ties), set it to 1e30
//   and write the next perturbation code there.
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

// The MRF cost of `codes`; every lane returns the same value.
__device__ __forceinline__ float mrf_cost(const float* u, const float* __restrict__ bin,
                                          const int* codes, float xsq, int m, int h,
                                          int lane) {
  float s = u[codes[0]];
  for (int i = 1; i < m; ++i) s += u[i * h + codes[i]];
  float total = xsq + s;
  const int npairs = m * (m - 1) / 2;
  for (int base = 0; base < npairs; base += 32) {
    // Lane `lane` loads pair base + lane of the row-major (i<j) order.
    float v = 0.0f;
    int p = base + lane;
    if (p < npairs) {
      int i = 0;
      while (p >= m - 1 - i) {
        p -= m - 1 - i;
        ++i;
      }
      const int j = i + 1 + p;
      v = __ldg(&bin[((static_cast<size_t>(i) * m + j) * h + codes[i]) * h + codes[j]]);
    }
    const int cnt = min(32, npairs - base);
    for (int q = 0; q < cnt; ++q) total += __shfl_sync(kFull, v, q);
  }
  return total;
}

template <int CPL>
__global__ void __launch_bounds__(kWarps * 32)
ils_kernel(const float* __restrict__ unaries, const float* __restrict__ bin,
           const float* __restrict__ xsq, const int* __restrict__ B0,
           const int* __restrict__ orders, const float* __restrict__ pkeys,
           const int* __restrict__ pcodes, const int* __restrict__ ms_rounds,
           int n, int m, int h, int rounds, int icmiter, int npert, int n_ms,
           int* __restrict__ out_b, float* __restrict__ out_cost,
           int* __restrict__ ms_b, float* __restrict__ ms_cost, int* __restrict__ stats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warp; only __syncwarp is used below
  const int mh = m * h;
  float* u = smem + warp * mh;
  int* cur = reinterpret_cast<int*>(smem + kWarps * mh) + warp * 2 * m;
  int* best = cur + m;

  const float* urow = unaries + static_cast<size_t>(row) * mh;
  for (int e = lane; e < mh; e += 32) u[e] = urow[e];
  if (lane < m) {
    const int c = B0[static_cast<size_t>(row) * m + lane];
    cur[lane] = c;
    best[lane] = c;
  }
  __syncwarp();
  const float x2 = xsq[row];
  float best_cost = mrf_cost(u, bin, best, x2, m, h, lane);

  for (int r = 0; r < rounds; ++r) {
    // --- perturb: cur == best here ---
    float key = lane < m ? pkeys[(static_cast<size_t>(r) * n + row) * m + lane] : INFINITY;
    for (int p = 0; p < npert; ++p) {
      float v = key;
      int pos = lane;
      warp_argmin(v, pos);
      if (lane == pos) {
        key = 1e30f;
        cur[pos] = pcodes[(static_cast<size_t>(r) * n + row) * npert + p];
      }
      __syncwarp();
    }

    // --- ICM sweeps in this round's visit order ---
    const int* ord = orders + static_cast<size_t>(r) * m;
    for (int it = 0; it < icmiter; ++it) {
      for (int s = 0; s < m; ++s) {
        const int j = ord[s];
        float acc[CPL];
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int c = lane + 32 * t;
          acc[t] = c < h ? u[j * h + c] : INFINITY;
        }
        for (int k = 0; k < m; ++k) {
          if (k == j) continue;
          const float* brow = bin + ((static_cast<size_t>(k) * m + j) * h + cur[k]) * h;
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int c = lane + 32 * t;
            if (c < h) acc[t] += __ldg(&brow[c]);
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
    }

    // --- accept if strictly better, else restore ---
    const float newcost = mrf_cost(u, bin, cur, x2, m, h, lane);
    const bool better = newcost < best_cost;
    if (stats != nullptr && lane == 0) {
      if (better) atomicAdd(&stats[2 * r], 1);
      if (newcost == best_cost) atomicAdd(&stats[2 * r + 1], 1);
    }
    __syncwarp();
    if (lane < m) {
      if (better)
        best[lane] = cur[lane];
      else
        cur[lane] = best[lane];
    }
    if (better) best_cost = newcost;
    __syncwarp();
    for (int s = 0; s < n_ms; ++s) {
      if (ms_rounds[s] == r) {
        if (lane < m) ms_b[(static_cast<size_t>(s) * n + row) * m + lane] = best[lane];
        if (lane == 0) ms_cost[static_cast<size_t>(s) * n + row] = best_cost;
      }
    }
  }
  if (lane < m) out_b[static_cast<size_t>(row) * m + lane] = best[lane];
  if (lane == 0) out_cost[row] = best_cost;
}

template <int CPL>
int launch(const void* unaries, const void* bin, const void* xsq, const void* B0,
           const void* orders, const void* pkeys, const void* pcodes, const void* ms_rounds,
           int n, int m, int h, int rounds, int icmiter, int npert, int n_ms, void* out_b,
           void* out_cost, void* ms_b, void* ms_cost, void* stats, cudaStream_t stream,
           int smem) {
  cudaError_t err = cudaFuncSetAttribute(ils_kernel<CPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kWarps - 1) / kWarps;
  ils_kernel<CPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(unaries), static_cast<const float*>(bin),
      static_cast<const float*>(xsq), static_cast<const int*>(B0),
      static_cast<const int*>(orders), static_cast<const float*>(pkeys),
      static_cast<const int*>(pcodes), static_cast<const int*>(ms_rounds), n, m, h, rounds,
      icmiter, npert, n_ms, static_cast<int*>(out_b), static_cast<float*>(out_cost),
      static_cast<int*>(ms_b), static_cast<float*>(ms_cost), static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lsq_ils_smem_bytes(int m, int h) {
  return kWarps * (m * h * 4 + 2 * m * 4);
}

// Largest h the kernel takes (32 candidates per lane).
int lsq_ils_max_h() { return 1024; }

int lsq_ils_encode(const void* unaries, const void* bin, const void* xsq, const void* B0,
                   const void* orders, const void* pkeys, const void* pcodes,
                   const void* ms_rounds, int n, int m, int h, int rounds, int icmiter,
                   int npert, int n_ms, void* out_b, void* out_cost, void* ms_b,
                   void* ms_cost, void* stats, void* stream) {
  const int smem = lsq_ils_smem_bytes(m, h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSQ_ILS_LAUNCH(CPL)                                                                  \
  return launch<CPL>(unaries, bin, xsq, B0, orders, pkeys, pcodes, ms_rounds, n, m, h,       \
                     rounds, icmiter, npert, n_ms, out_b, out_cost, ms_b, ms_cost, stats, s, \
                     smem)
  if (h <= 32) LSQ_ILS_LAUNCH(1);
  if (h <= 64) LSQ_ILS_LAUNCH(2);
  if (h <= 128) LSQ_ILS_LAUNCH(4);
  if (h <= 256) LSQ_ILS_LAUNCH(8);
  if (h <= 512) LSQ_ILS_LAUNCH(16);
  if (h <= 1024) LSQ_ILS_LAUNCH(32);
#undef LSQ_ILS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
