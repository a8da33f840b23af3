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
// - A visit to codebook j scores all h candidates c; each lane holds CPL of
//   them in registers (the lane map is below). Each candidate's score is
//   unaries[j][c] first, then binaries[k][j][B_k][c] for k = 0..m-1, k != j,
//   in that fixed order; the warp's argmin breaks ties to the lowest c.
//   Everything is full float32: the TPU's bf16 visit LUT and hi/lo cost
//   split were workarounds for its matrix unit.
// - The row's unaries ([m, h] f32, 7 KB at m=7, h=256) live in shared
//   memory; its codes live in registers, lane k < m holding code k (the
//   current and the best). The pairwise tables [m, m, h, h] f32 (12.8 MB at
//   m=7, h=256) are too big for shared memory; they stay in device memory
//   and are served from the 50 MB L2.
// - The cost is xsq + (sum of unaries in i order) + pairs (i<j) in row-major
//   order, as cost_from_luts computes it: the lanes load the pair terms in
//   parallel and the sum walks them in that order through shuffles. Dead
//   rows carry xsq = -1e30 and so never accept; that holds only because no
//   sum is reassociated (no fast math, and adds only, so nothing is
//   contracted into an FMA).
// - Perturbation follows the TPU kernel's rule (icm_pallas.py:245-256):
//   npert times, take the argmin key (lowest index on ties), set it to 1e30
//   and write the next perturbation code there.
//
// What bounds it on this card: each visit of each row gathers m-1 rows of h
// floats (1 KB each at h=256) from L2, 90.2 GB at n=131072, 4 rounds,
// icmiter=4, which L2 serves at 7.6 TB/s for one element a lane and at 6.6
// TB/s for 16 bytes a lane (csrc/l2_probe.cu): 11.8 ms. The first port's
// visit looped k = 0..m-1 with a runtime bound, each iteration reading
// cur[k] from shared memory and then issuing its row's loads, so a visit
// waited for L2 m-1 times in a row (19.6 ms).
//
// Design:
// - One L2 round trip a visit: a visit forms its m-1 row addresses from the
//   codes by shuffles (no shared-memory read in a load's address) and loads
//   all m-1 rows (RowsInFlight at a time where a row takes many registers)
//   into registers of their own before the first add. The adds then walk k
//   in order, so each candidate's sum is the same as before.
// - Lane map: lane l holds the CPL consecutive candidates c = l*CPL + t
//   (PACKED), so its share of a row is CPL/4 16-byte loads and its unaries
//   CPL/4 float4s from shared memory. The probe serves 1 KB f32 rows faster
//   one element a lane (c = l + 32t), but that build needs 142-146
//   registers at CPL 8 against 96-108 (a predicate and an address a
//   candidate), so fewer warps fit an SM and it was 1.3-1.4x slower on an
//   H100 (chip_smoke.py phase 2). Where h is no multiple of CPL (a lane's
//   candidates would straddle h), where CPL < 4, or where the table is not
//   16-byte aligned, the kernel takes that element map with a masked tail.
// - Skip the visits whose inputs did not change: a visit to j reads no code
//   of j's own, so if no other code changed since j's last visit in this
//   round its scores are the same floats in the same order and its argmin
//   is the code j holds. Each row keeps an m-bit mask `need` (the same in
//   every lane: the warp owns the row): every bit set after the
//   perturbation, bit j cleared when j is visited, and every other bit set
//   when the visit changes code j. A visit whose bit is clear issues no
//   load and writes nothing. No output changes by a bit; the plain version
//   (ils_encode_streamed_reference) does every visit, and
//   icm_kernels.ils_visits_needed counts the visits the mask keeps.
// - Only the table rows of a visit are loaded through the read-only path
//   (__ldg, LDG.E.CONSTANT in the SASS); the once-read inputs stream
//   (__ldcs) and the cost's pair terms and the visit orders go through L2
//   (__ldcg), so chip_smoke.py can find a visit's row loads in the SASS.
//
// Chosen not to: issue the next visit's rows before the current argmin
// finishes. It would take another m-2 rows of registers a lane, and with
// the two steps above K1 takes within a few percent of the time in which L2
// serves the rows of the visits it needs (chip_smoke.py phases 2 and 2d).
//
// STEP keeps the stages of the redesign as builds of the one template
// (entry point lsq_ils_encode_step, a measurement tool on no path):
// kPresent is the first port's visit loop (one row's loads, then its adds,
// k by k), kHoisted a visit's rows in flight together, kSkip the same with
// the mask, which is what lsq_ils_encode runs; each hoisted stage is built
// with both lane maps.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr unsigned kFull = 0xffffffffu;

// The stages of the redesign (see the head of this file); kSkip runs.
enum Step { kPresent, kHoisted, kSkip };

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

// Code i of the row: lane i holds it.
__device__ __forceinline__ int code_of(int code, int i) { return __shfl_sync(kFull, code, i); }

// The MRF cost of the codes lanes 0..m-1 hold; every lane returns the same value.
__device__ __forceinline__ float mrf_cost(const float* u, const float* __restrict__ bin, int code,
                                          float xsq, int m, int h, int lane) {
  float s = u[code_of(code, 0)];
  for (int i = 1; i < m; ++i) s += u[i * h + code_of(code, i)];
  float total = xsq + s;
  const int npairs = m * (m - 1) / 2;
  for (int base = 0; base < npairs; base += 32) {
    // Lane `lane` loads pair base + lane of the row-major (i<j) order.
    int p = base + lane;
    const bool live = p < npairs;
    int i = 0;
    if (live) {
      while (p >= m - 1 - i) {
        p -= m - 1 - i;
        ++i;
      }
    }
    const int j = live ? i + 1 + p : 0;
    const int ci = __shfl_sync(kFull, code, i);
    const int cj = __shfl_sync(kFull, code, j);
    const float v =
        live ? __ldcg(&bin[((static_cast<size_t>(i) * m + j) * h + ci) * h + cj]) : 0.0f;
    const int cnt = min(32, npairs - base);
    for (int q = 0; q < cnt; ++q) total += __shfl_sync(kFull, v, q);
  }
  return total;
}

// Candidate t of a lane: strided by 32, or consecutive (PACKED).
template <int CPL, bool PACKED>
__device__ __forceinline__ int cand(int lane, int t) {
  return PACKED ? lane * CPL + t : lane + 32 * t;
}

// Table rows a visit keeps in flight at once: all m-1 up to 8, fewer where
// a row takes many registers (64 registers of rows a lane at most).
template <int CPL, int STEP>
struct RowsInFlight {
  static constexpr int value = STEP == kPresent ? 1 : (64 / CPL > 8 ? 8 : 64 / CPL);
};

// Load a lane's share of table row r; candidates at or past h read as 0.
template <int CPL, bool PACKED>
__device__ __forceinline__ void load_row(const float* __restrict__ r, int lane, int h,
                                         float (&row)[CPL]) {
  if constexpr (PACKED) {
    // h % CPL == 0: a lane is whole or idle, and r + lane*CPL is 16-byte aligned.
    const bool live = lane * CPL < h;
#pragma unroll
    for (int i = 0; i < CPL / 4; ++i) {
      const float4 v = live ? __ldg(reinterpret_cast<const float4*>(r + lane * CPL) + i)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      row[4 * i] = v.x;
      row[4 * i + 1] = v.y;
      row[4 * i + 2] = v.z;
      row[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = cand<CPL, false>(lane, t);
      row[t] = c < h ? __ldg(&r[c]) : 0.0f;
    }
  }
}

template <int CPL, int STEP, bool PACKED>
__global__ void __launch_bounds__(kWarps * 32)
ils_kernel(const float* __restrict__ unaries, const float* __restrict__ bin,
           const float* __restrict__ xsq, const int* __restrict__ B0,
           const int* __restrict__ orders, const float* __restrict__ pkeys,
           const int* __restrict__ pcodes, const int* __restrict__ ms_rounds,
           int n, int m, int h, int rounds, int icmiter, int npert, int n_ms,
           int* __restrict__ out_b, float* __restrict__ out_cost,
           int* __restrict__ ms_b, float* __restrict__ ms_cost, int* __restrict__ stats) {
  static_assert(!PACKED || (CPL >= 4 && STEP != kPresent), "16-byte loads need 4+ a lane");
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // whole warp; only __syncwarp is used below
  const int mh = m * h;
  float* u = smem + warp * mh;
  const unsigned all = m == 32 ? kFull : (1u << m) - 1u;

  // The unaries are read once: streaming loads, so they do not evict the table.
  const float* urow = unaries + static_cast<size_t>(row) * mh;
  for (int e = lane; e < mh; e += 32) u[e] = __ldcs(&urow[e]);
  int code = lane < m ? __ldcs(&B0[static_cast<size_t>(row) * m + lane]) : 0;
  int best = code;
  __syncwarp();
  const float x2 = __ldcs(&xsq[row]);
  float best_cost = mrf_cost(u, bin, best, x2, m, h, lane);

  for (int r = 0; r < rounds; ++r) {
    // --- perturb: code == best here ---
    const size_t rr = static_cast<size_t>(r) * n + row;
    float key = lane < m ? __ldcs(&pkeys[rr * m + lane]) : INFINITY;
    const int pc = lane < npert ? __ldcs(&pcodes[rr * npert + lane]) : 0;
    for (int p = 0; p < npert; ++p) {
      float v = key;
      int pos = lane;
      warp_argmin(v, pos);
      const int next = __shfl_sync(kFull, pc, p);
      if (lane == pos) {
        key = 1e30f;
        code = next;
      }
    }
    unsigned need = all;  // kSkip: the visits whose inputs changed

    // --- ICM sweeps in this round's visit order (lane s holds visit s) ---
    const int ord = lane < m ? __ldcg(&orders[r * m + lane]) : 0;
    for (int it = 0; it < icmiter; ++it) {
      for (int s = 0; s < m; ++s) {
        const int j = __shfl_sync(kFull, ord, s);
        if constexpr (STEP == kSkip) {
          if (!((need >> j) & 1u)) continue;
        }
        float acc[CPL];
        if constexpr (PACKED) {
          const bool live = lane * CPL < h;
#pragma unroll
          for (int i = 0; i < CPL / 4; ++i) {
            const float4 v = live ? *reinterpret_cast<const float4*>(u + j * h + lane * CPL + 4 * i)
                                  : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
            acc[4 * i] = v.x;
            acc[4 * i + 1] = v.y;
            acc[4 * i + 2] = v.z;
            acc[4 * i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int c = cand<CPL, false>(lane, t);
            acc[t] = c < h ? u[j * h + c] : INFINITY;
          }
        }
        if constexpr (STEP == kPresent) {
          // The first port's loop: one row's loads, then its adds, k by k.
          for (int k = 0; k < m; ++k) {
            const int ck = code_of(code, k);
            if (k == j) continue;
            const float* brow = bin + ((static_cast<size_t>(k) * m + j) * h + ck) * h;
#pragma unroll
            for (int t = 0; t < CPL; ++t) {
              const int c = lane + 32 * t;
              if (c < h) acc[t] += __ldg(&brow[c]);
            }
          }
        } else {
          constexpr int kRows = RowsInFlight<CPL, STEP>::value;
          // The visit's m-1 rows are those of k = kk + (kk >= j), kk = 0..m-2,
          // in k order; kRows of them are loaded before any is added.
          for (int kk0 = 0; kk0 < m - 1; kk0 += kRows) {
            float rows[kRows][CPL];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const int kk = kk0 + i;
              const int k = kk + (kk >= j);
              const int ck = code_of(code, k & 31);
              if (kk < m - 1)
                load_row<CPL, PACKED>(bin + ((static_cast<size_t>(k) * m + j) * h + ck) * h,
                                      lane, h, rows[i]);
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              if (kk0 + i < m - 1) {
#pragma unroll
                for (int t = 0; t < CPL; ++t) acc[t] += rows[i][t];
              }
            }
          }
        }
        // A lane's candidates ascend with t, so a strict < keeps its lowest c.
        float bv = acc[0];
        int bc = cand<CPL, PACKED>(lane, 0) < h ? cand<CPL, PACKED>(lane, 0) : INT_MAX;
#pragma unroll
        for (int t = 1; t < CPL; ++t) {
          if (acc[t] < bv) {
            bv = acc[t];
            bc = cand<CPL, PACKED>(lane, t);
          }
        }
        warp_argmin(bv, bc);
        if constexpr (STEP == kSkip) {
          need &= ~(1u << j);
          if (bc != code_of(code, j)) need |= all & ~(1u << j);
        }
        if (lane == j) code = bc;
      }
    }

    // --- accept if strictly better, else restore ---
    const float newcost = mrf_cost(u, bin, code, x2, m, h, lane);
    const bool better = newcost < best_cost;
    if (stats != nullptr && lane == 0) {
      if (better) atomicAdd(&stats[2 * r], 1);
      if (newcost == best_cost) atomicAdd(&stats[2 * r + 1], 1);
    }
    if (better) {
      best = code;
      best_cost = newcost;
    } else {
      code = best;
    }
    for (int s = 0; s < n_ms; ++s) {
      if (__ldcg(&ms_rounds[s]) == r) {
        if (lane < m) ms_b[(static_cast<size_t>(s) * n + row) * m + lane] = best;
        if (lane == 0) ms_cost[static_cast<size_t>(s) * n + row] = best_cost;
      }
    }
  }
  if (lane < m) out_b[static_cast<size_t>(row) * m + lane] = best;
  if (lane == 0) out_cost[row] = best_cost;
}

template <int CPL, int STEP, bool PACKED>
int launch(const void* unaries, const void* bin, const void* xsq, const void* B0,
           const void* orders, const void* pkeys, const void* pcodes, const void* ms_rounds,
           int n, int m, int h, int rounds, int icmiter, int npert, int n_ms, void* out_b,
           void* out_cost, void* ms_b, void* ms_cost, void* stats, cudaStream_t stream,
           int smem) {
  auto kernel = ils_kernel<CPL, STEP, PACKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kWarps - 1) / kWarps;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
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

// The rows' unaries: [m, h] f32 for each of the block's rows.
int lsq_ils_smem_bytes(int m, int h) { return kWarps * m * h * 4; }

// Largest h the kernel takes (32 candidates per lane).
int lsq_ils_max_h() { return 1024; }

#define LSQ_ILS_ARGS                                                                       \
  unaries, bin, xsq, B0, orders, pkeys, pcodes, ms_rounds, n, m, h, rounds, icmiter, npert, \
      n_ms, out_b, out_cost, ms_b, ms_cost, stats, static_cast<cudaStream_t>(stream),      \
      lsq_ils_smem_bytes(m, h)

// 16 bytes a lane where a lane's candidates never straddle h and every
// table row starts on a 16-byte boundary.
inline bool can_pack(const void* bin, int h, int cpl) {
  return cpl >= 4 && h % cpl == 0 && reinterpret_cast<uintptr_t>(bin) % 16 == 0;
}

int lsq_ils_encode(const void* unaries, const void* bin, const void* xsq, const void* B0,
                   const void* orders, const void* pkeys, const void* pcodes,
                   const void* ms_rounds, int n, int m, int h, int rounds, int icmiter,
                   int npert, int n_ms, void* out_b, void* out_cost, void* ms_b,
                   void* ms_cost, void* stats, void* stream) {
#define LSQ_ILS_LAUNCH(CPL)                                                   \
  return can_pack(bin, h, CPL) ? launch<CPL, kSkip, true>(LSQ_ILS_ARGS) \
                               : launch<CPL, kSkip, false>(LSQ_ILS_ARGS)
  if (h <= 32) return launch<1, kSkip, false>(LSQ_ILS_ARGS);
  if (h <= 64) return launch<2, kSkip, false>(LSQ_ILS_ARGS);
  if (h <= 128) LSQ_ILS_LAUNCH(4);
  if (h <= 256) LSQ_ILS_LAUNCH(8);
  if (h <= 512) LSQ_ILS_LAUNCH(16);
  if (h <= 1024) LSQ_ILS_LAUNCH(32);
#undef LSQ_ILS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1 at one stage of its redesign, to time the stages in one run: step 0
// the first port's visit loop, 1 a visit's rows in flight together one
// element a lane, 2 the same with 16 bytes a lane, 3 rows in flight and the
// skip one element a lane, 4 that with 16 bytes a lane (what lsq_ils_encode
// runs here). Eight candidates a lane only: 128 < h <= 256, h % 8 == 0, a
// 16-byte aligned table.
int lsq_ils_encode_step(int step, const void* unaries, const void* bin, const void* xsq,
                        const void* B0, const void* orders, const void* pkeys,
                        const void* pcodes, const void* ms_rounds, int n, int m, int h,
                        int rounds, int icmiter, int npert, int n_ms, void* out_b,
                        void* out_cost, void* ms_b, void* ms_cost, void* stats, void* stream) {
  if (h <= 128 || h > 256 || h % 8 != 0 || reinterpret_cast<uintptr_t>(bin) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (step) {
    case 0:
      return launch<8, kPresent, false>(LSQ_ILS_ARGS);
    case 1:
      return launch<8, kHoisted, false>(LSQ_ILS_ARGS);
    case 2:
      return launch<8, kHoisted, true>(LSQ_ILS_ARGS);
    case 3:
      return launch<8, kSkip, false>(LSQ_ILS_ARGS);
    case 4:
      return launch<8, kSkip, true>(LSQ_ILS_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef LSQ_ILS_ARGS

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
