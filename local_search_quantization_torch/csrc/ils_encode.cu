// K1: a whole ILS/ICM encode in one launch.
//
// Replaces local_search_quantization_tpu/ops/icm_pallas.py:_ils_kernel_pp
// (and its unpipelined twin _ils_kernel, with the cost helper _mrf_cost),
// launched there through fused_ils_encode. Same function on the same
// streamed inputs, rethought for an H100:
//
// - One warp owns one row for the whole encode: `rounds` x (perturb npert
//   codebooks from the streamed keys/codes -> icmiter*m ICM visits -> MRF
//   cost -> accept only if strictly better, else restore).
// - The pairwise table comes as the TPU wrapper splits it
//   (icm_pallas.py:715-716): hi = bf16(binaries) [m, m, h, h] for the
//   visits and the cost, and its bf16 residual lo for the cost alone. The
//   wrapper (ops/icm_kernels.py) splits the f32 table once per encode.
// - A visit to codebook j scores all h candidates c; each lane holds CPL of
//   them in registers (the lane map is below). Each candidate's score is
//   the sum of hi[k][j][B_k][c] for k = 0..m-1, k != j, in that order from
//   0, each bf16 value widened exactly to f32, and then the unary
//   unaries[j][c] added: the TPU kernel's one-hot x bf16 product
//   (icm_pallas.py:441-451) adds exact zeros to the same values. The warp's
//   argmin breaks ties to the lowest c.
// - The cost is _mrf_cost's (icm_pallas.py:133-166): (xsq + the unaries in
//   i order) + the sum over j = 0..m-2, from 0, of
//   (sum_{k>j} hi[k][j][B_k][B_j]) + (sum_{k>j} lo[k][j][B_k][B_j]), each
//   inner sum in k order. The lanes load the pair terms in parallel and the
//   sum walks them in that order through shuffles. Dead rows carry xsq =
//   -1e30 and so never accept; that holds only because no sum is
//   reassociated (no fast math, and adds only, so nothing is contracted
//   into an FMA).
// - The row's unaries ([m, h] f32, 7 KB at m=7, h=256) live in shared
//   memory; its codes live in registers, lane k < m holding code k (the
//   current and the best). The hi table (6.4 MB at m=7, h=256) is too big
//   for shared memory; it stays in device memory and is served from the
//   50 MB L2.
// - Perturbation follows the TPU kernel's rule (icm_pallas.py:245-256):
//   npert times, take the argmin key (lowest index on ties), set it to 1e30
//   and write the next perturbation code there.
//
// What bounds it on this card: each visit of each row gathers m-1 table
// rows of h bf16 values (512 B at h=256) from L2, which serves random 512 B
// rows at 6.2 TB/s for 16 bytes a lane (csrc/l2_probe.cu, chip_smoke.py
// phase 2d): 31.5 GB, 5.1 ms, for the visits K1 needs at n=131072, 4
// rounds, icmiter=4, m=7. K1 takes 7.2 ms there on an H100, against 8.4 ms
// when its table was f32 (63 GB of 1 KB rows, at the L2 rate). With
// rows half as long the gather is no longer all of the time; what else
// sets it (a visit's argmin and shuffles, or the rows in flight at 24 warps
// an SM, 80 registers a lane) has not been measured apart.
//
// Design:
// - One L2 round trip a visit: a visit forms its m-1 row addresses from the
//   codes by shuffles (no shared-memory read in a load's address) and loads
//   all m-1 rows (RowsInFlight at a time where a row takes many registers)
//   into registers of their own before the first add. The adds then walk k
//   in order, so each candidate's sum is the same as the plain version's.
// - Lane map: lane l holds the CPL consecutive candidates c = l*CPL + t
//   (PACKED), so its share of a bf16 row is CPL*2 bytes: one 16-byte load
//   at CPL 8 (two at 16, four at 32; one 8- or 4-byte load at CPL 4 or 2),
//   and its unaries CPL/4 float4s from shared memory (one float at a time
//   below CPL 4). The register holding two bf16 values widens them exactly:
//   the low half shifted left by 16, the high half masked. Where h is no
//   multiple of CPL (a lane's candidates would straddle h) or where CPL is
//   1, the kernel takes the element map c = l + 32t with a masked tail, a
//   2-byte load a candidate. The bf16 tables are the wrapper's own
//   allocations, so a row always starts on a 16-byte boundary; the entry
//   point refuses tables that do not.
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
// finishes. It would take another m-2 rows of registers a lane.
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

// Code i of the row: lane i holds it.
__device__ __forceinline__ int code_of(int code, int i) { return __shfl_sync(kFull, code, i); }

// Exact widening of a bf16 bit pattern to f32.
__device__ __forceinline__ float bf16_bits_to_f32(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// Pair p of the order (a, b > a), a outer, that m codebooks have.
__device__ __forceinline__ void pair_of(int p, int m, int& a, int& b) {
  a = 0;
  while (p >= m - 1 - a) {
    p -= m - 1 - a;
    ++a;
  }
  b = a + 1 + p;
}

// The MRF cost of the codes lanes 0..m-1 hold, with the table's pair terms
// (see the head of this file); every lane returns the same value.
__device__ __forceinline__ float mrf_cost(const float* u, const unsigned short* __restrict__ table,
                                          const unsigned short* __restrict__ lo, int code,
                                          float xsq, int m, int h, int lane) {
  float s = u[code_of(code, 0)];
  for (int i = 1; i < m; ++i) s += u[i * h + code_of(code, i)];
  const float base = xsq + s;
  const int npairs = m * (m - 1) / 2;
  // For each j: hi[k][j][B_k][B_j] and lo[k][j][B_k][B_j], k > j; lane
  // `lane` loads pair q + lane of the order (j, k > j), j outer, 32 pairs at
  // a time.
  float pair = 0.0f, sh = 0.0f, sl = 0.0f, vh = 0.0f, vl = 0.0f;
  int q = 0;
  for (int j = 0; j < m - 1; ++j) {
    for (int k = j + 1; k < m; ++k, ++q) {
      if ((q & 31) == 0) {
        const bool live = q + lane < npairs;
        int a = 0, b = 0;
        if (live) pair_of(q + lane, m, a, b);
        const int ca = __shfl_sync(kFull, code, a);
        const int cb = __shfl_sync(kFull, code, b);
        const size_t at = ((static_cast<size_t>(b) * m + a) * h + cb) * h + ca;
        vh = live ? bf16_bits_to_f32(__ldcg(&table[at])) : 0.0f;
        vl = live ? bf16_bits_to_f32(__ldcg(&lo[at])) : 0.0f;
      }
      const float th = __shfl_sync(kFull, vh, q & 31);
      const float tl = __shfl_sync(kFull, vl, q & 31);
      if (k == j + 1) {
        sh = th;
        sl = tl;
      } else {
        sh += th;
        sl += tl;
      }
    }
    pair += sh + sl;
  }
  return base + pair;
}

// Candidate t of a lane: strided by 32, or consecutive (PACKED).
template <int CPL, bool PACKED>
__device__ __forceinline__ int cand(int lane, int t) {
  return PACKED ? lane * CPL + t : lane + 32 * t;
}

// A lane's share of one table row, in registers: the bytes of its CPL
// values, two bf16 values a word where they are loaded packed, else one
// value a word.
template <int CPL, bool PACKED>
struct RowRegs {
  static constexpr int kWords = PACKED ? CPL / 2 : CPL;
  uint32_t w[kWords];
  __device__ __forceinline__ float value(int t) const {
    if constexpr (PACKED) {
      const uint32_t x = w[t >> 1];
      return __uint_as_float((t & 1) ? (x & 0xffff0000u) : (x << 16));
    } else {
      return __uint_as_float(w[t] << 16);
    }
  }
};

// Table rows a visit keeps in flight at once: all m-1 up to 8, fewer where
// a row takes many registers (64 registers of rows a lane at most).
template <int CPL, bool PACKED>
struct RowsInFlight {
  static constexpr int kByRegs = 64 / RowRegs<CPL, PACKED>::kWords;
  static constexpr int value = kByRegs > 8 ? 8 : kByRegs;
};

// Load a lane's share of table row r; candidates at or past h read as 0.
template <int CPL, bool PACKED>
__device__ __forceinline__ void load_row(const unsigned short* __restrict__ r, int lane, int h,
                                         RowRegs<CPL, PACKED>& row) {
  if constexpr (PACKED) {
    // h % CPL == 0: a lane is whole or idle, and r + lane*CPL is aligned to
    // the load's width.
    constexpr int kBytes = CPL * 2;
    const unsigned short* p = r + lane * CPL;
    const bool live = lane * CPL < h;
    if constexpr (kBytes == 4) {
      row.w[0] = live ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
    } else if constexpr (kBytes == 8) {
      const uint2 v = live ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
      row.w[0] = v.x;
      row.w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
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
      const int c = cand<CPL, false>(lane, t);
      row.w[t] = c < h ? static_cast<uint32_t>(__ldg(&r[c])) : 0u;
    }
  }
}

template <int CPL, bool PACKED>
__global__ void __launch_bounds__(kWarps * 32)
ils_kernel(const float* __restrict__ unaries, const unsigned short* __restrict__ table,
           const unsigned short* __restrict__ lo, const float* __restrict__ xsq,
           const int* __restrict__ B0, const int* __restrict__ orders,
           const float* __restrict__ pkeys, const int* __restrict__ pcodes,
           const int* __restrict__ ms_rounds, int n, int m, int h, int rounds, int icmiter,
           int npert, int n_ms, int* __restrict__ out_b, float* __restrict__ out_cost,
           int* __restrict__ ms_b, float* __restrict__ ms_cost, int* __restrict__ stats) {
  static_assert(!PACKED || CPL >= 2, "packed loads are 4+ bytes a lane");
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
  float best_cost = mrf_cost(u, table, lo, best, x2, m, h, lane);

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
    unsigned need = all;  // the visits whose inputs changed

    // --- ICM sweeps in this round's visit order (lane s holds visit s) ---
    const int ord = lane < m ? __ldcg(&orders[r * m + lane]) : 0;
    for (int it = 0; it < icmiter; ++it) {
      for (int s = 0; s < m; ++s) {
        const int j = __shfl_sync(kFull, ord, s);
        if (!((need >> j) & 1u)) continue;
        // The lane's unaries of codebook j; +inf at or past h, so those
        // candidates never win.
        float uv[CPL];
        if constexpr (PACKED && CPL >= 4) {
          const bool live = lane * CPL < h;
#pragma unroll
          for (int i = 0; i < CPL / 4; ++i) {
            const float4 v = live ? *reinterpret_cast<const float4*>(u + j * h + lane * CPL + 4 * i)
                                  : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
            uv[4 * i] = v.x;
            uv[4 * i + 1] = v.y;
            uv[4 * i + 2] = v.z;
            uv[4 * i + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int c = cand<CPL, PACKED>(lane, t);
            uv[t] = c < h ? u[j * h + c] : INFINITY;
          }
        }
        // The pair rows from 0, then the unary.
        float acc[CPL];
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[t] = 0.0f;
        constexpr int kRows = RowsInFlight<CPL, PACKED>::value;
        // The visit's m-1 rows are those of k = kk + (kk >= j), kk = 0..m-2,
        // in k order; kRows of them are loaded before any is added.
        for (int kk0 = 0; kk0 < m - 1; kk0 += kRows) {
          RowRegs<CPL, PACKED> rows[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int kk = kk0 + i;
            const int k = kk + (kk >= j);
            const int ck = code_of(code, k & 31);
            if (kk < m - 1)
              load_row<CPL, PACKED>(
                  table + ((static_cast<size_t>(k) * m + j) * h + ck) * h, lane, h, rows[i]);
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (kk0 + i < m - 1) {
#pragma unroll
              for (int t = 0; t < CPL; ++t) acc[t] += rows[i].value(t);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[t] = uv[t] + acc[t];
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
        need &= ~(1u << j);
        if (bc != code_of(code, j)) need |= all & ~(1u << j);
        if (lane == j) code = bc;
      }
    }

    // --- accept if strictly better, else restore ---
    const float newcost = mrf_cost(u, table, lo, code, x2, m, h, lane);
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

template <int CPL, bool PACKED>
int launch(const void* unaries, const void* table, const void* lo, const void* xsq,
           const void* B0, const void* orders, const void* pkeys, const void* pcodes,
           const void* ms_rounds, int n, int m, int h, int rounds, int icmiter, int npert,
           int n_ms, void* out_b, void* out_cost, void* ms_b, void* ms_cost, void* stats,
           cudaStream_t stream, int smem) {
  auto kernel = ils_kernel<CPL, PACKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kWarps - 1) / kWarps;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(unaries), static_cast<const unsigned short*>(table),
      static_cast<const unsigned short*>(lo), static_cast<const float*>(xsq),
      static_cast<const int*>(B0), static_cast<const int*>(orders),
      static_cast<const float*>(pkeys), static_cast<const int*>(pcodes),
      static_cast<const int*>(ms_rounds), n, m, h, rounds, icmiter, npert, n_ms,
      static_cast<int*>(out_b), static_cast<float*>(out_cost), static_cast<int*>(ms_b),
      static_cast<float*>(ms_cost), static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The rows' unaries: [m, h] f32 for each of the block's rows.
int lsq_ils_smem_bytes(int m, int h) { return kWarps * m * h * 4; }

// Largest h the kernel takes (32 candidates per lane).
int lsq_ils_max_h() { return 1024; }

#define LSQ_ILS_ARGS                                                                         \
  unaries, table, lo, xsq, B0, orders, pkeys, pcodes, ms_rounds, n, m, h, rounds, icmiter, \
      npert, n_ms, out_b, out_cost, ms_b, ms_cost, stats, static_cast<cudaStream_t>(stream), \
      lsq_ils_smem_bytes(m, h)

// Packed bf16 loads where a lane's candidates never straddle h (h % CPL == 0
// and CPL >= 2 make each lane's share of a 16-byte aligned row aligned to its
// load's width).
inline bool can_pack(int h, int cpl) { return cpl >= 2 && h % cpl == 0; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// table: hi = bf16(binaries) [m, m, h, h]; lo: bf16(binaries - hi), the same shape.
// Both 16-byte aligned (fresh allocations of the wrapper), else refused.
int lsq_ils_encode(const void* unaries, const void* table, const void* lo, const void* xsq,
                   const void* B0, const void* orders, const void* pkeys, const void* pcodes,
                   const void* ms_rounds, int n, int m, int h, int rounds, int icmiter,
                   int npert, int n_ms, void* out_b, void* out_cost, void* ms_b,
                   void* ms_cost, void* stats, void* stream) {
#define LSQ_ILS_LAUNCH(CPL) \
  return can_pack(h, CPL) ? launch<CPL, true>(LSQ_ILS_ARGS) : launch<CPL, false>(LSQ_ILS_ARGS)
  if (!aligned16(table) || !aligned16(lo)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (h <= 32) return launch<1, false>(LSQ_ILS_ARGS);
  if (h <= 64) LSQ_ILS_LAUNCH(2);
  if (h <= 128) LSQ_ILS_LAUNCH(4);
  if (h <= 256) LSQ_ILS_LAUNCH(8);
  if (h <= 512) LSQ_ILS_LAUNCH(16);
  if (h <= 1024) LSQ_ILS_LAUNCH(32);
#undef LSQ_ILS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef LSQ_ILS_ARGS

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
