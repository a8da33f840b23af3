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
// What bounds it on this card: the shared-memory bytes of the m table entries
// a (query, row), 2 bytes each: 7e9 entries at 1000 queries x 1M rows x 7
// codebooks are 14 GB, 0.42 ms at 128 bytes an SM a clock, and as many
// widen-and-add pairs. The first port held 4 queries' tables apart in shared
// memory and read one 2-byte entry a load, codes straight from device memory
// once per group of 4 queries (1.75 GB through L2 a launch).
//
// Design: a block serves G queries (32, 16, 8 or 4: the most whose tables fit,
// no more than the batch needs) and one segment of rows; the grid is
// (segments) x (groups of G queries), and the wrapper picks the segments so
// that the card is full at any batch. The wrapper hands the tables over
// already rounded to bf16 and interleaved per group as [m*h][G], so a block
// copies its group's tables in with 16-byte cp.async loads and a lane fetches
// kQ queries' entries of one code in one shared-memory load, 4 in 8 bytes or 8
// in 16 (scan_common.cuh: score_rows_bf16; at 32 queries a block 8 a lane and
// 2 rows a lane run, 5% faster than 4 and 4). A tile of codes and extra is
// staged once for all G queries, the next tile copied in by cp.async while
// this one is scored (stage_tile, shared with K3 and K2's k2_filter); it
// holds several steps (up to 4, as many as fit), so the block meets at a
// barrier once a tile, not once a step. A hit is appended through an
// atomicAdd on its query's cursor in device memory: every block of a query
// appends to the one list, so the segments need no merge, and there is no
// buffer upkeep and no threshold to tighten. Hits are rare at a warm bound
// (some 2 in 1000 rows a query), and what they cost is the round trip of the
// atomicAdd that hands out their slots: a warp that waits for it holds up its
// block's next barrier. So a lane gathers the hits of a step's kR x kQ
// distances in one bit mask, asks for each query's slots with one atomicAdd
// of its count, and goes on to score the next step; it writes the ids out a
// step later, when the slots have long arrived.
// (key(hi) & M) < K with K = key(t0) & M a multiple of 2^13 is key(hi) < K,
// and with key'(x) = bits ^ ((bits >> 31) & 0x7fffffff), which is key(x) for
// x >= 0 and key(x) - 1 below, that is key'(hi) < (K > 0 ? K : K - 1): two
// operations and a compare, the same answer on every bit pattern.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#include "scan_common.cuh"

namespace {

constexpr int kKeyMask = -(1 << 13);
constexpr int kSmemLimit = 227 * 1024;
// Shared memory the runtime keeps of every block beside its own.
constexpr int kBlockReserve = 1024;

// Threads a block: 32 warps where one block's tables fill the SM's shared
// memory (G = 32), 16 where several blocks share an SM.
__host__ __device__ constexpr int block_threads(int g) { return g == 32 ? 1024 : 512; }
// Rows a block scores a step: G / kQ lanes a row, kR rows a lane.
__host__ __device__ constexpr int step_rows(int g, int kq, int kr) {
  return block_threads(g) / (g / kq) * kr;
}

inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory: one group's tables and two tiles, of `steps` steps
// each, of extra and codes.
inline size_t smem_bytes(int group_elems, int m, int code_bytes, int g, int kq, int kr,
                         int steps) {
  return align16(static_cast<size_t>(group_elems) * 2) +
         2 * static_cast<size_t>(steps) * step_rows(g, kq, kr) * (4 + m * code_bytes);
}

// Signed-int32 monotone key of a float (select_pallas.py:475): non-negative
// floats keep their bits, negative ones map to MININT - bits, computed in
// unsigned arithmetic so nothing overflows; -0.0 maps to 0.
__device__ __forceinline__ int f32_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : static_cast<int>(0x80000000u - static_cast<unsigned>(b));
}

// key'(x): f32_key(x) for x >= 0, f32_key(x) - 1 for negative bits.
__device__ __forceinline__ int f32_key_fast(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The bound T with key'(x) < T iff f32_key(x) < K. For K > 0 every negative x
// hits under both; for K <= 0 no x >= 0 does, and a negative x hits iff
// key'(x) + 1 < K. K = MININT (no key lies below it) stays.
__device__ __forceinline__ int fast_bound(int K) {
  return K > 0 || K == INT32_MIN ? K : K - 1;
}

// The hits of one step that a lane has asked slots for: bit u*kQ + q of
// `hits` says that row `row0 + u` hit the lane's query q, whose slots start
// at pos[q] (the value its atomicAdd returned).
template <int kQ>
struct Pending {
  unsigned hits;
  int row0;
  int pos[kQ];
};

// Ask for the slots of this step's hits: one atomicAdd a query with hits, by
// this lane alone, none of them waited for here.
template <int kQ, int kR>
__device__ __forceinline__ void claim(Pending<kQ>& pend, unsigned hits, int row0, int gq0,
                                      int* __restrict__ count) {
  pend.hits = hits;
  pend.row0 = row0;
  if (hits == 0u) return;
  unsigned of_q = 0u;  // the bits of query 0: one a row
#pragma unroll
  for (int u = 0; u < kR; ++u) of_q |= 1u << (u * kQ);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int c = __popc(hits & (of_q << q));
    if (c) pend.pos[q] = atomicAdd(count + gq0 + q, c);
  }
}

// Write the ids of the hits claimed a step ago into their slots; hits past
// cap are counted and dropped. Most lanes have none, and one that has, has
// them for one query as a rule: the others are skipped.
template <int kQ, int kR>
__device__ __forceinline__ void write_out(const Pending<kQ>& pend, int gq0, int cap,
                                          int* __restrict__ out_i) {
  if (pend.hits == 0u) return;
  unsigned of_q = 0u;  // the bits of query 0: one a row
#pragma unroll
  for (int u = 0; u < kR; ++u) of_q |= 1u << (u * kQ);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if ((pend.hits & (of_q << q)) == 0u) continue;
    int* slots = out_i + static_cast<size_t>(gq0 + q) * cap;
    int pos = pend.pos[q];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      if (pend.hits >> (u * kQ + q) & 1u) {
        if (pos < cap) slots[pos] = pend.row0 + u;
        ++pos;
      }
    }
  }
}

// Stage the tile that starts at row `base`: `steps` sub-tiles of kStep rows,
// each laid out as stage_tile lays it ([m][kStep] codes, [kStep] extra); the
// sub-tiles wholly past seg1 are left alone (no step reads them).
template <typename CodeT, int kStep, int kBlockThreads>
__device__ __forceinline__ void stage_steps(CodeT* s_codes, float* s_extra,
                                            const CodeT* __restrict__ bt,
                                            const float* __restrict__ extra, int m, int n,
                                            int base, int seg1, int steps, bool vec) {
  for (int s = 0; s < steps && base + s * kStep < seg1; ++s)
    lsq_scan::stage_tile<CodeT, kStep, kBlockThreads, true>(
        s_codes + static_cast<size_t>(s) * m * kStep, s_extra + s * kStep, bt, extra, m, n,
        base + s * kStep, min(kStep, seg1 - base - s * kStep), vec);
}

template <typename CodeT, int G, int kQ, int kR>
__global__ void __launch_bounds__(block_threads(G))
scan_key(const uint16_t* __restrict__ luts, const CodeT* __restrict__ bt,
         const float* __restrict__ extra, const float* __restrict__ t0, int nq, int m, int h,
         int n, int group_elems, int tile_steps, int rows_per_block, int cap, int vec,
         int* __restrict__ out_i, int* __restrict__ count) {
  constexpr int kThreads = block_threads(G);
  constexpr int kLanes = G / kQ;        // lanes a row, kQ queries each
  constexpr int kSlots = 32 / kLanes;   // row slots a warp scores at once
  constexpr int kStep = step_rows(G, kQ, kR);
  static_assert(kLanes >= 1 && kLanes <= 32 && G % kQ == 0, "G / kQ lanes a row");
  static_assert(kR * kQ <= 32, "a step's hits fit one mask");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_bytes = group_elems * 2;  // a multiple of 16
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);            // [m*h][G]
  const int tile = tile_steps * kStep;  // rows between two barriers
  float* s_extra = reinterpret_cast<float*>(smem + lut_bytes);    // [2][tile_steps][kStep]
  CodeT* s_codes = reinterpret_cast<CodeT*>(s_extra + 2 * tile);  // [2][tile_steps][m][kStep]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg0 = blockIdx.x * rows_per_block;
  const int seg1 = min(n, seg0 + rows_per_block);
  lsq_scan::load_luts_bf16<kThreads>(
      s_lut, luts + static_cast<size_t>(blockIdx.y) * group_elems, lut_bytes);
  stage_steps<CodeT, kStep, kThreads>(s_codes, s_extra, bt, extra, m, n, seg0, seg1,
                                      tile_steps, vec != 0);
  const int p = lane % kLanes, slot = lane / kLanes;
  const int gq0 = blockIdx.y * G + kQ * p;  // this lane's first query
  int t0k[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q)  // a padding query never appends
    t0k[q] = gq0 + q < nq ? fast_bound(f32_key(t0[gq0 + q]) & kKeyMask) : INT32_MIN;
  // This lane's first entry, as an address in the shared-memory window.
  const unsigned lq = static_cast<unsigned>(__cvta_generic_to_shared(s_lut)) + kQ * p * 2;
  const int r = (warp * kSlots + slot) * kR;  // this lane's first row of a step
  Pending<kQ> pend = {};  // nothing claimed yet
  lsq_scan::cp_async_commit();
  lsq_scan::cp_async_wait_all();
  __syncthreads();  // the tables and the first tile have landed for every thread
  int stage = 0;
  for (int base = seg0; base < seg1; base += tile) {
    const float* t_extra = s_extra + stage * tile;
    const CodeT* t_codes = s_codes + static_cast<size_t>(stage) * m * tile;
    // The barrier that ended the last tile says that the tile before is
    // consumed and that this one has landed for every thread.
    stage ^= 1;
    // The next tile loads while this one is scored.
    stage_steps<CodeT, kStep, kThreads>(s_codes + static_cast<size_t>(stage) * m * tile,
                                        s_extra + stage * tile, bt, extra, m, n, base + tile,
                                        seg1, tile_steps, vec != 0);
    lsq_scan::cp_async_commit();
    for (int s = 0; s < tile_steps && base + s * kStep < seg1; ++s) {  // block-uniform
      float d[kR][kQ];
      lsq_scan::score_rows_bf16<CodeT, G, kQ, kR, kStep>(
          lq, t_codes + static_cast<size_t>(s) * m * kStep, t_extra + s * kStep, r, m, h, d);
      const int row0 = base + s * kStep + r;
      unsigned hits = 0u;  // bit u*kQ + q: row row0 + u hits query gq0 + q
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const bool live = row0 + u < seg1;
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          if (live && f32_key_fast(d[u][q]) < t0k[q]) hits |= 1u << (u * kQ + q);
      }
      write_out<kQ, kR>(pend, gq0, cap, out_i);  // the step before: its slots have arrived
      claim<kQ, kR>(pend, hits, row0, gq0, count);
    }
    lsq_scan::cp_async_wait_all();
    __syncthreads();
  }
  write_out<kQ, kR>(pend, gq0, cap, out_i);
}

template <typename CodeT, int G, int kQ, int kR>
int launch(const void* luts, const void* bt, const void* extra, const void* t0, int nq, int m,
           int h, int n, int group_elems, int tile_steps, int rows_per_block, int cap, int vec,
           void* out_i, void* count, cudaStream_t stream) {
  const int tile = tile_steps * step_rows(G, kQ, kR);
  if (tile_steps < 1 || rows_per_block < tile || rows_per_block % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(group_elems, m, sizeof(CodeT), G, kQ, kR, tile_steps);
  if (smem + kBlockReserve > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(scan_key<CodeT, G, kQ, kR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, (nq + G - 1) / G);
  scan_key<CodeT, G, kQ, kR><<<grid, block_threads(G), smem, stream>>>(
      static_cast<const uint16_t*>(luts), static_cast<const CodeT*>(bt),
      static_cast<const float*>(extra), static_cast<const float*>(t0), nq, m, h, n,
      group_elems, tile_steps, rows_per_block, cap, vec, static_cast<int*>(out_i),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// The geometries that are built: (G queries a block, kQ queries a lane, kR rows
// a lane).
#define LSQ_K4_GEOMETRIES(X) \
  X(32, 8, 2) X(16, 4, 4) X(8, 4, 4) X(4, 4, 4) X(4, 4, 1)

inline bool geometry_ok(int g, int kq, int kr) {
#define LSQ_K4_OK(G, Q, R) \
  if (g == G && kq == Q && kr == R) return true;
  LSQ_K4_GEOMETRIES(LSQ_K4_OK)
#undef LSQ_K4_OK
  return false;
}

template <typename CodeT>
int dispatch(int g, int kq, int kr, const void* luts, const void* bt, const void* extra,
             const void* t0, int nq, int m, int h, int n, int group_elems, int tile_steps,
             int rows_per_block, int cap, int vec, void* out_i, void* count, cudaStream_t s) {
#define LSQ_K4_LAUNCH(G, Q, R)                                                            \
  if (g == G && kq == Q && kr == R)                                                       \
    return launch<CodeT, G, Q, R>(luts, bt, extra, t0, nq, m, h, n, group_elems,          \
                                  tile_steps, rows_per_block, cap, vec, out_i, count, s);
  LSQ_K4_GEOMETRIES(LSQ_K4_LAUNCH)
#undef LSQ_K4_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The shape rules, for the wrapper's pure mirror of them: the rows a block of
// geometry (g, kq, kr) scores a step (0: not built), its threads, and its
// dynamic shared memory for tables of group_elems bf16 entries a group and
// tiles of `steps` steps.
int lsq_key_step(int g, int kq, int kr) {
  return geometry_ok(g, kq, kr) ? step_rows(g, kq, kr) : 0;
}
int lsq_key_threads(int g) { return block_threads(g); }
int lsq_key_smem_bytes(int group_elems, int m, int code_bytes, int g, int kq, int kr,
                       int steps) {
  return geometry_ok(g, kq, kr)
             ? static_cast<int>(smem_bytes(group_elems, m, code_bytes, g, kq, kr, steps))
             : 0;
}

// Append the hits of nq queries. luts: bf16 tables interleaved per group of g
// queries, [ceil(nq/g)][group_elems] with group_elems >= m*h*g entries laid
// out as [m*h][g] (zeros for the queries past nq), group_elems * 2 a multiple
// of 16 and the pointer 16-byte aligned; t0 [nq] f32; out_i [nq, cap] int32
// prefilled with -1; count [nq] int32 prefilled with 0. code_bytes is 1
// (uint8 codes) or 4 (int32 codes); a tile is tile_steps steps of
// lsq_key_step(g, kq, kr) rows, and rows_per_block a multiple of a tile;
// vec = 1 allows 16-byte staging loads (aligned pointers, n * code_bytes % 16
// == 0). Needs n < 2^31, cap >= 1.
int lsq_scan_key(const void* luts, const void* bt, int code_bytes, const void* extra,
                 const void* t0, int nq, int m, int h, int n, int group_elems, int g, int kq,
                 int kr, int tile_steps, int rows_per_block, int cap, int vec, void* out_i,
                 void* count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap < 1 || group_elems < m * h * g || group_elems % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return dispatch<uint8_t>(g, kq, kr, luts, bt, extra, t0, nq, m, h, n, group_elems,
                             tile_steps, rows_per_block, cap, vec, out_i, count, s);
  if (code_bytes == 4)
    return dispatch<int32_t>(g, kq, kr, luts, bt, extra, t0, nq, m, h, n, group_elems,
                             tile_steps, rows_per_block, cap, vec, out_i, count, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
