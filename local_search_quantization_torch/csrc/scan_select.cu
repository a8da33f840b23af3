// K3: additive ADC scan plus a top-k cut at a warm bound, streamed through a
// per-query shared-memory buffer: no distance scratch.
//
// Replaces local_search_quantization_tpu/ops/select_pallas.py: _select_kernel
// (variants "sorted" and "unsorted"), launched there through fused_scan_topk
// and scan_topk_warm (the warm pre-scan and the key variant's fallback).
// Contract: dist[q, i] = sum_j lut[q, j, Bt[j, i]] + extra[i], summed in j
// order then extra (the f32 values of K2 and lut_scan_block); only rows with
// dist < t0[q] are kept, and +inf rows never are.
// - lex (the "sorted" variant): the keep = k rows that are smallest in
//   (dist, id) order, bit for bit K2's answer cut at t0;
// - value (the "unsorted" variant): keep = cap rows, value-exact: the k
//   smallest distances are right, but which ids survive a tie block across
//   the k-th value follows arrival order.
// The survivors come back unsorted, (+inf, -1) past them; the wrapper sorts by
// (dist, id), as the TPU route sorts after its kernel.
//
// What bounds it on this card: 7e9 shared-memory LUT lookups at 1000 queries
// x 1M rows (0.84 ms with no bank conflicts at one 32-lane lookup an SM a
// clock), and the code bytes, which the first port (one block a query, one
// lane a row, one byte a load from device memory) read once per query: 11 GB
// from L2, and 32 random banks a lookup (3.4 ways), on a grid of nq blocks.
//
// Design: a block serves G queries (16, 8, 4 or 2, the most whose buffers fit)
// and one segment of rows; the grid is (segments) x (groups of G queries), and
// the wrapper picks the segments (up to two blocks an SM), so a single query
// is scanned by many SMs. The G queries' LUTs lie in shared memory as
// s_lut[(j*h + c)*G + q]; a lane serves two queries by one 8-byte load and
// kR consecutive rows, and a tile of codes and extra (one step's rows) is
// staged by 16-byte loads once for all G queries, the next tile copied in by
// cp.async while this one is scored (scan_common.cuh, shared with K2's
// k2_filter): 11/G GB of code bytes from L2, and 1.5 bank ways a lookup at
// G=16. Each query keeps a buffer of `cap` 64-bit keys, (monotone image of
// dist) << 32 | id, in shared memory. A step scores one tile for every query;
// each row below the query's threshold thr = min(t0, the largest kept
// distance) is appended with a warp-aggregated shared-memory atomic. When a
// step leaves any buffer above room = cap - (a step's rows) keys, warp q trims
// query q's buffer, all G at once: a histogram of the distance halves over
// their own range keeps every key up to the bin where the count reaches keep
// (the keep smallest all stay), and thr tightens. Rows of later steps have
// larger ids than every kept row, so a strict dist < thr is the lexicographic
// rule too. Where the distances fall into one bin, and at the end of the
// segment, a radix select (8-bit digits; the whole 64-bit key in lex mode,
// the distance half in value mode) finds the keep-th key exactly and an
// order-preserving in-place compaction keeps the rows at or below it. Each
// (segment, query) writes its own `keep` survivors; the top-keep of the union
// of the segments' top-keeps is the top-keep of all rows, so the wrapper's
// (dist, id) sort over [nq, segments*keep] is the merge. The selection runs
// only on the few rows below thr once a buffer has filled.
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "scan_common.cuh"

namespace {

using lsq_scan::kFull;
using lsq_scan::mono;
using lsq_scan::unmono;

constexpr int kThreads = 1024;  // 32 warps: one block an SM
constexpr int kRowsUnit = 1024;  // a segment is a multiple of this many rows
constexpr int kSmemLimit = 227 * 1024;
// Static shared memory reserved out of the 227 KB (the barrier's reduction).
constexpr int kStaticSmemReserve = 1024;
constexpr int kHistBytes = 256 * 4;  // one radix histogram a query

// Consecutive rows a lane scores per step: a step is kThreads / (G/2) * kR
// rows, 512 at G=16 and 1024 below, so a query's buffer needs little room
// beyond `keep` for the appends of one step.
__host__ __device__ constexpr int rows_per_lane(int g) { return g >= 8 ? 4 : (g == 4 ? 2 : 1); }
__host__ __device__ constexpr int step_rows(int g) {
  return kThreads / (g / 2) * rows_per_lane(g);
}
// A tile is one step's rows. Two tile buffers, the next tile copied in by
// cp.async while this one is scored (a sixth faster at G = 8 and 4 than one
// buffer loaded between two barriers), except at g = 2, whose buffers (the
// deepest k) need the room: there one buffer.
__host__ __device__ constexpr int tile_stages(int g) { return g == 2 ? 1 : 2; }

inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory besides the key buffers: LUTs, the tile buffers of
// extra and codes, the histograms, and each query's count and threshold.
inline size_t fixed_bytes(int m, int h, int code_bytes, int g) {
  return align16(static_cast<size_t>(g) * m * h * 4) +
         static_cast<size_t>(tile_stages(g)) * step_rows(g) * (4 + m * code_bytes) +
         static_cast<size_t>(g) * (kHistBytes + 8);
}

// Keys each of a block's g queries can buffer (0: not even the rest fits).
inline int cap_keys(int m, int h, int code_bytes, int g) {
  const size_t fixed = fixed_bytes(m, h, code_bytes, g) + kStaticSmemReserve;
  if (fixed >= static_cast<size_t>(kSmemLimit)) return 0;
  return static_cast<int>((kSmemLimit - fixed) / (8 * static_cast<size_t>(g)));
}

// Append row `id` to local query q's buffer when d < thr: one atomicAdd per
// query and warp, by the leader of the lanes `mask` that serve that query.
// True where the append left the buffer above `room` keys.
__device__ __forceinline__ bool append(float d, float thr, int q, unsigned mask, int lane,
                                       uint32_t id, int room, int* s_count,
                                       unsigned long long* buf) {
  const bool take = d < thr;
  const unsigned bal = __ballot_sync(kFull, take);
  if (bal == 0u) return false;  // warp-uniform
  const unsigned peers = bal & mask;
  const int leader = peers ? __ffs(peers) - 1 : lane;
  int pos = 0;
  if (take && lane == leader) pos = atomicAdd(s_count + q, __popc(peers));
  pos = __shfl_sync(kFull, pos, leader) + __popc(peers & ((1u << lane) - 1u));
  if (take) buf[pos] = (static_cast<unsigned long long>(mono(d)) << 32) | id;
  return take && pos >= room;
}

// Lane l owns bins 8l .. 8l+7 of the warp's 256-bin histogram. Finds the bin
// d where the running count first reaches `need`: returns d, the count
// before it through *before and the bin's own count through *at.
__device__ __forceinline__ unsigned find_bin(const unsigned* hist, unsigned need, int lane,
                                             unsigned* before, unsigned* at) {
  unsigned loc[8], sum = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    loc[i] = hist[8 * lane + i];
    sum += loc[i];
  }
  unsigned inc = sum;  // inclusive scan over the lanes
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += v;
  }
  const int src = __ffs(__ballot_sync(kFull, inc >= need)) - 1;
  unsigned d = 0u, cum = inc - sum, hit = 0u;
  if (lane == src) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (hit == 0u) {
        if (cum + loc[i] >= need) {
          d = 8u * lane + i;
          hit = loc[i];
        } else {
          cum += loc[i];
        }
      }
    }
  }
  *before = __shfl_sync(kFull, cum, src);
  *at = __shfl_sync(kFull, hit, src);
  return __shfl_sync(kFull, d, src);
}

// One pass of in-place, order-preserving compaction by one warp, 32 keys at a
// time: keeps the keys below `prefix` under `mask`, and the first `need` of
// those equal to it. The ballots order every lane's read of its key before
// any write, and a key moves only to a lower index, so nothing unread is
// overwritten. Sets the count and the threshold min(t0, largest kept dist).
__device__ __forceinline__ void keep_below(unsigned long long* buf, int count,
                                           unsigned long long prefix,
                                           unsigned long long mask, unsigned need, float t0,
                                           int lane, int* s_count, float* thr) {
  int kept = 0, ties = 0;
  uint32_t my_max = 0u;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = 0; base < count; base += 32) {
    const int e = base + lane;
    const bool in = e < count;
    const unsigned long long key = in ? buf[e] : ~0ull;
    const bool less = in && (key & mask) < prefix;
    const bool tie = in && (key & mask) == prefix;
    const unsigned tb = __ballot_sync(kFull, tie);
    const bool keep_it =
        less || (tie && static_cast<unsigned>(ties + __popc(tb & lt)) < need);
    const unsigned kb = __ballot_sync(kFull, keep_it);
    if (keep_it) {
      buf[kept + __popc(kb & lt)] = key;
      my_max = max(my_max, static_cast<uint32_t>(key >> 32));
    }
    kept += __popc(kb);
    ties += __popc(tb);
  }
  for (int o = 16; o > 0; o >>= 1) my_max = max(my_max, __shfl_xor_sync(kFull, my_max, o));
  if (lane == 0) {
    *s_count = kept;
    *thr = fminf(t0, unmono(my_max));
  }
  __syncwarp();
}

// One warp keeps exactly the `keep` smallest keys of buf[0, count) (lex: the
// whole key; value: the distance half, ties kept in buffer order): a radix
// select by 8-bit digits, then keep_below. Needs count > keep; hist is this
// warp's 256 bins.
template <bool kLex>
__device__ void warp_select(unsigned long long* buf, int count, int keep, unsigned* hist,
                            float t0, int lane, int* s_count, float* thr) {
  unsigned long long prefix = 0ull, mask = 0ull;
  unsigned need = static_cast<unsigned>(keep);
  constexpr int kLastShift = kLex ? 0 : 32;
  for (int shift = 56; shift >= kLastShift; shift -= 8) {
    for (int b = lane; b < 256; b += 32) hist[b] = 0u;
    __syncwarp();
    for (int base = 0; base < count; base += 32) {
      const int e = base + lane;
      unsigned digit = 256u;  // no bin
      if (e < count) {
        const unsigned long long key = buf[e];
        if ((key & mask) == prefix) digit = static_cast<unsigned>(key >> shift) & 255u;
      }
      // Keys of one query share their leading digits: one lane a digit adds
      // its peers, so no two lanes write one bin at once.
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < 256u && lane == __ffs(peers) - 1) hist[digit] += __popc(peers);
      __syncwarp();
    }
    unsigned before, at;
    const unsigned d = find_bin(hist, need, lane, &before, &at);
    need -= before;
    prefix |= static_cast<unsigned long long>(d) << shift;
    mask |= 255ull << shift;
    if (at == need) break;  // every row at this prefix is kept
  }
  keep_below(buf, count, prefix, mask, need, t0, lane, s_count, thr);
}

// One warp trims buf[0, count) to at least `keep` keys without selecting the
// keep-th exactly, which only the end of a segment needs: a histogram of the
// distance halves over their own range [lo, hi] in 128 to 256 equal bins,
// then every key up to the bin where the count reaches `keep` stays. The
// smallest `keep` keys all stay, and thr = the largest kept distance admits
// no later row that at least `keep` kept rows do not precede. Returns false,
// with nothing changed, where more than `limit` keys would stay (distances
// that fall in one bin): the caller then selects exactly.
__device__ bool warp_trim(unsigned long long* buf, int count, int keep, int limit,
                          unsigned* hist, float t0, int lane, int* s_count, float* thr) {
  uint32_t lo = 0xffffffffu, hi = 0u;
#pragma unroll 4
  for (int e = lane; e < count; e += 32) {
    const uint32_t v = static_cast<uint32_t>(buf[e] >> 32);
    lo = min(lo, v);
    hi = max(hi, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const uint32_t range = hi - lo;
  const int sh = range < 256u ? 0 : 24 - __clz(range);  // (range >> sh) < 256
  for (int b = lane; b < 256; b += 32) hist[b] = 0u;
  __syncwarp();
#pragma unroll 4
  for (int e = lane; e < count; e += 32)
    atomicAdd(&hist[(static_cast<uint32_t>(buf[e] >> 32) - lo) >> sh], 1u);
  __syncwarp();
  unsigned before, at;
  const unsigned d = find_bin(hist, static_cast<unsigned>(keep), lane, &before, &at);
  if (before + at > static_cast<unsigned>(limit)) return false;  // warp-uniform
  // Every key of bins 0 .. d: those below the first distance of bin d + 1.
  const unsigned long long first_out =
      static_cast<unsigned long long>(lo) + (static_cast<unsigned long long>(d + 1u) << sh);
  const unsigned long long edge = min(first_out, 0xffffffffull) << 32;  // past any distance
  keep_below(buf, count, edge, ~0ull, 0u, t0, lane, s_count, thr);
  return true;
}

template <typename CodeT, int G, bool kLex>
__global__ void __launch_bounds__(kThreads)
scan_select(const float* __restrict__ luts, const CodeT* __restrict__ bt,
            const float* __restrict__ extra, const float* __restrict__ t0s, int nq, int m,
            int h, int n, int rows_per_block, int keep, int cap, int vec,
            float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kPairs = G / 2;             // lanes a row, two queries each
  constexpr int kSlots = 32 / kPairs;       // row slots a warp scores at once
  constexpr int kR = rows_per_lane(G);      // consecutive rows a lane
  constexpr int kTile = step_rows(G);       // rows a block stages and scores a step
  constexpr int kStages = tile_stages(G);
  extern __shared__ __align__(16) unsigned char smem[];
  const int mh = m * h;
  float* s_lut = reinterpret_cast<float*>(smem);  // [m*h][G]
  float* s_extra =
      reinterpret_cast<float*>(smem + (static_cast<size_t>(G) * mh * 4 + 15) / 16 * 16);
  CodeT* s_codes = reinterpret_cast<CodeT*>(s_extra + kStages * kTile);  // [stage][m][kTile]
  unsigned* s_hist =
      reinterpret_cast<unsigned*>(s_codes + static_cast<size_t>(kStages) * m * kTile);
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(s_hist + G * 256);
  int* s_count = reinterpret_cast<int*>(s_keys + static_cast<size_t>(G) * cap);
  float* s_thr = reinterpret_cast<float*>(s_count + G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * G;
  lsq_scan::load_luts<G, kThreads>(s_lut, luts, q0, nq, mh);
  if (tid < G) {
    s_count[tid] = 0;  // a padding query never appends
    s_thr[tid] = q0 + tid < nq ? (t0s == nullptr ? INFINITY : t0s[q0 + tid]) : -INFINITY;
  }
  // Warp q compacts query q; its bound, buffer and histogram.
  const float my_t0 = warp < G && q0 + warp < nq && t0s != nullptr ? t0s[q0 + warp] : INFINITY;
  unsigned long long* my_buf = s_keys + static_cast<size_t>(warp < G ? warp : 0) * cap;
  unsigned* my_hist = s_hist + (warp < G ? warp : 0) * 256;
  const int p = lane % kPairs, slot = lane / kPairs;
  const int qa = 2 * p, qb = qa + 1;
  unsigned pmask = 0u;  // the lanes of query pair p in this warp
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pmask |= 1u << (p + s * kPairs);
  const float* lq = s_lut + 2 * p;
  const int r = (warp * kSlots + slot) * kR;  // this lane's first row of a tile
  unsigned long long* buf_a = s_keys + static_cast<size_t>(qa) * cap;
  unsigned long long* buf_b = s_keys + static_cast<size_t>(qb) * cap;
  const int room = cap - kTile;  // a step appends at most kTile keys a query
  const int limit = keep + (room - keep) / 2;  // a trim must leave at most this
  const int seg0 = blockIdx.x * rows_per_block;
  const int seg1 = min(n, seg0 + rows_per_block);
  if constexpr (kStages == 2) {
    lsq_scan::stage_tile<CodeT, kTile, kThreads, true>(s_codes, s_extra, bt, extra, m, n,
                                                       seg0, min(kTile, seg1 - seg0),
                                                       vec != 0);
    lsq_scan::cp_async_commit();
    lsq_scan::cp_async_wait_all();
    __syncthreads();  // the first tile has landed for every thread
  }
  int stage = 0;
  for (int base = seg0; base < seg1; base += kTile) {
    const float* t_extra = s_extra + stage * kTile;
    const CodeT* t_codes = s_codes + static_cast<size_t>(stage) * m * kTile;
    // The barrier that ended the last step says that the tile before is
    // consumed, and (two stages) that this one has landed for every thread.
    if constexpr (kStages == 2) {
      stage ^= 1;
      if (base + kTile < seg1)  // the next tile loads while this one is scored
        lsq_scan::stage_tile<CodeT, kTile, kThreads, true>(
            s_codes + static_cast<size_t>(stage) * m * kTile, s_extra + stage * kTile, bt,
            extra, m, n, base + kTile, min(kTile, seg1 - base - kTile), vec != 0);
      lsq_scan::cp_async_commit();
    } else {
      lsq_scan::stage_tile<CodeT, kTile, kThreads, false>(s_codes, s_extra, bt, extra, m, n,
                                                          base, min(kTile, seg1 - base),
                                                          vec != 0);
      __syncthreads();
    }
    const float thr_a = s_thr[qa], thr_b = s_thr[qb];
    float da[kR], db[kR];
    lsq_scan::score_rows<CodeT, G, kR, kTile>(lq, t_codes, t_extra, r, m, h, da, db);
    bool over = false;
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const uint32_t id = static_cast<uint32_t>(base + r + u);
      over |= append(da[u], thr_a, qa, pmask, lane, id, room, s_count, buf_a);
      over |= append(db[u], thr_b, qb, pmask, lane, id, room, s_count, buf_b);
    }
    if constexpr (kStages == 2) lsq_scan::cp_async_wait_all();
    // Any buffer above room: every query with more than keep keys trims,
    // warp q the buffer of query q, so the block stops once for all of them.
    if (__syncthreads_or(over)) {
      if (warp < G && s_count[warp] > keep) {
        const int count = s_count[warp];
        if (!warp_trim(my_buf, count, keep, limit, my_hist, my_t0, lane, s_count + warp,
                       s_thr + warp))
          warp_select<kLex>(my_buf, count, keep, my_hist, my_t0, lane, s_count + warp,
                            s_thr + warp);
      }
      __syncthreads();
    }
  }
  if (warp < G && s_count[warp] > keep)
    warp_select<kLex>(my_buf, s_count[warp], keep, my_hist, my_t0, lane, s_count + warp,
                      s_thr + warp);
  __syncthreads();
  for (int q = 0; q < G && q0 + q < nq; ++q) {
    const int count = s_count[q];
    const unsigned long long* buf = s_keys + static_cast<size_t>(q) * cap;
    const size_t at = (static_cast<size_t>(q0 + q) * gridDim.x + blockIdx.x) * keep;
    for (int pos = tid; pos < keep; pos += kThreads) {
      if (pos < count) {
        const unsigned long long key = buf[pos];
        out_d[at + pos] = unmono(static_cast<uint32_t>(key >> 32));
        out_i[at + pos] = static_cast<int>(static_cast<uint32_t>(key));
      } else {
        out_d[at + pos] = INFINITY;
        out_i[at + pos] = -1;
      }
    }
  }
}

template <typename CodeT, int G, bool kLex>
int launch(const void* luts, const void* bt, const void* extra, const void* t0, int nq,
           int m, int h, int n, int rows_per_block, int keep, int cap, int vec, void* out_d,
           void* out_i, cudaStream_t stream) {
  if (cap < keep + step_rows(G) || cap > cap_keys(m, h, sizeof(CodeT), G))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed_bytes(m, h, sizeof(CodeT), G) + 8 * static_cast<size_t>(G) * cap;
  cudaError_t err = cudaFuncSetAttribute(scan_select<CodeT, G, kLex>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, (nq + G - 1) / G);
  scan_select<CodeT, G, kLex><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const CodeT*>(bt),
      static_cast<const float*>(extra), static_cast<const float*>(t0), nq, m, h, n,
      rows_per_block, keep, cap, vec, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, bool kLex>
int dispatch(int g, const void* luts, const void* bt, const void* extra, const void* t0,
             int nq, int m, int h, int n, int rows_per_block, int keep, int cap, int vec,
             void* out_d, void* out_i, cudaStream_t s) {
#define LSQ_K3_LAUNCH(G)                                                                  \
  case G:                                                                                 \
    return launch<CodeT, G, kLex>(luts, bt, extra, t0, nq, m, h, n, rows_per_block, keep, \
                                  cap, vec, out_d, out_i, s)
  switch (g) {
    LSQ_K3_LAUNCH(16);
    LSQ_K3_LAUNCH(8);
    LSQ_K3_LAUNCH(4);
    LSQ_K3_LAUNCH(2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LSQ_K3_LAUNCH
}

inline bool group_ok(int g) { return g == 16 || g == 8 || g == 4 || g == 2; }

}  // namespace

extern "C" {

// The shape rules, for the wrapper's pure mirror of them: the rows a segment
// is a multiple of, the rows a block of g queries scores a step, and the keys
// each of its queries can buffer in shared memory (0: the LUTs and the tiles
// alone do not fit).
int lsq_select_rows_unit() { return kRowsUnit; }
int lsq_select_step(int g) { return group_ok(g) ? step_rows(g) : 0; }
int lsq_select_cap_keys(int m, int h, int code_bytes, int g) {
  return group_ok(g) ? cap_keys(m, h, code_bytes, g) : 0;
}

// Per query and segment of rows_per_block rows (a multiple of
// lsq_select_rows_unit()), the keep rows below t0 (t0 may be NULL: +inf):
// lex = 1 keeps the (dist, id)-smallest, lex = 0 the value-smallest. Unsorted
// out_d/out_i [nq, segments, keep], (+inf, -1) past each segment's survivors.
// g queries a block, each with a buffer of cap keys:
// keep + lsq_select_step(g) <= cap <= lsq_select_cap_keys(m, h, code_bytes, g).
// code_bytes is 1 (uint8 codes) or 4 (int32 codes); vec = 1 allows 16-byte
// staging loads (aligned pointers, n * code_bytes % 16 == 0). Needs
// 1 <= keep, n < 2^31.
int lsq_select_topk(const void* luts, const void* bt, int code_bytes, const void* extra,
                    const void* t0, int nq, int m, int h, int n, int rows_per_block, int keep,
                    int lex, int g, int cap, int vec, void* out_d, void* out_i,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep < 1 || rows_per_block < kRowsUnit || rows_per_block % kRowsUnit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return lex ? dispatch<uint8_t, true>(g, luts, bt, extra, t0, nq, m, h, n, rows_per_block,
                                         keep, cap, vec, out_d, out_i, s)
               : dispatch<uint8_t, false>(g, luts, bt, extra, t0, nq, m, h, n, rows_per_block,
                                          keep, cap, vec, out_d, out_i, s);
  if (code_bytes == 4)
    return lex ? dispatch<int32_t, true>(g, luts, bt, extra, t0, nq, m, h, n, rows_per_block,
                                         keep, cap, vec, out_d, out_i, s)
               : dispatch<int32_t, false>(g, luts, bt, extra, t0, nq, m, h, n, rows_per_block,
                                          keep, cap, vec, out_d, out_i, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
