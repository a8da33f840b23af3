// The IVF coarse probes: each query's nprobe lists of least coarse score
// s(c) = ||c||^2 - 2 q.c, closest first, with no [nq, nlist] score matrix in
// device memory.
//
// Replaces no TPU kernel: the JAX package chooses the probes in numpy
// (local_search_quantization_tpu/ivf.py `coarse_probes`). It takes the place
// of a cuBLAS GEMM, two elementwise ops and `torch.topk` on a CUDA index
// (`ivf.coarse_probes_topk`, which stays for the shapes the kernel does not
// serve: nprobe above 64 or d above 128, where it is the faster), whose
// [nq, nlist] f32 scores were written three times and read again by each
// pass of the multi-block radix select. Same function as the plain version
// `ivf.coarse_probes_reference`: the nprobe keys mono(s) << 32 | list of
// least value (scan_common.cuh), so that an exact tie goes to the lower list
// id; a list whose score is not finite is never returned, and slots past the
// finite lists are -1. The dot product is summed in f32 by FMA on the CUDA
// cores in d order (no TF32, no bf16), s = fma(-2, dot, cn).
//
// ivf_probes: grid (query tiles of 64) x (chunks of the lists), 256 threads.
// A block
// - stages its 64 queries' coordinates in shared memory once, [d][64] (d
//   padded to 32, at most 128); pad queries and coordinates are 0;
// - walks its chunk's tiles of 256 lists through a ring of 2 slabs of 32
//   coordinates x 256 lists of the transposed centroids [d, nlist], loaded by
//   cp.async (16 bytes where nlist is a multiple of 4, else 4) while the slab
//   before is scored; coordinates past d and lists past nlist load as 0;
// - scores a tile in registers: warp w holds queries 8w..8w+7, lane l the
//   lists 4l..4l+3 and 128+4l..128+4l+3, 64 accumulators a thread; a step of
//   d reads 8 query values (one broadcast address a warp) and 8 list values
//   (two 16-byte loads, contiguous over the lanes) and issues 64 FMAs;
// - stages the tile's scores in shared memory and selects among them during
//   the next tile's product, query i at slab i mod the slabs, so that the
//   selection's latency hides behind the FMAs of the SM's other warps; after its first
//   tile, publishes each query's part of the bound its chunks share.
// The selection keeps, for each query of the chunk, a superset of its nprobe
// least keys, warp-private, behind a bound (a key at or above it is not
// taken), one ballot a list a lane, no atomics: a buffer of 2P candidates in
// shared memory, unsorted (P, 32 or 64, the least power of two >= max(nprobe,
// 32)). The bound: on the chunk's first tile the warp's largest r-th key of a
// lane (32 r >= nprobe keys lie at or below it); then the bound shared by the
// query's chunks (each chunk publishes the high word past its first tile's
// m-th least lane minimum, m = ceil(nprobe / chunks), so that nprobe keys lie
// below the largest of them); where the buffer would overflow, a bitonic sort
// in registers keeps the P least and the bound becomes the nprobe-th. Each
// chunk writes its P least candidates within its final bound to the workspace
// (by their ranks among the candidates, where more remain: the block's tail,
// when no FMAs are left to hide a sort's shuffles), and ivf_probes_select
// picks each query's nprobe least of them the same way, a warp a query.
// Sorting is rare in the scan.
//
// Bounds on this card, at the benchmark's IVF shapes (1000 queries, nlist
// 16,384, d=128, nprobe 64): 2 x 1000 x 16,384 x 128 = 4.19e9 f32 operations,
// 62.6 us at 67 TFLOP/s; the bytes (8 MB of centroids, 0.5 MB of queries,
// 0.5 MB of ids) are 3 us from HBM, so the FMAs bound it. What the design
// spends to approach that: 64 FMAs a thread for every four 16-byte shared
// loads (two of them broadcasts), the centroid slabs in flight behind the
// FMAs, a grid of 16 x 8 blocks (one an SM, one wave: the host chooses the
// chunks from nq, nlist and the SMs), and a selection whose common case is a
// compare and a ballot a score, off the FMAs' critical path.
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "scan_common.cuh"

namespace {

using lsq_scan::kFull;
using lsq_scan::mono;
using lsq_scan::unmono;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 64;                 // queries a block
constexpr int kQW = kTQ / kWarps;       // queries a warp: 8
constexpr int kTC = 256;                // lists a tile
constexpr int kBK = 32;                 // coordinates a slab
constexpr int kStages = 2;              // slabs in the ring
constexpr int kMaxD = 128;              // the most coordinates (padded) a query tile holds
constexpr int kPMin = 32;               // the least P: one ballot's appends
constexpr int kMaxProbes = 64;          // the largest nprobe (P = 64)
constexpr int kSelectWarps = 4;         // queries a block of the candidates' selection
constexpr unsigned long long kEmpty = ~0ull;  // an empty slot; the bound before any

// One asynchronous copy of 16 (4) bytes from device to shared memory; where
// !valid nothing is read and the bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// One step (block size kSize, partner distance kStride) of the bitonic
// network that sorts the warp's 32 R keys ascending, key r * 32 + lane in
// v[r]; then the steps after it. Partners within a lane swap registers;
// partners across lanes meet by shuffles. Templates unroll every step, so v
// stays in registers.
template <int R, int kSize, int kStride>
__device__ __forceinline__ void bitonic_steps(unsigned long long (&v)[R], int lane) {
  if constexpr (kStride >= 32) {
    constexpr int kS = kStride / 32;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & kS) == 0) {
        const bool asc = ((r * 32) & kSize) == 0;
        const unsigned long long a = v[r], b = v[r | kS];
        const bool swap = asc ? a > b : a < b;
        v[r] = swap ? b : a;
        v[r | kS] = swap ? a : b;
      }
    }
  } else {
    const bool lower = (lane & kStride) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool asc = ((r * 32 + lane) & kSize) == 0;
      const unsigned long long o = __shfl_xor_sync(kFull, v[r], kStride);
      v[r] = (lower == asc) ? (o < v[r] ? o : v[r]) : (o > v[r] ? o : v[r]);
    }
  }
  if constexpr (kStride > 1) {
    bitonic_steps<R, kSize, kStride / 2>(v, lane);
  } else if constexpr (kSize < 32 * R) {
    bitonic_steps<R, kSize * 2, kSize>(v, lane);
  }
}

// The key r * 32 + lane of v, broadcast to every lane (e < 32 R).
template <int R>
__device__ __forceinline__ unsigned long long element(const unsigned long long (&v)[R], int e) {
  unsigned long long x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if (r == e >> 5) x = v[r];
  return __shfl_sync(kFull, x, e & 31);
}

// The warp's largest of u64 values, one a lane.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// P = 16 R (32 or 64): the 2P candidates buf[0, 2P) (cnt of them written)
// sorted in registers, the P least written back; returns the nprobe-th, the
// new bound.
template <int R>
__device__ __forceinline__ unsigned long long shrink(unsigned long long* buf, int cnt, int nprobe,
                                                     int lane) {
  unsigned long long v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = r * 32 + lane < cnt ? buf[r * 32 + lane] : kEmpty;
  bitonic_steps<R, 2, 1>(v, lane);
#pragma unroll
  for (int r = 0; r < R / 2; ++r) buf[r * 32 + lane] = v[r];
  __syncwarp();
  return element<R>(v, nprobe - 1);
}

// What a query's selection reads of a scored tile: its staged scores (offset
// by the lane's first list), the lane's first list, and nlist.
struct TileView {
  const float* scores;
  int c0;
  int nlist;
};

// The key of the lane's list j (c0 + (j & 3) + (j >> 2) * kTC / 2) of the
// tile: kEmpty where the list is past nlist or its score is not finite.
__device__ __forceinline__ unsigned long long key_of(const TileView& v, int j) {
  const int off = (j & 3) + (j >> 2) * (kTC / 2), col = v.c0 + off;
  if (col >= v.nlist) return kEmpty;
  const float sco = v.scores[off];
  return fabsf(sco) < INFINITY
             ? (static_cast<unsigned long long>(mono(sco)) << 32) | static_cast<uint32_t>(col)
             : kEmpty;
}

struct Selection {
  unsigned long long bound;  // no key at or above it is taken
  int cnt;                   // candidates in the buffer
};

// The functions below run at most once a query and tile, most of them
// rarely, and are not inlined, so that the tile's common path stays small.

// A chunk's first tile: the warp's largest r-th least key
// of a lane, r = ceil(nprobe / 32), plus one; 32 r >= nprobe keys lie below
// it.
__device__ __noinline__ unsigned long long first_bound(TileView v, int nprobe) {
  unsigned long long least = kEmpty, second = kEmpty;  // the lane's two least keys
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned long long k = key_of(v, j);
    if (k < least) {
      second = least;
      least = k;
    } else if (k < second) {
      second = k;
    }
  }
  const unsigned long long x = warp_max(nprobe <= 32 ? least : second);
  return x == kEmpty ? kEmpty : x + 1;
}

// A chunk's first tile, where the query has several chunks: the chunk
// publishes the high word past the m-th least of the lanes' least keys, m =
// ceil(nprobe / chunks) (0xffffffff where m > 32 or the tile has too few):
// every chunk holds m keys below its word, so nprobe keys lie below the
// largest word of the query's chunks (`shared_bound`). Runs as soon as the
// tile is scored, before any selection.
__device__ __noinline__ void publish(TileView v, int nprobe, int chunks, uint32_t* pub_qc,
                                     uint32_t* published_q, int lane) {
  unsigned long long least[1] = {kEmpty};
#pragma unroll
  for (int j = 0; j < 8; ++j) least[0] = min(least[0], key_of(v, j));
  bitonic_steps<1, 2, 1>(least, lane);
  const int m = (nprobe + chunks - 1) / chunks;
  const unsigned long long km = m <= 32 ? element<1>(least, m - 1) : kEmpty;
  if (lane == 0) {
    *pub_qc = km == kEmpty ? 0xffffffffu : static_cast<uint32_t>(km >> 32) + 1;
    __threadfence();
    atomicAdd(published_q, 1u);
  }
}

// The bound below which nprobe of the query's keys lie in its chunks, once
// they have all published (kEmpty where one published none).
__device__ __noinline__ unsigned long long shared_bound(const uint32_t* pub_q, int chunks,
                                                        int lane) {
  __threadfence();
  uint32_t g = 0;
  for (int c = lane; c < chunks; c += 32) g = max(g, __ldcg(pub_q + c));
  g = __reduce_max_sync(kFull, g);
  return g == 0xffffffffu ? kEmpty : static_cast<unsigned long long>(g) << 32;
}

// Make room: the P least of the buffer's cnt candidates, sorted, to its
// front. Returns the new bound, their nprobe-th.
__device__ __forceinline__ unsigned long long make_room(unsigned long long* buf, int cnt, int P,
                                                        int nprobe, int lane) {
  __syncwarp();
  if (P == 32) return shrink<2>(buf, cnt, nprobe, lane);
  return shrink<4>(buf, cnt, nprobe, lane);
}

// make_room, not inlined: for callers that unroll around it.
__device__ __noinline__ unsigned long long make_room_call(unsigned long long* buf, int cnt, int P,
                                                          int nprobe, int lane) {
  return make_room(buf, cnt, P, nprobe, lane);
}

// Take the tile's keys below the bound a list a lane at a time (one ballot
// each), making room first wherever the buffer of 2P would overflow.
__device__ __noinline__ Selection take_shrinking(TileView v, unsigned long long* buf, Selection sel,
                                               int P, int nprobe, int lane) {
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const unsigned long long key = key_of(v, j);
    bool take = key < sel.bound;
    unsigned bal = __ballot_sync(kFull, take);
    if (bal != 0u && sel.cnt + __popc(bal) > 2 * P) {  // warp-uniform
      sel.bound = min(sel.bound, make_room(buf, sel.cnt, P, nprobe, lane));
      sel.cnt = P;
      take = key < sel.bound;
      bal = __ballot_sync(kFull, take);
    }
    if (take) buf[sel.cnt + __popc(bal & ((1u << lane) - 1u))] = key;
    sel.cnt += __popc(bal);
  }
  return sel;
}

// The chunk's candidates of a query to its slot of the workspace, P keys:
// those at or below the final bound (taken under a looser one, a key above it
// is none of the nprobe least; the bound itself may be the nprobe-th key,
// after a shrink); where more than P remain (at most 2P = 128),
// the P least, each at its rank among them (the keys are distinct, one a
// list), counted a lane at a time with no shuffle; kEmpty past them.
__device__ __noinline__ void finish(unsigned long long* buf, Selection sel, int P,
                                    unsigned long long* slot, int lane) {
  int kept = 0;
  for (int r0 = 0; r0 < sel.cnt; r0 += 32) {  // in place: a key moves down, never up
    const unsigned long long key = r0 + lane < sel.cnt ? buf[r0 + lane] : kEmpty;
    const bool keep = key <= sel.bound;
    const unsigned bal = __ballot_sync(kFull, keep);
    __syncwarp();
    if (keep) buf[kept + __popc(bal & ((1u << lane) - 1u))] = key;
    kept += __popc(bal);
  }
  __syncwarp();
  if (kept <= P) {
    for (int r = lane; r < P; r += 32) slot[r] = r < kept ? buf[r] : kEmpty;
    return;
  }
  unsigned long long mine[4];
  int rank[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 4; ++r) mine[r] = r * 32 + lane < kept ? buf[r * 32 + lane] : kEmpty;
#pragma unroll 8
  for (int k = 0; k < kept; ++k) {
    const unsigned long long x = buf[k];
#pragma unroll
    for (int r = 0; r < 4; ++r) rank[r] += x < mine[r];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (rank[r] < P) slot[rank[r]] = mine[r];  // an empty one ranks kept > P
}

__global__ void __launch_bounds__(kThreads, 1)
ivf_probes(const float* __restrict__ q, int nq, int d, const float* __restrict__ ct,
           const float* __restrict__ cn, int nlist, int nprobe, int P, int chunks, bool vec,
           unsigned long long* __restrict__ work, uint32_t* __restrict__ pub,
           uint32_t* __restrict__ published) {
  extern __shared__ __align__(16) float s_mem[];
  __shared__ unsigned long long s_bound[kTQ];
  __shared__ int s_cnt[kTQ];
  __shared__ int s_shared[kTQ];  // the query's shared bound is applied

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ, ch = blockIdx.y;
  const int dpad = (d + kBK - 1) / kBK * kBK;  // at most kMaxD
  float* s_q = s_mem;                          // [dpad][kTQ]
  float* s_c = s_q + kTQ * dpad;               // [kStages][kBK][kTC]
  float* s_sc = s_c + kStages * kBK * kTC;     // [kWarps][kQW][kTC]: a tile's scores
  unsigned long long* s_buf =
      reinterpret_cast<unsigned long long*>(s_sc + kTQ * kTC);  // [queries][2P]
  const int tiles = (nlist + kTC - 1) / kTC;
  const int t_begin = static_cast<int>(static_cast<long long>(tiles) * ch / chunks);
  const int t_end = static_cast<int>(static_cast<long long>(tiles) * (ch + 1) / chunks);
  const int kslabs = dpad / kBK;
  const int nslabs = (t_end - t_begin) * kslabs;
  const bool active = q0 + warp * kQW < nq;  // warp-uniform: the warp has a query

  // Query ql's buffer of 2P candidates.
  auto buffer = [&](int ql) { return s_buf + static_cast<size_t>(ql) * 2 * P; };
  if (active) {
    for (int i = 0; i < kQW; ++i) {
      const int ql = warp * kQW + i;
      if (q0 + ql >= nq) break;
      if (lane == 0) {
        s_bound[ql] = kEmpty;
        s_cnt[ql] = 0;
        s_shared[ql] = chunks == 1;
      }
    }
    __syncwarp();
  }

  // Slab s of the chunk: tile t_begin + s / kslabs, coordinates k0 + [0, kBK).
  auto load_slab = [&](int s) {
    float* dst = s_c + (s % kStages) * kBK * kTC;
    const int c0 = (t_begin + s / kslabs) * kTC, k0 = (s % kslabs) * kBK;
    if (vec) {
      for (int e = tid; e < kBK * kTC / 4; e += kThreads) {
        const int kk = e / (kTC / 4), cc = (e % (kTC / 4)) * 4;
        const bool valid = k0 + kk < d && c0 + cc < nlist;
        cp_async16(dst + kk * kTC + cc,
                   valid ? ct + static_cast<size_t>(k0 + kk) * nlist + c0 + cc : ct, valid);
      }
    } else {
      for (int e = tid; e < kBK * kTC; e += kThreads) {
        const int kk = e / kTC, cc = e % kTC;
        const bool valid = k0 + kk < d && c0 + cc < nlist;
        cp_async4(dst + kk * kTC + cc,
                  valid ? ct + static_cast<size_t>(k0 + kk) * nlist + c0 + cc : ct, valid);
      }
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslabs) load_slab(s);
    cp_async_commit();
  }

  // Query i's selection among tile tp's staged scores.
  float* sc_w = s_sc + warp * kQW * kTC + lane * 4;  // the warp's staged scores
  auto select_query = [&](int tp, int i) {
    const int ql = warp * kQW + i, qq = q0 + ql;
    if (qq >= nq) return;  // warp-uniform
    const TileView v = {sc_w + i * kTC, tp * kTC + lane * 4, nlist};
    Selection sel = {s_bound[ql], s_cnt[ql]};
    unsigned long long* buf = buffer(ql);
    if (tp == t_begin) sel.bound = min(sel.bound, first_bound(v, nprobe));
    if (!s_shared[ql]) {  // warp-uniform: have all the query's chunks published?
      const unsigned done = lane == 0 ? __ldcg(published + qq) : 0u;
      if (static_cast<int>(__shfl_sync(kFull, done, 0)) == chunks) {
        sel.bound =
            min(sel.bound, shared_bound(pub + static_cast<size_t>(qq) * chunks, chunks, lane));
        if (lane == 0) s_shared[ql] = 1;
      }
    }
    // key < bound, compared as (score, list) in f32: the key is built only for
    // the lists taken. A score that is not finite is never taken; an empty
    // bound takes every finite score.
    const float bs =
        sel.bound == kEmpty ? INFINITY : unmono(static_cast<uint32_t>(sel.bound >> 32));
    const int bl = sel.bound == kEmpty ? 0 : static_cast<int>(static_cast<uint32_t>(sel.bound));
    const float4 s0 = *reinterpret_cast<const float4*>(v.scores);
    const float4 s1 = *reinterpret_cast<const float4*>(v.scores + kTC / 2);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    unsigned bal[8];
    int total = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = v.c0 + (j & 3) + (j >> 2) * (kTC / 2);
      bal[j] = __ballot_sync(kFull, col < nlist && fabsf(sc[j]) < INFINITY &&
                                        (sc[j] < bs || (sc[j] == bs && col < bl)));
      total += __popc(bal[j]);
    }
    if (total > 0 && sel.cnt + total <= 2 * P) {  // warp-uniform: the buffer takes them
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (bal[j] >> lane & 1u) {
          const int col = v.c0 + (j & 3) + (j >> 2) * (kTC / 2);
          buf[sel.cnt + __popc(bal[j] & below)] =
              (static_cast<unsigned long long>(mono(sc[j])) << 32) | static_cast<uint32_t>(col);
        }
        sel.cnt += __popc(bal[j]);
      }
    } else if (total > 0) {
      sel = take_shrinking(v, buf, sel, P, nprobe, lane);
    }
    if (lane == 0) {  // read again by the warp after a barrier or __syncwarp
      s_bound[ql] = sel.bound;
      s_cnt[ql] = sel.cnt;
    }
  };

  int s = 0;  // the chunk's slabs in order, across its tiles
  for (int t = t_begin; t <= t_end; ++t) {  // t_end: the last tile's selection alone
    const int ns = t < t_end ? kslabs : 0;
    float cnv[8];  // the squared norms of the lane's lists of the tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = t * kTC + lane * 4 + (j & 3) + (j >> 2) * (kTC / 2);
      cnv[j] = ns > 0 && col < nlist ? __ldg(cn + col) : 0.0f;
    }
    float acc[kQW][8];
#pragma unroll
    for (int i = 0; i < kQW; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int ks = 0; ks < ns; ++ks, ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slab s is in; every warp is done with slab s - 1 and the query tile
      if (s + kStages - 1 < nslabs) load_slab(s + kStages - 1);
      cp_async_commit();
      const int k0 = ks * kBK;
      if (s == 0) {  // block-uniform: the query tile, once
        for (int e = tid; e < kTQ * dpad; e += kThreads) {
          const int ql = e % kTQ, k = e / kTQ, qq = q0 + ql;
          s_q[k * kTQ + ql] = qq < nq && k < d ? __ldg(q + static_cast<size_t>(qq) * d + k) : 0.0f;
        }
        __syncthreads();
      }
      if (!active) continue;
      // The previous tile's queries ks, ks + ns, ... are selected at this
      // slab; the two warps of an SM sub-partition (w and w + 4) select at
      // either end of it, so that one's FMAs cover the other's latency.
      if (t > t_begin && (warp & 4))
        for (int i = ks; i < kQW; i += ns) select_query(t - 1, i);
      const float* sc = s_c + (s % kStages) * kBK * kTC + lane * 4;
      const float* sq = s_q + k0 * kTQ + warp * kQW;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(sq + kk * kTQ);
        const float4 a1 = *reinterpret_cast<const float4*>(sq + kk * kTQ + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(sc + kk * kTC);
        const float4 b1 = *reinterpret_cast<const float4*>(sc + kk * kTC + kTC / 2);
        const float a[kQW] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kQW; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (t > t_begin && !(warp & 4))
        for (int i = ks; i < kQW; i += ns) select_query(t - 1, i);
    }
    if (!active) continue;
    if (t == t_end) {  // the last tile's selection
      for (int i = 0; i < kQW; ++i) select_query(t - 1, i);
      break;
    }
    __syncwarp();  // the warp is done with the previous tile's scores
#pragma unroll
    for (int i = 0; i < kQW; ++i) {  // the scores fma(-2, dot, cn)
      *reinterpret_cast<float4*>(sc_w + i * kTC) =
          make_float4(fmaf(-2.0f, acc[i][0], cnv[0]), fmaf(-2.0f, acc[i][1], cnv[1]),
                      fmaf(-2.0f, acc[i][2], cnv[2]), fmaf(-2.0f, acc[i][3], cnv[3]));
      *reinterpret_cast<float4*>(sc_w + i * kTC + kTC / 2) =
          make_float4(fmaf(-2.0f, acc[i][4], cnv[4]), fmaf(-2.0f, acc[i][5], cnv[5]),
                      fmaf(-2.0f, acc[i][6], cnv[6]), fmaf(-2.0f, acc[i][7], cnv[7]));
    }
    __syncwarp();
    if (t == t_begin && chunks > 1) {
      for (int i = 0; i < kQW && q0 + warp * kQW + i < nq; ++i) {
        const int qq = q0 + warp * kQW + i;
        publish({sc_w + i * kTC, t * kTC + lane * 4, nlist}, nprobe, chunks,
                pub + static_cast<size_t>(qq) * chunks + ch, published + qq, lane);
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  __syncwarp();  // lane 0's last counts
  for (int i = 0; i < kQW; ++i) {
    const int ql = warp * kQW + i;
    if (q0 + ql >= nq) break;
    finish(buffer(ql), {s_bound[ql], s_cnt[ql]}, P,
           work + (static_cast<size_t>(q0 + ql) * chunks + ch) * P, lane);
  }
}

// The nprobe least of a query's chunks x P candidates (the workspace [nq,
// keys], kEmpty where none), a warp a query, by the scan's
// selection: the candidates pass a bound into a buffer of 2P in shared
// memory, 8 loads a lane in flight; the buffer shrinks to its P least where
// it would overflow, and a last shrink sorts them. Written as list ids.
__global__ void __launch_bounds__(kSelectWarps * 32)
ivf_probes_select(const unsigned long long* __restrict__ work, int keys, int nq, int P,
                  int nprobe, long long* __restrict__ out) {
  extern __shared__ unsigned long long s_sel[];  // [kSelectWarps][2P]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kSelectWarps + warp;
  if (qi >= nq) return;  // warp-uniform
  unsigned long long* buf = s_sel + warp * 2 * P;
  const unsigned long long* wq = work + static_cast<size_t>(qi) * keys;
  Selection sel = {kEmpty, 0};
  for (int base = 0; base < keys; base += 32 * 8) {
    unsigned long long k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = base + j * 32 + lane;
      k[j] = e < keys ? __ldcg(wq + e) : kEmpty;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned long long key = k[j];
      bool take = key < sel.bound;
      unsigned bal = __ballot_sync(kFull, take);
      if (bal != 0u && sel.cnt + __popc(bal) > 2 * P) {  // warp-uniform
        sel.bound = min(sel.bound, make_room_call(buf, sel.cnt, P, nprobe, lane));
        sel.cnt = P;
        take = key < sel.bound;
        bal = __ballot_sync(kFull, take);
      }
      if (take) buf[sel.cnt + __popc(bal & ((1u << lane) - 1u))] = key;
      sel.cnt += __popc(bal);
    }
  }
  make_room_call(buf, sel.cnt, P, nprobe, lane);  // the P least, sorted
  for (int i = lane; i < nprobe; i += 32) {
    const unsigned long long key = buf[i];
    out[static_cast<size_t>(qi) * nprobe + i] =
        key == kEmpty ? -1ll : static_cast<long long>(static_cast<uint32_t>(key));
  }
}

}  // namespace

extern "C" {

// Whether the kernel serves queries of d coordinates at this nprobe: d at
// most 128 (the query tile staged once) and nprobe at most 64 (P <= 64).
// Elsewhere the torch form is the faster (ivf.ivf_probes takes it).
int lsq_ivf_probes_serves(int d, int nprobe) {
  return d >= 1 && (d + kBK - 1) / kBK * kBK <= kMaxD && nprobe >= 1 && nprobe <= kMaxProbes;
}

// The uint64 words of the workspace lsq_ivf_probes takes: each query's
// chunks' P candidates, uint64 [nq, chunks, P], then the chunks' shared
// bounds and their count, uint32 [nq, chunks] and [nq].
long long lsq_ivf_probes_work_words(int nq, int chunks, int nprobe) {
  const long long P = pow2_ceil(nprobe < kPMin ? kPMin : nprobe);
  return static_cast<long long>(nq) * chunks * P +
         (static_cast<long long>(nq) * (chunks + 1) + 1) / 2;
}

// The coarse probes of nq queries: q [nq, d] f32; ct [d, nlist] f32 (the
// centroids transposed); cn [nlist] f32 (their squared norms). Writes out
// [nq, nprobe] int64, each query's lists of least cn - 2 q.c closest first
// (ties to the lower id; -1 past the finite scores). work: the workspace of
// lsq_ivf_probes_work_words(nq, chunks, nprobe) words (the call zeroes what
// it needs zeroed). lsq_ivf_probes_serves(d, nprobe); nprobe <= nlist; 1 <=
// chunks <= the tiles of 256 lists.
int lsq_ivf_probes(const void* q, int nq, int d, const void* ct, const void* cn, int nlist,
                   int nprobe, int chunks, void* work, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (nlist + kTC - 1) / kTC;
  if (nq < 1 || nlist < 1 || !lsq_ivf_probes_serves(d, nprobe) || nprobe > nlist ||
      chunks < 1 || chunks > tiles || work == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = pow2_ceil(nprobe < kPMin ? kPMin : nprobe);
  const int dpad = (d + kBK - 1) / kBK * kBK;
  const int smem = 4 * (kTQ * dpad + kStages * kBK * kTC + kTQ * kTC) +
                   (nq < kTQ ? nq : kTQ) * 2 * P * 8;
  cudaError_t err =
      cudaFuncSetAttribute(ivf_probes, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = nlist % 4 == 0 && (reinterpret_cast<uintptr_t>(ct) & 15) == 0;
  unsigned long long* keys = static_cast<unsigned long long*>(work);
  uint32_t* pub = reinterpret_cast<uint32_t*>(keys + static_cast<size_t>(nq) * chunks * P);
  uint32_t* published = pub + static_cast<size_t>(nq) * chunks;
  err = cudaMemsetAsync(published, 0, static_cast<size_t>(nq) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kTQ - 1) / kTQ, chunks);
  ivf_probes<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), nq, d, static_cast<const float*>(ct),
      static_cast<const float*>(cn), nlist, nprobe, P, chunks, vec, keys, pub, published);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_probes_select<<<(nq + kSelectWarps - 1) / kSelectWarps, kSelectWarps * 32,
                      kSelectWarps * 2 * P * 8, st>>>(keys, chunks * P, nq, P, nprobe,
                                                      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* lsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
