// Device functions shared by the ADC scan kernels that hold several queries'
// LUTs in shared memory: K2's k2_filter (scan_topk.cu), K3 (scan_select.cu)
// and K4 (scan_key.cu).
//
// - mono / unmono: the order-preserving image of f32 bits, the high half of
//   the 64-bit (dist, id) keys both kernels append;
// - load_codes: kR consecutive rows' codes of one codebook from a staged tile
//   in one shared-memory load;
// - stage_tile: a tile of codes and extra from device memory into shared
//   memory, by 16-byte loads (plain, or cp.async so that the copy overlaps the
//   scoring of the tile before it), with a scalar path for a ragged or
//   unaligned tile;
// - score_rows: the interleaved lookup. G queries' LUTs lie in shared memory
//   as s_lut[(j*h + c)*G + q]; a lane serves the query pair at lq = s_lut + 2p
//   and kR consecutive rows, and one 8-byte load fetches both queries' entries
//   of a code. An entry's G words sit in banks (c mod 32/G)*G + q for even h:
//   the lanes of one row never collide, and the rows a warp serves together
//   collide only where their codes agree mod 32/G.
// - score_rows_bf16, load_entries, load_luts_bf16: the same lookup over bf16
//   tables (K4), 4 or 8 queries' entries of a code in one 8- or 16-byte load.
#pragma once

#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace lsq_scan {

constexpr unsigned kFull = 0xffffffffu;

// Monotone image of a float: a < b as floats iff mono(a) < mono(b) as
// unsigned ints (NaN excluded). -0.0 maps with +0.0, as the two compare equal.
__device__ __forceinline__ uint32_t mono(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unmono(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// kR consecutive rows' codes of one codebook from the staged tile, one load:
// kR bytes for uint8 codes, kR words for int32 (p aligned to the load).
template <int kR>
__device__ __forceinline__ void load_codes(const uint8_t* p, int (&c)[kR]) {
  static_assert(kR == 1 || kR == 2 || kR == 4, "1, 2 or 4 rows a lane");
  if constexpr (kR == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    c[0] = static_cast<int>(w & 255u);
    c[1] = static_cast<int>((w >> 8) & 255u);
    c[2] = static_cast<int>((w >> 16) & 255u);
    c[3] = static_cast<int>(w >> 24);
  } else if constexpr (kR == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    c[0] = static_cast<int>(w & 255u);
    c[1] = static_cast<int>(w >> 8);
  } else {
    c[0] = static_cast<int>(*p);
  }
}

template <int kR>
__device__ __forceinline__ void load_codes(const int32_t* p, int (&c)[kR]) {
  static_assert(kR == 1 || kR == 2 || kR == 4, "1, 2 or 4 rows a lane");
  if constexpr (kR == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  } else if constexpr (kR == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    c[0] = v.x;
    c[1] = v.y;
  } else {
    c[0] = *p;
  }
}

// kR consecutive f32 values (the rows' extra terms), one load.
template <int kR>
__device__ __forceinline__ void load_extra(const float* p, float (&e)[kR]) {
  if constexpr (kR == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  } else if constexpr (kR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    e[0] = v.x;
    e[1] = v.y;
  } else {
    e[0] = *p;
  }
}

// One 16-byte asynchronous copy from device to shared memory (both aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every asynchronous copy this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [base, base + rows) of the codes ([m, n]) and extra into shared
// memory ([m][kTileRows] codes, [kTileRows] extra); rows past `rows` get code
// 0 and extra +inf, so they never score below a threshold. vec: 16-byte
// loads (aligned base pointers, n * sizeof(CodeT) % 16 == 0, base % 16 == 0);
// a ragged or unaligned tile is staged element by element. kAsync: the
// 16-byte loads are cp.async copies, which the caller commits and waits for
// (cp_async_commit, cp_async_wait_all, then a barrier); the element-wise path
// stores directly either way.
template <typename CodeT, int kTileRows, int kBlockThreads, bool kAsync>
__device__ __forceinline__ void stage_tile(CodeT* s_codes, float* s_extra,
                                           const CodeT* __restrict__ bt,
                                           const float* __restrict__ extra, int m, int n,
                                           int base, int rows, bool vec) {
  const int tid = threadIdx.x;
  if (vec && rows == kTileRows) {
    constexpr int kPer = 16 / sizeof(CodeT);
    constexpr int kChunks = kTileRows / kPer;
    for (int e = tid; e < m * kChunks; e += kBlockThreads) {
      const int j = e / kChunks, c = e % kChunks;
      const CodeT* src = bt + static_cast<size_t>(j) * n + base + c * kPer;
      int4* dst = reinterpret_cast<int4*>(s_codes + j * kTileRows) + c;
      if constexpr (kAsync) {
        cp_async16(dst, src);
      } else {
        *dst = *reinterpret_cast<const int4*>(src);
      }
    }
    for (int e = tid; e < kTileRows / 4; e += kBlockThreads) {
      if constexpr (kAsync) {
        cp_async16(reinterpret_cast<float4*>(s_extra) + e,
                   reinterpret_cast<const float4*>(extra + base) + e);
      } else {
        reinterpret_cast<float4*>(s_extra)[e] =
            reinterpret_cast<const float4*>(extra + base)[e];
      }
    }
  } else {
    for (int e = tid; e < m * kTileRows; e += kBlockThreads) {
      const int j = e / kTileRows, r = e % kTileRows;
      s_codes[e] = r < rows ? bt[static_cast<size_t>(j) * n + base + r] : CodeT(0);
    }
    for (int r = tid; r < kTileRows; r += kBlockThreads)
      s_extra[r] = r < rows ? extra[base + r] : INFINITY;
  }
}

// Distances of rows r .. r + kR - 1 of the staged tile for the query pair
// whose entries start at lq = s_lut + 2p: summed in j order, then extra.
template <typename CodeT, int G, int kR, int kTileRows>
__device__ __forceinline__ void score_rows(const float* lq, const CodeT* s_codes,
                                           const float* s_extra, int r, int m, int h,
                                           float (&da)[kR], float (&db)[kR]) {
  int c[kR];
  load_codes<kR>(s_codes + r, c);
#pragma unroll
  for (int u = 0; u < kR; ++u) {
    const float2 v = *reinterpret_cast<const float2*>(lq + c[u] * G);
    da[u] = v.x;
    db[u] = v.y;
  }
  for (int j = 1; j < m; ++j) {
    load_codes<kR>(s_codes + j * kTileRows + r, c);
    const float* lj = lq + j * h * G;
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const float2 v = *reinterpret_cast<const float2*>(lj + c[u] * G);
      da[u] += v.x;
      db[u] += v.y;
    }
  }
  float e[kR];
  load_extra<kR>(s_extra + r, e);
#pragma unroll
  for (int u = 0; u < kR; ++u) {
    da[u] += e[u];
    db[u] += e[u];
  }
}

// Load G queries' [m*h] f32 LUTs (queries q0 .. q0 + G - 1 of nq; zeros past
// nq) into shared memory interleaved as s_lut[e*G + q].
template <int G, int kBlockThreads>
__device__ __forceinline__ void load_luts(float* s_lut, const float* __restrict__ luts,
                                          int q0, int nq, int mh) {
  for (int e = threadIdx.x; e < G * mh; e += kBlockThreads) {
    const int q = e % G;
    s_lut[e] = q0 + q < nq ? luts[static_cast<size_t>(q0 + q) * mh + e / G] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// bf16 tables (K4). G queries' tables lie in shared memory as 16-bit entries
// s_lut[(j*h + c)*G + q]; a lane serves kQ of them (4: one 8-byte load, 8:
// one 16-byte load) and widens each entry to f32 by a shift, so the sums keep
// the bits of f32 adds over the bf16 values.

// The two bf16 halves of a 32-bit word as f32: the lower address first.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// kQ consecutive bf16 entries (queries) of one code, one load from the
// shared-memory window address `addr` (8- or 16-byte aligned), as f32.
template <int kQ>
__device__ __forceinline__ void load_entries(unsigned addr, float (&v)[kQ]) {
  static_assert(kQ == 4 || kQ == 8, "4 or 8 queries a lane");
  if constexpr (kQ == 8) {
    uint4 w;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
                 : "r"(addr));
    v[0] = bf16_lo(w.x);
    v[1] = bf16_hi(w.x);
    v[2] = bf16_lo(w.y);
    v[3] = bf16_hi(w.y);
    v[4] = bf16_lo(w.z);
    v[5] = bf16_hi(w.z);
    v[6] = bf16_lo(w.w);
    v[7] = bf16_hi(w.w);
  } else {
    uint2 w;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(w.x), "=r"(w.y) : "r"(addr));
    v[0] = bf16_lo(w.x);
    v[1] = bf16_hi(w.x);
    v[2] = bf16_lo(w.y);
    v[3] = bf16_hi(w.y);
  }
}

// Distances of rows r .. r + kR - 1 of the staged tile for the kQ queries
// whose entries start at the shared-memory window address lq (that of s_lut
// + kQ*p): the bf16 entries widened to f32 and summed in j order, then extra.
// An entry's address is one multiply-add from its code: the address of
// codebook j's table, plus the code times the G*2 bytes of an entry's row.
template <typename CodeT, int G, int kQ, int kR, int kTileRows>
__device__ __forceinline__ void score_rows_bf16(unsigned lq, const CodeT* s_codes,
                                                const float* s_extra, int r, int m, int h,
                                                float (&d)[kR][kQ]) {
  constexpr unsigned kEntry = G * 2;  // bytes from one code's entries to the next's
  int c[kR];
  load_codes<kR>(s_codes + r, c);
#pragma unroll
  for (int u = 0; u < kR; ++u) load_entries<kQ>(lq + static_cast<unsigned>(c[u]) * kEntry, d[u]);
  unsigned lj = lq;
  for (int j = 1; j < m; ++j) {
    load_codes<kR>(s_codes + j * kTileRows + r, c);
    lj += static_cast<unsigned>(h) * kEntry;
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      float v[kQ];
      load_entries<kQ>(lj + static_cast<unsigned>(c[u]) * kEntry, v);
#pragma unroll
      for (int q = 0; q < kQ; ++q) d[u][q] += v[q];
    }
  }
  float e[kR];
  load_extra<kR>(s_extra + r, e);
#pragma unroll
  for (int u = 0; u < kR; ++u) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) d[u][q] += e[u];
  }
}

// Copy one group's bf16 tables, already interleaved as [m*h][G] in device
// memory (16-byte aligned, `bytes` a multiple of 16), into shared memory by
// cp.async; the caller commits and waits with its first tile.
template <int kBlockThreads>
__device__ __forceinline__ void load_luts_bf16(uint16_t* s_lut,
                                               const uint16_t* __restrict__ group_luts,
                                               int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += kBlockThreads)
    cp_async16(reinterpret_cast<int4*>(s_lut) + e,
               reinterpret_cast<const int4*>(group_luts) + e);
}

}  // namespace lsq_scan
