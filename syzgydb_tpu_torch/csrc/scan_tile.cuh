// The code-matmul tile loop shared by K1/K5/K6 (segmin.cu) and K4
// (surface.cu): a block owns a BQ x BR tile of (queries x rows), stages the
// code tile (decoded to f32) and the query tile in shared memory, and every
// thread accumulates a TQ x TR register tile of raw dots q . c_r in fp32
// FMA.  Thread tx of a 16-wide row group holds rows tx + 16 j, so any
// 16-aligned run of rows is spread over the 16 tx lanes of one half-warp.
//
// Arithmetic: 4/8/16-bit centered codes and f32 codes are exact in f32 and
// queries are not rounded, so the only error is f32 accumulation
// (~D * 2^-24 relative), inside ops/scan.py's surface_accum_eps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_tile {

constexpr int TX = 16;           // threads along rows
constexpr int TY = 16;           // threads along queries
constexpr int TQ = 8;            // queries per thread
constexpr int TR = 8;            // rows per thread (rows tx + 16 j)
constexpr int BQ = TY * TQ;      // 128 queries per block
constexpr int BR = TX * TR;      // 128 rows per block
constexpr int BK = 32;           // decoded dims per shared-memory stage
constexpr int NTHREADS = TX * TY;
constexpr int CS_STRIDE = BR + 1;  // odd: conflict-free transposed stores

// decoded value of dim k of row `row` (f32; centered code for 4/8/16-bit;
// 4-bit: high nibble = even dim, the disk nibble order)
template <int BITS>
__device__ __forceinline__ float decode(const void* codes, long row, int k,
                                        int row_elems) {
  if (BITS == 4) {
    uint8_t b = static_cast<const uint8_t*>(codes)[row * row_elems + (k >> 1)];
    int nib = (k & 1) ? (b & 0xF) : (b >> 4);
    return static_cast<float>(nib - 8);
  } else if (BITS == 8) {
    return static_cast<float>(
        static_cast<const int8_t*>(codes)[row * row_elems + k]);
  } else if (BITS == 16) {
    return static_cast<float>(
        static_cast<const int16_t*>(codes)[row * row_elems + k]);
  } else {
    return static_cast<const float*>(codes)[row * row_elems + k];
  }
}

// acc[i][j] = q_(q0 + ty*TQ + i) . c_(row0 + tx + TX*j) over all K dims
// (zero for queries >= Q or rows >= N).  Every thread of the block must
// call it: it synchronises the block.
template <int BITS>
__device__ __forceinline__ void accumulate(const float* __restrict__ queries,
                                           const void* __restrict__ codes,
                                           int Q, long N, int K, int row_elems,
                                           long row0, int q0,
                                           float (&acc)[TQ][TR]) {
  __shared__ __align__(16) float Qs[BK][BQ];
  __shared__ float Cs[BK][CS_STRIDE];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // code tile: consecutive threads walk the dims of one row (coalesced)
    for (int idx = tid; idx < BR * BK; idx += NTHREADS) {
      const int r = idx / BK, kk = idx % BK;
      const long row = row0 + r;
      const int k = k0 + kk;
      Cs[kk][r] = (row < N && k < K) ? decode<BITS>(codes, row, k, row_elems)
                                     : 0.f;
    }
    // query tile: consecutive threads walk queries (conflict-free stores)
    for (int idx = tid; idx < BQ * BK; idx += NTHREADS) {
      const int qq = idx % BQ, kk = idx / BQ;
      const int q = q0 + qq;
      const int k = k0 + kk;
      Qs[kk][qq] = (q < Q && k < K) ? queries[static_cast<long>(q) * K + k]
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Qs[kk][ty * TQ]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Qs[kk][ty * TQ + 4]);
      const float a[TQ] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TR];
#pragma unroll
      for (int j = 0; j < TR; ++j) b[j] = Cs[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// surrogate distance of one (query, row) pair from its raw dot:
//   euclidean: max(|q|^2 - 2 dot + |v|^2, 0)
//   cosine:    (1 - clip(dot * rsqrt(|q|^2 |v|^2), -1, 1)) / 2, 1.0 where
//              |q|^2 |v|^2 == 0
// with dot = scale * raw + off (off = offset * sum(q)); +inf where !ok
template <bool COSINE>
__device__ __forceinline__ float surrogate(float raw, float scale, float off,
                                           float n2, float vn, bool ok) {
  const float dot = scale * raw + off;
  float s;
  if (COSINE) {
    const float den = n2 * vn;
    float c = den > 0.f ? dot * rsqrtf(den) : -1.f;
    c = fminf(fmaxf(c, -1.f), 1.f);
    s = (1.f - c) * 0.5f;
  } else {
    s = fmaxf(n2 - 2.f * dot + vn, 0.f);
  }
  return ok ? s : __int_as_float(0x7f800000);
}

}  // namespace scan_tile
