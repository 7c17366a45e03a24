// K4 in fp32 FMA: the full (Q, N) surrogate-distance surface, for the code
// widths the int8 route (segmin_i8.cu) does not take: 4-, 16-bit and f32
// (32- and 64-bit collections) codes, and 8-bit codes when called directly.
//
// Replaces syzgydb_tpu/ops/pallas_scan.py::_surface_kernel (wrapper
// score_surface).  For every query q and row r it writes the surrogate
// distance of scan_tile::surrogate (squared euclidean, or (1 - cos) / 2
// with 1.0 for a zero query or zero row), +inf for an invalid row, as f32
// (exact) or bf16 rounded to nearest from the f32 value.  The TPU kernel
// rounded queries to bf16 for 4- and 8-bit codes outside exact mode; this
// one rounds neither queries nor codes (fp32 FMA, as K1), so its f32 output
// is the exact-mode surface at every width and its bf16 output differs
// from that only by the final rounding.  Like the TPU kernel, which keeps
// the whole (Q, D) query block resident and grids over N alone, the small
// query tiles (16, 32) stream each code row once per launch.
//
// Design: the tile loop of scan_tile.cuh (query-tile variants chosen from Q
// by ops/scan.py::fp32_query_tile, a cp.async ring of raw code stages) with
// a store epilogue: a thread holds runs of 4 consecutive rows, so for
// each of its queries the 16 row lanes of a half-warp store 256 contiguous
// bytes (f32) or 128 (bf16) along N, 16 or 8 bytes a lane when N is a
// multiple of 4.  The Collection's non-fused branch (radius
// escalation, and batches past the fused scan's k bound) selects its
// candidates from this surface.
//
// Bound on the H100 (1,048,576 x 384): at Q = 16 on f32 codes the 1.61 GB
// of codes (0.48 ms at 3.35 TB/s) outweigh the 64 MiB surface and the
// 0.19 ms of fp32 FMAs; on 4- and 16-bit codes the FMAs bound it; at
// Q = 128 the FMAs (1.54 ms at 67 TFLOP/s) bound it, the 512 MiB f32
// surface taking 0.16 ms of bytes.

#include <cuda_bf16.h>

#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int BQ, bool COSINE, typename OutT>
struct Surface {
  static constexpr int TQ = Tile<BQ>::TQ;

  static __device__ __forceinline__ void tile(const Args& a,
                                              const float (&acc)[TQ][TR],
                                              const Lane<BQ>& l, int q0,
                                              long row0) {
    float vn[TR];
    bool vok[TR];
    row_terms<BQ>(a, l, row0, vn, vok);
    OutT* out = static_cast<OutT*>(a.out);
    const bool vec = (a.N & 3) == 0;  // every run of 4 is 4-aligned
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int q = q0 + l.query(i);
      if (q >= a.Q) continue;
      const float n2 = a.qn2[q];
      const float off = a.offset * a.qsum[q];
      OutT* orow = out + static_cast<long>(q) * a.N;
#pragma unroll
      for (int h = 0; h < TR / 4; ++h) {
        const long r = row0 + l.row(h * 4);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = surrogate<COSINE>(acc[i][h * 4 + j], a.scale, off, n2,
                                   vn[h * 4 + j], vok[h * 4 + j]);
        if (vec && r + 3 < a.N) {
          store4(orow + r, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (r + j < a.N) store1(orow + r + j, v[j]);
        }
      }
    }
  }
};

template <int BQ>
using SurfCosF = Surface<BQ, true, float>;
template <int BQ>
using SurfEucF = Surface<BQ, false, float>;
template <int BQ>
using SurfCosB = Surface<BQ, true, __nv_bfloat16>;
template <int BQ>
using SurfEucB = Surface<BQ, false, __nv_bfloat16>;

}  // namespace

// C entry point (bound with ctypes).  Arguments as segmin_launch's, with
// out (Q, N) f32 when out_bf16 == 0, else (Q, N) bf16, in place of seg; any
// N.  Returns cudaGetLastError() after the launch.
extern "C" int surface_launch(const float* qt, const void* codes,
                              const float* norms, const uint8_t* valid,
                              const float* qn2, const float* qsum, void* out,
                              int Q, int Qp, long N, int Kp, int row_bytes,
                              int bits, int cosine, float scale, float offset,
                              int out_bf16, int tile, int vec, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const Args a{qt,  static_cast<const uint8_t*>(codes), norms, valid, qn2,
               qsum, out, Q, Qp, N, Kp, row_bytes, scale, offset, vec, 0};
  if (bad_args(a, bits, tile)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return cosine ? launch_bits<SurfCosB>(a, bits, tile, st)
                  : launch_bits<SurfEucB>(a, bits, tile, st);
  return cosine ? launch_bits<SurfCosF>(a, bits, tile, st)
                : launch_bits<SurfEucF>(a, bits, tile, st);
}
