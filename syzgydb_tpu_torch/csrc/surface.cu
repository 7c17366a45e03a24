// K4: the full (Q, N) surrogate-distance surface.
//
// Replaces syzgydb_tpu/ops/pallas_scan.py::_surface_kernel (wrapper
// score_surface).  For every query q and row r it writes the surrogate
// distance of scan_tile::surrogate (squared euclidean, or (1 - cos) / 2
// with 1.0 for a zero query or zero row), +inf for an invalid row, as f32
// (exact) or bf16 rounded to nearest from the f32 value.  The TPU kernel
// rounded queries to bf16 for 4- and 8-bit codes outside exact mode; this
// one rounds neither queries nor codes (fp32 FMA, as K1), so its f32 output
// is the exact-mode surface at every width and its bf16 output differs
// from that only by the final rounding.
//
// Design: K1's tile loop (scan_tile.cuh) without the segment-min epilogue.
// Thread tx holds rows tx + 16 j, so for each (query, j) the 16 lanes of a
// half-warp store 16 consecutive rows: every store instruction of a warp
// writes two full 64-byte (f32) or 32-byte (bf16) runs along N.  The
// Collection's non-fused branch (radius escalation, and batches past the
// fused scan's k bound) selects its candidates from this surface.
//
// Bound on the H100: at Q = 128, N = 1M, D = 384 the 2*Q*N*D = 0.10 TFLOP
// take 0.10 ms at the bf16 tensor rate, while the f32 surface alone is
// 512 MiB (0.16 ms at 3.35 TB/s): the output makes it byte-bound from
// Q ~ 100 at f32.  This kernel runs the products at the fp32 CUDA-core
// rate (~1.5 ms at 67 TFLOP/s), so it is compute-bound in practice;
// tensor cores are the same later work as for K1.

#include <cuda_bf16.h>

#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

__device__ __forceinline__ void store(float* out, long i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store(__nv_bfloat16* out, long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <int BITS, bool COSINE, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
surface_kernel(const float* __restrict__ queries,  // (Q, K) f32, zero-padded
               const void* __restrict__ codes,     // (N, row_elems)
               const float* __restrict__ norms,    // (N,)
               const uint8_t* __restrict__ valid,  // (N,) bool
               const float* __restrict__ qn2,      // (Q,)
               const float* __restrict__ qsum,     // (Q,)
               OutT* __restrict__ out,             // (Q, N)
               int Q, long N, int K, int row_elems, float scale,
               float offset) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const long row0 = static_cast<long>(blockIdx.x) * BR;
  const int q0 = blockIdx.y * BQ;

  float acc[TQ][TR];
  accumulate<BITS>(queries, codes, Q, N, K, row_elems, row0, q0, acc);

  float vn[TR];
  bool vok[TR];
#pragma unroll
  for (int j = 0; j < TR; ++j) {
    const long row = row0 + tx + TX * j;
    vok[j] = row < N && valid[row] != 0;
    vn[j] = row < N ? norms[row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = q0 + ty * TQ + i;
    if (q >= Q) break;  // queries rise with i: the rest are past Q too
    const float n2 = qn2[q];
    const float off = offset * qsum[q];
    const long base = static_cast<long>(q) * N;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const long row = row0 + tx + TX * j;
      if (row < N)
        store(out, base + row,
              surrogate<COSINE>(acc[i][j], scale, off, n2, vn[j], vok[j]));
    }
  }
}

template <int BITS, typename OutT>
void launch(bool cosine, dim3 grid, cudaStream_t st, const float* queries,
            const void* codes, const float* norms, const uint8_t* valid,
            const float* qn2, const float* qsum, OutT* out, int Q, long N,
            int K, int row_elems, float scale, float offset) {
  if (cosine)
    surface_kernel<BITS, true, OutT><<<grid, NTHREADS, 0, st>>>(
        queries, codes, norms, valid, qn2, qsum, out, Q, N, K, row_elems,
        scale, offset);
  else
    surface_kernel<BITS, false, OutT><<<grid, NTHREADS, 0, st>>>(
        queries, codes, norms, valid, qn2, qsum, out, Q, N, K, row_elems,
        scale, offset);
}

template <typename OutT>
int launch_bits(int bits, bool cosine, dim3 grid, cudaStream_t st,
                const float* queries, const void* codes, const float* norms,
                const uint8_t* valid, const float* qn2, const float* qsum,
                OutT* out, int Q, long N, int K, int row_elems, float scale,
                float offset) {
  switch (bits) {
    case 4:
      launch<4>(cosine, grid, st, queries, codes, norms, valid, qn2, qsum,
                out, Q, N, K, row_elems, scale, offset);
      return 0;
    case 8:
      launch<8>(cosine, grid, st, queries, codes, norms, valid, qn2, qsum,
                out, Q, N, K, row_elems, scale, offset);
      return 0;
    case 16:
      launch<16>(cosine, grid, st, queries, codes, norms, valid, qn2, qsum,
                 out, Q, N, K, row_elems, scale, offset);
      return 0;
    case 32:
      launch<32>(cosine, grid, st, queries, codes, norms, valid, qn2, qsum,
                 out, Q, N, K, row_elems, scale, offset);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point (bound with ctypes).  Arguments as segmin_launch's; out is
// (Q, N) f32 when out_bf16 == 0, else (Q, N) bf16.  Returns
// cudaGetLastError() after the launch.
extern "C" int surface_launch(const float* queries, const void* codes,
                              const float* norms, const uint8_t* valid,
                              const float* qn2, const float* qsum, void* out,
                              int Q, long N, int K, int row_elems, int bits,
                              int cosine, float scale, float offset,
                              int out_bf16, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((N + BR - 1) / BR),
                  static_cast<unsigned>((Q + BQ - 1) / BQ));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      out_bf16
          ? launch_bits(bits, cosine, grid, st, queries, codes, norms, valid,
                        qn2, qsum, static_cast<__nv_bfloat16*>(out), Q, N, K,
                        row_elems, scale, offset)
          : launch_bits(bits, cosine, grid, st, queries, codes, norms, valid,
                        qn2, qsum, static_cast<float*>(out), Q, N, K,
                        row_elems, scale, offset);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
