// K1, K5, K6: fused code-matmul + surrogate epilogue + SEG-row segment
// minimum.
//
// Replaces syzgydb_tpu/ops/pallas_scan.py::_segmin_ilv_kernel (K1, wrapper
// segment_min_scan_ilv, 32-row segments) and the two archived TPU layouts
// of the same function at a free segment length,
// tools_dev/superseded_kernels.py::_segmin_kernel (K5, transposed (B, Q)
// layout, wrapper segment_min_scan) and ::_segmin_nat_loop_kernel (K6,
// natural layout, wrapper segment_min_scan_nat).  For every query q and
// every SEG-row segment s it writes min over the segment's valid rows r of
// the surrogate distance (scan_tile::surrogate)
//   euclidean: max(|q|^2 - 2 dot + |v_r|^2, 0)
//   cosine:    (1 - clip(dot * rsqrt(|q|^2 |v_r|^2), -1, 1)) / 2,
//              1.0 where |q|^2 |v_r|^2 == 0
// with dot = scale * (q . c_r) + offset * sum(q) for 4/8/16-bit codes and
// the raw q . c_r for 32/64-bit (f32) codes; invalid rows are +inf.  Output
// is (Q, N/SEG) f32 in ORIGINAL segment order, SEG in {16, 32, 64, 128}.
//
// Layout: the TPU kernels needed a segment-interleaved or transposed copy
// of the codes (or a rotate-accumulator) so that Mosaic could fold minima
// over whole lane tiles; the three TPU kernels differ only in that layout.
// Here the codes stay in their natural row-major (N, W) layout and one
// kernel serves every segment length: the tile loop (scan_tile.cuh) leaves
// thread tx holding rows tx + 16 j of a 128-row tile, so segment s of the
// tile is rows tx + 16 j for j in [s*J, (s+1)*J), J = SEG/16.  Each thread
// first folds its J rows of the segment, then a 4-step __shfl_xor_sync
// reduction over the half-warp's 16 lanes finishes it (SEG = 128 folds all
// 8 rows: one segment per tile).
//
// Arithmetic: fp32 FMA at every width (option (i) of the port's design).
// 4/8/16-bit centered codes and f32 codes are exact in f32, queries are not
// rounded, so the only error is f32 accumulation (~D * 2^-24 relative) —
// inside surface_accum_eps.  The same arithmetic serves exact=True.
//
// Bound on the H100: 2*Q*N*D operations.  At Q=1024, N=1M, D=384 that is
// ~0.8 TFLOP: compute-bound (0.8 ms at the 989 TFLOP/s bf16 tensor rate,
// ~12 ms at the 67 TFLOP/s fp32 CUDA-core rate this kernel runs at).  At
// Q <= 64 the codes read (N*D bytes at 8-bit) bounds it instead.  The
// design answers the compute bound with a 64-FMA register tile per
// thread fed by 2 broadcast 128-bit and 8 conflict-free 32-bit shared
// loads per k step; tensor cores (bf16 mma/wgmma with the reference's
// exact hi/lo and bf16x2 code splits), TMA and pipelining are later work.

#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

template <int BITS, bool COSINE, int SEG>
__global__ void __launch_bounds__(NTHREADS)
segmin_kernel(const float* __restrict__ queries,  // (Q, K) f32, zero-padded
              const void* __restrict__ codes,     // (N, row_elems)
              const float* __restrict__ norms,    // (N,)
              const uint8_t* __restrict__ valid,  // (N,) bool
              const float* __restrict__ qn2,      // (Q,)
              const float* __restrict__ qsum,     // (Q,)
              float* __restrict__ out,            // (Q, N / SEG)
              int Q, long N, int K, int row_elems, float scale,
              float offset) {
  static_assert(SEG % TX == 0 && BR % SEG == 0, "SEG must be 16..128");
  constexpr int J = SEG / TX;   // rows of one segment per thread
  constexpr int NS = BR / SEG;  // segments per tile

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const long row0 = static_cast<long>(blockIdx.x) * BR;
  const int q0 = blockIdx.y * BQ;

  float acc[TQ][TR];
  accumulate<BITS>(queries, codes, Q, N, K, row_elems, row0, q0, acc);

  // epilogue: surrogate per (query, row), then the segment minimum
  float vn[TR];
  bool vok[TR];
#pragma unroll
  for (int j = 0; j < TR; ++j) {
    const long row = row0 + tx + TX * j;
    vok[j] = row < N && valid[row] != 0;
    vn[j] = row < N ? norms[row] : 0.f;
  }
  const long nseg = N / SEG;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = q0 + ty * TQ + i;
    const bool qok = q < Q;  // whole half-warp shares q: no divergence
    const float n2 = qok ? qn2[q] : 0.f;
    const float off = qok ? offset * qsum[q] : 0.f;
    float d[TR];
#pragma unroll
    for (int j = 0; j < TR; ++j)
      d[j] = surrogate<COSINE>(acc[i][j], scale, off, n2, vn[j], vok[j]);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float m = d[s * J];
#pragma unroll
      for (int jj = 1; jj < J; ++jj) m = fminf(m, d[s * J + jj]);
#pragma unroll
      for (int lane = TX / 2; lane >= 1; lane >>= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, lane));
      const long seg = row0 / SEG + s;
      if (qok && tx == s && seg < nseg) out[static_cast<long>(q) * nseg + seg] = m;
    }
  }
}

template <int BITS, int SEG>
void launch(bool cosine, dim3 grid, cudaStream_t st, const float* queries,
            const void* codes, const float* norms, const uint8_t* valid,
            const float* qn2, const float* qsum, float* out, int Q, long N,
            int K, int row_elems, float scale, float offset) {
  if (cosine)
    segmin_kernel<BITS, true, SEG><<<grid, NTHREADS, 0, st>>>(
        queries, codes, norms, valid, qn2, qsum, out, Q, N, K, row_elems,
        scale, offset);
  else
    segmin_kernel<BITS, false, SEG><<<grid, NTHREADS, 0, st>>>(
        queries, codes, norms, valid, qn2, qsum, out, Q, N, K, row_elems,
        scale, offset);
}

template <int SEG>
int launch_bits(int bits, bool cosine, dim3 grid, cudaStream_t st,
                const float* queries, const void* codes, const float* norms,
                const uint8_t* valid, const float* qn2, const float* qsum,
                float* out, int Q, long N, int K, int row_elems, float scale,
                float offset) {
  switch (bits) {
    case 4:
      launch<4, SEG>(cosine, grid, st, queries, codes, norms, valid, qn2,
                     qsum, out, Q, N, K, row_elems, scale, offset);
      return 0;
    case 8:
      launch<8, SEG>(cosine, grid, st, queries, codes, norms, valid, qn2,
                     qsum, out, Q, N, K, row_elems, scale, offset);
      return 0;
    case 16:
      launch<16, SEG>(cosine, grid, st, queries, codes, norms, valid, qn2,
                      qsum, out, Q, N, K, row_elems, scale, offset);
      return 0;
    case 32:
      launch<32, SEG>(cosine, grid, st, queries, codes, norms, valid, qn2,
                      qsum, out, Q, N, K, row_elems, scale, offset);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point (bound with ctypes).  bits selects the code decoding: 4
// (packed nibbles, K = 2 * row_elems), 8, 16, or 32 (f32 codes, also used
// for 64-bit collections).  For 32-bit pass scale = 1, offset = 0.  seg is
// 16, 32, 64 or 128, and N must be a multiple of it.  Returns
// cudaGetLastError() after the launch.
extern "C" int segmin_launch(const float* queries, const void* codes,
                             const float* norms, const uint8_t* valid,
                             const float* qn2, const float* qsum, float* out,
                             int Q, long N, int K, int row_elems, int bits,
                             int cosine, float scale, float offset, int seg,
                             void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((N + BR - 1) / BR),
                  static_cast<unsigned>((Q + BQ - 1) / BQ));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (seg) {
    case 16:
      rc = launch_bits<16>(bits, cosine, grid, st, queries, codes, norms,
                           valid, qn2, qsum, out, Q, N, K, row_elems, scale,
                           offset);
      break;
    case 32:
      rc = launch_bits<32>(bits, cosine, grid, st, queries, codes, norms,
                           valid, qn2, qsum, out, Q, N, K, row_elems, scale,
                           offset);
      break;
    case 64:
      rc = launch_bits<64>(bits, cosine, grid, st, queries, codes, norms,
                           valid, qn2, qsum, out, Q, N, K, row_elems, scale,
                           offset);
      break;
    case 128:
      rc = launch_bits<128>(bits, cosine, grid, st, queries, codes, norms,
                            valid, qn2, qsum, out, Q, N, K, row_elems, scale,
                            offset);
      break;
    default:
      rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
