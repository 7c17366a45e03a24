// K1, K5, K6 in fp32 FMA: fused code-matmul + surrogate epilogue + SEG-row
// segment minimum, for the code widths the int8 route (segmin_i8.cu) does
// not take: 4-, 16-bit and f32 (32- and 64-bit collections) codes, and
// 8-bit codes when called directly.
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
// the raw q . c_r for f32 codes; invalid rows are +inf.  Output is
// (Q, N/SEG) f32 in ORIGINAL segment order, SEG in {16, 32, 64, 128}.
//
// Layout: the TPU kernels needed a segment-interleaved or transposed copy
// of the codes (or a rotate-accumulator) so that Mosaic could fold minima
// over whole lane tiles.  Here the codes stay row-major (N, W) and one
// kernel serves every segment length: in the tile loop (scan_tile.cuh) a
// thread holds runs of 4 consecutive rows, 64 rows apart, and a warp's 16
// row lanes cover 64 consecutive rows with each run, so each thread folds
// its runs (SEG = 128: two runs), and a __shfl_xor_sync over SEG/4 (at
// most 16) row lanes finishes the minimum.
//
// The tile loop's query-tile variants (BQ = 16, 32, 64, 128, chosen from Q
// by ops/scan.py::fp32_query_tile), its cp.async ring of raw code stages
// and what bounds each shape on the H100 are described in scan_tile.cuh:
// at Q = 16 on f32 codes the codes' read bounds it, at Q >= 64 and on 4-
// and 16-bit codes the fp32 FMA rate.  The same arithmetic serves
// exact=True.

#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

template <int BQ, bool COSINE>
struct SegMin {
  static constexpr int TQ = Tile<BQ>::TQ;
  static constexpr int RUNS = TR / 4;  // runs of 4 rows, 64 rows apart

  static __device__ __forceinline__ void tile(const Args& a,
                                              const float (&acc)[TQ][TR],
                                              const Lane<BQ>& l, int q0,
                                              long row0) {
    float vn[TR];
    bool vok[TR];
    row_terms<BQ>(a, l, row0, vn, vok);
    const int seg = a.seg;
    const int lanes = (seg < 64 ? seg : 64) / 4;  // row lanes a segment
    const long nseg = a.N / seg;
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      // every lane computes (the shuffles need the whole warp); queries
      // past Q are not stored
      const int q = q0 + l.query(i);
      const bool qok = q < a.Q;
      const int qc = qok ? q : a.Q - 1;
      const float n2 = a.qn2[qc];
      const float off = a.offset * a.qsum[qc];
      float m[RUNS];  // each run of 4 rows folded
#pragma unroll
      for (int h = 0; h < RUNS; ++h) {
        m[h] = surrogate<COSINE>(acc[i][h * 4], a.scale, off, n2, vn[h * 4],
                                 vok[h * 4]);
#pragma unroll
        for (int j = 1; j < 4; ++j)
          m[h] = fminf(m[h], surrogate<COSINE>(acc[i][h * 4 + j], a.scale,
                                               off, n2, vn[h * 4 + j],
                                               vok[h * 4 + j]));
      }
      if (seg == 128) {  // runs 2p and 2p + 1: one 128-row segment
#pragma unroll
        for (int h = 0; h < RUNS; h += 2) m[h] = fminf(m[h], m[h + 1]);
      }
      for (int o = 1; o < lanes; o <<= 1) {
#pragma unroll
        for (int h = 0; h < RUNS; ++h)
          m[h] = fminf(m[h], __shfl_xor_sync(0xffffffffu, m[h], o));
      }
      if (!qok || l.rl % lanes != 0) continue;
#pragma unroll
      for (int h = 0; h < RUNS; ++h) {
        if (seg == 128 && (h & 1)) continue;
        const long s = (row0 + l.row(h * 4)) / seg;
        if (s < nseg) out[static_cast<long>(q) * nseg + s] = m[h];
      }
    }
  }
};

template <int BQ>
using SegMinCos = SegMin<BQ, true>;
template <int BQ>
using SegMinEuc = SegMin<BQ, false>;

}  // namespace

// C entry point (bound with ctypes).  qt is the (Kp, Qp) f32 queries,
// transposed and zero-padded (Kp a multiple of 16 holding the K decoded
// dims, 4-bit: K = 2 * row_elems; Qp a multiple of `tile`); qn2 and qsum
// are the (Q,) |q|^2 and sum(q); codes are (N, row_bytes) bytes, read in
// copies of `vec` bytes (16, 8, 4, 2 or 1; at most 8 for 4-bit codes),
// which must divide row_bytes and the codes' address.  bits selects the
// decoding: 4 (packed nibbles), 8, 16, or 32 (f32 codes, also used for
// 64-bit collections; pass scale = 1, offset = 0).  seg is 16, 32, 64 or
// 128 and divides N; tile is the query tile, 16, 32, 64 or 128.  Returns
// cudaGetLastError() after the launch.
extern "C" int segmin_launch(const float* qt, const void* codes,
                             const float* norms, const uint8_t* valid,
                             const float* qn2, const float* qsum, float* out,
                             int Q, int Qp, long N, int Kp, int row_bytes,
                             int bits, int cosine, float scale, float offset,
                             int seg, int tile, int vec, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const Args a{qt,  static_cast<const uint8_t*>(codes), norms, valid, qn2,
               qsum, out, Q, Qp, N, Kp, row_bytes, scale, offset, vec, seg};
  if (bad_args(a, bits, tile) ||
      (seg != 16 && seg != 32 && seg != 64 && seg != 128) || N % seg)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cosine ? launch_bits<SegMinCos>(a, bits, tile, st)
                : launch_bits<SegMinEuc>(a, bits, tile, st);
}
