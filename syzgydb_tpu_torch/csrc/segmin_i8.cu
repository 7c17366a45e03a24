// K1, K5/K6 and K4 for 8-bit codes, and K1 and K5/K6 for 16-bit codes, on
// int8 tensor cores: one fused code-matmul with exact integer products, the
// surrogate epilogue, and one of three stores: segment minima at seg 32 (K1)
// or 16/64/128 (K5/K6), or the full surface (K4, 8-bit codes only).
//
// Replaces, for 8-bit codes (and for 16-bit codes, the segment minima):
//  - syzgydb_tpu/ops/pallas_scan.py::_segmin_ilv_kernel (K1, wrapper
//    segment_min_scan_ilv) and tools_dev/superseded_kernels.py::
//    _segmin_kernel / ::_segmin_nat_loop_kernel (K5/K6, wrappers
//    segment_min_scan / segment_min_scan_nat): for every query q and every
//    SEG-row segment s, min over the segment's valid rows r of
//    scan_tile::surrogate (see segmin.cu), invalid rows +inf, as a
//    (Q, N/SEG) f32 surface in ORIGINAL segment order (epilogue SegMin);
//  - syzgydb_tpu/ops/pallas_scan.py::_surface_kernel (K4, wrapper
//    score_surface): every (q, r) surrogate, invalid rows +inf, as a (Q, N)
//    f32 surface or bf16 rounded to nearest from the same f32 value
//    (epilogue Surface).
// Other widths, K4 at 16 bits, 16-bit rows past D = 992 and 16-bit
// batches of Q <= 16 on rows narrower than D = 512 stay on segmin.cu and
// surface.cu's fp32 kernels (ops/scan.py::_route dispatches by width,
// kernel and shape).
//
// Arithmetic.  The codes are int8 in device memory, row-major (N, D): that
// is the "col" B operand of mma.sync.m16n8k32.row.col.s32.s8.s8.s32, so
// they go from HBM to shared memory to fragments with no decode.  The
// wrapper (ops/scan.py::slice_queries) splits each f32 query into S = 3
// int8 slices with a per-query power-of-two scale,
//   q_hat = scale * (a_0 + a_1 2^-7 + a_2 2^-14),
// |a_0| <= 127, |a_1|, |a_2| <= 64, zero-padded to Kp = D rounded up to 32.
// Each slice's dot with the codes is an exact int32 sum (|sum| <= 127 * 128
// * Kp < 2^31 for D <= 2^17); the three combine exactly in int64 and the
// raw dot is rounded once to f32 (combine()):
//   dot_raw = f32(A_0 2^14 + A_1 2^7 + A_2) * 2^-14 * scale.
// The epilogue is scan_tile::surrogate with qn2 and qsum of the UNROUNDED
// query, so every output carries the query-slicing error (dq_rel, computed
// exactly by the wrapper and carried by ops/scan.py::surface_delta) and f32
// epilogue rounding, nothing from the products.
//
// 16-bit codes (BITS = 16).  A centred int16 code c splits exactly into a
// signed high byte and an unsigned low byte, c = 256 hi + lo, hi = c >> 8
// in [-128, 127], lo = c & 0xFF in [0, 255].  The codes stay int16,
// row-major (N, D), in device memory (no second copy); a stage still holds
// BK = 128 bytes of a row, 64 codes, and the bytes are separated on the way
// to the tensor cores: one ldmatrix.x4 brings a thread codes 2t, 2t + 1 of
// four 8-code chunks of its row, and __byte_perm gathers their high bytes
// into one B fragment pair and their low bytes into another.  That order
// of K inside each 32-code block (slot p holds code (p & 16) + 8 bit1(p) +
// 2 ((p >> 2) & 3) + bit0(p)) is the order the wrapper gives the query
// slices (ops/scan.py::hilo_order), so each A fragment, loaded once,
// multiplies both: mma .s8.s8 with the high bytes, .s8.u8 with the low
// ones.  Each slice's two sums are exact int32 (|sum_lo| <= 255 * 127 * Kp
// < 2^31 for Kp <= 65,536; |sum_hi| <= 128 * 127 * Kp), and combine_hilo()
// forms sum_s 2^(14 - 7s) (256 H_s + L_s) exactly in int64 (|v| < 2^52)
// and rounds it once to f32, so the epilogue sees what the 8-bit form
// gives: every output carries dq_rel and f32 epilogue rounding alone.  The
// 16-bit form runs the resident-slice kernel only (Kp <= 992 on the H100,
// as segmin_i8_hilo_max_dims reports it); ops/scan.py sends wider 16-bit
// rows to the fp32 kernels.
//
// Bound on the H100: at Q = 1024, N = 1M, D = 384 the 3-slice int8 products
// are 2*3*Q*N*D = 2.5 Tops, 1.25 ms at the 1,979 TOP/s dense int8 rate
// (the bf16 yardstick of 2*Q*N*D over 989 TFLOP/s is 0.83 ms); at Q <= 64
// the codes read (N*D bytes, 0.12 ms) bounds the segment minima instead.
// K4 stores 4 (f32) or 2 (bf16) bytes per (q, r): at Q = 128 its 512 MiB
// f32 surface (0.16 ms at 3.35 TB/s) and the codes bound it.  mma.sync
// itself reaches 1,254 TOP/s int8 fed from registers (tools/mma_rate.py,
// H100 80GB HBM3 at 700 W), a 2.0 ms floor for the Q = 1024 products; what
// this kernel spends beyond it goes to feeding the tensor cores from shared
// memory (ldmatrix, 5 per 12 MMAs; 7 per 24 at 16 bits) and to the
// epilogue.  At 16 bits the products double: 2*6*Q*N*D, at Q = 1024, N =
// 1M, D = 960 11.8 Tops, 5.96 ms at 1,979 TOP/s and 9.4 ms at the rate
// mma.sync reaches (the bf16 yardstick 2*Q*N*D/989 TFLOP/s is 1.99 ms);
// it takes 25.7 ms there (the fp32 kernels 54.4 ms; H100 80GB HBM3 at
// 700 W), at 168-204 registers a thread and no spills.  Per k32 step a
// warp reads 3.5 KB of fragments from shared memory for 24 MMAs, about
// what the SM's shared-memory bandwidth serves in the time the tensor
// cores take for them, so the byte split stays in registers: a pass that
// deinterleaved each stage into high and low planes in shared memory
// (B then loaded as at 8 bits) measured 27.5-27.7 ms there against
// 25.2-25.4 ms in the same process.  wgmma, which reads its operands from
// shared memory itself, is the way past it.  At Q <= 64 both widths and
// the fp32 kernels stream the codes at 1.0-1.4 TB/s whatever Q, and the
// 16-bit form adds ~0.23 ms a million rows that D does not scale (its
// int64 combine and epilogue), so at Q <= 16 the fp32 kernel is the faster
// below D = 512 (1M x 384, Q = 16: 0.80 against 0.77 ms).  A deeper ring
// (16 stages), slice rows cut to Q and the streams' warps interleaved
// across schedulers did not move it there (0.976 ms at 4 and 16 stages in
// one process) and, as run-time parameters, cost 10-20% at Q = 1024.
//
// Design: one product loop, three epilogues.  The loads, the slices'
// residency, products() and combine() are shared; the epilogue is a
// template parameter (EP) of both kernels, and a unit of work is EP::ROWS
// rows: one output segment for SegMin at SEG >= 32 (SEG/32 consecutive
// 32-row warp tiles, the minimum carried in registers across them and
// stored after the last), one 32-row tile otherwise (SegMin<16>: two
// outputs, n8 tiles 0-1 and 2-3; Surface: 32 rows).
//
// segmin_i8_res_kernel, every Kp whose slices fit shared memory (D <= 992
// on the H100).  Slices streamed beside every code tile would be re-read
// from L2 with every tile, and an epilogue that every warp of a block runs
// at the same step leaves the tensor cores idle.  So:
//  - The block's 64-query tile of slices (3 x 64 rows x Kp bytes) is loaded
//    once and stays in shared memory; only the codes stream, and a code row
//    is read once per 64 queries (16 times at Q = 1024, once at Q <= 64).
//  - The block's two halves (4 warps each, one 16-query quarter of the
//    tile a warp) are independent row streams: each walks its own units
//    through its own 4-stage cp.async ring (BK = 128 bytes of K a stage,
//    rows padded to 144 bytes so ldmatrix.x4 is conflict-free),
//    synchronised by its own named barrier.  The streams drift apart, so
//    one stream's epilogue runs while the other's products and loads
//    proceed.  Each 32-row tile's last stage also brings its 32 norms and
//    validity bytes.
//  - A warp's tile is 16 queries x 32 rows: S m16 tiles (the S slices of
//    its 16 queries, so each thread holds every slice of its queries in C
//    rows lane/4 and lane/4 + 8 and combines them in registers) by 4 n8
//    tiles.  A thread holds rows j*8 + tig*2 + c, c = 0, 1: SegMin folds
//    them and two __shfl_xor_sync over lane%4 finish a minimum; Surface
//    stores the pair as one float2 (or __nv_bfloat162), so a quad writes
//    one 32-byte (16-byte) run per (query, n8 tile).  Warps whose queries
//    lie past Q skip their products and epilogue, so Q = 8 costs little
//    beyond the codes' read.  (This layout, 144 registers a thread,
//    measured faster at Q = 1024, 64 and 8 than 2-warp streams of 32-query
//    warps at 227 registers.)
//  - Blocks: query tiles x row ranges of whole units, one block per SM;
//    the blocks of one row range walk the same rows together, so a code
//    tile comes from HBM once and from L2 for the other query tiles.
//  - Code rows start at row*D bytes: D % 16 == 0 takes 16-byte copies,
//    D % 4 == 0 4-byte copies, any other D byte copies (synchronous); the K
//    tail (D..Kp) and rows past N are zero-filled, and rows past N are
//    never stored (the wrapper pads norms and validity to whole 32-row
//    tiles).
// Past that Kp segmin_i8_stream_kernel runs the same warp tiles with the
// slices streamed beside the codes through one block-wide ring; a stage
// holds each warp's next 32-row tile of its own unit (8-bit codes only).
// wgmma/TMA, the 4-bit form, the streamed 16-bit form and K4 at 16 bits
// are later work.

#include <algorithm>

#include <cuda_bf16.h>

#include "scan_tile.cuh"

namespace {

constexpr int S = 3;               // query slices (ops/scan.py I8_SLICES)
constexpr int TN = 32;             // rows of a warp tile (4 n8 tiles)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MQ = 1;              // m16 query tiles per warp (16 queries)
constexpr int BK = 128;            // bytes of K per stage
constexpr int PITCH = BK + 16;     // 144 bytes: 8 rows, 8 distinct 16-B banks
constexpr int STAGES = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one copy of VEC bytes global -> shared, zero-filled where !ok
template <int VEC>
__device__ __forceinline__ void copy_chunk(int8_t* dst, const int8_t* src,
                                           bool ok) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
  } else {
    *dst = ok ? *src : static_cast<int8_t>(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// named barrier `id` over `n` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const int8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with unsigned B bytes (the low bytes of 16-bit codes)
__device__ __forceinline__ void mma_s8u8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const int8_t* slices;   // (S, Q, Kp) int8
  const float* qscale;    // (Q,) power-of-two slice scale
  const int8_t* codes;    // (N, D) int8 or int16, centered
  const float* norms;     // (N rounded up to 32,)
  const uint8_t* valid;   // (N rounded up to 32,) bool
  const float* qn2;       // (Q,) |q|^2 of the unrounded query
  const float* qsum;      // (Q,) sum(q) of the unrounded query
  void* out;              // the epilogue's: (Q, N / SEG) f32 or (Q, N)
  int Q;
  long N;
  int D;
  int Kp;
  float scale;            // affine dequantization constants
  float offset;
};

// exact floats of small integers, built from their bits with one integer
// op and one float op: x in [0, 2^23), and x in (-2^22, 2^22)
__device__ __forceinline__ float u23_to_f32(int x) {
  return __int_as_float(0x4B000000 | x) - 8388608.f;
}
__device__ __forceinline__ float s22_to_f32(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.f;
}

// f32(A_0 2^14 + A_1 2^7 + A_2) * qlo, qlo = scale * 2^-14.  v is exact in
// int64 (|v| < 2^45); v = h 2^22 + r with |h| < 2^23 and r in [0, 2^22),
// both exact floats, so fmaf(h, 2^22, r) rounds v once (as __ll2float_rn
// would), and the power-of-two qlo scales it exactly.
__device__ __forceinline__ float combine(int a0, int a1, int a2, float qlo) {
  const long long v = static_cast<long long>(a0) * 16384 +
                      static_cast<long long>(a1) * 128 + a2;
  const int h = static_cast<int>(v >> 22);
  const int r = static_cast<int>(v & 0x3FFFFF);
  const float fh = fmaf(s22_to_f32(h >> 12), 4096.f, u23_to_f32(h & 0xFFF));
  return fmaf(fh, 4194304.f, u23_to_f32(r)) * qlo;
}

// 16-bit codes: f32(sum_s 2^(14 - 7s) (256 H_s + L_s)) * qlo, H_s and L_s
// slice s's sums with the high and low bytes.  v is exact in int64 (|v| <
// 2^52 for Kp <= 65,536) and __ll2float_rn rounds it once.
__device__ __forceinline__ float combine_hilo(int h0, int h1, int h2, int l0,
                                              int l1, int l2, float qlo) {
  const long long v =
      (static_cast<long long>(h0) * 256 + l0) * 16384 +
      (static_cast<long long>(h1) * 256 + l1) * 128 +
      (static_cast<long long>(h2) * 256 + l2);
  return __ll2float_rn(v) * qlo;
}

// Per-thread query terms of a warp's queries qb .. qb + 16 MQ - 1: queries
// qb + m*16 + g + 8h (C rows g, g + 8 of m16 tile m).
struct QueryTerms {
  float qlo[MQ][2];
  float n2[MQ][2];
  float off[MQ][2];
};

__device__ __forceinline__ QueryTerms query_terms(const Args& a, int qb,
                                                  int g) {
  QueryTerms t;
#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = min(qb + m * 16 + g + 8 * h, a.Q - 1);
      t.qlo[m][h] = a.qscale[q] * 0x1p-14f;
      t.n2[m][h] = a.qn2[q];
      t.off[m][h] = a.offset * a.qsum[q];
    }
  return t;
}

// the accumulators: one plane of S slices x MQ m16 tiles x 4 n8 tiles a
// code byte (8-bit codes: the codes; 16-bit: the high bytes, then the low)
template <int CB>
using Planes = int[CB][S][MQ][4][4];
template <int BITS>
using Acc = Planes<BITS / 8>;

// the surrogate of query row h of m16 tile m and row j*8 + tig*2 + c of
// the warp's 32-row tile
template <int CB, bool COSINE>
__device__ __forceinline__ float surr(const Args& a, const Planes<CB>& acc,
                                      const QueryTerms& t, float vn, bool ok,
                                      int m, int h, int j, int c) {
  const int e = 2 * h + c;
  float raw;
  if constexpr (CB == 1)
    raw = combine(acc[0][0][m][j][e], acc[0][1][m][j][e],
                  acc[0][2][m][j][e], t.qlo[m][h]);
  else
    raw = combine_hilo(acc[0][0][m][j][e], acc[0][1][m][j][e],
                       acc[0][2][m][j][e], acc[1][0][m][j][e],
                       acc[1][1][m][j][e], acc[1][2][m][j][e], t.qlo[m][h]);
  return scan_tile::surrogate<COSINE>(raw, a.scale, t.off[m][h], t.n2[m][h],
                                      vn, ok);
}

// ---------------------------------------------------------------------------
// epilogues: begin() at a unit's first tile, tile() at each 32-row tile's
// last K stage (tile ti of unit `unit`, rows unit * ROWS + ti * 32 + ...)
// ---------------------------------------------------------------------------

// SEGL-row segment minima -> out (Q, N / SEGL) f32
template <int SEGL, bool COSINE>
struct SegMin {
  static_assert(SEGL == 16 || SEGL == 32 || SEGL == 64 || SEGL == 128,
                "segment lengths the kernel is built for");
  static constexpr int ROWS = SEGL > TN ? SEGL : TN;     // rows of a unit
  static constexpr int PER = SEGL < TN ? TN / SEGL : 1;  // outputs a tile
  static constexpr int JPER = 4 / PER;                   // n8 tiles each

  float mn[MQ][2][PER];

  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int m = 0; m < MQ; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < PER; ++p) mn[m][h][p] = __int_as_float(0x7f800000);
  }

  template <int CB>
  __device__ __forceinline__ void tile(const Args& a, const Planes<CB>& acc,
                                       const QueryTerms& t,
                                       const float (&vn)[4][2],
                                       const bool (&vok)[4][2], int qb,
                                       long unit, int ti, int g, int tig) {
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      if (qb + m * 16 >= a.Q) break;  // warp-uniform: the shuffles stay whole
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            mn[m][h][j / JPER] =
                fminf(mn[m][h][j / JPER],
                      surr<CB, COSINE>(a, acc, t, vn[j][c], vok[j][c], m,
                                       h, j, c));
    }
    if constexpr (ROWS > TN) {
      if (ti != ROWS / TN - 1) return;  // the unit's last tile stores
    }
    const long nseg = a.N / SEGL;
    float* out = static_cast<float*>(a.out);
#pragma unroll
    for (int m = 0; m < MQ; ++m) {
      if (qb + m * 16 >= a.Q) break;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          float v = mn[m][h][p];
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const int q = qb + m * 16 + g + 8 * h;
          const long seg = unit * PER + p;
          if (tig == 0 && q < a.Q && seg < nseg)
            out[static_cast<long>(q) * nseg + seg] = v;
        }
    }
  }
};

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// every surrogate -> out (Q, N) OutT (f32, or bf16 rounded to nearest)
template <typename OutT, bool COSINE>
struct Surface {
  static constexpr int ROWS = TN;

  __device__ __forceinline__ void begin() {}

  template <int CB>
  __device__ __forceinline__ void tile(const Args& a, const Planes<CB>& acc,
                                       const QueryTerms& t,
                                       const float (&vn)[4][2],
                                       const bool (&vok)[4][2], int qb,
                                       long unit, int, int g, int tig) {
    OutT* out = static_cast<OutT*>(a.out);
    // a pair of rows is one aligned store when every (q, r) pair is
    const bool pairs = (a.N & 1) == 0;
#pragma unroll
    for (int m = 0; m < MQ; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qb + m * 16 + g + 8 * h;
        if (q >= a.Q) continue;
        OutT* orow = out + static_cast<long>(q) * a.N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long r = unit * ROWS + j * 8 + tig * 2;
          if (r >= a.N) continue;
          const float x = surr<CB, COSINE>(a, acc, t, vn[j][0], vok[j][0], m,
                                           h, j, 0);
          const float y = surr<CB, COSINE>(a, acc, t, vn[j][1], vok[j][1], m,
                                           h, j, 1);
          if (pairs && r + 1 < a.N) {
            store_pair(orow + r, x, y);
          } else {
            store_one(orow + r, x);
            if (r + 1 < a.N) store_one(orow + r + 1, y);
          }
        }
      }
  }
};

// acc += the warp's queries (A: rows s * arow_stride + i at `as`, pitch
// apitch, byte column acol) x its 32 code rows (B: rows at bs, pitch
// PITCH), over `ksteps` k32 steps (32 bytes of B at 8 bits, 64 at 16); m16
// tiles from `mtiles` on are skipped (warp-uniform)
template <int BITS>
__device__ __forceinline__ void products(Acc<BITS>& acc, const int8_t* as,
                                         int apitch, int arow_stride,
                                         int acol, const int8_t* bs,
                                         int ksteps, int mtiles, int lane) {
#pragma unroll
  for (int ks = 0; ks < BK / (BITS / 8 * 32); ++ks) {
    if (ks >= ksteps) break;
    const int kk = ks * 32;
    // A: matrices (rows 0-7 | 8-15) x (bytes kk | kk + 16)
    uint32_t af[S][MQ][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int m = 0; m < MQ; ++m)
        if (m < mtiles)
          ldmatrix_x4(af[s][m],
                      as + (s * arow_stride + m * 16 + (lane & 7) +
                            ((lane >> 3) & 1) * 8) * apitch +
                          acol + kk + (lane >> 4) * 16);
    if constexpr (BITS == 8) {
      // B: n8 tiles jj, jj+1 x (bytes kk | kk + 16)
      uint32_t bf[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; jj += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (jj * 8 + (lane & 7) + (lane >> 4) * 8) * PITCH +
                           kk + ((lane >> 3) & 1) * 16);
        bf[jj][0] = r[0];
        bf[jj][1] = r[1];
        bf[jj + 1][0] = r[2];
        bf[jj + 1][1] = r[3];
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int m = 0; m < MQ; ++m)
          if (m < mtiles)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_s8(acc[0][s][m][j], af[s][m], bf[j][0], bf[j][1]);
    } else {
      // B, n8 tile j: its 8 rows x the four 8-code chunks of the step's 32
      // codes; a thread gets codes 2 tig, 2 tig + 1 of each chunk, and the
      // high (low) bytes of chunks 0-1 and 2-3 make its b0 and b1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (j * 8 + (lane & 7)) * PITCH + ks * 64 +
                           (lane >> 3) * 16);
        const uint32_t h0 = __byte_perm(r[0], r[1], 0x7531);
        const uint32_t h1 = __byte_perm(r[2], r[3], 0x7531);
        const uint32_t l0 = __byte_perm(r[0], r[1], 0x6420);
        const uint32_t l1 = __byte_perm(r[2], r[3], 0x6420);
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int m = 0; m < MQ; ++m)
            if (m < mtiles) {
              mma_s8(acc[0][s][m][j], af[s][m], h0, h1);
              mma_s8u8(acc[1][s][m][j], af[s][m], l0, l1);
            }
      }
    }
  }
}

template <int CB>
__device__ __forceinline__ void zero(Planes<CB>& acc) {
#pragma unroll
  for (int b = 0; b < CB; ++b)
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int m = 0; m < MQ; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[b][s][m][j][e] = 0;
}

// code rows into rows of PITCH at dst, bytes k0 .. k0 + BK - 1 of each
// row (BITS / 8 bytes a code), by thread tid of nt: smem row i holds code
// row row0 + (i / 32) * rstride + i % 32 (rstride = 32: rows row0 .. row0 +
// nrows - 1).  VEC divides the row's bytes, so a copy is wholly inside or
// outside a row; rows past N and bytes past the row's are zero-filled.
template <int VEC, int BITS>
__device__ __forceinline__ void load_codes(const Args& a, int8_t* dst,
                                           long row0, int nrows, int k0,
                                           int tid, int nt,
                                           long rstride = TN) {
  constexpr int CH = BK / VEC;
  const int rb = a.D * (BITS / 8);  // bytes of a code row
  for (int i = tid; i < nrows * CH; i += nt) {
    const int r = i / CH, c = i % CH;
    const long row = row0 + (r / TN) * rstride + r % TN;
    const int k = k0 + c * VEC;
    const bool ok = row < a.N && k < rb;
    copy_chunk<VEC>(dst + r * PITCH + c * VEC,
                    ok ? a.codes + row * rb + k : a.codes, ok);
  }
}

// ---------------------------------------------------------------------------
// resident slices, two 4-warp row streams
// ---------------------------------------------------------------------------

constexpr int WQ = 4;                  // warps of a stream (query quarters)
constexpr int RBQ = 16 * MQ * WQ;      // 64 queries per block
constexpr int NSTREAMS = NWARPS / WQ;  // 2 row streams per block
constexpr int SLOT = TN * PITCH + TN * 4 + TN;  // codes, norms, valid

__host__ __device__ constexpr int res_apitch(int Kp) { return Kp + 16; }

__host__ __device__ constexpr long res_smem(int Kp) {
  return static_cast<long>(S) * RBQ * res_apitch(Kp) +
         static_cast<long>(NSTREAMS) * STAGES * SLOT;
}

template <int BITS, int VEC, class EP>
__global__ void __launch_bounds__(NTHREADS, 1)
segmin_i8_res_kernel(const Args a, int qtiles, int ranges) {
  constexpr int UT = EP::ROWS / TN;  // 32-row tiles a unit
  constexpr int CB = BITS / 8;       // bytes of a code
  extern __shared__ __align__(128) int8_t smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int p = warp / WQ, wq = warp % WQ;
  const int apitch = res_apitch(a.Kp);
  const int q0 = static_cast<int>(blockIdx.x % qtiles) * RBQ;
  const long range = blockIdx.x / qtiles;
  const long nunits = (a.N + EP::ROWS - 1) / EP::ROWS;
  const long u_lo = nunits * range / ranges;
  const long u_hi = nunits * (range + 1) / ranges;

  // the tile's slices, every K, once: row s * RBQ + (q - q0)
  int8_t* as = smem;
  {
    const int ch = a.Kp / 16;
    for (int i = threadIdx.x; i < S * RBQ * ch; i += NTHREADS) {
      const int r = i / ch, c = i % ch;
      const int q = q0 + r % RBQ;
      const bool ok = q < a.Q;
      copy_chunk<16>(as + r * apitch + c * 16,
                     ok ? a.slices + (static_cast<long>(r / RBQ) * a.Q + q) *
                                         a.Kp + c * 16
                        : a.slices,
                     ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  const int qb = q0 + wq * 16 * MQ;  // this warp's first query
  const int mtiles = min(MQ, max(0, (a.Q - qb + 15) / 16));
  const QueryTerms t = query_terms(a, qb, g);
  const int8_t* as_w = as + wq * 16 * MQ * apitch;

  // this stream's units: u_lo + p, + NSTREAMS, ... < u_hi, each UT tiles
  int8_t* ring = smem + S * RBQ * apitch + p * STAGES * SLOT;
  const long mine = u_hi - u_lo > p
                        ? (u_hi - u_lo - p + NSTREAMS - 1) / NSTREAMS
                        : 0;
  const int nk = (a.Kp * CB + BK - 1) / BK;  // K stages of a tile
  const long total = mine * UT * nk;
  const int sid = wq * 32 + lane;  // thread of the stream

  long issued = 0, ld_u = u_lo + p;
  int ld_t = 0, ld_k = 0;
  auto issue = [&](int slot) {
    if (issued < total) {
      int8_t* st = ring + slot * SLOT;
      const long row0 = ld_u * EP::ROWS + ld_t * TN;
      load_codes<VEC, BITS>(a, st, row0, TN, ld_k * BK, sid, 32 * WQ);
      if (ld_k == nk - 1 && sid < 10) {
        // the tile's norms (8 x 16 B) and validity (2 x 16 B)
        const int8_t* src =
            sid < 8 ? reinterpret_cast<const int8_t*>(a.norms + row0) +
                          sid * 16
                    : reinterpret_cast<const int8_t*>(a.valid + row0) +
                          (sid - 8) * 16;
        copy_chunk<16>(st + TN * PITCH + sid * 16, src, true);
      }
      ++issued;
      if (++ld_k == nk) {
        ld_k = 0;
        if (++ld_t == UT) {
          ld_t = 0;
          ld_u += NSTREAMS;
        }
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts aligned
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  Acc<BITS> acc;
  EP ep;
  long cu = u_lo + p;
  int ct = 0, kc = 0, slot = 0;
  for (long f = 0; f < total; ++f) {
    cp_async_wait<STAGES - 2>();
    bar_sync(1 + p, 32 * WQ);  // stage f landed; the slot read at f-1 is free
    issue((slot + STAGES - 1) % STAGES);

    const int8_t* st = ring + slot * SLOT;
    if (kc == 0) {
      zero(acc);
      if (ct == 0) ep.begin();
    }
    // stage kc holds codes kc * BK / CB ..: the slices' columns from there
    if (mtiles > 0)
      products<BITS>(acc, as_w, apitch, RBQ, kc * (BK / CB), st,
                     min(BK, a.Kp * CB - kc * BK) / (32 * CB), mtiles, lane);
    if (kc == nk - 1 && mtiles > 0) {
      const float* nv = reinterpret_cast<const float*>(st + TN * PITCH);
      const uint8_t* vv =
          reinterpret_cast<const uint8_t*>(st + TN * PITCH + TN * 4);
      float vn[4][2];
      bool vok[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          vn[j][c] = nv[j * 8 + tig * 2 + c];
          vok[j][c] = vv[j * 8 + tig * 2 + c] != 0;
        }
      ep.tile(a, acc, t, vn, vok, qb, cu, ct, g, tig);
    }
    if (++kc == nk) {
      kc = 0;
      if (++ct == UT) {
        ct = 0;
        cu += NSTREAMS;
      }
    }
    slot = (slot + 1) % STAGES;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// streamed slices (Kp past the resident kernel's shared memory)
// ---------------------------------------------------------------------------

constexpr int SBQ = 16 * MQ;            // 16 queries per tile
constexpr int SAROWS = S * SBQ;         // slice rows per stage
constexpr int SBN = NWARPS * TN;        // 256 code rows per stage
constexpr int SSTAGE = (SAROWS + SBN) * PITCH;
constexpr int SSMEM = STAGES * SSTAGE;

// a stage: the query tile's slices and each warp's 32-row tile, warp w's
// rows row0 + w * rstride + 0 .. 31
template <int VEC>
__device__ __forceinline__ void stream_stage(const Args& a, int8_t* st,
                                             int q0, long row0, long rstride,
                                             int k0) {
  constexpr int ACH = BK / 16;
  for (int i = threadIdx.x; i < SAROWS * ACH; i += NTHREADS) {
    const int r = i / ACH, c = i % ACH;
    const int q = q0 + r % SBQ;
    const int k = k0 + c * 16;
    const bool ok = q < a.Q && k < a.Kp;
    copy_chunk<16>(st + r * PITCH + c * 16,
                   ok ? a.slices + (static_cast<long>(r / SBQ) * a.Q + q) *
                                       a.Kp + k
                      : a.slices,
                   ok);
  }
  load_codes<VEC, 8>(a, st + SAROWS * PITCH, row0, SBN, k0, threadIdx.x,
                     NTHREADS, rstride);
}

template <int VEC, class EP>
__global__ void __launch_bounds__(NTHREADS, 1)
segmin_i8_stream_kernel(const Args a) {
  constexpr int UT = EP::ROWS / TN;
  constexpr long GROUP = static_cast<long>(NWARPS) * EP::ROWS;
  extern __shared__ __align__(128) int8_t smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;

  // block units: (16-query tile, NWARPS consecutive EP units, one a warp)
  const int qtiles = (a.Q + SBQ - 1) / SBQ;
  const long nunits = (a.N + EP::ROWS - 1) / EP::ROWS;
  const long units = qtiles * ((a.N + GROUP - 1) / GROUP);
  const int nk = (a.Kp + BK - 1) / BK;
  const long mine = units > blockIdx.x
                        ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;
  const long total = mine * UT * nk;

  // units blockIdx.x, + gridDim.x, ...: query tile fastest, so concurrent
  // blocks share code tiles in L2
  long issued = 0, ld_u = blockIdx.x;
  int ld_t = 0, ld_k = 0;
  auto issue = [&](int slot) {
    if (issued < total) {
      stream_stage<VEC>(a, smem + slot * SSTAGE,
                        static_cast<int>(ld_u % qtiles) * SBQ,
                        (ld_u / qtiles) * GROUP + ld_t * TN, EP::ROWS,
                        ld_k * BK);
      ++issued;
      if (++ld_k == nk) {
        ld_k = 0;
        if (++ld_t == UT) {
          ld_t = 0;
          ld_u += gridDim.x;
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  Acc<8> acc;
  EP ep;
  long cu = blockIdx.x;
  int ct = 0, kc = 0, slot = 0;
  for (long f = 0; f < total; ++f) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage f landed; the slot read at f-1 is free
    issue((slot + STAGES - 1) % STAGES);

    const int8_t* st = smem + slot * SSTAGE;
    const int qb = static_cast<int>(cu % qtiles) * SBQ;
    const int mtiles = min(MQ, (a.Q - qb + 15) / 16);
    const long unit = (cu / qtiles) * NWARPS + warp;  // this warp's unit
    if (kc == 0) {
      zero(acc);
      if (ct == 0) ep.begin();
    }
    products<8>(acc, st, PITCH, SBQ, 0, st + (SAROWS + warp * TN) * PITCH,
                min(BK, a.Kp - kc * BK) / 32, mtiles, lane);
    if (kc == nk - 1 && unit < nunits) {
      float vn[4][2];
      bool vok[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long row = unit * EP::ROWS + ct * TN + j * 8 + tig * 2 + c;
          vn[j][c] = a.norms[row];
          vok[j][c] = a.valid[row] != 0;
        }
      ep.tile(a, acc, query_terms(a, qb, g), vn, vok, qb, unit, ct, g, tig);
    }
    if (++kc == nk) {
      kc = 0;
      if (++ct == UT) {
        ct = 0;
        cu += gridDim.x;
      }
    }
    slot = (slot + 1) % STAGES;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kern, long smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kern, NTHREADS, static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && *per_sm <= 0) e = cudaErrorInvalidConfiguration;
  return e;
}

template <int BITS, int VEC, class EP>
int launch(const Args& a, cudaStream_t st) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long smem = res_smem(a.Kp);
  if (smem <= optin) {
    auto kern = segmin_i8_res_kernel<BITS, VEC, EP>;
    e = prepare(kern, smem, &per_sm, &sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int qtiles = (a.Q + RBQ - 1) / RBQ;
    const long nunits = (a.N + EP::ROWS - 1) / EP::ROWS;
    // about one block per SM: query tiles x row ranges, each range at
    // least one unit per stream
    const long ranges = std::max(
        1L, std::min(static_cast<long>(sms) * per_sm / qtiles,
                     (nunits + NSTREAMS - 1) / NSTREAMS));
    kern<<<static_cast<unsigned>(qtiles * ranges), NTHREADS, smem, st>>>(
        a, qtiles, static_cast<int>(ranges));
  } else if constexpr (BITS != 8) {
    // the 16-bit form is resident only (ops/scan.py routes wider rows to
    // the fp32 kernels)
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kern = segmin_i8_stream_kernel<VEC, EP>;
    e = prepare(kern, SSMEM, &per_sm, &sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long group = static_cast<long>(NWARPS) * EP::ROWS;
    const long units = static_cast<long>((a.Q + SBQ - 1) / SBQ) *
                       ((a.N + group - 1) / group);
    const long grid = std::min(units, static_cast<long>(sms) * per_sm);
    kern<<<static_cast<unsigned>(grid), NTHREADS, SSMEM, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// by code copy width, then metric (EPC: the cosine epilogue, EPE: the
// euclidean one)
template <int BITS, class EPC, class EPE>
int launch_all(const Args& a, bool cosine, int vec, cudaStream_t st) {
  switch (vec) {
    case 16:
      return cosine ? launch<BITS, 16, EPC>(a, st)
                    : launch<BITS, 16, EPE>(a, st);
    case 4:
      return cosine ? launch<BITS, 4, EPC>(a, st)
                    : launch<BITS, 4, EPE>(a, st);
    case 1:
      return cosine ? launch<BITS, 1, EPC>(a, st)
                    : launch<BITS, 1, EPE>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int SEGL>
int launch_segmin(const Args& a, int bits, bool cosine, int vec,
                  cudaStream_t st) {
  using EPC = SegMin<SEGL, true>;
  using EPE = SegMin<SEGL, false>;
  return bits == 16 ? launch_all<16, EPC, EPE>(a, cosine, vec, st)
                    : launch_all<8, EPC, EPE>(a, cosine, vec, st);
}

template <typename OutT>
int launch_surface(const Args& a, bool cosine, int vec, cudaStream_t st) {
  return launch_all<8, Surface<OutT, true>, Surface<OutT, false>>(
      a, cosine, vec, st);
}

// Kp: D rounded up to 32; int32 sums need D <= 2^17 (8-bit) and Kp <=
// 65,536 (16-bit: the low bytes' sums)
bool bad_shape(int D, int Kp, int bits) {
  return Kp % 32 || Kp < D || D > (1 << 17) || (bits != 8 && bits != 16) ||
         (bits == 16 && Kp > (1 << 16));
}

}  // namespace

// the widest 16-bit rows (D) the int8 route takes on the current device:
// the largest Kp whose resident slices and rings fit a block's shared
// memory (992 on the H100), within the low bytes' int32 limit; 0, or a
// cudaError_t from the device queries
extern "C" int segmin_i8_hilo_max_dims(int* dims) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int kp = 0;
  while (kp + 32 <= (1 << 16) && res_smem(kp + 32) <= optin) kp += 32;
  *dims = kp;
  return 0;
}

// C entry points (bound with ctypes).  slices (S, Q, Kp) int8 and qscale
// (Q,) f32 come from ops/scan.py::slice_queries (at 16 bits with each
// 32-dim block of K in ops/scan.py::hilo_order); qn2 and qsum are |q|^2
// and sum(q) of the unrounded f32 queries; codes are (N, D) int8 (bits 8,
// D <= 2^17) or int16 (bits 16, Kp <= 65,536, segment minima only); norms
// and valid start 16-byte aligned and hold N rounded up to a multiple of
// 32 entries (the pad rows are never stored); vec (16, 4 or 1) is the code
// copy width, which must divide a row's bytes and the codes' address.
// Each returns cudaGetLastError() after the launch.

// K1/K5/K6: out (Q, N / seg) f32, seg in {16, 32, 64, 128} dividing N
extern "C" int segmin_i8_launch(const int8_t* slices, const float* qscale,
                                const int8_t* codes, const float* norms,
                                const uint8_t* valid, const float* qn2,
                                const float* qsum, float* out, int Q, long N,
                                int D, int Kp, int bits, int cosine,
                                float scale, float offset, int seg, int vec,
                                void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (bad_shape(D, Kp, bits) || seg <= 0 || N % seg)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{slices, qscale, codes, norms, valid, qn2, qsum, out,
               Q,      N,      D,     Kp,    scale, offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cosn = cosine != 0;
  switch (seg) {
    case 16: return launch_segmin<16>(a, bits, cosn, vec, st);
    case 32: return launch_segmin<32>(a, bits, cosn, vec, st);
    case 64: return launch_segmin<64>(a, bits, cosn, vec, st);
    case 128: return launch_segmin<128>(a, bits, cosn, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4: out (Q, N) f32 when out_bf16 == 0, else bf16; any N; 8-bit codes
extern "C" int surface_i8_launch(const int8_t* slices, const float* qscale,
                                 const int8_t* codes, const float* norms,
                                 const uint8_t* valid, const float* qn2,
                                 const float* qsum, void* out, int Q, long N,
                                 int D, int Kp, int bits, int cosine,
                                 float scale, float offset, int out_bf16,
                                 int vec, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (bad_shape(D, Kp, bits) || bits != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{slices, qscale, codes, norms, valid, qn2, qsum, out,
               Q,      N,      D,     Kp,    scale, offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_surface<__nv_bfloat16>(a, cosine != 0, vec, st)
                  : launch_surface<float>(a, cosine != 0, vec, st);
}
