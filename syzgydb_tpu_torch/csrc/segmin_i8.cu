// K1 for 8-bit codes on int8 tensor cores: fused code-matmul + surrogate
// epilogue + 32-row segment minimum, with exact integer products.
//
// Replaces syzgydb_tpu/ops/pallas_scan.py::_segmin_ilv_kernel (K1, wrapper
// segment_min_scan_ilv) for 8-bit codes at 32-row segments: for every query
// q and every 32-row segment s it writes min over the segment's valid rows r
// of scan_tile::surrogate (see segmin.cu), invalid rows +inf, as a (Q, N/32)
// f32 surface in ORIGINAL segment order.  Other widths and segment lengths
// stay on segmin.cu's fp32 kernel (ops/scan.py dispatches by shape).
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
// query, so the surface carries the query-slicing error (dq_rel, computed
// exactly by the wrapper and carried by ops/scan.py::surface_delta) and f32
// epilogue rounding, nothing from the products.
//
// Bound on the H100: at Q = 1024, N = 1M, D = 384 the 3-slice int8 products
// are 2*3*Q*N*D = 2.5 Tops, 1.25 ms at the 1,979 TOP/s dense int8 rate
// (the bf16 yardstick of 2*Q*N*D over 989 TFLOP/s is 0.83 ms); at Q <= 64
// the codes read (N*D bytes, 0.12 ms) bounds it instead.  mma.sync itself
// reaches 1,254 TOP/s int8 fed from registers (tools/mma_rate.py, H100 80GB
// HBM3 at 700 W), a 2.0 ms floor for these products; what this kernel
// spends beyond it goes to feeding the tensor cores from shared memory
// (ldmatrix, 5 per 12 MMAs) and to the surrogate epilogue.  wgmma, which
// reads its operands from shared memory itself, is the way past it.
//
// Design (segmin_i8_res_kernel, every Kp whose slices fit shared memory:
// D <= 992 on the H100).  Slices streamed beside every code tile would be
// re-read from L2 with every tile, and an epilogue that every warp of a
// block runs at the same step leaves the tensor cores idle.  So:
//  - The block's 64-query tile of slices (3 x 64 rows x Kp bytes) is loaded
//    once and stays in shared memory; only the codes stream, and a code row
//    is read once per 64 queries (16 times at Q = 1024, once at Q <= 64).
//  - The block's two halves (4 warps each, one 16-query quarter of the
//    tile a warp) are independent row streams: each walks its own 32-row
//    segments through its own 4-stage cp.async ring (BK = 128 bytes of K a
//    stage, rows padded to 144 bytes so ldmatrix.x4 is conflict-free),
//    synchronised by its own named barrier.  The streams drift apart, so
//    one stream's epilogue runs while the other's products and loads
//    proceed.  A segment's last stage also brings its 32 norms and
//    validity bytes.
//  - A warp's tile is 16 queries x 32 rows: S m16 tiles (the S slices of
//    its 16 queries, so each thread holds every slice of its queries in C
//    rows lane/4 and lane/4 + 8 and combines them in registers) by 4 n8
//    tiles (its segment); two __shfl_xor_sync over lane%4 finish the
//    segment minimum.  Warps whose queries lie past Q skip their products
//    and epilogue, so Q = 8 costs little beyond the codes' read.  (This
//    layout, 144 registers a thread, measured faster at Q = 1024, 64 and 8
//    than 2-warp streams of 32-query warps at 227 registers.)
//  - Blocks: query tiles x row ranges, one block per SM; the blocks of one
//    row range walk the same rows together, so a code tile comes from HBM
//    once and from L2 for the other query tiles.
//  - Code rows start at row*D bytes: D % 16 == 0 takes 16-byte copies,
//    D % 4 == 0 4-byte copies, any other D byte copies (synchronous); the K
//    tail (D..Kp) is zero-filled.
// Past that Kp segmin_i8_stream_kernel runs the same warp tiles with the
// slices streamed beside the codes through one block-wide ring.  wgmma/TMA,
// and the 4/16-bit and seg 16/64/128 forms, are later work.

#include <algorithm>

#include "scan_tile.cuh"

namespace {

constexpr int S = 3;               // query slices (ops/scan.py I8_SLICES)
constexpr int SEG = 32;            // rows per segment (one warp's n extent)
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

struct Args {
  const int8_t* slices;   // (S, Q, Kp) int8
  const float* qscale;    // (Q,) power-of-two slice scale
  const int8_t* codes;    // (N, D) int8, centered
  const float* norms;     // (N,)
  const uint8_t* valid;   // (N,) bool
  const float* qn2;       // (Q,) |q|^2 of the unrounded query
  const float* qsum;      // (Q,) sum(q) of the unrounded query
  float* out;             // (Q, N / 32)
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

// the surrogate of the warp's queries x 32 rows (rows j*8 + tig*2 + c of
// segment `seg`), its segment minimum, and the store of out[q, seg]
template <bool COSINE>
__device__ __forceinline__ void epilogue(const Args& a,
                                         const int (&acc)[S][MQ][4][4],
                                         const QueryTerms& t,
                                         const float (&vn)[4][2],
                                         const bool (&vok)[4][2], int qb,
                                         long seg, int g, int tig) {
  const long nseg = a.N / SEG;
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    if (qb + m * 16 >= a.Q) break;  // warp-uniform: the shuffles stay whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mn = __int_as_float(0x7f800000);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * h + c;
          const float raw = combine(acc[0][m][j][e], acc[1][m][j][e],
                                    acc[2][m][j][e], t.qlo[m][h]);
          mn = fminf(mn, scan_tile::surrogate<COSINE>(
                             raw, a.scale, t.off[m][h], t.n2[m][h], vn[j][c],
                             vok[j][c]));
        }
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, 1));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, 2));
      const int q = qb + m * 16 + g + 8 * h;
      if (tig == 0 && q < a.Q) a.out[static_cast<long>(q) * nseg + seg] = mn;
    }
  }
}

// acc += the warp's queries (A: rows s * arow_stride + i at `as`, pitch
// apitch, byte column acol) x its 32 code rows (B: rows at bs, pitch
// PITCH), over `ksteps` k32 steps; m16 tiles from `mtiles` on are skipped
// (warp-uniform)
__device__ __forceinline__ void products(int (&acc)[S][MQ][4][4],
                                         const int8_t* as, int apitch,
                                         int arow_stride, int acol,
                                         const int8_t* bs, int ksteps,
                                         int mtiles, int lane) {
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
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
            mma_s8(acc[s][m][j], af[s][m], bf[j][0], bf[j][1]);
  }
}

__device__ __forceinline__ void zero(int (&acc)[S][MQ][4][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int m = 0; m < MQ; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][m][j][e] = 0;
}

// code rows row0 .. row0 + nrows - 1, bytes k0 .. k0 + BK - 1, into rows of
// PITCH at dst, by thread tid of nt (VEC divides D, so a copy is wholly
// inside or outside a row; rows past N and bytes past D are zero-filled)
template <int VEC>
__device__ __forceinline__ void load_codes(const Args& a, int8_t* dst,
                                           long row0, int nrows, int k0,
                                           int tid, int nt) {
  constexpr int CH = BK / VEC;
  for (int i = tid; i < nrows * CH; i += nt) {
    const int r = i / CH, c = i % CH;
    const long row = row0 + r;
    const int k = k0 + c * VEC;
    const bool ok = row < a.N && k < a.D;
    copy_chunk<VEC>(dst + r * PITCH + c * VEC,
                    ok ? a.codes + row * a.D + k : a.codes, ok);
  }
}

// ---------------------------------------------------------------------------
// resident slices, two 4-warp row streams
// ---------------------------------------------------------------------------

constexpr int WQ = 4;                  // warps of a stream (query quarters)
constexpr int RBQ = 16 * MQ * WQ;      // 64 queries per block
constexpr int NSTREAMS = NWARPS / WQ;  // 2 row streams per block
constexpr int SLOT = SEG * PITCH + SEG * 4 + SEG;  // codes, norms, valid

__host__ __device__ constexpr int res_apitch(int Kp) { return Kp + 16; }

__host__ __device__ constexpr long res_smem(int Kp) {
  return static_cast<long>(S) * RBQ * res_apitch(Kp) +
         static_cast<long>(NSTREAMS) * STAGES * SLOT;
}

template <int VEC, bool COSINE>
__global__ void __launch_bounds__(NTHREADS, 1)
segmin_i8_res_kernel(const Args a, int qtiles, int ranges) {
  extern __shared__ __align__(128) int8_t smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int p = warp / WQ, wq = warp % WQ;
  const int apitch = res_apitch(a.Kp);
  const int q0 = static_cast<int>(blockIdx.x % qtiles) * RBQ;
  const long range = blockIdx.x / qtiles;
  const long nseg = a.N / SEG;
  const long seg_lo = nseg * range / ranges;
  const long seg_hi = nseg * (range + 1) / ranges;

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

  // this stream's segments: seg_lo + p, + NSTREAMS, ... < seg_hi
  int8_t* ring = smem + S * RBQ * apitch + p * STAGES * SLOT;
  const long mine = seg_hi - seg_lo > p
                        ? (seg_hi - seg_lo - p + NSTREAMS - 1) / NSTREAMS
                        : 0;
  const int nk = (a.Kp + BK - 1) / BK;
  const long total = mine * nk;
  const int sid = wq * 32 + lane;  // thread of the stream

  long issued = 0, ld_seg = seg_lo + p;
  int ld_k = 0;
  auto issue = [&](int slot) {
    if (issued < total) {
      int8_t* st = ring + slot * SLOT;
      load_codes<VEC>(a, st, ld_seg * SEG, SEG, ld_k * BK, sid, 32 * WQ);
      if (ld_k == nk - 1 && sid < 10) {
        // the segment's norms (8 x 16 B) and validity (2 x 16 B)
        const int8_t* src =
            sid < 8
                ? reinterpret_cast<const int8_t*>(a.norms + ld_seg * SEG) +
                      sid * 16
                : reinterpret_cast<const int8_t*>(a.valid + ld_seg * SEG) +
                      (sid - 8) * 16;
        copy_chunk<16>(st + SEG * PITCH + sid * 16, src, true);
      }
      ++issued;
      if (++ld_k == nk) {
        ld_k = 0;
        ld_seg += NSTREAMS;
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts aligned
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  int acc[S][MQ][4][4];
  long cu_seg = seg_lo + p;
  int kc = 0, slot = 0;
  for (long f = 0; f < total; ++f) {
    cp_async_wait<STAGES - 2>();
    bar_sync(1 + p, 32 * WQ);  // stage f landed; the slot read at f-1 is free
    issue((slot + STAGES - 1) % STAGES);

    const int8_t* st = ring + slot * SLOT;
    if (kc == 0) zero(acc);
    if (mtiles > 0)
      products(acc, as_w, apitch, RBQ, kc * BK, st,
               min(BK, a.Kp - kc * BK) / 32, mtiles, lane);
    if (kc == nk - 1 && mtiles > 0) {
      const float* nv = reinterpret_cast<const float*>(st + SEG * PITCH);
      const uint8_t* vv =
          reinterpret_cast<const uint8_t*>(st + SEG * PITCH + SEG * 4);
      float vn[4][2];
      bool vok[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          vn[j][c] = nv[j * 8 + tig * 2 + c];
          vok[j][c] = vv[j * 8 + tig * 2 + c] != 0;
        }
      epilogue<COSINE>(a, acc, t, vn, vok, qb, cu_seg, g, tig);
    }
    if (++kc == nk) {
      kc = 0;
      cu_seg += NSTREAMS;
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
constexpr int SBN = NWARPS * SEG;       // 256 code rows per tile
constexpr int SSTAGE = (SAROWS + SBN) * PITCH;
constexpr int SSMEM = STAGES * SSTAGE;

template <int VEC>
__device__ __forceinline__ void stream_stage(const Args& a, int8_t* st,
                                             int q0, long row0, int k0) {
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
  load_codes<VEC>(a, st + SAROWS * PITCH, row0, SBN, k0, threadIdx.x,
                  NTHREADS);
}

template <int VEC, bool COSINE>
__global__ void __launch_bounds__(NTHREADS, 1)
segmin_i8_stream_kernel(const Args a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;

  const int qtiles = (a.Q + SBQ - 1) / SBQ;
  const long units = qtiles * ((a.N + SBN - 1) / SBN);
  const int nk = (a.Kp + BK - 1) / BK;
  const long mine = units > blockIdx.x
                        ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;
  const long total = mine * nk;

  // units blockIdx.x, + gridDim.x, ...: query tile fastest, so concurrent
  // blocks share code tiles in L2
  long issued = 0, ld_u = blockIdx.x;
  int ld_k = 0;
  auto issue = [&](int slot) {
    if (issued < total) {
      stream_stage<VEC>(a, smem + slot * SSTAGE,
                        static_cast<int>(ld_u % qtiles) * SBQ,
                        (ld_u / qtiles) * SBN, ld_k * BK);
      ++issued;
      if (++ld_k == nk) {
        ld_k = 0;
        ld_u += gridDim.x;
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  int acc[S][MQ][4][4];
  long cu = blockIdx.x;
  int kc = 0, slot = 0;
  for (long f = 0; f < total; ++f) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage f landed; the slot read at f-1 is free
    issue((slot + STAGES - 1) % STAGES);

    const int8_t* st = smem + slot * SSTAGE;
    const int qb = static_cast<int>(cu % qtiles) * SBQ;
    const int mtiles = min(MQ, (a.Q - qb + 15) / 16);
    if (kc == 0) zero(acc);
    products(acc, st, PITCH, SBQ, 0, st + (SAROWS + warp * SEG) * PITCH,
             min(BK, a.Kp - kc * BK) / 32, mtiles, lane);
    const long seg = (cu / qtiles) * (SBN / SEG) + warp;
    if (kc == nk - 1 && seg < a.N / SEG) {
      float vn[4][2];
      bool vok[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long row = seg * SEG + j * 8 + tig * 2 + c;
          vn[j][c] = a.norms[row];
          vok[j][c] = a.valid[row] != 0;
        }
      epilogue<COSINE>(a, acc, query_terms(a, qb, g), vn, vok, qb,
                              seg, g, tig);
    }
    if (++kc == nk) {
      kc = 0;
      cu += gridDim.x;
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

template <int VEC, bool COSINE>
int launch(const Args& a, cudaStream_t st) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long smem = res_smem(a.Kp);
  if (smem <= optin) {
    auto kern = segmin_i8_res_kernel<VEC, COSINE>;
    e = prepare(kern, smem, &per_sm, &sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int qtiles = (a.Q + RBQ - 1) / RBQ;
    const long nseg = a.N / SEG;
    // about one block per SM: query tiles x row ranges, each range at
    // least one segment per stream
    const long ranges = std::max(
        1L, std::min(static_cast<long>(sms) * per_sm / qtiles,
                     (nseg + NSTREAMS - 1) / NSTREAMS));
    kern<<<static_cast<unsigned>(qtiles * ranges), NTHREADS, smem, st>>>(
        a, qtiles, static_cast<int>(ranges));
  } else {
    auto kern = segmin_i8_stream_kernel<VEC, COSINE>;
    e = prepare(kern, SSMEM, &per_sm, &sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long units = static_cast<long>((a.Q + SBQ - 1) / SBQ) *
                       ((a.N + SBN - 1) / SBN);
    const long grid = std::min(units, static_cast<long>(sms) * per_sm);
    kern<<<static_cast<unsigned>(grid), NTHREADS, SSMEM, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_metric(const Args& a, bool cosine, cudaStream_t st) {
  return cosine ? launch<VEC, true>(a, st) : launch<VEC, false>(a, st);
}

}  // namespace

// C entry point (bound with ctypes).  slices (S, Q, Kp) int8 and qscale (Q,)
// f32 come from ops/scan.py::slice_queries; qn2 and qsum are |q|^2 and
// sum(q) of the unrounded f32 queries; codes are (N, D) int8 with N a
// multiple of 32 and D <= 2^17; norms and valid start 16-byte aligned; vec
// (16, 4 or 1) is the code copy width, which must divide D and the codes'
// address.  Returns cudaGetLastError() after the launch.
extern "C" int segmin_i8_launch(const int8_t* slices, const float* qscale,
                                const int8_t* codes, const float* norms,
                                const uint8_t* valid, const float* qn2,
                                const float* qsum, float* out, int Q, long N,
                                int D, int Kp, int cosine, float scale,
                                float offset, int vec, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (N % SEG || Kp % 32 || Kp < D || D > (1 << 17))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{slices, qscale, codes, norms, valid, qn2, qsum, out,
               Q,      N,      D,     Kp,    scale, offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch_metric<16>(a, cosine != 0, st);
    case 4: return launch_metric<4>(a, cosine != 0, st);
    case 1: return launch_metric<1>(a, cosine != 0, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
