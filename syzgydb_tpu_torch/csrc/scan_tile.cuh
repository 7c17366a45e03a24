// The fp32 code-matmul tile loop shared by K1/K5/K6 (segmin.cu) and K4
// (surface.cu) for every code width the int8 route does not take.
//
// Variants.  A block of 256 threads owns a BQ x BR tile of (queries x
// rows); BQ is chosen per launch by ops/scan.py::fp32_query_tile(Q) from
// {16, 32, 64, 128}, so a launch pads Q at most to a multiple of its own
// tile (Q = 16 computes 16 queries, not 128).  Every thread holds a TQ x 8
// register tile of raw dots: TQ = 4 at BQ = 16, else 8.  The row tile
// shrinks as BQ grows so that the register tile stays full:
//
//   BQ    TQ  BR   blocks an SM   ring stages (f32 codes)
//   16    4   512  1              3
//   32    8   512  1              3
//   64    8   256  2              3
//   128   8   128  2              5
//
// A warp is 2 query lanes x 16 row lanes and owns 128 consecutive rows of
// the tile: thread (ql, rl) of warp (wq, wr) holds queries tq*4 + i (and
// BQ/2 + tq*4 + i at TQ = 8), tq = 2 wq + ql, and rows wr*128 + rl*4 + j
// and wr*128 + 64 + rl*4 + j, j < 4.  So a segment of 16..128 rows lies in
// one warp (the segment minimum is a __shfl_xor_sync over its row lanes),
// and K4 stores 16-byte runs along N.
//
// The code stream.  Blocks are persistent: a block walks units (query
// tile, row tile), query tile fastest so the blocks in flight share code
// tiles in L2, and each unit in stages of BK = 16 dims.  A stage holds the
// RAW code bytes of the tile's rows (BR rows x 16*BITS/8 bytes, rows padded
// to an odd number of 16-byte chunks so the decode's vector reads are
// conflict-free) and the queries' 16 x BQ chunk, brought by cp.async
// (16-byte copies where the rows' length and the codes' address allow it;
// 8, 4 bytes, or plain 2- and 1-byte loads otherwise) into a ring of as
// many stages as the block's share of shared memory holds.  Each stage is
// decoded once per block (nibble, int8, int16 or f32, exact floats built
// from the bits) into one of two k-major f32 tiles: stage f+1 is decoded
// while stage f's products run, so one barrier a stage suffices and one
// warp's copies and decode overlap another's FMAs.  The products read
// 128-bit operands: per dim one or two of queries and two of codes for
// TQ x 8 FMAs.  The wrapper passes the queries transposed and zero-padded
// to (Kp, Qp), Kp a multiple of 16 and Qp of BQ.
//
// Arithmetic: 4/8/16-bit centered codes and f32 codes are exact in f32 and
// queries are not rounded, so every product is exact and the only error is
// f32 accumulation, in dim order 0..K-1 for every output at every tile
// (~D * 2^-24 relative), inside ops/scan.py's surface_accum_eps.  No atomics
// and no split of K: two launches on the same inputs, and launches at any
// query tile, give bit-identical outputs.
//
// What bounds it on the H100 (1,048,576 x 384; PERF.md holds the measured
// times): at BQ = 16 on f32 codes the 1.61 GB of codes (0.48 ms at 3.35
// TB/s; the FMAs take 0.19 ms at 67 TFLOP/s), on 4- and 16-bit codes and
// at Q >= 64 the fp32 FMA rate (0.77 ms at Q = 64).  In practice shared
// memory bounds the loop: an LDS.128 costs four 128-byte wavefronts, so an
// 8 x 8 register tile needs as many shared-memory cycles as FMA cycles
// (128 FMAs and 128 bytes a clock an SM), and the stage copies and the
// decode add to that.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace scan_tile {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BK = 16;  // dims a stage
constexpr int TR = 8;   // rows a thread: two runs of 4, 64 rows apart
constexpr int SMEM_BUDGET = 220 * 1024;  // a block alone on its SM

// measurement builds only (tools/fp32_split.py): 1 leaves out the stage
// copies and the decode (the products run on whatever shared memory
// holds), 2 leaves out the products; the outputs are then meaningless
#ifndef SCAN_TILE_SPLIT
#define SCAN_TILE_SPLIT 0
#endif

// what a launch passes to the kernel
struct Args {
  const float* qt;        // (Kp, Qp) f32 queries, transposed, zero-padded
  const uint8_t* codes;   // (N, row_bytes) codes
  const float* norms;     // (N,)
  const uint8_t* valid;   // (N,) bool
  const float* qn2;       // (Q,)
  const float* qsum;      // (Q,)
  void* out;              // the epilogue's output
  int Q, Qp;
  long N;
  int Kp, row_bytes;
  float scale, offset;    // dot = scale * raw + offset * sum(q)
  int vec;                // code copy width: 16, 8, 4, 2 or 1 bytes
  int seg;                // segment length (segment minima only)
};

// the query-tile variants
template <int BQ_>
struct Tile {
  static_assert(BQ_ == 16 || BQ_ == 32 || BQ_ == 64 || BQ_ == 128,
                "query tiles the kernels are built for");
  static constexpr int BQ = BQ_;
  static constexpr int TQ = BQ == 16 ? 4 : 8;
  static constexpr int QT = BQ / TQ;           // query threads: 4 .. 16
  static constexpr int WQW = QT / 2;           // warps along queries
  static constexpr int WRW = NWARPS / WQW;     // warps along rows
  static constexpr int BR = WRW * 128;         // rows of a tile
  static constexpr int MINB = BQ <= 32 ? 1 : 2;  // blocks an SM
};

// a stage's raw code bytes a row, the decode chunk, and the padded pitch
// (an odd number of chunks: the vector reads of consecutive rows are
// conflict-free)
template <int BITS>
struct Raw {
  static constexpr int RB = BK * BITS / 8;          // 8, 16, 32 or 64
  static constexpr int CH = RB < 16 ? RB : 16;      // decode vector bytes
  static constexpr int CPR = RB / CH;               // chunks a row
  static constexpr int DPC = CH * 8 / BITS;         // dims a chunk
  static constexpr int PITCH = (CPR & 1) ? RB : RB + CH;
};

// shared memory: two decoded k-major f32 tiles and a ring of as many
// stages (raw codes + the queries' k-major chunk) as the block's share of
// the SM holds
template <int BITS, int BQ>
struct Smem {
  static constexpr int BR = Tile<BQ>::BR;
  static constexpr int CS = BK * BR * 4;
  static constexpr int STAGE = BR * Raw<BITS>::PITCH + BK * BQ * 4;
  static constexpr int BUDGET = SMEM_BUDGET / Tile<BQ>::MINB;
  static constexpr int FIT = (BUDGET - 2 * CS) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = 2 * CS + STAGES * STAGE;
  static_assert(STAGES >= 3, "the ring needs three stages");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one copy of V bytes global -> shared, zero-filled where !ok (V < 4: a
// plain load and store, seen by the consumer after the ring's barrier)
template <int V>
__device__ __forceinline__ void copy(uint8_t* dst, const uint8_t* src,
                                     bool ok) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(V), "r"(ok ? V : 0));
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
  } else {
    *dst = ok ? *src : uint8_t{0};
  }
}

// a stage's code rows row0 .. row0 + BR - 1, bytes kb .. kb + RB - 1 of
// each, in copies of V bytes (V divides row_bytes: a copy lies wholly
// inside or outside its row; rows past N and bytes past the row are
// zeros).  VPR divides NTHREADS, so a thread keeps its byte column and
// steps NTHREADS / VPR rows a copy.
template <int BITS, int BR, int V>
__device__ __forceinline__ void load_codes(const Args& a, uint8_t* dst,
                                           long row0, int kb) {
  using R = Raw<BITS>;
  constexpr int VPR = R::RB / V;  // copies a row
  constexpr int STEP = NTHREADS / VPR;
  static_assert(NTHREADS % VPR == 0, "copies a row divide the block");
  const int b = (threadIdx.x % VPR) * V;
  const int rows = static_cast<int>(min(static_cast<long>(BR), a.N - row0));
  const bool inrow = kb + b < a.row_bytes;
  int r = threadIdx.x / VPR;
  const uint8_t* src = a.codes + (row0 + r) * a.row_bytes + kb + b;
  const long src_step = static_cast<long>(STEP) * a.row_bytes;
  uint8_t* d = dst + r * R::PITCH + b;
#pragma unroll 4
  for (; r < BR; r += STEP, src += src_step, d += STEP * R::PITCH) {
    const bool ok = inrow && r < rows;
    copy<V>(d, ok ? src : a.codes, ok);
  }
}

template <int BITS, int BQ>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* st,
                                           int q0, long row0, int k0) {
  using R = Raw<BITS>;
  constexpr int BR = Tile<BQ>::BR;
  const int kb = k0 * BITS / 8;
  // copies no wider than a stage's row (both powers of two)
  switch (a.vec < R::RB ? a.vec : R::RB) {
    case 16:
      if constexpr (R::RB >= 16) {
        load_codes<BITS, BR, 16>(a, st, row0, kb);
        break;
      }
      [[fallthrough]];
    case 8: load_codes<BITS, BR, 8>(a, st, row0, kb); break;
    case 4: load_codes<BITS, BR, 4>(a, st, row0, kb); break;
    case 2: load_codes<BITS, BR, 2>(a, st, row0, kb); break;
    default: load_codes<BITS, BR, 1>(a, st, row0, kb); break;
  }
  // the queries' BK x BQ chunk: rows k0.. of qt, BQ floats from q0
  constexpr int QCH = BQ / 4;  // 16-byte copies a dim
  float* qs = reinterpret_cast<float*>(st + BR * R::PITCH);
  const float* src = a.qt + static_cast<long>(k0) * a.Qp + q0;
  for (int i = threadIdx.x; i < BK * QCH; i += NTHREADS) {
    const int k = i / QCH, c = i % QCH;
    copy<16>(reinterpret_cast<uint8_t*>(qs + k * BQ + c * 4),
             reinterpret_cast<const uint8_t*>(src + k * a.Qp + c * 4), true);
  }
}

// exact f32 of the small unsigned integer x < 2^23, minus `magic`
__device__ __forceinline__ float biased(uint32_t x, float magic) {
  return __int_as_float(0x4B000000u | x) - magic;
}

// the N dims of one raw chunk (8 or 16 bytes): centered codes for 4/8/16
// bits (4-bit: high nibble = even dim, the disk nibble order), f32 codes
// as they are
template <int BITS, int N>
__device__ __forceinline__ void decode(const uint8_t* src, float (&v)[N]) {
  constexpr int W = N * BITS / 32;  // 32-bit words of the chunk
  static_assert(W == 2 || W == 4, "8- or 16-byte chunks");
  uint32_t w[W];
  if constexpr (W == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    w[0] = x.x;
    w[1] = x.y;
  }
#pragma unroll
  for (int h = 0; h < W; ++h) {
    if constexpr (BITS == 4) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (w[h] >> (8 * b)) & 0xFFu;
        v[h * 8 + b * 2] = biased(byte >> 4, 8388616.f);       // 2^23 + 8
        v[h * 8 + b * 2 + 1] = biased(byte & 0xFu, 8388616.f);
      }
    } else if constexpr (BITS == 8) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[h * 4 + b] = biased(((w[h] >> (8 * b)) & 0xFFu) ^ 0x80u,
                              8388736.f);                      // 2^23 + 128
    } else if constexpr (BITS == 16) {
      v[h * 2] = biased((w[h] & 0xFFFFu) ^ 0x8000u, 8421376.f);  // + 2^15
      v[h * 2 + 1] = biased((w[h] >> 16) ^ 0x8000u, 8421376.f);
    } else {
      v[h] = __uint_as_float(w[h]);
    }
  }
}

// a stage's raw rows -> cs[k][r] f32 (k-major), once per block;
// consecutive threads take consecutive rows (odd chunk pitch:
// conflict-free reads; 4-byte stores on consecutive banks)
template <int BITS, int BR>
__device__ __forceinline__ void decode_stage(const uint8_t* raw, float* cs) {
  using R = Raw<BITS>;
#pragma unroll 2
  for (int i = threadIdx.x; i < BR * R::CPR; i += NTHREADS) {
    const int r = i % BR, c = i / BR;
    float v[R::DPC];
    decode<BITS, R::DPC>(raw + r * R::PITCH + c * R::CH, v);
#pragma unroll
    for (int e = 0; e < R::DPC; ++e) cs[(c * R::DPC + e) * BR + r] = v[e];
  }
}

// where a thread sits in its tile: warp (wq, wr) of 2 query lanes x 16 row
// lanes owns rows wr*128 .. wr*128 + 127
template <int BQ>
struct Lane {
  int tq;  // query group: queries tq*4 + i (and BQ/2 + tq*4 + i)
  int wr;  // row group
  int rl;  // row lane, 0..15: rows wr*128 + rl*4 + j and + 64
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wq = warp % Tile<BQ>::WQW;
    wr = warp / Tile<BQ>::WQW;
    rl = lane % 16;
    tq = wq * 2 + lane / 16;
  }
  // the tile's query of register row i, and row of register column j
  __device__ __forceinline__ int query(int i) const {
    return i < 4 ? tq * 4 + i : Tile<BQ>::BQ / 2 + tq * 4 + i - 4;
  }
  __device__ __forceinline__ int row(int j) const {
    return wr * 128 + (j < 4 ? rl * 4 + j : 64 + rl * 4 + j - 4);
  }
};

// acc[i][j] += q_i . c_j over the stage's BK dims, dim order ascending;
// per dim one or two 128-bit query loads (two distinct a warp) and two of
// codes (16 lanes on 256 contiguous bytes)
template <int BQ, int BR, int TQ>
__device__ __forceinline__ void products(const float* qs, const float* cs,
                                         const Lane<BQ>& l,
                                         float (&acc)[TQ][TR]) {
  const float* qa = qs + l.tq * 4;
  const float* cb = cs + l.wr * 128 + l.rl * 4;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TQ], b[TR];
    const float4 a0 = *reinterpret_cast<const float4*>(qa + kk * BQ);
    a[0] = a0.x;
    a[1] = a0.y;
    a[2] = a0.z;
    a[3] = a0.w;
    if constexpr (TQ == 8) {
      const float4 a1 =
          *reinterpret_cast<const float4*>(qa + kk * BQ + BQ / 2);
      a[4] = a1.x;
      a[5] = a1.y;
      a[6] = a1.z;
      a[7] = a1.w;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(cb + kk * BR);
    const float4 b1 = *reinterpret_cast<const float4*>(cb + kk * BR + 64);
    b[0] = b0.x;
    b[1] = b0.y;
    b[2] = b0.z;
    b[3] = b0.w;
    b[4] = b1.x;
    b[5] = b1.y;
    b[6] = b1.z;
    b[7] = b1.w;
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The persistent tile loop: every unit's raw dots, then EP::tile(a, acc,
// lane, q0, row0) with q0 the unit's first query and row0 its first row.
// EP::tile is called by every thread of the block (it may shuffle).  One
// barrier a stage: stage f+1 is decoded into the other f32 tile while
// stage f's products run.
template <int BITS, int BQ, class EP>
__global__ void __launch_bounds__(NTHREADS, Tile<BQ>::MINB)
scan_kernel(const Args a) {
  using T = Tile<BQ>;
  using M = Smem<BITS, BQ>;
  constexpr int S = M::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];
  float* cs = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + 2 * M::CS;

  const int qtiles = a.Qp / BQ;
  const int units = qtiles * static_cast<int>((a.N + T::BR - 1) / T::BR);
  const int nk = a.Kp / BK;
  const int mine = units > static_cast<int>(blockIdx.x)
                       ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int total = mine * nk;

  int issued = 0, ld_u = blockIdx.x, ld_k = 0;
  auto issue = [&](int slot) {
    if (issued < total && SCAN_TILE_SPLIT != 1) {
      load_stage<BITS, BQ>(a, ring + slot * M::STAGE, (ld_u % qtiles) * BQ,
                           static_cast<long>(ld_u / qtiles) * T::BR,
                           ld_k * BK);
      ++issued;
      if (++ld_k == nk) {
        ld_k = 0;
        ld_u += gridDim.x;
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts aligned
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  cp_async_wait<S - 2>();
  __syncthreads();
  if (total > 0 && SCAN_TILE_SPLIT != 1) decode_stage<BITS, T::BR>(ring, cs);

  const Lane<BQ> l;
  float acc[T::TQ][TR];
  int cu = blockIdx.x, kc = 0, slot = 0;
  for (int f = 0; f < total; ++f) {
    cp_async_wait<S - 3>();
    // stage f decoded into cs[f & 1], stage f+1 landed, and stage f-1's
    // slot and f32 tile are free
    __syncthreads();
    issue((slot + S - 1) % S);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < T::TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
    }
    if (SCAN_TILE_SPLIT != 2)
      products<BQ, T::BR, T::TQ>(
          reinterpret_cast<const float*>(ring + slot * M::STAGE +
                                         T::BR * Raw<BITS>::PITCH),
          cs + (f & 1) * (M::CS / 4), l, acc);
    if (kc == nk - 1)
      EP::tile(a, acc, l, (cu % qtiles) * BQ,
               static_cast<long>(cu / qtiles) * T::BR);
    slot = slot + 1 == S ? 0 : slot + 1;
    if (f + 1 < total && SCAN_TILE_SPLIT != 1)
      decode_stage<BITS, T::BR>(ring + slot * M::STAGE,
                                cs + ((f + 1) & 1) * (M::CS / 4));
    if (++kc == nk) {
      kc = 0;
      cu += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// about one wave of persistent blocks; cudaError_t
template <int BITS, int BQ, class EP>
int launch_tile(const Args& a, cudaStream_t st) {
  auto kern = scan_kernel<BITS, BQ, EP>;
  constexpr int smem = Smem<BITS, BQ>::BYTES;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      NTHREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm <= 0) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) return static_cast<int>(e);
  const long units = static_cast<long>(a.Qp / BQ) *
                     ((a.N + Tile<BQ>::BR - 1) / Tile<BQ>::BR);
  const long grid = std::min(units, static_cast<long>(sms) * per_sm);
  kern<<<static_cast<unsigned>(grid), NTHREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// by query tile (EP<BQ>: the epilogue of that tile)
template <int BITS, template <int> class EP>
int launch_bq(const Args& a, int tile, cudaStream_t st) {
  switch (tile) {
    case 16: return launch_tile<BITS, 16, EP<16>>(a, st);
    case 32: return launch_tile<BITS, 32, EP<32>>(a, st);
    case 64: return launch_tile<BITS, 64, EP<64>>(a, st);
    case 128: return launch_tile<BITS, 128, EP<128>>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// by code width: 4 (packed nibbles), 8, 16, or 32 (f32 codes, also the
// 64-bit collections')
template <template <int> class EP>
int launch_bits(const Args& a, int bits, int tile, cudaStream_t st) {
  switch (bits) {
    case 4: return launch_bq<4, EP>(a, tile, st);
    case 8: return launch_bq<8, EP>(a, tile, st);
    case 16: return launch_bq<16, EP>(a, tile, st);
    case 32: return launch_bq<32, EP>(a, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// what every launch must satisfy, whatever its epilogue
inline bool bad_args(const Args& a, int bits, int tile) {
  return (tile != 16 && tile != 32 && tile != 64 && tile != 128) ||
         a.Qp % tile || a.Qp < a.Q || a.Kp % BK || a.Kp <= 0 ||
         a.row_bytes <= 0 || a.Kp * bits / 8 < a.row_bytes ||
         a.vec <= 0 || 16 % a.vec || a.row_bytes % a.vec;
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

// a thread's 8 rows' norms and validity (rows past N: invalid)
template <int BQ>
__device__ __forceinline__ void row_terms(const Args& a, const Lane<BQ>& l,
                                          long row0, float (&vn)[TR],
                                          bool (&vok)[TR]) {
#pragma unroll
  for (int j = 0; j < TR; ++j) {
    const long row = row0 + l.row(j);
    vok[j] = row < a.N && a.valid[row] != 0;
    vn[j] = row < a.N ? a.norms[row] : 0.f;
  }
}

}  // namespace scan_tile
