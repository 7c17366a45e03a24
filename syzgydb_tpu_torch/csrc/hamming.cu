// K2 and K3: Hamming distance surfaces of packed sign sketches, as exact
// int8 tensor-core products of unpacked sketch bits.
//
// K2 replaces syzgydb_tpu/ops/pallas_hamming.py::_hamming_bf16_kernel
// (wrapper hamming_scores_bf16): for (Q, W) query sketches and (N, W) row
// sketches (uint32 words) it writes out[q, r] = sum_w popcount(q_w ^ h_w)
// as bf16 (the wrapper's default there) or f32, or 16384 where row r is
// invalid; every value (<= 256, and 16384) is exact in bf16.  Candidate
// selection (torch.topk) runs outside the kernel.
//
// K3 replaces ::_hamming_kernel (wrapper hamming_scores): the same sum
// with no validity mask, stored as uint8.  Like the TPU kernel's
// acc.astype(uint8), the store keeps the low 8 bits, so a distance of 256
// (all 256 bits differ at W = 8) reads 0.
//
// Arithmetic.  With a the query's bits and b a row's, as 0/1 values,
//   Hamming(a, b) = popc(a) + sum_k (1 - 2 a_k) b_k,
// exact in int32.  Each 32-bit word is one k32 step of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: A (16 x 32) holds 16 rows' bits,
// B (32 x 8) 8 queries' signs 1 - 2 a_k, and C starts at popc(q) of its
// column's query.  W = 1..8 words are W k-steps, no padding.
//
// Bit -> k mapping (within a word; A and B share it, and
// tests/test_torch_hamming.py::_emulate_tc_hamming copies it):
//   k = 16 h + 4 t + j  <->  bit 8 j + 4 h + t     (h < 2, t < 4, j < 4).
// A thread with tig = lane % 4 holds k = 4 tig + j (a0/a1, b0) and
// k = 16 + 4 tig + j (a2/a3, b1), i.e. bits tig and 4 + tig of each byte of
// a word x.  Two encodings of the same bits:
//  - eight n8 tiles: A bytes are the bits, (x >> tig) & 0x01010101 and
//    (x >> (tig + 4)) & 0x01010101 (two integer instructions a register);
//  - one n8 tile (Q <= 8, the medium route): u = x * 2^(3 - tig) (one IMAD,
//    on the FMA pipe) puts the two bits at bits 3 and 7 of each byte, so A
//    is u & 0x08080808 (8 * bit) and u & 0x80808080 (-128 * bit as s8), and
//    B bytes are 16 (1 - 2 q) and 2 q - 1: every product is 128 (1 - 2 q) b,
//    C is 128 x the count, and the extraction costs 1.5 instructions a
//    register.
//
// Bound on the H100: memory.  The kernel reads the N*W*4 sketch bytes (20
// MB at 1M rows x 5 words) once per 64-query tile and the validity bytes,
// and writes the (Q, N) surface: 2 (bf16), 4 (f32) or 1 (uint8) bytes a
// value, which dominates from Q = 2 on.  The products are 2*Q*N*32*W int8
// operations (21.5 G at Q = 64, W = 5: ~0.017 ms at mma.sync's measured
// 1,254 TOP/s, under the 0.026 ms byte bound).  The kernel it replaced
// spent W __popc per output value at 16 popcounts per clock per SM.  What
// holds this one above its bound is instruction issue: unpacking costs
// ~1.5 instructions per 4 row bits whatever Q is (PERF.md).
//
// Design: a persistent grid of (64-query tiles) x (row ranges), up to three
// blocks of 8 warps per SM; each block walks 512-row blocks of its range.
//  - Loads: a row block's words (512 * W * 4 bytes, contiguous in the
//    (N, W) array, which must start 16-byte aligned) and its 512 validity
//    bytes stream into a 3-stage ring: two 1-D bulk copies (TMA) a stage,
//    issued by one thread on the slot's mbarrier.
//  - Query fragments: B for the block's n8 tiles (8 queries each) are built
//    once into shared memory with popc(q), zero past Q; with one n8 tile
//    they stay in registers.
//  - Products: a warp step is 64 rows (four m16 tiles) with one n8 tile and
//    32 rows (two) with eight, whose 64 accumulators fill the registers; W
//    is a template argument, so the word loop unrolls.
//  - Epilogue (a template parameter): Masked<float>, Masked<bf16> (K2) or
//    Wrap (K3, uint8) turns each C value into OutT with no conversion
//    instruction and stages it in the warp's own [query][step rows] tile of
//    shared memory; the warp then writes each query's run as 16-byte stores
//    (64-bit offsets), or element by element at the N tail or where
//    N * sizeof(OutT) is not a multiple of 16.  Nothing past N or Q is
//    stored.

#include <stdint.h>

#include <algorithm>

#include <cuda_bf16.h>

namespace {

constexpr int MAX_WORDS = 8;    // total sketch bits <= 256
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RB = 512;         // rows of a ring stage
constexpr int WROWS = RB / NWARPS;  // 64 rows of a stage per warp
constexpr int STAGES = 3;
constexpr uint32_t LSB = 0x01010101u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 1-D bulk copy (TMA) of `bytes` (a multiple of 16, 16-byte aligned ends)
// into shared memory, completing on the mbarrier at `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// x * s as an integer multiply (IMAD, on the FMA pipe): written in PTX so
// that a power-of-two s is not turned back into a shift
__device__ __forceinline__ uint32_t imul(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// d = a * b + c
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b, const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

struct Args {
  const uint32_t* qcodes;  // (Q, W)
  const uint32_t* hashes;  // (N, W), 16-byte aligned
  const uint8_t* valid;    // (N,) bool, 16-byte aligned; null for K3
  void* out;               // (Q, N) OutT
  int Q;
  long N;
  int W;
};

// ---------------------------------------------------------------------------
// epilogues: the value of count d at a row whose validity is ok
// ---------------------------------------------------------------------------

// the accumulator is the count d, or 128 d (SCALED); d <= 256, so its f32
// value is built from the bits with full-rate integer and float operations
// (no conversion instructions), and that f32 is exact in bf16
template <typename OutT>
struct Masked {
  using T = OutT;
  static constexpr bool MASK = true;
  template <bool SCALED>
  __device__ __forceinline__ static T value(int acc, bool ok) {
    // 2^23 + acc from its bits, then acc (or acc / 128: exact, one FFMA)
    const float big = __int_as_float(0x4B000000 | acc);
    float v = SCALED ? __fmaf_rn(big, 0.0078125f, -65536.f) : big - 8388608.f;
    v = ok ? v : 16384.f;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat16_raw r;
      r.x = static_cast<unsigned short>(__float_as_uint(v) >> 16);
      return r;
    } else {
      return v;
    }
  }
};

struct Wrap {
  using T = uint8_t;
  static constexpr bool MASK = false;
  template <bool SCALED>
  __device__ __forceinline__ static T value(int acc, bool) {
    return static_cast<uint8_t>((SCALED ? acc >> 7 : acc) & 0xFF);
  }
};

// m16 tiles of a warp step: four (64 rows, one step a stage) with one n8
// tile, two (32 rows) with eight, whose accumulators fill the registers
__host__ __device__ constexpr int step_tiles(int nt) { return nt == 1 ? 4 : 2; }

// staging pitch of one query's run of a step: +16 bytes keeps the four
// queries a C store touches at once (2 tig apart) in distinct banks
template <typename T>
__host__ __device__ constexpr int stage_pitch(int nt) {
  return 16 * step_tiles(nt) * static_cast<int>(sizeof(T)) + 16;
}

__host__ __device__ constexpr long round16(long x) { return (x + 15) & ~15L; }

struct Layout {  // byte offsets into dynamic shared memory
  long words, valid, bfrag, qpop, bars, stage, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int W, int nt) {
  Layout l;
  l.words = 0;
  l.valid = l.words + static_cast<long>(STAGES) * RB * W * 4;
  l.bfrag = round16(l.valid + static_cast<long>(STAGES) * RB);
  l.qpop = l.bfrag + static_cast<long>(nt) * MAX_WORDS * 32 * 8;
  l.bars = round16(l.qpop + 8L * nt * 4);
  l.stage = l.bars + 16L * STAGES;
  l.total = l.stage + static_cast<long>(NWARPS) * 8 * nt * stage_pitch<T>(nt);
  return l;
}

// One row block's words and validity bytes into a ring slot, by one
// thread: two bulk copies on the slot's mbarrier (the last block's
// sub-16-byte tails by plain loads); rows past N keep stale bytes and are
// never stored.
__device__ __forceinline__ void load_block(const Args& a, int W,
                                           uint8_t* words, uint8_t* vbytes,
                                           long blk, uint32_t bar) {
  const int bytes = RB * W * 4;
  const long left = a.N * W * 4 - blk * bytes;  // sketch bytes from here on
  const uint8_t* src = reinterpret_cast<const uint8_t*>(a.hashes) + blk * bytes;
  const int wb = static_cast<int>(left < bytes ? left : bytes);
  const long vleft = a.N - blk * RB;
  const int vb =
      a.valid != nullptr ? static_cast<int>(vleft < RB ? vleft : RB) : 0;
  const int wb16 = wb & ~15, vb16 = vb & ~15;
  for (int i = wb16; i < wb; i += 4)
    *reinterpret_cast<uint32_t*>(words + i) =
        *reinterpret_cast<const uint32_t*>(src + i);
  for (int i = vb16; i < vb; ++i) vbytes[i] = a.valid[blk * RB + i];
  // slot reuse: the generic-proxy reads of the last round come first
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_expect(bar, wb16 + vb16);
  if (wb16) bulk_copy(words, src, wb16, bar);
  if (vb16) bulk_copy(vbytes, a.valid + blk * RB, vb16, bar);
}

// W: the sketch width as a template argument (1..8)
template <class EP, int NT, int W>
__global__ void __launch_bounds__(NTHREADS, NT == 1 ? 3 : 2)
hamming_tc_kernel(const Args a, int qtiles, int ranges) {
  using T = typename EP::T;
  constexpr int QT = 8 * NT;
  constexpr int MT = step_tiles(NT);
  constexpr int STEP = 16 * MT;
  constexpr int PITCH = stage_pitch<T>(NT);
  // one n8 tile: A bytes are 8 * bit (k < 16) and -128 * bit (k >= 16), B
  // bytes 16 (1 - 2 q) and 2 q - 1, so every product is 128 (1 - 2 q) bit
  // and the extraction costs 1.5 instructions a register (see the products)
  constexpr bool SCALED = NT == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout<T>(W, NT);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int q0 = static_cast<int>(blockIdx.x % qtiles) * QT;
  const int qn = min(QT, a.Q - q0);     // queries of this tile
  const int ntiles = (qn + 7) / 8;      // n8 tiles with a query
  const long range = blockIdx.x / qtiles;
  const long nblk = (a.N + RB - 1) / RB;
  const long mine = range < nblk ? (nblk - range + ranges - 1) / ranges : 0;

  uint8_t* words = smem + L.words;
  uint8_t* vbytes = smem + L.valid;
  uint2* bfrag = reinterpret_cast<uint2*>(smem + L.bfrag);
  int* qpop = reinterpret_cast<int*>(smem + L.qpop);
  uint8_t* stage = smem + L.stage + warp * QT * PITCH;
  const uint32_t bars = smem_addr(smem + L.bars);  // one mbarrier a slot

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](long f) {  // by thread 0 alone
    if (f < mine && threadIdx.x == 0) {
      const int slot = static_cast<int>(f % STAGES);
      load_block(a, W, words + slot * RB * W * 4, vbytes + slot * RB,
                 range + f * ranges, bars + 8 * slot);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // B fragments [n tile][word < MAX_WORDS][lane] and popc(q), zero past Q
  if (threadIdx.x < QT) {
    int p = 0;
    const int q = q0 + threadIdx.x;
#pragma unroll
    for (int wd = 0; wd < MAX_WORDS; ++wd)
      if (wd < W && q < a.Q)
        p += __popc(a.qcodes[static_cast<long>(q) * W + wd]);
    qpop[threadIdx.x] = p;
  }
  constexpr int NB = NT * MAX_WORDS * 32 / NTHREADS;
  uint32_t xq[NB];
#pragma unroll
  for (int it = 0; it < NB; ++it) {  // every load first
    const int i = it * NTHREADS + threadIdx.x;
    const int l = i % 32, wd = (i / 32) % MAX_WORDS, nt = i / (32 * MAX_WORDS);
    const int q = q0 + nt * 8 + l / 4;
    xq[it] = q < a.Q && wd < W ? a.qcodes[static_cast<long>(q) * W + wd] : 0u;
  }
#pragma unroll
  for (int it = 0; it < NB; ++it) {
    const int i = it * NTHREADS + threadIdx.x;
    const int l = i % 32, wd = (i / 32) % MAX_WORDS, nt = i / (32 * MAX_WORDS);
    const int q = q0 + nt * 8 + l / 4, t = l % 4;
    const bool ok = q < a.Q && wd < W;
    const uint32_t x = xq[it];
    const uint32_t lo = (x >> t) & LSB, hi = (x >> (t + 4)) & LSB;
    if (!ok)
      bfrag[i] = make_uint2(0u, 0u);
    else if (SCALED)  // 16 (1 - 2 q) and 2 q - 1
      bfrag[i] = make_uint2(0x10101010u ^ (lo * 0xE0u),
                            LSB | ((hi ^ LSB) * 0xFEu));
    else  // 1 - 2 q
      bfrag[i] = make_uint2(LSB | (lo * 0xFEu), LSB | (hi * 0xFEu));
  }
  __syncthreads();
  // one n8 tile: its fragments and popcounts stay in registers
  uint2 breg[NT == 1 ? MAX_WORDS : 1];
  int2 preg = make_int2(0, 0);
  if constexpr (NT == 1) {
#pragma unroll
    for (int wd = 0; wd < MAX_WORDS; ++wd)
      if (wd < W) breg[wd] = bfrag[wd * 32 + lane];
    preg = *reinterpret_cast<const int2*>(qpop + tig * 2);
  }

  T* out = static_cast<T*>(a.out);
  const bool wide = (a.N * static_cast<long>(sizeof(T))) % 16 == 0;
  constexpr int CH = STEP * sizeof(T) / 16;  // 16-byte chunks of a run

  for (long f = 0; f < mine; ++f) {
    bar_wait(bars + 8 * static_cast<int>(f % STAGES),
             static_cast<uint32_t>((f / STAGES) & 1));
    __syncthreads();  // block f landed; the slot read at f - 1 is free
    issue(f + STAGES - 1);

    const int slot = static_cast<int>(f % STAGES);
    const uint32_t* hs =
        reinterpret_cast<const uint32_t*>(words + slot * RB * W * 4);
    const uint8_t* vs = vbytes + slot * RB;
    const long row0 = (range + f * ranges) * RB;
#pragma unroll 1
    for (int s = 0; s < WROWS / STEP; ++s) {
      const int lr = warp * WROWS + s * STEP;  // the step's first local row
      const long grow = row0 + lr;
      if (grow >= a.N) break;  // warp-uniform

      // validity of rows m*16 + g + 8h, read before the products
      bool ok[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ok[m][h] = !EP::MASK || vs[lr + m * 16 + g + 8 * h] != 0;
      // C starts at popc(q) (128 popc(q) scaled), the first word's input
      int acc[MT][NT][4], init[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int2 p = NT == 1 ? preg
                               : *reinterpret_cast<const int2*>(
                                     qpop + nt * 8 + tig * 2);
        init[nt][0] = init[nt][2] = SCALED ? p.x << 7 : p.x;
        init[nt][1] = init[nt][3] = SCALED ? p.y << 7 : p.y;
      }
      // rows lr + m*16 + g + 8h: the A fragments of word wd are byte j of
      // (x >> tig) & LSB (a0, a1) and of (x >> (tig + 4)) & LSB (a2, a3);
      // scaled, bits 3 and 7 of byte j of u = x * 2^(3 - tig) (one IMAD,
      // not a shift), the same bits
      const uint32_t* hr = hs + (lr + g) * W;
      const uint32_t s_u = 1u << (3 - tig);
#pragma unroll
      for (int wd = 0; wd < MAX_WORDS; ++wd) {
        if (wd >= W) break;
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t x0 = hr[(m * 16) * W + wd];
          const uint32_t x1 = hr[(m * 16 + 8) * W + wd];
          if constexpr (SCALED) {
            const uint32_t u0 = imul(x0, s_u), u1 = imul(x1, s_u);
            af[m][0] = u0 & 0x08080808u;
            af[m][1] = u1 & 0x08080808u;
            af[m][2] = u0 & 0x80808080u;
            af[m][3] = u1 & 0x80808080u;
          } else {
            af[m][0] = (x0 >> tig) & LSB;
            af[m][1] = (x1 >> tig) & LSB;
            af[m][2] = (x0 >> (tig + 4)) & LSB;
            af[m][3] = (x1 >> (tig + 4)) & LSB;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= ntiles) break;  // warp-uniform
          const uint2 b =
              NT == 1 ? breg[NT == 1 ? wd : 0]
                      : bfrag[(nt * MAX_WORDS + wd) * 32 + lane];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (wd == 0)
              mma_s8(acc[m][nt], af[m], b, init[nt]);
            else
              mma_s8(acc[m][nt], af[m], b, acc[m][nt]);
          }
        }
      }

      // C (row m*16 + g + 8h, query nt*8 + 2 tig + c) -> stage[query][row]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= ntiles) break;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = nt * 8 + tig * 2 + c;
          if (q >= qn) continue;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<T*>(stage + q * PITCH +
                                    (m * 16 + g + 8 * h) * sizeof(T)) =
                  EP::template value<SCALED>(acc[m][nt][2 * h + c], ok[m][h]);
        }
      }
      __syncwarp();
      if (wide && grow + STEP <= a.N) {
        T* orow = out + static_cast<long>(q0) * a.N + grow;
        for (int i = lane; i < qn * CH; i += 32) {
          const int q = i / CH, c = i % CH;
          *reinterpret_cast<uint4*>(orow + q * a.N + c * (16 / sizeof(T))) =
              *reinterpret_cast<const uint4*>(stage + q * PITCH + c * 16);
        }
      } else {
        for (int i = lane; i < qn * STEP; i += 32) {
          const int q = i / STEP, r = i % STEP;
          if (grow + r < a.N)
            out[static_cast<long>(q0 + q) * a.N + grow + r] =
                *reinterpret_cast<const T*>(stage + q * PITCH +
                                            r * sizeof(T));
        }
      }
      __syncwarp();  // the stage tile is rewritten by the next step
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <class EP, int NT, int W>
int launch_k(const Args& a, cudaStream_t st) {
  auto kern = hamming_tc_kernel<EP, NT, W>;
  const long smem = layout<typename EP::T>(W, NT).total;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, NTHREADS, static_cast<size_t>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm <= 0) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) return static_cast<int>(e);
  const long qtiles = (a.Q + 8 * NT - 1) / (8 * NT);
  const long nblk = (a.N + RB - 1) / RB;
  // query tiles x row ranges, about per_sm blocks per SM; the blocks of one
  // range walk the same row blocks, so a row block comes from HBM once
  const long ranges = std::max(
      1L, std::min(nblk, static_cast<long>(sms) * per_sm / qtiles));
  kern<<<static_cast<unsigned>(qtiles * ranges), NTHREADS, smem, st>>>(
      a, static_cast<int>(qtiles), static_cast<int>(ranges));
  return static_cast<int>(cudaGetLastError());
}

template <class EP, int NT>
int launch_w(const Args& a, cudaStream_t st) {
  switch (a.W) {
    case 1: return launch_k<EP, NT, 1>(a, st);
    case 2: return launch_k<EP, NT, 2>(a, st);
    case 3: return launch_k<EP, NT, 3>(a, st);
    case 4: return launch_k<EP, NT, 4>(a, st);
    case 5: return launch_k<EP, NT, 5>(a, st);
    case 6: return launch_k<EP, NT, 6>(a, st);
    case 7: return launch_k<EP, NT, 7>(a, st);
    default: return launch_k<EP, NT, 8>(a, st);
  }
}

// one n8 tile (8 queries) a block up to Q = 8, else eight
template <class EP>
int launch(const Args& a, void* stream) {
  if (a.W < 1 || a.W > MAX_WORDS ||
      reinterpret_cast<uintptr_t>(a.hashes) % 16 ||
      reinterpret_cast<uintptr_t>(a.valid) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.Q <= 0 || a.N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.Q <= 8 ? launch_w<EP, 1>(a, st) : launch_w<EP, 8>(a, st);
}

}  // namespace

// C entry points (bound with ctypes).  qcodes (Q, W) and hashes (N, W) are
// uint32 words, W in [1, MAX_WORDS]; hashes and valid start 16-byte
// aligned.  Each returns cudaGetLastError() after the launch.

// K2: out (Q, N) f32 when out_bf16 == 0, else bf16; valid (N,) bool
extern "C" int hamming_launch(const uint32_t* qcodes, const uint32_t* hashes,
                              const uint8_t* valid, void* out, int Q, long N,
                              int W, int out_bf16, void* stream) {
  const Args a{qcodes, hashes, valid, out, Q, N, W};
  return out_bf16 ? launch<Masked<__nv_bfloat16>>(a, stream)
                  : launch<Masked<float>>(a, stream);
}

// K3: out (Q, N) uint8, the low 8 bits of each count, no mask
extern "C" int hamming_u8_launch(const uint32_t* qcodes,
                                 const uint32_t* hashes, uint8_t* out, int Q,
                                 long N, int W, void* stream) {
  const Args a{qcodes, hashes, nullptr, out, Q, N, W};
  return launch<Wrap>(a, stream);
}
