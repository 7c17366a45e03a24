// Throughput of the warp-level tensor-core MMA (mma.sync) that K1's int8
// route (segmin_i8.cu) is built on, beside its bf16 counterpart: every
// warp issues `iters` rounds of 24 independent MMAs on fragments held in
// registers (no loads, no epilogue), and the sums are folded into one word
// so none is dead.  tools/mma_rate.py times it and prints the rate; it is
// a measurement of the card, not part of the port's search path.
//
//   kind 0: mma.sync.m16n8k32.row.col.s32.s8.s8.s32  (8,192 ops each)
//   kind 1: mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32  (4,096 flops each)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 24;  // independent accumulators per warp, as in K1
constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
mma_s8_kernel(int iters, unsigned* out) {
  const unsigned lane = threadIdx.x % 32;
  const uint32_t a[4] = {lane * 0x01010101u, lane ^ 0x5a5a5a5au,
                         lane * 7u, ~lane};
  const uint32_t b[2] = {lane * 0x03030303u, lane + 0x11111111u};
  int acc[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < CHAINS; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+r"(acc[t][0]), "+r"(acc[t][1]), "+r"(acc[t][2]),
            "+r"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  unsigned x = 0;
#pragma unroll
  for (int t = 0; t < CHAINS; ++t)
    x ^= acc[t][0] ^ acc[t][1] ^ acc[t][2] ^ acc[t][3];
  atomicXor(out, x);
}

__global__ void __launch_bounds__(NTHREADS)
mma_bf16_kernel(int iters, unsigned* out) {
  const unsigned lane = threadIdx.x % 32;
  // bf16 pairs of small normal values
  const uint32_t a[4] = {0x3f803f80u ^ (lane & 7u), 0x3f003f00u,
                         0x3e803e80u, 0x3f403f40u ^ lane};
  const uint32_t b[2] = {0x3f803f80u, 0x3e003e00u ^ (lane & 3u)};
  float acc[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < CHAINS; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]),
            "+f"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  unsigned x = 0;
#pragma unroll
  for (int t = 0; t < CHAINS; ++t)
    x ^= __float_as_uint(acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3]);
  atomicXor(out, x);
}

}  // namespace

// C entry point (bound with ctypes): `blocks` blocks of 256 threads, each
// warp `iters` x 24 MMAs of `kind`.  Returns cudaGetLastError().
extern "C" int mma_rate_launch(int kind, int blocks, int iters,
                               unsigned* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    mma_s8_kernel<<<blocks, NTHREADS, 0, st>>>(iters, out);
  else if (kind == 1)
    mma_bf16_kernel<<<blocks, NTHREADS, 0, st>>>(iters, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
