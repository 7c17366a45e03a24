// K2 and K3: Hamming distance surfaces of packed sign sketches.
//
// K2 replaces syzgydb_tpu/ops/pallas_hamming.py::_hamming_bf16_kernel
// (wrapper hamming_scores_bf16): for (Q, W) query sketches and (N, W) row
// sketches (uint32 words) it writes out[q, r] = sum_w popcount(q_w ^ h_w)
// as f32, or 16384 where row r is invalid.  Candidate selection
// (torch.topk) runs outside the kernel.
//
// K3 replaces ::_hamming_kernel (wrapper hamming_scores): the same sum
// with no validity mask, stored as uint8.  Like the TPU kernel's
// acc.astype(uint8), the store keeps the low 8 bits, so a distance of 256
// (all 256 bits differ at W = 8) reads 0.
//
// Design: one thread per row keeps that row's W <= MAX_WORDS words (and
// its validity bit) in registers and walks a tile of QT queries staged in
// shared memory; each query's distances are written as one coalesced run
// across the block's rows.  The TPU kernels tiled rows in VMEM subtiles to
// bound live vector registers; here the live set is W words per thread.
//
// Bound on the H100: memory.  The kernels read the N*W*4 sketch bytes
// (20 MB at 1M rows x 5 words) once per query tile and write the (Q, N)
// surface, which dominates from Q = 2 on (K2: 4 bytes a value, 32 MB at
// Q = 8; K3: 1 byte a value, 64 MB at Q = 64).  The popcounts are ~W*Q*N
// integer operations, far below the card's integer rate.  Fusing the
// candidate selection into the kernel, so the surface never reaches device
// memory, is the later fix for that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WORDS = 8;   // total sketch bits <= 256
constexpr int QT = 32;         // queries per block
constexpr int NTHREADS = 256;  // rows per block

__device__ __forceinline__ void store(float* out, long i, int d, bool ok) {
  out[i] = ok ? static_cast<float>(d) : 16384.f;
}

__device__ __forceinline__ void store(uint8_t* out, long i, int d, bool) {
  out[i] = static_cast<uint8_t>(d & 0xFF);
}

// OutT = float: K2 (valid mask applied); uint8_t: K3 (valid may be null)
template <typename OutT>
__global__ void __launch_bounds__(NTHREADS)
hamming_kernel(const uint32_t* __restrict__ qcodes,   // (Q, W)
               const uint32_t* __restrict__ hashes,   // (N, W)
               const uint8_t* __restrict__ valid,     // (N,) bool
               OutT* __restrict__ out,                // (Q, N)
               int Q, long N, int W) {
  __shared__ uint32_t qs[QT * MAX_WORDS];
  const int q0 = blockIdx.y * QT;
  for (int i = threadIdx.x; i < QT * W; i += NTHREADS) {
    const int q = q0 + i / W;
    qs[i] = q < Q ? qcodes[static_cast<long>(q) * W + i % W] : 0u;
  }
  __syncthreads();
  const long row = static_cast<long>(blockIdx.x) * NTHREADS + threadIdx.x;
  if (row >= N) return;
  uint32_t h[MAX_WORDS];
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w)
    h[w] = w < W ? hashes[row * W + w] : 0u;
  const bool ok = valid == nullptr || valid[row] != 0;
  const int qn = min(QT, Q - q0);
  for (int i = 0; i < qn; ++i) {
    int d = 0;
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w)
      if (w < W) d += __popc(qs[i * W + w] ^ h[w]);
    store(out, static_cast<long>(q0 + i) * N + row, d, ok);
  }
}

template <typename OutT>
int launch(const uint32_t* qcodes, const uint32_t* hashes,
           const uint8_t* valid, OutT* out, int Q, long N, int W,
           void* stream) {
  if (W < 1 || W > MAX_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  if (Q <= 0 || N <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((N + NTHREADS - 1) / NTHREADS),
                  static_cast<unsigned>((Q + QT - 1) / QT));
  hamming_kernel<OutT><<<grid, NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      qcodes, hashes, valid, out, Q, N, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes).  Each returns cudaGetLastError()
// after the launch; W must be in [1, MAX_WORDS].
extern "C" int hamming_launch(const uint32_t* qcodes, const uint32_t* hashes,
                              const uint8_t* valid, float* out, int Q, long N,
                              int W, void* stream) {
  return launch(qcodes, hashes, valid, out, Q, N, W, stream);
}

extern "C" int hamming_u8_launch(const uint32_t* qcodes,
                                 const uint32_t* hashes, uint8_t* out, int Q,
                                 long N, int W, void* stream) {
  return launch<uint8_t>(qcodes, hashes, nullptr, out, Q, N, W, stream);
}
