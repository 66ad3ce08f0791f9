// In-place fused chain of single-qubit gates for Hopper (sm_90a), FP32.
//
// Replaces the TPU kernel `_fused_chain_kernel` / `apply_1q_chain` in
// quantum_computations_tpu/ops/pallas_kernels.py (kernel :219, wrapper
// :310, pallas_call :344, outputs aliased onto the inputs with `donate`).
//
// Applies k <= 24 complex 2x2 mixes, gate g on AMPLITUDE bit bits[g]
// (LSB = 0; bits may repeat; chain order), to the split-real planes re, im
// (2^N float32 each) in ONE pass over device memory.
//
// Bound on an H100 SXM at N = 30, for a 24-gate chain: both planes read and
// written once, 16 GiB, 5.13 ms at 3.35 TB/s; 24 x 2^29 pairs x 32 FP32
// operations = 4.1e11, 6.15 ms at 67 TFLOP/s. So it is bound by operations
// at k = 24 and by bytes below k ~ 20. This design also moves every
// amplitude through shared memory once per gate (read and write, both
// planes): 24 x 16 GiB, about 12.3 ms at the SMs' 128 B/clock x 132 SMs at
// 1.98 GHz (33.5 TB/s), so its own bound at k = 24 is that round trip.
//
// Design against those bounds:
// - The TPU block is (32, 2048) float32 per plane, 512 KB for both planes:
//   more than the 227 KB of shared memory an H100 block may use. So the
//   tile here is chosen per chain: the distinct chain bits plus the lowest
//   other bits, 2^13 amplitudes per plane (64 KB for both planes, three
//   blocks per SM), clamped to 2^N. Its low bits that are amplitude bits
//   0..low-1 make coalesced runs of 2^low floats.
// - One block owns one value of every bit outside the tile: it loads its
//   tile of both planes into shared memory, applies the gates in chain
//   order with a __syncthreads() between gates, and writes the tile back
//   to the same addresses. No two blocks share an amplitude, which makes
//   the update in place safe.
// - The gates (8 floats each) and the bit maps travel by value in the
//   kernel's parameter block (about 1.1 KB of the 4 KB limit); the gate
//   loop is unrolled, so every gate's coefficients are constant-bank
//   operands of the FFMAs. No host-to-device copy per chain.
// - Keeping several gates' amplitudes in registers between syncs, to cut
//   the shared-memory round trips, is later work.
//
// C interface, bound with ctypes: qct_apply_1q_chain takes HOST arrays
// (the Python wrapper's `chain_tile` computes the bit maps) and returns
// cudaGetLastError() after the launch (or the error of an earlier runtime
// call, or cudaErrorInvalidValue for arguments out of range), 0 on success.
// It launches on the caller's stream, allocates nothing and never
// synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxGates = 24;
constexpr int kMaxTileBits = 13;
constexpr int kMaxOtherBits = 30;  // grid of 2^n_other blocks

struct Chain {
  float u[kMaxGates][8];  // re[2][2] then im[2][2], row-major
  int local[kMaxGates];   // gate g's bit inside the tile
  int high[kMaxTileBits]; // tile bit low + j is amplitude bit high[j]
  int other[kMaxOtherBits];  // block index bit j is amplitude bit other[j]
  int k, low, n_high, n_other;
};

__device__ __forceinline__ int64_t tile_offset(const Chain& c, int l,
                                               int64_t base) {
  int64_t off = base | (l & ((1 << c.low) - 1));
#pragma unroll
  for (int j = 0; j < kMaxTileBits; ++j)
    if (j < c.n_high) off |= (int64_t)((l >> (c.low + j)) & 1) << c.high[j];
  return off;
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(float* __restrict__ re, float* __restrict__ im,
             const __grid_constant__ Chain c) {
  extern __shared__ __align__(16) float smem[];
  const int size = 1 << (c.low + c.n_high);
  float* s_re = smem;
  float* s_im = smem + size;

  int64_t base = 0;
#pragma unroll
  for (int j = 0; j < kMaxOtherBits; ++j)
    if (j < c.n_other) base |= (int64_t)((blockIdx.x >> j) & 1) << c.other[j];

  for (int l = threadIdx.x; l < size; l += kThreads) {
    const int64_t off = tile_offset(c, l, base);
    s_re[l] = re[off];
    s_im[l] = im[off];
  }
  __syncthreads();  // the whole tile is staged before any gate

  const int pairs = size >> 1;
#pragma unroll
  for (int g = 0; g < kMaxGates; ++g) {
    if (g >= c.k) break;  // uniform across the block
    const int lb = c.local[g];
    const int lo_mask = (1 << lb) - 1;
    const float* u = c.u[g];
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int i0 = ((p >> lb) << (lb + 1)) | (p & lo_mask);
      const int i1 = i0 | (1 << lb);
      const float ar = s_re[i0], ai = s_im[i0];
      const float br = s_re[i1], bi = s_im[i1];
      s_re[i0] = fmaf(u[0], ar, fmaf(-u[4], ai, fmaf(u[1], br, -u[5] * bi)));
      s_im[i0] = fmaf(u[0], ai, fmaf(u[4], ar, fmaf(u[1], bi, u[5] * br)));
      s_re[i1] = fmaf(u[2], ar, fmaf(-u[6], ai, fmaf(u[3], br, -u[7] * bi)));
      s_im[i1] = fmaf(u[2], ai, fmaf(u[6], ar, fmaf(u[3], bi, u[7] * br)));
    }
    __syncthreads();  // gate g is done everywhere before gate g + 1
  }

  for (int l = threadIdx.x; l < size; l += kThreads) {
    const int64_t off = tile_offset(c, l, base);
    re[off] = s_re[l];
    im[off] = s_im[l];
  }
}

}  // namespace

extern "C" int qct_apply_1q_chain(float* re, float* im, const float* us,
                                  const int* local, int k, const int* high,
                                  int n_high, int low, const int* other,
                                  int n_other, void* stream) {
  const int tile_bits = low + n_high;
  if (!re || !im || !us || !local || !high || !other || k < 1 ||
      k > kMaxGates || n_high < 0 || low < 0 || tile_bits < 1 ||
      tile_bits > kMaxTileBits || n_other < 0 || n_other > kMaxOtherBits)
    return (int)cudaErrorInvalidValue;
  Chain c;
  c.k = k;
  c.low = low;
  c.n_high = n_high;
  c.n_other = n_other;
  for (int g = 0; g < k; ++g) {
    if (local[g] < 0 || local[g] >= tile_bits)
      return (int)cudaErrorInvalidValue;
    c.local[g] = local[g];
    for (int j = 0; j < 8; ++j) c.u[g][j] = us[8 * g + j];
  }
  for (int g = k; g < kMaxGates; ++g) {
    c.local[g] = 0;
    for (int j = 0; j < 8; ++j) c.u[g][j] = 0.f;
  }
  for (int j = 0; j < kMaxTileBits; ++j) c.high[j] = j < n_high ? high[j] : 0;
  for (int j = 0; j < kMaxOtherBits; ++j)
    c.other[j] = j < n_other ? other[j] : 0;

  const int smem = 2 * (1 << tile_bits) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<1u << n_other, kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(re, im, c);
  return (int)cudaGetLastError();
}
