// In-place fused chain of single-qubit gates for Hopper (sm_90a), FP32.
//
// Replaces the TPU kernel `_fused_chain_kernel` / `apply_1q_chain` in
// quantum_computations_tpu/ops/pallas_kernels.py (kernel :219, wrapper
// :310, pallas_call :344, outputs aliased onto the inputs with `donate`).
//
// A chain is k <= 24 complex 2x2 gates on AMPLITUDE bits (LSB = 0; bits may
// repeat; chain order). Gates on different bits commute, so the Python
// wrapper composes them per bit in float64 on the host
// (`gate_kernels.compose_chain`): this kernel applies one mix per distinct
// bit, at most 13, to the split-real planes re, im (2^N float32 each) in
// ONE pass over device memory.
//
// Bound on an H100 SXM at N = 30, for the 24-gate chain on the 9 bits
// 7..15: both planes read and written once, 16 GiB, 5.13 ms at 3.35 TB/s;
// 9 mixes x 2^29 pairs x 32 FP32 operations = 1.55e11, 2.3 ms at
// 67 TFLOP/s. So the composed chain is bound by bytes. (The 24 gates one by
// one would be 4.1e11 operations, 6.15 ms, the bound of the first design,
// which also moved every amplitude through shared memory once per gate.)
//
// Design against that bound:
// - The tile (`gate_kernels.chain_tile`) is the distinct chain bits plus the
//   lowest other bits, 2^13 amplitudes per plane (64 KB for both planes),
//   clamped to 2^N. One block owns one value of every bit outside it: no
//   two blocks share an amplitude, which makes the update in place safe.
// - A thread keeps 2^5 amplitudes of each plane in registers, spanning 5 of
//   the tile's bits; its thread index spans the others. Stage s applies the
//   mixes of its register bits in registers (`gate_kernels.chain_plan`
//   picks the bits). The first stage loads from device memory, the last
//   stores; between two stages the tile goes once through shared memory
//   (a barrier, then a read in the next stage's layout). Nine chain bits
//   take two stages: one shared-memory round trip and two barriers per
//   tile, where the first design had 24.
// - The lanes of a warp span the tile's lowest bits, amplitude bits 0..3 at
//   N = 30: runs of 64 B, every sector used. Shared-memory slots are
//   swizzled (bit 4 ^= parity of bits >= 5) so that such lanes hit 32
//   banks in both layouts.
// - Every offset is computed once: the host gives each register index's
//   offset (device memory and shared memory) and each thread bit's
//   position; a thread forms its own part once per layout, and the
//   unrolled register loops add constant-bank offsets.
// - 256 threads of 2 x 32 floats each (128 registers a thread) and 64 KB
//   of shared memory per block: two blocks per SM, each with its whole
//   tile in flight from its loads into registers, before any mix.
// - Mixes (8 floats each) and tables travel by value in the kernel's
//   parameter block (about 1.7 KB of the 4 KB limit); no host-to-device
//   copy per chain.
//
// C interface, bound with ctypes: qct_apply_1q_chain takes HOST arrays in
// the fixed sizes of struct Plan below (the Python wrapper fills them from
// `chain_plan`) and returns cudaGetLastError() after the launch (or the
// error of an earlier runtime call, or cudaErrorInvalidValue for arguments
// out of range), 0 on success. It launches on the caller's stream,
// allocates nothing and never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRegBits = 5;  // amplitudes per plane per thread: 2^5
constexpr int kRegs = 1 << kRegBits;
constexpr int kMaxTileBits = 13;
constexpr int kMaxThreadBits = kMaxTileBits - kRegBits;
constexpr int kMaxStages = 3;
constexpr int kMaxOtherBits = 30;  // grid of 2^n_other blocks

struct Plan {
  float mix[kMaxStages][kRegBits][8];  // re[2][2] then im[2][2], row-major
  long long greg[2][kRegs];        // first/last stage: amplitude offset of
                                   // register index i
  int sreg[kMaxStages][kRegs];     // swizzled tile offset of register i
  int gthr[2][kMaxThreadBits];     // first/last stage: amplitude bit of
                                   // thread bit j
  int sthr[kMaxStages][kMaxThreadBits];  // tile bit of thread bit j
  int other[kMaxOtherBits];        // block index bit j is amplitude bit
  int mask[kMaxStages];            // register slot q of stage s has a mix
  int n_stages, thread_bits, n_other;
};

__device__ __forceinline__ int swizzle(int local) {
  return local ^ ((__popc(local >> 5) & 1) << 4);
}

// The thread's part of a tile index (or amplitude offset): thread bit j
// set contributes bit pos[j].
template <typename T>
__device__ __forceinline__ T thread_part(const int* pos, int n, int tid) {
  T off = 0;
#pragma unroll
  for (int j = 0; j < kMaxThreadBits; ++j)
    if (j < n) off |= (T)((tid >> j) & 1) << pos[j];
  return off;
}

// The mixes of stage S on the thread's registers: register slot q is one
// tile bit, so the pairs of slot q are (i, i | 1 << q).
template <int RB, int S>
__device__ __forceinline__ void mix_stage(float (&ar)[1 << RB],
                                          float (&ai)[1 << RB],
                                          const Plan& p) {
#pragma unroll
  for (int q = 0; q < RB; ++q) {
    if (!((p.mask[S] >> q) & 1)) continue;  // uniform across the block
    const float* u = p.mix[S][q];
#pragma unroll
    for (int i = 0; i < (1 << RB); ++i) {
      if (i & (1 << q)) continue;
      const int k = i | (1 << q);
      const float xr = ar[i], xi = ai[i], yr = ar[k], yi = ai[k];
      ar[i] = fmaf(u[0], xr, fmaf(-u[4], xi, fmaf(u[1], yr, -u[5] * yi)));
      ai[i] = fmaf(u[0], xi, fmaf(u[4], xr, fmaf(u[1], yi, u[5] * yr)));
      ar[k] = fmaf(u[2], xr, fmaf(-u[6], xi, fmaf(u[3], yr, -u[7] * yi)));
      ai[k] = fmaf(u[2], xi, fmaf(u[6], xr, fmaf(u[3], yi, u[7] * yr)));
    }
  }
}

// Stage S > 0: the registers go to shared memory in stage S - 1's layout
// and come back in stage S's, then stage S's mixes.
template <int RB, int S>
__device__ __forceinline__ void exchange(float (&ar)[1 << RB],
                                         float (&ai)[1 << RB], float* s_re,
                                         float* s_im, const Plan& p,
                                         int tid) {
  if (S > 1) __syncthreads();  // stage S - 1's shared reads are done
  int st = swizzle(thread_part<int>(p.sthr[S - 1], p.thread_bits, tid));
#pragma unroll
  for (int i = 0; i < (1 << RB); ++i) {
    s_re[st ^ p.sreg[S - 1][i]] = ar[i];
    s_im[st ^ p.sreg[S - 1][i]] = ai[i];
  }
  __syncthreads();  // the whole tile is in shared memory
  st = swizzle(thread_part<int>(p.sthr[S], p.thread_bits, tid));
#pragma unroll
  for (int i = 0; i < (1 << RB); ++i) {
    ar[i] = s_re[st ^ p.sreg[S][i]];
    ai[i] = s_im[st ^ p.sreg[S][i]];
  }
  mix_stage<RB, S>(ar, ai, p);
}

template <int RB>
__global__ void __launch_bounds__(1 << kMaxThreadBits, 2)
chain_kernel(float* __restrict__ re, float* __restrict__ im,
             const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) float smem[];
  float* s_re = smem;
  float* s_im = smem + (1 << (p.thread_bits + RB));
  const int tid = threadIdx.x;

  int64_t base = 0;
#pragma unroll
  for (int j = 0; j < kMaxOtherBits; ++j)
    if (j < p.n_other) base |= (int64_t)((blockIdx.x >> j) & 1) << p.other[j];

  float ar[1 << RB], ai[1 << RB];
  const int64_t in = base | thread_part<int64_t>(p.gthr[0], p.thread_bits, tid);
#pragma unroll
  for (int i = 0; i < (1 << RB); ++i) {
    ar[i] = re[in + p.greg[0][i]];
    ai[i] = im[in + p.greg[0][i]];
  }
  mix_stage<RB, 0>(ar, ai, p);
  if (p.n_stages > 1) exchange<RB, 1>(ar, ai, s_re, s_im, p, tid);
  if (p.n_stages > 2) exchange<RB, 2>(ar, ai, s_re, s_im, p, tid);

  const int64_t out = base | thread_part<int64_t>(p.gthr[1], p.thread_bits, tid);
#pragma unroll
  for (int i = 0; i < (1 << RB); ++i) {
    re[out + p.greg[1][i]] = ar[i];
    im[out + p.greg[1][i]] = ai[i];
  }
}

template <int RB>
cudaError_t launch(float* re, float* im, const Plan& p, cudaStream_t stream) {
  const int smem = p.n_stages > 1
                       ? 2 * (1 << (p.thread_bits + RB)) * (int)sizeof(float)
                       : 0;
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  chain_kernel<RB><<<1u << p.n_other, 1 << p.thread_bits, smem, stream>>>(
      re, im, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qct_apply_1q_chain(float* re, float* im, const float* mix,
                                  const long long* greg, const int* sreg,
                                  const int* gthr, const int* sthr,
                                  const int* mask, int n_stages, int reg_bits,
                                  int thread_bits, const int* other,
                                  int n_other, void* stream) {
  const int tile_bits = reg_bits + thread_bits;
  if (!re || !im || !mix || !greg || !sreg || !gthr || !sthr || !mask ||
      !other || n_stages < 1 || n_stages > kMaxStages || reg_bits < 1 ||
      reg_bits > kRegBits || thread_bits < 0 ||
      tile_bits > kMaxTileBits || n_other < 0 || n_other > kMaxOtherBits ||
      (reg_bits < kRegBits && thread_bits > 0))
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.n_stages = n_stages;
  p.thread_bits = thread_bits;
  p.n_other = n_other;
  for (int s = 0; s < kMaxStages; ++s) {
    p.mask[s] = s < n_stages ? mask[s] : 0;
    for (int q = 0; q < kRegBits; ++q)
      for (int c = 0; c < 8; ++c)
        p.mix[s][q][c] = mix[(s * kRegBits + q) * 8 + c];
    for (int i = 0; i < kRegs; ++i) {
      p.sreg[s][i] = sreg[s * kRegs + i];
      if (p.sreg[s][i] < 0 || p.sreg[s][i] >= (1 << tile_bits))
        return (int)cudaErrorInvalidValue;
    }
    for (int j = 0; j < kMaxThreadBits; ++j) {
      p.sthr[s][j] = sthr[s * kMaxThreadBits + j];
      if (p.sthr[s][j] < 0 || p.sthr[s][j] >= tile_bits)
        return (int)cudaErrorInvalidValue;
    }
  }
  for (int s = 0; s < 2; ++s) {
    for (int i = 0; i < kRegs; ++i) p.greg[s][i] = greg[s * kRegs + i];
    for (int j = 0; j < kMaxThreadBits; ++j) {
      p.gthr[s][j] = gthr[s * kMaxThreadBits + j];
      if (p.gthr[s][j] < 0 || p.gthr[s][j] > 62)
        return (int)cudaErrorInvalidValue;
    }
  }
  for (int j = 0; j < kMaxOtherBits; ++j) {
    p.other[j] = j < n_other ? other[j] : 0;
    if (p.other[j] < 0 || p.other[j] > 62) return (int)cudaErrorInvalidValue;
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (reg_bits) {
    case 1: return (int)launch<1>(re, im, p, s);
    case 2: return (int)launch<2>(re, im, p, s);
    case 3: return (int)launch<3>(re, im, p, s);
    case 4: return (int)launch<4>(re, im, p, s);
    default: return (int)launch<5>(re, im, p, s);
  }
}
