// In-place split-real gate mixes for Hopper (sm_90a), FP32 FFMA:
// a 2x2 complex mix of one qubit and a 4x4 complex mix of an adjacent pair.
//
// Replaces the TPU kernels in quantum_computations_tpu/ops/pallas_kernels.py:
// - `_mix_kernel` / `apply_1q` (kernel :31, wrapper :62, pallas_call :90);
// - `_mix4_kernel` / `apply_2q_adjacent` (kernel :104, wrapper :132,
//   pallas_call :160).
//
// The planes re, im (2^N float32 each, qubit q big-endian: amplitude bit
// N - q - 1) are viewed as (2^q, B, inner) with B = 2 (one qubit) or 4 (the
// pair q, q+1; branch index 2 b_q + b_{q+1}) and inner = 2^(N - q - log2 B).
// For every (outer, inner) the B branches are mixed by the gate:
//     x_b <- sum_c u[b][c] x_c   (complex, split into re/im planes).
//
// Bound on an H100 SXM at N = 30: both planes are read and written once,
// 16 GiB, 5.13 ms at 3.35 TB/s; the mixes are 2^29 pairs x 32 FP32
// operations (0.26 ms) for one qubit and 2^28 groups x 128 (0.51 ms) for a
// pair, at 67 TFLOP/s. Both are bound by bytes.
//
// Design against that bound:
// - A streaming kernel: each thread owns whole branch groups, reads their
//   B amplitudes of both planes, mixes them in registers and writes them
//   back to the same addresses. No two threads share an amplitude, so the
//   update in place is safe without any synchronisation.
// - Consecutive threads take consecutive `inner` indices, so every branch
//   row is read and written in coalesced runs; with inner >= 4 and 16-byte
//   aligned planes each thread moves float4 vectors (4 groups at once).
//   The TPU kernel refuses inner < 128 (a lane rule); this one takes any
//   qubit, and below inner = 32 (the last qubits) its accesses are strided.
// - The gate (8 or 32 floats) travels by value in the kernel's parameter
//   block: no host-to-device copy and no synchronisation per gate.
// - A grid-stride loop over a grid of a few waves; 64-bit offsets.
//
// C interface, bound with ctypes: qct_apply_1q / qct_apply_2q_adjacent
// take the gate as a HOST array (B*B real parts, then B*B imaginary parts,
// row-major) and return cudaGetLastError() after the launch, 0 on success.
// They launch on the caller's stream, allocate nothing and never
// synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int B>
struct Gate {
  float re[B][B];
  float im[B][B];
};

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

// One thread step mixes V consecutive inner positions of one outer index.
template <int B, int V>
__global__ void __launch_bounds__(kThreads)
mix_kernel(float* __restrict__ re, float* __restrict__ im, const Gate<B> u,
           int log_inner, long long steps) {
  using Vf = Vec<V>;
  const int log_inner_v = log_inner - (V == 4 ? 2 : 0);
  const long long inner_v_mask = (1LL << log_inner_v) - 1;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
       s < steps; s += stride) {
    const long long outer = s >> log_inner_v;
    const int64_t base =
        ((outer * B) << log_inner) + (s & inner_v_mask) * (int64_t)V;
    Vf xr[B], xi[B];
#pragma unroll
    for (int c = 0; c < B; ++c) {
      const int64_t off = base + ((int64_t)c << log_inner);
      xr[c] = *reinterpret_cast<const Vf*>(re + off);
      xi[c] = *reinterpret_cast<const Vf*>(im + off);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      Vf yr, yi;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int c = 0; c < B; ++c) {
          ar = fmaf(u.re[b][c], xr[c].v[j], ar);
          ar = fmaf(-u.im[b][c], xi[c].v[j], ar);
          ai = fmaf(u.re[b][c], xi[c].v[j], ai);
          ai = fmaf(u.im[b][c], xr[c].v[j], ai);
        }
        yr.v[j] = ar;
        yi.v[j] = ai;
      }
      const int64_t off = base + ((int64_t)b << log_inner);
      *reinterpret_cast<Vf*>(re + off) = yr;
      *reinterpret_cast<Vf*>(im + off) = yi;
    }
  }
}

template <int B>
cudaError_t launch(float* re, float* im, const float* u_host, int qubit,
                   int num_qubits, cudaStream_t stream) {
  const int log_b = B == 2 ? 1 : 2;
  if (!re || !im || !u_host || num_qubits < log_b || num_qubits > 40 ||
      qubit < 0 || qubit > num_qubits - log_b)
    return cudaErrorInvalidValue;
  Gate<B> u;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < B; ++c) {
      u.re[b][c] = u_host[b * B + c];
      u.im[b][c] = u_host[B * B + b * B + c];
    }
  const int log_inner = num_qubits - qubit - log_b;
  const bool vec = log_inner >= 2 &&
                   reinterpret_cast<uintptr_t>(re) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(im) % 16 == 0;
  const long long groups = 1LL << (num_qubits - log_b);
  const long long steps = vec ? groups / 4 : groups;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long want = (steps + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;  // a few waves of 2048 threads
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  if (vec)
    mix_kernel<B, 4><<<grid, kThreads, 0, stream>>>(re, im, u, log_inner,
                                                     steps);
  else
    mix_kernel<B, 1><<<grid, kThreads, 0, stream>>>(re, im, u, log_inner,
                                                     steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qct_apply_1q(float* re, float* im, const float* u, int qubit,
                            int num_qubits, void* stream) {
  return (int)launch<2>(re, im, u, qubit, num_qubits,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int qct_apply_2q_adjacent(float* re, float* im, const float* u,
                                     int qubit, int num_qubits,
                                     void* stream) {
  return (int)launch<4>(re, im, u, qubit, num_qubits,
                        static_cast<cudaStream_t>(stream));
}
