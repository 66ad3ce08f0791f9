// In-place split-real slab-window mix for Hopper (sm_90a), FP32 FFMA.
//
// Replaces the TPU kernel `_slab_mix_kernel` / `slab_matmul` in
// quantum_computations_tpu/ops/pallas_kernels.py (kernel :254, wrapper :274,
// pallas_call :296, outputs aliased onto the inputs at :302).
//
// Computes, in place on the two planes viewed as (R, d) row-major matrices,
//     re <- re . Wt_re - im . Wt_im
//     im <- im . Wt_re + re . Wt_im
// where Wt = W^T is the ALREADY-TRANSPOSED window (d, d), d = 2^S <= 128.
//
// Bound on an H100 SXM at N = 30, d = 128 (R = 2^23): the planes move
// 2 x 4 GiB in and 2 x 4 GiB out = 16 GiB, 5.1 ms at 3.35 TB/s; the four
// real products are 8 R d^2 = 1.1e12 FP32 operations, 16.4 ms at the
// 67 TFLOP/s of FFMA. So at d = 128 the kernel is bound by operations,
// and below d = 40 (20 operations per byte) by bytes.
//
// Design against that bound:
// - The JAX kernel accumulates in float32, so this one keeps full FP32 FMA
//   accumulation (no TF32). Moving the products onto the tensor cores
//   (3xTF32) is later work.
// - Wt_re and Wt_im (2 d^2 floats, 128 KB at d = 128) are loaded into
//   shared memory ONCE per block; the grid is persistent (one wave of
//   blocks that loop over row tiles), so the window is not re-read from L2
//   for each of the 2^17 row tiles at N = 30.
// - Each row tile of both planes is staged in shared memory and every
//   block reads all of its rows, in both planes, before it writes any of
//   them; no two blocks ever hold the same rows. That is what makes the
//   update in place safe.
// - Each thread keeps a 4-row x (up to 8)-column complex register tile:
//   per 4-wide k step it issues 8 + 16 vector shared loads for 512 FMAs.
// - Element offsets are 64-bit (R d exceeds 2^31 from N = 31 on).
//
// C interface, bound with ctypes: qct_slab_matmul returns cudaGetLastError()
// after the launch (or the error of an earlier runtime call), 0 on success.
// It launches on the caller's stream, allocates nothing and never
// synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

template <int D>
struct Tile {
  static constexpr int VW = D < 4 ? D : 4;          // floats per vector access
  static constexpr int NCH = D >= 128 ? 2 : 1;       // column chunks per thread
  static constexpr int TN = VW * NCH;                // columns per thread
  static constexpr int TX = D / TN;                  // threads across columns
  static constexpr int TY = kThreads / TX;           // threads down the rows
  static constexpr int TM = kRowsPerThread;          // rows per thread
  static constexpr int BM = TY * TM;                 // rows per tile
  static constexpr int LD = D + VW;                  // padded smem row stride
  static constexpr size_t kSmemFloats = 2 * D * D + 2 * BM * LD;
  static_assert(TX * TN == D && TY * TX == kThreads, "bad tiling");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
slab_mix_kernel(float* __restrict__ re, float* __restrict__ im,
                const float* __restrict__ wt_re,
                const float* __restrict__ wt_im, long long rows) {
  using T = Tile<D>;
  using V = Vec<T::VW>;
  extern __shared__ __align__(16) float smem[];
  float* s_wr = smem;                 // (D, D): s_wr[k * D + n] = Wt_re[k][n]
  float* s_wi = s_wr + D * D;
  float* s_xr = s_wi + D * D;         // (BM, LD) tile of re
  float* s_xi = s_xr + T::BM * T::LD; // (BM, LD) tile of im

  const int tid = threadIdx.x;
  for (int e = tid * T::VW; e < D * D; e += kThreads * T::VW) {
    *reinterpret_cast<V*>(s_wr + e) = *reinterpret_cast<const V*>(wt_re + e);
    *reinterpret_cast<V*>(s_wi + e) = *reinterpret_cast<const V*>(wt_im + e);
  }

  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const long long n_tiles = (rows + T::BM - 1) / T::BM;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * T::BM;
    const int valid = (int)min((long long)T::BM, rows - row0);
    const int64_t base = row0 * (int64_t)D;

    __syncthreads();  // the previous tile's shared reads are done
    for (int e = tid * T::VW; e < T::BM * D; e += kThreads * T::VW) {
      const int r = e / D;
      const int c = e % D;
      V a, b;
      if (r < valid) {
        a = *reinterpret_cast<const V*>(re + base + e);
        b = *reinterpret_cast<const V*>(im + base + e);
      } else {
#pragma unroll
        for (int j = 0; j < T::VW; ++j) a.v[j] = b.v[j] = 0.f;
      }
      *reinterpret_cast<V*>(s_xr + r * T::LD + c) = a;
      *reinterpret_cast<V*>(s_xi + r * T::LD + c) = b;
    }
    __syncthreads();  // whole tile (and the window) staged: safe to write

    float acc_r[T::TM][T::TN];
    float acc_i[T::TM][T::TN];
#pragma unroll
    for (int m = 0; m < T::TM; ++m)
#pragma unroll
      for (int n = 0; n < T::TN; ++n) acc_r[m][n] = acc_i[m][n] = 0.f;

#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += T::VW) {
      float xr[T::TM][T::VW], xi[T::TM][T::VW];
#pragma unroll
      for (int m = 0; m < T::TM; ++m) {
        const int off = (ty * T::TM + m) * T::LD + k0;
        const V a = *reinterpret_cast<const V*>(s_xr + off);
        const V b = *reinterpret_cast<const V*>(s_xi + off);
#pragma unroll
        for (int j = 0; j < T::VW; ++j) {
          xr[m][j] = a.v[j];
          xi[m][j] = b.v[j];
        }
      }
#pragma unroll
      for (int kk = 0; kk < T::VW; ++kk) {
        float wr[T::TN], wi[T::TN];
#pragma unroll
        for (int ch = 0; ch < T::NCH; ++ch) {
          const int off = (k0 + kk) * D + ch * (D / T::NCH) + tx * T::VW;
          const V a = *reinterpret_cast<const V*>(s_wr + off);
          const V b = *reinterpret_cast<const V*>(s_wi + off);
#pragma unroll
          for (int j = 0; j < T::VW; ++j) {
            wr[ch * T::VW + j] = a.v[j];
            wi[ch * T::VW + j] = b.v[j];
          }
        }
#pragma unroll
        for (int m = 0; m < T::TM; ++m)
#pragma unroll
          for (int n = 0; n < T::TN; ++n) {
            acc_r[m][n] = fmaf(xr[m][kk], wr[n], acc_r[m][n]);
            acc_r[m][n] = fmaf(-xi[m][kk], wi[n], acc_r[m][n]);
            acc_i[m][n] = fmaf(xi[m][kk], wr[n], acc_i[m][n]);
            acc_i[m][n] = fmaf(xr[m][kk], wi[n], acc_i[m][n]);
          }
      }
    }

#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = ty * T::TM + m;
      if (r >= valid) continue;
#pragma unroll
      for (int ch = 0; ch < T::NCH; ++ch) {
        const int c = ch * (D / T::NCH) + tx * T::VW;
        V a, b;
#pragma unroll
        for (int j = 0; j < T::VW; ++j) {
          a.v[j] = acc_r[m][ch * T::VW + j];
          b.v[j] = acc_i[m][ch * T::VW + j];
        }
        *reinterpret_cast<V*>(re + base + (int64_t)r * D + c) = a;
        *reinterpret_cast<V*>(im + base + (int64_t)r * D + c) = b;
      }
    }
  }
}

template <int D>
cudaError_t launch(float* re, float* im, const float* wt_re,
                   const float* wt_im, long long rows, cudaStream_t stream) {
  using T = Tile<D>;
  const size_t smem = T::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slab_mix_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slab_mix_kernel<D>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_tiles = (rows + T::BM - 1) / T::BM;
  const long long grid = n_tiles < (long long)sms * per_sm
                             ? n_tiles : (long long)sms * per_sm;
  slab_mix_kernel<D><<<(unsigned)grid, kThreads, smem, stream>>>(
      re, im, wt_re, wt_im, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qct_slab_matmul(float* re, float* im, const float* wt_re,
                               const float* wt_im, long long rows, int d,
                               void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return (int)launch<2>(re, im, wt_re, wt_im, rows, s);
    case 4: return (int)launch<4>(re, im, wt_re, wt_im, rows, s);
    case 8: return (int)launch<8>(re, im, wt_re, wt_im, rows, s);
    case 16: return (int)launch<16>(re, im, wt_re, wt_im, rows, s);
    case 32: return (int)launch<32>(re, im, wt_re, wt_im, rows, s);
    case 64: return (int)launch<64>(re, im, wt_re, wt_im, rows, s);
    case 128: return (int)launch<128>(re, im, wt_re, wt_im, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
