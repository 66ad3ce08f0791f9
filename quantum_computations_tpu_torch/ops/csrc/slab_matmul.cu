// In-place split-real slab-window mix for Hopper (sm_90a): 3xTF32 on the
// tensor cores (wgmma) for d >= 64, FP32 FFMA for d <= 32.
//
// Replaces the TPU kernel `_slab_mix_kernel` / `slab_matmul` in
// quantum_computations_tpu/ops/pallas_kernels.py (kernel :254, wrapper :274,
// pallas_call :296, outputs aliased onto the inputs at :302).
//
// Computes, in place on the two planes viewed as (R, d) row-major matrices,
//     re <- re . Wt_re - im . Wt_im
//     im <- im . Wt_re + re . Wt_im
// where Wt = W^T is the ALREADY-TRANSPOSED window (d, d), d = 2^S <= 128.
// As one real GEMM: [re | im] (R, 2d) times [[Wt_re, Wt_im], [-Wt_im, Wt_re]]
// (2d, 2d).
//
// Bound on an H100 SXM at N = 30, d = 128 (R = 2^23): the planes move
// 2 x 4 GiB in and 2 x 4 GiB out = 16 GiB, 5.1 ms at 3.35 TB/s. The product
// is 8 R d^2 = 1.1e12 operations: 16.4 ms on FP32 FFMA (67 TFLOP/s), which
// bound the first design of this kernel. On the tensor cores a TF32 product
// keeps 10 mantissa bits (about 1e-3 relative), too few for the float32
// accumulation the JAX kernel keeps. So each operand is split as
// a = big + small, big = tf32(a) rounded to nearest (as cvt.rna), small =
// tf32(a - big), and big.big + big.small + small.big is summed in FP32
// accumulators (3xTF32; the dropped small.small is ~2^-22 relative). That
// is 3 x 1.1e12 operations, 6.7 ms at the 495 TFLOP/s of dense TF32: the
// bound of this design, above the 5.1 ms of bytes.
//
// Accumulation: the tensor cores add each product into their FP32
// accumulator with truncation, not round-to-nearest, so a running sum that
// takes all 3 x 2d / 8 products loses about half an ulp per product, always
// toward zero: 2.4e-6 of max|out| at d = 128 and a norm that shrinks window
// by window. So the products of kQ = 4 16-column k-blocks (small terms
// first) go into a fresh fragment, which is added to the running sum with
// round-to-nearest FADDs: the truncations fall on partial sums of a
// quarter of the columns, and the running sum rounds without bias.
//
// Design of the tensor-core path (d = D in {64, 128}, H = D / 2):
// - wgmma.m64nDk8 TF32, A from registers, B from shared memory. B must be
//   pre-split there, and big and small of both Wt planes (4 D^2 words,
//   256 KB at D = 128) do not fit the 227 KB a block may use. So a cluster
//   of two CTAs shares each row tile: CTA `rank` computes output columns
//   rank H .. rank H + H - 1 of both planes and holds, big and small,
//   [-Wt_im | Wt_re | Wt_im] on its H columns (6 D H words, 192 KB at
//   D = 128). Per k-step, re rows (A = re) times [Wt_re | Wt_im] and im
//   rows (A = im) times [-Wt_im | Wt_re] give the 64 x D block
//   [re out | im out] of one warpgroup in one product each.
// - B is staged once per CTA (the grid is persistent: one wave of
//   clusters that loop over row tiles) as 8 x 16-byte core matrices
//   without swizzle. The k order inside a 16-column block is permuted so
//   that a lane's A values of two k-steps are 4 consecutive floats of one
//   row: A comes straight from device memory, one float4 per row and
//   k-block, prefetched one wait ahead, and is split in registers.
// - Two warpgroups per CTA, 64 rows each. A warpgroup issues the 24
//   products of 4 k-blocks (64 columns) before it waits for them and adds
//   them up; meanwhile the other keeps the tensor cores busy. Fewer,
//   longer groups beat more warpgroups: three warpgroups leave registers
//   for one k-block per wait only.
// - In place: every warp reads all 2D columns of its rows before the
//   cluster barrier (arrive after the last read, wait before the first
//   write), and only the two CTAs of a cluster touch those rows. The
//   barrier is what makes both halves of a row read before either writes.
// - Element offsets are 64-bit (R d exceeds 2^31 from N = 31 on).
// d <= 32 occurs only at N <= 5 (the slab is min(7, N) qubits) and in
// tests; those windows run the FFMA kernel at the end, chosen by d.
//
// C interface, bound with ctypes: qct_slab_matmul returns cudaGetLastError()
// after the launch (or the error of an earlier runtime call), 0 on success,
// and stores in *path which kernel it launched (1: 3xTF32 tensor cores,
// 0: FFMA). It launches on the caller's stream, allocates nothing and
// never synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// -- 3xTF32 tensor-core path, d >= 64 ---------------------------------------

constexpr int kWgThreads = 256;  // 2 warpgroups of 64 rows
constexpr int kWgRows = 64 * (kWgThreads / 128);  // rows of a cluster tile
constexpr int kQ = 4;  // 16-column k-blocks per fresh fragment (and wait)

template <int D>
struct Wg {
  static constexpr int H = D / 2;  // columns of each plane per CTA
  static constexpr int KB = D / 16;  // 16-column k-blocks of one plane
  // one k-step of B: 3 H columns in (3 H / 8) x 2 core matrices of 32 words
  static constexpr int kStep = (3 * H / 8) * 2 * 32;
  static constexpr int kPart = (D / 8) * kStep;  // words of big (or small)
  static constexpr size_t kSmemBytes = 2 * kPart * sizeof(uint32_t);
};

// big = x rounded to TF32 (10 mantissa bits, to nearest, ties away: what
// cvt.rna.tf32.f32 gives, in two integer operations instead of a
// conversion), small = x - big, exact in FP32. The tensor cores read only
// the top 19 bits of a TF32 operand, so small enters the products
// truncated to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Shared-memory matrix descriptor of a K-major B tile without swizzle:
// core matrices of 8 rows x 16 bytes, 128 bytes apart along K and 256
// along N.
__device__ __forceinline__ uint64_t b_desc(const uint32_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// D (64 x N, f32) = [D +] A B, A from registers: m64n64k8 and m64n128k8
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Keeps the compiler from moving reads or writes of r across the wgmma
// wait: the registers stay the asynchronous operands until then.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A lane's raw A values of k-block b: rows g and g + 8 of its warp's 16
// rows, the float4 at columns 16 (b % KB) + 4 t of re (b < KB) or im.
template <int D>
__device__ __forceinline__ void load_rows(float4 (&v)[2],
                                          const float* __restrict__ re,
                                          const float* __restrict__ im,
                                          long long rows, long long row0,
                                          int b, int g, int t) {
  constexpr int KB = D / 16;
  const float* src = b < KB ? re : im;
  const int col = 16 * (b % KB) + 4 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + 8 * h + g;
    v[h] = r < rows ? *reinterpret_cast<const float4*>(
                          src + r * (int64_t)D + col)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kWgThreads, 1)
slab_mix_wgmma_kernel(float* __restrict__ re, float* __restrict__ im,
                      const float* __restrict__ wt_re,
                      const float* __restrict__ wt_im, long long rows) {
  using G = Wg<D>;
  constexpr int H = G::H, KB = G::KB;
  static_assert(KB % kQ == 0, "a wait's k-blocks lie in one plane");
  // B words, big then small. Column c of the 3 H is -Wt_im, Wt_re or
  // Wt_im (c / H = 0, 1, 2) at column rank H + c % H. k-step s (k-block
  // s / 2, j = s % 2) at + s kStep, its core matrix (c / 8, kc) at
  // + (2 (c / 8) + kc) 32, row c % 8 at + 4 (c % 8); element e of that row
  // is row 16 (s / 2) + 4 e + 2 kc + s % 2 of Wt, the k order of the A
  // fragments.
  extern __shared__ __align__(128) uint32_t s_b[];
  const uint32_t rank = cluster_rank();
  for (int w = threadIdx.x; w < G::kPart; w += kWgThreads) {
    const int s = w / G::kStep, cm = (w % G::kStep) / 32;
    const int k = 16 * (s / 2) + 4 * (w % 4) + 2 * (cm % 2) + s % 2;
    const int c = 8 * (cm / 2) + (w % 32) / 4;
    const int n = k * D + rank * H + c % H;
    const float x = c < H ? -wt_im[n] : c < 2 * H ? wt_re[n] : wt_im[n];
    split(x, s_b[w], s_b[G::kPart + w]);
  }
  // written through the generic proxy, read by wgmma through the async one
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int my_rows = 16 * warp;  // warpgroup w has rows 64 w .. 64 w + 63
  const long long n_tiles = (rows + kWgRows - 1) / kWgRows;
  const long long stride = gridDim.x / 2;
  long long tile = blockIdx.x / 2;

  float part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
  // the raw A of the next kQ k-blocks, prefetched a wait ahead
  float4 next[kQ][2];
  if (tile < n_tiles)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      load_rows<D>(next[q], re, im, rows, tile * kWgRows + my_rows, q, g, t);
  for (; tile < n_tiles; tile += stride) {
    const long long row0 = tile * kWgRows + my_rows;
    float acc[D / 2];  // columns 8 i + 2 t (+1) of [re out | im out]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
    for (int b = 0; b < 2 * KB; b += kQ) {
      // A fragments of k-step s = 2 q + j: a0 (g, j), a1 (g + 8, j),
      // a2 (g, j + 2), a3 (g + 8, j + 2) of block b + q's float4s
      uint32_t a_big[2 * kQ][4], a_small[2 * kQ][4];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t(&ab)[4] = a_big[2 * q + j];
          uint32_t(&as)[4] = a_small[2 * q + j];
          split(comp(next[q][0], j), ab[0], as[0]);
          split(comp(next[q][1], j), ab[1], as[1]);
          split(comp(next[q][0], j + 2), ab[2], as[2]);
          split(comp(next[q][1], j + 2), ab[3], as[3]);
        }
      // prefetch: the next kQ k-blocks, or the first of the next tile
      // (rows only this cluster touches)
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (b + kQ < 2 * KB)
          load_rows<D>(next[q], re, im, rows, row0, b + kQ + q, g, t);
        else if (tile + stride < n_tiles)
          load_rows<D>(next[q], re, im, rows,
                       (tile + stride) * kWgRows + my_rows, q, g, t);
      }
      if (b + kQ == 2 * KB)  // this CTA has read all of the tile's rows
        asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

      // re rows take columns H .. 3 H - 1 of B, im rows 0 .. 2 H - 1; the
      // kQ blocks lie in one plane, their k-steps one after the other
      const uint32_t* big = s_b + 2 * (b % KB) * G::kStep +
                            (b < KB ? (H / 8) * 64 : 0);
      const uint32_t* small = big + G::kPart;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < 2 * kQ; ++s) {
        wgmma_tf32(part, a_small[s], b_desc(big + s * G::kStep), s > 0);
        wgmma_tf32(part, a_big[s], b_desc(small + s * G::kStep), 1);
      }
#pragma unroll
      for (int s = 0; s < 2 * kQ; ++s)
        wgmma_tf32(part, a_big[s], b_desc(big + s * G::kStep), 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      pin(part);
      pin(a_big);
      pin(a_small);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    }

    // both CTAs of the cluster have read all of the tile's rows
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + 8 * h + g;
      if (r >= rows) continue;
      const int64_t off = r * (int64_t)D + rank * H + 2 * t;
#pragma unroll
      for (int i = 0; i < H / 8; ++i) {
        const int o = 4 * (i + H / 8) + 2 * h;  // the im half of acc
        *reinterpret_cast<float2*>(re + off + 8 * i) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        *reinterpret_cast<float2*>(im + off + 8 * i) =
            make_float2(acc[o], acc[o + 1]);
      }
    }
  }
}

// -- FFMA path, d <= 32 ------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

template <int D>
struct Tile {
  static constexpr int VW = D < 4 ? D : 4;          // floats per vector access
  static constexpr int TN = VW;                      // columns per thread
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

#pragma unroll
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
        const int off = (k0 + kk) * D + tx * T::VW;
        const V wr = *reinterpret_cast<const V*>(s_wr + off);
        const V wi = *reinterpret_cast<const V*>(s_wi + off);
#pragma unroll
        for (int m = 0; m < T::TM; ++m)
#pragma unroll
          for (int n = 0; n < T::TN; ++n) {
            acc_r[m][n] = fmaf(xr[m][kk], wr.v[n], acc_r[m][n]);
            acc_r[m][n] = fmaf(-xi[m][kk], wi.v[n], acc_r[m][n]);
            acc_i[m][n] = fmaf(xi[m][kk], wr.v[n], acc_i[m][n]);
            acc_i[m][n] = fmaf(xr[m][kk], wi.v[n], acc_i[m][n]);
          }
      }
    }

#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = ty * T::TM + m;
      if (r >= valid) continue;
      const int c = tx * T::VW;
      V a, b;
#pragma unroll
      for (int j = 0; j < T::VW; ++j) {
        a.v[j] = acc_r[m][j];
        b.v[j] = acc_i[m][j];
      }
      *reinterpret_cast<V*>(re + base + (int64_t)r * D + c) = a;
      *reinterpret_cast<V*>(im + base + (int64_t)r * D + c) = b;
    }
  }
}

// -- launch ----------------------------------------------------------------

template <int D>
cudaError_t launch_wgmma(float* re, float* im, const float* wt_re,
                         const float* wt_im, long long rows,
                         cudaStream_t stream) {
  constexpr size_t smem = Wg<D>::kSmemBytes;
  auto kernel = slab_mix_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2, 1, 1);
  config.blockDim = dim3(kWgThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  int clusters = 0;  // one wave: as many clusters as can be resident
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (rows + kWgRows - 1) / kWgRows;
  const long long grid = 2 * (tiles < clusters ? tiles : clusters);
  kernel<<<(unsigned)grid, kWgThreads, smem, stream>>>(re, im, wt_re, wt_im,
                                                       rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ffma(float* re, float* im, const float* wt_re,
                        const float* wt_im, long long rows, cudaStream_t s) {
  using T = Tile<D>;
  constexpr size_t smem = T::kSmemFloats * sizeof(float);
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
  slab_mix_kernel<D><<<(unsigned)grid, kThreads, smem, s>>>(
      re, im, wt_re, wt_im, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qct_slab_matmul(float* re, float* im, const float* wt_re,
                               const float* wt_im, long long rows, int d,
                               int* path, void* stream) {
  if (rows < 1 || !path) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *path = d >= 64 ? 1 : 0;
  switch (d) {
    case 2: return (int)launch_ffma<2>(re, im, wt_re, wt_im, rows, s);
    case 4: return (int)launch_ffma<4>(re, im, wt_re, wt_im, rows, s);
    case 8: return (int)launch_ffma<8>(re, im, wt_re, wt_im, rows, s);
    case 16: return (int)launch_ffma<16>(re, im, wt_re, wt_im, rows, s);
    case 32: return (int)launch_ffma<32>(re, im, wt_re, wt_im, rows, s);
    case 64: return (int)launch_wgmma<64>(re, im, wt_re, wt_im, rows, s);
    case 128: return (int)launch_wgmma<128>(re, im, wt_re, wt_im, rows, s);
    default: *path = -1; return (int)cudaErrorInvalidValue;
  }
}
