// Hermitian eigendecomposition of a batch of small complex128 matrices
// (side n <= 128) for Hopper (sm_90a): cyclic two-sided Jacobi in FP64, one
// thread-block cluster per matrix, the whole batch in one launch.
//
// Replaces no TPU kernel. It replaces a library call, `torch.linalg.eigh`
// on the Gram matrices of the port's randomized SVD (ops/linalg.py), which
// the JAX package also leaves to its backend. On CUDA that call loops over
// the batch with one cuSOLVER `syevd` per matrix (tridiagonalisation,
// back-transformation, a divide-and-conquer or QR step: some 1.4 ms of
// device time per 110 x 110 matrix) and then reads `info` back to the
// host, which is one synchronisation per call.
//
// What bounds it. The work is ~8 n^3 real FP64 operations a sweep (a
// rotation of each of n^2/2 pairs touches 2 columns of A, 2 of V and 2 rows
// of A), with 9 to 22 sweeps: 0.1-0.3 GFLOP a matrix, microseconds at the
// data sheet's FP64 rate. But a sweep is m - 1 dependent sub-rounds (m = n
// rounded up to the cluster's layout), so the kernel is bound by the latency
// of one sub-round, not by operations or bytes: ~10^3 sub-rounds a matrix.
//
// Design against that latency:
// - One cluster of C <= 8 blocks per matrix (C = ceil(n / 16)); B matrices
//   are B clusters, which run side by side: the latency of a call is that
//   of one matrix where the batch fits on the card at once. 512 threads a
//   block where it does at one block per SM, else 256 threads and two
//   blocks per SM (shared memory ~112 KB a block at n = 110).
// - A (padded to m = 2 C k) lives in shared memory, cut by columns: member c
//   holds 2 k columns (a top and a bottom block of k). V lives in shared
//   memory too, cut by rows: member c holds rows [2 k c, 2 k c + 2 k) of
//   every column, so V never moves.
// - A sub-round rotates m / 2 disjoint pairs, k in each member, always
//   pairs of the member's own columns. Within a block round the member's
//   own block A[own][own] changes only by the member's own rotations, so
//   its first 128 threads run all of the block round's rotations on a copy
//   of that 2k x 2k block first. The member then writes them (cosine,
//   complex sine) and its column list into every member's tables in
//   distributed shared memory, and one cluster barrier follows: one per
//   block round, not one per sub-round.
// - Then every thread applies the block round's rotations, sub-round by
//   sub-round with a block barrier between: a 2 x 2 block of A per (row
//   pair, own column pair) and a pair of V's own rows' entries per pair.
//   Each thread's items are fixed for the whole kernel, so the inner loops
//   do no integer division.
// - Between block rounds the blocks of A move in the circle method (block
//   0 stays, the others turn one place): each member pushes its two blocks
//   into the neighbours' staging buffers, one cluster barrier, then copies
//   its staging into A. 2 C - 1 block rounds make a sweep in which every
//   pair meets once.
// - A rotation's square roots and quotients go through rsqrt and the
//   hardware's reciprocal with two Newton steps (the chain of a rotation
//   is on the simulation's critical path).
// - Convergence is decided on the device at the start of each sweep: the
//   members' sums of |a_ij|^2 off and on the diagonal are exchanged through
//   distributed shared memory and added in the same order in every member,
//   so all stop together. A rotation whose |a_pq| is at most
//   tol ||A||_F / m is skipped (it cannot matter to the stop test).
// - The eigenpairs are sorted ascending on the device (rank by count, ties
//   by column) and written straight to the outputs.
// - The launch allocates nothing and never synchronises.
//
// The same algorithm, the same rotations in the same order, is
// `herm_eigh_small_plain` in ops/herm_eigh_small.py.
//
// C interface, bound with ctypes: qct_herm_eigh_small(G, w, V, info, B, n,
// C, k, max_sweeps, tol, stream). G: B x n x n complex128, row-major, only
// its lower triangle and the diagonal's real part read. w: B x n float64,
// ascending. V: B x n x n complex128, G = V diag(w) V^H. info: B int32, the
// sweeps a matrix took, or -max_sweeps if it had not converged by then or
// holds a non-finite entry. Returns cudaGetLastError() after the launch, 0
// on success.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxM = 128;
constexpr int kMaxC = 8;
constexpr int kMaxK = 8;
// work items of a sub-round's update, at most: A blocks and V pairs
constexpr int kMaxItems = kMaxM / 2 * kMaxK + 2 * kMaxK * kMaxM / 2;

// A rotation J = [[c, s], [-conj(s), c]] of the pair (p, q).
struct Rot {
  double c;
  double2 s;
  double a, b;  // the pair's new A[p][p], A[q][q]
  int skip;
};

struct Layout {
  int m, kk, half, nsub;
  size_t a_off, v_off, tc_off, ts_off, oa_off, ob_off, osk_off, ps_off,
      stage_off, sidx_off, iall_off, red_off, fin_off, wred_off, idx_off,
      rank_off, bytes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of one member. The exchange's staging also holds the
// copy of the own block during a block round's local run: members push
// into it only after every member has finished that run.
__host__ __device__ inline Layout layout(int C, int k) {
  Layout L;
  L.kk = 2 * k;
  L.m = C * L.kk;
  L.half = L.m / 2;
  L.nsub = L.kk - 1;  // sub-rounds of the longest block round
  size_t off = 0;
  L.a_off = off;  off = align16(off + sizeof(double2) * L.kk * L.m);
  L.v_off = off;  off = align16(off + sizeof(double2) * L.kk * L.m);
  L.tc_off = off; off = align16(off + sizeof(double) * L.nsub * L.half);
  L.ts_off = off; off = align16(off + sizeof(double2) * L.nsub * L.half);
  L.oa_off = off; off = align16(off + sizeof(double) * L.nsub * k);
  L.ob_off = off; off = align16(off + sizeof(double) * L.nsub * k);
  L.osk_off = off; off = align16(off + sizeof(int) * L.nsub * k);
  L.ps_off = off; off = align16(off + sizeof(int2) * L.nsub * k);
  L.stage_off = off; off = align16(off + sizeof(double2) * L.kk * L.m);
  L.sidx_off = off; off = align16(off + sizeof(int) * L.kk);
  L.iall_off = off; off = align16(off + sizeof(int) * C * L.kk);
  L.red_off = off; off = align16(off + sizeof(double) * 2 * C);
  L.fin_off = off; off = align16(off + sizeof(double) * L.m);
  L.wred_off = off; off = align16(off + sizeof(double) * 2 * (kMaxThreads / 32));
  L.idx_off = off; off = align16(off + sizeof(int) * L.kk);
  L.rank_off = off; off = align16(off + sizeof(int) * L.m);
  L.bytes = off;
  return L;
}

__device__ __forceinline__ void local_pair(bool first, int t, int i, int k,
                                           int& s1, int& s2) {
  if (first) {
    const int L = 2 * k - 1;
    if (i == 0) {
      s1 = t;
      s2 = L;
    } else {
      s1 = (t + i) % L;
      s2 = (t - i + L) % L;
    }
  } else {
    s1 = i;
    s2 = k + (i + t) % k;
  }
}

// c x - s y
__device__ __forceinline__ double2 rot_sub(double c, double2 s, double2 x,
                                           double2 y) {
  return make_double2(c * x.x - (s.x * y.x - s.y * y.y),
                      c * x.y - (s.x * y.y + s.y * y.x));
}
// conj(s) x + c y
__device__ __forceinline__ double2 rot_add_conj(double c, double2 s,
                                                double2 x, double2 y) {
  return make_double2((s.x * x.x + s.y * x.y) + c * y.x,
                      (s.x * x.y - s.y * x.x) + c * y.y);
}
// c x - conj(s) y
__device__ __forceinline__ double2 rot_sub_conj(double c, double2 s,
                                                double2 x, double2 y) {
  return make_double2(c * x.x - (s.x * y.x + s.y * y.y),
                      c * x.y - (s.x * y.y - s.y * y.x));
}
// s x + c y
__device__ __forceinline__ double2 rot_add(double c, double2 s, double2 x,
                                           double2 y) {
  return make_double2((s.x * x.x - s.y * x.y) + c * y.x,
                      (s.x * x.y + s.y * x.x) + c * y.y);
}

// 1/x to about an ulp: the hardware's approximation and two Newton steps.
__device__ __forceinline__ double fast_rcp(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x, y, 1.0);
  y = fma(y, e, y);
  e = fma(-x, y, 1.0);
  return fma(y, e, y);
}

// The rotation that zeroes g = A[p][q] of [[a, g], [conj g, b]]; skipped
// (the identity) where |g| <= tau. Square roots and quotients go through
// rsqrt and fast_rcp: the rotation's latency is the sub-round's.
__device__ __forceinline__ Rot make_rot(double a, double b, double2 g,
                                        double tau) {
  Rot r;
  const double h2 = g.x * g.x + g.y * g.y;
  double h, inv_h;
  if (h2 > 1e-300 && h2 < 1e300) {
    inv_h = rsqrt(h2);
    h = h2 * inv_h;
  } else {
    h = hypot(g.x, g.y);
    inv_h = 1.0 / h;
  }
  if (!(h > tau)) {
    r.c = 1.0;
    r.s = make_double2(0.0, 0.0);
    r.a = a;
    r.b = b;
    r.skip = 1;
    return r;
  }
  const double theta = 0.5 * (b - a) * inv_h;
  const double at = fabs(theta);
  double t;
  if (at > 1e150) {
    t = 0.5 * fast_rcp(theta);
  } else {
    const double x = fma(theta, theta, 1.0);
    const double root = x * rsqrt(x);  // sqrt(1 + theta^2)
    t = copysign(fast_rcp(at + root), theta >= 0.0 ? 1.0 : -1.0);
  }
  const double c = rsqrt(fma(t, t, 1.0));
  const double sh = t * c * inv_h;
  r.c = c;
  r.s = make_double2(sh * g.x, sh * g.y);
  r.a = a - t * h;
  r.b = b + t * h;
  r.skip = 0;
  return r;
}

// A barrier of the first kSimThreads threads, which run a block round's
// own rotations.
constexpr int kSimThreads = 128;
__device__ __forceinline__ void sim_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kSimThreads) : "memory");
}

// The 2 x 2 block of A at rows (r1, r2), columns (c1, c2): rows rotated by
// (cr, sr), then columns by (cc, sc).
__device__ __forceinline__ void block_update(double2& x11, double2& x21,
                                             double2& x12, double2& x22,
                                             double cr, double2 sr, double cc,
                                             double2 sc) {
  const double2 u1 = rot_sub(cr, sr, x11, x21);
  const double2 u2 = rot_add_conj(cr, sr, x11, x21);
  const double2 v1 = rot_sub(cr, sr, x12, x22);
  const double2 v2 = rot_add_conj(cr, sr, x12, x22);
  x11 = rot_sub_conj(cc, sc, u1, v1);
  x12 = rot_add(cc, sc, u1, v1);
  x21 = rot_sub_conj(cc, sc, u2, v2);
  x22 = rot_add(cc, sc, u2, v2);
}

// Key of the ascending sort: NaN after everything.
__device__ __forceinline__ double sort_key(double w) {
  return isnan(w) ? INFINITY : w;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
herm_eigh_kernel(const double2* __restrict__ G, double* __restrict__ w_out,
                 double2* __restrict__ V_out, int* __restrict__ info_out,
                 int n, int k, int max_sweeps, double tol) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int mat = blockIdx.x / C;
  const Layout L = layout(C, k);
  const int m = L.m, kk = L.kk, half = L.half;
  const int tid = threadIdx.x;

  double2* A = reinterpret_cast<double2*>(smem + L.a_off);     // [kk][m]
  double2* Vl = reinterpret_cast<double2*>(smem + L.v_off);    // [kk][m]
  double* Tc = reinterpret_cast<double*>(smem + L.tc_off);     // [nsub][half]
  double2* Ts = reinterpret_cast<double2*>(smem + L.ts_off);   // [nsub][half]
  double* Oa = reinterpret_cast<double*>(smem + L.oa_off);     // [nsub][k]
  double* Ob = reinterpret_cast<double*>(smem + L.ob_off);     // [nsub][k]
  int* Osk = reinterpret_cast<int*>(smem + L.osk_off);         // [nsub][k]
  int2* PS = reinterpret_cast<int2*>(smem + L.ps_off);         // [nsub][k]
  double2* stage = reinterpret_cast<double2*>(smem + L.stage_off);  // [kk][m]
  double2* Lb = stage;                                         // [kk][kk]
  int* sidx = reinterpret_cast<int*>(smem + L.sidx_off);       // [kk]
  int* iall = reinterpret_cast<int*>(smem + L.iall_off);       // [C][kk]
  double* red = reinterpret_cast<double*>(smem + L.red_off);   // [C][2]
  double* fin = reinterpret_cast<double*>(smem + L.fin_off);   // [m]
  double* wred = reinterpret_cast<double*>(smem + L.wred_off);
  int* idx = reinterpret_cast<int*>(smem + L.idx_off);         // [kk]
  int* ranks = reinterpret_cast<int*>(smem + L.rank_off);      // [m]

  // load: own columns of A from G's lower triangle; V's own rows of I
  const double2* Gm = G + (size_t)mat * n * n;
  if (tid < kk) idx[tid] = rank * kk + tid;
  for (int it = tid; it < kk * m; it += kThreads) {
    const int s = it / m, r = it % m;
    const int l = rank * kk + s;  // column of A; for V, row rank*kk + s
    double2 a = make_double2(0.0, 0.0);
    if (l < n && r < n) {
      if (r > l) {
        a = Gm[(size_t)r * n + l];
      } else if (r == l) {
        a = make_double2(Gm[(size_t)l * n + l].x, 0.0);
      } else {
        const double2 x = Gm[(size_t)l * n + r];
        a = make_double2(x.x, -x.y);
      }
    }
    A[s * m + r] = a;
    Vl[s * m + r] = make_double2(r == l ? 1.0 : 0.0, 0.0);
  }
  // this thread's update items, the same in every sub-round: an A block
  // (rows of pair e, own pair i >= 0) or a V pair (pair e, own row -1 - i);
  // pair e is member e / k's pair e % k
  constexpr int kItems = (kMaxItems + kThreads - 1) / kThreads;
  int item_e[kItems], item_i[kItems], item_o[kItems];
  const int nA = half * k;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int it = tid + j * kThreads;
    if (it < nA) {
      item_e[j] = it % half;
      item_i[j] = it / half;
    } else if (it < nA + kk * half) {
      item_e[j] = (it - nA) % half;
      item_i[j] = -1 - (it - nA) / half;
    } else {
      item_e[j] = -1;
      item_i[j] = 0;
    }
    item_o[j] = item_e[j] < 0 ? 0 : item_e[j] / k;  // pair e's member
  }
  // the simulation's block of the own 2k x 2k block (pair e of rows, pair
  // i of columns), one per thread of the first kSimThreads (k^2 <= 64)
  const int loc_e = tid < k * k ? tid % k : -1;
  const int loc_i = tid < k * k ? tid / k : 0;
  __syncthreads();

  int status = -max_sweeps;
  double tau = 0.0;
  for (int sweep = 0;; ++sweep) {
    // -- the stop test: off(A)^2 and ||A||_F^2 over the cluster ----------
    {
      double off = 0.0, diag = 0.0;
      for (int it = tid; it < kk * m; it += kThreads) {
        const int s = it / m, r = it % m;
        const double2 x = A[s * m + r];
        const double v = x.x * x.x + x.y * x.y;
        if (r == idx[s]) diag += v; else off += v;
      }
      for (int o = 16; o > 0; o >>= 1) {
        off += __shfl_down_sync(0xffffffffu, off, o);
        diag += __shfl_down_sync(0xffffffffu, diag, o);
      }
      if ((tid & 31) == 0) {
        wred[2 * (tid >> 5)] = off;
        wred[2 * (tid >> 5) + 1] = diag;
      }
      __syncthreads();
      if (tid == 0) {
        off = diag = 0.0;
        for (int w = 0; w < kThreads / 32; ++w) {
          off += wred[2 * w];
          diag += wred[2 * w + 1];
        }
        for (int d = 0; d < C; ++d) {
          double* dst = cluster.map_shared_rank(red, d);
          dst[2 * rank] = off;
          dst[2 * rank + 1] = off + diag;
        }
      }
      cluster.sync();
      double off_all = 0.0, tot_all = 0.0;
      for (int d = 0; d < C; ++d) {
        off_all += red[2 * d];
        tot_all += red[2 * d + 1];
      }
      if (sweep == 0) tau = tol * sqrt(tot_all) / m;
      if (off_all <= tol * tol * tot_all) {
        status = sweep;
        break;
      }
      // a non-finite matrix never converges: stop at once, unconverged
      if (sweep == max_sweeps || !(tot_all < INFINITY)) break;
    }

    // -- one sweep: 2 C - 1 block rounds ----------------------------------
    for (int br = 0; br < 2 * C - 1; ++br) {
      const bool first = br == 0;
      const int nsub = first ? kk - 1 : k;
      // The member's own block A[own][own] changes only by its own
      // rotations in a block round: the first kSimThreads threads run them
      // all on a copy of it.
      for (int it = tid; it < kk * kk; it += kThreads)
        Lb[it] = A[(it / kk) * m + idx[it % kk]];  // [column slot][row slot]
      for (int it = tid; it < nsub * k; it += kThreads) {
        int s1, s2;
        local_pair(first, it / k, it % k, k, s1, s2);
        PS[it] = make_int2(s1, s2);
      }
      __syncthreads();
      if (tid < kSimThreads) {
        for (int t = 0; t < nsub; ++t) {
          const int2* ps = PS + t * k;
          const int er = t * half + rank * k;
          if (tid < k) {
            const int2 sp = ps[tid];
            const Rot r = make_rot(Lb[sp.x * kk + sp.x].x, Lb[sp.y * kk + sp.y].x,
                                   Lb[sp.y * kk + sp.x], tau);
            Tc[er + tid] = r.c;
            Ts[er + tid] = r.s;
            Oa[t * k + tid] = r.a;
            Ob[t * k + tid] = r.b;
            Osk[t * k + tid] = r.skip;
          }
          sim_sync();
          const int e = loc_e, i = loc_i;
          if (e >= 0) {
            const int2 rs = ps[e], cs = ps[i];
            if (e == i) {
              if (!Osk[t * k + i]) {
                Lb[cs.x * kk + rs.x] = make_double2(Oa[t * k + i], 0.0);
                Lb[cs.y * kk + rs.y] = make_double2(Ob[t * k + i], 0.0);
                Lb[cs.x * kk + rs.y] = make_double2(0.0, 0.0);
                Lb[cs.y * kk + rs.x] = make_double2(0.0, 0.0);
              }
            } else {
              double2 x11 = Lb[cs.x * kk + rs.x], x21 = Lb[cs.x * kk + rs.y];
              double2 x12 = Lb[cs.y * kk + rs.x], x22 = Lb[cs.y * kk + rs.y];
              block_update(x11, x21, x12, x22, Tc[er + e], Ts[er + e],
                           Tc[er + i], Ts[er + i]);
              Lb[cs.x * kk + rs.x] = x11;
              Lb[cs.x * kk + rs.y] = x21;
              Lb[cs.y * kk + rs.x] = x12;
              Lb[cs.y * kk + rs.y] = x22;
            }
          }
          sim_sync();
        }
      }
      __syncthreads();
      // publish the block round's rotations and the member's columns in
      // every member's tables
      for (int it = tid; it < (nsub * k + kk) * C; it += kThreads) {
        const int d = it % C, j = it / C;
        if (j < nsub * k) {
          const int e = (j / k) * half + rank * k + j % k;
          cluster.map_shared_rank(Tc, d)[e] = Tc[e];
          cluster.map_shared_rank(Ts, d)[e] = Ts[e];
        } else {
          cluster.map_shared_rank(iall, d)[rank * kk + j - nsub * k] = idx[j - nsub * k];
        }
      }
      cluster.sync();
      // apply them: A's rows and own columns, V's own rows
      for (int t = 0; t < nsub; ++t) {
        const double* tc = Tc + t * half;
        const double2* ts = Ts + t * half;
        const int2* ps = PS + t * k;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int e = item_e[j], i = item_i[j];
          if (e < 0) continue;
          const int owner = item_o[j];
          const int2 se_slots = ps[e - owner * k];
          const int* io = iall + owner * kk;
          const int p = io[se_slots.x], q = io[se_slots.y];
          if (i >= 0) {  // A: rows of pair e, own columns of pair i
            const int2 sp = ps[i];
            double2* cp = A + sp.x * m;
            double2* cq = A + sp.y * m;
            if (e == rank * k + i) {  // the pair's own 2 x 2 block
              if (!Osk[t * k + i]) {
                cp[p] = make_double2(Oa[t * k + i], 0.0);
                cq[q] = make_double2(Ob[t * k + i], 0.0);
                cp[q] = make_double2(0.0, 0.0);
                cq[p] = make_double2(0.0, 0.0);
              }
              continue;
            }
            double2 x11 = cp[p], x21 = cp[q];
            double2 x12 = cq[p], x22 = cq[q];
            block_update(x11, x21, x12, x22, tc[e], ts[e],
                         tc[rank * k + i], ts[rank * k + i]);
            cp[p] = x11;
            cp[q] = x21;
            cq[p] = x12;
            cq[q] = x22;
          } else {  // V: own row -1 - i, columns of pair e
            const double c = tc[e];
            const double2 se = ts[e];
            double2* row = Vl + (-1 - i) * m;
            const double2 x = row[p], y = row[q];
            row[p] = rot_sub_conj(c, se, x, y);
            row[q] = rot_add(c, se, x, y);
          }
        }
        __syncthreads();
      }
      if (C > 1) {
        // circle method, pushed: block 0 of member 0 stays, the others
        // turn one place; into the destinations' staging, then copied
        const int top_dst = rank == 0 ? 0 : (rank <= C - 2 ? rank + 1 : rank);
        const int top_off = (rank >= 1 && rank == C - 1) ? k : 0;
        const int bot_dst = rank == 0 ? 1 : rank - 1;
        const int bot_off = rank == 0 ? 0 : k;
        double2* St = cluster.map_shared_rank(stage, top_dst);
        double2* Sb = cluster.map_shared_rank(stage, bot_dst);
        for (int it = tid; it < kk * m; it += kThreads) {
          const int s = it / m, r = it % m;
          if (s < k) St[(top_off + s) * m + r] = A[it];
          else Sb[(bot_off + s - k) * m + r] = A[it];
        }
        if (tid < kk) {
          if (tid < k) cluster.map_shared_rank(sidx, top_dst)[top_off + tid] = idx[tid];
          else cluster.map_shared_rank(sidx, bot_dst)[bot_off + tid - k] = idx[tid];
        }
        cluster.sync();
        for (int it = tid; it < kk * m; it += kThreads) A[it] = stage[it];
        if (tid < kk) idx[tid] = sidx[tid];
        __syncthreads();
      }
    }
  }

  // -- sort ascending, ties by column, and write out ---------------------
  {
    if (tid < kk * C) {  // every member learns every eigenvalue
      const int s = tid % kk, dst = tid / kk;
      cluster.map_shared_rank(fin, dst)[idx[s]] = A[s * m + idx[s]].x;
    }
    cluster.sync();
    for (int l = tid; l < n; l += kThreads) {
      const double key = sort_key(fin[l]);
      int pos = 0;
      for (int j = 0; j < n; ++j) {
        const double kj = sort_key(fin[j]);
        pos += (kj < key) || (kj == key && j < l);
      }
      ranks[l] = pos;
      if (rank == 0) w_out[(size_t)mat * n + pos] = fin[l];
    }
    __syncthreads();
    double2* Vm = V_out + (size_t)mat * n * n;
    for (int it = tid; it < kk * n; it += kThreads) {
      const int s = it / n, l = it % n;
      const int row = rank * kk + s;
      if (row < n) Vm[(size_t)row * n + ranks[l]] = Vl[s * m + l];
    }
    if (rank == 0 && tid == 0) info_out[mat] = status;
  }
  cluster.sync();  // no member leaves while another may read its memory
}

template <int kThreads>
int launch(const void* G, void* w, void* V, void* info, int B, int n, int C,
           int k, int max_sweeps, double tol, void* stream) {
  if (!G || !w || !V || !info || B < 1 || n < 1 || n > kMaxM || C < 1 ||
      C > kMaxC || k < 1 || k > kMaxK || 2 * C * k < n ||
      2 * C * k > kMaxM || max_sweeps < 0 || !(tol >= 0.0) ||
      (long long)B * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(C, k);
  cudaError_t err = cudaFuncSetAttribute(
      herm_eigh_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, herm_eigh_kernel<kThreads>,
                           static_cast<const double2*>(G),
                           static_cast<double*>(w), static_cast<double2*>(V),
                           static_cast<int*>(info), n, k, max_sweeps, tol);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int kThreads>
int max_clusters(int C, int k) {
  if (C < 1 || C > kMaxC || k < 1 || k > kMaxK) return 0;
  const Layout L = layout(C, k);
  if (cudaFuncSetAttribute(herm_eigh_kernel<kThreads>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.bytes) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, herm_eigh_kernel<kThreads>, &cfg) !=
      cudaSuccess)
    return 0;
  return clusters;
}

}  // namespace

extern "C" int qct_herm_eigh_small(const void* G, void* w, void* V,
                                   void* info, int B, int n, int C, int k,
                                   int max_sweeps, double tol,
                                   void* stream) {
  // 512 threads a block where the batch's clusters fit on the card at
  // once with one block per SM, else 256 (two blocks per SM): every
  // cluster of a call runs in one wave either way where it can. The
  // occupancy query is made once per geometry.
  static std::atomic<int> fits[kMaxC + 1][kMaxK + 1];  // clusters + 1, 0 unknown
  if (C < 1 || C > kMaxC || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  int at_once = fits[C][k].load(std::memory_order_relaxed) - 1;
  if (at_once < 0) {
    at_once = max_clusters<512>(C, k);
    fits[C][k].store(at_once + 1, std::memory_order_relaxed);
  }
  if (B <= at_once)
    return launch<512>(G, w, V, info, B, n, C, k, max_sweeps, tol, stream);
  return launch<256>(G, w, V, info, B, n, C, k, max_sweeps, tol, stream);
}

