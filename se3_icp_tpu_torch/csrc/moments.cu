// Neighbourhood sums of the sort-free setup, two kernels:
//
// K2 `moments_kernel`: for each query and each of its kBalls shifted
//   thresholds thr_m - |q|^2 (three: centroid, covariance and arrow ball;
//   one for `moments_one_ball`, whose three are one ball), the sums over the
//   targets inside the ball of [p (3) | the six distinct products of
//   p p^T | 1].  Replaces se3_icp_tpu/ops/pallas_moments.py
//   `_kernel_moments` (l.45; wrapper `moments_batched` l.308).  As there,
//   the query itself is inside every ball (its shifted distance is
//   exactly -|q|^2) and the wrapper subtracts its term afterwards.
// K3 `axis_kernel`: the TOLDI x-axis weights
//   W_ij = [d2_ij <= thr_i] (radius_i - d_ij)^2 (n_i . (p_j - q_i))^2,
//   reduced to sum_j W_ij p_j and sum_j W_ij.  Replaces
//   pallas_moments.py `_kernel_axis` (l.79; wrapper `axis_sums_batched`
//   l.658).
//
// The TPU kernels reduce a 0/1 mask (or the weights, limb-split into two
// bf16 halves) against limb-split feature blocks on the matrix unit,
// because a TPU has no cheap per-element branch.  Here a ball holds
// ~1-2% of the targets, so a member's terms are added in float32 and a
// non-member costs only its distance and a compare.  Membership uses the
// same explicitly rounded distance as K1 and the plain versions
// (dist.cuh), so the ball counts equal the plain version's exactly.
// Each query's sums run over its members in target-index order with
// fixed rounded operations (K2 __fadd_rn, K3 one fmaf chain), so a
// query's result has the same bits whatever the tiling, the block it
// lands in or the order in which the queries run.
//
// What bounds them on an H100: operations, none of them FMAs.  Per
// (query, valid target) the shifted distance takes 7 and the compare 1;
// members add ~5-10% (K2: six products a target, ten adds per member and
// ball; K3: ~20 operations per member).  The inputs are 16 bytes a point
// plus a few floats a query, read once.  Design:
//   * a spatial query order: the wrapper hands the kernels a permutation
//     of each cloud's rows (a Z-order sort of the valid rows, then the
//     padded ones, ``setup_cloud``), and a warp takes 32 kR consecutive
//     queries of it.  The member branch runs whenever any lane of the
//     warp has a member; in index order the queries of a warp lie all
//     over the cloud and half the (warp, target) steps take it, in
//     Z-order a tenth or less;
//   * kR queries a thread share each staged target, read from shared
//     memory as one 16-byte row (x, y, z, |t|^2) broadcast to the warp;
//   * one warp vote a target guards the member branch (K2 tests the
//     largest of a query's thresholds first); inside it K2 forms the six
//     products once for all kR queries and each query adds under its
//     own predicates;
//   * target tiles double-buffered in shared memory with cp.async, the
//     next tile loading while the current one is consumed.  Rows past
//     n_valid are staged as the origin with |t|^2 = NaN: their distance
//     is NaN, which no threshold admits (not even +inf), so the inner
//     loop has no bound check.
// Outputs are written at the query's own row of the [B, C, N] result
// (writing them at the sorted position and un-permuting with one gather
// was no faster).  Tiling, from tools/kernel_tiling_sweep.py on an H100:
// 64 threads a block and 2 queries a thread for both kernels (K2 120
// registers with three balls, 56 with one; K3 56; no spill).  One query a
// thread gives K2 the same time and K3 a slower one, four take K2 to 198
// registers; 256 threads a block starve 64 x 4608 of blocks.  What holds
// both at ~2.5x their bound: a target step is ~19 instructions for two
// queries (a 16-byte load, two 7-step distance chains, two compares, the
// vote and its branch), each chain a row of dependent operations, and the
// ~16 warps an SM that K2's registers allow hide their latency only in
// part; a tenth of the steps take the member branch (~70 instructions in
// K2).
//
// Row slices (`se3icp_moments_rows`, `se3icp_axis_rows`): the queries may
// be the rows [q0, q0 + nq) of the cloud, summed over the whole cloud;
// the order then lists the slice's rows (as offsets from q0: the entries
// of the cloud's Z-order that lie in the slice, in that order), and the
// per-query inputs and the outputs are [B, C, nq].  The points route of
// a registration sharded over a process group (parallel/points.py) gives
// each rank its own rows, the counterpart of the `queries=` path of the
// TPU kernels.  A query's sums depend on its own inputs and the cloud
// only, so a slice's rows are the whole call's rows, bit for bit.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "dist.cuh"

namespace {

constexpr int kMomThreads = 64;   // K2 threads a block
constexpr int kMomR = 2;          // K2 queries a thread
constexpr int kAxisThreads = 64;  // K3 threads a block
constexpr int kAxisR = 2;         // K3 queries a thread
constexpr int kTile = 128;        // targets a shared-memory tile
constexpr int kSums = 10;         // x y z | xx xy xz yy yz zz | 1

// Stage targets [t0, t0 + kTile) as rows (x, y, z, |t|^2); rows at or
// past nv: the origin with |t|^2 = NaN.
template <int kThreads>
__device__ __forceinline__ void stage(float4* t_s, const float* px,
                                      const float* py, const float* pz,
                                      const float* tnb, int t0, int nv) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int j = t0 + i;
    if (j < nv) {
      __pipeline_memcpy_async(&t_s[i].x, &px[j], sizeof(float));
      __pipeline_memcpy_async(&t_s[i].y, &py[j], sizeof(float));
      __pipeline_memcpy_async(&t_s[i].z, &pz[j], sizeof(float));
      __pipeline_memcpy_async(&t_s[i].w, &tnb[j], sizeof(float));
    } else {
      t_s[i] = float4{0.f, 0.f, 0.f, __int_as_float(0x7fc00000)};
    }
  }
  __pipeline_commit();
}

// visit(t) for every valid target t of the pair in index order (and the
// NaN rows that fill the last tile), the next tile loading while this
// one is visited.  Every thread of the block calls it.
template <int kThreads, class Visit>
__device__ __forceinline__ void each_target(float4 (&t_s)[2][kTile],
                                            const float* px, int n,
                                            const float* tnb, int nv,
                                            Visit&& visit) {
  const float* py = px + n;
  const float* pz = py + n;
  const int n_tiles = (nv + kTile - 1) / kTile;
  if (n_tiles > 0) stage<kThreads>(t_s[0], px, py, pz, tnb, 0, nv);
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    if (k + 1 < n_tiles) {
      stage<kThreads>(t_s[cur ^ 1], px, py, pz, tnb, (k + 1) * kTile, nv);
      __pipeline_wait_prior(1);     // this thread's copies of tile k landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                // ... and every thread's
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) visit(t_s[cur][c]);
    __syncthreads();                // consumed before it is restaged
  }
}

// Position of query r of this thread in the pair's query order: a warp
// takes 32 kR consecutive positions, lane-contiguous for each r.
template <int kThreads, int kR>
__device__ __forceinline__ int query_pos(int r) {
  return blockIdx.x * kThreads * kR + (threadIdx.x >> 5) * 32 * kR + r * 32 +
         (threadIdx.x & 31);
}

// The slice row (offset from q0) of the query at position p of pair b's
// order, or -1 past the slice's row count and for an entry that is no
// row of the slice: that query is skipped.
__device__ __forceinline__ int query_row(const int* order, int b, int nq,
                                         int p) {
  const int row = p < nq ? order[(size_t)b * nq + p] : -1;
  return (unsigned)row < (unsigned)nq ? row : -1;
}

template <int kBalls>
__global__ void __launch_bounds__(kMomThreads)
moments_kernel(const float* __restrict__ pts_t,    // [B,3,N]
               const float* __restrict__ tn,       // [B,N] |p|^2
               const int* __restrict__ n_valid,    // [B]
               const int* __restrict__ order,      // [B,nq] query order
               const float* __restrict__ thr_s,    // [B,kBalls,nq] thr - |q|^2
               float* __restrict__ out,            // [B,kBalls*10,nq]
               int n, int q0, int nq) {
  constexpr int kR = kMomR;
  __shared__ float4 t_s[2][kTile];
  const int b = blockIdx.y;
  const float* px = pts_t + (size_t)b * 3 * n;
  const float* tnb = tn + (size_t)b * n;
  const int nv = min(n_valid[b], n);

  int row[kR];
  float qx[kR], qy[kR], qz[kR], th[kR][kBalls], th_max[kR];
  float acc[kR][kBalls][kSums];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int p = query_pos<kMomThreads, kR>(r);
    row[r] = query_row(order, b, nq, p);
    const bool active = row[r] >= 0;
    const int i = active ? row[r] : 0;        // slice row
    const int g = q0 + i;                     // cloud row
    qx[r] = active ? px[g] : 0.f;
    qy[r] = active ? px[n + g] : 0.f;
    qz[r] = active ? px[2 * n + g] : 0.f;
    th_max[r] = __int_as_float(0x7fc00000);   // NaN: no member
#pragma unroll
    for (int m = 0; m < kBalls; ++m) {
      th[r][m] = active ? thr_s[((size_t)b * kBalls + m) * nq + i]
                        : __int_as_float(0x7fc00000);
      th_max[r] = fmaxf(th_max[r], th[r][m]);   // NaN only if all are
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[r][m][k] = 0.f;
    }
  }

  each_target<kMomThreads>(t_s, px, n, tnb, nv, [&](const float4 t) {
    float d[kR];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      d[r] = se3icp::shifted_d2(qx[r], qy[r], qz[r], t.x, t.y, t.z, t.w);
      any |= d[r] <= th_max[r];
    }
    if (__any_sync(0xffffffffu, any)) {
      const float f[kSums] = {t.x, t.y, t.z,
                              __fmul_rn(t.x, t.x), __fmul_rn(t.x, t.y),
                              __fmul_rn(t.x, t.z), __fmul_rn(t.y, t.y),
                              __fmul_rn(t.y, t.z), __fmul_rn(t.z, t.z),
                              1.f};
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int m = 0; m < kBalls; ++m) {
          const bool in = d[r] <= th[r][m];
#pragma unroll
          for (int k = 0; k < kSums; ++k) {
            acc[r][m][k] = in ? __fadd_rn(acc[r][m][k], f[k]) : acc[r][m][k];
          }
        }
      }
    }
  });

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (row[r] < 0) continue;
    float* ob = out + (size_t)b * kBalls * kSums * nq + row[r];
#pragma unroll
    for (int m = 0; m < kBalls; ++m) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        ob[(size_t)(m * kSums + k) * nq] = acc[r][m][k];
      }
    }
  }
}

__global__ void __launch_bounds__(kAxisThreads)
axis_kernel(const float* __restrict__ pts_t,     // [B,3,N]
            const float* __restrict__ tn,        // [B,N] |p|^2
            const int* __restrict__ n_valid,     // [B]
            const int* __restrict__ order,       // [B,nq] query order
            const float* __restrict__ normal_t,  // [B,3,nq] unit normals
            const float* __restrict__ aux,       // [B,3,nq] thr-|q|^2, radius, n.q
            float* __restrict__ out,             // [B,4,nq]
            int n, int q0, int nq) {
  constexpr int kR = kAxisR;
  __shared__ float4 t_s[2][kTile];
  const int b = blockIdx.y;
  const float* px = pts_t + (size_t)b * 3 * n;
  const float* tnb = tn + (size_t)b * n;
  const int nv = min(n_valid[b], n);

  int row[kR];
  float qx[kR], qy[kR], qz[kR], qn[kR], nx[kR], ny[kR], nz[kR];
  float thr[kR], rad[kR], ndq[kR];
  float sx[kR], sy[kR], sz[kR], sw[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int p = query_pos<kAxisThreads, kR>(r);
    row[r] = query_row(order, b, nq, p);
    const bool active = row[r] >= 0;
    const int i = active ? row[r] : 0;        // slice row
    const int g = q0 + i;                     // cloud row
    const float* nb = normal_t + (size_t)b * 3 * nq + i;
    const float* ab = aux + (size_t)b * 3 * nq + i;
    qx[r] = active ? px[g] : 0.f;
    qy[r] = active ? px[n + g] : 0.f;
    qz[r] = active ? px[2 * n + g] : 0.f;
    qn[r] = active ? tnb[g] : 0.f;
    nx[r] = active ? nb[0] : 0.f;
    ny[r] = active ? nb[nq] : 0.f;
    nz[r] = active ? nb[2 * (size_t)nq] : 0.f;
    thr[r] = active ? ab[0] : __int_as_float(0x7fc00000);   // NaN: no member
    rad[r] = active ? ab[nq] : 0.f;
    ndq[r] = active ? ab[2 * (size_t)nq] : 0.f;
    sx[r] = sy[r] = sz[r] = sw[r] = 0.f;
  }

  each_target<kAxisThreads>(t_s, px, n, tnb, nv, [&](const float4 t) {
    float d[kR];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      d[r] = se3icp::shifted_d2(qx[r], qy[r], qz[r], t.x, t.y, t.z, t.w);
      any |= d[r] <= thr[r];
    }
    if (__any_sync(0xffffffffu, any)) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (d[r] <= thr[r]) {
          const float dist = __fsqrt_rn(fmaxf(__fadd_rn(d[r], qn[r]), 0.f));
          const float w1 = __fsub_rn(rad[r], dist);
          const float zd = __fsub_rn(
              se3icp::dot3_rn(nx[r], ny[r], nz[r], t.x, t.y, t.z), ndq[r]);
          const float w = __fmul_rn(__fmul_rn(w1, w1), __fmul_rn(zd, zd));
          sx[r] = fmaf(w, t.x, sx[r]);
          sy[r] = fmaf(w, t.y, sy[r]);
          sz[r] = fmaf(w, t.z, sz[r]);
          sw[r] = __fadd_rn(sw[r], w);
        }
      }
    }
  });

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (row[r] < 0) continue;
    float* ob = out + (size_t)b * 4 * nq + row[r];
    ob[0] = sx[r];
    ob[nq] = sy[r];
    ob[2 * (size_t)nq] = sz[r];
    ob[3 * (size_t)nq] = sw[r];
  }
}

}  // namespace

// balls: 3 (three thresholds a query) or 1 (one).  The queries are the
// rows [q0, q0 + nq) of each cloud; order, thr_s and out have nq columns.
extern "C" int se3icp_moments_rows(const void* pts_t, const void* tn,
                                   const void* n_valid, const void* order,
                                   const void* thr_s, void* out, int bsz,
                                   int n, int q0, int nq, int balls,
                                   void* stream) {
  if (bsz <= 0 || n <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535) return (int)cudaErrorInvalidConfiguration;
  if ((balls != 1 && balls != 3) || q0 < 0 || nq > n - q0) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kBlockQueries = kMomThreads * kMomR;
  const dim3 grid((nq + kBlockQueries - 1) / kBlockQueries, bsz);
  if (balls == 3) {
    moments_kernel<3><<<grid, kMomThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pts_t, (const float*)tn, (const int*)n_valid,
        (const int*)order, (const float*)thr_s, (float*)out, n, q0, nq);
  } else {
    moments_kernel<1><<<grid, kMomThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pts_t, (const float*)tn, (const int*)n_valid,
        (const int*)order, (const float*)thr_s, (float*)out, n, q0, nq);
  }
  return (int)cudaGetLastError();
}

// Every row of each cloud.
extern "C" int se3icp_moments(const void* pts_t, const void* tn,
                              const void* n_valid, const void* order,
                              const void* thr_s, void* out, int bsz, int n,
                              int balls, void* stream) {
  return se3icp_moments_rows(pts_t, tn, n_valid, order, thr_s, out, bsz, n,
                             0, n, balls, stream);
}

// The queries are the rows [q0, q0 + nq) of each cloud; order, normal_t,
// aux and out have nq columns.
extern "C" int se3icp_axis_rows(const void* pts_t, const void* tn,
                                const void* n_valid, const void* order,
                                const void* normal_t, const void* aux,
                                void* out, int bsz, int n, int q0, int nq,
                                void* stream) {
  if (bsz <= 0 || n <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535) return (int)cudaErrorInvalidConfiguration;
  if (q0 < 0 || nq > n - q0) return (int)cudaErrorInvalidValue;
  constexpr int kBlockQueries = kAxisThreads * kAxisR;
  const dim3 grid((nq + kBlockQueries - 1) / kBlockQueries, bsz);
  axis_kernel<<<grid, kAxisThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts_t, (const float*)tn, (const int*)n_valid,
      (const int*)order, (const float*)normal_t, (const float*)aux,
      (float*)out, n, q0, nq);
  return (int)cudaGetLastError();
}

// Every row of each cloud.
extern "C" int se3icp_axis(const void* pts_t, const void* tn,
                           const void* n_valid, const void* order,
                           const void* normal_t, const void* aux, void* out,
                           int bsz, int n, void* stream) {
  return se3icp_axis_rows(pts_t, tn, n_valid, order, normal_t, aux, out, bsz,
                          n, 0, n, stream);
}
