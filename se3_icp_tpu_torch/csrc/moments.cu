// Neighbourhood sums of the sort-free setup, two kernels:
//
// K2 `moments_kernel`: for each query and each of its three shifted
//   thresholds thr_m - |q|^2 (m = centroid, covariance, arrow ball), the
//   sums over the targets inside the ball of [p (3) | the six distinct
//   products of p p^T | 1].  Replaces se3_icp_tpu/ops/pallas_moments.py
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
// because a TPU has no cheap per-element branch; padded rows are
// poisoned coordinates.  Here a ball holds ~1-2% of the targets, so a
// thread skips non-members and adds a member's terms in float32, and
// rows >= n_valid are not visited.  Membership uses the same explicitly
// rounded distance as K1 and the plain versions (dist.cuh), so the ball
// counts equal the plain version's exactly; only the order of the float
// sums differs.
//
// What bounds them on an H100: operations.  Per (query, valid target)
// both compute the shifted distance (7 operations) and compare it (K2
// three times); the members' terms add ~1-10% to that (K2: 16 adds and
// 6 products per member and ball; K3: ~20 operations per member).  The
// inputs are 16 bytes a point plus a few floats a query, read once.
// Design: one query per thread, 128 per block, grid (query tiles, B);
// targets staged through shared memory in tiles of 256 (components
// apart) and read by all threads at one address (a broadcast).  K2 keeps
// 30 float32 sums in registers (3 balls x 10), K3 four; ptxas (CUDA
// 12.8, sm_90a): K2 80 registers, K3 56, no spills.  Fusing K2 -> eigh -> K3
// into one pass over the targets is left for a later change.

#include <cuda_runtime.h>

#include "dist.cuh"

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 256;      // targets per shared-memory tile
constexpr int kSums = 10;       // x y z | xx xy xz yy yz zz | 1

__device__ __forceinline__ void load_tile(float* xs, float* ys, float* zs,
                                          float* ts, const float* px,
                                          const float* py, const float* pz,
                                          const float* tnb, int s0, int cnt) {
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    xs[i] = px[s0 + i];
    ys[i] = py[s0 + i];
    zs[i] = pz[s0 + i];
    ts[i] = tnb[s0 + i];
  }
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ pts_t,    // [B,3,N]
               const float* __restrict__ tn,       // [B,N] |p|^2
               const int* __restrict__ n_valid,    // [B]
               const float* __restrict__ thr_s,    // [B,3,N] thr - |q|^2
               float* __restrict__ out,            // [B,3*10,N]
               int n) {
  __shared__ float xs[kTile], ys[kTile], zs[kTile], ts[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < n;
  const float* px = pts_t + (size_t)b * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* tnb = tn + (size_t)b * n;
  const int nv = min(n_valid[b], n);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  float th0 = -1.f, th1 = -1.f, th2 = -1.f;
  if (active) {
    qx = px[qi];
    qy = py[qi];
    qz = pz[qi];
    const float* tb = thr_s + (size_t)b * 3 * n + qi;
    th0 = tb[0];
    th1 = tb[n];
    th2 = tb[2 * (size_t)n];
  }
  float acc[3][kSums];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[m][k] = 0.f;
  }

  for (int s0 = 0; s0 < nv; s0 += kTile) {
    const int cnt = min(kTile, nv - s0);
    __syncthreads();
    load_tile(xs, ys, zs, ts, px, py, pz, tnb, s0, cnt);
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int c = 0; c < cnt; ++c) {
      const float x = xs[c], y = ys[c], z = zs[c];
      const float r = se3icp::shifted_d2(qx, qy, qz, x, y, z, ts[c]);
      const bool in0 = r <= th0, in1 = r <= th1, in2 = r <= th2;
      if (in0 || in1 || in2) {
        const float f[kSums] = {x, y, z,
                                __fmul_rn(x, x), __fmul_rn(x, y), __fmul_rn(x, z),
                                __fmul_rn(y, y), __fmul_rn(y, z), __fmul_rn(z, z),
                                1.f};
        if (in0) {
#pragma unroll
          for (int k = 0; k < kSums; ++k) acc[0][k] = __fadd_rn(acc[0][k], f[k]);
        }
        if (in1) {
#pragma unroll
          for (int k = 0; k < kSums; ++k) acc[1][k] = __fadd_rn(acc[1][k], f[k]);
        }
        if (in2) {
#pragma unroll
          for (int k = 0; k < kSums; ++k) acc[2][k] = __fadd_rn(acc[2][k], f[k]);
        }
      }
    }
  }
  if (!active) return;
  float* ob = out + (size_t)b * 3 * kSums * n + qi;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) ob[(size_t)(m * kSums + k) * n] = acc[m][k];
  }
}

__global__ void __launch_bounds__(kThreads)
axis_kernel(const float* __restrict__ pts_t,     // [B,3,N]
            const float* __restrict__ tn,        // [B,N] |p|^2
            const int* __restrict__ n_valid,     // [B]
            const float* __restrict__ normal_t,  // [B,3,N] unit normals
            const float* __restrict__ aux,       // [B,3,N] thr-|q|^2, radius, n.q
            float* __restrict__ out,             // [B,4,N]
            int n) {
  __shared__ float xs[kTile], ys[kTile], zs[kTile], ts[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < n;
  const float* px = pts_t + (size_t)b * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* tnb = tn + (size_t)b * n;
  const int nv = min(n_valid[b], n);

  float qx = 0.f, qy = 0.f, qz = 0.f, qn = 0.f;
  float nx = 0.f, ny = 0.f, nz = 0.f;
  float thr = -1.f, rad = 0.f, ndq = 0.f;
  if (active) {
    qx = px[qi];
    qy = py[qi];
    qz = pz[qi];
    qn = tnb[qi];
    const float* nb = normal_t + (size_t)b * 3 * n + qi;
    nx = nb[0];
    ny = nb[n];
    nz = nb[2 * (size_t)n];
    const float* ab = aux + (size_t)b * 3 * n + qi;
    thr = ab[0];
    rad = ab[n];
    ndq = ab[2 * (size_t)n];
  }
  float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;

  for (int s0 = 0; s0 < nv; s0 += kTile) {
    const int cnt = min(kTile, nv - s0);
    __syncthreads();
    load_tile(xs, ys, zs, ts, px, py, pz, tnb, s0, cnt);
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int c = 0; c < cnt; ++c) {
      const float x = xs[c], y = ys[c], z = zs[c];
      const float r = se3icp::shifted_d2(qx, qy, qz, x, y, z, ts[c]);
      if (r <= thr) {
        const float d = __fsqrt_rn(fmaxf(__fadd_rn(r, qn), 0.f));
        const float w1 = __fsub_rn(rad, d);
        const float zd = __fsub_rn(se3icp::dot3_rn(nx, ny, nz, x, y, z), ndq);
        const float w = __fmul_rn(__fmul_rn(w1, w1), __fmul_rn(zd, zd));
        sx = fmaf(w, x, sx);
        sy = fmaf(w, y, sy);
        sz = fmaf(w, z, sz);
        sw = __fadd_rn(sw, w);
      }
    }
  }
  if (!active) return;
  float* ob = out + (size_t)b * 4 * n + qi;
  ob[0] = sx;
  ob[n] = sy;
  ob[2 * (size_t)n] = sz;
  ob[3 * (size_t)n] = sw;
}

}  // namespace

extern "C" int se3icp_moments(const void* pts_t, const void* tn,
                              const void* n_valid, const void* thr_s,
                              void* out, int bsz, int n, void* stream) {
  if (bsz <= 0 || n <= 0) return (int)cudaGetLastError();
  if (bsz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n + kThreads - 1) / kThreads, bsz);
  moments_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts_t, (const float*)tn, (const int*)n_valid,
      (const float*)thr_s, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int se3icp_axis(const void* pts_t, const void* tn,
                           const void* n_valid, const void* normal_t,
                           const void* aux, void* out, int bsz, int n,
                           void* stream) {
  if (bsz <= 0 || n <= 0) return (int)cudaGetLastError();
  if (bsz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n + kThreads - 1) / kThreads, bsz);
  axis_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pts_t, (const float*)tn, (const int*)n_valid,
      (const float*)normal_t, (const float*)aux, (float*)out, n);
  return (int)cudaGetLastError();
}
