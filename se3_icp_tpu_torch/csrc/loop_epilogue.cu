// Fused epilogue of one registration iteration, everything after the
// correspondence match: moving source rebuilt from (R, t), the trim /
// MSE distance of the pair's phase, the optional exact-count trim, the
// convergence MSE, and the estimator's reduction -- JtJ / Jtr for
// point-to-plane and generalized ICP (with the per-point whitening
// (R C_s R^T + C_t)^(-1/2) and the optional confidence), or the
// Umeyama moments for point-to-point.  Only the 6x6 solve / 3x3 SVD
// stays outside.
//
// Replaces the TPU kernel se3_icp_tpu/ops/pallas_loop.py
// `_kernel_epilogue` (wrapper `loop_epilogue_batched`).  Dropped with
// it: the slab of pairs per grid step and its on-chip memory cap, the
// [BP,6,3N] matrix-unit contraction form of the reductions, and the
// polynomial acos/cos (CUDA has acosf and cosf).
//
// What bounds it on an H100: bytes, nominally -- it reads
// B*N*(3+P[+6][+1])*4 bytes once (14 MB at 64 x 4608, P = 9: about
// 4 us at 3.35 TB/s) and writes a few hundred bytes per pair.  In
// practice it is latency: one block per pair walks its N points with
// 512 threads, and a trimmed call adds 26 + isteps block-wide counting
// rounds.  Design choices that matter for the results rather than the
// speed:
//   * the trim counts are block-wide INTEGER sums, so the brackets equal
//     those of the plain bisection and the kept set is the same set
//     (lowest indices inside the boundary band);
//   * the distance chain uses explicitly rounded multiplies and adds
//     (no FMA contraction), so it yields the same bits as the plain
//     elementwise version and the two trim on identical keys;
//   * all float sums go through a fixed-order shuffle + shared-memory
//     tree, never atomics: two runs give the same bits, which the stop
//     rule |mse - mse_prev| < thr and the iteration counts rely on;
//   * rows that are not kept are skipped, not multiplied by zero, so a
//     non-finite padded row cannot poison a sum.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;          // 21 (JtJ upper) + 6 (Jtr) + 1 (mse)
constexpr int kVSteps = 26;       // value-bisection halvings
constexpr float kBig = 3.4e38f;

// pf row layout (per-pair iteration scalars)
constexpr int PF_T = 0, PF_BETA = 3, PF_SWITCHED = 4, PF_NSRC = 5,
              PF_COUNT = 6, PF_R = 8, PF_WIDTH = 24;

enum Variant { kPt2Pt = 0, kPt2Pl = 1, kGicp = 2 };

struct Params {
  const float* srcT;     // [B,3,N]
  const float* matchedT; // [B,P,N]
  const float* pf;       // [B,24]
  const float* cov6;     // [B,6,N] or null
  const float* conf;     // [B,N] or null
  float* A;              // [B,6,6]
  float* bvec;           // [B,8]
  float* st;             // [B,8]
  int n, p, is_se3, use_cf, do_trim;
  int off_tr, off_nrm, off_cov, off_conf, isteps;
};

// ---- block-wide reductions (every thread gets the result) ------------

__device__ int block_sum_int(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) tot += red[wi];
  __syncthreads();
  return tot;
}

__device__ float block_max_float(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float tot = red[0];
#pragma unroll
  for (int wi = 1; wi < kWarps; ++wi) tot = fmaxf(tot, red[wi]);
  __syncthreads();
  return tot;
}

// Sums acc[0..K) over the block in a fixed order; result in res[0..K),
// visible to all threads on return.
template <int K>
__device__ void block_sum_floats(float (&acc)[K], float (*red)[kAcc],
                                 float* res) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float tot = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) tot += red[wi][threadIdx.x];
    res[threadIdx.x] = tot;
  }
  __syncthreads();
}

// ---- explicitly rounded arithmetic of the distance chain -------------

__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y,
                                         float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

struct Point {
  float s0, s1, s2;      // moving source R x + t
  float g0, g1, g2;      // matched target point
  float dB0, dB1, dB2;   // s - g
  float d_b;             // euclidean moving-vs-target distance
  float dist;            // trim / MSE metric of the pair's phase
};

struct Pose {
  float t0, t1, t2, beta;
  float R[3][3];
  bool switched;
};

__device__ __forceinline__ Point load_point(const Params& P, const Pose& ps,
                                            const float* src_b,
                                            const float* mt_b, int i) {
  const int n = P.n;
  const float x = src_b[i], y = src_b[n + i], z = src_b[2 * n + i];
  const float rx = dot3_rn(ps.R[0][0], x, ps.R[0][1], y, ps.R[0][2], z);
  const float ry = dot3_rn(ps.R[1][0], x, ps.R[1][1], y, ps.R[1][2], z);
  const float rz = dot3_rn(ps.R[2][0], x, ps.R[2][1], y, ps.R[2][2], z);
  Point pt;
  pt.s0 = __fadd_rn(rx, ps.t0);
  pt.s1 = __fadd_rn(ry, ps.t1);
  pt.s2 = __fadd_rn(rz, ps.t2);
  pt.g0 = mt_b[i]; pt.g1 = mt_b[n + i]; pt.g2 = mt_b[2 * n + i];
  pt.dB0 = __fsub_rn(pt.s0, pt.g0);
  pt.dB1 = __fsub_rn(pt.s1, pt.g1);
  pt.dB2 = __fsub_rn(pt.s2, pt.g2);
  pt.d_b = __fsqrt_rn(dot3_rn(pt.dB0, pt.dB0, pt.dB1, pt.dB1, pt.dB2, pt.dB2));
  pt.dist = pt.d_b;
  if (P.is_se3 && !ps.switched) {
    // phase A: beta-weighted frame translations against the matched
    // 12-D row's translation block
    const float* tr = mt_b + (size_t)P.off_tr * n;
    const float a0 = __fsub_rn(__fadd_rn(__fmul_rn(ps.beta, rx), ps.t0), tr[i]);
    const float a1 =
        __fsub_rn(__fadd_rn(__fmul_rn(ps.beta, ry), ps.t1), tr[n + i]);
    const float a2 =
        __fsub_rn(__fadd_rn(__fmul_rn(ps.beta, rz), ps.t2), tr[2 * n + i]);
    pt.dist = __fsqrt_rn(dot3_rn(a0, a0, a1, a1, a2, a2));
  }
  return pt;
}

// ---- closed-form symmetric 3x3 eigendecomposition (ops/eigh3.py) ------

struct V3 { float x, y, z; };
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// a = (a00, a01, a02, a11, a12, a22) -> ascending eigenvalues val[3] and
// unit eigenvectors vec[3]
__device__ void eigh3(const float (&a)[6], float (&val)[3], V3 (&vec)[3]) {
  const float eps = 1e-7f, peps = 1e-7f;
  float scale = fmaxf(fmaxf(fmaxf(fabsf(a[0]), fabsf(a[1])),
                            fmaxf(fabsf(a[2]), fabsf(a[3]))),
                      fmaxf(fmaxf(fabsf(a[4]), fabsf(a[5])), 1e-30f));
  const float s00 = a[0] / scale, s01 = a[1] / scale, s02 = a[2] / scale;
  const float s11 = a[3] / scale, s12 = a[4] / scale, s22 = a[5] / scale;

  const float q = (s00 + s11 + s22) / 3.0f;
  const float b00 = s00 - q, b11 = s11 - q, b22 = s22 - q;
  const float p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
                    2.0f * (s01 * s01 + s02 * s02 + s12 * s12)) / 6.0f;
  const float p = sqrtf(fmaxf(p2, 0.0f));
  const bool small = p < peps;
  const float pinv = 1.0f / (small ? 1.0f : p);
  const float d00 = b00 * pinv, d11 = b11 * pinv, d22 = b22 * pinv;
  const float d01 = s01 * pinv, d02 = s02 * pinv, d12 = s12 * pinv;
  const float det = d00 * (d11 * d22 - d12 * d12) -
                    d01 * (d01 * d22 - d12 * d02) +
                    d02 * (d01 * d12 - d11 * d02);
  const float r = fminf(fmaxf(det * 0.5f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float cos0 = cosf(phi);
  const float cos_plus = cosf(phi + 2.0f * CUDART_PI_F / 3.0f);
  const float two_p = small ? 0.0f : 2.0f * p;
  const float e2 = q + two_p * cos0;
  const float e0 = q + two_p * cos_plus;
  const float e1 = 3.0f * q - e0 - e2;

  const bool first_is_low = (e1 - e0) >= (e2 - e1);
  const float lam = first_is_low ? e0 : e2;
  const V3 r0 = {s00 - lam, s01, s02};
  const V3 r1 = {s01, s11 - lam, s12};
  const V3 r2 = {s02, s12, s22 - lam};
  const V3 c01 = cross(r0, r1), c02 = cross(r0, r2), c12 = cross(r1, r2);
  const float n01 = dot(c01, c01), n02 = dot(c02, c02), n12 = dot(c12, c12);
  const V3 v12 = sel(n02 >= n12, c02, c12);
  const float nb12 = fmaxf(n02, n12);
  V3 v = sel(n01 >= nb12, c01, v12);
  const float nbest = fmaxf(n01, nb12);
  v = sel(nbest > eps * eps, v, V3{1.0f, 0.0f, 0.0f});
  const float winv = 1.0f / fmaxf(sqrtf(dot(v, v)), eps);
  const V3 w = {v.x * winv, v.y * winv, v.z * winv};

  const bool use_x = fabsf(w.x) > fabsf(w.z);
  const float inv1 = 1.0f / fmaxf(sqrtf(w.x * w.x + w.y * w.y), eps);
  const float inv2 = 1.0f / fmaxf(sqrtf(w.y * w.y + w.z * w.z), eps);
  const V3 U = sel(use_x, V3{-w.y * inv1, w.x * inv1, 0.0f},
                   V3{0.0f, -w.z * inv2, w.y * inv2});
  const V3 V = cross(w, U);
  const V3 AU = {s00 * U.x + s01 * U.y + s02 * U.z,
                 s01 * U.x + s11 * U.y + s12 * U.z,
                 s02 * U.x + s12 * U.y + s22 * U.z};
  const V3 AV = {s00 * V.x + s01 * V.y + s02 * V.z,
                 s01 * V.x + s11 * V.y + s12 * V.z,
                 s02 * V.x + s12 * V.y + s22 * V.z};
  const float aa = dot(U, AU), bb = dot(U, AV), cc = dot(V, AV);
  const float lam_other = first_is_low ? e2 : e0;
  const float d1x = bb, d1y = lam_other - aa;
  const float d2x = lam_other - cc, d2y = bb;
  const bool pick1 = (d1x * d1x + d1y * d1y) >= (d2x * d2x + d2y * d2y);
  float dx = pick1 ? d1x : d2x;
  float dy = pick1 ? d1y : d2y;
  const float nd = sqrtf(dx * dx + dy * dy);
  const float dinv = 1.0f / fmaxf(nd, eps);
  const bool good = nd > eps;
  dx = good ? dx * dinv : 1.0f;
  dy = good ? dy * dinv : 0.0f;
  const V3 v_other = {dx * U.x + dy * V.x, dx * U.y + dy * V.y,
                      dx * U.z + dy * V.z};
  const V3 v_mid = cross(w, v_other);
  vec[0] = sel(first_is_low, w, v_other);
  vec[1] = v_mid;
  vec[2] = sel(first_is_low, v_other, w);
  val[0] = e0 * scale; val[1] = e1 * scale; val[2] = e2 * scale;
}

// components (w00, w01, w02, w11, w12, w22) of M^(-1/2)
__device__ void inv_sqrt_sym3(const float (&m)[6], float (&out)[6]) {
  float val[3];
  V3 vec[3];
  eigh3(m, val, vec);
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = 1.0f / sqrtf(fmaxf(val[k], 1e-12f));
    const V3 v = vec[k];
    out[0] += s * v.x * v.x; out[1] += s * v.x * v.y; out[2] += s * v.x * v.z;
    out[3] += s * v.y * v.y; out[4] += s * v.y * v.z; out[5] += s * v.z * v.z;
  }
}

// acc[0..21) += upper triangle of j j^T (row-major), acc[21..27) += j r
__device__ __forceinline__ void add_normal(float (&acc)[kAcc],
                                           const float (&j)[6], float r) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) acc[k++] += j[a] * j[c];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * r;
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const Params P) {
  extern __shared__ float dkey[];             // [N] trim keys (do_trim)
  __shared__ float red_f[kWarps][kAcc];
  __shared__ float res[kAcc];
  __shared__ int red_i[kWarps];

  const int b = blockIdx.x;
  const int n = P.n;
  const int tid = threadIdx.x;
  const float* pf = P.pf + (size_t)b * PF_WIDTH;
  Pose ps;
  ps.t0 = pf[PF_T]; ps.t1 = pf[PF_T + 1]; ps.t2 = pf[PF_T + 2];
  ps.beta = pf[PF_BETA];
  ps.switched = pf[PF_SWITCHED] > 0.5f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) ps.R[i][j] = pf[PF_R + 3 * i + j];
  const int n_src = (int)pf[PF_NSRC];    // exact integer-valued floats
  const int count = (int)pf[PF_COUNT];

  const float* src_b = P.srcT + (size_t)b * 3 * n;
  const float* mt_b = P.matchedT + (size_t)b * P.p * n;

  // ---- exact-count trim: value bisection + index bisection ----------
  float lo = -1.0f, hi = 0.0f, hii = 0.0f;
  if (P.do_trim) {
    float tmax = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      const Point pt = load_point(P, ps, src_b, mt_b, i);
      const bool valid = i < n_src;
      dkey[i] = valid ? pt.dist : kBig;
      if (valid) tmax = fmaxf(tmax, pt.dist);
    }
    hi = block_max_float(tmax, red_f[0]);   // also orders the dkey writes
    for (int step = 0; step < kVSteps; ++step) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
      for (int i = tid; i < n; i += kThreads) c += dkey[i] <= mid;
      if (block_sum_int(c, red_i) >= count) hi = mid; else lo = mid;
    }
    int c = 0;
    for (int i = tid; i < n; i += kThreads) c += dkey[i] <= lo;
    const int target = count - block_sum_int(c, red_i);
    float li = -1.0f;
    hii = (float)(n - 1);
    for (int step = 0; step < P.isteps; ++step) {
      const float mid = floorf(0.5f * (li + hii));
      int cb = 0;
      for (int i = tid; i < n; i += kThreads) {
        const float d = dkey[i];
        cb += (d > lo) && (d <= hi) && ((float)i <= mid);
      }
      if (block_sum_int(cb, red_i) >= target) hii = mid; else li = mid;
    }
  }
  auto kept_at = [&](int i) -> bool {
    if (!P.do_trim) return i < n_src;
    const float d = dkey[i];
    return (d <= lo) || ((d > lo) && (d <= hi) && ((float)i <= hii));
  };

  // ---- kept count, MSE and the estimator's sums ----------------------
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  int wcount = 0;

  if constexpr (VARIANT == kPt2Pt) {
    // pass 1: weighted means (acc 0..5) + mse numerator (acc 27)
    for (int i = tid; i < n; i += kThreads) {
      if (!kept_at(i)) continue;
      const Point pt = load_point(P, ps, src_b, mt_b, i);
      ++wcount;
      acc[0] += pt.s0; acc[1] += pt.s1; acc[2] += pt.s2;
      acc[3] += pt.g0; acc[4] += pt.g1; acc[5] += pt.g2;
      acc[27] += P.use_cf ? pt.d_b : pt.dist;
    }
    const int wsum_i = block_sum_int(wcount, red_i);
    block_sum_floats(acc, red_f, res);
    const float wsum = (float)wsum_i;
    const float wsafe = fmaxf(wsum, 1e-30f);
    float mu[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) mu[k] = res[k] / wsafe;
    const float mse = res[27] / fmaxf(wsum, 1.0f);
    __syncthreads();                      // res is reused below
    // pass 2: H = sum w (g - mu_t)(s - mu_s)^T
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      if (!kept_at(i)) continue;
      const Point pt = load_point(P, ps, src_b, mt_b, i);
      const float ds[3] = {pt.s0 - mu[0], pt.s1 - mu[1], pt.s2 - mu[2]};
      const float dt[3] = {pt.g0 - mu[3], pt.g1 - mu[4], pt.g2 - mu[5]};
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[3 * r + c] += dt[r] * ds[c];
    }
    block_sum_floats(acc, red_f, res);
    float* A = P.A + (size_t)b * 36;
    if (tid < 36) {
      const int r = tid / 6, c = tid % 6;
      A[tid] = (r < 3 && c < 3) ? res[3 * r + c] : 0.0f;
    }
    if (tid < 8) {
      P.bvec[(size_t)b * 8 + tid] = tid < 6 ? mu[tid] : 0.0f;
      P.st[(size_t)b * 8 + tid] = tid == 0 ? mse : (tid == 1 ? wsum : 0.0f);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      if (!kept_at(i)) continue;
      const Point pt = load_point(P, ps, src_b, mt_b, i);
      ++wcount;
      acc[27] += P.use_cf ? pt.d_b : pt.dist;
      if (VARIANT == kPt2Pl) {
        const float* nr = mt_b + (size_t)P.off_nrm * n;
        const float n0 = nr[i], n1 = nr[n + i], n2 = nr[2 * n + i];
        const float r = pt.dB0 * n0 + pt.dB1 * n1 + pt.dB2 * n2;
        const float j[6] = {pt.s1 * n2 - pt.s2 * n1, pt.s2 * n0 - pt.s0 * n2,
                            pt.s0 * n1 - pt.s1 * n0, n0, n1, n2};
        add_normal(acc, j, r);
      } else {
        // M = C_t(matched) + R C_s R^T on symmetric components
        const float* cs = P.cov6 + (size_t)b * 6 * n;
        const float* ct = mt_b + (size_t)P.off_cov * n;
        float c6[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) c6[k] = cs[(size_t)k * n + i];
        const int cidx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
        const int pr[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
        float m6[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          float a = ct[(size_t)m * n + i];
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int l = 0; l < 3; ++l)
              a += (ps.R[pr[m][0]][k] * ps.R[pr[m][1]][l]) * c6[cidx[k][l]];
          m6[m] = a;
        }
        float W6[6];
        inv_sqrt_sym3(m6, W6);
        if (P.use_cf) {
          const float cw = 0.5f * (P.conf[(size_t)b * n + i] +
                                   mt_b[(size_t)P.off_conf * n + i]);
#pragma unroll
          for (int k = 0; k < 6; ++k) W6[k] *= cw;
        }
        const float Wm[3][3] = {{W6[0], W6[1], W6[2]},
                                {W6[1], W6[3], W6[4]},
                                {W6[2], W6[4], W6[5]}};
        // columns of -skew(s)
        const float cols[3][3] = {{0.0f, -pt.s2, pt.s1},
                                  {pt.s2, 0.0f, -pt.s0},
                                  {-pt.s1, pt.s0, 0.0f}};
#pragma unroll
        for (int r3 = 0; r3 < 3; ++r3) {
          float j[6];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            j[a] = Wm[r3][0] * cols[a][0] + Wm[r3][1] * cols[a][1] +
                   Wm[r3][2] * cols[a][2];
          j[3] = Wm[r3][0]; j[4] = Wm[r3][1]; j[5] = Wm[r3][2];
          const float r = Wm[r3][0] * pt.dB0 + Wm[r3][1] * pt.dB1 +
                          Wm[r3][2] * pt.dB2;
          add_normal(acc, j, r);
        }
      }
    }
    const int wsum_i = block_sum_int(wcount, red_i);
    block_sum_floats(acc, red_f, res);
    const float wsum = (float)wsum_i;
    float* A = P.A + (size_t)b * 36;
    if (tid < 36) {
      int r = tid / 6, c = tid % 6;
      if (r > c) { const int t = r; r = c; c = t; }
      // index of (r, c), r <= c, in the row-major upper triangle
      A[tid] = res[r * 6 - (r * (r - 1)) / 2 + (c - r)];
    }
    if (tid < 8) {
      P.bvec[(size_t)b * 8 + tid] = tid < 6 ? res[21 + tid] : 0.0f;
      P.st[(size_t)b * 8 + tid] =
          tid == 0 ? res[27] / fmaxf(wsum, 1.0f) : (tid == 1 ? wsum : 0.0f);
    }
  }
}

}  // namespace

extern "C" int se3icp_loop_epilogue(
    const void* srcT, const void* matchedT, const void* pf, const void* cov6,
    const void* conf, void* A, void* bvec, void* st, int bsz, int n, int p,
    int variant, int is_se3, int use_cf, int do_trim, int off_tr, int off_nrm,
    int off_cov, int off_conf, int isteps, void* stream) {
  if (bsz <= 0) return (int)cudaGetLastError();
  if (variant == kGicp && cov6 == nullptr) return (int)cudaErrorInvalidValue;
  if (use_cf && conf == nullptr) return (int)cudaErrorInvalidValue;
  Params P;
  P.srcT = (const float*)srcT; P.matchedT = (const float*)matchedT;
  P.pf = (const float*)pf; P.cov6 = (const float*)cov6;
  P.conf = (const float*)conf;
  P.A = (float*)A; P.bvec = (float*)bvec; P.st = (float*)st;
  P.n = n; P.p = p; P.is_se3 = is_se3; P.use_cf = use_cf; P.do_trim = do_trim;
  P.off_tr = off_tr; P.off_nrm = off_nrm; P.off_cov = off_cov;
  P.off_conf = off_conf; P.isteps = isteps;
  const size_t smem = do_trim ? (size_t)n * sizeof(float) : 0;
  void (*kern)(const Params) =
      variant == kPt2Pt ? epilogue_kernel<kPt2Pt>
      : variant == kPt2Pl ? epilogue_kernel<kPt2Pl>
      : variant == kGicp ? epilogue_kernel<kGicp> : nullptr;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<bsz, kThreads, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
