// The unit eigenvector of the smallest eigenvalue of a symmetric 3x3, in
// float32, operation for operation as ops/eigh3.py's eigh3_c computes it
// with torch's elementwise CUDA ops (the setup glue's PCA normal and
// TOLDI z-axis): Cardano's eigenvalues on the matrix scaled by its
// largest entry, the null vector of (A - lam I) for the better-isolated
// extreme eigenvalue as the largest cross product of two rows, the 2x2
// problem on its orthonormal complement for the other, and the smallest
// one's vector chosen between them.
//
// Each step is an explicitly rounded intrinsic in the torch expression's
// order, so no FMA contraction creeps in.  Where torch divides a tensor
// by a Python number on the card it multiplies by the number's float32
// reciprocal, and so does this (kInv3, kInv6); clamps and maxima
// propagate NaN as torch's do; acosf / cosf are the CUDA math library's,
// as torch.acos / torch.cos call them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace se3icp {
namespace rn {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min / torch.clamp / torch.maximum: NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// (x0 y0 + x1 y1) + x2 y2
__device__ __forceinline__ float dot3(const float x[3], const float y[3]) {
  return add(add(mul(x[0], y[0]), mul(x[1], y[1])), mul(x[2], y[2]));
}

__device__ __forceinline__ void cross3(const float x[3], const float y[3],
                                       float out[3]) {
  out[0] = sub(mul(x[1], y[2]), mul(x[2], y[1]));
  out[1] = sub(mul(x[2], y[0]), mul(x[0], y[2]));
  out[2] = sub(mul(x[0], y[1]), mul(x[1], y[0]));
}

// eigh3_c(a00, a01, a02, a11, a12, a22)[1][0] in float32
__device__ inline void smallest_eigvec3(float a00, float a01, float a02,
                                        float a11, float a12, float a22,
                                        float out[3]) {
  const float eps = 1e-7f, peps = 1e-7f;
  const float eps2 = 1e-14f;                  // Python's eps * eps
  const float kInv3 = 1.0f / 3.0f, kInv6 = 1.0f / 6.0f;
  const float kTwoPiOver3 = 2.09439510239319549f;

  float scale = fabsf(a00);
  scale = maximum(scale, fabsf(a01));
  scale = maximum(scale, fabsf(a02));
  scale = maximum(scale, fabsf(a11));
  scale = maximum(scale, fabsf(a12));
  scale = maximum(scale, fabsf(a22));
  scale = clamp_min(scale, 1e-30f);
  const float s00 = dvd(a00, scale), s01 = dvd(a01, scale),
              s02 = dvd(a02, scale);
  const float s11 = dvd(a11, scale), s12 = dvd(a12, scale),
              s22 = dvd(a22, scale);

  // Cardano eigenvalues
  const float q = mul(add(add(s00, s11), s22), kInv3);
  const float b00 = sub(s00, q), b11 = sub(s11, q), b22 = sub(s22, q);
  const float off = add(add(mul(s01, s01), mul(s02, s02)), mul(s12, s12));
  const float p2 = mul(add(add(add(mul(b00, b00), mul(b11, b11)),
                               mul(b22, b22)), mul(off, 2.0f)), kInv6);
  const float p = __fsqrt_rn(clamp_min(p2, 0.0f));
  const bool small = p < peps;
  const float pinv = dvd(1.0f, small ? 1.0f : p);
  const float d00 = mul(b00, pinv), d11 = mul(b11, pinv), d22 = mul(b22, pinv);
  const float d01 = mul(s01, pinv), d02 = mul(s02, pinv), d12 = mul(s12, pinv);
  const float det =
      add(sub(mul(d00, sub(mul(d11, d22), mul(d12, d12))),
              mul(d01, sub(mul(d01, d22), mul(d12, d02)))),
          mul(d02, sub(mul(d01, d12), mul(d11, d02))));
  const float r = clamp(mul(det, 0.5f), -1.0f, 1.0f);
  const float phi = mul(acosf(r), kInv3);
  const float cos0 = cosf(phi);
  const float cos_plus = cosf(add(phi, kTwoPiOver3));
  const float two_p = small ? 0.0f : mul(p, 2.0f);
  const float e2 = add(q, mul(two_p, cos0));
  const float e0 = add(q, mul(two_p, cos_plus));
  const float e1 = sub(sub(mul(q, 3.0f), e0), e2);

  // better-isolated extreme eigenvalue first
  const bool first_is_low = sub(e1, e0) >= sub(e2, e1);
  const float lam_first = first_is_low ? e0 : e2;

  // null vector of (A - lam I): max-norm cross of row pairs
  const float r0[3] = {sub(s00, lam_first), s01, s02};
  const float r1[3] = {s01, sub(s11, lam_first), s12};
  const float r2[3] = {s02, s12, sub(s22, lam_first)};
  float c01[3], c02[3], c12[3];
  cross3(r0, r1, c01);
  cross3(r0, r2, c02);
  cross3(r1, r2, c12);
  const float n01 = dot3(c01, c01), n02 = dot3(c02, c02),
              n12 = dot3(c12, c12);
  const bool pick02 = n02 >= n12;                       // ties: lower pair
  const float nb12 = maximum(n02, n12);
  const bool pick01 = n01 >= nb12;
  const float nbest = maximum(n01, nb12);
  const bool good_v = nbest > eps2;
  float v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v12 = pick02 ? c02[i] : c12[i];
    const float vv = pick01 ? c01[i] : v12;
    v[i] = good_v ? vv : (i == 0 ? 1.0f : 0.0f);
  }
  const float winv = dvd(1.0f, clamp_min(__fsqrt_rn(dot3(v, v)), eps));
  const float w[3] = {mul(v[0], winv), mul(v[1], winv), mul(v[2], winv)};

  // orthonormal complement (U, V) of w
  const bool use_x = fabsf(w[0]) > fabsf(w[2]);
  const float inv1 = dvd(1.0f, clamp_min(
      __fsqrt_rn(add(mul(w[0], w[0]), mul(w[1], w[1]))), eps));
  const float inv2 = dvd(1.0f, clamp_min(
      __fsqrt_rn(add(mul(w[1], w[1]), mul(w[2], w[2]))), eps));
  float U[3];
  U[0] = use_x ? mul(-w[1], inv1) : 0.0f;
  U[1] = use_x ? mul(w[0], inv1) : mul(-w[2], inv2);
  U[2] = use_x ? 0.0f : mul(w[1], inv2);
  float V[3];
  cross3(w, U, V);

  const float AU[3] = {add(add(mul(s00, U[0]), mul(s01, U[1])), mul(s02, U[2])),
                       add(add(mul(s01, U[0]), mul(s11, U[1])), mul(s12, U[2])),
                       add(add(mul(s02, U[0]), mul(s12, U[1])), mul(s22, U[2]))};
  const float AV[3] = {add(add(mul(s00, V[0]), mul(s01, V[1])), mul(s02, V[2])),
                       add(add(mul(s01, V[0]), mul(s11, V[1])), mul(s12, V[2])),
                       add(add(mul(s02, V[0]), mul(s12, V[1])), mul(s22, V[2]))};
  const float a = dot3(U, AU), b = dot3(U, AV), c = dot3(V, AV);
  const float lam_other = first_is_low ? e2 : e0;
  // (a - lam) x + b y = 0  -> direction (b, lam - a) or (lam - c, b)
  const float d1x = b, d1y = sub(lam_other, a);
  const float d2x = sub(lam_other, c), d2y = b;
  const bool pick1 = add(mul(d1x, d1x), mul(d1y, d1y)) >=
                     add(mul(d2x, d2x), mul(d2y, d2y));
  float dx = pick1 ? d1x : d2x;
  float dy = pick1 ? d1y : d2y;
  const float nd = __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
  const float dinv = dvd(1.0f, clamp_min(nd, eps));
  const bool good = nd > eps;               // degenerate 2x2: any direction
  dx = good ? mul(dx, dinv) : 1.0f;
  dy = good ? mul(dy, dinv) : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v_other = add(mul(dx, U[i]), mul(dy, V[i]));
    out[i] = first_is_low ? w[i] : v_other;
  }
}

}  // namespace rn
}  // namespace se3icp
