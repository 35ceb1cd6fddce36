// Device helpers shared by the setup kernels (thresholds.cu, moments.cu).
//
// Every step is an explicitly rounded intrinsic, written in the order of
// the plain PyTorch versions' elementwise expressions in
// ops/cuda_moments.py, so that FMA contraction cannot make a kernel's
// distances differ from the plain version's: a threshold that K1 derived
// from these values classifies a target the same way in K2 and K3, on
// the card and in the plain versions.

#pragma once

#include <cuda_runtime.h>

namespace se3icp {

// (a.x * b.x + a.y * b.y) + a.z * b.z
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// Shifted squared distance r = |t|^2 - 2 q.t (add |q|^2 for d^2).  With
// tn = |t|^2 computed as dot3_rn(t, t), r of a point against itself is
// exactly -|q|^2.
__device__ __forceinline__ float shifted_d2(float qx, float qy, float qz,
                                            float tx, float ty, float tz,
                                            float tn) {
  return __fsub_rn(tn, __fmul_rn(2.0f, dot3_rn(qx, qy, qz, tx, ty, tz)));
}

}  // namespace se3icp
