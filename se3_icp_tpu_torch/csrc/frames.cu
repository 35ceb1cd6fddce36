// The setup glue of the threshold route around the moments (K2) and the
// TOLDI axis sums (K3), one thread a query:
//
//   G1 (frame_inputs_kernel): from K2's raw ball sums, the covariance
//     about TOLDI's quirky centroid and its smallest eigenvector (the
//     unsigned z-axis), n.q and the radius, written as K3's own operands
//     (normal [B,3,C] and aux = (thr - |q|^2, radius, n.q) [B,3,C]); with
//     the pt2pl normals fused into the same K2 pass, the PCA normal of the
//     centroid ball too.  One-ball modes: the PCA normal of a ball
//     (pt2pl normals) or the GICP covariance built from it (C = I -
//     (1 - eps) n n^T, diag(eps, 1, 1) where n.x < -0.99: the reference's
//     quirk).
//   G2 (frame_assembly_kernel): after K3, the TOLDI frame: the arrow sign
//     of z, x from the weighted sums orthogonalised to z and normalised,
//     y = z x x; written component-major [B,9(+3),C] (the fused normal
//     appended) and point-major [B,C,9], the layout the loop's packing
//     reads.
//
// Replaces no TPU kernel: on the TPU these are XLA fusions of the JAX
// package's glue (se3_icp_tpu/ops/lrf.py:579-629 and its normals and
// covariance functions).  The port ran them as ~1,000 small torch ops a
// setup (ops/lrf.py, ops/eigh3.py).  Every float32 step here is that
// torch code's, in its order, explicitly rounded (eigh3_rn.cuh): the same
// bits on the card as the plain versions in ops/cuda_frames.py.  Sums of
// three over a component dimension (torch.sum(.., 1)) run as torch's
// reduction does on the card: ((a0 + a1) + a2) + 0.
//
// Bound: bytes.  G1 (TOLDI) reads the covariance ball's 10 sums, the
// centroid ball's 3 (all 10 with the fused normal; the third ball's
// none) and 5 floats of the query, and writes 6 (9 fused): 24 (34)
// floats a query, 28 (40) MB at 64 x 4608; one ball reads 13 and writes
// 3 (6).  G2 reads 14 (17) and writes 18 (21), its points and
// point-major frames staged in shared memory so that every warp access
// is coalesced.  A few hundred operations a query are far from the
// card's rate.
#include <cuda_runtime.h>
#include <math.h>

#include "eigh3_rn.cuh"

namespace {

using namespace se3icp::rn;

constexpr int kThreads = 128;
constexpr int kSums = 10;          // K2's sums a ball: x y z xx xy xz yy yz zz 1

enum Mode { kToldi = 0, kNormals = 1, kGicp = 2 };

__device__ __forceinline__ float bits(int b) { return __int_as_float(b); }

// torch.sum(v, 1) over three components on the card
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return add(add(add(a0, a1), a2), 0.0f);
}

// A ball's sums with the query's own term removed (cuda_moments.
// _moments_dict): s[3] = sum p, p9 (xx xy xz yy yz zz), cnt.
struct Ball {
  float s[3], p6[6], cnt;
};

__device__ __forceinline__ Ball ball(const float* raw, int ball_row, int nq,
                                     const float q[3]) {
  const float* r = raw + static_cast<long long>(ball_row) * nq;
  Ball out;
#pragma unroll
  for (int k = 0; k < 3; ++k) out.s[k] = sub(r[k * nq], q[k]);
  out.p6[0] = sub(r[3 * nq], mul(q[0], q[0]));
  out.p6[1] = sub(r[4 * nq], mul(q[0], q[1]));
  out.p6[2] = sub(r[5 * nq], mul(q[0], q[2]));
  out.p6[3] = sub(r[6 * nq], mul(q[1], q[1]));
  out.p6[4] = sub(r[7 * nq], mul(q[1], q[2]));
  out.p6[5] = sub(r[8 * nq], mul(q[2], q[2]));
  out.cnt = sub(r[9 * nq], 1.0f);
  return out;
}

// lrf._pca_normal_t: the ball's PCA normal, self included, mean over k
__device__ void pca_normal(const Ball& bl, const float q[3], float kinv,
                           float n[3]) {
  float s1[3], mean[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s1[k] = add(bl.s[k], q[k]);
    mean[k] = mul(s1[k], kinv);
  }
  const float m = add(bl.cnt, 1.0f);
  float c[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int i = e < 3 ? 0 : (e < 5 ? 1 : 2);
    const int j = e < 3 ? e : (e < 5 ? e - 2 : 2);
    const float s2 = add(bl.p6[e], mul(q[j], q[i]));
    const float v = add(sub(sub(s2, mul(s1[i], mean[j])), mul(mean[i], s1[j])),
                        mul(mul(m, mean[i]), mean[j]));
    c[e] = mul(v, kinv);
  }
  smallest_eigvec3(c[0], c[1], c[2], c[3], c[4], c[5], n);
}

// G1.  raw [B, 10 M, C] (K2's sums of the query rows r0 .. r0 + C - 1),
// pts [B, N, 3], tn [B, N], thr [B, C] with batch stride thr_bstride
// (kToldi: the k-ball's threshold);
// out0 [B, 3, C] the normal (kGicp: [B, 6, C] the covariance), out1
// [B, 3, C] aux (kToldi), out2 [B, 3, C] the fused normal (kToldi with
// fuse).  c0, c1: float bits of 1/rz (kToldi) or of kinv (the normals'
// mean), c2: of kinv of the fused normal (kToldi) or, with c3, of
// (1 - eps) and eps (kGicp).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
frame_inputs_kernel(const float* __restrict__ raw, const float* __restrict__ pts,
                    const float* __restrict__ tn, const float* __restrict__ thr,
                    float* __restrict__ out0, float* __restrict__ out1,
                    float* __restrict__ out2, int n, int nq, int r0,
                    int thr_bstride, int fuse, int c0, int c2, int c3) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= nq) return;
  const int balls = kMode == kToldi ? 3 : 1;
  const float* rb = raw + static_cast<long long>(b) * balls * kSums * nq + c;
  const long long row = static_cast<long long>(b) * n + r0 + c;
  const float q[3] = {pts[3 * row], pts[3 * row + 1], pts[3 * row + 2]};
  const long long o3 = static_cast<long long>(b) * 3 * nq + c;
  if (kMode == kToldi) {
    // lrf.toldi_axis_inputs: the covariance ball about the centroid of
    // the rz-ball's sum over rz (only that ball's first 3 sums are read
    // unless the fused normal needs the rest)
    const Ball cov = ball(rb, kSums, nq, q);
    const float inv_rz = bits(c0);
    float ce[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) ce[k] = mul(sub(rb[k * nq], q[k]), inv_rz);
    float cv[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int i = e < 3 ? 0 : (e < 5 ? 1 : 2);
      const int j = e < 3 ? e : (e < 5 ? e - 2 : 2);
      cv[e] = add(sub(sub(cov.p6[e], mul(cov.s[i], ce[j])), mul(ce[i], cov.s[j])),
                  mul(mul(cov.cnt, ce[i]), ce[j]));
    }
    float nrm[3];
    smallest_eigvec3(cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], nrm);
    const float ndotq = add(add(mul(nrm[0], q[0]), mul(nrm[1], q[1])),
                            mul(nrm[2], q[2]));
    const float t = thr[static_cast<long long>(b) * thr_bstride + c];
#pragma unroll
    for (int k = 0; k < 3; ++k) out0[o3 + k * nq] = nrm[k];
    out1[o3] = sub(t, tn[row]);
    out1[o3 + nq] = __fsqrt_rn(clamp_min(t, 0.0f));
    out1[o3 + 2 * nq] = ndotq;
    if (fuse) {
      float fn[3];
      pca_normal(ball(rb, 0, nq, q), q, bits(c2), fn);
#pragma unroll
      for (int k = 0; k < 3; ++k) out2[o3 + k * nq] = fn[k];
    }
  } else {
    float nrm[3];
    pca_normal(ball(rb, 0, nq, q), q, bits(c0), nrm);
    if (kMode == kNormals) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out0[o3 + k * nq] = nrm[k];
    } else {
      // lrf.gicp_cov6_from_normals_t
      const float f = bits(c2), eps = bits(c3), nf = -f;
      const float nx = nrm[0], ny = nrm[1], nz = nrm[2];
      const bool quirk = nx < -0.99f;
      const float comps[6] = {
          quirk ? eps : sub(1.0f, mul(mul(nx, f), nx)),
          quirk ? 0.0f : mul(mul(nx, nf), ny),
          quirk ? 0.0f : mul(mul(nx, nf), nz),
          quirk ? 1.0f : sub(1.0f, mul(mul(ny, f), ny)),
          quirk ? 0.0f : mul(mul(ny, nf), nz),
          quirk ? 1.0f : sub(1.0f, mul(mul(nz, f), nz))};
      const long long o6 = static_cast<long long>(b) * 6 * nq + c;
#pragma unroll
      for (int e = 0; e < 6; ++e) out0[o6 + e * nq] = comps[e];
    }
  }
}

// G2.  raw [B, 30, C] (K2's three balls), pts [B, N, 3], normal [B, 3, C]
// (G1's), w [B, 4, C] (K3's: sum W p, sum W), fused [B, 3, C] or null;
// out_t [B, 9 (12 with fused), C], frames [B, C, 9].  A block's queries
// are consecutive, so their points are one run of 3 floats a query and
// their point-major frames one run of 9: both go through shared memory,
// read and written by consecutive threads at consecutive addresses (a
// thread's own 3 or 9 floats, 12 or 36 bytes apart from its neighbour's,
// would spread each warp's access over 3 or 9 times the lines).  The
// component-major rows are read and written a row at a time, coalesced.
__global__ void __launch_bounds__(kThreads)
frame_assembly_kernel(const float* __restrict__ raw, const float* __restrict__ pts,
                      const float* __restrict__ normal, const float* __restrict__ w,
                      const float* __restrict__ fused, float* __restrict__ out_t,
                      float* __restrict__ frames, int n, int nq, int r0) {
  __shared__ float sq[3 * kThreads];
  __shared__ float sf[9 * kThreads];
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + t;
  const int b = blockIdx.y;
  const int count = nq - c0 < kThreads ? nq - c0 : kThreads;
  const float* pq = pts + (static_cast<long long>(b) * n + r0 + c0) * 3;
  for (int i = t; i < 3 * count; i += kThreads) sq[i] = pq[i];
  __syncthreads();
  if (c < nq) {
    const float q[3] = {sq[3 * t], sq[3 * t + 1], sq[3 * t + 2]};
    const float* rb = raw + static_cast<long long>(b) * 3 * kSums * nq + c;
    const float* wb = w + static_cast<long long>(b) * 4 * nq + c;
    const long long o3 = static_cast<long long>(b) * 3 * nq + c;
    // the all-ball's sums without the query, and K3's
    const float cnt = sub(rb[(2 * kSums + 9) * nq], 1.0f);
    const float wsum = wb[3 * nq];
    float nv[3], arrow[3], scaled[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nv[k] = normal[o3 + k * nq];
      const float all_sum = sub(rb[(2 * kSums + k) * nq], q[k]);
      arrow[k] = sub(all_sum, mul(cnt, q[k]));
      scaled[k] = sub(wb[k * nq], mul(wsum, q[k]));
    }
    const bool flip = sum3(mul(nv[0], arrow[0]), mul(nv[1], arrow[1]),
                           mul(nv[2], arrow[2])) < 0.0f;
    float z[3], x[3], y[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) z[k] = flip ? -nv[k] : nv[k];
    const float sz = sum3(mul(scaled[0], z[0]), mul(scaled[1], z[1]),
                          mul(scaled[2], z[2]));
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = sub(scaled[k], mul(sz, z[k]));
    const float xn = __fsqrt_rn(sum3(mul(x[0], x[0]), mul(x[1], x[1]),
                                     mul(x[2], x[2])));
    const float xc = clamp_min(xn, 1e-30f);
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = dvd(x[k], xc);
    y[0] = sub(mul(z[1], x[2]), mul(z[2], x[1]));
    y[1] = sub(mul(z[2], x[0]), mul(z[0], x[2]));
    y[2] = sub(mul(z[0], x[1]), mul(z[1], x[0]));
    const int rows = fused != nullptr ? 12 : 9;
    float* ot = out_t + static_cast<long long>(b) * rows * nq + c;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ot[k * nq] = x[k];
      ot[(3 + k) * nq] = y[k];
      ot[(6 + k) * nq] = z[k];
      sf[9 * t + k] = x[k];
      sf[9 * t + 3 + k] = y[k];
      sf[9 * t + 6 + k] = z[k];
    }
    if (fused != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) ot[(9 + k) * nq] = fused[o3 + k * nq];
    }
  }
  __syncthreads();
  float* fp = frames + (static_cast<long long>(b) * nq + c0) * 9;
  for (int i = t; i < 9 * count; i += kThreads) fp[i] = sf[i];
}

}  // namespace

// mode 0 (TOLDI axis inputs, fuse: the fused normal too), 1 (PCA
// normals), 2 (GICP covariances); c0, c2, c3: float bits (see the kernel)
extern "C" int se3icp_frame_inputs(const void* raw, const void* pts,
                                   const void* tn, const void* thr, void* out0,
                                   void* out1, void* out2, int bsz, int n,
                                   int nq, int r0, int thr_bstride, int mode,
                                   int fuse, int c0, int c2, int c3,
                                   void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  const dim3 grid((nq + kThreads - 1) / kThreads, bsz);
  const float* r = (const float*)raw;
  const float* p = (const float*)pts;
  const float* t = (const float*)tn;
  const float* h = (const float*)thr;
  if (mode == kToldi) {
    frame_inputs_kernel<kToldi><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        r, p, t, h, (float*)out0, (float*)out1, (float*)out2, n, nq, r0,
        thr_bstride, fuse, c0, c2, c3);
  } else if (mode == kNormals) {
    frame_inputs_kernel<kNormals><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        r, p, t, h, (float*)out0, (float*)out1, (float*)out2, n, nq, r0,
        thr_bstride, fuse, c0, c2, c3);
  } else if (mode == kGicp) {
    frame_inputs_kernel<kGicp><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        r, p, t, h, (float*)out0, (float*)out1, (float*)out2, n, nq, r0,
        thr_bstride, fuse, c0, c2, c3);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int se3icp_frame_assembly(const void* raw, const void* pts,
                                     const void* normal, const void* w,
                                     const void* fused, void* out_t,
                                     void* frames, int bsz, int n, int nq,
                                     int r0, void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  const dim3 grid((nq + kThreads - 1) / kThreads, bsz);
  frame_assembly_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)raw, (const float*)pts, (const float*)normal,
      (const float*)w, (const float*)fused, (float*)out_t, (float*)frames, n,
      nq, r0);
  return (int)cudaGetLastError();
}
