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
// practice it is latency: a pair is 512 logical threads that each walk
// ceil(N/512) points, and the loop's batches are small (64 pairs on the
// main path, 8 at the KITTI bucket).  The design against that:
//   * a pair is a thread-block CLUSTER of C blocks (C = 1, 2, 4 or 8,
//     chosen by the wrapper so that B*C reaches the SM count, at most 2
//     when the call trims, see below): block r
//     of the cluster holds logical threads [r*512/C, (r+1)*512/C), so a
//     64-pair batch runs on 256 blocks instead of 64.  The blocks meet
//     through distributed shared memory (cluster.map_shared_rank) and
//     cluster.sync();
//   * a thread fetches the rows of several of its points before it
//     computes on any of them (kUnroll), so more loads are in flight;
//   * the trim's bisections decide kLevels = 3 levels of the bisection
//     tree per counting pass: the 7 mids of the subtree, each computed
//     by the sequential bisection's own formula from the brackets it
//     would have there, are counted in one pass over the keys and the
//     walk takes the 3 decisions -- 9 value passes instead of 26, and
//     ceil(isteps/3) index passes instead of isteps, to the SAME
//     brackets.  The count below the lower bracket comes from the pass
//     that set it, so no extra pass is needed.  The passes run inside
//     each block, with block barriers only: every block writes its
//     points' keys into every block's copy of the pair's keys (after a
//     split barrier that shows every block started, and before the one
//     that publishes the maximum), and each block then bisects all keys
//     with its own threads, to the same brackets in every block (a
//     cluster barrier a pass cost more than the counting it spread:
//     0.040 ms alone at 64 x 4608 against 0.030 at C = 2 this way, H100);
// Design choices that matter for the results rather than the speed:
//   * each logical thread keeps the parent design's points (i = t mod
//     512) in the same order; warp partials are summed in logical warp
//     order 0..15 by the same float adds, so A, b and st are the same
//     bits for every C;
//   * the trim counts are INTEGER sums, so the brackets equal those of
//     the plain bisection and the kept set is the same set (lowest
//     indices inside the boundary band);
//   * the distance chain uses explicitly rounded multiplies and adds
//     (no FMA contraction), so it yields the same bits as the plain
//     elementwise version and the two trim on identical keys;
//   * all float sums go through a fixed-order shuffle + shared-memory
//     tree, never atomics: two runs give the same bits, which the stop
//     rule |mse - mse_prev| < thr and the iteration counts rely on;
//   * rows that are not kept are skipped, not multiplied by zero, so a
//     non-finite padded row cannot poison a sum.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;     // logical threads a pair
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;          // 21 (JtJ upper) + 6 (Jtr) + 1 (mse)
constexpr int kVSteps = 26;       // value-bisection halvings
constexpr int kLevels = 3;        // bisection levels a counting pass decides
constexpr int kMids = (1 << kLevels) - 1;
constexpr int kRec = kMids + 1;   // ints a warp's count record
constexpr float kBig = 3.4e38f;

// pf row layout (per-pair iteration scalars)
constexpr int PF_T = 0, PF_BETA = 3, PF_SWITCHED = 4, PF_NSRC = 5,
              PF_COUNT = 6, PF_R = 8, PF_WIDTH = 24;

enum Variant { kPt2Pt = 0, kPt2Pl = 1, kGicp = 2 };

// points a thread fetches before it computes on them (pt2pt, pt2pl;
// gicp's whitening is bound by its arithmetic and runs one point at a
// time)
constexpr int kUnroll = 4;

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
  int off_tr, off_nrm, off_cov, off_conf, isteps, cluster;
};

// dynamic shared memory of a block, in 4-byte words: two float partial
// records a warp (kAcc each), two int records a warp for the cluster's
// reductions and two for the block's own trim counts (separate: a peer
// may still read the former while this block counts), the block's copy
// of the results, and (trim) the keys of all the pair's points
constexpr int kRedF = 2 * kWarps * kAcc;
constexpr int kRedI = 2 * kWarps * kRec;
constexpr int kRes = 32;
__host__ __device__ constexpr int fixed_words() {
  return kRedF + 2 * kRedI + kRes;
}

// ---- cluster-wide reductions ------------------------------------------

// a[h] for a run-time h without an indexed (local-memory) load
template <class T>
__device__ __forceinline__ T pick(const T (&a)[kMids], int h) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < kMids; ++j) v = j == h ? a[j] : v;
  return v;
}

// cluster.sync() for control flow that every thread of the cluster
// reaches together (the .aligned form of the barrier), and its two
// halves: a thread arrives, works, then waits for the others' arrival
__device__ __forceinline__ void cluster_sync(const cg::cluster_group& cl) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
#else
  cl.sync();
#endif
}

__device__ __forceinline__ void cluster_arrive(const cg::cluster_group& cl) {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
#else
  cl.sync();   // the CPU emulation: the whole barrier here
#endif
}

__device__ __forceinline__ void cluster_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#endif
}

// Every block writes its warps' records into its own shared memory, then
// cluster.sync(), then reads the records of all 16 logical warps in
// logical order from the blocks that hold them.  The records alternate
// between two slots, so a reduction's reads are finished (they precede
// the next reduction's cluster.sync) before its slot is written again.

struct Cluster {
  cg::cluster_group cl;
  int wpb;          // warps a block
  int lane, wl;     // lane, warp within the block
  int* red_i;       // [2][kWarps][kRec] the cluster's int records
  int* red_c;       // [2][kWarps][kRec] the block's trim counts
  float* red_f;     // [2][kWarps][kAcc]
  float* res;       // [kAcc]
  int iround = 0, fround = 0, cround = 0;

  // logical warp w's record in slot `base` of the block that holds it
  template <class T>
  __device__ const T* record(T* base, int w, int width) {
    return cl.map_shared_rank(base, (unsigned)(w / wpb)) + (w % wpb) * width;
  }

  // c[j] summed over the threads of this BLOCK; lane j < kMids of every
  // warp gets total j.  One block barrier: the records alternate
  // between two slots.
  __device__ int block_counts(int (&c)[kMids]) {
    int* slot = red_c + (cround++ & 1) * kWarps * kRec;
#pragma unroll
    for (int j = 0; j < kMids; ++j) c[j] = __reduce_add_sync(0xffffffffu, c[j]);
    if (lane < kMids) slot[wl * kRec + lane] = pick(c, lane);
    __syncthreads();
    int t = 0;
    if (lane < kMids)
      for (int w = 0; w < wpb; ++w) t += slot[w * kRec + lane];
    return t;
  }

  // max over the cluster of v >= 0, in every thread
  __device__ float max_float(float v) {
    int* slot = red_i + (iround++ & 1) * kWarps * kRec;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) slot[wl * kRec] = __float_as_int(v);
    cluster_sync(cl);
    float t = 0.0f;
    if (lane < kWarps) t = __int_as_float(*record(slot, lane, kRec));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
    return t;
  }

  // res[0..K) = sum over the cluster of acc[k], lane sums by the
  // shuffle tree and then the 16 warp partials one after another in
  // logical warp order (the single-block design's order, so the same
  // bits); *count = the cluster's sum of `count`.  res is written by the
  // blocks that need it (all, or rank 0) and visible to their threads
  // on return.
  template <int K>
  __device__ void sum_floats(float (&acc)[K], int* count, bool all) {
    float* slot = red_f + (fround & 1) * kWarps * kAcc;
    int* islot = red_i + (iround & 1) * kWarps * kRec;
    ++fround;
    ++iround;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = acc[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) slot[wl * kAcc + k] = v;
    }
    const int c = __reduce_add_sync(0xffffffffu, *count);
    if (lane == 0) islot[wl * kRec] = c;
    cluster_sync(cl);
    int t = lane < kWarps ? *record(islot, lane, kRec) : 0;
    *count = __reduce_add_sync(0xffffffffu, t);
    if (all || cl.block_rank() == 0) {
      const int k = (int)threadIdx.x;
      if (k < K) {
        float tot = 0.f;
        for (int wi = 0; wi < kWarps; ++wi) tot += record(slot, wi, kAcc)[k];
        res[k] = tot;
      }
      __syncthreads();
    }
  }
};

// the subtree of `levels` bisection levels below brackets (lo, hi), in
// heap order (node h has children 2h+1 below and 2h+2 above its mid):
// each node's mid by the sequential bisection's formula from the
// brackets it would have there
template <bool kIndex>
__device__ __forceinline__ void subtree_mids(float lo, float hi,
                                             float (&mid)[kMids]) {
  float a[kMids], b[kMids];
  a[0] = lo;
  b[0] = hi;
#pragma unroll
  for (int h = 0; h < kMids; ++h) {
    mid[h] = kIndex ? floorf(0.5f * (a[h] + b[h])) : 0.5f * (a[h] + b[h]);
    if (2 * h + 2 < kMids) {
      a[2 * h + 1] = a[h]; b[2 * h + 1] = mid[h];
      a[2 * h + 2] = mid[h]; b[2 * h + 2] = b[h];
    }
  }
}

// ---- explicitly rounded arithmetic of the distance chain -------------

__device__ __forceinline__ float dot3_rn(float a, float x, float b, float y,
                                         float c, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                   __fmul_rn(c, z));
}

struct Pose {
  float t0, t1, t2, beta;
  float R[3][3];
  bool switched;
};

// What a point's arithmetic reads, fetched before any of it runs: the
// source row, the matched target point, the matched frame translation
// (SE(3) phase A), and pt2pl's normal.
template <int VARIANT>
struct Rows {
  float x, y, z, g0, g1, g2, a0, a1, a2;
  float e[VARIANT == kPt2Pl ? 3 : 1];
};

struct Point {
  float s0, s1, s2;      // moving source R x + t
  float g0, g1, g2;      // matched target point
  float dB0, dB1, dB2;   // s - g
  float d_b;             // euclidean moving-vs-target distance
  float dist;            // trim / MSE metric of the pair's phase
};

// The rows of point i.  `extra`: also pt2pl's normal (the trim's key
// pass needs only the distance).
template <int VARIANT>
__device__ __forceinline__ Rows<VARIANT> fetch(const Params& P,
                                               const Pose& ps,
                                               const float* src_b,
                                               const float* mt_b, int i,
                                               bool extra) {
  const int n = P.n;
  Rows<VARIANT> r;
  r.x = src_b[i]; r.y = src_b[n + i]; r.z = src_b[2 * n + i];
  r.g0 = mt_b[i]; r.g1 = mt_b[n + i]; r.g2 = mt_b[2 * n + i];
  r.a0 = r.a1 = r.a2 = 0.0f;
  if (P.is_se3 && !ps.switched) {
    const float* tr = mt_b + (size_t)P.off_tr * n;
    r.a0 = tr[i]; r.a1 = tr[n + i]; r.a2 = tr[2 * n + i];
  }
  if (!extra) return r;
  if constexpr (VARIANT == kPt2Pl) {
    const float* nr = mt_b + (size_t)P.off_nrm * n;
    r.e[0] = nr[i]; r.e[1] = nr[n + i]; r.e[2] = nr[2 * n + i];
  }
  return r;
}

template <int VARIANT>
__device__ __forceinline__ Point make_point(const Params& P, const Pose& ps,
                                            const Rows<VARIANT>& r) {
  const float rx = dot3_rn(ps.R[0][0], r.x, ps.R[0][1], r.y, ps.R[0][2], r.z);
  const float ry = dot3_rn(ps.R[1][0], r.x, ps.R[1][1], r.y, ps.R[1][2], r.z);
  const float rz = dot3_rn(ps.R[2][0], r.x, ps.R[2][1], r.y, ps.R[2][2], r.z);
  Point pt;
  pt.s0 = __fadd_rn(rx, ps.t0);
  pt.s1 = __fadd_rn(ry, ps.t1);
  pt.s2 = __fadd_rn(rz, ps.t2);
  pt.g0 = r.g0; pt.g1 = r.g1; pt.g2 = r.g2;
  pt.dB0 = __fsub_rn(pt.s0, pt.g0);
  pt.dB1 = __fsub_rn(pt.s1, pt.g1);
  pt.dB2 = __fsub_rn(pt.s2, pt.g2);
  pt.d_b = __fsqrt_rn(dot3_rn(pt.dB0, pt.dB0, pt.dB1, pt.dB1, pt.dB2, pt.dB2));
  pt.dist = pt.d_b;
  if (P.is_se3 && !ps.switched) {
    // phase A: beta-weighted frame translations against the matched
    // 12-D row's translation block
    const float a0 = __fsub_rn(__fadd_rn(__fmul_rn(ps.beta, rx), ps.t0), r.a0);
    const float a1 = __fsub_rn(__fadd_rn(__fmul_rn(ps.beta, ry), ps.t1), r.a1);
    const float a2 = __fsub_rn(__fadd_rn(__fmul_rn(ps.beta, rz), ps.t2), r.a2);
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

// components (w00, w01, w02, w11, w12, w22) of M^(-1/2).  A function of
// its own, not inlined: its multiplies and adds are not explicitly
// rounded, and compiled apart they fuse into the same FMAs whatever the
// kernel around them, so gicp's sums keep the single-block design's bits.
__device__ __noinline__ void inv_sqrt_sym3(const float (&m)[6],
                                           float (&out)[6]) {
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
  extern __shared__ __align__(16) float smem[];
  const int C = P.cluster;
  const int T = kThreads / C;                  // threads of this block
  Cluster cs{cg::this_cluster()};
  cs.wpb = T / 32;
  cs.lane = threadIdx.x & 31;
  cs.wl = threadIdx.x >> 5;
  cs.red_f = smem;
  cs.red_i = reinterpret_cast<int*>(smem + kRedF);
  cs.red_c = reinterpret_cast<int*>(smem + kRedF + kRedI);
  cs.res = smem + kRedF + 2 * kRedI;
  // the trim keys of ALL the pair's points, in index order (every block
  // of the cluster holds a copy: steps * 512, do_trim)
  float* keys = smem + fixed_words();

  const int rank = (int)cs.cl.block_rank();
  const int b = blockIdx.x / C;
  const int lt = rank * T + threadIdx.x;       // logical thread of the pair
  const int n = P.n;
  const int steps = (n + kThreads - 1) / kThreads;   // points a thread
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
  const int nv = min(max(n_src, 0), n);

  const float* src_b = P.srcT + (size_t)b * 3 * n;
  const float* mt_b = P.matchedT + (size_t)b * P.p * n;
  constexpr int U = kUnroll;

  // ---- exact-count trim: value bisection + index bisection ----------
  float lo = -1.0f, hi = 0.0f, hii = 0.0f;
  if (P.do_trim) {
    // the peers' shared memory may be written once every block of the
    // cluster has started: arrive now, wait once the first rows are on
    // their way
    cluster_arrive(cs.cl);
    float tmax = 0.0f;
    for (int k0 = 0; k0 < steps; k0 += U) {
      Rows<VARIANT> r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = lt + (k0 + u) * kThreads;
        if (k0 + u < steps && i < nv)
          r[u] = fetch<VARIANT>(P, ps, src_b, mt_b, i, false);
      }
      if (k0 == 0) cluster_wait();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u, i = lt + k * kThreads;
        if (k >= steps) continue;
        // rows past the cloud are no points: NaN is in no bracket
        float key = i < n ? kBig : __int_as_float(0x7fffffff);
        if (i < nv) {
          key = make_point<VARIANT>(P, ps, r[u]).dist;
          tmax = fmaxf(tmax, key);
        }
        // into every block's copy; the barrier of max_float publishes
#pragma unroll 1
        for (int r = 0; r < C; ++r)
          cs.cl.map_shared_rank(keys, (unsigned)r)[i] = key;
      }
    }
    if (steps == 0) cluster_wait();
    hi = cs.max_float(tmax);
    // the bisections run on the block's own copy of the keys: block
    // barriers only, the same brackets in every block
    // #(d <= lo): none below the first lo, distances are >= 0; later
    // the count of the pass that moved lo
    int clo = 0;
    for (int done = 0; done < kVSteps; done += kLevels) {
      float mid[kMids];
      subtree_mids<false>(lo, hi, mid);
      int c[kMids];
#pragma unroll
      for (int j = 0; j < kMids; ++j) c[j] = 0;
      for (int i = threadIdx.x; i < n; i += T) {
        const float d = keys[i];
#pragma unroll
        for (int j = 0; j < kMids; ++j) c[j] += d <= mid[j];
      }
      const int tot = cs.block_counts(c);
      const int levels = min(kLevels, kVSteps - done);
      for (int l = 0, h = 0; l < levels; ++l) {
        const int th = __shfl_sync(0xffffffffu, tot, h);
        if (th >= count) { hi = pick(mid, h); h = 2 * h + 1; }
        else { lo = pick(mid, h); clo = th; h = 2 * h + 2; }
      }
    }
    const int target = count - clo;
    float li = -1.0f;
    hii = (float)(n - 1);
    for (int done = 0; done < P.isteps; done += kLevels) {
      float mid[kMids];
      subtree_mids<true>(li, hii, mid);
      int c[kMids];
#pragma unroll
      for (int j = 0; j < kMids; ++j) c[j] = 0;
      for (int i = threadIdx.x; i < n; i += T) {
        const float d = keys[i];
        const bool band = (d > lo) && (d <= hi);
#pragma unroll
        for (int j = 0; j < kMids; ++j) c[j] += band && ((float)i <= mid[j]);
      }
      const int tot = cs.block_counts(c);
      const int levels = min(kLevels, P.isteps - done);
      for (int l = 0, h = 0; l < levels; ++l) {
        if (__shfl_sync(0xffffffffu, tot, h) >= target) {
          hii = pick(mid, h); h = 2 * h + 1;
        } else {
          li = pick(mid, h); h = 2 * h + 2;
        }
      }
    }
  }
  auto kept_at = [&](int i) -> bool {
    if (!P.do_trim) return i < nv;
    const float d = keys[i];
    return (d <= lo) || ((d > lo) && (d <= hi) && ((float)i <= hii));
  };
  // use(point, rows) on each kept point of this thread, in point order;
  // the rows of U points are fetched before any of them is used
  auto each_kept = [&](auto&& use) {
    for (int k0 = 0; k0 < steps; k0 += U) {
      Rows<VARIANT> r[U];
      bool on[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u, i = lt + k * kThreads;
        on[u] = k < steps && i < n && kept_at(i);
        if (on[u]) r[u] = fetch<VARIANT>(P, ps, src_b, mt_b, i, true);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (on[u]) use(make_point<VARIANT>(P, ps, r[u]), r[u]);
    }
  };

  // ---- kept count, MSE and the estimator's sums ----------------------
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  int wcount = 0;
  float* A = P.A + (size_t)b * 36;
  const int tid = threadIdx.x;

  if constexpr (VARIANT == kPt2Pt) {
    // pass 1: weighted means (acc 0..5) + mse numerator (acc 27)
    each_kept([&](const Point& pt, const Rows<VARIANT>&) {
      ++wcount;
      acc[0] += pt.s0; acc[1] += pt.s1; acc[2] += pt.s2;
      acc[3] += pt.g0; acc[4] += pt.g1; acc[5] += pt.g2;
      acc[27] += P.use_cf ? pt.d_b : pt.dist;
    });
    cs.sum_floats(acc, &wcount, true);
    const float wsum = (float)wcount;
    const float wsafe = fmaxf(wsum, 1e-30f);
    float mu[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) mu[k] = cs.res[k] / wsafe;
    const float mse = cs.res[27] / fmaxf(wsum, 1.0f);
    // pass 2: H = sum w (g - mu_t)(s - mu_s)^T
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
    each_kept([&](const Point& pt, const Rows<VARIANT>&) {
      const float ds[3] = {pt.s0 - mu[0], pt.s1 - mu[1], pt.s2 - mu[2]};
      const float dt[3] = {pt.g0 - mu[3], pt.g1 - mu[4], pt.g2 - mu[5]};
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[3 * r + c] += dt[r] * ds[c];
    });
    int none = 0;
    cs.sum_floats(acc, &none, false);
    if (rank == 0) {
      if (tid < 36) {
        const int r = tid / 6, c = tid % 6;
        A[tid] = (r < 3 && c < 3) ? cs.res[3 * r + c] : 0.0f;
      }
      if (tid < 8) {
        P.bvec[(size_t)b * 8 + tid] = tid < 6 ? mu[tid] : 0.0f;
        P.st[(size_t)b * 8 + tid] = tid == 0 ? mse : (tid == 1 ? wsum : 0.0f);
      }
    }
  } else {
    if constexpr (VARIANT == kPt2Pl) {
      each_kept([&](const Point& pt, const Rows<VARIANT>& rw) {
        ++wcount;
        acc[27] += P.use_cf ? pt.d_b : pt.dist;
        const float n0 = rw.e[0], n1 = rw.e[1], n2 = rw.e[2];
        const float r = pt.dB0 * n0 + pt.dB1 * n1 + pt.dB2 * n2;
        const float j[6] = {pt.s1 * n2 - pt.s2 * n1, pt.s2 * n0 - pt.s0 * n2,
                            pt.s0 * n1 - pt.s1 * n0, n0, n1, n2};
        add_normal(acc, j, r);
      });
    } else {
      const float* cs_b = P.cov6 + (size_t)b * 6 * n;
      const float* ct = mt_b + (size_t)P.off_cov * n;
      for (int k = 0; k < steps; ++k) {
        const int i = lt + k * kThreads;
        if (i >= n || !kept_at(i)) continue;
        const Point pt = make_point<VARIANT>(
            P, ps, fetch<VARIANT>(P, ps, src_b, mt_b, i, false));
        ++wcount;
        acc[27] += P.use_cf ? pt.d_b : pt.dist;
        // M = C_t(matched) + R C_s R^T on symmetric components
        float c6[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) c6[c] = cs_b[(size_t)c * n + i];
        const int cidx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
        const int pr[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
        float m6[6];
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          float a = ct[(size_t)m * n + i];
#pragma unroll
          for (int kk = 0; kk < 3; ++kk)
#pragma unroll
            for (int l = 0; l < 3; ++l)
              a += (ps.R[pr[m][0]][kk] * ps.R[pr[m][1]][l]) * c6[cidx[kk][l]];
          m6[m] = a;
        }
        float W6[6];
        inv_sqrt_sym3(m6, W6);
        if (P.use_cf) {
          const float cw = 0.5f * (P.conf[(size_t)b * n + i] +
                                   mt_b[(size_t)P.off_conf * n + i]);
#pragma unroll
          for (int c = 0; c < 6; ++c) W6[c] *= cw;
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
    cs.sum_floats(acc, &wcount, false);
    if (rank == 0) {
      const float wsum = (float)wcount;
      if (tid < 36) {
        int r = tid / 6, c = tid % 6;
        if (r > c) { const int t = r; r = c; c = t; }
        // index of (r, c), r <= c, in the row-major upper triangle
        A[tid] = cs.res[r * 6 - (r * (r - 1)) / 2 + (c - r)];
      }
      if (tid < 8) {
        P.bvec[(size_t)b * 8 + tid] = tid < 6 ? cs.res[21 + tid] : 0.0f;
        P.st[(size_t)b * 8 + tid] =
            tid == 0 ? cs.res[27] / fmaxf(wsum, 1.0f)
                     : (tid == 1 ? wsum : 0.0f);
      }
    }
  }
  // a block's shared memory must outlive the peers' reads of it
  cluster_sync(cs.cl);
}

}  // namespace

extern "C" int se3icp_loop_epilogue(
    const void* srcT, const void* matchedT, const void* pf, const void* cov6,
    const void* conf, void* A, void* bvec, void* st, int bsz, int n, int p,
    int variant, int is_se3, int use_cf, int do_trim, int off_tr, int off_nrm,
    int off_cov, int off_conf, int isteps, int cluster, void* stream) {
  if (bsz <= 0) return (int)cudaGetLastError();
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return (int)cudaErrorInvalidValue;
  if (variant == kGicp && cov6 == nullptr) return (int)cudaErrorInvalidValue;
  if (use_cf && conf == nullptr) return (int)cudaErrorInvalidValue;
  Params P;
  P.srcT = (const float*)srcT; P.matchedT = (const float*)matchedT;
  P.pf = (const float*)pf; P.cov6 = (const float*)cov6;
  P.conf = (const float*)conf;
  P.A = (float*)A; P.bvec = (float*)bvec; P.st = (float*)st;
  P.n = n; P.p = p; P.is_se3 = is_se3; P.use_cf = use_cf; P.do_trim = do_trim;
  P.off_tr = off_tr; P.off_nrm = off_nrm; P.off_cov = off_cov;
  P.off_conf = off_conf; P.isteps = isteps; P.cluster = cluster;
  const int threads = kThreads / cluster;
  const size_t steps = (size_t)(n + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(float) * (fixed_words() + (do_trim ? steps * kThreads : 0));
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
  // one cluster of `cluster` blocks a pair; a size the card refuses
  // fails the launch (no fallback to another size)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bsz * (unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
