// G3: the registration loop step's glue after the fused epilogue (K5),
// one warp a pair.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's loop
// body (se3_icp_tpu/models/registration.py: jnp.linalg.solve, the
// Euler-ZYX retraction, T_i @ T, the stop and switch tests, the masked
// update, the next step's W / phase / pf) into the device program around
// its Pallas kernels.  The port ran it as ~110 small torch ops a step.
//
// It repeats ops/cuda_step.py's step_update_plain operation for
// operation: every float32 step rounded on its own (no contraction into
// FMAs), sums left to right, sinf/cosf, the pivot and the quaternion's
// column chosen by the same strict comparisons, so the kernel and the
// plain version give the same bits on the card.  Per pair: the 6x6
// normal equations by Gaussian elimination with partial pivoting (pt2pl,
// gicp) or Horn's quaternion form of the Kabsch rotation, 24 squarings
// of a symmetric 4x4 (pt2pt); the identity where the solve fails; the
// new pose, its change, the stop / switch tests; the state written in
// place, the history row, and the next step's W [16,16], ph2 [2] and
// pf [24].
//
// Bound: latency.  A pair's solve is a chain of a few hundred dependent
// operations (pt2pt: ~1,700 on one thread); the bytes (~1.4 KB a pair)
// and the operations are nothing to the card.  The design spreads a
// pair over a warp, one pair a warp and four warps a block, so a 64-pair
// batch runs on 16 SMs instead of one, and within the warp:
//   * the 6x6 system's rows over lanes 0..5: each elimination step's
//     divisions and row updates run in parallel, the pivot is the
//     sequential scan's strict comparisons on the column fetched by
//     shuffles, the row swap and the pivot row are shuffles;
//   * pt2pt's symmetric 4x4 over lanes 0..9, an entry a lane: a
//     squaring is 8 shuffles and a chain of 4 products and 3 sums, a
//     rescale one division a lane;
//   * the retraction's three cosf and three sinf on six lanes;
//   * the loads and stores over the lanes, coalesced (W's 256 floats
//     as 8 stores a lane);
// the rest (the new pose, the tests) every lane computes alike.  Each
// entry keeps its operations and their order, so the bits are the
// one-thread design's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;                   // pairs a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1.17549435e-38f;    // torch.finfo(float32).tiny
constexpr int kSquarings = 24;              // ops/solve.py _SQUARINGS
constexpr int kRescaleEvery = 4;
// pf layout (ops/cuda_loop.py)
constexpr int kPfT = 0, kPfBeta = 3, kPfSwitched = 4, kPfNsrc = 5,
              kPfCount = 6, kPfR = 8, kPfWidth = 24;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.40282347e38f;
}
// torch.clamp_min: NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(kFull, v, src);
}

// v[i] for a lane-dependent i, by selects (no indexed register array)
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float out = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) out = i == k ? v[k] : out;
  return out;
}

// solve.solve6_c: A x = -b by Gaussian elimination with partial
// pivoting; false where a pivot is zero or not finite or x is not
// finite (non-finite entries of x set to 0).  Row r of [A | -b] lives
// in lane r (lanes past 5 keep a copy of row 5 that no lane reads); x
// and the flag come out in every lane.
__device__ bool solve6(const float* A, const float* b, int lane,
                       float x[6]) {
  const int r = lane < 6 ? lane : 5;
  float a[7];
#pragma unroll
  for (int c = 0; c < 6; ++c) a[c] = A[6 * r + c];
  a[6] = -b[r];
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // the pivot: the scan of |a[r][k]| over rows k..5, strict >
    float v[6];
#pragma unroll
    for (int rr = k; rr < 6; ++rr) v[rr] = fabsf(shfl(a[k], rr));
    float best = v[k];
    int idx = k;
#pragma unroll
    for (int rr = k + 1; rr < 6; ++rr) {
      const bool take = v[rr] > best;
      best = take ? v[rr] : best;
      idx = take ? rr : idx;
    }
    // rows k and idx trade their columns k..6
    const int from = r == k ? idx : (r == idx ? k : r);
#pragma unroll
    for (int c = k; c < 7; ++c) a[c] = shfl(a[c], from);
    float prow[7];
#pragma unroll
    for (int c = k; c < 7; ++c) prow[c] = shfl(a[c], k);
    const float piv = prow[k];
    ok = ok && piv != 0.0f && finite(piv);
    if (r > k) {
      const float f = dvd(a[k], piv);
#pragma unroll
      for (int c = k + 1; c < 7; ++c) a[c] = sub(a[c], mul(f, prow[c]));
    }
  }
  // back substitution, in every lane, on the rows fetched by shuffles
  float u[6][7];
#pragma unroll
  for (int rr = 0; rr < 6; ++rr) {
#pragma unroll
    for (int c = rr; c < 7; ++c) u[rr][c] = shfl(a[c], rr);
  }
#pragma unroll
  for (int rr = 5; rr >= 0; --rr) {
    float acc = u[rr][6];
#pragma unroll
    for (int c = rr + 1; c < 6; ++c) acc = sub(acc, mul(u[rr][c], x[c]));
    x[rr] = dvd(acc, u[rr][rr]);
  }
#pragma unroll
  for (int rr = 0; rr < 6; ++rr) {
    const bool fin = finite(x[rr]);
    ok = ok && fin;
    x[rr] = fin ? x[rr] : 0.0f;
  }
  return ok;
}

// solve.euler_zyx_c; the three cosines and three sines on lanes 0..5
__device__ void euler_zyx(const float xi[6], int lane, float R[3][3],
                          float t[3]) {
  const float ang[3] = {xi[0], xi[1], xi[2]};
  const float arg = pick(ang, lane % 3);
  const float tv = lane < 3 ? cosf(arg) : sinf(arg);
  const float cx = shfl(tv, 0), cy = shfl(tv, 1), cz = shfl(tv, 2);
  const float sx = shfl(tv, 3), sy = shfl(tv, 4), sz = shfl(tv, 5);
  const float czsy = mul(cz, sy), szsy = mul(sz, sy);
  R[0][0] = mul(cz, cy);
  R[0][1] = sub(mul(czsy, sx), mul(sz, cx));
  R[0][2] = add(mul(czsy, cx), mul(sz, sx));
  R[1][0] = mul(sz, cy);
  R[1][1] = add(mul(szsy, sx), mul(cz, cx));
  R[1][2] = sub(mul(szsy, cx), mul(cz, sx));
  R[2][0] = -sy;
  R[2][1] = mul(cy, sx);
  R[2][2] = mul(cy, cx);
  t[0] = xi[3];
  t[1] = xi[4];
  t[2] = xi[5];
}

// the upper triangle of a symmetric 4x4, row by row
__device__ __forceinline__ int sym(int i, int j) {
  if (i > j) {
    const int k = i;
    i = j;
    j = k;
  }
  return i * 4 - (i * (i - 1)) / 2 + (j - i);
}

// solve.kabsch3_c on H [3][3] (row-major).  The symmetric 4x4 lives one
// entry a lane (lane e < 10 the upper triangle's entry e; lanes past 9
// a copy of entry 9 that no lane reads); R comes out in every lane.
__device__ void kabsch3(const float* H, int lane, float R[3][3]) {
  const float xx = H[0], yx = H[1], zx = H[2];
  const float xy = H[3], yy = H[4], zy = H[5];
  const float xz = H[6], yz = H[7], zz = H[8];
  float shift2 = mul(H[0], H[0]);
#pragma unroll
  for (int e = 1; e < 9; ++e) shift2 = add(shift2, mul(H[e], H[e]));
  const float shift = __fsqrt_rn(shift2);
  float m0[10];
  m0[sym(0, 0)] = add(add(add(xx, yy), zz), shift);
  m0[sym(0, 1)] = sub(yz, zy);
  m0[sym(0, 2)] = sub(zx, xz);
  m0[sym(0, 3)] = sub(xy, yx);
  m0[sym(1, 1)] = add(sub(sub(xx, yy), zz), shift);
  m0[sym(1, 2)] = add(xy, yx);
  m0[sym(1, 3)] = add(zx, xz);
  m0[sym(2, 2)] = add(sub(sub(yy, xx), zz), shift);
  m0[sym(2, 3)] = add(yz, zy);
  m0[sym(3, 3)] = add(sub(sub(zz, xx), yy), shift);
  // this lane's entry (i, j) and the lanes of row i and column j
  const int e = lane < 10 ? lane : 9;
  int ei = 0, ej = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) {
      if (sym(i, j) == e) {
        ei = i;
        ej = j;
      }
    }
  }
  int la[4], lb[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    la[l] = sym(ei, l);
    lb[l] = sym(l, ej);
  }
  float mine = pick(m0, e);
#pragma unroll 1
  for (int k = 0; k < kSquarings; ++k) {
    if (k % kRescaleEvery == 0) {
      float tr = add(add(add(shfl(mine, sym(0, 0)), shfl(mine, sym(1, 1))),
                         shfl(mine, sym(2, 2))),
                     shfl(mine, sym(3, 3)));
      tr = clamp_min(tr, kTiny);
      mine = dvd(mine, tr);
    }
    float acc = mul(shfl(mine, la[0]), shfl(mine, lb[0]));
#pragma unroll
    for (int l = 1; l < 4; ++l)
      acc = add(acc, mul(shfl(mine, la[l]), shfl(mine, lb[l])));
    mine = acc;
  }
  float diag[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) diag[i] = shfl(mine, sym(i, i));
  float best = diag[0];
  int col = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const bool take = diag[i] > best;
    best = take ? diag[i] : best;
    col = take ? i : col;
  }
  float q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int src = sym(r, 3);
#pragma unroll
    for (int j = 2; j >= 0; --j) src = col == j ? sym(r, j) : src;
    q[r] = shfl(mine, src);
  }
  const float nq = __fsqrt_rn(
      add(add(add(mul(q[0], q[0]), mul(q[1], q[1])), mul(q[2], q[2])),
          mul(q[3], q[3])));
  const bool pos = nq > 0.0f;
  const float nqc = clamp_min(nq, kTiny);
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = pos ? dvd(q[r], nqc) : (r == 0 ? 1.0f : 0.0f);
  const float w = q[0], v0 = q[1], v1 = q[2], v2 = q[3];
  const float d = sub(mul(mul(w, 2.0f), w), 1.0f);
  R[0][0] = add(d, mul(mul(v0, v0), 2.0f));
  R[0][1] = mul(sub(mul(v0, v1), mul(w, v2)), 2.0f);
  R[0][2] = mul(add(mul(v0, v2), mul(w, v1)), 2.0f);
  R[1][0] = mul(add(mul(v1, v0), mul(w, v2)), 2.0f);
  R[1][1] = add(d, mul(mul(v1, v1), 2.0f));
  R[1][2] = mul(sub(mul(v1, v2), mul(w, v0)), 2.0f);
  R[2][0] = mul(sub(mul(v2, v0), mul(w, v1)), 2.0f);
  R[2][1] = mul(add(mul(v2, v1), mul(w, v0)), 2.0f);
  R[2][2] = add(d, mul(mul(v2, v2), 2.0f));
}

// cuda_step._step_transform: T_i as (R, t), the identity on failure
template <bool kPt2pt>
__device__ void step_transform(const float* A, const float* b,
                               const float* st, int lane, float R[3][3],
                               float t[3]) {
  const float wsum = st[1];
  bool ok;
  if (kPt2pt) {
    const float H[9] = {A[0], A[1], A[2], A[6], A[7], A[8],
                        A[12], A[13], A[14]};
    ok = wsum > 2.5f;
#pragma unroll
    for (int e = 0; e < 9; ++e) ok = ok && finite(H[e]);
    kabsch3(H, lane, R);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      t[i] = sub(b[3 + i], add(add(mul(R[i][0], b[0]), mul(R[i][1], b[1])),
                               mul(R[i][2], b[2])));
  } else {
    float xi[6];
    ok = solve6(A, b, lane, xi);
    ok = ok && wsum > 5.5f;
    euler_zyx(xi, lane, R, t);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) ok = ok && finite(R[i][j]);
    ok = ok && finite(t[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = ok ? R[i][j] : (i == j ? 1.0f : 0.0f);
    t[i] = ok ? t[i] : 0.0f;
  }
}

template <bool kPt2pt>
__global__ void __launch_bounds__(kThreads)
step_update_kernel(const float* __restrict__ A, const float* __restrict__ bv,
                   const float* __restrict__ st, float* __restrict__ T,
                   int* __restrict__ it, int* __restrict__ pure_it,
                   float* __restrict__ mse_prev, float* __restrict__ mse_cur,
                   unsigned char* __restrict__ switched,
                   unsigned char* __restrict__ done, float* __restrict__ hist,
                   float* __restrict__ W, int* __restrict__ ph2,
                   float* __restrict__ pf, const float* __restrict__ hv,
                   const float* __restrict__ stop_thresh,
                   const float* __restrict__ n_src_f, int bsz, int hist_len,
                   int is_se3, int hybrid, int do_trim, int max_iters,
                   int max_se3_iters) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + threadIdx.x / 32;
  if (p >= bsz) return;   // the whole warp
  // everything the pair's step reads, before any lane writes
  float* Tp = T + 16 * p;
  float Tc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) Tc[i][j] = Tp[4 * i + j];
  }
  const float mse_val = st[8 * p];
  const float cur = mse_cur[p];
  const int it0 = it[p];
  const int pure0 = pure_it[p];
  const bool sw = switched[p] != 0;
  const bool was_done = done[p] != 0;
  const float thr = stop_thresh[p];
  const float nsf = n_src_f[p];
  float Ri[3][3], ti[3];
  step_transform<kPt2pt>(A + 36 * p, bv + 8 * p, st + 8 * p, lane, Ri, ti);
  __syncwarp();   // every lane's reads are done
  const float mse_rel = fabsf(sub(mse_val, cur));
  const int it1 = it0 + 1;
  float nw[4][4];
  // T_new = T_i @ T (T's last row is 0 0 0 1)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float acc = add(add(mul(Ri[i][0], Tc[0][j]), mul(Ri[i][1], Tc[1][j])),
                            mul(Ri[i][2], Tc[2][j]));
      nw[i][j] = j == 3 ? add(acc, ti[i]) : acc;
    }
  }
  nw[3][0] = nw[3][1] = nw[3][2] = 0.0f;
  nw[3][3] = 1.0f;
  float t2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = sub(Tc[i][j], nw[i][j]);
      t2 = (i == 0 && j == 0) ? mul(d, d) : add(t2, mul(d, d));
    }
  }
  const float t_change = __fsqrt_rn(t2);

  // phase switch / stopping
  const bool stop = it1 >= max_iters || mse_rel < thr;
  bool new_switched, new_done;
  if (hybrid) {
    new_switched = sw || it1 >= max_se3_iters || t_change < hv[3];
    new_done = sw && stop;
  } else {
    new_switched = sw;
    new_done = stop;
  }

  // done-masked state update, in place, over the lanes
  const bool active = !was_done;
  float To[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) To[4 * i + j] = active ? nw[i][j] : Tc[i][j];
  }
  const bool sw_out = active ? new_switched : sw;
  const bool done_out = was_done || new_done;
  if (lane < 16) {
    const float v = pick(To, lane);
    Tp[lane] = v;
    if (hist != nullptr) {
      const int row = it1 - 1 < hist_len - 1 ? it1 - 1 : hist_len - 1;
      hist[(static_cast<long long>(p) * hist_len + row) * 16 + lane] = v;
    }
  }
  if (lane == 16) it[p] = active ? it1 : it0;
  if (lane == 17) pure_it[p] = active && !sw ? pure0 + 1 : pure0;
  if (lane == 18 && active) mse_prev[p] = cur;
  if (lane == 19 && active) mse_cur[p] = mse_val;
  if (lane == 20) switched[p] = sw_out ? 1 : 0;
  if (lane == 21) done[p] = done_out ? 1 : 0;
  if (lane == 22) ph2[2 * p] = sw_out ? 1 : 0;
  if (lane == 23) ph2[2 * p + 1] = done_out ? 1 : 0;

  // the next step's operands (cuda_step.step_inputs_plain): W row-major,
  // entry e = 16 row + col, 8 coalesced stores a lane
  const float swf = sw_out ? 1.0f : 0.0f;
  const float f = mul(sub(1.0f, swf), hv[0]);
  const float c_s = add(swf, mul(sub(1.0f, swf), hv[1]));
  float* Wp = W + 256 * p;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = lane + 32 * k;
    const int row = e >> 4, col = e & 15;
    float v = 0.0f;
    if (row < 12 && col < 12 && row / 3 == col / 3) {
      // W[3 blk + i][3 blk + j] = f R^T or c_s R^T (icp: R^T), R^T[i][j]
      // = To[j][i]
      const float rt = pick(To, 4 * (col % 3) + row % 3);
      v = !is_se3 ? (row >= 9 ? rt : 0.0f) : mul(row < 9 ? f : c_s, rt);
    } else if (row == 12 && col >= 9 && col < 12) {
      v = pick(To, 4 * (col - 9) + 3);
    }
    Wp[e] = v;
  }
  if (lane < kPfWidth) {
    float v = 0.0f;
    if (lane < kPfT + 3) v = pick(To, 4 * (lane - kPfT) + 3);
    else if (lane == kPfBeta) v = hv[1];
    else if (lane == kPfSwitched) v = swf;
    else if (lane == kPfNsrc) v = nsf;
    else if (lane == kPfCount) v = do_trim ? floorf(mul(hv[2], nsf)) : nsf;
    else if (lane >= kPfR && lane < kPfR + 9)
      v = pick(To, 4 * ((lane - kPfR) / 3) + (lane - kPfR) % 3);
    pf[kPfWidth * p + lane] = v;
  }
}

}  // namespace

extern "C" int se3icp_step_update(
    const void* A, const void* bvec, const void* st, void* T, void* it,
    void* pure_it, void* mse_prev, void* mse_cur, void* switched, void* done,
    void* hist, void* W, void* ph2, void* pf, const void* hv,
    const void* stop_thresh, const void* n_src_f, int bsz, int hist_len,
    int pt2pt, int is_se3, int hybrid, int do_trim, int max_iters,
    int max_se3_iters, void* stream) {
  if (bsz <= 0) return (int)cudaGetLastError();
  const int grid = (bsz + kWarps - 1) / kWarps;
  if (pt2pt) {
    step_update_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)A, (const float*)bvec, (const float*)st, (float*)T,
        (int*)it, (int*)pure_it, (float*)mse_prev, (float*)mse_cur,
        (unsigned char*)switched, (unsigned char*)done, (float*)hist,
        (float*)W, (int*)ph2, (float*)pf, (const float*)hv,
        (const float*)stop_thresh, (const float*)n_src_f, bsz, hist_len,
        is_se3, hybrid, do_trim, max_iters, max_se3_iters);
  } else {
    step_update_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)A, (const float*)bvec, (const float*)st, (float*)T,
        (int*)it, (int*)pure_it, (float*)mse_prev, (float*)mse_cur,
        (unsigned char*)switched, (unsigned char*)done, (float*)hist,
        (float*)W, (int*)ph2, (float*)pf, (const float*)hv,
        (const float*)stop_thresh, (const float*)n_src_f, bsz, hist_len,
        is_se3, hybrid, do_trim, max_iters, max_se3_iters);
  }
  return (int)cudaGetLastError();
}
