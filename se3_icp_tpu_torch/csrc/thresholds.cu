// Sort-free neighbourhood thresholds (K1): per query and per requested
// self-inclusive count c, a squared-distance threshold whose ball holds
// about c points of the cloud.
//
// Replaces the TPU kernel se3_icp_tpu/ops/pallas_moments.py
// `_kernel_thresholds` (l.457; wrapper `neighborhood_thresholds_batched`
// l.592), with the same semantics:
//   1. candidate fold: the shifted distances r = |t|^2 - 2 q.t of the
//      valid targets j are folded into 512 candidate lanes by minimum
//      (lane = j mod 512, initial value 3.0e38), then un-shifted (+|q|^2),
//      clamped to the cloud's bound hib = 4 max|p|^2 + 1 and to >= 0;
//   2. bracket seeds: lo0/hi0 are the min/max over the candidates; the
//      max over G groups of the group minima (G = 256, 128, 64, 32,
//      contiguous-half folding) has candidate count >= G and replaces a
//      count's upper bracket where c <= G and it is lower;
//   3. per count, in DESCENDING order, a fixed probe plan (16, 9, 6, then
//      8 each) of rank-secant (probe index % 4 == 0), geometric (== 2)
//      and arithmetic bisection; every probe's candidate count updates
//      the brackets of ALL counts.  The result is the upper bracket.
// The TPU kernel needed a three-limb bf16 split of the positions to get
// float32 distances out of its matrix unit, and poisoned coordinates for
// padded rows.  Here the distance is float32 on the CUDA cores, written
// with explicitly rounded intrinsics (dist.cuh) in the plain version's
// order, so this kernel's thresholds equal the plain version's bit for
// bit; rows >= n_valid never lower a candidate, which leaves an
// all-padding lane at 3.0e38 and, after the clamp, at hib, as the
// poisoned lane ends there.
//
// What bounds it on an H100: operations, none of them an FMA (every
// step is explicitly rounded), so they issue at the float32 rate of
// 33.5 T op/s, half the 67 TFLOP/s that counts an FMA as two.  The fold
// is 8 operations per (query, valid target) -- 64 * 4167^2 * 8 = 8.9e9 at
// the golden batch -- and the search 2 * 512 per probe and query (31
// probes for three counts: 8.5e9), ~0.52 ms; the inputs are 16 bytes a
// point.  Design: kQ queries per warp, 8 warps a block.  Lane l owns the
// candidates c = l + 32 m (m = 0..15) of each of its warp's kQ queries
// in registers.  Targets stream through shared memory in tiles of 512
// laid out by component, double-buffered with cp.async (the next tile
// loads while this one is folded); lane l reads target s*512 + l + 32 m
// once (neighbouring lanes at neighbouring addresses, no bank conflicts)
// and folds it into the candidates of all kQ queries, so a shared load
// feeds 8 kQ operations.  Rows past n_valid are staged as the origin
// with |t|^2 = +inf: their r is +inf and leaves every lane as it was, so
// the fold has no bound check.  The group minima fold inside a lane
// (c + 256 is m + 8, c + 128 is m + 4, c + 64 is m + 2, c + 32 is m + 1);
// maxima and minima over the warp are shuffles.  The search runs the kQ
// queries' probe chains side by side: lane l keeps the brackets of query
// l mod kQ (every bracket value is uniform over the lanes of one query),
// so the scalar probe arithmetic is issued once for all kQ queries; each
// probe is shuffled to the warp, counted against that query's 16
// candidates a lane (in float: a compare and an add each) and summed by
// one __reduce_add_sync a query.  The number of counts T is a template
// argument (1..8) and the probe plan is unrolled, so the brackets stay in
// registers and each probe's kind is known at compile time.  What holds
// it at about twice its bound on an H100 (tools/kernel_tiling_sweep.py
// measures it): the fold issues ~600 instructions per 512 (query,
// target) pairs of a warp, about what it must, but the 64 candidates a
// lane take 128 registers, so 16 warps an SM are all that run, and the
// probe chain -- probe, shuffle, count, reduce, brackets -- is serial
// within a warp.
//
// Row slices (`se3icp_thresholds_rows`): the queries may be the rows
// [q0, q0 + nq) of the cloud, searched against the whole cloud, with the
// result written as [B, T, nq]; the points route of a registration
// sharded over a process group (parallel/points.py) gives each rank its
// own rows, the counterpart of the `queries=` path of the TPU kernel.  A
// query's thresholds depend on its own position and the cloud only (hib
// and the counts are the cloud's, clamped by the wrapper), so a slice's
// rows are the whole call's rows, bit for bit.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "dist.cuh"

namespace {

constexpr int kCand = 512;                  // candidate lanes
constexpr int kPer = kCand / 32;            // candidates per lane
constexpr int kQ = 4;                       // queries per warp
constexpr int kWarps = 8;                   // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQueries = kWarps * kQ;  // queries per block
constexpr int kMaxT = 8;
constexpr float kInit = 3.0e38f;
static_assert(32 % kQ == 0 && kMaxT * kQ <= 32,
              "lane l keeps query l mod kQ; lane kQ t + q writes count t");

// probes per DESCENDING-sorted count (pallas_moments._THR_PLAN)
__host__ __device__ constexpr int plan_steps(int t) {
  return t == 0 ? 16 : (t == 1 ? 9 : (t == 2 ? 6 : 8));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// v[q] of the lane's own query q = my, by selects (a register array
// indexed by a run-time value would go to local memory)
__device__ __forceinline__ float pick(const float (&v)[kQ], int my) {
  float r = v[0];
#pragma unroll
  for (int q = 1; q < kQ; ++q) r = my == q ? v[q] : r;
  return r;
}

// Stage targets [s0, s0 + kCand) into one buffer; rows at or past nv:
// the origin with |t|^2 = +inf.
__device__ __forceinline__ void stage(float* xs, float* ys, float* zs,
                                      float* ts, const float* px,
                                      const float* py, const float* pz,
                                      const float* tnb, int s0, int nv) {
  for (int i = threadIdx.x; i < kCand; i += kThreads) {
    if (s0 + i < nv) {
      __pipeline_memcpy_async(&xs[i], &px[s0 + i], sizeof(float));
      __pipeline_memcpy_async(&ys[i], &py[s0 + i], sizeof(float));
      __pipeline_memcpy_async(&zs[i], &pz[s0 + i], sizeof(float));
      __pipeline_memcpy_async(&ts[i], &tnb[s0 + i], sizeof(float));
    } else {
      xs[i] = 0.f;
      ys[i] = 0.f;
      zs[i] = 0.f;
      ts[i] = __int_as_float(0x7f800000);   // +inf
    }
  }
  __pipeline_commit();
}

template <int T>
__global__ void __launch_bounds__(kThreads)
thresholds_kernel(const float* __restrict__ pts_t,    // [B,3,N]
                  const float* __restrict__ tn,       // [B,N] |p|^2
                  const int* __restrict__ n_valid,    // [B]
                  const float* __restrict__ counts,   // [B,T] descending
                  const float* __restrict__ hib,      // [B]
                  float* __restrict__ out,            // [B,T,nq]
                  int n, int q0, int nq) {
  __shared__ float xs[2][kCand], ys[2][kCand], zs[2][kCand], ts[2][kCand];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l0 = (blockIdx.x * kWarps + warp) * kQ;   // the warp's queries
  const int my = lane & (kQ - 1);                     // the lane's own query
  const float* px = pts_t + (size_t)b * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* tnb = tn + (size_t)b * n;
  const int nv = min(n_valid[b], n);

  float qx[kQ], qy[kQ], qz[kQ], qn[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const bool active = l0 + q < nq;   // uniform over the warp
    const int i = q0 + l0 + q;         // the query's row of the cloud
    qx[q] = active ? px[i] : 0.f;
    qy[q] = active ? py[i] : 0.f;
    qz[q] = active ? pz[i] : 0.f;
    qn[q] = active ? tnb[i] : 0.f;
  }

  // 1. candidate fold over the valid targets, kQ queries at once
  float cand[kQ][kPer];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) cand[q][m] = kInit;
  }
  const int n_tiles = nv > 0 ? (nv + kCand - 1) / kCand : 0;
  if (n_tiles > 0) {
    stage(xs[0], ys[0], zs[0], ts[0], px, py, pz, tnb, 0, nv);
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    if (k + 1 < n_tiles) {
      stage(xs[cur ^ 1], ys[cur ^ 1], zs[cur ^ 1], ts[cur ^ 1], px, py, pz,
            tnb, (k + 1) * kCand, nv);
      __pipeline_wait_prior(1);     // this thread's copies of tile k landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                // ... and every thread's
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int c = lane + 32 * m;
      const float x = xs[cur][c], y = ys[cur][c], z = zs[cur][c];
      const float t = ts[cur][c];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        cand[q][m] = fminf(cand[q][m],
                           se3icp::shifted_d2(qx[q], qy[q], qz[q], x, y, z, t));
      }
    }
    __syncthreads();                // consumed before it is restaged
  }

  // un-shift to absolute squared distances, clamp to [0, hib]; the
  // bracket bounds and the guaranteed seeds from the group minima
  const float hb = hib[b];
  float lo0[kQ], hi0[kQ], seed[4][kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    float vmin = kInit, vmax = -kInit;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const float v = fmaxf(fminf(__fadd_rn(cand[q][m], qn[q]), hb), 0.f);
      cand[q][m] = v;
      vmin = fminf(vmin, v);
      vmax = fmaxf(vmax, v);
    }
    lo0[q] = warp_min(vmin);
    hi0[q] = warp_max(vmax);
    float g[kPer / 2];
#pragma unroll
    for (int m = 0; m < 8; ++m) g[m] = fminf(cand[q][m], cand[q][m + 8]);  // G=256
    seed[0][q] = warp_max(fmaxf(fmaxf(fmaxf(g[0], g[1]), fmaxf(g[2], g[3])),
                                fmaxf(fmaxf(g[4], g[5]), fmaxf(g[6], g[7]))));
#pragma unroll
    for (int m = 0; m < 4; ++m) g[m] = fminf(g[m], g[m + 4]);             // G=128
    seed[1][q] = warp_max(fmaxf(fmaxf(g[0], g[1]), fmaxf(g[2], g[3])));
#pragma unroll
    for (int m = 0; m < 2; ++m) g[m] = fminf(g[m], g[m + 2]);             // G=64
    seed[2][q] = warp_max(fmaxf(g[0], g[1]));
    seed[3][q] = warp_max(fminf(g[0], g[1]));                             // G=32
  }

  // 2. the lane's own query's brackets
  float tg[T], lo[T], cl[T], hi[T], ch[T];
  const float my_lo0 = pick(lo0, my), my_hi0 = pick(hi0, my);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    tg[t] = counts[(size_t)b * T + t];
    lo[t] = my_lo0;
    cl[t] = 1.f;
    hi[t] = my_hi0;
    ch[t] = (float)kCand;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float gsz = (float)(256 >> i);
    const float sd = pick(seed[i], my);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (tg[t] <= gsz && sd < hi[t]) {
        hi[t] = sd;
        ch[t] = gsz;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) ch[t] = fmaxf(ch[t], __fadd_rn(tg[t], 1.f));

  // 3. the probe plan, largest count first, the kQ queries side by side
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int s = 0; s < plan_steps(t); ++s) {
      const int kind = s & 3;
      const float dlt = __fsub_rn(hi[t], lo[t]);
      float probe;
      if (kind == 0) {          // linear rank-secant
        const float den = fmaxf(__fsub_rn(ch[t], cl[t]), 1.f);
        const float fr = fminf(fmaxf(__fdiv_rn(__fsub_rn(tg[t], cl[t]), den),
                                     0.02f), 0.98f);
        probe = __fadd_rn(lo[t], __fmul_rn(fr, dlt));
      } else if (kind == 2) {   // geometric bisection
        probe = __fsqrt_rn(__fmul_rn(fmaxf(lo[t], __fmul_rn(hi[t], 1e-9f)),
                                     hi[t]));
      } else {                  // arithmetic bisection
        probe = __fadd_rn(lo[t], __fmul_rn(0.5f, dlt));
      }
      float cnt_q[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float pq = __shfl_sync(0xffffffffu, probe, q);   // lane q: query q
        // counted in float (exact: at most 16 a lane), one add a compare
        float c = 0.f;
#pragma unroll
        for (int m = 0; m < kPer; ++m) c += cand[q][m] <= pq ? 1.f : 0.f;
        cnt_q[q] = (float)__reduce_add_sync(0xffffffffu, (int)c);
      }
      const float cnt = pick(cnt_q, my);
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const bool pred = cnt >= tg[u];
        if (pred && probe < hi[u]) {
          hi[u] = probe;
          ch[u] = cnt;
        }
        if (!pred && probe > lo[u]) {
          lo[u] = probe;
          cl[u] = cnt;
        }
      }
    }
  }

  // lane kQ t + q writes count t of query q
  const int qi = l0 + my;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (lane / kQ == t && qi < nq) out[((size_t)b * T + t) * nq + qi] = hi[t];
  }
}

template <int T>
cudaError_t launch(const float* pts_t, const float* tn, const int* n_valid,
                   const float* counts, const float* hib, float* out,
                   int bsz, int n, int q0, int nq, cudaStream_t stream) {
  const dim3 grid((nq + kBlockQueries - 1) / kBlockQueries, bsz);
  thresholds_kernel<T><<<grid, kThreads, 0, stream>>>(
      pts_t, tn, n_valid, counts, hib, out, n, q0, nq);
  return cudaGetLastError();
}

}  // namespace

// The queries are the rows [q0, q0 + nq) of each cloud; out is [B,T,nq].
extern "C" int se3icp_thresholds_rows(const void* pts_t, const void* tn,
                                      const void* n_valid, const void* counts,
                                      const void* hib, void* out, int bsz,
                                      int n, int q0, int nq, int t,
                                      void* stream) {
  if (bsz <= 0 || n <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || t < 1 || t > kMaxT || q0 < 0 || nq > n - q0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* p = (const float*)pts_t;
  const float* tq = (const float*)tn;
  const int* nv = (const int*)n_valid;
  const float* c = (const float*)counts;
  const float* h = (const float*)hib;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 1: return (int)launch<1>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    case 2: return (int)launch<2>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    case 3: return (int)launch<3>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    case 4: return (int)launch<4>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    case 5: return (int)launch<5>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    case 6: return (int)launch<6>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    case 7: return (int)launch<7>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
    default: return (int)launch<8>(p, tq, nv, c, h, o, bsz, n, q0, nq, s);
  }
}

// Every row of each cloud: out is [B,T,N].
extern "C" int se3icp_thresholds(const void* pts_t, const void* tn,
                                 const void* n_valid, const void* counts,
                                 const void* hib, void* out, int bsz, int n,
                                 int t, void* stream) {
  return se3icp_thresholds_rows(pts_t, tn, n_valid, counts, hib, out, bsz, n,
                                0, n, t, stream);
}
