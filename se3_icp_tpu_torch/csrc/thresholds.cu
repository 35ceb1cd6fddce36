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
// bit; rows >= n_valid are skipped, which leaves an all-padding lane at
// 3.0e38 and, after the clamp, at hib, as the poisoned lane ends there.
//
// What bounds it on an H100: operations.  The fold is 8 float32
// operations per (query, valid target) -- 64 * 4167^2 * 8 = 8.9e9 at the
// golden batch -- and the search 2 * 512 per probe and query (31 probes
// for three counts: 8.5e9); the inputs are 16 bytes a point.  Design:
// one warp per query, 8 queries per block.  Lane l owns the candidates
// c = l + 32 m (m = 0..15) in registers.  Targets stream through shared
// memory in tiles of 512 laid out by component, so lane l reads target
// s*512 + l + 32 m: neighbouring lanes at neighbouring addresses, no
// bank conflicts.  The group minima fold inside a lane (c + 256 is m + 8,
// c + 128 is m + 4, c + 64 is m + 2, c + 32 is m + 1); maxima and minima
// over the warp are shuffles, and a probe is 16 compares per lane and one
// __reduce_add_sync.  Every bracket value is warp-uniform.  The number
// of counts T is a template argument (1..8), so the brackets stay in
// registers: ptxas (CUDA 12.8, sm_90a) gives 64 registers and no spill
// for T = 2..4, 48 for T = 1, 79 for T = 7; T = 5 spills 4 bytes.

#include <cuda_runtime.h>

#include "dist.cuh"

namespace {

constexpr int kCand = 512;           // candidate lanes
constexpr int kPer = kCand / 32;     // candidates per lane
constexpr int kWarps = 8;            // queries per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 8;
constexpr float kInit = 3.0e38f;

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

template <int T>
__global__ void __launch_bounds__(kThreads)
thresholds_kernel(const float* __restrict__ pts_t,    // [B,3,N]
                  const float* __restrict__ tn,       // [B,N] |p|^2
                  const int* __restrict__ n_valid,    // [B]
                  const float* __restrict__ counts,   // [B,T] descending
                  const float* __restrict__ hib,      // [B]
                  float* __restrict__ out,            // [B,T,N]
                  int n) {
  __shared__ float xs[kCand], ys[kCand], zs[kCand], ts[kCand];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const bool active = qi < n;                // uniform over the warp
  const float* px = pts_t + (size_t)b * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float* tnb = tn + (size_t)b * n;
  const int nv = min(n_valid[b], n);

  float qx = 0.f, qy = 0.f, qz = 0.f, qn = 0.f;
  if (active) {
    qx = px[qi];
    qy = py[qi];
    qz = pz[qi];
    qn = tnb[qi];
  }

  // 1. candidate fold over the valid targets
  float cand[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) cand[m] = kInit;
  for (int s0 = 0; s0 < nv; s0 += kCand) {
    const int cnt = min(kCand, nv - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      xs[i] = px[s0 + i];
      ys[i] = py[s0 + i];
      zs[i] = pz[s0 + i];
      ts[i] = tnb[s0 + i];
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int c = lane + 32 * m;
        if (c < cnt) {
          cand[m] = fminf(cand[m], se3icp::shifted_d2(qx, qy, qz, xs[c], ys[c],
                                                      zs[c], ts[c]));
        }
      }
    }
  }
  if (!active) return;    // after the block's last barrier

  // un-shift to absolute squared distances, clamp to [0, hib]
  const float hb = hib[b];
  float vmin = kInit, vmax = -kInit;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const float v = fmaxf(fminf(__fadd_rn(cand[m], qn), hb), 0.f);
    cand[m] = v;
    vmin = fminf(vmin, v);
    vmax = fmaxf(vmax, v);
  }
  const float lo0 = warp_min(vmin);
  const float hi0 = warp_max(vmax);

  // 2. guaranteed bracket seeds from the group minima
  float g[kPer / 2];
  float seed[4];
#pragma unroll
  for (int m = 0; m < 8; ++m) g[m] = fminf(cand[m], cand[m + 8]);     // G=256
  seed[0] = warp_max(fmaxf(fmaxf(fmaxf(g[0], g[1]), fmaxf(g[2], g[3])),
                           fmaxf(fmaxf(g[4], g[5]), fmaxf(g[6], g[7]))));
#pragma unroll
  for (int m = 0; m < 4; ++m) g[m] = fminf(g[m], g[m + 4]);           // G=128
  seed[1] = warp_max(fmaxf(fmaxf(g[0], g[1]), fmaxf(g[2], g[3])));
#pragma unroll
  for (int m = 0; m < 2; ++m) g[m] = fminf(g[m], g[m + 2]);           // G=64
  seed[2] = warp_max(fmaxf(g[0], g[1]));
  seed[3] = warp_max(fminf(g[0], g[1]));                              // G=32

  float tg[T], lo[T], cl[T], hi[T], ch[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    tg[t] = counts[(size_t)b * T + t];
    lo[t] = lo0;
    cl[t] = 1.f;
    hi[t] = hi0;
    ch[t] = (float)kCand;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float gsz = (float)(256 >> i);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (tg[t] <= gsz && seed[i] < hi[t]) {
        hi[t] = seed[i];
        ch[t] = gsz;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) ch[t] = fmaxf(ch[t], __fadd_rn(tg[t], 1.f));

  // 3. the probe plan, largest count first
#pragma unroll
  for (int t = 0; t < T; ++t) {
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
      int c = 0;
#pragma unroll
      for (int m = 0; m < kPer; ++m) c += cand[m] <= probe ? 1 : 0;
      const float cnt = (float)__reduce_add_sync(0xffffffffu, c);
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

#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (lane == t) out[((size_t)b * T + t) * n + qi] = hi[t];
  }
}

template <int T>
cudaError_t launch(const float* pts_t, const float* tn, const int* n_valid,
                   const float* counts, const float* hib, float* out,
                   int bsz, int n, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, bsz);
  thresholds_kernel<T><<<grid, kThreads, 0, stream>>>(pts_t, tn, n_valid,
                                                      counts, hib, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int se3icp_thresholds(const void* pts_t, const void* tn,
                                 const void* n_valid, const void* counts,
                                 const void* hib, void* out, int bsz, int n,
                                 int t, void* stream) {
  if (bsz <= 0 || n <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || t < 1 || t > kMaxT) return (int)cudaErrorInvalidValue;
  const float* p = (const float*)pts_t;
  const float* tq = (const float*)tn;
  const int* nv = (const int*)n_valid;
  const float* c = (const float*)counts;
  const float* h = (const float*)hib;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 1: return (int)launch<1>(p, tq, nv, c, h, o, bsz, n, s);
    case 2: return (int)launch<2>(p, tq, nv, c, h, o, bsz, n, s);
    case 3: return (int)launch<3>(p, tq, nv, c, h, o, bsz, n, s);
    case 4: return (int)launch<4>(p, tq, nv, c, h, o, bsz, n, s);
    case 5: return (int)launch<5>(p, tq, nv, c, h, o, bsz, n, s);
    case 6: return (int)launch<6>(p, tq, nv, c, h, o, bsz, n, s);
    case 7: return (int)launch<7>(p, tq, nv, c, h, o, bsz, n, s);
    default: return (int)launch<8>(p, tq, nv, c, h, o, bsz, n, s);
  }
}
