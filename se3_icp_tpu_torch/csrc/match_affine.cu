// Fused correspondence search of the registration loop:
//   q = feat @ W (built in the kernel), 1-NN over the phase-selected
//   target embedding by the shifted distance -2 q.t + |t|^2, matched
//   payload row out (transposed), exact ties averaged.
//
// Replaces the TPU kernel se3_icp_tpu/ops/pallas_knn.py
// `_kernel_match_affine` (wrapper `nn_match_affine`).  That kernel
// splits every float32 operand into three bf16 limbs to get float32
// products out of a bf16 matrix unit, carries |t|^2 as limb columns,
// replaces the gather of the winning row by a min-mask matmul and the
// bound check by poisoned coordinates.  None of that is needed here:
// float32 FMAs on the CUDA cores are exact-class, a thread can keep a
// running minimum and gather one row at the end.
//
// What bounds it on an H100: operations.  One call is B*Nq*Nt*12 FMAs
// (64*4608*4608*12 = 1.6e10) against a few tens of MB of inputs that
// are read once, so the float32 FMA rate (67 TFLOP/s), not the memory,
// sets the least time (~0.5 ms at the golden batch).  Design: grid
// (query tiles, B); one query per thread, its 12-D embedding held in
// registers pre-multiplied by -2; target tiles staged through shared
// memory and read by every thread at the same address (a broadcast, no
// bank conflicts); per target 12 FMAs plus a compare.  The thread keeps
// (min, first two indices attaining it, tie count); one or two tied
// rows -- duplicates included -- are gathered directly, three or more
// (practically never) take a second pass over the targets.  A block
// returns at once when its pair's done flag is set.  Tensor cores (a
// 3xTF32 or bf16-limb split through wgmma) are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 128;      // targets per shared-memory tile
constexpr int kEmb = 12;        // embedding width
constexpr int kFeat = 16;       // feature width (rows of W)
constexpr float kBig = 3.4e38f;

// The one definition of the shifted distance: both passes must produce
// the same bits for the same (query, target).
__device__ __forceinline__ float shifted_d2(const float (&q2)[kEmb],
                                            const float4 a, const float4 b,
                                            const float4 c, float tn) {
  float d = tn;
  d = fmaf(q2[0], a.x, d);
  d = fmaf(q2[1], a.y, d);
  d = fmaf(q2[2], a.z, d);
  d = fmaf(q2[3], a.w, d);
  d = fmaf(q2[4], b.x, d);
  d = fmaf(q2[5], b.y, d);
  d = fmaf(q2[6], b.z, d);
  d = fmaf(q2[7], b.w, d);
  d = fmaf(q2[8], c.x, d);
  d = fmaf(q2[9], c.y, d);
  d = fmaf(q2[10], c.z, d);
  d = fmaf(q2[11], c.w, d);
  return d;
}

__global__ void __launch_bounds__(kThreads)
match_affine_kernel(const float* __restrict__ feat,     // [B,Nq,16]
                    const float* __restrict__ w,        // [B,16,16]
                    const float* __restrict__ emb,      // [B,2,Nt,12]
                    const float* __restrict__ tn,       // [B,2,Nt]
                    const float* __restrict__ payload,  // [B,Nt,P]
                    const int* __restrict__ n_tgt,      // [B]
                    const int* __restrict__ phase,      // [B,2]
                    float* __restrict__ d2_out,         // [B,Nq]
                    float* __restrict__ matched_t,      // [B,P,Nq]
                    int nq, int nt, int p) {
  const int b = blockIdx.y;
  if (phase[2 * b + 1] != 0) return;   // done pair: outputs unspecified
  const int ph = phase[2 * b] != 0 ? 1 : 0;
  const int n = min(n_tgt[b], nt);
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;

  __shared__ float w_s[kFeat * kEmb];
  __shared__ float4 t_s[kTile * 3];
  __shared__ float tn_s[kTile];

  for (int i = threadIdx.x; i < kFeat * kEmb; i += kThreads) {
    w_s[i] = w[(size_t)b * kFeat * kFeat + (i / kEmb) * kFeat + (i % kEmb)];
  }
  __syncthreads();

  float q2[kEmb];
#pragma unroll
  for (int k = 0; k < kEmb; ++k) q2[k] = 0.f;
  if (active) {
    const float4* f4 =
        reinterpret_cast<const float4*>(feat + ((size_t)b * nq + qi) * kFeat);
    float f[kFeat];
#pragma unroll
    for (int i = 0; i < kFeat / 4; ++i) {
      const float4 v = f4[i];
      f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kEmb; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kFeat; ++i) acc = fmaf(f[i], w_s[i * kEmb + k], acc);
      q2[k] = -2.f * acc;
    }
  }

  const float4* emb4 =
      reinterpret_cast<const float4*>(emb + ((size_t)b * 2 + ph) * nt * kEmb);
  const float* tn_b = tn + ((size_t)b * 2 + ph) * nt;

  float best = kBig;
  int i0 = 0, i1 = 0, cnt = 1;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int m = min(kTile, n - t0);
    __syncthreads();               // previous tile fully consumed
    for (int i = threadIdx.x; i < m * 3; i += kThreads) {
      t_s[i] = emb4[(size_t)t0 * 3 + i];
    }
    for (int i = threadIdx.x; i < m; i += kThreads) tn_s[i] = tn_b[t0 + i];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float d = shifted_d2(q2, t_s[3 * j], t_s[3 * j + 1],
                                 t_s[3 * j + 2], tn_s[j]);
      if (d < best) {
        best = d; i0 = t0 + j; cnt = 1;
      } else if (d == best) {
        if (cnt == 1) i1 = t0 + j;
        ++cnt;
      }
    }
  }
  if (!active) return;

  d2_out[(size_t)b * nq + qi] = best;
  const float* pay_b = payload + (size_t)b * nt * p;
  float* out = matched_t + (size_t)b * p * nq + qi;
  if (cnt == 1) {
    for (int c = 0; c < p; ++c) out[(size_t)c * nq] = pay_b[(size_t)i0 * p + c];
  } else if (cnt == 2) {
    for (int c = 0; c < p; ++c) {
      out[(size_t)c * nq] =
          (pay_b[(size_t)i0 * p + c] + pay_b[(size_t)i1 * p + c]) * 0.5f;
    }
  } else {
    // three or more targets at exactly the minimum: sum their rows in a
    // second pass (same distance bits by construction), then average
    for (int c = 0; c < p; ++c) out[(size_t)c * nq] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float d = shifted_d2(q2, emb4[(size_t)j * 3], emb4[(size_t)j * 3 + 1],
                                 emb4[(size_t)j * 3 + 2], tn_b[j]);
      if (d == best) {
        for (int c = 0; c < p; ++c) out[(size_t)c * nq] += pay_b[(size_t)j * p + c];
      }
    }
    const float inv = 1.f / (float)cnt;
    for (int c = 0; c < p; ++c) out[(size_t)c * nq] *= inv;
  }
}

}  // namespace

extern "C" int se3icp_match_affine(const void* feat, const void* w,
                                   const void* emb, const void* tn,
                                   const void* payload, const void* n_tgt,
                                   const void* phase, void* d2_out,
                                   void* matched_t, int bsz, int nq, int nt,
                                   int p, void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((nq + kThreads - 1) / kThreads, bsz);
  match_affine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)w, (const float*)emb, (const float*)tn,
      (const float*)payload, (const int*)n_tgt, (const int*)phase,
      (float*)d2_out, (float*)matched_t, nq, nt, p);
  return (int)cudaGetLastError();
}
