// Fused correspondence search of the registration loop (K4):
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
// What bounds it on an H100: the float32 FMA issue rate.  One call is
// B*Nq*Nt*12 FMAs in the SE(3) phase (64*4608*4167*12 = 1.5e10 at the
// golden batch, ~0.44 ms at 67 TFLOP/s) and 3 FMAs a pair in the R3
// phase, against a few MB of inputs read once.  Every instruction that
// is not an FMA takes an FMA's issue slot, so the design makes the FMAs
// nearly all of what is issued:
//   * register tiling: a thread holds kR queries (-2q, 12 floats each,
//     and the tie state in registers) and applies every target row it
//     reads from shared memory to all of them, so one broadcast load
//     feeds 12 kR FMAs;
//   * cheap tie tracking: per step of kU targets (kU3 in the R3 phase) a
//     query folds its distances into one minimum (a min a pair); only
//     when some query of the warp reaches its running minimum (one vote,
//     a uniform branch) do the queries note, by selects, the first step
//     where their running minimum was reached and the last step that
//     reached it again.  Only the targets of those steps (usually one
//     step) can lie at exactly the final minimum; at the end the thread
//     recomputes them, with the same chain, for the lowest index and the
//     tied rows.  Index bookkeeping per target, behind a branch per query
//     and step, cost more: with a warp's 32 kR queries in no spatial
//     order, some lane improves its minimum in many of the steps;
//   * phase specialisation: a pair in the R3 phase (phase[b,0] = 1) has
//     an exactly zero rotation block in its phase-B targets, so its block
//     runs a 3-FMA chain over columns 9-11 and stages only those columns.
//     The 12-FMA chain adds nine exact zeros first (fma(q, +-0, d) = d
//     for the |t|^2 >= +0 it starts from), so both chains give the same
//     bits.  The branch is uniform: a block serves one pair;
//   * asynchronous tiles: target tiles (embedding rows and |t|^2) are
//     double-buffered in shared memory with cp.async, the next tile
//     loading while the current one is consumed.  Rows past n_tgt are
//     staged as a zero row with |t|^2 = +inf, which no query matches, so
//     the inner loop has no bound check.
// The distance of a (query, target) has the same bits wherever it is
// computed (one FMA chain, one order), which the recomputation and the
// tie average rely on: one tied row or two -- duplicates included -- are
// gathered directly, three or more are summed in one more walk over the
// same steps.
// A block returns at once when its pair's done flag is set.  What holds
// it at about twice its bound on an H100 (tools/kernel_tiling_sweep.py):
// 128 registers a thread leave 16 warps an SM, and the card issues about
// half an instruction a cycle a scheduler on this loop, where an FMA-only
// loop reaches 97% of 67 TFLOP/s (tools/fma_peak.py).  Tensor cores (a
// 3xTF32 split through wgmma) would change the distance bits; they are
// left for a later change.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;             // threads a block
constexpr int kR = 4;                    // queries a thread
constexpr int kQueries = kThreads * kR;  // queries a block
constexpr int kMinBlocks = 8;            // resident blocks an SM: <= 128 registers
constexpr int kTile = 128;               // targets a shared-memory tile
constexpr int kU = 4;                    // targets a step, SE(3) phase
constexpr int kU3 = 8;                   // targets a step, R3 phase
constexpr int kEmb = 12;                 // embedding width
constexpr int kFeat = 16;                // feature width (rows of W)
constexpr float kBig = 3.4e38f;          // distance of "no valid target"
static_assert(kTile % kU == 0 && kTile % kU3 == 0, "whole steps a tile");

struct Best {
  float d;      // running minimum
  int first;    // first target of the step where it was first reached
  int last;     // first target of the last step that reached it
};

// The one definition of the shifted distance in the SE(3) phase: every
// pass must produce the same bits for the same (query, target).
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

// The same chain in the R3 phase, where a, b and c.x are exact zeros:
// the terms that remain, in the same order.
__device__ __forceinline__ float shifted_d2_r3(const float (&q2)[kEmb],
                                               const float4 c, float tn) {
  float d = tn;
  d = fmaf(q2[9], c.y, d);
  d = fmaf(q2[10], c.z, d);
  d = fmaf(q2[11], c.w, d);
  return d;
}

// The chain of the pair's phase on target j, read from device memory.
__device__ __forceinline__ float d2_at(const float (&q2)[kEmb], bool r3,
                                       const float4* emb4, const float* tn_b,
                                       int j) {
  const float4* row = emb4 + (size_t)j * 3;
  return r3 ? shifted_d2_r3(q2, row[2], tn_b[j])
            : shifted_d2(q2, row[0], row[1], row[2], tn_b[j]);
}

// Stage targets [t0, t0 + kTile) into one buffer: all three float4s of a
// row in the SE(3) phase, the translation float4 (columns 8-11) in the
// R3 phase.  Rows at or past n: zeros and |t|^2 = +inf.
template <bool kR3>
__device__ __forceinline__ void stage(float4* t_s, float* tn_s,
                                      const float4* emb4, const float* tn_b,
                                      int t0, int n) {
  constexpr int kVec = kR3 ? 1 : 3;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int row = i / kVec;
    if (t0 + row < n) {
      const int v = kR3 ? 2 : i - row * kVec;
      __pipeline_memcpy_async(&t_s[i], &emb4[(size_t)(t0 + row) * 3 + v],
                              sizeof(float4));
    } else {
      t_s[i] = float4{0.f, 0.f, 0.f, 0.f};
    }
  }
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    if (t0 + i < n) {
      __pipeline_memcpy_async(&tn_s[i], &tn_b[t0 + i], sizeof(float));
    } else {
      tn_s[i] = __int_as_float(0x7f800000);   // +inf
    }
  }
  __pipeline_commit();
}

// One staged tile against the thread's kR queries, in steps of U targets.
template <bool kR3, int U = kR3 ? kU3 : kU>
__device__ __forceinline__ void scan_tile(const float4* __restrict__ t_s,
                                          const float* __restrict__ tn_s,
                                          const float (&q2)[kR][kEmb],
                                          Best (&st)[kR], int t0) {
#pragma unroll 1
  for (int j = 0; j < kTile; j += U) {
    float d[U][kR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float tn = tn_s[j + u];
      if (kR3) {
        const float4 c = t_s[j + u];
#pragma unroll
        for (int r = 0; r < kR; ++r) d[u][r] = shifted_d2_r3(q2[r], c, tn);
      } else {
        const float4 a = t_s[3 * (j + u)];
        const float4 b = t_s[3 * (j + u) + 1];
        const float4 c = t_s[3 * (j + u) + 2];
#pragma unroll
        for (int r = 0; r < kR; ++r) d[u][r] = shifted_d2(q2[r], a, b, c, tn);
      }
    }
    float m[kR];
    bool hit = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m[r] = d[0][r];
#pragma unroll
      for (int u = 1; u < U; ++u) m[r] = fminf(m[r], d[u][r]);
      hit |= m[r] <= st[r].d;
    }
    if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        st[r].first = m[r] < st[r].d ? t0 + j : st[r].first;
        st[r].last = m[r] <= st[r].d ? t0 + j : st[r].last;
        st[r].d = fminf(st[r].d, m[r]);
      }
    }
  }
}

// Every valid target of the pair, tile by tile, the next tile loading
// while this one is scanned.
template <bool kR3>
__device__ __forceinline__ void search(float4 (&t_s)[2][kTile * 3],
                                       float (&tn_s)[2][kTile],
                                       const float4* emb4, const float* tn_b,
                                       int n, const float (&q2)[kR][kEmb],
                                       Best (&st)[kR]) {
  const int n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0) stage<kR3>(t_s[0], tn_s[0], emb4, tn_b, 0, n);
  for (int k = 0; k < n_tiles; ++k) {
    const int cur = k & 1;
    if (k + 1 < n_tiles) {
      stage<kR3>(t_s[cur ^ 1], tn_s[cur ^ 1], emb4, tn_b, (k + 1) * kTile, n);
      __pipeline_wait_prior(1);     // this thread's copies of tile k landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                // ... and every thread's
    scan_tile<kR3>(t_s[cur], tn_s[cur], q2, st, k * kTile);
    __syncthreads();                // consumed before it is restaged
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  const bool r3 = phase[2 * b] != 0;
  const int ph = r3 ? 1 : 0;
  const int n = min(max(n_tgt[b], 0), nt);
  // query r of this thread: q0 + r * kThreads (coalesced over the block)
  const int q0 = blockIdx.x * kQueries + threadIdx.x;

  __shared__ float w_s[kFeat * kEmb];
  __shared__ float4 t_s[2][kTile * 3];
  __shared__ float tn_s[2][kTile];

  for (int i = threadIdx.x; i < kFeat * kEmb; i += kThreads) {
    w_s[i] = w[(size_t)b * kFeat * kFeat + (i / kEmb) * kFeat + (i % kEmb)];
  }
  __syncthreads();

  float q2[kR][kEmb];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + r * kThreads;
    float f[kFeat];
#pragma unroll
    for (int i = 0; i < kFeat; ++i) f[i] = 0.f;
    if (qi < nq) {
      const float4* f4 = reinterpret_cast<const float4*>(
          feat + ((size_t)b * nq + qi) * kFeat);
#pragma unroll
      for (int i = 0; i < kFeat / 4; ++i) {
        const float4 v = f4[i];
        f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z;
        f[4 * i + 3] = v.w;
      }
    }
#pragma unroll
    for (int k = 0; k < kEmb; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kFeat; ++i) acc = fmaf(f[i], w_s[i * kEmb + k], acc);
      q2[r][k] = -2.f * acc;
    }
  }

  const float4* emb4 =
      reinterpret_cast<const float4*>(emb + ((size_t)b * 2 + ph) * nt * kEmb);
  const float* tn_b = tn + ((size_t)b * 2 + ph) * nt;
  Best st[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) st[r] = Best{kBig, 0, -kU - kU3};
  if (r3) {
    search<true>(t_s, tn_s, emb4, tn_b, n, q2, st);
  } else {
    search<false>(t_s, tn_s, emb4, tn_b, n, q2, st);
  }

  // unrolled: q2 and st are indexed by constants only, so they stay in
  // registers
  const float* pay_b = payload + (size_t)b * nt * p;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int qi = q0 + r * kThreads;
    if (qi >= nq) continue;
    const Best s = st[r];
    d2_out[(size_t)b * nq + qi] = s.d;
    // the targets at exactly the minimum lie in the steps s.first ..
    // s.last; none when no target was valid (row 0 then, d2 = kBig)
    const int end = min(s.last + (r3 ? kU3 : kU), n);
    int i0 = 0, i1 = 0, cnt = 0;
    for (int j = s.first; j < end; ++j) {
      if (d2_at(q2[r], r3, emb4, tn_b, j) == s.d) {
        if (cnt == 0) i0 = j;
        if (cnt == 1) i1 = j;
        ++cnt;
      }
    }
    float* out = matched_t + (size_t)b * p * nq + qi;
    if (cnt <= 1) {
      for (int c = 0; c < p; ++c) out[(size_t)c * nq] = pay_b[(size_t)i0 * p + c];
    } else if (cnt == 2) {
      for (int c = 0; c < p; ++c) {
        out[(size_t)c * nq] =
            (pay_b[(size_t)i0 * p + c] + pay_b[(size_t)i1 * p + c]) * 0.5f;
      }
    } else {
      // three or more: sum their rows in index order, then average
      for (int c = 0; c < p; ++c) out[(size_t)c * nq] = 0.f;
      for (int j = s.first; j < end; ++j) {
        if (d2_at(q2[r], r3, emb4, tn_b, j) == s.d) {
          for (int c = 0; c < p; ++c) out[(size_t)c * nq] += pay_b[(size_t)j * p + c];
        }
      }
      const float inv = 1.f / (float)cnt;
      for (int c = 0; c < p; ++c) out[(size_t)c * nq] *= inv;
    }
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
  const dim3 grid((nq + kQueries - 1) / kQueries, bsz);
  match_affine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)w, (const float*)emb, (const float*)tn,
      (const float*)payload, (const int*)n_tgt, (const int*)phase,
      (float*)d2_out, (float*)matched_t, nq, nt, p);
  return (int)cudaGetLastError();
}
