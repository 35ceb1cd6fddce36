// Exact 1-NN of float32 points: for every query, the index of the
// nearest valid target (lowest index on ties) and its squared distance,
// and for the match variants the nearest target's payload row.
//
// Replaces four TPU kernels of se3_icp_tpu/ops/pallas_knn.py, which all
// compute this one function:
//   K6 `_kernel_batched`      (wrapper `nn_argmin_pallas_batched`)
//   K9 `_kernel`              (wrapper `nn_argmin_pallas`, unbatched;
//                              here the same kernel launched at B = 1)
//   K7 `_kernel_match`        (wrapper `nn_match_pallas_batched`)
//   K8 `_kernel_match_packed` (wrapper `nn_match_packed`: targets packed
//                              once in both phases, one chosen per pair)
// Those kernels split every float32 operand into three bf16 limbs so the
// matrix unit yields float32-exact products, poison invalid targets with
// huge coordinates instead of a bound check, add |q|^2 back after the
// reduction and pick the winning payload row with a one-hot matmul.  None
// of that is needed here: float32 FMAs on the CUDA cores are exact-class,
// the target loop simply stops at n_targets[b], and a thread gathers its
// winning row once, at the end.  K8 takes no tie-average (that is K4's
// contract, csrc/match_affine.cu): every variant keeps the lowest index.
//
// What bounds it on an H100: operations.  A call is B*Nq*Nt pairs, each
// D FMAs on the shifted distance |t|^2 - 2 q.t plus a compare:
// B*Nq*Nt*(2D+2) float32 operations against 67 TFLOP/s, while the inputs
// (a few MB) are read once.  At 64 x 4608 x 4608 that is 0.16 ms for
// D = 3 (multistart scoring) and 1.4 ms for D = 33 (FGR's FPFH features).
// Design: grid (query tiles, B); one query per thread, -2q held in
// registers (D a template argument, so the loops unroll and nothing
// spills); target tiles staged through shared memory as rows of D
// coordinates plus |t|^2 padded to whole float4s, read by every thread of
// the block at the same address (broadcasts, no bank conflicts); a
// running (min, first index) in registers.  |t|^2 is computed once per
// tile by one thread per target, or read from the packed targets (K8).
// A grid of fewer than two blocks an SM (one cloud: K9, 36 blocks at
// 4608 queries) splits the valid targets into S contiguous slices of
// whole tiles (S <= 8, chosen by the wrapper): the S blocks of a query
// tile form a thread-block cluster, each runs the same search over its
// slice, and rank 0 merges the peers' (min, first index) through
// distributed shared memory in slice order, taking a peer's only if it
// is strictly smaller -- so the lowest index keeps a tie across slices
// and idx and d2 are the unsplit search's bits (the per-target distances
// are the same FMA chain).  A slice past the valid targets finds none
// and loses every merge.  Register tiling over several queries a thread
// and tensor cores (a 3xTF32 or bf16-limb split through wgmma, which
// would matter most at D = 33) are left for a later change.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 128;      // targets per shared-memory tile
constexpr float kBig = 3.4e38f; // distance of "no valid target"
constexpr int kMaxSplit = 8;    // the portable cluster size

template <int D>
constexpr int tile_words() {   // float4s of a target tile
  return kTile * ((D + 4) / 4);
}

template <int D, bool kPay, bool kPacked>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q,        // [B,Nq,D]
          const float* __restrict__ t,        // [B,Nt,D]; packed [B,2,Nt,D]
          const float* __restrict__ tn,       // packed only: [B,2,Nt] |t|^2
          const float* __restrict__ payload,  // kPay: [B,Nt,P]
          const int* __restrict__ n_tgt,      // [B]
          const int* __restrict__ phase,      // packed only: [B]
          int* __restrict__ idx_out,          // [B,Nq]
          float* __restrict__ d2_out,         // [B,Nq]
          float* __restrict__ matched,        // kPay: [B,Nq,P]
          int nq, int nt, int p, int split) {
  constexpr int V = (D + 4) / 4;   // float4s a target row: D coords, |t|^2
  constexpr int S = 4 * V;
  extern __shared__ float4 t_s4[];   // [kTile * V]
  float* t_s = reinterpret_cast<float*>(t_s4);

  const int b = blockIdx.y;
  const int slice = blockIdx.x % split;      // the block's rank in its cluster
  const int qi = (blockIdx.x / split) * kThreads + threadIdx.x;
  const bool active = qi < nq;
  const int n = min(max(n_tgt[b], 0), nt);
  // this block's targets: whole tiles [lo_t, hi_t) of the valid ones
  const int per = ((n + kTile - 1) / kTile + split - 1) / split * kTile;
  const int lo_t = min(slice * per, n);
  const int hi_t = min(lo_t + per, n);
  const int sel = kPacked ? (phase[b] != 0 ? 1 : 0) : 0;
  const size_t t_row0 = ((size_t)b * (kPacked ? 2 : 1) + sel) * nt;
  const float* t_b = t + t_row0 * D;

  float q2[D];
  float qn = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) q2[k] = 0.f;
  if (active) {
    const float* qr = q + ((size_t)b * nq + qi) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float v = qr[k];
      qn = fmaf(v, v, qn);
      q2[k] = -2.f * v;            // exact: a power-of-two scaling
    }
  }

  float best = kBig;
  int bi = 0;
  for (int t0 = lo_t; t0 < hi_t; t0 += kTile) {
    const int m = min(kTile, hi_t - t0);
    __syncthreads();               // the previous tile is fully consumed
    for (int i = threadIdx.x; i < m * D; i += kThreads) {
      const int r = i / D;
      t_s[r * S + (i - r * D)] = t_b[(size_t)t0 * D + i];
    }
    if (kPacked) {
      for (int r = threadIdx.x; r < m; r += kThreads) {
        t_s[r * S + D] = tn[t_row0 + t0 + r];
      }
    } else {
      __syncthreads();             // the coordinates are in place
      for (int r = threadIdx.x; r < m; r += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) s = fmaf(t_s[r * S + k], t_s[r * S + k], s);
        t_s[r * S + D] = s;
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int j = 0; j < m; ++j) {
        float tv[S];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 w = t_s4[j * V + v];
          tv[4 * v] = w.x; tv[4 * v + 1] = w.y;
          tv[4 * v + 2] = w.z; tv[4 * v + 3] = w.w;
        }
        float d = tv[D];
#pragma unroll
        for (int k = 0; k < D; ++k) d = fmaf(q2[k], tv[k], d);
        if (d < best) {            // strict: the first index keeps a tie
          best = d;
          bi = t0 + j;
        }
      }
    }
  }
  if (split > 1) {
    // merge the slices in cluster rank order, on rank 0; every thread of
    // every block takes part in both cluster barriers
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();               // the last tile is fully consumed
    float* m_best = t_s;
    int* m_idx = reinterpret_cast<int*>(t_s + kThreads);
    m_best[threadIdx.x] = best;
    m_idx[threadIdx.x] = bi;
    cluster.sync();
    if (slice == 0) {
      for (int r = 1; r < split; ++r) {
        const float ob = cluster.map_shared_rank(m_best, (unsigned)r)[threadIdx.x];
        if (ob < best) {           // strict: the lower slice keeps a tie
          best = ob;
          bi = cluster.map_shared_rank(m_idx, (unsigned)r)[threadIdx.x];
        }
      }
    }
    cluster.sync();                // the peers' records outlive the reads
    if (slice != 0) return;
  }
  if (!active) return;

  const size_t o = (size_t)b * nq + qi;
  idx_out[o] = bi;
  d2_out[o] = best + qn;
  if (kPay) {
    const float* src = payload + ((size_t)b * nt + bi) * p;
    float* dst = matched + o * p;
    for (int c = 0; c < p; ++c) dst[c] = src[c];
  }
}

template <int D, bool kPay, bool kPacked>
int launch(const void* q, const void* t, const void* tn, const void* payload,
           const void* n_tgt, const void* phase, void* idx, void* d2,
           void* matched, int bsz, int nq, int nt, int p, int split,
           void* stream) {
  if (split < 1 || split > kMaxSplit) return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kThreads - 1) / kThreads * split, bsz);
  const size_t smem = sizeof(float4) * tile_words<D>();
  auto kern = nn_kernel<D, kPay, kPacked>;
  const float* qf = (const float*)q;
  const float* tf = (const float*)t;
  const float* tnf = (const float*)tn;
  const float* pay = (const float*)payload;
  const int* nt_p = (const int*)n_tgt;
  const int* ph = (const int*)phase;
  if (split == 1) {
    kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        qf, tf, tnf, pay, nt_p, ph, (int*)idx, (float*)d2, (float*)matched,
        nq, nt, p, 1);
    return (int)cudaGetLastError();
  }
  // the S blocks of a query tile as one cluster; a size the card refuses
  // fails the launch (no fallback to the unsplit search)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, qf, tf, tnf, pay, nt_p,
                                           ph, (int*)idx, (float*)d2,
                                           (float*)matched, nq, nt, p, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kPay>
int launch_width(const void* q, const void* t, const void* payload,
                 const void* n_tgt, void* idx, void* d2, void* matched,
                 int bsz, int nq, int nt, int d, int p, int split,
                 void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || nt <= 0 || (kPay && p <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {   // the widths of ops/cuda_nn.py WIDTHS
    case 3:
      return launch<3, kPay, false>(q, t, nullptr, payload, n_tgt, nullptr,
                                    idx, d2, matched, bsz, nq, nt, p, split,
                                    stream);
    case 12:
      return launch<12, kPay, false>(q, t, nullptr, payload, n_tgt, nullptr,
                                     idx, d2, matched, bsz, nq, nt, p, split,
                                     stream);
    case 33:
      return launch<33, kPay, false>(q, t, nullptr, payload, n_tgt, nullptr,
                                     idx, d2, matched, bsz, nq, nt, p, split,
                                     stream);
    case 64:
      return launch<64, kPay, false>(q, t, nullptr, payload, n_tgt, nullptr,
                                     idx, d2, matched, bsz, nq, nt, p, split,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K6 (and K9 at B = 1): idx [B,Nq] int32, d2 [B,Nq]; `split` target
// slices a query tile (1 = the unsplit search)
extern "C" int se3icp_nn_argmin(const void* q, const void* t,
                                const void* n_tgt, void* idx, void* d2,
                                int bsz, int nq, int nt, int d, int split,
                                void* stream) {
  return launch_width<false>(q, t, nullptr, n_tgt, idx, d2, nullptr, bsz, nq,
                             nt, d, 0, split, stream);
}

// K7: K6 plus matched [B,Nq,P] = payload[b, idx]
extern "C" int se3icp_nn_match(const void* q, const void* t,
                               const void* payload, const void* n_tgt,
                               void* idx, void* d2, void* matched, int bsz,
                               int nq, int nt, int d, int p, int split,
                               void* stream) {
  return launch_width<true>(q, t, payload, n_tgt, idx, d2, matched, bsz, nq,
                            nt, d, p, split, stream);
}

// K8: K7 against dual-phase 12-D targets emb [B,2,Nt,12] with their
// |t|^2 tn [B,2,Nt], phase [B] choosing the block per pair
extern "C" int se3icp_nn_match_packed(const void* q, const void* emb,
                                      const void* tn, const void* payload,
                                      const void* n_tgt, const void* phase,
                                      void* idx, void* d2, void* matched,
                                      int bsz, int nq, int nt, int p,
                                      int split, void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || nt <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  return launch<12, true, true>(q, emb, tn, payload, n_tgt, phase, idx, d2,
                                matched, bsz, nq, nt, p, split, stream);
}
