// Exact 1-NN of float32 points: for every query, the index of the
// nearest valid target (lowest index on ties) and its squared distance,
// and for the match variants the nearest target's payload row.
//
// Replaces four TPU kernels of se3_icp_tpu/ops/pallas_knn.py, which all
// compute this one function:
//   K6 `_kernel_batched`      (wrapper `nn_argmin_pallas_batched`)
//   K7 `_kernel_match`        (wrapper `nn_match_pallas_batched`)
//   K9 `_kernel`              (wrapper `nn_argmin_pallas`, unbatched;
//                              here `nn_kernel` launched at B = 1)
//   K8 `_kernel_match_packed` (wrapper `nn_match_packed`: targets packed
//                              once in both phases, one chosen per pair)
// Those kernels split every float32 operand into three bf16 limbs so the
// matrix unit yields float32-exact products, poison invalid targets with
// huge coordinates instead of a bound check, add |q|^2 back after the
// reduction and pick the winning payload row with a one-hot matmul.  None
// of that is needed here: float32 FMAs on the CUDA cores are exact-class
// and a thread gathers the winning row once, at the end.  K8 takes no
// tie-average (that is K4's contract, csrc/match_affine.cu): every
// variant keeps the lowest index.
//
// The distance of a (query, target) is one FMA chain in one order in
// every kernel here and in every pass of a kernel: d = |t|^2, then d =
// fmaf(-2 q_k, t_k, d) for k = 0 .. D-1, and d2 = d + |q|^2 (|q|^2 an
// fmaf chain from 0).  |t|^2 is the chain fmaf(t_k, t_k, .) over k from
// 0, except K8's: the packed targets carry it (`tn`, a torch sum in
// ops/cuda_knn.py, whose bits are not the chain's), and every pass reads
// it as given, never recomputes it.  So the tiled kernel (K6, K7, K8)
// and `nn_kernel` (K9, and K8's bit reference) return the same idx and d2
// bits on the same inputs, and a recomputed distance equals the one the
// search compared.
//
// What bounds it on an H100: operations.  A call is B*Nq*Nt pairs, each
// D FMAs on the shifted distance |t|^2 - 2 q.t plus a min:
// B*Nq*Nt*(2D+2) float32 operations against 67 TFLOP/s, while the inputs
// (a few MB) are read once.  At 64 x 4608 x 4608 that is 0.16 ms for
// D = 3 (multistart scoring) and 1.4 ms for D = 33 (FGR's FPFH features).
//
// K6, K7 and K8: `nn_tiled_kernel`, the search as a CUDA-core SGEMM with a
// min epilogue.  Grid (query tiles, B).  A thread owns kTR queries x kTC
// targets of accumulators; the kTCols threads that share a query sit in
// one warp, each with its own targets.  The block stages its queries'
// -2q once and streams target tiles through shared memory, both k-major
// (coordinate-major), so one LDS.128 brings 4 queries' or 4 targets' k-th
// coordinate: each k costs a thread (kTR + kTC) / 4 loads and kTR*kTC
// independent FMAs, where one query a thread cost a load a few FMAs and
// one dependent chain.  At D = 3 a thread's -2q stay in registers for the
// whole search, so a k costs only the target loads.  A thread's queries
// and targets are groups of 4 strided by the group width of the block
// (4 kTRows queries, 4 kTCols targets), so a warp's loads hit distinct
// banks.  Target tiles come raw (rows of D floats, no alignment) by
// 4-byte cp.async into a double buffer, the next tile loading while this
// one is scanned, and are transposed in shared memory by one thread a
// row, which also computes the row's |t|^2 (rows past n_tgt: zeros and
// |t|^2 = +inf, never below a running minimum, so the scan has no bound
// check).  Per step of kTC targets a query folds its accumulators into
// one min (one operation a pair, as the bound counts it); only when some
// lane of the warp beat its running minimum (one vote, a uniform branch)
// do the queries note, by selects, the new minimum and the step's first
// target.  The update is strict, so the noted step is the first that
// reached the final minimum.  At the end every thread leaves its (min,
// step) a query in shared memory; one thread a query takes the least min
// over the kTCols threads and recomputes, with the same chain, the
// targets of each of their steps that reached it, for the lowest index
// at exactly that min; it writes idx, d2 and (K7) the payload row, bit
// for bit.  The grid fills the card without a split of the targets
// (1152 blocks at 64 x 4608, 480 at 8 x 15360).  The tiling (8 x 8 a
// thread, 4 threads a query, tiles of 256 targets at D <= 12 and of 64
// above, at most 168 registers) was chosen by measurement
// (tools/kernel_tiling_sweep.py --nn-tile; PERF.md).
//
// K8 is the instance on packed targets (kPacked, D = 12): a block serves
// one pair, so it picks the pair's phase block once, by one scalar load
// of phase[b], where the TPU kernel's index map chose it per grid step;
// its rows emb[b, sel] and their given |t|^2 tn[b, sel] are staged with
// the tile (the |t|^2 after the rows in the raw buffer, by the same
// cp.async) and copied, not computed, into the tile's |t|^2 row, and the
// epilogue's recompute starts each chain from tn[b, sel, j] too.  Its
// block takes 2 x 256 floats more shared memory (53,248 B), still 3
// blocks an SM; the payload rows are the phase-independent ones.
//
// K9: `nn_kernel`, one query a thread: -2q in registers, target
// tiles staged as rows of D coordinates plus |t|^2 padded to whole
// float4s, read by every thread of the block at the same address
// (broadcasts); a running (min, first index) in registers; |t|^2 computed
// once per tile, or read from the packed targets (its instance on K8's
// targets, `se3icp_nn_match_packed`, is the bit reference of the tiled K8
// in the card checks).  A grid of fewer
// than two blocks an SM (one cloud: K9, 36 blocks at 4608 queries) splits
// the valid targets into S contiguous slices of whole tiles (S <= 8,
// chosen by the wrapper): the S blocks of a query tile form a
// thread-block cluster, each runs the same search over its slice, and
// rank 0 merges the peers' (min, first index) through distributed shared
// memory in slice order, taking a peer's only if it is strictly smaller
// -- so the lowest index keeps a tie across slices and idx and d2 are the
// unsplit search's bits.  A slice past the valid targets finds none and
// loses every merge.  Tensor cores (a 3xTF32 or bf16-limb split through
// wgmma) would change the distance bits and are left out.

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 128;      // targets per shared-memory tile
constexpr float kBig = 3.4e38f; // distance of "no valid target"
constexpr int kMaxSplit = 8;    // the portable cluster size

// the tiled search (K6, K7, K8)
constexpr int kTR = 8;                // queries a thread
constexpr int kTC = 8;                // targets a thread a step
constexpr int kTCols = 4;             // threads that share a query
constexpr int kTThreads = 128;        // threads a block
constexpr int kTMinBlocks = 3;        // resident blocks an SM: <= 168 registers
constexpr int kTTileNarrow = 256;     // targets a staged tile, D <= 12
constexpr int kTTileWide = 64;        // targets a staged tile, D > 12
constexpr int kTRows = kTThreads / kTCols;   // threads along the queries
constexpr int kTQueries = kTRows * kTR;      // queries a block
constexpr int kTStep = kTCols * kTC;         // targets a step of the block
static_assert(kTR % 4 == 0 && kTC % 4 == 0, "whole float4 groups");
static_assert(32 % kTCols == 0 && kTThreads % 32 == 0,
              "the threads of a query in one warp, whole warps");
static_assert(kTTileNarrow % kTStep == 0 && kTTileWide % kTStep == 0,
              "whole steps a tile");

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

template <int D>
__host__ __device__ constexpr int tiled_tile() {   // targets a staged tile
  return D <= 12 ? kTTileNarrow : kTTileWide;
}

// The tiled kernel's dynamic shared memory, in floats: -2q [D][queries],
// |q|^2, the transposed tile [D][tile], |t|^2, and two raw tiles (the
// rows, then, packed, their given |t|^2), whose room the (min, step)
// records of the epilogue reuse.
template <int D, bool kPacked = false>
struct TiledSmem {
  static constexpr int kSpan = tiled_tile<D>();   // targets a tile
  static constexpr int kQ = D * kTQueries;
  static constexpr int kQn = kTQueries;
  static constexpr int kT = D * kSpan;
  static constexpr int kTn = kSpan;
  static constexpr int kRawRows = (kSpan * D + 3) / 4 * 4;
  static constexpr int kRawTile = kRawRows + (kPacked ? kSpan : 0);
  static constexpr int kRec = 2 * kTQueries * kTCols;
  static constexpr int kRest = 2 * kRawTile > kRec ? 2 * kRawTile : kRec;
  static constexpr int kWords = kQ + kQn + kT + kTn + kRest;
};

// Copy the valid rows of the tile at t0 (row-major, D floats each) into
// `raw` with 4-byte cp.async: the rows carry no 16-byte alignment.
// Packed: their given |t|^2 (from tn_b) after the rows, the same way.
template <int D, bool kPacked>
__device__ __forceinline__ void stage_raw(float* raw, const float* t_b,
                                          const float* tn_b, int t0, int n) {
  constexpr int kSpan = tiled_tile<D>();
  const int rows = min(kSpan, n - t0);
  const float* src = t_b + (size_t)t0 * D;
  for (int e = threadIdx.x; e < rows * D; e += kTThreads) {
    __pipeline_memcpy_async(&raw[e], &src[e], sizeof(float));
  }
  if constexpr (kPacked) {
    float* raw_tn = raw + TiledSmem<D, true>::kRawRows;
    for (int r = threadIdx.x; r < rows; r += kTThreads) {
      __pipeline_memcpy_async(&raw_tn[r], &tn_b[t0 + r], sizeof(float));
    }
  }
  __pipeline_commit();
}

// raw rows -> t_s [D][tile] and |t|^2, one thread a row: computed, or
// packed, the given one, never recomputed; rows at or past n: zeros and
// |t|^2 = +inf.
template <int D, bool kPacked>
__device__ __forceinline__ void transpose_tile(const float* raw, float* t_s,
                                               float* tn_s, int t0, int n) {
  constexpr int kSpan = tiled_tile<D>();
  for (int r = threadIdx.x; r < kSpan; r += kTThreads) {
    if (t0 + r < n) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float v = raw[r * D + k];
        t_s[k * kSpan + r] = v;
        if constexpr (!kPacked) s = fmaf(v, v, s);
      }
      tn_s[r] = kPacked ? raw[TiledSmem<D, true>::kRawRows + r] : s;
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) t_s[k * kSpan + r] = 0.f;
      tn_s[r] = __int_as_float(0x7f800000);   // +inf
    }
  }
}

// Local index of query r of thread row ty, and of target c of thread
// column tx within a step: groups of 4, strided by the block's group width.
__device__ __forceinline__ int tiled_query(int ty, int r) {
  return (r / 4) * (4 * kTRows) + ty * 4 + r % 4;
}
__device__ __forceinline__ int tiled_target(int tx, int c) {
  return (c / 4) * (4 * kTCols) + tx * 4 + c % 4;
}

// -2q of a thread's queries kept in registers for the whole search where
// they fit (D * kTR <= 32: D = 3), else read from shared memory each k.
template <int D>
__host__ __device__ constexpr int held_rows() {
  return D * kTR <= 32 ? D : 1;
}
template <int D>
using Held = float[held_rows<D>()][kTR];

// Coordinate k of the thread's queries (-2q) and of its targets of the
// step whose tile columns start at t_s.
template <int D>
__device__ __forceinline__ void load_step(const float* __restrict__ q_s,
                                          const float* __restrict__ t_s,
                                          const Held<D>& qh,
                                          int tx, int ty, int k,
                                          float (&a)[kTR], float (&v)[kTC]) {
  constexpr int kSpan = tiled_tile<D>();
  if constexpr (held_rows<D>() == D) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) a[r] = qh[k][r];
  } else {
#pragma unroll
    for (int g = 0; g < kTR / 4; ++g) {
      const float4 w = *reinterpret_cast<const float4*>(
          q_s + k * kTQueries + tiled_query(ty, 4 * g));
      a[4 * g] = w.x; a[4 * g + 1] = w.y; a[4 * g + 2] = w.z;
      a[4 * g + 3] = w.w;
    }
  }
#pragma unroll
  for (int g = 0; g < kTC / 4; ++g) {
    const float4 w = *reinterpret_cast<const float4*>(
        t_s + k * kSpan + tiled_target(tx, 4 * g));
    v[4 * g] = w.x; v[4 * g + 1] = w.y; v[4 * g + 2] = w.z;
    v[4 * g + 3] = w.w;
  }
}

// One step: the thread's kTR queries against its kTC targets of the
// staged tile from column s0 (target j0 of the pair), folded into one min
// a query; the running minimum and the step of its first reaching.
template <int D>
__device__ __forceinline__ void scan_step(const float* __restrict__ q_s,
                                          const float* __restrict__ t_s,
                                          const float* __restrict__ tn_s,
                                          const Held<D>& qh,
                                          int tx, int ty, int s0, int j0,
                                          float (&best)[kTR],
                                          int (&first)[kTR]) {
  const float4* tn4 = reinterpret_cast<const float4*>(tn_s + s0);
  float acc[kTR][kTC];
  float a[kTR], v[kTC];
  // k = 0 starts every chain from |t|^2
  load_step<D>(q_s, t_s + s0, qh, tx, ty, 0, a, v);
#pragma unroll
  for (int g = 0; g < kTC / 4; ++g) {
    const float4 w = tn4[tiled_target(tx, 4 * g) / 4];
    const float tn[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        acc[r][4 * g + e] = fmaf(a[r], v[4 * g + e], tn[e]);
      }
    }
  }
#pragma unroll (D <= 12 ? 12 : 4)
  for (int k = 1; k < D; ++k) {
    load_step<D>(q_s, t_s + s0, qh, tx, ty, k, a, v);
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
#pragma unroll
      for (int c = 0; c < kTC; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
    }
  }
  float m[kTR];
  bool hit = false;
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    m[r] = acc[r][0];
#pragma unroll
    for (int c = 1; c < kTC; ++c) m[r] = fminf(m[r], acc[r][c]);
    hit |= m[r] < best[r];
  }
  if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      // strict: a later step that reaches the minimum again keeps the first
      first[r] = m[r] < best[r] ? j0 : first[r];
      best[r] = m[r] < best[r] ? m[r] : best[r];
    }
  }
}

template <int D, bool kPay, bool kPacked>
__global__ void __launch_bounds__(kTThreads, kTMinBlocks)
nn_tiled_kernel(const float* __restrict__ q,        // [B,Nq,D]
                const float* __restrict__ t,        // [B,Nt,D]; packed [B,2,Nt,D]
                const float* __restrict__ tn,       // packed only: [B,2,Nt] |t|^2
                const float* __restrict__ payload,  // kPay: [B,Nt,P]
                const int* __restrict__ n_tgt,      // [B]
                const int* __restrict__ phase,      // packed only: [B]
                int* __restrict__ idx_out,          // [B,Nq]
                float* __restrict__ d2_out,         // [B,Nq]
                float* __restrict__ matched,        // kPay: [B,Nq,P]
                int nq, int nt, int p) {
  using L = TiledSmem<D, kPacked>;
  constexpr int kSpan = L::kSpan;
  extern __shared__ float4 tiled_s4[];
  float* q_s = reinterpret_cast<float*>(tiled_s4);
  float* qn_s = q_s + L::kQ;
  float* t_s = qn_s + L::kQn;
  float* tn_s = t_s + L::kT;
  float* raw_s = tn_s + L::kTn;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQueries;
  const int n = min(max(n_tgt[b], 0), nt);
  // packed: the pair's phase block (one scalar load a block)
  const int sel = kPacked ? (phase[b] != 0 ? 1 : 0) : 0;
  const size_t t_row0 = ((size_t)b * (kPacked ? 2 : 1) + sel) * nt;
  const float* t_b = t + t_row0 * D;
  const float* tn_b = kPacked ? tn + t_row0 : nullptr;
  const int tx = threadIdx.x % kTCols;
  const int ty = threadIdx.x / kTCols;

  // -2q (k-major) and |q|^2 of the block's queries, one thread a query;
  // queries past nq are zero rows, searched and never written
  for (int i = threadIdx.x; i < kTQueries; i += kTThreads) {
    float s = 0.f;
    if (q0 + i < nq) {
      const float* qr = q + ((size_t)b * nq + q0 + i) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float v = qr[k];
        s = fmaf(v, v, s);
        q_s[k * kTQueries + i] = -2.f * v;   // exact: a power-of-two scaling
      }
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) q_s[k * kTQueries + i] = 0.f;
    }
    qn_s[i] = s;
  }
  __syncthreads();
  Held<D> qh;
#pragma unroll
  for (int k = 0; k < held_rows<D>(); ++k) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      qh[k][r] = held_rows<D>() == D ? q_s[k * kTQueries + tiled_query(ty, r)]
                                     : 0.f;
    }
  }

  float best[kTR];
  int first[kTR];   // first target of the step that reached best; -1: none
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    best[r] = kBig;
    first[r] = -1;
  }
  const int n_tiles = (n + kSpan - 1) / kSpan;
  if (n_tiles > 0) stage_raw<D, kPacked>(raw_s, t_b, tn_b, 0, n);
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * kSpan;
    if (k + 1 < n_tiles) {
      stage_raw<D, kPacked>(raw_s + ((k + 1) & 1) * L::kRawTile, t_b, tn_b,
                            t0 + kSpan, n);
      __pipeline_wait_prior(1);     // this thread's copies of tile k landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();   // every thread's copies; the last tile consumed
    transpose_tile<D, kPacked>(raw_s + (k & 1) * L::kRawTile, t_s, tn_s,
                               t0, n);
    __syncthreads();
#pragma unroll 1
    for (int s0 = 0; s0 < kSpan; s0 += kTStep) {
      scan_step<D>(q_s, t_s, tn_s, qh, tx, ty, s0, t0 + s0, best, first);
    }
  }

  // merge the kTCols threads of a query: least min, then lowest index
  __syncthreads();     // the raw tiles are free (no copy in flight)
  float* rec_best = raw_s;
  int* rec_first = reinterpret_cast<int*>(raw_s + kTQueries * kTCols);
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int o = tiled_query(ty, r) * kTCols + tx;
    rec_best[o] = best[r];
    rec_first[o] = first[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTQueries; i += kTThreads) {
    const int qi = q0 + i;
    if (qi >= nq) continue;
    const float* rb = rec_best + i * kTCols;
    const int* rf = rec_first + i * kTCols;
    float m = kBig;
    for (int c = 0; c < kTCols; ++c) m = fminf(m, rb[c]);
    int bi = 0;                    // no valid target below kBig: row 0
    if (m < kBig) {
      bi = nt;
      for (int c = 0; c < kTCols; ++c) {
        if (rb[c] != m) continue;
        // the lowest of thread c's targets in its noted step at exactly m
        for (int e = 0; e < kTC; ++e) {
          const int j = rf[c] + tiled_target(c, e);
          if (j >= n || j >= bi) break;   // targets ascend with e
          const float* tr = t_b + (size_t)j * D;
          // the chain the scan compared: from the |t|^2 it staged
          float d = 0.f;
          if constexpr (kPacked) {
            d = tn_b[j];
          } else {
            for (int kk = 0; kk < D; ++kk) d = fmaf(tr[kk], tr[kk], d);
          }
          for (int kk = 0; kk < D; ++kk) {
            d = fmaf(q_s[kk * kTQueries + i], tr[kk], d);
          }
          if (d == m) {
            bi = j;
            break;
          }
        }
      }
    }
    const size_t o = (size_t)b * nq + qi;
    idx_out[o] = bi;
    d2_out[o] = m + qn_s[i];
    if (kPay) {
      const float* src = payload + ((size_t)b * nt + bi) * p;
      float* dst = matched + o * p;
      for (int c = 0; c < p; ++c) dst[c] = src[c];
    }
  }
}

template <int D, bool kPay, bool kPacked>
int launch_tiled(const void* q, const void* t, const void* tn,
                 const void* payload, const void* n_tgt, const void* phase,
                 void* idx, void* d2, void* matched, int bsz, int nq, int nt,
                 int p, void* stream) {
  const dim3 grid((nq + kTQueries - 1) / kTQueries, bsz);
  const size_t smem = sizeof(float) * TiledSmem<D, kPacked>::kWords;
  auto kern = nn_tiled_kernel<D, kPay, kPacked>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kTThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)t, (const float*)tn,
      (const float*)payload, (const int*)n_tgt, (const int*)phase, (int*)idx,
      (float*)d2, (float*)matched, nq, nt, p);
  return (int)cudaGetLastError();
}

template <bool kPay>
int launch_tiled_width(const void* q, const void* t, const void* payload,
                       const void* n_tgt, void* idx, void* d2, void* matched,
                       int bsz, int nq, int nt, int d, int p, void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || nt <= 0 || (kPay && p <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {   // the widths of ops/cuda_nn.py WIDTHS
    case 3:
      return launch_tiled<3, kPay, false>(q, t, nullptr, payload, n_tgt,
          nullptr, idx, d2, matched, bsz, nq, nt, p, stream);
    case 12:
      return launch_tiled<12, kPay, false>(q, t, nullptr, payload, n_tgt,
          nullptr, idx, d2, matched, bsz, nq, nt, p, stream);
    case 33:
      return launch_tiled<33, kPay, false>(q, t, nullptr, payload, n_tgt,
          nullptr, idx, d2, matched, bsz, nq, nt, p, stream);
    case 64:
      return launch_tiled<64, kPay, false>(q, t, nullptr, payload, n_tgt,
          nullptr, idx, d2, matched, bsz, nq, nt, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
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

int launch_width(const void* q, const void* t, const void* n_tgt, void* idx,
                 void* d2, int bsz, int nq, int nt, int d, int split,
                 void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || nt <= 0) return (int)cudaErrorInvalidValue;
  switch (d) {   // the widths of ops/cuda_nn.py WIDTHS
    case 3:
      return launch<3, false, false>(q, t, nullptr, nullptr, n_tgt, nullptr,
                                     idx, d2, nullptr, bsz, nq, nt, 0, split,
                                     stream);
    case 12:
      return launch<12, false, false>(q, t, nullptr, nullptr, n_tgt, nullptr,
                                      idx, d2, nullptr, bsz, nq, nt, 0, split,
                                      stream);
    case 33:
      return launch<33, false, false>(q, t, nullptr, nullptr, n_tgt, nullptr,
                                      idx, d2, nullptr, bsz, nq, nt, 0, split,
                                      stream);
    case 64:
      return launch<64, false, false>(q, t, nullptr, nullptr, n_tgt, nullptr,
                                      idx, d2, nullptr, bsz, nq, nt, 0, split,
                                      stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K9 (`nn_kernel` at B = 1; any B): idx [B,Nq] int32, d2 [B,Nq];
// `split` target slices a query tile (1 = the unsplit search)
extern "C" int se3icp_nn_argmin(const void* q, const void* t,
                                const void* n_tgt, void* idx, void* d2,
                                int bsz, int nq, int nt, int d, int split,
                                void* stream) {
  return launch_width(q, t, n_tgt, idx, d2, bsz, nq, nt, d, split, stream);
}

// K6, the tiled search: idx [B,Nq] int32, d2 [B,Nq]
extern "C" int se3icp_nn_argmin_batched(const void* q, const void* t,
                                        const void* n_tgt, void* idx,
                                        void* d2, int bsz, int nq, int nt,
                                        int d, void* stream) {
  return launch_tiled_width<false>(q, t, nullptr, n_tgt, idx, d2, nullptr,
                                   bsz, nq, nt, d, 0, stream);
}

// Dynamic shared memory of a block of the tiled search at width d, in
// bytes, on plain (packed = 0: K6, K7) or packed targets (packed = 1: K8,
// d = 12 only); -1 for an instance it is not built for
extern "C" int se3icp_nn_tiled_smem(int d, int packed) {
  if (packed) {
    return d == 12 ? (int)sizeof(float) * TiledSmem<12, true>::kWords : -1;
  }
  switch (d) {
    case 3: return (int)sizeof(float) * TiledSmem<3>::kWords;
    case 12: return (int)sizeof(float) * TiledSmem<12>::kWords;
    case 33: return (int)sizeof(float) * TiledSmem<33>::kWords;
    case 64: return (int)sizeof(float) * TiledSmem<64>::kWords;
    default: return -1;
  }
}

// K7, the tiled search: K6 plus matched [B,Nq,P] = payload[b, idx]
extern "C" int se3icp_nn_match_batched(const void* q, const void* t,
                                       const void* payload, const void* n_tgt,
                                       void* idx, void* d2, void* matched,
                                       int bsz, int nq, int nt, int d, int p,
                                       void* stream) {
  return launch_tiled_width<true>(q, t, payload, n_tgt, idx, d2, matched, bsz,
                                  nq, nt, d, p, stream);
}

// K8, the tiled search: K7 against dual-phase 12-D targets emb
// [B,2,Nt,12] with their given |t|^2 tn [B,2,Nt], phase [B] choosing the
// block per pair (0: the first, any other value: the second)
extern "C" int se3icp_nn_match_packed_batched(
    const void* q, const void* emb, const void* tn, const void* payload,
    const void* n_tgt, const void* phase, void* idx, void* d2, void* matched,
    int bsz, int nq, int nt, int p, void* stream) {
  if (bsz <= 0 || nq <= 0) return (int)cudaGetLastError();
  if (bsz > 65535 || nt <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  return launch_tiled<12, true, true>(q, emb, tn, payload, n_tgt, phase, idx,
                                      d2, matched, bsz, nq, nt, p, stream);
}

// The same search by `nn_kernel` (one query a thread, `split` target
// slices a query tile): the bit reference of the card checks
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
