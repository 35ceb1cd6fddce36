// G4: the setup's centring and scaling (the registration's preprocess),
// one cluster of 2C blocks a pair: blocks 0 .. C-1 the source cloud,
// C .. 2C-1 the target (C = 1, 2, 4 or 8, chosen by the wrapper).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// _masked_centroid, _largest_radius and the scaling
// (se3_icp_tpu/models/registration.py:85-93, 209-220) into its setup
// program.  The port ran them as torch reductions, whose split over
// threads and blocks on the card follows the number of outputs: a
// pair's centroid, and with it every later bit of its registration,
// could follow the size of its batch.
//
// One order, fixed by the valid count n alone: lane t (of 256) sums the
// rows t, t + 256, t + 512, ... below n in index order, starting from
// +0, then a halving tree adds lane i + h into lane i for h = 128, 64,
// ..., 1.  The centroid is that sum over max(n, 1); the radius the
// largest sqrt((dx dx + dy dy) + dz dz) over the valid rows (-1 without
// one; a maximum, exact in any order); the scale is 1 / max(max(r_s,
// r_t), 1e-30) times scale_preprocessing.  Every float32 step is an
// explicit __f*_rn, so the kernel gives the bits of its plain version
// (ops/cuda_prep.py, elementwise torch ops in the same order) in any
// batch, at any padded width and for every C: rows past n are never
// read or added (+0 added to a sum that starts at +0 changes nothing).
//
// Bound: bytes.  Each cloud's valid rows are read once (12 bytes a
// row) and every padded row is written once (12 bytes), the padded rows
// as 0 without a read; the kernel reads each valid row three times, the
// second and third from L2.  What held the one-block-a-cloud design
// (PR 15) back: a 64-pair call filled 128 SMs and a B = 1 call two, and
// each thread walked its rows through a chain of dependent loads.  So:
//   * a cloud's lanes are spread over the C blocks of its half of the
//     cluster, block r holding lanes [r 256/C, (r+1) 256/C); each block
//     stages its lanes' rows in shared memory, a tile at a time, with
//     every thread loading (coalesced, all loads in flight at once), and
//     the lanes then add their rows from shared memory in index order;
//   * every block gathers the cloud's 256 lane sums through distributed
//     shared memory and runs the halving tree itself (the same adds in
//     every block, so the same centroid);
//   * the radius and the write pass split the padded rows into C
//     contiguous parts, one a block; the 2C radius partials meet through
//     distributed shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // the lanes of the fixed order; a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;      // loads a thread issues before it waits
// staged floats a tile: with the lanes, the tree and the maxima the
// dynamic shared memory stays under 48 KB
constexpr int kTileFloats = 10624;
constexpr int kSmemFloats = kTileFloats + 6 * kThreads + kWarps + 2;

// torch.amax / torch.maximum: a NaN wins
__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// torch.clamp_min: NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// smem: the staged tile, this block's lane sums [3][L], the cloud's
// lanes [3][256] (then the tree), the warp maxima, this block's radius,
// the pair's scale
template <int C>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ src, const int* __restrict__ n_src,
            const float* __restrict__ tgt, const int* __restrict__ n_tgt,
            const float* __restrict__ scale_pre, float* __restrict__ src_c,
            float* __restrict__ tgt_c, float* __restrict__ cen_s,
            float* __restrict__ cen_t, float* __restrict__ scaling, int ns,
            int nt) {
  // block r of a cloud holds the lanes [l0, l0 + L); pair q = k L + i
  // of the block is component k of lane l0 + i, summed by thread
  // q mod 256
  constexpr int L = kThreads / C, span = 3 * L;
  constexpr int per_tile = kTileFloats / span;
  extern __shared__ float smem[];
  float* tile = smem;
  float* mine = tile + kTileFloats;
  float* lane = mine + 3 * kThreads;
  float* red = lane + 3 * kThreads;
  float* rad = red + kWarps;
  float* pair_scale = rad + 1;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int side = rank / C, part = rank - side * C;
  const int b = blockIdx.x / (2 * C);
  const int t = threadIdx.x;
  const int width = side ? nt : ns;
  const long long base = static_cast<long long>(b) * width * 3;
  const float* p = (side ? tgt : src) + base;
  const int n = (side ? n_tgt : n_src)[b];
  const int rows = n < 0 ? 0 : (n < width ? n : width);
  const int l0 = part * L;

  const int chunks = (rows + kThreads - 1) / kThreads;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < chunks; c0 += per_tile) {
    const int nc = min(per_tile, chunks - c0), total = nc * span;
    // chunk j's lanes are 3 L contiguous floats: rows
    // (c0 + j) 256 + l0 .. + L - 1; rows past n are not read
    for (int i0 = t; i0 < total; i0 += kUnroll * kThreads) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        const int j = i / span, w = i - j * span;
        const int row0 = (c0 + j) * kThreads + l0;
        v[u] = (i < total && row0 + w / 3 < rows) ? p[3 * row0 + w] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kThreads < total) tile[i0 + u * kThreads] = v[u];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int q = t + u * kThreads;
      if (q < span) {
        const int k = q / L, i = q - k * L;
        for (int j = 0; j < nc; ++j)
          if ((c0 + j) * kThreads + l0 + i < rows)
            acc[u] = __fadd_rn(acc[u], tile[j * span + 3 * i + k]);
      }
    }
    __syncthreads();   // the tile is read before the next is staged
  }
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int q = t + u * kThreads;
    if (q < span) mine[q] = acc[u];
  }
  cl.sync();           // every block's lanes are in place

  // the cloud's 256 lanes, then the halving tree, in every block
  {
    const float* m = cl.map_shared_rank(mine, side * C + t / L);
    const int i = t % L;
#pragma unroll
    for (int k = 0; k < 3; ++k) lane[k * kThreads + t] = m[k * L + i];
  }
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        lane[k * kThreads + t] =
            __fadd_rn(lane[k * kThreads + t], lane[k * kThreads + t + h]);
    }
    __syncthreads();
  }
  const float div = fmaxf(static_cast<float>(n), 1.0f);
  const float c0 = __fdiv_rn(lane[0], div);
  const float c1 = __fdiv_rn(lane[kThreads], div);
  const float c2 = __fdiv_rn(lane[2 * kThreads], div);

  // this block's part of the rows: the radius (a maximum) and the write
  const int per = (width + C - 1) / C;
  const int r0 = min(part * per, width), r1 = min(r0 + per, width);
  const int hi = min(r1, rows);
  float m = -1.0f;
  for (int s0 = r0 + t; s0 < hi; s0 += kUnroll * kThreads) {
    float x[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = s0 + u * kThreads;
#pragma unroll
      for (int k = 0; k < 3; ++k) x[u][k] = r < hi ? p[3 * r + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u * kThreads >= hi) continue;
      const float dx = __fsub_rn(x[u][0], c0);
      const float dy = __fsub_rn(x[u][1], c1);
      const float dz = __fsub_rn(x[u][2], c2);
      m = max_nan(m, __fsqrt_rn(__fadd_rn(
                         __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz))));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((t & 31) == 0) red[t >> 5] = m;
  __syncthreads();
  if (t == 0) {
    float v = red[0];
    for (int w = 1; w < kWarps; ++w) v = max_nan(v, red[w]);
    *rad = v;
  }
  cl.sync();           // every block's radius is in place
  if (t == 0) {
    float r_s = -1.0f, r_t = -1.0f;
    for (int q = 0; q < C; ++q) {
      r_s = max_nan(r_s, *cl.map_shared_rank(rad, q));
      r_t = max_nan(r_t, *cl.map_shared_rank(rad, C + q));
    }
    const float r = clamp_min((r_s != r_s || r_t != r_t) ? r_s + r_t
                                                          : fmaxf(r_s, r_t),
                              1e-30f);
    *pair_scale = __fmul_rn(__frcp_rn(r), *scale_pre);
  }
  __syncthreads();
  const float s = *pair_scale;

  // the rows [r0, r1) centred and scaled, padded rows 0, in flat
  // (coalesced) order
  float* o = (side ? tgt_c : src_c) + base;
  for (int i0 = 3 * r0 + t; i0 < 3 * r1; i0 += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = (i < 3 * r1 && i < 3 * rows) ? p[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= 3 * r1) continue;
      const int row = i / 3, k = i - 3 * row;
      const float c = k == 0 ? c0 : (k == 1 ? c1 : c2);
      o[i] = row < rows ? __fmul_rn(__fsub_rn(v[u], c), s) : 0.0f;
    }
  }
  if (t == 0 && part == 0) {
    float* cen = (side ? cen_t : cen_s) + 3 * b;
    cen[0] = c0;
    cen[1] = c1;
    cen[2] = c2;
    if (side == 0) scaling[b] = s;
  }
  cl.sync();           // the peers' reads of this block's memory are done
}

template <int C>
cudaError_t launch(const float* src, const int* n_src, const float* tgt,
                   const int* n_tgt, const float* scale_pre, float* src_c,
                   float* tgt_c, float* cen_s, float* cen_t, float* scaling,
                   int bsz, int ns, int nt, cudaStream_t stream) {
  if (2 * C > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        prep_kernel<C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2u * C * (unsigned)bsz);
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * kSmemFloats;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2u * C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, prep_kernel<C>, src, n_src, tgt, n_tgt,
                            scale_pre, src_c, tgt_c, cen_s, cen_t, scaling,
                            ns, nt);
}

}  // namespace

// src [B, Ns, 3], tgt [B, Nt, 3] float32, n_src / n_tgt [B] int32,
// scale_pre a float32 scalar on the card; src_c [B, Ns, 3], tgt_c
// [B, Nt, 3], cen_s / cen_t [B, 3], scaling [B] written.  cluster: the
// blocks a cloud runs on, 1, 2, 4 or 8 (a pair's cluster is twice
// that; 16 is a non-portable cluster size, allowed here).
extern "C" int se3icp_prep(const void* src, const void* n_src,
                           const void* tgt, const void* n_tgt,
                           const void* scale_pre, void* src_c, void* tgt_c,
                           void* cen_s, void* cen_t, void* scaling, int bsz,
                           int ns, int nt, int cluster, void* stream) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return (int)cudaErrorInvalidValue;
  if (bsz <= 0) return (int)cudaGetLastError();
  if (ns <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  auto run = [&](auto c) {
    return launch<decltype(c)::value>(
        (const float*)src, (const int*)n_src, (const float*)tgt,
        (const int*)n_tgt, (const float*)scale_pre, (float*)src_c,
        (float*)tgt_c, (float*)cen_s, (float*)cen_t, (float*)scaling, bsz,
        ns, nt, (cudaStream_t)stream);
  };
  const cudaError_t e =
      cluster == 1   ? run(std::integral_constant<int, 1>{})
      : cluster == 2 ? run(std::integral_constant<int, 2>{})
      : cluster == 4 ? run(std::integral_constant<int, 4>{})
                     : run(std::integral_constant<int, 8>{});
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
