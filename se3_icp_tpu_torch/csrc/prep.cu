// G4: the setup's centring and scaling (the registration's preprocess),
// one cluster of two blocks a pair: block 0 the source cloud, block 1
// the target.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// _masked_centroid, _largest_radius and the scaling
// (se3_icp_tpu/models/registration.py:85-93, 209-220) into its setup
// program.  The port ran them as torch reductions, whose split over
// threads and blocks on the card follows the number of outputs: a
// pair's centroid, and with it every later bit of its registration,
// could follow the size of its batch.
//
// One order, fixed by the valid count n alone: thread t of a block sums
// the rows t, t + 256, t + 512, ... below n in index order, starting
// from +0, then a halving tree in shared memory adds lane i + h into
// lane i for h = 128, 64, ..., 1.  The centroid is that sum over
// max(n, 1); the radius the largest sqrt((dx dx + dy dy) + dz dz) over
// the valid rows (-1 without one), by the same lanes and tree (a
// maximum, exact in any order); the scale is 1 / max(max(r_s, r_t),
// 1e-30) times scale_preprocessing, the two blocks of a pair trading
// their radii through distributed shared memory.  Each block then
// writes its cloud centred and scaled, its padded rows 0.  Every float32
// step is an explicit __f*_rn, so the kernel gives the bits of its plain
// version (ops/cuda_prep.py, elementwise torch ops in the same order)
// in any batch and at any padded width: rows past n are never added
// (+0 added to a sum that starts at +0 changes nothing).
//
// Bound: bytes.  Each cloud's valid rows are read once (12 bytes a
// row) and every padded row is written once (12 bytes), the padded rows
// as 0 without a read (13.5 MB at 64 x 4608 with 4167 valid rows); the
// kernel reads each valid row three times, the second and third from
// L2.  The cluster puts a pair's two clouds on two SMs, 128 blocks for
// the main path's 64 pairs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // the lanes of the fixed order

// torch.amax / torch.maximum: a NaN wins
__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// torch.clamp_min: NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// smem: [3][kThreads] the lanes, then one float: this block's radius
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ src, const int* __restrict__ n_src,
            const float* __restrict__ tgt, const int* __restrict__ n_tgt,
            const float* __restrict__ scale_pre, float* __restrict__ src_c,
            float* __restrict__ tgt_c, float* __restrict__ cen_s,
            float* __restrict__ cen_t, float* __restrict__ scaling, int ns,
            int nt) {
  extern __shared__ float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int side = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x >> 1;
  const int t = threadIdx.x;
  const int width = side ? nt : ns;
  const long long base = static_cast<long long>(b) * width * 3;
  const float* p = (side ? tgt : src) + base;
  const int n = (side ? n_tgt : n_src)[b];
  const int rows = n < 0 ? 0 : (n < width ? n : width);
  float* lane = smem;

  // the centroid: a lane's rows in index order, then the halving tree
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int r = t; r < rows; r += kThreads) {
    s0 = __fadd_rn(s0, p[3 * r]);
    s1 = __fadd_rn(s1, p[3 * r + 1]);
    s2 = __fadd_rn(s2, p[3 * r + 2]);
  }
  lane[t] = s0;
  lane[kThreads + t] = s1;
  lane[2 * kThreads + t] = s2;
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
  __syncthreads();   // every thread has read the sums

  // the radius: the same lanes, a maximum
  float m = -1.0f;
  for (int r = t; r < rows; r += kThreads) {
    const float dx = __fsub_rn(p[3 * r], c0);
    const float dy = __fsub_rn(p[3 * r + 1], c1);
    const float dz = __fsub_rn(p[3 * r + 2], c2);
    m = max_nan(m, __fsqrt_rn(__fadd_rn(
                       __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz))));
  }
  lane[t] = m;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) lane[t] = max_nan(lane[t], lane[t + h]);
    __syncthreads();
  }
  if (t == 0) lane[3 * kThreads] = lane[0];
  cl.sync();         // both radii are in place
  const float mine = lane[3 * kThreads];
  const float other = cl.map_shared_rank(lane, side ^ 1)[3 * kThreads];
  const float r_s = side ? other : mine, r_t = side ? mine : other;
  const float r = clamp_min((r_s != r_s || r_t != r_t) ? r_s + r_t
                                                        : fmaxf(r_s, r_t),
                            1e-30f);
  const float s = __fmul_rn(__frcp_rn(r), *scale_pre);

  // the cloud centred and scaled, padded rows 0, in flat (coalesced)
  // order
  float* o = (side ? tgt_c : src_c) + base;
  for (int i = t; i < 3 * width; i += kThreads) {
    const int row = i / 3, k = i - 3 * row;
    const float c = k == 0 ? c0 : (k == 1 ? c1 : c2);
    o[i] = row < rows ? __fmul_rn(__fsub_rn(p[i], c), s) : 0.0f;
  }
  if (t == 0) {
    float* cen = (side ? cen_t : cen_s) + 3 * b;
    cen[0] = c0;
    cen[1] = c1;
    cen[2] = c2;
    if (side == 0) scaling[b] = s;
  }
  cl.sync();         // the peer's read of this block's radius is done
}

}  // namespace

// src [B, Ns, 3], tgt [B, Nt, 3] float32, n_src / n_tgt [B] int32,
// scale_pre a float32 scalar on the card; src_c [B, Ns, 3], tgt_c
// [B, Nt, 3], cen_s / cen_t [B, 3], scaling [B] written.
extern "C" int se3icp_prep(const void* src, const void* n_src,
                           const void* tgt, const void* n_tgt,
                           const void* scale_pre, void* src_c, void* tgt_c,
                           void* cen_s, void* cen_t, void* scaling, int bsz,
                           int ns, int nt, void* stream) {
  if (bsz <= 0) return (int)cudaGetLastError();
  if (ns <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2u * (unsigned)bsz);
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * (3 * kThreads + 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, prep_kernel, (const float*)src, (const int*)n_src,
      (const float*)tgt, (const int*)n_tgt, (const float*)scale_pre,
      (float*)src_c, (float*)tgt_c, (float*)cen_s, (float*)cen_t,
      (float*)scaling, ns, nt);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
