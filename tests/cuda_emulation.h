// CPU emulation of the CUDA built-ins that the setup kernels
// (se3_icp_tpu_torch/csrc/thresholds.cu, moments.cu), the 1-NN kernels
// (nn_argmin.cu), the loop's match kernel (match_affine.cu) and its
// epilogue (loop_epilogue.cu) use, so that their sources can be compiled
// with a host C++20 compiler and run against the plain PyTorch versions
// on a machine without a GPU (tests/test_torch_kernels_emulated.py
// installs this file as cuda_runtime.h, and cuda_pipeline_primitives.h,
// cooperative_groups.h and math_constants.h include it).
//
// One OS thread per CUDA thread of a block; the blocks of a grid run one
// after another on the same threads.  __syncthreads is a block-wide
// barrier, warp shuffles and reductions exchange through a per-warp
// buffer between two warp barriers, __shared__ arrays are function
// statics (one block at a time uses them).  The explicitly rounded float
// intrinsics are plain IEEE float operations (compile with
// -ffp-contract=off); __fsqrt_rn is std::sqrt and __frcp_rn 1 / x,
// both correctly rounded; __syncwarp is the warp's barrier.  The
// cp.async pipeline calls copy at once: __pipeline_memcpy_async is a
// memcpy, commit and wait do nothing (the kernels' barriers still order
// the copies against the reads).
// Thread-block clusters (cudaLaunchKernelEx with a cluster dimension):
// the blocks of one cluster run together, one OS thread per CUDA thread
// of each, and clusters one after another.  Each block has its own
// dynamic shared memory (``extern __shared__`` arrays, which the test
// rewrites into emu_dyn_smem() pointers); cooperative_groups'
// cluster.sync() is a barrier over the cluster's threads and
// map_shared_rank maps an address of the block's dynamic shared memory
// to the same offset in another block's.  A kernel launched as a
// cluster must keep all its shared data in dynamic shared memory (the
// statics would be shared by the cluster's blocks).
// Launch geometry limits, registers and timing are not emulated.

#pragma once

#include <algorithm>
#include <barrier>
#include <bit>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __launch_bounds__(...)
#define CUDART_PI_F 3.141592654f

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline thread_local uint3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 10
};
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }

struct EmuWarp {
  std::barrier<>* bar;
  float* fbuf;
  int* ibuf;
};
inline thread_local std::barrier<>* emu_block_bar;
inline thread_local EmuWarp emu_warp;
// this block's dynamic shared memory, every block's of its cluster, the
// block's rank in the cluster, the cluster-wide barrier
inline thread_local unsigned char* emu_smem;
inline thread_local const std::vector<unsigned char*>* emu_cluster_smem;
inline thread_local unsigned emu_rank;
inline thread_local std::barrier<>* emu_cluster_bar;

inline void* emu_dyn_smem() { return emu_smem; }

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}

inline void __pipeline_memcpy_async(void* dst, const void* src,
                                    std::size_t size) {
  std::memcpy(dst, src, size);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp.bar->arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31;
  emu_warp.fbuf[lane] = v;
  emu_warp.bar->arrive_and_wait();
  const float r = emu_warp.fbuf[lane ^ o];
  emu_warp.bar->arrive_and_wait();
  return r;
}

inline float __shfl_down_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31;
  emu_warp.fbuf[lane] = v;
  emu_warp.bar->arrive_and_wait();
  const float r = lane + o < 32 ? emu_warp.fbuf[lane + o] : v;
  emu_warp.bar->arrive_and_wait();
  return r;
}

inline float __shfl_sync(unsigned, float v, int src) {
  const int lane = threadIdx.x & 31;
  emu_warp.fbuf[lane] = v;
  emu_warp.bar->arrive_and_wait();
  const float r = emu_warp.fbuf[src & 31];
  emu_warp.bar->arrive_and_wait();
  return r;
}

inline int __shfl_sync(unsigned, int v, int src) {
  const int lane = threadIdx.x & 31;
  emu_warp.ibuf[lane] = v;
  emu_warp.bar->arrive_and_wait();
  const int r = emu_warp.ibuf[src & 31];
  emu_warp.bar->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned, bool v) {
  const int lane = threadIdx.x & 31;
  emu_warp.ibuf[lane] = v ? 1 : 0;
  emu_warp.bar->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= emu_warp.ibuf[i] != 0 ? 1u << i : 0u;
  emu_warp.bar->arrive_and_wait();
  return r;
}

inline int __popc(unsigned v) { return std::popcount(v); }

inline bool __any_sync(unsigned, bool v) {
  const int lane = threadIdx.x & 31;
  emu_warp.ibuf[lane] = v ? 1 : 0;
  emu_warp.bar->arrive_and_wait();
  bool r = false;
  for (int i = 0; i < 32; ++i) r = r || emu_warp.ibuf[i] != 0;
  emu_warp.bar->arrive_and_wait();
  return r;
}

inline int __reduce_add_sync(unsigned, int v) {
  const int lane = threadIdx.x & 31;
  emu_warp.ibuf[lane] = v;
  emu_warp.bar->arrive_and_wait();
  int s = 0;
  for (int i = 0; i < 32; ++i) s += emu_warp.ibuf[i];
  emu_warp.bar->arrive_and_wait();
  return s;
}

using std::fmaf;
using std::fmaxf;
using std::fminf;
using std::max;
using std::min;

namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster_bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_rank; }
  unsigned num_blocks() const {
    return static_cast<unsigned>(emu_cluster_smem->size());
  }
  template <class T>
  T* map_shared_rank(T* addr, unsigned rank) const {
    const auto off = reinterpret_cast<unsigned char*>(addr) - emu_smem;
    return reinterpret_cast<T*>((*emu_cluster_smem).at(rank) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// Runs f() as the kernel body on a grid of clusters of `cluster` blocks
// along x (1: plain blocks), `threads` a block, `smem` bytes of dynamic
// shared memory a block.
template <class F>
void emu_run(dim3 grid, unsigned threads, unsigned cluster, std::size_t smem,
             F f) {
  const unsigned warps = (threads + 31) / 32, total = cluster * threads;
  std::vector<std::unique_ptr<std::barrier<>>> block_bars, warp_bars;
  for (unsigned r = 0; r < cluster; ++r) {
    block_bars.emplace_back(new std::barrier<>(threads));
    for (unsigned w = 0; w < warps; ++w)
      warp_bars.emplace_back(new std::barrier<>(32));
  }
  std::barrier<> cluster_bar(total), end_bar(total);
  std::vector<float> fbuf(32 * warps * cluster);
  std::vector<int> ibuf(32 * warps * cluster);
  std::vector<std::vector<float4>> mem(cluster,
                                       std::vector<float4>(smem / 16 + 1));
  std::vector<unsigned char*> bases;
  for (auto& m : mem) bases.push_back(reinterpret_cast<unsigned char*>(m.data()));
  std::vector<std::thread> pool;
  for (unsigned g = 0; g < total; ++g) {
    pool.emplace_back([&, g] {
      const unsigned r = g / threads, t = g % threads, w = r * warps + t / 32;
      threadIdx = {t, 0, 0};
      emu_block_bar = block_bars[r].get();
      emu_warp = {warp_bars[w].get(), &fbuf[32 * w], &ibuf[32 * w]};
      emu_smem = bases[r];
      emu_cluster_smem = &bases;
      emu_rank = r;
      emu_cluster_bar = &cluster_bar;
      for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned cx = 0; cx < grid.x / cluster; ++cx) {
          blockIdx = {cx * cluster + r, by, 0};
          f();
          end_bar.arrive_and_wait();   // the cluster is done before the next
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, smem, [&] { kernel(args); })
template <class F>
void emu_launch(dim3 grid, unsigned threads, std::size_t smem, F f) {
  emu_run(grid, threads, 1, smem, f);
}

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  std::size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

template <class... KArgs, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(KArgs...), Args&&... args) {
  unsigned cluster = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a) {
    const cudaLaunchAttribute& at = cfg->attrs[a];
    if (at.id != cudaLaunchAttributeClusterDimension) continue;
    if (at.val.clusterDim.y != 1 || at.val.clusterDim.z != 1 ||
        at.val.clusterDim.x < 1 || at.val.clusterDim.x > 8)
      return cudaErrorInvalidConfiguration;
    cluster = at.val.clusterDim.x;
  }
  if (cfg->gridDim.x % cluster != 0) return cudaErrorInvalidConfiguration;
  emu_run(cfg->gridDim, cfg->blockDim.x, cluster, cfg->dynamicSmemBytes,
          [&] { kernel(args...); });
  return cudaSuccess;
}
