// CPU emulation of the CUDA built-ins that the setup kernels
// (se3_icp_tpu_torch/csrc/thresholds.cu, moments.cu), the 1-NN kernels
// (nn_argmin.cu) and the loop's match kernel (match_affine.cu) use, so
// that their sources can be compiled with a host C++20 compiler and run
// against the plain PyTorch versions on a machine without a GPU
// (tests/test_torch_kernels_emulated.py installs this file as
// cuda_runtime.h, and cuda_pipeline_primitives.h includes it).
//
// One OS thread per CUDA thread of a block; the blocks of a grid run one
// after another on the same threads.  __syncthreads is a block-wide
// barrier, warp shuffles and reductions exchange through a per-warp
// buffer between two warp barriers, __shared__ arrays are function
// statics (one block at a time uses them).  The explicitly rounded float
// intrinsics are plain IEEE float operations (compile with
// -ffp-contract=off); __fsqrt_rn is std::sqrt, correctly rounded.  The
// cp.async pipeline calls copy at once: __pipeline_memcpy_async is a
// memcpy, commit and wait do nothing (the kernels' barriers still order
// the copies against the reads).
// Launch geometry, registers and timing are not emulated.

#pragma once

#include <algorithm>
#include <barrier>
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
#define __restrict__
#define __launch_bounds__(...)

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

struct EmuWarp {
  std::barrier<>* bar;
  float* fbuf;
  int* ibuf;
};
inline thread_local std::barrier<>* emu_block_bar;
inline thread_local EmuWarp emu_warp;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

inline void __pipeline_memcpy_async(void* dst, const void* src,
                                    std::size_t size) {
  std::memcpy(dst, src, size);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}

inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31;
  emu_warp.fbuf[lane] = v;
  emu_warp.bar->arrive_and_wait();
  const float r = emu_warp.fbuf[lane ^ o];
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

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, [&] { kernel(args); })
template <class F>
void emu_launch(dim3 grid, unsigned threads, F f) {
  const unsigned warps = (threads + 31) / 32;
  std::barrier<> block_bar(threads), end_bar(threads);
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (unsigned w = 0; w < warps; ++w) warp_bars.emplace_back(new std::barrier<>(32));
  std::vector<float> fbuf(32 * warps);
  std::vector<int> ibuf(32 * warps);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      threadIdx = {t, 0, 0};
      emu_block_bar = &block_bar;
      emu_warp = {warp_bars[t / 32].get(), &fbuf[32 * (t / 32)], &ibuf[32 * (t / 32)]};
      for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = {bx, by, 0};
          f();
          end_bar.arrive_and_wait();   // the block is done before the next
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}
