#!/usr/bin/env python3
"""Achieved float32 FMA rate of the card, as a yardstick for the
operation bounds that ``chip_smoke.py`` states against the data sheet's
67 TFLOP/s.

    python3 tools/fma_peak.py

Builds (nvcc, sm_90a, the package's flags) a kernel whose threads run
``chains`` independent FMA chains (1, 2, 4 or 8) of ``STEPS`` FMAs
each, operands in registers, one result stored a thread so nothing is
dropped, and times it with CUDA events at 16, 32 and 64 warps an SM:
how many independent FMAs a scheduler needs in flight to reach the
peak.  With 8 chains it also times the K4 inner loop's mix per pair (12
FMAs and one min).  Prints one JSON line with the achieved TFLOP/s (an
FMA counts two) and the SM clock and power that nvidia-smi reads while
the kernels run.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHAINS, STEPS = (1, 2, 4, 8), 4096
SOURCE = r"""
#include <cuda_runtime.h>
template <bool kMin>
__global__ void fma_kernel(float* out, float a, float b) {
  float x[%(chains)d];
  float m = 3.0e38f;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) x[c] = threadIdx.x * 1e-3f + c;
#pragma unroll 4
  for (int s = 0; s < %(steps)d; s += 12) {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
#pragma unroll
      for (int c = 0; c < %(chains)d; ++c) x[c] = fmaf(x[c], a, b);
    }
    if (kMin) {
#pragma unroll
      for (int c = 0; c < %(chains)d; ++c) m = fminf(m, x[c]);
    }
  }
  float s = m;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) s += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(void* out, int blocks, int threads, int with_min,
                   void* stream) {
  if (with_min) {
    fma_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)out, 0.999f, 1e-3f);
  } else {
    fma_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)out, 0.999f, 1e-3f);
  }
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fma_peak: no CUDA device", file=sys.stderr)
        return 2
    from se3_icp_tpu_torch.ops import _build
    steps = STEPS // 12 * 12
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for chains in CHAINS:
            src = os.path.join(tmp, f"fma{chains}.cu")
            with open(src, "w") as f:
                f.write(SOURCE % dict(chains=chains, steps=steps))
            lib_path = os.path.join(tmp, f"libfma{chains}.so")
            subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-shared", src, "-o", lib_path], check=True)
            libs[chains] = ctypes.CDLL(lib_path)
            libs[chains].run.argtypes = [ctypes.c_void_p] + \
                [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads = 256
    out = torch.empty(sms * 8 * threads, device="cuda")
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
            time.sleep(0.25)

    results = {}
    th = threading.Thread(target=sample)
    th.start()
    try:
        for chains, with_min in [(c, 0) for c in CHAINS] + [(8, 1)]:
            lib = libs[chains]
            for per_sm in (2, 4, 8):         # blocks of 256 an SM
                blocks = sms * per_sm
                stream = torch.cuda.current_stream().cuda_stream
                lib.run(out.data_ptr(), blocks, threads, with_min, stream)
                torch.cuda.synchronize()
                reps = 20
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    _build.check(lib.run(out.data_ptr(), blocks, threads,
                                         with_min, stream), "fma_peak")
                b.record()
                torch.cuda.synchronize()
                sec = a.elapsed_time(b) / 1e3 / reps
                fmas = blocks * threads * chains * steps
                results[f"{'fma+min' if with_min else 'fma'}, {chains} "
                        f"chains, {per_sm * threads // 32} warps/SM"] = dict(
                    ms=sec * 1e3, tflops=2 * fmas / sec / 1e12)
    finally:
        stop.set()
        th.join()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"phase": "fma_peak", "card": smi,
                      "fmas_per_chain": steps,
                      "results": results, "clock_power": samples}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
