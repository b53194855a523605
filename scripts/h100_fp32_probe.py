#!/usr/bin/env python3
"""What one NVIDIA card reaches in FP32 on its CUDA cores, as a yardstick for
the port's hand-written kernels (``csrc/vq_nearest.cu`` is bound by it).

    python3 scripts/h100_fp32_probe.py

Needs a CUDA card and nvcc. Builds four small kernels into ``build/probe/``
and prints, in TFLOP/s (two operations an FMA), on one block of 256 threads
per SM unless it says otherwise:

* ``chain``: 16 independent FMA chains a thread on two constant operands, the
  card's rate for an FMA stream that reads one register operand a cycle;
* ``outer``: an 8 x 8 outer product from registers, three register operands
  an FMA, as every tiled matrix product has it;
* ``k-contiguous``: the inner loop of ``vq_nearest.cu``: both operands read
  from shared memory as float4 along the feature axis, four chained FMAs an
  accumulator, one barrier per 16 features;
* ``feature-major``: the classic SGEMM inner loop: float4 along the rows of a
  tile stored feature-major, 64 independent FMAs a feature, one barrier per
  16 features;
* ``sgemm``: ``torch.matmul`` of two 8192 x 8192 float32 matrices, TF32 off.

Before them the card's name and power limit as nvidia-smi gives them, and
after them the SM clock read while the kernels ran.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUILD = REPO / "build" / "probe"

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) chain(float* out, int iters, float s) {
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = threadIdx.x * 0.001f + i;
  const float a = s, b = s * 0.5f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(acc[i], a, b);
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) t += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

// per pass 64 FMAs and 16 operand updates: 80 instructions
__global__ void __launch_bounds__(256) outer(float* out, int iters, float s) {
  float acc[8][8], a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = s + i + threadIdx.x;
    b[i] = s * 0.5f - i + threadIdx.x * 0.25f;
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;
  }
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] += 1.0f;
        b[i] -= 0.5f;
      }
    }
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) t += acc[i][u];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

// rows of 16 features at a stride of 20 floats, float4 along the features
__global__ void __launch_bounds__(256) k_contiguous(float* out, int iters) {
  __shared__ float4 sm4[2 * 128 * 20 / 4];
  float* xs = (float*)sm4;
  float* es = xs + 128 * 20;
  for (int i = threadIdx.x; i < 128 * 20; i += 256) {
    xs[i] = i * 1e-4f;
    es[i] = 1.f - i * 1e-4f;
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;
  const float* xa = xs + ty * 20;
  const float* eb = es + tx * 20;
  for (int it = 0; it < iters; ++it) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *(const float4*)(xa + i * 16 * 20 + j);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float4 b = *(const float4*)(eb + t * 16 * 20 + j);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = acc[i][t];
          v = fmaf(a[i].x, b.x, v);
          v = fmaf(a[i].y, b.y, v);
          v = fmaf(a[i].z, b.z, v);
          v = fmaf(a[i].w, b.w, v);
          acc[i][t] = v;
        }
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) s += acc[i][t];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// tiles stored [feature][128 rows], float4 along the rows
__global__ void __launch_bounds__(256) feature_major(float* out, int iters) {
  __shared__ float4 sm4[2 * 16 * 128 / 4];
  float* xs = (float*)sm4;
  float* es = xs + 16 * 128;
  for (int i = threadIdx.x; i < 16 * 128; i += 256) {
    xs[i] = i * 1e-4f;
    es[i] = 1.f - i * 1e-4f;
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;
  for (int it = 0; it < iters; ++it) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float4 a0 = *(const float4*)(xs + k * 128 + ty * 4);
      const float4 a1 = *(const float4*)(xs + k * 128 + 64 + ty * 4);
      const float4 b0 = *(const float4*)(es + k * 128 + tx * 4);
      const float4 b1 = *(const float4*)(es + k * 128 + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) s += acc[i][t];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int run(int which, float* out, int blocks, int iters, void* st) {
  cudaStream_t s = (cudaStream_t)st;
  if (which == 0) chain<<<blocks, 256, 0, s>>>(out, iters, 1.0001f);
  if (which == 1) outer<<<blocks, 256, 0, s>>>(out, iters, 1.0001f);
  if (which == 2) k_contiguous<<<blocks, 256, 0, s>>>(out, iters);
  if (which == 3) feature_major<<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

# FMAs a thread per iteration of each kernel's outer loop
KERNELS = (("chain", 8 * 16), ("outer", 16 * 64), ("k-contiguous", 16 * 64), ("feature-major", 16 * 64))
SMI = ["nvidia-smi", "--format=csv,noheader"]


def main() -> int:
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    if not torch.cuda.is_available() or CUDA_HOME is None:
        print("h100_fp32_probe: needs a CUDA card and nvcc", file=sys.stderr)
        return 1
    print(subprocess.run(SMI + ["--query-gpu=name,power.limit"], capture_output=True, text=True, check=True).stdout.strip())
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "probe.cu").write_text(SOURCE)
    subprocess.run([f"{CUDA_HOME}/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(BUILD / "probe.so"), str(BUILD / "probe.cu")], check=True)
    run = ctypes.CDLL(str(BUILD / "probe.so")).run
    run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 2 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls

    clocks, done = set(), threading.Event()

    def poll():
        while not done.is_set():
            clocks.add(subprocess.run(SMI + ["--query-gpu=clocks.sm"], capture_output=True, text=True).stdout.strip())
            time.sleep(0.2)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        iters = 4000
        for which, (name, fmas) in enumerate(KERNELS):
            for blocks_per_sm in (1, 2):
                def launch():
                    if run(which, out.data_ptr(), sms * blocks_per_sm, iters, stream):
                        raise RuntimeError(f"{name} did not launch")
                t = ms(launch)
                print(f"{name}, {blocks_per_sm} block(s) of 256 threads an SM: "
                      f"{sms * blocks_per_sm * 256 * iters * fmas * 2 / t / 1e9:.1f} TFLOP/s", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        a = torch.randn(8192, 8192, device="cuda")
        b = torch.randn(8192, 8192, device="cuda")
        print(f"sgemm 8192^3, TF32 off: {2 * 8192**3 / ms(lambda: a @ b) / 1e9:.1f} TFLOP/s")
    finally:
        done.set()
        poller.join()
    print("SM clock while running:", ", ".join(sorted(clocks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
