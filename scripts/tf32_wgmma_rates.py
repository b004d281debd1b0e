"""TF32 wgmma throughput on one NVIDIA GPU at the shapes of the wide fp32
flash kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu`` above D = 128):
m64nNk8 for N = 16, 32 and 64, with A from registers (each k8 step's A
fragment loaded from a swizzled shared-memory tile and split into its two
TF32 parts, as ``mma3_ra`` does) or A from shared memory (both operands by
descriptor, as ``mma3_ss`` does), issued by one or by two warpgroups of a
CTA. Each CTA runs 32 k8 steps of three products (one 3xTF32 product at
D = 256) over and over, one CTA an SM. Prints the card's name and power
limit, then one JSON line of TFLOP/s (TF32 peak 495); exits nonzero
without a card.

    python3 scripts/tf32_wgmma_rates.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flashattention_tpu_torch import _build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include "tf32_sm90.cuh"
using namespace fat::sm90;

// MODE 0: A in registers, loaded and split per k8 step; 1: A and B in
// shared memory. WG warpgroups issue at once, each its own accumulator.
template <int N, int MODE, int WG>
__global__ void __launch_bounds__(128 * WG, 1) rate(int iters, float* out) {
  extern __shared__ char smem_raw[];
  char* a_s = align_1024(smem_raw);  // 64 rows x 256 fp32
  char* b_s = a_s + 65536;           // N rows x 256 fp32
  const int t = threadIdx.x % 128;
  for (int i = threadIdx.x; i < (65536 + N * 1024) / 4; i += blockDim.x) {
    reinterpret_cast<float*>(a_s)[i] = 0.001f * (i % 97);
  }
  __syncthreads();
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    if constexpr (MODE == 0) {
      mma3_ra<64, N, 32, 4, 1>(acc, a_s, 1.f, b_s, b_s, t);
    } else {
      wgmma_fence();
      mma3_ss<64, N, 32>(acc, a_s, a_s, 0, b_s, b_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  if (s == 12345.f) out[0] = s;
}

template <int N, int MODE, int WG>
float run(int iters, int sms) {
  auto k = rate<N, MODE, WG>;
  const int smem = 1024 + 65536 + N * 1024;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) {
    return -1.f;
  }
  float* out;
  if (cudaMalloc(&out, 4) != cudaSuccess) return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  k<<<sms, 128 * WG, smem>>>(2, out);
  cudaEventRecord(e0);
  k<<<sms, 128 * WG, smem>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1.f;
  // 96 wgmmas of 64 x N x 8 multiply-adds an iteration, each warpgroup
  return (float)((double)sms * WG * iters * 96 * 64 * N * 8 * 2 /
                 (ms * 1e-3) / 1e12);
}

extern "C" int tf32_wgmma_rates(int sms, float* res) {
  const int it = 2000;
  int i = 0;
  res[i++] = run<16, 0, 1>(it, sms);
  res[i++] = run<16, 0, 2>(it, sms);
  res[i++] = run<16, 1, 1>(it, sms);
  res[i++] = run<32, 0, 1>(it, sms);
  res[i++] = run<32, 0, 2>(it, sms);
  res[i++] = run<32, 1, 1>(it, sms);
  res[i++] = run<64, 0, 1>(it, sms);
  res[i++] = run<64, 0, 2>(it, sms);
  res[i++] = run<64, 1, 1>(it, sms);
  return i;
}
"""
NAMES = [f"n{n} {'registers' if mode == 0 else 'shared'} {wg}wg"
         for n in (16, 32, 64) for mode, wg in ((0, 1), (0, 2), (1, 1))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tf32_wgmma_rates: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "tf32_wgmma_rates.cu"
    lib_path = _build.BUILD_DIR / "libtf32_wgmma_rates.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC_DIR), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    res = (ctypes.c_float * len(NAMES))()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = lib.tf32_wgmma_rates(sms, res)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "tflops": {NAMES[i]: res[i] for i in range(n)}}))
    return 0 if all(res[i] > 0 for i in range(n)) else 1


if __name__ == "__main__":
    sys.exit(main())
