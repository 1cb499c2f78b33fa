#!/usr/bin/env python3
"""Time a warp's shared-memory loads on one GPU, by the address pattern of
its lanes: the cost model behind K6's register tiles (csrc/head_tail.cu).

    python3 tools/smem_loads.py

One block of 1024 threads on one SM loads from shared memory in a loop
(16 loads an iteration, each feeding one float add of eight independent
sums) and reads clock64 around it; the line gives the SM's cycles per
warp-wide load instruction. Patterns: 16-byte loads with one address across
the warp, with 8 addresses (4 lanes each, rows 144 bytes apart, as K6's
old tile read y3), with 4 addresses (lanes interleaved, and a quarter warp
each) and with 32 distinct consecutive addresses; 4-byte loads with one
address; 8-byte loads with 32 distinct addresses. The source is built by
nvcc into build/smem_loads/, removed at the end.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from segmentation_factory_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "smem_loads"
PATTERNS = {  # mode: (name, float offset of lane `lane`)
    0: ("16B one address", "0"),
    1: ("16B 8 addresses, 4 lanes each, rows 144 B apart", "(lane >> 2) * 36"),
    2: ("16B 32 distinct consecutive", "lane * 4"),
    3: ("4B one address", "0"),
    4: ("8B 32 distinct consecutive", "lane * 2"),
    5: ("16B 4 addresses, lanes interleaved", "(lane & 3) * 4"),
    6: ("16B 4 addresses, a quarter warp each", "(lane >> 3) * 4"),
}
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ int offset(int mode, int lane) {
  switch (mode) {
%s
  }
  return 0;
}
extern "C" __global__ void bench(int mode, int iters, float* out, long long* cyc) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm + offset(mode, threadIdx.x & 31));
  float acc[8] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float x, w = 0.f;
      if (mode == 3) {
        asm volatile("ld.shared.f32 %%0, [%%1];" : "=f"(x) : "r"(base + k * 16));
      } else if (mode == 4) {
        asm volatile("ld.shared.v2.f32 {%%0,%%1}, [%%2];" : "=f"(x), "=f"(w) : "r"(base + k * 256));
      } else {
        float y, z;
        asm volatile("ld.shared.v4.f32 {%%0,%%1,%%2,%%3}, [%%4];"
                     : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(base + k * 512));
      }
      acc[k & 7] += x + w;
    }
  }
  const long long t1 = clock64();
  float a = 0.f;
  for (int k = 0; k < 8; ++k) a += acc[k];
  out[threadIdx.x] = a;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}
extern "C" int run(int mode, int iters, double* per_load) {
  const int threads = 1024;
  float* out;
  long long* cyc;
  cudaMalloc(&out, threads * sizeof(float));
  cudaMalloc(&cyc, sizeof(long long));
  for (int rep = 0; rep < 2; ++rep) bench<<<1, threads>>>(mode, iters, out, cyc);
  long long h = 0;
  cudaMemcpy(&h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  *per_load = (double)h / ((double)iters * 16 * (threads / 32));
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    cases = "\n".join(f"    case {m}: return {expr};" for m, (_, expr) in PATTERNS.items())
    (OUT / "smem_loads.cu").write_text(SOURCE % cases)
    so = OUT / "smem_loads.so"
    try:
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                              str(OUT / "smem_loads.cu")], capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        out = {}
        for mode, (name, _) in PATTERNS.items():
            v = ctypes.c_double()
            if lib.run(mode, 200, ctypes.byref(v)):
                print(f"smem_loads: no CUDA device or launch failed ({name})", file=sys.stderr)
                return 2
            out[name] = v.value
        print(json.dumps({"cycles_per_warp_load_per_sm": out}), flush=True)
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
