#!/usr/bin/env python3
"""The card's rates for the instructions the split-TF32 kernels are made of:
``mma.sync.aligned.m16n8k8`` with TF32 operands (independent accumulators,
several warps an SM) and the two ways of rounding a float32 to TF32, the
conversion instruction ``cvt.rna.tf32.f32`` and the same bits in integer
arithmetic (``(bits + 0x1000) & 0xffffe000``, csrc/split_tf32.cuh's
``tf32_rna_int``).

    python3 benchmarks/torch_tf32_rates.py

Builds a small CUDA program with nvcc into spmf_tpu_torch/_build/ and
prints one JSON line: mma.sync TF32 TFLOP/s at 4, 8 and 16 warps an SM with
8 and with 2 independent accumulators a warp, and each rounding's results a
clock and SM, at the card's reported clock. Needs the card and nvcc; exits
2 without them.
"""
import json
import os
import subprocess
import sys

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int CH>
__global__ void mma_rate(float* out, int iters) {
  float acc[CH][4];
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j) mma(acc[j], a, b0, b1);
  }
  float s = 0.f;
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool CVT>
__global__ void round_rate(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * 0.37f + j;
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t r;
      if (CVT) asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x[j]));
      else r = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;
      acc ^= r;
      x[j] += 1.0f;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = (float)acc;
}
template <typename F>
float time_ms(F f) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  f();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  f();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
int main() {
  int sms, khz;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  float* out;
  cudaMalloc(&out, (size_t)sms * 1024 * sizeof(float));
  const int iters = 20000;
  printf("{\"sms\": %d, \"clock_khz\": %d, \"mma_tf32_tflops\": {", sms, khz);
  const int warps[3] = {4, 8, 16};
  for (int w = 0; w < 3; ++w) {
    const int th = 32 * warps[w];
    const float m8 = time_ms([&] { mma_rate<8><<<sms, th>>>(out, iters); });
    const float m2 = time_ms([&] { mma_rate<2><<<sms, th>>>(out, iters); });
    const double f8 = 2048.0 * sms * warps[w] * iters * 8, f2 = 2048.0 * sms * warps[w] * iters * 2;
    printf("%s\"%d warps, 8 chains\": %.1f, \"%d warps, 2 chains\": %.1f", w ? ", " : "", warps[w],
           f8 / m8 / 1e9, warps[w], f2 / m2 / 1e9);
  }
  const int th = 32 * 8;
  const float mc = time_ms([&] { round_rate<true><<<sms, th>>>(out, iters); });
  const float mi = time_ms([&] { round_rate<false><<<sms, th>>>(out, iters); });
  const double n = 1.0 * sms * th * iters * 8, clk = khz * 1e3;
  printf("}, \"cvt_rna_per_sm_clock\": %.1f, \"int_rna_per_sm_clock\": %.1f}\n",
         n / (mc * 1e-3) / sms / clk, n / (mi * 1e-3) / sms / clk);
  return cudaGetLastError() != cudaSuccess;
}
'''


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from spmf_tpu_torch.ops import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        print(f"torch_tf32_rates: {e}", file=sys.stderr)
        sys.exit(2)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "tf32_rates.cu")
    exe = os.path.join(_build.BUILD_DIR, "tf32_rates")
    with open(src, "w") as f:
        f.write(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-o", exe, src], check=True, capture_output=True)
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        print(f"torch_tf32_rates: {run.stdout}{run.stderr}", file=sys.stderr)
        sys.exit(2)
    row = json.loads(run.stdout)
    row["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
