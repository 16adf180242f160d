// Shared by the fused samplers (fused_ig.cu: K3, fused_normal.cu: K6): the
// Philox4x32-10 counter-based generator, the half-ulp uniform grid, a stable
// softplus and the block reduction of the per-sample log-q sums. Both
// samplers key their streams by (element, sample), never by block geometry,
// so their plain PyTorch twins draw the same bits
// (spmf_tpu_torch/ops/fused_ig.py::philox4x32).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float SQRT2 = 1.4142135623730951f;

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// U = m 2^-23 + 2^-24 for a 23-bit integer m lies on [2^-24, 1 - 2^-24]:
// log U is finite and 1 - U is exact, so 2(1-U)-1 is the exact negation of
// 2U-1.
__device__ __forceinline__ float uniform_from_u23(uint32_t m) {
  return __fadd_rn(__fmul_rn((float)m, 1.1920928955078125e-07f),
                   5.9604644775390625e-08f);
}

// the uniform of a Philox word: its top 23 bits
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return uniform_from_u23(bits >> 9);
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// block sum of a per-thread double, valid in thread 0
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace
