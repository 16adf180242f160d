// Fused Normal-surrogate sampler (forward K6f, backward K6b) for Hopper.
//
// Replaces the TPU kernels spmf_tpu/ops/fused_normal.py::_nfwd_kernel and
// ::_nbwd_kernel together with what the JAX code around them computes
// (_nprep's softplus(raw_scale), log scale and sigmoid(raw_scale)). Per
// element i of the flat Normal block (u, v, w, s) and ELBO sample s: one
// uniform from a Philox4x32-10 stream, eps = sqrt(2) erfinv(2u-1),
// x = loc + softplus(raw_scale) eps, y = softplus(x) where mask > 0 (a
// Softplus bijector) else x (Identity), and the per-sample sum of
//   log q(x) - fldj = -log(scale) - eps^2/2 - log(2 pi)/2 + mask softplus(-x).
// The backward replays the stream (nothing of sample shape is saved) and
// accumulates d(y, logq)/d(loc, raw_scale) over the samples.
//
// The stream: key (seed, 1) (K3 uses (seed, 0), so one seed never gives the
// two blocks the same uniform), counter (element, sample, 0, 0), and the
// first of the four output words. It never depends on block geometry, so
// forward, backward and the plain PyTorch twin draw the same bits.
//
// What bounds it on an H100: at total = 1,340,000 and S = 8 the forward reads
// three parameter vectors (16 MB) and writes y (43 MB), 59 MB or 0.018 ms at
// 3.35 TB/s, and does about 150 operations per element and sample (10 Philox
// rounds of 8 integer operations, erfinv, two softplus, a log), 1.6 G
// operations or 0.024 ms at 67 T/s; the backward reads gy instead of writing
// y and writes two vectors, 70 MB or 0.021 ms, with about the same
// arithmetic. Bytes and operations bind almost equally. The design keeps
// every intermediate in registers: scale, log scale and sigmoid(raw_scale)
// are computed in the kernel instead of three passes outside it; y is written
// once with neighbouring threads on neighbouring addresses; the per-sample
// log-q sums leave as per-block partials in double that the wrapper reduces
// (no atomics: deterministic); each backward thread owns one element and
// loops over the samples, so gloc and graw_scale are one plain store each
// with no cross-block reduction. The grid is cut to `total`, so there is no
// padding to mask. One Philox call yields four words and this kernel uses
// one: four samples per call is a later refinement.
#include "philox.cuh"

namespace {

constexpr float HALF_LOG_2PI = 0.9189385332046727f;

// the replay contract of forward, backward and twin
__device__ __forceinline__ float draw_eps(uint32_t idx, uint32_t sample,
                                          uint32_t seed) {
  const U4 r = philox4x32_10(U4{idx, sample, 0u, 0u}, seed, 1u);
  return SQRT2 * erfinvf(2.0f * uniform_from_bits(r.x) - 1.0f);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// grid (ceil(total/THREADS), S): one thread per (element, sample).
__global__ void __launch_bounds__(THREADS)
normal_fwd_kernel(const float* __restrict__ loc,
                  const float* __restrict__ raw_scale,
                  const float* __restrict__ mask,
                  const int* __restrict__ seed_ptr, float* __restrict__ y,
                  double* __restrict__ lq_part, int total) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  double lq = 0.0;
  if (i < total) {
    const float eps = draw_eps((uint32_t)i, (uint32_t)s, (uint32_t)seed_ptr[0]);
    const float scale = softplusf(raw_scale[i]);
    const float m = mask[i];
    const float x = loc[i] + scale * eps;
    y[(size_t)s * total + i] = m > 0.0f ? softplusf(x) : x;
    lq = (double)(-logf(scale) - 0.5f * eps * eps - HALF_LOG_2PI +
                  m * softplusf(-x));
  }
  lq = block_sum(lq);
  if (threadIdx.x == 0) lq_part[(size_t)s * gridDim.x + blockIdx.x] = lq;
}

// grid ceil(total/THREADS): one thread per element, looping over samples.
__global__ void __launch_bounds__(THREADS)
normal_bwd_kernel(const float* __restrict__ loc,
                  const float* __restrict__ raw_scale,
                  const float* __restrict__ mask,
                  const int* __restrict__ seed_ptr,
                  const float* __restrict__ glq, const float* __restrict__ gy,
                  float* __restrict__ gloc, float* __restrict__ grs, int total,
                  int S) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const float li = loc[i], rsi = raw_scale[i], m = mask[i];
  const float scale = softplusf(rsi);
  const float sig_rs = sigmoidf(rsi);
  const float dlogscale_drs = sig_rs / scale;
  float gl = 0.0f, gr = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float eps = draw_eps((uint32_t)i, (uint32_t)s, seed);
    const float x = li + scale * eps;
    const float sig_x = sigmoidf(x);
    const float dy_dx = m > 0.0f ? sig_x : 1.0f;
    const float dlq_dx = m * (sig_x - 1.0f);
    const float dx_drs = eps * sig_rs;
    const float gys = gy[(size_t)s * total + i], glqs = glq[s];
    gl += gys * dy_dx + glqs * dlq_dx;
    gr += gys * dy_dx * dx_drs + glqs * (dlq_dx * dx_drs - dlogscale_drs);
  }
  gloc[i] = gl;
  grs[i] = gr;
}

}  // namespace

extern "C" int normal_fwd(const float* loc, const float* raw_scale,
                          const float* mask, const int* seed, float* y,
                          double* lq_part, int total, int S, void* stream) {
  const dim3 grid((total + THREADS - 1) / THREADS, S);
  normal_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      loc, raw_scale, mask, seed, y, lq_part, total);
  return (int)cudaGetLastError();
}

extern "C" int normal_bwd(const float* loc, const float* raw_scale,
                          const float* mask, const int* seed, const float* glq,
                          const float* gy, float* gloc, float* grs, int total,
                          int S, void* stream) {
  const int grid = (total + THREADS - 1) / THREADS;
  normal_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      loc, raw_scale, mask, seed, glq, gy, gloc, grs, total, S);
  return (int)cudaGetLastError();
}
