// Fused InverseGamma-surrogate sampler (forward K3f, backward K3b) for Hopper.
//
// Replaces the TPU kernels spmf_tpu/ops/fused_ig.py::_fwd_kernel and
// ::_bwd_kernel. Per element and ELBO sample: 9 uniforms from a Philox4x32-10
// stream, eps = sqrt(2) erfinv(2u-1) and the Stuart log-uniform sums, the
// boosted Wilson-Hilferty gamma g, y = softplus(b/g), and the per-sample sum
// of log q_IG - fldj_softplus. The backward replays the same stream (nothing
// of sample shape is saved) and accumulates d(y, logq)/d(a, b) over samples.
//
// What bounds it on an H100: arithmetic. Per element-sample it does ~15
// transcendentals (erfinv, 8 logs, exp, softplus) and 30 Philox rounds; it
// reads 16 bytes of parameters and writes 4 bytes of y. The design keeps all
// randomness in registers (the TPU's hardware PRNG has no counterpart here,
// so Philox is keyed by (seed, 0) and counted by (element, stream, j, 0):
// the stream never depends on block geometry, which lets the plain PyTorch
// twin draw the same bits), writes per-block partial log-q sums instead of
// using atomics (deterministic), and gives each backward thread one element
// looping over the samples, so the backward needs no cross-block reduction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BOOST = 8;
constexpr int THREADS = 256;
constexpr float SQRT2 = 1.4142135623730951f;
constexpr float G_FLOOR = 1.0842021724855044e-19f;  // sqrt(FLT_MIN) = 2^-63

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

// U = (bits >> 9) 2^-23 + 2^-24 lies on [2^-24, 1 - 2^-24]: log U is finite
// and 1 - U is exact, so 2(1-U)-1 is the exact negation of 2U-1.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fadd_rn(__fmul_rn((float)(bits >> 9), 1.1920928955078125e-07f),
                   5.9604644775390625e-08f);
}

// The draw order is the replay contract between forward and backward and
// with the twin: u0 -> eps, u1..u8 -> the boost log-uniforms.
__device__ __forceinline__ void draw_eps_s1_s2(uint32_t idx, uint32_t stream,
                                               uint32_t seed, bool mirror,
                                               float a, float& eps, float& s1,
                                               float& s2) {
  float u[12];
#pragma unroll
  for (uint32_t j = 0; j < 3; ++j) {
    const U4 r = philox4x32_10(U4{idx, stream, j, 0u}, seed, 0u);
    u[4 * j + 0] = uniform_from_bits(r.x);
    u[4 * j + 1] = uniform_from_bits(r.y);
    u[4 * j + 2] = uniform_from_bits(r.z);
    u[4 * j + 3] = uniform_from_bits(r.w);
  }
  if (mirror) {
#pragma unroll
    for (int k = 0; k <= BOOST; ++k) u[k] = 1.0f - u[k];
  }
  eps = SQRT2 * erfinvf(2.0f * u[0] - 1.0f);
  s1 = 0.0f;
  s2 = 0.0f;
#pragma unroll
  for (int k = 0; k < BOOST; ++k) {
    const float logu = logf(u[k + 1]);
    const float w = 1.0f / (a + (float)k);
    s1 += logu * w;
    s2 += logu * w * w;
  }
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float wh_gamma(float a, float eps, float s1) {
  const float ab = a + (float)BOOST;
  const float c = 1.0f - 1.0f / (9.0f * ab) + eps / (3.0f * sqrtf(ab));
  const float cc = fmaxf(c, 0.05f);
  return fmaxf(ab * cc * cc * cc * expf(s1), G_FLOOR);
}

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

// grid (ceil(total/THREADS), S): one thread per (element, sample).
__global__ void __launch_bounds__(THREADS)
ig_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ logb, const float* __restrict__ t0,
              const int* __restrict__ seed_ptr, float* __restrict__ y,
              double* __restrict__ lq_part, int total, int S, int antithetic) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int half = antithetic ? S / 2 : S;
  double lq = 0.0;
  if (i < total) {
    const float ai = a[i], bi = b[i];
    float eps, s1, s2;
    draw_eps_s1_s2((uint32_t)i, (uint32_t)(s % half), (uint32_t)seed_ptr[0],
                   antithetic && s >= half, ai, eps, s1, s2);
    const float g = wh_gamma(ai, eps, s1);
    const float x = bi / g;
    y[(size_t)s * total + i] = softplusf(x);
    lq = (double)(t0[i] - (ai + 1.0f) * (logb[i] - logf(g)) - g + softplusf(-x));
  }
  lq = block_sum(lq);
  if (threadIdx.x == 0) lq_part[(size_t)s * gridDim.x + blockIdx.x] = lq;
}

// grid ceil(total/THREADS): one thread per element, looping over samples.
__global__ void __launch_bounds__(THREADS)
ig_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ logb, const float* __restrict__ dg0,
              const int* __restrict__ seed_ptr, const float* __restrict__ glq,
              const float* __restrict__ gy, float* __restrict__ ga,
              float* __restrict__ gb, int total, int S, int antithetic) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int half = antithetic ? S / 2 : S;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const float ai = a[i], bi = b[i], lbi = logb[i], dgi = dg0[i];
  const float ab = ai + (float)BOOST;
  const float sqrt_ab = sqrtf(ab);
  float ga_acc = 0.0f, gb_acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    float eps, s1, s2;
    draw_eps_s1_s2((uint32_t)i, (uint32_t)(s % half), seed,
                   antithetic && s >= half, ai, eps, s1, s2);
    const float c = 1.0f - 1.0f / (9.0f * ab) + eps / (3.0f * sqrt_ab);
    const float cc = fmaxf(c, 0.05f);
    const float active_c = c > 0.05f ? 1.0f : 0.0f;
    const float g_raw = ab * cc * cc * cc * expf(s1);
    const float g = fmaxf(g_raw, G_FLOOR);
    const float not_floored = g_raw > G_FLOOR ? 1.0f : 0.0f;
    const float x = bi / g;
    const float sig = 1.0f / (1.0f + expf(-x));
    const float dc_da = 1.0f / (9.0f * ab * ab) - eps / (6.0f * ab * sqrt_ab);
    const float dlogg_da = (1.0f / ab + 3.0f * active_c * dc_da / cc - s2) * not_floored;
    const float dx_da = -x * dlogg_da;
    const float dx_db = 1.0f / g;
    const float dlq_da = dgi - (lbi - logf(g)) + (ai + 1.0f) * dlogg_da
                         - g * dlogg_da - (1.0f - sig) * dx_da;
    const float dlq_db = -1.0f / bi - (1.0f - sig) * dx_db;
    const float gys = gy[(size_t)s * total + i], glqs = glq[s];
    ga_acc += gys * sig * dx_da + glqs * dlq_da;
    gb_acc += gys * sig * dx_db + glqs * dlq_db;
  }
  ga[i] = ga_acc;
  gb[i] = gb_acc;
}

}  // namespace

extern "C" int ig_fwd(const float* a, const float* b, const float* logb,
                      const float* t0, const int* seed, float* y,
                      double* lq_part, int total, int S, int antithetic,
                      void* stream) {
  const dim3 grid((total + THREADS - 1) / THREADS, S);
  ig_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, logb, t0, seed, y, lq_part, total, S, antithetic);
  return (int)cudaGetLastError();
}

extern "C" int ig_bwd(const float* a, const float* b, const float* logb,
                      const float* dg0, const int* seed, const float* glq,
                      const float* gy, float* ga, float* gb, int total, int S,
                      int antithetic, void* stream) {
  const int grid = (total + THREADS - 1) / THREADS;
  ig_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, logb, dg0, seed, glq, gy, ga, gb, total, S, antithetic);
  return (int)cudaGetLastError();
}

