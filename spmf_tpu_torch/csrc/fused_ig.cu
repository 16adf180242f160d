// Fused InverseGamma-surrogate sampler (forward K3f, backward K3b) for Hopper.
//
// Replaces the TPU kernels spmf_tpu/ops/fused_ig.py::_fwd_kernel and
// ::_bwd_kernel in their three modes. Per element and ELBO sample: 9
// uniforms, eps = sqrt(2) erfinv(2u-1) and the Stuart log-uniform sums, the
// boosted Wilson-Hilferty gamma g, y = softplus(b/g), and the per-sample sum
// of log q_IG - fldj_softplus. The backward replays the same draws (nothing
// of sample shape is saved) and accumulates d(y, logq)/d(a, b) over samples.
//
// Randomness (the replay contract with the plain PyTorch twin,
// spmf_tpu_torch/ops/fused_ig.py): Philox4x32-10 keyed (seed, 0); a stream is
// the counters (element, stream, j, 0) for j = 0, 1, 2, whose first 9 words
// give 23-bit integers m_j = word >> 9 and uniforms U_j = m_j 2^-23 + 2^-24
// (U_0 -> eps, U_1..U_8 -> the boost log-uniforms). Independent mode: sample
// s reads stream s. Antithetic: pair p = s mod S/2 reads stream p, and the
// samples s >= S/2 mirror U -> 1-U. Stratified: every sample of an element
// reads stream 0; pair p adds the lattice shift shifts[p][j] (a table the
// wrapper makes once per S/2) to m_j modulo 2^23, and s >= S/2 mirrors.
//
// What bounds it on an H100: the instruction pipes, not memory (8 bytes
// read and 4 S written per element). Per element and sample the draw costs
// 30 Philox rounds (120 integer multiplies, 64 a clock and SM), and the
// chain about 14 transcendentals (erfinv, 8 logs, exp, the softplus pair,
// log g, a reciprocal: 16 a clock and SM on the special-function unit) and
// some 60 float operations. The design:
// - one thread per element, looping over the samples: a and b are read once,
//   and the per-element constants (the 8 weights 1/(a+k), a+8, 1 - 1/(9(a+8)),
//   3 sqrt(a+8) and its reciprocal; in the backward also their derivatives
//   and digamma(a)) are made once, not once per sample;
// - the modes share what their draws share: antithetic draws one stream and
//   one erfinv per pair (the mirror's normal is -eps: erfinvf is odd and
//   2(1-U)-1 is the exact negation of 2U-1) and takes only the logs of 1-U;
//   stratified draws the 9 integers once per element for all S samples;
// - log b, a log b - lgamma(a) and log b - digamma(a) are made here, so the
//   wrapper launches nothing around the kernel. The per-sample log q is
//   summed in double by warp shuffles into shared memory, per block, and a
//   second tiny kernel sums the blocks' partials in a fixed order: no float
//   atomics, the same bits on every launch;
// - no division with a slow path in the loop. The forward keeps the parent
//   kernel's bits for y (the pinned checksums of tests/test_torch_gpu.py):
//   eps / (3 sqrt(a+8)) is a correctly rounded division by a hoisted
//   correctly rounded reciprocal (div_by_rcp_rn), the same value as the IEEE
//   division; b / g, whose divisor changes every sample, stays the IEEE
//   division. The backward, held to tolerances, takes rcp_normal (within 1
//   ulp) everywhere. No fast intrinsic (__logf, __expf) is used: logf, expf,
//   log1pf, erfinvf and lgammaf are the accurate library functions.
// Writes of y[s * total + i] are coalesced across the warp.
#include "fast_math.cuh"
#include "philox.cuh"

namespace {

constexpr int BOOST = 8;
constexpr int NU = BOOST + 1;          // uniforms per draw: eps, then the boost
constexpr int WARPS = THREADS / 32;
constexpr float G_FLOOR = 1.0842021724855044e-19f;  // sqrt(FLT_MIN) = 2^-63
constexpr unsigned FULL = 0xffffffffu;
constexpr int MODE_INDEPENDENT = 0, MODE_ANTITHETIC = 1, MODE_STRATIFIED = 2;

// the 23-bit integers m_0..m_8 of one stream of element idx
__device__ __forceinline__ void stream_bits(uint32_t idx, uint32_t stream, uint32_t seed,
                                            uint32_t m[NU]) {
#pragma unroll
  for (uint32_t j = 0; j < 3; ++j) {
    const U4 r = philox4x32_10(U4{idx, stream, j, 0u}, seed, 0u);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < NU) m[4 * j + k] = w[k] >> 9;
  }
}

// Calls f(s, eps, logu) for every sample s of element idx, where eps is the
// sample's standard normal and logu[k] = log U_{k+1} its boost log-uniforms,
// in the order of the module comment's modes (both samples of a pair in turn).
template <int MODE, typename F>
__device__ __forceinline__ void for_each_draw(uint32_t idx, uint32_t seed,
                                              const int* __restrict__ shifts, int S, F&& f) {
  const int pairs = MODE == MODE_INDEPENDENT ? S : S / 2;
  uint32_t base[NU];
  if (MODE == MODE_STRATIFIED) stream_bits(idx, 0u, seed, base);
#pragma unroll 1
  for (int p = 0; p < pairs; ++p) {
    uint32_t m[NU];
    if (MODE == MODE_STRATIFIED) {
#pragma unroll
      for (int j = 0; j < NU; ++j)
        m[j] = (base[j] + (uint32_t)__ldg(shifts + p * NU + j)) & 0x7FFFFFu;
    } else {
      stream_bits(idx, (uint32_t)p, seed, m);
    }
    float u[NU], logu[BOOST];
#pragma unroll
    for (int j = 0; j < NU; ++j) u[j] = uniform_from_u23(m[j]);
    const float eps = SQRT2 * erfinvf(2.0f * u[0] - 1.0f);
#pragma unroll
    for (int k = 0; k < BOOST; ++k) logu[k] = logf(u[k + 1]);
    f(p, eps, logu);
    if (MODE != MODE_INDEPENDENT) {
#pragma unroll
      for (int k = 0; k < BOOST; ++k) logu[k] = logf(1.0f - u[k + 1]);
      f(p + pairs, -eps, logu);
    }
  }
}

// digamma(x) for x > 0: psi(x) = psi(x + n) - sum_{k<n} 1 / (x + k) up to
// x + n >= 6, then log z - 1/(2z) - 1/(12 z^2) + 1/(120 z^4) - 1/(252 z^6)
// (the next term is below 3e-9 at z >= 6). The same recipe in float32 on a
// CPU is within 5.3e-7 of torch.digamma in float64, relative to max(1,
// |digamma|), over a in [1e-3, 1e4], the largest near its root (torch.digamma
// in float32: 8.5e-7; tests/test_torch_stratified.py::
// test_kernel_digamma_recipe).
__device__ __forceinline__ float digamma_pos(float x) {
  float acc = 0.0f;
#pragma unroll 1
  for (int k = 0; k < 6 && x < 6.0f; ++k) {
    acc -= rcp_normal(x);
    x += 1.0f;
  }
  const float r = rcp_normal(x), r2 = r * r;
  return acc + logf(x) - 0.5f * r -
         r2 * (1.0f / 12.0f - r2 * (1.0f / 120.0f - r2 * (1.0f / 252.0f)));
}

// grid ceil(total / THREADS): one thread per element, looping over samples.
// lq_part[s][block] gets the block's sum of sample s's log q.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
ig_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const int* __restrict__ seed_ptr, const int* __restrict__ shifts,
              float* __restrict__ y, double* __restrict__ lq_part, int total, int S) {
  extern __shared__ double warp_lq[];  // [S][WARPS]
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lanes past the end take a = 10, b = 1 (no NaN) and add nothing: they
  // stay in the loop for the shuffles
  const float ai = live ? a[i] : 10.0f, bi = live ? b[i] : 1.0f;
  const float logb = logf(bi);
  const float t0 = ai * logb - lgammaf(ai);
  const float ap1 = ai + 1.0f;
  const float ab = ai + (float)BOOST;
  const float c0 = 1.0f - 1.0f / (9.0f * ab);
  const float d_eps = 3.0f * sqrtf(ab);
  const float r_eps = 1.0f / d_eps;
  float w[BOOST];
#pragma unroll
  for (int k = 0; k < BOOST; ++k) w[k] = 1.0f / (ai + (float)k);
  for_each_draw<MODE>((uint32_t)i, (uint32_t)seed_ptr[0], shifts, S,
                      [&](int s, float eps, const float* logu) {
    float s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < BOOST; ++k) s1 += logu[k] * w[k];
    const float c = c0 + div_by_rcp_rn(eps, d_eps, r_eps);
    const float cc = fmaxf(c, 0.05f);
    const float g = fmaxf(ab * cc * cc * cc * expf(s1), G_FLOOR);
    const float x = bi / g;
    // softplus(x) = max(x, 0) + l and softplus(-x) = max(-x, 0) + l
    const float l = log1pf(expf(-fabsf(x)));
    if (live) y[(size_t)s * total + i] = fmaxf(x, 0.0f) + l;
    const float lq = t0 - ap1 * (logb - logf(g)) - g + (fmaxf(-x, 0.0f) + l);
    double v = live ? (double)lq : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    if (lane == 0) warp_lq[s * WARPS + warp] = v;
  });
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += THREADS) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) v += warp_lq[s * WARPS + k];
    lq_part[(size_t)s * gridDim.x + blockIdx.x] = v;
  }
}

// grid S: lq[s] = sum over blocks of lq_part[s][.], in a fixed order
__global__ void __launch_bounds__(THREADS)
ig_lq_sum_kernel(const double* __restrict__ lq_part, int nblk, float* __restrict__ lq) {
  double v = 0.0;
  for (int k = threadIdx.x; k < nblk; k += THREADS) v += lq_part[(size_t)blockIdx.x * nblk + k];
  v = block_sum(v);
  if (threadIdx.x == 0) lq[blockIdx.x] = (float)v;
}

// grid ceil(total / THREADS): one thread per element, looping over samples
template <int MODE>
__global__ void __launch_bounds__(THREADS)
ig_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const int* __restrict__ seed_ptr, const int* __restrict__ shifts,
              const float* __restrict__ glq, const float* __restrict__ gy,
              float* __restrict__ ga, float* __restrict__ gb, int total, int S) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const float ai = a[i], bi = b[i];
  const float logb = logf(bi);
  const float dg0 = logb - digamma_pos(ai);
  const float ap1 = ai + 1.0f;
  const float ab = ai + (float)BOOST;
  const float inv_ab = rcp_normal(ab);
  const float c0 = 1.0f - inv_ab * (1.0f / 9.0f);    // c = c0 + eps k_eps
  const float k_eps = rcp_normal(3.0f * sqrtf(ab));
  const float dc0 = inv_ab * inv_ab * (1.0f / 9.0f);  // dc/da = dc0 - eps dc1
  const float dc1 = 0.5f * inv_ab * k_eps;
  const float inv_b = rcp_normal(bi);
  float w[BOOST], w2[BOOST];
#pragma unroll
  for (int k = 0; k < BOOST; ++k) {
    w[k] = rcp_normal(ai + (float)k);
    w2[k] = w[k] * w[k];
  }
  float ga_acc = 0.0f, gb_acc = 0.0f;
  for_each_draw<MODE>((uint32_t)i, (uint32_t)seed_ptr[0], shifts, S,
                      [&](int s, float eps, const float* logu) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < BOOST; ++k) {
      s1 += logu[k] * w[k];
      s2 += logu[k] * w2[k];
    }
    const float c = c0 + eps * k_eps;
    const float cc = fmaxf(c, 0.05f);
    const float g_raw = ab * cc * cc * cc * expf(s1);
    const float g = fmaxf(g_raw, G_FLOOR);
    const float rg = rcp_normal(g);
    const float x = bi * rg;                  // >= 0
    const float t = expf(-x);
    const float sig = rcp_normal(1.0f + t);   // sigmoid(x)
    const float omsig = t * sig;              // 1 - sigmoid(x)
    // d log g / da = 1/ab + 3 [c > .05] (dc/da) / cc - s2, 0 where floored
    float dlogg = inv_ab - s2;
    if (c > 0.05f) dlogg += 3.0f * (dc0 - eps * dc1) * rcp_normal(cc);
    if (!(g_raw > G_FLOOR)) dlogg = 0.0f;
    const float dx_da = -x * dlogg;
    const float dlq_da = dg0 - (logb - logf(g)) + (ap1 - g) * dlogg - omsig * dx_da;
    const float dlq_db = -inv_b - omsig * rg;
    const float gys = gy[(size_t)s * total + i], glqs = __ldg(glq + s);
    ga_acc += gys * (sig * dx_da) + glqs * dlq_da;
    gb_acc += gys * (sig * rg) + glqs * dlq_db;
  });
  ga[i] = ga_acc;
  gb[i] = gb_acc;
}

int fwd_smem(int S) { return S * WARPS * (int)sizeof(double); }

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int MODE>
int fwd_launch(const float* a, const float* b, const int* seed, const int* shifts, float* y,
               double* lq_part, float* lq, int total, int S, cudaStream_t stream) {
  const int nblk = (total + THREADS - 1) / THREADS;
  const int smem = fwd_smem(S);
  if (smem > 48 * 1024) {
    const int err = prepare(ig_fwd_kernel<MODE>, smem);
    if (err != 0) return err;
  }
  ig_fwd_kernel<MODE><<<nblk, THREADS, smem, stream>>>(a, b, seed, shifts, y, lq_part, total, S);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ig_lq_sum_kernel<<<S, THREADS, 0, stream>>>(lq_part, nblk, lq);
  return (int)cudaGetLastError();
}

template <int MODE>
int bwd_launch(const float* a, const float* b, const int* seed, const int* shifts,
               const float* glq, const float* gy, float* ga, float* gb, int total, int S,
               cudaStream_t stream) {
  const int nblk = (total + THREADS - 1) / THREADS;
  ig_bwd_kernel<MODE><<<nblk, THREADS, 0, stream>>>(a, b, seed, shifts, glq, gy, ga, gb, total, S);
  return (int)cudaGetLastError();
}

// registers, static and dynamic shared memory and resident blocks per SM
template <typename Kernel>
int kernel_info(Kernel kernel, int smem, int* info) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err == 0 && smem > 48 * 1024) err = prepare(kernel, smem);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return err;
}

}  // namespace

// mode: 0 independent, 1 antithetic, 2 stratified (shifts: the (S/2, 9)
// lattice table; unread in the other modes). lq_part: (S, ceil(total /
// THREADS)) scratch.
extern "C" int ig_fwd(const float* a, const float* b, const int* seed, const int* shifts,
                      float* y, double* lq_part, float* lq, int total, int S, int mode,
                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_INDEPENDENT:
      return fwd_launch<MODE_INDEPENDENT>(a, b, seed, shifts, y, lq_part, lq, total, S, st);
    case MODE_ANTITHETIC:
      return fwd_launch<MODE_ANTITHETIC>(a, b, seed, shifts, y, lq_part, lq, total, S, st);
    case MODE_STRATIFIED:
      return fwd_launch<MODE_STRATIFIED>(a, b, seed, shifts, y, lq_part, lq, total, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int ig_bwd(const float* a, const float* b, const int* seed, const int* shifts,
                      const float* glq, const float* gy, float* ga, float* gb, int total, int S,
                      int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case MODE_INDEPENDENT:
      return bwd_launch<MODE_INDEPENDENT>(a, b, seed, shifts, glq, gy, ga, gb, total, S, st);
    case MODE_ANTITHETIC:
      return bwd_launch<MODE_ANTITHETIC>(a, b, seed, shifts, glq, gy, ga, gb, total, S, st);
    case MODE_STRATIFIED:
      return bwd_launch<MODE_STRATIFIED>(a, b, seed, shifts, glq, gy, ga, gb, total, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

// what the built library reports for K3f (fwd != 0, at S samples) or K3b in
// a mode, into info[0..3] (see kernel_info)
extern "C" int ig_kernel_info(int fwd, int mode, int S, int* info) {
  const int smem = fwd ? fwd_smem(S) : 0;
  switch (mode * 2 + (fwd != 0)) {
    case 0: return kernel_info(ig_bwd_kernel<MODE_INDEPENDENT>, 0, info);
    case 1: return kernel_info(ig_fwd_kernel<MODE_INDEPENDENT>, smem, info);
    case 2: return kernel_info(ig_bwd_kernel<MODE_ANTITHETIC>, 0, info);
    case 3: return kernel_info(ig_fwd_kernel<MODE_ANTITHETIC>, smem, info);
    case 4: return kernel_info(ig_bwd_kernel<MODE_STRATIFIED>, 0, info);
    case 5: return kernel_info(ig_fwd_kernel<MODE_STRATIFIED>, smem, info);
  }
  return (int)cudaErrorInvalidValue;
}
