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
// The stream (the replay contract of forward, backward and the plain
// PyTorch twin, spmf_tpu_torch/ops/fused_normal.py::draw_eps): key (seed, 1)
// (K3 uses (seed, 0), so one seed never gives the two blocks the same
// uniform); sample s of element i takes word s % 4 of the call at counter
// (i, s / 4, 0, 0), on the half-ulp uniform grid of philox.cuh. One call
// serves four samples; for S not a multiple of 4 the last call's first
// S % 4 words are used. It never depends on block geometry.
//
// What bounds it on an H100, counted per pipe as for K3 (chip_smoke.py's
// normal_bound), at total = 1,340,000 and S = 8: the forward reads three
// parameter vectors and writes y, 59 MB or 0.018 ms at 3.35 TB/s; the
// backward reads gy instead of writing y and writes two vectors, 70 MB or
// 0.021 ms. The arithmetic stays under that: 40 integer multiplies a
// Philox call, one call per element and four samples (0.006 ms), and
// about 4 transcendentals per sample plus 3 per element (0.011 ms). So the
// bytes bound both directions. The design:
// - each thread owns its elements (ELEMS of them in the forward, one in
//   the backward) and loops over the samples in groups of four: loc,
//   raw_scale and mask are read once, softplus(raw_scale) and its log
//   (forward) or its sigmoid and 1/scale (backward) are made once;
// - per sample the forward shares exp(-|x|) and its log1p between
//   softplus(x) and softplus(-x) (the same bits as two softplusf calls);
//   the backward takes sigmoid(x) from the same exp(-|x|) and one rcp_normal
//   (no division with a slow path in the loop), and sums the samples'
//   log q cotangents so that d/d raw_scale needs one product per sample;
// - y[s * total + i] and gy[s * total + i] are coalesced across the warp;
//   gloc and graw_scale are one plain store each;
// - the per-sample log q is summed in double by warp shuffles into shared
//   memory, one partial per block and sample, and normal_lq_sum_kernel sums
//   the partials in a fixed order into the float lq: two launches a
//   forward, no float atomics, the same bits on every launch, and the seed
//   is read on the device (no host sync).
// Accurate library functions only (logf, expf, log1pf, erfinvf): given the
// same eps, y is computed as by the kernel before this design.
#include "fast_math.cuh"
#include "philox.cuh"

namespace {

constexpr float HALF_LOG_2PI = 0.9189385332046727f;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// elements a forward thread takes, a block apart: each sample's log q
// shuffles are shared by them (faster on the card than 1 or 2 at S = 8 and
// S = 1, at 80 registers and 3 blocks an SM: PERF.md)
constexpr int ELEMS = 4;

// the four uniforms' words of samples 4q .. 4q+3 of element idx
__device__ __forceinline__ U4 draw_words(uint32_t idx, uint32_t q, uint32_t seed) {
  return philox4x32_10(U4{idx, q, 0u, 0u}, seed, 1u);
}

__device__ __forceinline__ uint32_t word(const U4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

__device__ __forceinline__ float eps_from_bits(uint32_t bits) {
  return SQRT2 * erfinvf(2.0f * uniform_from_bits(bits) - 1.0f);
}

// sigmoid(x) and 1 - sigmoid(x) from t = exp(-|x|) in (0, 1]: no overflow
// for any x, and the smaller of the two without cancellation
__device__ __forceinline__ void sigmoid_pair(float x, float t, float& sig, float& omsig) {
  const float r = rcp_normal(1.0f + t);
  sig = x >= 0.0f ? r : t * r;
  omsig = x >= 0.0f ? t * r : r;
}

// grid ceil(total / (THREADS ELEMS)): each thread takes ELEMS elements a
// block apart (coalesced) and loops over the samples; lq_part[s][block] gets
// the block's sum of sample s's log q.
__global__ void __launch_bounds__(THREADS)
normal_fwd_kernel(const float* __restrict__ loc, const float* __restrict__ raw_scale,
                  const float* __restrict__ mask, const int* __restrict__ seed_ptr,
                  float* __restrict__ y, double* __restrict__ lq_part, int total, int S) {
  extern __shared__ double warp_lq[];  // [S][WARPS]
  const int i0 = blockIdx.x * (THREADS * ELEMS) + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lanes past the end take loc = 0, raw_scale = 0, mask = 0 (no NaN) and
  // add nothing: they stay in the loop for the shuffles
  float li[ELEMS], m[ELEMS], scale[ELEMS], logscale[ELEMS];
#pragma unroll
  for (int e = 0; e < ELEMS; ++e) {
    const int i = i0 + e * THREADS;
    const bool live = i < total;
    li[e] = live ? loc[i] : 0.0f;
    m[e] = live ? mask[i] : 0.0f;
    scale[e] = softplusf(live ? raw_scale[i] : 0.0f);
    logscale[e] = logf(scale[e]);
  }
  const uint32_t seed = (uint32_t)seed_ptr[0];
#pragma unroll 1
  for (int s0 = 0; s0 < S; s0 += 4) {
    U4 r[ELEMS];
#pragma unroll
    for (int e = 0; e < ELEMS; ++e)
      r[e] = draw_words((uint32_t)(i0 + e * THREADS), (uint32_t)(s0 >> 2), seed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = s0 + k;
      if (s >= S) break;  // the same for the whole block
      double v = 0.0;
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        const float eps = eps_from_bits(word(r[e], k));
        const float x = li[e] + scale[e] * eps;
        // softplus(x) = max(x, 0) + l and softplus(-x) = max(-x, 0) + l
        const float l = log1pf(expf(-fabsf(x)));
        const float lq =
            -logscale[e] - 0.5f * eps * eps - HALF_LOG_2PI + m[e] * (fmaxf(-x, 0.0f) + l);
        const int i = i0 + e * THREADS;
        if (i < total) {
          y[(size_t)s * total + i] = m[e] > 0.0f ? fmaxf(x, 0.0f) + l : x;
          v += (double)lq;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
      if (lane == 0) warp_lq[s * WARPS + warp] = v;
    }
  }
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
normal_lq_sum_kernel(const double* __restrict__ lq_part, int nblk, float* __restrict__ lq) {
  double v = 0.0;
  for (int k = threadIdx.x; k < nblk; k += THREADS) v += lq_part[(size_t)blockIdx.x * nblk + k];
  v = block_sum(v);
  if (threadIdx.x == 0) lq[blockIdx.x] = (float)v;
}

// grid ceil(total / THREADS): one thread per element, looping over samples.
//   gloc = sum_s a_s, a_s = gy_s dy/dx + glq_s dlq/dx,
//   grs  = sigmoid(rs) sum_s a_s eps_s - (sigmoid(rs) / scale) sum_s glq_s
// (dx/drs = eps sigmoid(rs), and d(-log scale)/drs = -sigmoid(rs) / scale).
__global__ void __launch_bounds__(THREADS)
normal_bwd_kernel(const float* __restrict__ loc, const float* __restrict__ raw_scale,
                  const float* __restrict__ mask, const int* __restrict__ seed_ptr,
                  const float* __restrict__ glq, const float* __restrict__ gy,
                  float* __restrict__ gloc, float* __restrict__ grs, int total, int S) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  const float li = loc[i], rsi = raw_scale[i], m = mask[i];
  const float t_rs = expf(-fabsf(rsi));
  const float scale = fmaxf(rsi, 0.0f) + log1pf(t_rs);  // softplusf(rsi)
  const float r_rs = rcp_normal(1.0f + t_rs);
  const float sig_rs = rsi >= 0.0f ? r_rs : t_rs * r_rs;
  const float dlogscale_drs = sig_rs * rcp_normal(scale);
  float gl = 0.0f, ge = 0.0f, gq = 0.0f;
#pragma unroll 1
  for (int s0 = 0; s0 < S; s0 += 4) {
    const U4 r = draw_words((uint32_t)i, (uint32_t)(s0 >> 2), seed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = s0 + k;
      if (s >= S) break;
      const float eps = eps_from_bits(word(r, k));
      const float x = li + scale * eps;
      float sig_x, omsig_x;
      sigmoid_pair(x, expf(-fabsf(x)), sig_x, omsig_x);
      const float dy_dx = m > 0.0f ? sig_x : 1.0f;
      const float gys = gy[(size_t)s * total + i], glqs = __ldg(glq + s);
      const float a = gys * dy_dx - glqs * (m * omsig_x);
      gl += a;
      ge += a * eps;
      gq += glqs;
    }
  }
  gloc[i] = gl;
  grs[i] = sig_rs * ge - dlogscale_drs * gq;
}

int fwd_smem(int S) { return S * WARPS * (int)sizeof(double); }

int prepare(int smem) {
  return smem > 48 * 1024 ? (int)cudaFuncSetAttribute(
                                normal_fwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                          : 0;
}

// registers, static and dynamic shared memory and resident blocks per SM
template <typename Kernel>
int kernel_info(Kernel kernel, int smem, int* info) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
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

// the forward's blocks: lq_part is (S, normal_fwd_blocks(total)) doubles
extern "C" int normal_fwd_blocks(int total) {
  return (total + THREADS * ELEMS - 1) / (THREADS * ELEMS);
}

extern "C" int normal_fwd(const float* loc, const float* raw_scale, const float* mask,
                          const int* seed, float* y, double* lq_part, float* lq, int total,
                          int S, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nblk = normal_fwd_blocks(total);
  const int smem = fwd_smem(S);
  int err = prepare(smem);
  if (err != 0) return err;
  normal_fwd_kernel<<<nblk, THREADS, smem, st>>>(loc, raw_scale, mask, seed, y, lq_part,
                                                 total, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  normal_lq_sum_kernel<<<S, THREADS, 0, st>>>(lq_part, nblk, lq);
  return (int)cudaGetLastError();
}

extern "C" int normal_bwd(const float* loc, const float* raw_scale, const float* mask,
                          const int* seed, const float* glq, const float* gy, float* gloc,
                          float* grs, int total, int S, void* stream) {
  const int grid = (total + THREADS - 1) / THREADS;
  normal_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      loc, raw_scale, mask, seed, glq, gy, gloc, grs, total, S);
  return (int)cudaGetLastError();
}

// what the built library reports for K6f (fwd != 0, at S samples) or K6b,
// into info[0..3]: registers a thread, static and dynamic shared memory a
// block, resident blocks an SM (the occupancy API's)
extern "C" int normal_kernel_info(int fwd, int S, int* info) {
  if (!fwd) return kernel_info(normal_bwd_kernel, 0, info);
  const int smem = fwd_smem(S);
  const int err = prepare(smem);
  return err != 0 ? err : kernel_info(normal_fwd_kernel, smem, info);
}
